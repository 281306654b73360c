"""realign_roofline_pct: the realign kernel's share of its roofline in one
profiled sample.

The least time of every call the sample made to the kernel's entries
(ops/realign_kernel.realign_group_sparse and realign_group, as ops/events
calls them), from the call's shapes at the published peaks
(harness/roofline.py: operations bound it at these shapes), over the device
seconds of the kernels of csrc/realign.cu in that sample, from the profiler
by kernel name. None when the sample made no call or the trace holds none of
the kernels.
"""

from benchmarks.harness import roofline

PHASE = "profile"
ENTRIES = {"tophat_tpu_torch.ops.events:realign_group_sparse": True,
           "tophat_tpu_torch.ops.events:realign_group": False}
KERNELS = ("realign_mma_kernel", "target_kernel", "rows_kernel")


def install(probe):
    calls = probe.state.setdefault("realign_calls", [])

    def hook(sparse):
        def make(fn):
            def call(reads, lengths, flank_l, comb, q, *rest):
                out = fn(reads, lengths, flank_l, comb, q, *rest)
                calls.append((tuple(reads.shape), lengths,
                              int(flank_l.shape[0]), int(q),
                              int(out.shape[1]) if sparse else None))
                return out
            return call
        return make

    return any([probe.hooks.replace(t, hook(s)) for t, s in ENTRIES.items()])


def splits(lengths, q: int, L: int) -> int:
    """Splits the rows need: 1 .. min(L - 1, len - 1 - q) each."""
    import torch

    return int(torch.clamp(torch.clamp(lengths.long() - 1 - q, max=L - 1),
                           min=0).sum())


def read(probe):
    calls = probe.state.get("realign_calls")
    kernel_s = probe.trace.device_seconds(
        lambda n: any(k in n for k in KERNELS))
    if not calls or kernel_s <= 0:
        return None
    least = 0.0
    for (R, L), lengths, E, q, records in calls:
        ops, nbytes = roofline.realign_work(splits(lengths, q, L), R, E, L,
                                            records)
        least += roofline.least_seconds(ops, nbytes)[0]
    return 100.0 * least / kernel_s
