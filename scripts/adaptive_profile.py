#!/usr/bin/env python3
"""Where the two-tier aligner's time goes on the card: bench.py's
unspliced batches through align_reads_adaptive with its arguments, the
deferred call (both tiers in one sync-free program, the wide pass over a
fixed budget of rows) against the exact call (the truncated rows read
back and re-run), each timed and then traced with torch.profiler.

Run from the root of a checkout, on a machine with a CUDA card:
  python3 scripts/adaptive_profile.py [--log2-bases 26] [--k 12]
                                      [--batches 8] [--top 12]

The genome is bench.py's draw (seed 7) cut to 2^log2-bases, indexed with
a k-mer seed table and a full SA on the host and loaded to the card (at
2^26 bases and k = 12, four bases a table entry as at bench.py's 2^30
and k = 14). Prints one JSON line: the card; per call, the wall and
host-dispatch seconds of the batches run back to back (CUDA-synchronized
at the end only), the traced device-busy seconds (kernel time summed),
the kernel launches and the ops with the most device time and the most
host time.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_loop(run, batches, defer):
    """(wall s, dispatch s) of every batch dispatched back to back."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        run(b, defer)
    dispatch = time.perf_counter() - t0
    torch.cuda.synchronize()
    return time.perf_counter() - t0, dispatch


def trace(run, batches, defer, top):
    """Kernel seconds and launches of one traced loop, and its aten ops
    with the most device time (their own kernels) and the most host
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in batches:
            run(b, defer)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ops = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    row = lambda e: dict(op=e.key, calls=e.count,
                         device_ms=e.self_device_time_total / 1e3,
                         host_ms=e.self_cpu_time_total / 1e3)
    by = lambda f: [row(e) for e in sorted(ops, key=f, reverse=True)[:top]]
    return dict(
        kernel_s=sum(e.device_time_total for e in kernels) / 1e6,
        kernel_launches=len(kernels),
        top_device=by(lambda e: e.self_device_time_total),
        top_host=by(lambda e: e.self_cpu_time_total))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2-bases", type=int, default=26)
    ap.add_argument("--k", type=int, default=12)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("adaptive_profile.py needs a CUDA card")
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from tophat_tpu_torch.index.fm import build_fm_index
    from tophat_tpu_torch.ops.align import align_reads_adaptive, kmer_fast_ok

    card = cs.card_line()
    codes = cs.bench_genome(1 << args.log2_bases)
    t0 = time.time()
    fm = build_fm_index(codes, kmer_k=args.k, device="cuda")
    build_s = time.time() - t0
    fast = kmer_fast_ok(fm, cs.READ_LEN, 2)
    offsets = torch.tensor([0, fm.n], device="cuda")
    batches = [tuple(torch.as_tensor(x, device="cuda")
                     for x in cs.unspliced_batch(codes, 100 + i))
               for i in range(args.batches)]
    run = lambda b, defer: align_reads_adaptive(
        fm, *b, offsets, kmer_fast=fast, defer=defer, **cs.BENCH_ALIGN)
    out = dict(card=card, bases=fm.n, kmer_k=fm.kmer_k, build_s=build_s,
               batches=args.batches, batch=cs.BATCH, kmer_fast=fast)
    for name, defer in (("deferred", True), ("exact", False)):
        run(batches[0], defer)
        wall, dispatch = run_loop(run, batches, defer)
        rec = dict(wall_s=wall, dispatch_s=dispatch,
                   reads_per_s=args.batches * cs.BATCH / wall)
        rec.update(trace(run, batches, defer, args.top))
        rec["device_busy_share"] = rec["kernel_s"] / wall
        out[name] = rec
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
