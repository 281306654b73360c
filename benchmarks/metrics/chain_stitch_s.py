"""chain_stitch_s: the default-mode multi-event chains of the reads still
unresolved after their candidates were collected, self seconds of the
`candidates.chains` span a sample (its segment rows' realignment, the
nested `realign` span, left out).

Read from the program's own tracer (tophat_tpu_torch/utils/trace.py) over
the window of a --trace 1 run (benchmarks/harness/program_trace.py).
"""

from benchmarks.harness import program_trace

PHASE = "window"


def install(probe):
    return program_trace.install(probe, "chain_stitch_s")


def read(probe):
    return program_trace.self_s(probe, lambda n: n == "candidates.chains")
