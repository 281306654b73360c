"""pair_select_s: candidate selection, mate rescue and pair grading (the
records to write), self seconds of the `pairs.select` span a sample.

Read from the program's own tracer (tophat_tpu_torch/utils/trace.py) over
the window of a --trace 1 run (benchmarks/harness/program_trace.py).
"""

from benchmarks.harness import program_trace

PHASE = "window"


def install(probe):
    return program_trace.install(probe, "pair_select_s")


def read(probe):
    return program_trace.self_s(probe, lambda n: n == "pairs.select")
