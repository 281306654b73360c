"""junction_filter_s: each event's stats over every candidate, then
filter_junctions: self seconds of the `junctions.filter` span a sample.

Read from the program's own tracer (tophat_tpu_torch/utils/trace.py) over
the window of a --trace 1 run (benchmarks/harness/program_trace.py).
"""

from benchmarks.harness import program_trace

PHASE = "window"


def install(probe):
    return program_trace.install(probe, "junction_filter_s")


def read(probe):
    return program_trace.self_s(probe, lambda n: n == "junctions.filter")
