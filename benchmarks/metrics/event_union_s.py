"""event_union_s: the union of every chunk's event tables with the known
events, self seconds of the `events.union` span a sample.

Read from the program's own tracer (tophat_tpu_torch/utils/trace.py) over
the window of a --trace 1 run (benchmarks/harness/program_trace.py).
"""

from benchmarks.harness import program_trace

PHASE = "window"


def install(probe):
    return program_trace.install(probe, "event_union_s")


def read(probe):
    return program_trace.self_s(probe, lambda n: n == "events.union")
