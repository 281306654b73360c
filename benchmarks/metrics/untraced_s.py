"""untraced_s: what the program's spans leave of a sample: self seconds of
the root `sample` span (one pipeline call) a sample.

Read from the program's own tracer (tophat_tpu_torch/utils/trace.py) over
the window of a --trace 1 run (benchmarks/harness/program_trace.py).
"""

from benchmarks.harness import program_trace

PHASE = "window"


def install(probe):
    return program_trace.install(probe, "untraced_s")


def read(probe):
    return program_trace.self_s(probe, lambda n: n == "sample")
