"""cov_islands_s: the coverage search's first phase: the segment hit tables
read to the host, coverage islands of >= 20 bases from the hits' intervals,
the look windows around their ends and the GT/AG/CT/AC sites in them, self
seconds of the `coverage_search.islands` span a sample.

Read from the program's own tracer (tophat_tpu_torch/utils/trace.py) over
the window of a --trace 1 run (benchmarks/harness/program_trace.py); a
port without the span leaves the metric out.
"""

from benchmarks.harness import program_trace

PHASE = "window"


def install(probe):
    return program_trace.install(probe, "cov_islands_s")


def read(probe):
    return program_trace.self_s(probe,
                                lambda n: n == "coverage_search.islands")
