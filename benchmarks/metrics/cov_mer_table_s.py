"""cov_mer_table_s: the coverage search's extension table: every 10-mer of the
IUM reads' forward rows with its >= 7-base extensions, as one sorted array
(forward_mer_table, ExtendChecker), self seconds of the
`coverage_search.mers` span a sample.

Read from the program's own tracer (tophat_tpu_torch/utils/trace.py) over
the window of a --trace 1 run (benchmarks/harness/program_trace.py); a
port without the span leaves the metric out.
"""

from benchmarks.harness import program_trace

PHASE = "window"


def install(probe):
    return program_trace.install(probe, "cov_mer_table_s")


def read(probe):
    return program_trace.self_s(probe,
                                lambda n: n == "coverage_search.mers")
