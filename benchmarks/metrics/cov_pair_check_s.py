"""cov_pair_check_s: the coverage search's site pairing and extension check:
the donor and acceptor sites paired within the coverage intron range on one
contig (site_pairs), each pair checked against the extension table, self
seconds of the `coverage_search.pairs` span a sample.

Read from the program's own tracer (tophat_tpu_torch/utils/trace.py) over
the window of a --trace 1 run (benchmarks/harness/program_trace.py); a
port without the span leaves the metric out.
"""

from benchmarks.harness import program_trace

PHASE = "window"


def install(probe):
    return program_trace.install(probe, "cov_pair_check_s")


def read(probe):
    return program_trace.self_s(probe,
                                lambda n: n == "coverage_search.pairs")
