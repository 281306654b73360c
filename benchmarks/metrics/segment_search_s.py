"""segment_search_s: the split-segment search of the reads that no
contiguous alignment placed (segment split, segment mapping, contiguous
stitch; the --b2 gapped step when on), self seconds of the `map.segments`
span a sample.

Read from the program's own tracer (tophat_tpu_torch/utils/trace.py) over
the window of a --trace 1 run (benchmarks/harness/program_trace.py).
"""

from benchmarks.harness import program_trace

PHASE = "window"


def install(probe):
    return program_trace.install(probe, "segment_search_s")


def read(probe):
    return program_trace.self_s(probe, lambda n: n == "map.segments")
