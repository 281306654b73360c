"""output_s: every output file (accepted_hits.sam and .bam, unmapped.bam,
the BED tracks, align_summary.txt and prep_reads.info), self seconds of the
`output` span and its `output.*` children a sample.

Read from the program's own tracer (tophat_tpu_torch/utils/trace.py) over
the window of a --trace 1 run (benchmarks/harness/program_trace.py).
"""

from benchmarks.harness import program_trace

PHASE = "window"


def install(probe):
    return program_trace.install(probe, "output_s")


def read(probe):
    return program_trace.self_s(
        probe, lambda n: n == "output" or n.startswith("output."))
