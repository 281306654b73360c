"""fastq_parse_s: FASTQ parse into read batches (pipeline/run.iter_read_batches),
self seconds of the `fastq.parse` spans a sample.

Read from the program's own tracer (tophat_tpu_torch/utils/trace.py) over
the window of a --trace 1 run (benchmarks/harness/program_trace.py).
"""

from benchmarks.harness import program_trace

PHASE = "window"


def install(probe):
    return program_trace.install(probe, "fastq_parse_s")


def read(probe):
    return program_trace.self_s(probe, lambda n: n == "fastq.parse")
