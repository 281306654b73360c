"""host_syncs: blocking device-to-host reads a sample, the program's
`host_syncs` counter (every read of a device result on the streaming
paths).

Read from the program's own tracer (tophat_tpu_torch/utils/trace.py) over
the window of a --trace 1 run (benchmarks/harness/program_trace.py).
"""

from benchmarks.harness import program_trace

PHASE = "window"


def install(probe):
    return program_trace.install(probe, "host_syncs")


def read(probe):
    return program_trace.counter(probe, "host_syncs")
