"""host_rest_s: what the clocked stages leave of a sample, seconds a sample.

The sample's timed seconds less the self seconds of every clocked stage (the
stage metrics of the cell): FASTQ parse, the event union, stats and filter,
selection, pair grading and every output file.
"""

PHASE = "window"


def read(probe):
    if not probe.samples:
        return None
    return (probe.sample_seconds - probe.clock.total()) / probe.samples
