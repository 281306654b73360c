"""map_s: read mapping (prep, full-read alignment, segment search, stitch), the
transcriptome map excluded, self seconds a sample.

Stage clock (a synchronize before and after each call) around
tophat_tpu_torch.pipeline.paired:_map_mate; stages clocked inside it are not
counted here.
"""

PHASE = "window"
TARGET = "tophat_tpu_torch.pipeline.paired:_map_mate"


def install(probe):
    return probe.clock.wrap(TARGET, "map_s")


def read(probe):
    return probe.per_sample("map_s")
