"""discovery_s: junction and indel discovery from the segment hits, self
seconds a sample.

Stage clock (a synchronize before and after each call) around
tophat_tpu_torch.pipeline.paired:discover_events; stages clocked inside it
are not counted here.
"""

PHASE = "window"
TARGET = "tophat_tpu_torch.pipeline.paired:discover_events"


def install(probe):
    return probe.clock.wrap(TARGET, "discovery_s")


def read(probe):
    return probe.per_sample("discovery_s")
