"""realign_s: the realignment entry (targets, the realign kernel, records to
the host), self seconds a sample.

Stage clock (a synchronize before and after each call) around
tophat_tpu_torch.pipeline.run:realign_events_sparse; stages clocked inside
it are not counted here.
"""

PHASE = "window"
TARGET = "tophat_tpu_torch.pipeline.run:realign_events_sparse"


def install(probe):
    return probe.clock.wrap(TARGET, "realign_s")


def read(probe):
    return probe.per_sample("realign_s")
