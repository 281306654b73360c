"""candidates_s: candidates and chains of a mate, realignment excluded, self
seconds a sample.

Stage clock (a synchronize before and after each call) around
tophat_tpu_torch.pipeline.paired:candidates_for_mate; stages clocked inside
it are not counted here.
"""

PHASE = "window"
TARGET = "tophat_tpu_torch.pipeline.paired:candidates_for_mate"


def install(probe):
    return probe.clock.wrap(TARGET, "candidates_s")


def read(probe):
    return probe.per_sample("candidates_s")
