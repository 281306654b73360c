"""coverage_search_s: the coverage search (islands, pairings, their checks),
self seconds a sample.

Stage clock (a synchronize before and after each call) around
tophat_tpu_torch.pipeline.run:coverage_search_events; stages clocked inside
it are not counted here.
"""

PHASE = "window"
TARGET = "tophat_tpu_torch.pipeline.run:coverage_search_events"


def install(probe):
    return probe.clock.wrap(TARGET, "coverage_search_s")


def read(probe):
    return probe.per_sample("coverage_search_s")
