"""device_idle_pct: the share of one sample's wall in which nothing ran on the
card: 100 x (1 - the union of its kernel, copy and set intervals / the
sample's wall), from torch.profiler over one whole sample.
"""

PHASE = "profile"


def read(probe):
    t = probe.trace
    if t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
