"""Reduction of a torch.profiler trace of one sample to device numbers.

The device is busy where any kernel, copy or set on it runs: the union of
their intervals, so overlapping kernels count once. An idle gap is a
stretch of the sample's wall in which nothing runs on the device; it is
named by the innermost stage range ("stage:<metric>", from the stage
clock) that holds its middle on the host, else "host_rest".
"""

from __future__ import annotations

import dataclasses


def union(intervals):
    """[(start, end), ...] merged, sorted, disjoint."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(busy, start, end):
    """The stretches of [start, end] outside the disjoint sorted `busy`."""
    out = []
    t = start
    for a, b in busy:
        if a > t:
            out.append((t, min(a, end)))
        t = max(t, b)
    if end > t:
        out.append((t, end))
    return [(a, b) for a, b in out if b > a]


@dataclasses.dataclass
class Trace:
    """One profiled sample: device ops [(name, start_s, end_s)], host
    ranges [(label, start_s, end_s)], and the sample's wall (start, end)
    on the same clock."""

    device: list
    ranges: list
    wall: tuple

    @property
    def window_s(self) -> float:
        return self.wall[1] - self.wall[0]

    def busy(self):
        a, b = self.wall
        return union((max(s, a), min(e, b)) for _, s, e in self.device
                     if e > a and s < b)

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def device_seconds(self, match) -> float:
        """Device seconds of the ops whose name satisfies match(name),
        their overlaps counted once."""
        return sum(b - a for a, b in union((s, e) for n, s, e in self.device
                                           if match(n)))

    def top_ops(self, k: int = 10):
        by = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0.0) + (e - s)
        return sorted(by.items(), key=lambda kv: -kv[1])[:k]

    def host_label(self, t: float) -> str:
        best = None
        for label, s, e in self.ranges:
            if s <= t <= e and (best is None or e - s < best[2] - best[1]):
                best = (label, s, e)
        return best[0] if best else "host_rest"

    def idle_gaps(self, k: int = 10):
        g = sorted(gaps(self.busy(), *self.wall), key=lambda x: x[0] - x[1])
        return [(self.host_label((a + b) / 2), b - a) for a, b in g[:k]]


SAMPLE_RANGE = "bench:sample"


def from_profiler(prof, prefix: str = "stage:") -> Trace:
    """A Trace of a finished torch.profiler.profile over one sample held
    in a record_function(SAMPLE_RANGE): every device event (kernels,
    copies, sets; not the device's copies of host ranges) and the host
    ranges whose name starts with `prefix`, in seconds of the profiler's
    clock."""
    from torch.autograd import DeviceType

    device, ranges, wall = [], [], None
    for e in prof.events():
        s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
        ours = e.name.startswith(prefix) or e.name == SAMPLE_RANGE
        if e.device_type == DeviceType.CUDA:
            if not ours:
                device.append((e.name, s, t))
        elif e.name == SAMPLE_RANGE:
            wall = (s, t)
        elif e.name.startswith(prefix):
            ranges.append((e.name[len(prefix):], s, t))
    if wall is None:
        raise RuntimeError(f"the profile holds no {SAMPLE_RANGE!r} range")
    return Trace(device, ranges, wall)
