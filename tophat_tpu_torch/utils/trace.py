"""The port's tracer: named spans around the pipeline's stages, and counters.

Counters always count: count(name, n) adds n to a process-wide total
(realign launches, host syncs, events, rows, records), whether tracing is
on or off. Spans record only with tracing on (enable()); off, a span is
one check of a module flag and a bare yield: no clock read, no profiler
range, no device sync.

With tracing on, a span records its name, the name of the span it opened
in (per thread), the pipeline call it belongs to (each `sample` span, the
root that run_pipeline_paired_streaming and run_pipeline_streaming open,
starts a new id), its wall start and end (time.perf_counter_ns), the
process's CPU seconds over it (time.process_time: working, as against
waiting), the wall its child spans cover (self time is the rest), and the
counters counted while it was the innermost open span. Every span but the
root also opens a torch.profiler range "stage:<name>", so a profiler trace
names each stretch of host time by the innermost span that holds it.
sync=True spans synchronize the card at both ends, when the process has
initialised CUDA, so that their seconds hold their device work. Records
stay in memory until snapshot() reads them; reset() clears them and every
counter.

to_host(t) is the pipeline's blocking device-to-host read: t.cpu().numpy(),
counted as one `host_syncs` and its bytes in `host_sync_bytes`.
note_sync(nbytes) counts a read that a torch op makes itself (nonzero
reads its count back). A CPU tensor counts the same: the counts are the
program's, whichever device it runs on.

Readers: the CLI's --trace (logs/trace.json) and the per-layer metrics
under benchmarks/metrics/, both from snapshot().
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

ROOT = "sample"       # one pipeline call; it opens no profiler range
RANGE_PREFIX = "stage:"

_on = False
_lock = threading.Lock()
_counts: Dict[str, int] = {}
_records: list = []
_next_sample = [0]
_local = threading.local()


@dataclasses.dataclass
class Span:
    name: str
    parent: Optional[str]    # the enclosing span's name; None at the top
    sample: Optional[int]    # the pipeline call; None outside any
    start_ns: int = 0
    end_ns: int = 0
    cpu_s: float = 0.0       # process CPU seconds over the span
    child_ns: int = 0        # wall covered by child spans
    counts: dict = dataclasses.field(default_factory=dict)

    @property
    def wall_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def self_s(self) -> float:
        return (self.end_ns - self.start_ns - self.child_ns) / 1e9


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    """Clear every counter and span record (open spans stay open)."""
    with _lock:
        _counts.clear()
        _records.clear()
        _next_sample[0] = 0


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def span(name: str, sync: bool = False):
    """A named stage; also a decorator (@span("map", sync=True))."""
    if not _on:
        yield
        return
    stack = _stack()
    parent = stack[-1] if stack else None
    if name == ROOT:
        with _lock:
            sample = _next_sample[0]
            _next_sample[0] += 1
    else:
        sample = parent.sample if parent is not None else None
    rec = Span(name, parent.name if parent is not None else None, sample)
    if sync:
        _sync()
    rng = (contextlib.nullcontext() if name == ROOT
           else torch.profiler.record_function(RANGE_PREFIX + name))
    with rng:
        cpu0 = time.process_time()
        rec.start_ns = time.perf_counter_ns()
        stack.append(rec)
        try:
            yield
        finally:
            if sync:
                _sync()
            rec.end_ns = time.perf_counter_ns()
            rec.cpu_s = time.process_time() - cpu0
            stack.pop()
            if parent is not None:
                parent.child_ns += rec.end_ns - rec.start_ns
            with _lock:
                _records.append(rec)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` (and, tracing on, to the innermost open
    span's count of it)."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n
    if _on:
        stack = _stack()
        if stack:
            c = stack[-1].counts
            c[name] = c.get(name, 0) + n


def note_sync(nbytes: int) -> None:
    """One blocking device-to-host read of nbytes."""
    count("host_syncs")
    count("host_sync_bytes", nbytes)


def to_host(t) -> np.ndarray:
    """t.cpu().numpy() for a tensor, counted by note_sync; np.asarray of
    anything else, not counted."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    a = t.cpu().numpy()
    note_sync(a.nbytes)
    return a


def snapshot() -> dict:
    """Per span name ("spans"): calls, wall, self and CPU seconds and the
    counters counted inside it; every counter's total ("counters"); the
    pipeline calls seen ("samples"); the span records ("records"). All
    read at one moment."""
    with _lock:
        records = list(_records)
        counters = dict(_counts)
        samples = _next_sample[0]
    spans: Dict[str, dict] = {}
    for r in records:
        s = spans.setdefault(r.name, {"calls": 0, "wall_s": 0.0,
                                      "self_s": 0.0, "cpu_s": 0.0,
                                      "counts": {}})
        s["calls"] += 1
        s["wall_s"] += r.wall_s
        s["self_s"] += r.self_s
        s["cpu_s"] += r.cpu_s
        for k, v in r.counts.items():
            s["counts"][k] = s["counts"].get(k, 0) + v
    return {"spans": spans, "counters": counters, "samples": samples,
            "records": records}
