"""The port's own tracer (tophat_tpu_torch/utils/trace.py) as the source
of "window" metrics.

core.traced_sample calls a "window" reader's install twice: before the
window, then at the start of the profiled sample; it reads the metric
after that sample. The first install switches the program's tracer on and
clears it; the second freezes the window's totals (trace.snapshot()) into
probe.state, so the profiled sample is not counted. A port without the
tracer makes install return False, and the metric is left out.
"""

import importlib

KEY = "program_trace"
MODULE = "tophat_tpu_torch.utils.trace"


def install(probe, metric: str) -> bool:
    try:
        trace = importlib.import_module(MODULE)
    except ImportError:
        return False
    st = probe.state.setdefault(KEY, {"installs": {}, "window": None})
    n = st["installs"][metric] = st["installs"].get(metric, 0) + 1
    if n == 1:
        trace.reset()
        trace.enable()
    elif st["window"] is None:
        st["window"] = trace.snapshot()
    return True


def window(probe):
    """The window's frozen totals (None before the second install); the
    tracer is switched off: the window and the profiled sample are over."""
    importlib.import_module(MODULE).disable()
    st = probe.state.get(KEY)
    return st["window"] if st else None


def self_s(probe, match):
    """Self seconds a sample of the spans whose name satisfies
    match(name); None when no such span ran in the window."""
    w = window(probe)
    if w is None or not probe.samples:
        return None
    spans = [s for name, s in w["spans"].items() if match(name)]
    if not any(s["calls"] for s in spans):
        return None
    return sum(s["self_s"] for s in spans) / probe.samples


def counter(probe, name: str):
    """A program counter's total over the window, a sample; None when it
    never counted."""
    w = window(probe)
    if w is None or not probe.samples or name not in w["counters"]:
        return None
    return w["counters"][name] / probe.samples
