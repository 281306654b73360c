"""Stage clocks and call hooks around the port's functions.

StageClock is a copy of the port smoke's StageClock (chip_smoke.py) that
counts self time: a stage nested in another (the transcriptome map inside
read mapping, realignment inside candidates) is taken out of its parent.
With `sync`, it synchronizes the card before and after each call, so a
stage's seconds hold its device work; without, it only marks each call as
a profiler range named by its stage.
"""

from __future__ import annotations

import contextlib
import importlib
import time


def resolve(target: str):
    """(owner, attribute) of 'package.module:attribute' or
    'package.module:Class.attribute'; None when the module, class or
    attribute is no longer there."""
    mod_name, _, attr = target.partition(":")
    try:
        owner = importlib.import_module(mod_name)
    except ImportError:
        return None
    *path, name = attr.split(".")
    for p in path:
        owner = getattr(owner, p, None)
        if owner is None:
            return None
    if name not in vars(owner):
        return None
    return owner, name


class Hooks:
    """Replaces attributes for the life of the object; restore() undoes
    every replacement in reverse order."""

    def __init__(self):
        self._undo = []

    def replace(self, target: str, make) -> bool:
        """Replace target by make(original); False if it is not there."""
        where = resolve(target)
        if where is None:
            return False
        owner, name = where
        saved = vars(owner)[name]
        setattr(owner, name, make(getattr(owner, name)))
        self._undo.append((owner, name, saved))
        return True

    def restore(self):
        for owner, name, saved in reversed(self._undo):
            setattr(owner, name, saved)
        self._undo.clear()


class StageClock:
    """Self seconds and calls per stage label over wrapped functions."""

    def __init__(self, hooks: Hooks, sync=None, label_ranges=False):
        self.hooks = hooks
        self.sync = sync
        self.label_ranges = label_ranges
        self.seconds = {}
        self.calls = {}
        self._stack = []       # seconds of clocked children, per open call

    def wrap(self, target: str, label: str) -> bool:
        def make(fn):
            def timed(*a, **k):
                if self.sync:
                    self.sync()
                t0 = time.perf_counter()
                self._stack.append(0.0)
                rng = contextlib.nullcontext()
                if self.label_ranges:
                    import torch
                    rng = torch.profiler.record_function("stage:" + label)
                try:
                    with rng:
                        return fn(*a, **k)
                finally:
                    if self.sync:
                        self.sync()
                    dt = time.perf_counter() - t0
                    child = self._stack.pop()
                    if self._stack:
                        self._stack[-1] += dt
                    self.seconds[label] = (self.seconds.get(label, 0.0)
                                           + dt - child)
                    self.calls[label] = self.calls.get(label, 0) + 1
            return timed
        return self.hooks.replace(target, make)

    def total(self) -> float:
        return sum(self.seconds.values())
