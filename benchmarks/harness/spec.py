"""Finding a cell and everything that belongs to it, by name.

BENCHMARK.json names the cells, their configurations (by file) and their
metrics. A traffic mix is `traffic/<mix>.json`, a per-layer metric's reader
`metrics/<metric>.py`, the program's entry point that a configuration
names (`"entry"`, default "streaming") `entries/<entry>.py`, and a cell's
limits for `correct` `limits/<cell>.json`, each looked up in the data
directories in order (the benchmark's own folder last), so a cell, a mix,
an entry point or a metric is added by adding files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list          # BENCHMARK.json entries that this cell reports
    per_layer: list
    metric_files: dict        # per-layer metric name -> reader file
    entry_file: str           # the program's entry point (entries/)


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def find(data_dirs, kind: str, name: str, ext: str) -> str:
    for d in list(data_dirs) + [HERE]:
        path = os.path.join(d, kind, name + ext)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no {kind}/{name}{ext} in "
                            f"{list(data_dirs) + [HERE]}")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: str, name: str, bench_path=None, data_dirs=()) -> Cell:
    """The cell `name` of the BENCHMARK.json at bench_path (default: the
    checkout root's)."""
    bench = load_json(bench_path or os.path.join(root, "BENCHMARK.json"))
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = load_json(os.path.join(root, c["file"]))
    traffic = load_json(find(data_dirs, "traffic", w["traffic"], ".json"))
    limits = load_json(find(data_dirs, "limits", name, ".json"))
    per_layer = [m for m in bench["per_layer"] if _applies(m, name)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=per_layer,
                metric_files={m["name"]: find(data_dirs, "metrics",
                                              m["name"], ".py")
                              for m in per_layer},
                entry_file=find(data_dirs, "entries",
                                config.get("entry", "streaming"), ".py"))


def load_module(prefix: str, name: str, path: str):
    spec = importlib.util.spec_from_file_location(
        prefix + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_entry(name: str, path: str):
    """The module of an entry point: run(world, fastq files, out_dir,
    log) maps the files' reads into out_dir as the program's CLI would."""
    return load_module("bench_entry_", name, path)


def load_reader(name: str, path: str):
    """The module of one per-layer metric's reader. A reader has PHASE,
    "window" (read from the stage-clocked window of a --trace 1 run) or
    "profile" (read from the sample profiled after it); install(probe) ->
    bool, optional, which puts its hooks on the port (harness/core.Probe)
    and says whether their targets are there; and read(probe) -> float,
    or None when it finds nothing to read."""
    return load_module("bench_metric_", name, path)
