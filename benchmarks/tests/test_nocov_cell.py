"""CPU tests of the de novo single-end cell, fly_nocov.se100: found by name
with its configuration, mix, limits and its two per-layer metrics alone; a
tiny copy of it (the tiny genome, fly_nocov's flags and entry, the se100
mix at a few hundred reads, the cell's own limits) run traced is correct
and reports both metrics; discovery that drops every other junction turns
`correct` false.

    python -m pytest benchmarks/tests -q -p no:cacheprovider
"""

import json
import os
import sys
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from benchmarks.harness import core, spec  # noqa: E402

CELL = "fly_nocov.se100"
TINY = "tiny_nocov.se100"
NEW = ["segment_search_s", "chain_stitch_s"]
ANNOTATED = ["map_s", "transcriptome_map_s", "discovery_s",
             "coverage_search_s", "candidates_s", "realign_s", "host_rest_s",
             "realign_roofline_pct", "device_idle_pct", "fastq_parse_s",
             "event_union_s", "junction_filter_s", "pair_select_s",
             "output_s", "untraced_s", "host_syncs"]


def load(path):
    with open(path) as f:
        return json.load(f)


def test_cell_found_by_name():
    cell = spec.load_cell(ROOT, CELL)
    assert cell.chips == 1
    assert [m["name"] for m in cell.per_layer] == NEW
    assert {m["name"] for m in cell.end_to_end} == {
        "reads_per_s", "device_peak_gib", "setup_s"}
    assert cell.traffic["mates"] == 1 and cell.traffic["pairs"] == 65536
    assert set(cell.limits["limits"]) == {
        "unspliced_missed_pct", "spliced_missed_pct", "records_wrong",
        "bed_spurious_pct", "realign_wrong", "events_missed"}
    assert cell.limits["limits"]["records_wrong"] == 0
    assert cell.limits["limits"]["realign_wrong"] == 0
    annotated = load(os.path.join(ROOT, "benchmarks", "configs",
                                  "fly_annotated.json"))
    for block in ("genome", "annotation"):
        assert cell.config[block] == annotated[block], block
    assert "-G" not in cell.config["tophat_flags"]
    assert "--no-coverage-search" in cell.config["tophat_flags"]
    for name in ("fly_annotated.pe100", "fly_annotated.pe300"):
        assert [m["name"] for m in spec.load_cell(ROOT, name).per_layer] \
            == ANNOTATED, name


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench_cache"))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A BENCHMARK.json and data directory holding the tiny copy of the
    cell."""
    d = tmp_path_factory.mktemp("tiny_nocov")
    for sub in ("configs", "traffic", "limits"):
        (d / sub).mkdir()
    cfg = load(os.path.join(DATA, "configs", "tiny.json"))
    nocov = load(os.path.join(ROOT, "benchmarks", "configs",
                              "fly_nocov.json"))
    cfg.update(tophat_flags=nocov["tophat_flags"], entry=nocov["entry"])
    (d / "configs" / "tiny_nocov.json").write_text(json.dumps(cfg))
    mix = load(os.path.join(ROOT, "benchmarks", "traffic", "se100.json"))
    mix.update(pairs=384, warm_pairs=64, check_pairs=384, check_rows=64)
    (d / "traffic" / "tiny_se100.json").write_text(json.dumps(mix))
    (d / "limits" / f"{TINY}.json").write_text(json.dumps(load(
        os.path.join(ROOT, "benchmarks", "limits", f"{CELL}.json"))))
    bench = load(os.path.join(DATA, "BENCHMARK.json"))
    real = load(os.path.join(ROOT, "BENCHMARK.json"))
    bench["configs"].append({"name": "tiny_nocov", "source": "test",
                             "file": str(d / "configs" / "tiny_nocov.json"),
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": TINY, "config": "tiny_nocov",
                               "traffic": "tiny_se100", "chips": 1,
                               "why": "test"})
    bench["per_layer"] = [dict(m, workloads=[TINY])
                          for m in real["per_layer"] if m["name"] in NEW]
    (d / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(d / "BENCHMARK.json"), str(d)


def run(cache, tiny, seed, trace):
    bench, data = tiny
    return core.run_cell(ROOT, TINY, seed, 0.5, trace, time.perf_counter(),
                         device="cpu", bench_path=bench,
                         data_dirs=(data, DATA), cache=cache,
                         log=lambda m: None)


def test_tiny_copy_traced_is_correct_and_reports_both(cache, tiny):
    r = run(cache, tiny, 2718281851, True)
    assert r["correct"] is True, json.dumps(r["checks"])
    for name in NEW:
        v = r["metrics"][name]["value"]
        assert isinstance(v, float) and v >= 0, name
    assert r["checks"]["spliced_missed_pct"]["value"] is not None


def test_fault_discovery_drops_every_other_junction(cache, tiny,
                                                    monkeypatch):
    from tophat_tpu_torch.ops.splice import KIND_JUNCTION
    from tophat_tpu_torch.pipeline import run as prun

    discover = prun.discover_events

    def half(*a, **k):
        ev = discover(*a, **k)
        j = np.nonzero(ev["kind"] == KIND_JUNCTION)[0]
        keep = np.ones(len(ev["kind"]), bool)
        keep[j[1::2]] = False
        return {n: v[keep] for n, v in ev.items()}

    monkeypatch.setattr(prun, "discover_events", half)
    r = run(cache, tiny, 2718281851, False)
    assert r["correct"] is False
    c = r["checks"]
    assert (c["events_missed"]["value"] > c["events_missed"]["limit"]
            or c["spliced_missed_pct"]["value"]
            > c["spliced_missed_pct"]["limit"]), json.dumps(c)
