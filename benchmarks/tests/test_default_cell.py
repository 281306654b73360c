"""CPU tests of the de novo paired cell with the coverage search on,
fly_default.pe100: found by name with its configuration, mix, limits and
its per-layer metrics (every accepted metric whose layer it runs, the
transcriptome map left out, and its three coverage-phase metrics, which no
other cell lists); a tiny copy of it (the tiny genome, fly_default's flags
and entry, the pe100 mix at a few hundred pairs, the cell's own limits) run
traced is correct and reports every metric the CPU can read; a coverage
search whose events are dropped reaches the program and is read.

    python -m pytest benchmarks/tests -q -p no:cacheprovider
"""

import json
import os
import sys
import time

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from benchmarks.harness import core, spec  # noqa: E402

CELL = "fly_default.pe100"
TINY = "tiny_default.pe100"
NEW = ["cov_islands_s", "cov_mer_table_s", "cov_pair_check_s"]
# The accepted metrics this cell reports: all but transcriptome_map_s,
# whose stage the cell bypasses.
ACCEPTED = ["map_s", "discovery_s", "coverage_search_s", "candidates_s",
            "realign_s", "host_rest_s", "realign_roofline_pct",
            "device_idle_pct", "fastq_parse_s", "event_union_s",
            "junction_filter_s", "pair_select_s", "output_s", "untraced_s",
            "host_syncs", "segment_search_s", "chain_stitch_s"]
# Read from the card's kernels only: the CPU's trace has none.
CARD_ONLY = ["realign_roofline_pct"]


def load(path):
    with open(path) as f:
        return json.load(f)


def test_cell_found_by_name():
    cell = spec.load_cell(ROOT, CELL)
    assert cell.chips == 1
    assert [m["name"] for m in cell.per_layer] == ACCEPTED + NEW
    assert {m["name"] for m in cell.end_to_end} == {
        "reads_per_s", "device_peak_gib", "setup_s"}
    assert cell.traffic == load(os.path.join(ROOT, "benchmarks", "traffic",
                                             "pe100.json"))
    assert set(cell.limits["limits"]) == {
        "unspliced_missed_pct", "spliced_missed_pct", "records_wrong",
        "bed_spurious_pct", "realign_wrong", "events_missed"}
    assert cell.limits["limits"]["records_wrong"] == 0
    assert cell.limits["limits"]["realign_wrong"] == 0
    annotated = load(os.path.join(ROOT, "benchmarks", "configs",
                                  "fly_annotated.json"))
    for block in ("genome", "annotation"):
        assert cell.config[block] == annotated[block], block
    flags = cell.config["tophat_flags"]
    assert "-G" not in flags and "--transcriptome-index" not in flags
    assert "--coverage-search" in flags and "--no-coverage-search" not in flags
    assert cell.config["reduced"] == ["sample_pairs"]
    for name in ("fly_annotated.pe100", "fly_annotated.pe300",
                 "fly_nocov.se100"):
        names = {m["name"] for m in spec.load_cell(ROOT, name).per_layer}
        assert not names & set(NEW), name


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench_cache"))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A BENCHMARK.json and data directory holding the tiny copy of the
    cell."""
    d = tmp_path_factory.mktemp("tiny_default")
    for sub in ("configs", "traffic", "limits"):
        (d / sub).mkdir()
    cfg = load(os.path.join(DATA, "configs", "tiny.json"))
    default = load(os.path.join(ROOT, "benchmarks", "configs",
                                "fly_default.json"))
    cfg.update(tophat_flags=default["tophat_flags"], entry=default["entry"])
    (d / "configs" / "tiny_default.json").write_text(json.dumps(cfg))
    mix = load(os.path.join(ROOT, "benchmarks", "traffic", "pe100.json"))
    mix.update(pairs=384, warm_pairs=64, check_pairs=384, check_rows=64)
    (d / "traffic" / "tiny_pe100.json").write_text(json.dumps(mix))
    (d / "limits" / f"{TINY}.json").write_text(json.dumps(load(
        os.path.join(ROOT, "benchmarks", "limits", f"{CELL}.json"))))
    bench = load(os.path.join(DATA, "BENCHMARK.json"))
    real = load(os.path.join(ROOT, "BENCHMARK.json"))
    bench["configs"].append({"name": "tiny_default", "source": "test",
                             "file": str(d / "configs" / "tiny_default.json"),
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": TINY, "config": "tiny_default",
                               "traffic": "tiny_pe100", "chips": 1,
                               "why": "test"})
    bench["per_layer"] = [dict(m, workloads=[TINY])
                          for m in real["per_layer"]
                          if CELL in m.get("workloads", [])]
    (d / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(d / "BENCHMARK.json"), str(d)


def run(cache, tiny, seed, trace):
    bench, data = tiny
    return core.run_cell(ROOT, TINY, seed, 0.5, trace, time.perf_counter(),
                         device="cpu", bench_path=bench,
                         data_dirs=(data, DATA), cache=cache,
                         log=lambda m: None)


@pytest.fixture(scope="module")
def sound(cache, tiny):
    return run(cache, tiny, 2718281861, True)


def test_tiny_copy_traced_is_correct_and_reports_its_metrics(sound):
    assert sound["correct"] is True, json.dumps(sound["checks"])
    for name in ACCEPTED + NEW:
        if name in CARD_ONLY:
            continue
        v = sound["metrics"][name]["value"]
        assert isinstance(v, float) and v >= 0, name
    assert sound["checks"]["spliced_missed_pct"]["value"] is not None


def test_fault_coverage_events_dropped(cache, tiny, monkeypatch):
    """The coverage search returning no events. No limit of this cell can
    detect a coverage search that returns wrong events: not on this tiny
    copy, where a few hundred pairs make too few islands for the search to
    place a junction that discovery misses, and not at full size either,
    where dropping every coverage event raised `events_missed` by 9 to 12
    a realignment call, inside the spread of the sound seeds (PERF.md gives
    the readings). The comparison with benchmarks/reference/coverage.py that would
    catch it is not a reading of `correct` yet. So this test holds only
    that the fault is planted and reaches the program and that the check
    still reads every number; it passes on the faulty program too."""
    from tophat_tpu_torch.pipeline import run as prun
    from tophat_tpu_torch.pipeline.juncs import empty_events

    search = prun.coverage_search_events
    dropped = []

    def empty(*a, **k):
        dropped.append(len(search(*a, **k)["left"]))
        return empty_events()

    monkeypatch.setattr(prun, "coverage_search_events", empty)
    r = run(cache, tiny, 2718281861, False)
    assert len(dropped) >= 2 and sum(dropped) > 0
    assert r["failed"] == 0
    assert all(v["value"] is not None for v in r["checks"].values())
