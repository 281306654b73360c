"""CPU tests of the port's benchmark harness (benchmarks/).

A tiny configuration and mix (tests/data) run through the harness's
window loop on the CPU; a cell, a mix and a metric added as data alone;
the import check; the reference and the control against planted faults;
the profiler reduction on a hand-made timeline. The card-only test
carries the `gpu` marker and skips without a card.

    python -m pytest benchmarks/tests -q -p no:cacheprovider
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from benchmarks.harness import core, profile  # noqa: E402
from benchmarks.reference import check, control, realign  # noqa: E402

CELL = "tiny.pe100"
BENCH = os.path.join(DATA, "BENCHMARK.json")


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench_cache"))


def run(cache, seed=3, seconds=0.5, trace=False, bench=BENCH, data=(DATA,),
        cell=CELL):
    return core.run_cell(ROOT, cell, seed, seconds, trace,
                         time.perf_counter(),
                         device="cpu", bench_path=bench, data_dirs=data,
                         cache=cache, log=lambda m: None)


def test_window_loop_on_cpu(cache):
    r = run(cache, seconds=1.0)
    assert r["correct"] is True
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"reads_per_s", "device_peak_gib",
                                 "setup_s"}
    assert r["metrics"]["reads_per_s"]["value"] > 0
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == {"unspliced_missed_pct",
                                "spliced_missed_pct", "records_wrong",
                                "bed_spurious_pct", "realign_wrong",
                                "events_missed"}


def test_traced_run_reads_per_layer_metrics(cache):
    r = run(cache, trace=True)
    assert r["correct"] is True
    m = r["metrics"]
    for name in ("map_s", "discovery_s", "coverage_search_s",
                 "candidates_s", "realign_s", "host_rest_s"):
        assert m[name]["value"] >= 0, name
    assert "reads_per_s" not in m
    assert r["device"]["window_s"] > 0
    assert "device_ops" in r["breakdown"] and "idle_gaps" in r["breakdown"]


def test_cell_mix_and_metric_added_as_data(cache, tmp_path):
    """A new cell on a new mix (longer inserts, smaller samples) with a
    new per-layer metric: files and entries only, no edit to the
    harness."""
    data = tmp_path / "data"
    for d in ("traffic", "limits", "metrics"):
        (data / d).mkdir(parents=True)
    mix = json.load(open(os.path.join(DATA, "traffic", "tiny.json")))
    mix.update(pairs=192, inner_dist={"mean": 120, "sd": 30})
    (data / "traffic" / "tiny80.json").write_text(json.dumps(mix))
    shutil.copy(os.path.join(DATA, "limits", "tiny.pe100.json"),
                data / "limits" / "tiny.pe80.json")
    (data / "metrics" / "stats_filter_s.py").write_text(
        'PHASE = "window"\n'
        'def install(probe):\n'
        '    return probe.clock.wrap("tophat_tpu_torch.pipeline.paired:'
        'filter_junctions", "stats_filter_s")\n'
        'def read(probe):\n'
        '    return probe.per_sample("stats_filter_s")\n')
    (data / "metrics" / "gone_s.py").write_text(
        'PHASE = "window"\n'
        'def install(probe):\n'
        '    return probe.clock.wrap("tophat_tpu_torch.pipeline.paired:'
        'no_such_stage", "gone_s")\n'
        'def read(probe):\n'
        '    return probe.per_sample("gone_s")\n')
    bench = json.load(open(BENCH))
    bench["workloads"].append({"name": "tiny.pe80", "config": "tiny",
                               "traffic": "tiny80", "chips": 1,
                               "why": "test"})
    for name in ("stats_filter_s", "gone_s"):
        bench["per_layer"].append({
            "name": name, "unit": "s/sample", "better": "lower",
            "source": "program_span", "layer": "test", "moves":
            "reads_per_s", "workloads": ["tiny.pe80"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    r = run(cache, trace=True, bench=str(path), data=(str(data), DATA),
            cell="tiny.pe80")
    assert r["correct"] is True, json.dumps(r["checks"])
    assert r["metrics"]["stats_filter_s"]["value"] > 0
    assert "gone_s" not in r["metrics"]      # its stage is not there


def test_single_end_cell_added_as_data(cache, tmp_path, monkeypatch):
    """A single-end cell (a mix with `mates: 1`) on a new configuration of
    another genome layout and no annotation: files and entries only; the
    entry point maps it through the single-end streaming pipeline."""
    from tophat_tpu_torch.pipeline import paired, run as prun

    data = tmp_path / "data"
    for d in ("traffic", "limits", "configs"):
        (data / d).mkdir(parents=True)
    mix = json.load(open(os.path.join(DATA, "traffic", "tiny.json")))
    mix.update(mates=1, read_len=75, pairs=384)
    (data / "traffic" / "se75.json").write_text(json.dumps(mix))
    lim = json.load(open(os.path.join(DATA, "limits", "tiny.pe100.json")))
    # discovery alone, as the unannotated default reads on the card:
    # chance junctions in repeats, short anchors missed
    lim["limits"].update(bed_spurious_pct=50.0, spliced_missed_pct=10.0)
    (data / "limits" / "tiny_se.se75.json").write_text(json.dumps(lim))
    cfg = json.load(open(os.path.join(DATA, "configs", "tiny.json")))
    cfg["genome"]["contigs"] = [["c1", 700000], ["c2", 348576]]
    cfg["genome"]["repeats"]["share_of"] = {"c2": 0.2}
    cfg["annotation"]["contigs"] = ["c1", "c2"]
    cfg["tophat_flags"] = ["--tt-index", "{genome_index}"]
    (data / "configs" / "tiny_se.json").write_text(json.dumps(cfg))
    bench = json.load(open(BENCH))
    bench["configs"].append({"name": "tiny_se", "source": "test",
                             "file": str(data / "configs" / "tiny_se.json"),
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny_se.se75", "config": "tiny_se",
                               "traffic": "se75", "chips": 1,
                               "why": "test"})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    entered = []
    for mod, fn in ((paired, "run_pipeline_paired_streaming"),
                    (prun, "run_pipeline_streaming")):
        orig = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _o=orig, _n=fn, **k: (
            entered.append(_n), _o(*a, **k))[1])
    r = run(cache, seconds=1.0, bench=str(path), data=(str(data), DATA),
            cell="tiny_se.se75")
    assert r["correct"] is True, json.dumps(r["checks"])
    assert set(entered) == {"run_pipeline_streaming"}
    assert r["metrics"]["reads_per_s"]["value"] > 0


@pytest.mark.parametrize("name,forbidden", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax", True), ("tophat_tpu", True), ("tophat_tpu.ops.align", True),
    ("tophat_tpu_torch", False), ("tophat_tpu_torch.ops", False),
    ("jaxtyping", False), ("flaxen", False)])
def test_import_check_compares_whole_top_level_names(monkeypatch, name,
                                                     forbidden):
    monkeypatch.setitem(sys.modules, name, object())
    assert (name in core.forbidden_modules()) is forbidden


def test_harness_and_reference_import_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmarks.reference.check, benchmarks.reference.realign\n"
            "import benchmarks.reference.control\n"
            "assert not [m for m in sys.modules if m.partition('.')[0] in\n"
            "            ('tophat_tpu', 'tophat_tpu_torch', 'jax')], 1\n"
            "import benchmarks.harness.core, benchmarks.harness.world\n"
            "import tophat_tpu_torch.cli.main\n"
            "import tophat_tpu_torch.pipeline.paired\n"
            "from benchmarks.harness.core import forbidden_modules\n"
            "assert not forbidden_modules(), forbidden_modules()\n" % ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


def test_run_without_a_card_prints_no_result():
    p = subprocess.run([sys.executable, "benchmarks/run.py", "--workload",
                        "fly_annotated.pe100", "--seed", "1", "--seconds",
                        "1"], cwd=ROOT, capture_output=True, text=True,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    assert p.stdout.strip() == ""


# ---------------------------------------------------------------- faults

def fault(monkeypatch, target, make):
    from benchmarks.harness.clock import resolve

    owner, name = resolve(target)
    monkeypatch.setattr(owner, name, make(getattr(owner, name)))


PIPELINE = "tophat_tpu_torch.pipeline.paired:run_pipeline_paired_streaming"


def test_fault_half_the_batch_left_out(cache, monkeypatch):
    from tophat_tpu_torch.io.fastq import ReadBatch

    def make(fn):
        def half(genome, pair_iter, *a, **k):
            cut = lambda b: ReadBatch(**{
                f: (v[: b.size // 2] if hasattr(v, "__len__") and
                    len(v) == b.size else v)
                for f, v in vars(b).items()})
            return fn(genome, ((cut(x), cut(y)) for x, y in pair_iter),
                      *a, **k)
        return half

    fault(monkeypatch, PIPELINE, make)
    r = run(cache)
    assert r["correct"] is False
    assert r["checks"]["unspliced_missed_pct"]["value"] > 40


def test_fault_step_returns_state_unchanged(cache, monkeypatch):
    fault(monkeypatch, PIPELINE,
          lambda fn: lambda genome, pair_iter, params, out_dir, **k:
          os.makedirs(out_dir, exist_ok=True))
    r = run(cache)
    assert r["correct"] is False
    assert r["checks"]["unspliced_missed_pct"]["value"] == 100.0


def test_fault_realign_answer_altered(cache, monkeypatch):
    def make(fn):
        def altered(*a, **k):
            rows, evs, t, mm = fn(*a, **k)
            t = t.copy()
            t[: max(1, len(t) // 8)] += 1
            return rows, evs, t, mm
        return altered

    fault(monkeypatch, core.REALIGN_ENTRY, make)
    r = run(cache)
    assert r["correct"] is False
    assert r["checks"]["realign_wrong"]["value"] > 0


def test_fault_record_position_altered(cache, monkeypatch):
    def make(fn):
        def shifted(**k):
            k["pos0"] += 1
            return fn(**k)
        return shifted

    fault(monkeypatch, "tophat_tpu_torch.io.sam:format_record", make)
    r = run(cache)
    assert r["correct"] is False
    assert r["checks"]["records_wrong"]["value"] > 0


def test_control_fails_every_number(cache):
    from benchmarks import readings

    res = readings.readings(ROOT, CELL, [21, 22, 23], 3, device="cpu",
                            bench_path=BENCH, data_dirs=(DATA,),
                            cache=cache, log=lambda m: None)
    lim = json.load(open(os.path.join(DATA, "limits",
                                      "tiny.pe100.json")))["limits"]
    for name, limit in lim.items():
        assert res["lower"][name] <= limit, name
        assert res["upper"][name] > limit, name


# ------------------------------------------------------------- reference

def test_control_rounding_is_float32_at_24_bits():
    x = np.random.default_rng(0).integers(0, 1 << 28, 100_000)
    assert np.array_equal(control.f32(x, 24),
                          x.astype(np.float32).astype(np.int64))
    assert control.significand_bits(143_726_002) == 24


def test_true_cigar():
    gp = np.r_[np.arange(10, 40), np.arange(140, 210)]
    assert check.true_cigar(gp) == ("30M100N70M", [(39, 140)], 30)


def test_realign_reference_finds_leftmost_best_split():
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, 4000).astype(np.int8)
    L, left, right = 50, 1000, 2500
    read = np.r_[g[left - 19:left + 1], g[right:right + 30]]
    events = {"left": np.array([left, 3000]), "right": np.array([right,
                                                                 3500]),
              "kind": np.array([0, 0], np.int8),
              "ins_len": np.zeros(2, np.int8),
              "ins_seq": np.full((2, 8), -1, np.int8)}
    rec = realign.records(g, read[None], np.array([L]), events, 2)
    assert (0, 0, 20, 0) in rec
    assert all(e == 0 for _, e, _, _ in rec)


# -------------------------------------------------------------- profiler

def test_union_and_idle_gaps_on_a_hand_made_timeline():
    assert profile.union([(0, 2), (1, 3), (5, 6), (6, 7)]) == [(0, 3),
                                                               (5, 7)]
    t = profile.Trace(
        device=[("k1", 1.0, 2.0), ("k2", 1.5, 2.5), ("copy", 4.0, 4.5),
                ("realign_mma_kernel<1>", 6.0, 7.0)],
        ranges=[("map_s", 0.5, 3.0), ("realign_s", 5.5, 7.5),
                ("candidates_s", 5.0, 8.0)],
        wall=(0.0, 10.0))
    assert t.busy_s() == pytest.approx(3.0)        # 1.5 + 0.5 + 1.0
    assert t.window_s == 10.0
    assert t.device_seconds(lambda n: "realign" in n) == pytest.approx(1.0)
    gaps = t.idle_gaps()
    assert gaps[0] == ("host_rest", pytest.approx(3.0))    # 7 .. 10
    assert ("host_rest", pytest.approx(1.5)) in gaps       # 2.5 .. 4
    assert ("candidates_s", pytest.approx(1.5)) in gaps    # 4.5 .. 6
    assert ("map_s", pytest.approx(1.0)) in gaps           # 0 .. 1
    assert t.top_ops(1) == [("k1", 1.0)] or t.top_ops(1)[0][1] == 1.0


# ------------------------------------------------------------------ card

@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_reference_matches_the_realign_kernel_on_the_card(card):
    import torch
    from tophat_tpu_torch.ops import events as ev

    rng = np.random.default_rng(9)
    g = rng.integers(0, 4, 1 << 16).astype(np.int8)
    E, R, L = 300, 256, 100
    left = rng.integers(200, 30000, E)
    evs = {"left": left, "right": left + rng.integers(70, 5000, E),
           "kind": np.zeros(E, np.int8), "ins_len": np.zeros(E, np.int8),
           "ins_seq": np.full((E, 8), -1, np.int8),
           "valid": np.ones(E, bool)}
    rows = np.stack([np.r_[g[a - t + 1:a + 1], g[b:b + L - t]]
                     for a, b, t in zip(evs["left"][:R], evs["right"][:R],
                                        rng.integers(10, 90, R))])
    got = ev.realign_events_sparse(torch.as_tensor(g, device=card), rows,
                                   np.full(R, L, np.int32), evs, 8)
    call = (rows, np.full(R, L), evs, 8, got)
    assert len(got[0]) >= R
    assert realign.compare(call, g, np.arange(R), device=card) == 0
