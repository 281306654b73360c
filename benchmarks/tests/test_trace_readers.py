"""CPU tests of the readers of the program's own tracer (benchmarks/
metrics/ over benchmarks/harness/program_trace.py): a --trace 1 run of the
tiny cell reports all seven; the second install freezes the window's
totals, so the profiled sample is not counted; a port without the tracer
leaves the metrics out.

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

from benchmarks.harness import clock, core, spec  # noqa: E402

CELL = "tiny.pe100"
METRICS = ("fastq_parse_s", "event_union_s", "junction_filter_s",
           "pair_select_s", "output_s", "untraced_s", "host_syncs")


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return str(tmp_path_factory.mktemp("bench_cache"))


def bench_with_readers(tmp_path) -> str:
    """The tiny cell's BENCHMARK.json with the seven metrics appended."""
    bench = json.load(open(os.path.join(DATA, "BENCHMARK.json")))
    for name in METRICS:
        bench["per_layer"].append({
            "name": name, "unit": "s/sample", "better": "lower",
            "source": "program_span", "layer": "host input and output",
            "moves": "reads_per_s", "workloads": [CELL]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return str(path)


def run(cache, bench):
    return core.run_cell(ROOT, CELL, 3, 0.5, True, time.perf_counter(),
                         device="cpu", bench_path=bench, data_dirs=(DATA,),
                         cache=cache, log=lambda m: None)


def test_traced_run_reports_all_seven(cache, tmp_path):
    from tophat_tpu_torch.utils import trace

    r = run(cache, bench_with_readers(tmp_path))
    assert r["correct"] is True, json.dumps(r["checks"])
    m = r["metrics"]
    for name in METRICS:
        assert m[name]["value"] >= 0, name
    assert m["host_syncs"]["value"] > 0 and m["output_s"]["value"] > 0
    host = sum(m[k]["value"] for k in METRICS[:6])
    assert host <= m["host_rest_s"]["value"] * 1.5 + 0.05
    assert not trace._on                # off once read


def test_second_install_freezes_the_window(tmp_path):
    """install, a window sample, install again, a profiled sample: read
    gives the window's sample alone."""
    from tophat_tpu_torch.utils import trace

    readers = {m: spec.load_reader(m, os.path.join(ROOT, "benchmarks",
                                                   "metrics", m + ".py"))
               for m in ("fastq_parse_s", "host_syncs")}
    probe = core.Probe(clock.Hooks(), None)

    def sample(parse_s, syncs):
        with trace.span(trace.ROOT):
            with trace.span("fastq.parse"):
                time.sleep(parse_s)
            for _ in range(syncs):
                trace.note_sync(8)

    trace.count("host_syncs", 1000)              # before the window
    assert all(r.install(probe) for r in readers.values())
    assert trace._on
    sample(0.05, 3)
    sample(0.05, 3)
    probe.samples = 2
    assert all(r.install(probe) for r in readers.values())
    sample(0.5, 100)                             # the profiled sample
    assert readers["host_syncs"].read(probe) == 3
    assert readers["fastq_parse_s"].read(probe) == pytest.approx(0.05,
                                                                 abs=0.04)
    assert not trace._on


def test_port_without_the_tracer_leaves_the_metrics_out(cache, tmp_path,
                                                       monkeypatch):
    monkeypatch.setitem(sys.modules, "tophat_tpu_torch.utils.trace", None)
    r = run(cache, bench_with_readers(tmp_path))
    assert r["correct"] is True
    assert not set(METRICS) & set(r["metrics"])
    assert "host_rest_s" in r["metrics"]
