"""The port's tracer (tophat_tpu_torch/utils/trace.py): spans, self time,
counters and host syncs; tracing off records nothing; both streaming
pipelines traced on an annotated CPU case, every stage span under one
pipeline call and every output file the same with tracing on and off; the
de novo single-end run's segment-search and chain spans and its discovery
and chain counters; the CLI's --trace."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from tophat_tpu_torch.native import bamenc
from tophat_tpu_torch.utils import trace

# every span the streaming pipelines open on an annotated run, and its
# parent
SPANS = {"sample": None, "fastq.parse": "sample", "map": "sample",
         "map.transcriptome": "map", "map.segments": "map",
         "discovery": "sample", "coverage_search": "sample",
         "events.union": "sample", "candidates": "sample",
         "realign": "candidates", "candidates.chains": "candidates",
         "junctions.filter": "sample", "pairs.select": "sample",
         "output": "sample", "output.sam": "output", "output.bam": "output",
         "output.unmapped": "output", "output.beds": "output",
         "output.summary": "output"}
OUTPUTS = ("accepted_hits.sam", "accepted_hits.bam", "unmapped.bam",
           "junctions.bed", "insertions.bed", "deletions.bed",
           "align_summary.txt", "prep_reads.info")
CHUNK = 24          # reads a streamed chunk


@pytest.fixture
def traced():
    trace.reset()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.reset()


def _in_span(name):
    with trace.span(name):
        pass


def test_nesting_self_time_and_samples(traced):
    with trace.span(trace.ROOT):
        with trace.span("a"):
            time.sleep(0.02)
            with trace.span("b"):
                time.sleep(0.03)
                trace.count("n", 2)
            trace.count("n")
        t = threading.Thread(target=_in_span, args=("c",))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    with trace.span(trace.ROOT):
        pass
    snap = trace.snapshot()
    recs = {r.name: r for r in snap["records"] if r.name != "sample"}
    a, b = recs["a"], recs["b"]
    assert (a.parent, b.parent) == ("sample", "a")
    assert a.sample == b.sample == 0
    assert b.wall_s >= 0.03 and a.wall_s >= b.wall_s + 0.02
    assert a.self_s == pytest.approx(a.wall_s - b.wall_s, abs=1e-9)
    assert a.cpu_s < a.wall_s          # sleeping is waiting, not working
    assert (a.counts, b.counts) == ({"n": 1}, {"n": 2})
    assert snap["counters"]["n"] == 3
    assert snap["spans"]["a"]["calls"] == 1
    assert snap["spans"]["a"]["counts"] == {"n": 1}
    assert snap["samples"] == 2
    assert [r.sample for r in snap["records"] if r.name == "sample"] == [0, 1]
    # the other thread's span opened on its own stack: no parent, no
    # pipeline call
    assert (recs["c"].parent, recs["c"].sample) == (None, None)
    assert not trace._stack()


def test_off_records_nothing_and_counters_count(monkeypatch):
    trace.disable()
    trace.reset()
    monkeypatch.setattr(torch.profiler, "record_function", None)
    monkeypatch.setattr(trace, "_sync", None)
    monkeypatch.setattr(trace, "time", None)        # no clock read

    @trace.span("d", sync=True)
    def f():
        trace.count("realign.launches")
        return 7

    with trace.span("e", sync=True):
        assert f() == 7
    snap = trace.snapshot()
    assert snap["records"] == [] and snap["spans"] == {}
    assert snap["counters"] == {"realign.launches": 1}
    trace.reset()


def test_to_host_counts_syncs_and_bytes(traced):
    x = torch.arange(10, dtype=torch.int32)
    with trace.span("s"):
        a = trace.to_host(x)
        b = trace.to_host(x[:3].to(torch.int8))
        c = trace.to_host(np.ones(5))          # host data: no sync
    assert a.tolist() == list(range(10)) and b.dtype == np.int8
    assert c.shape == (5,)
    snap = trace.snapshot()
    assert snap["counters"] == {"host_syncs": 2, "host_sync_bytes": 43}
    assert snap["spans"]["s"]["counts"] == snap["counters"]


def test_spans_name_profiler_ranges(traced):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span(trace.ROOT):
            with trace.span("map"):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert "stage:map" in names
    assert not any(n.startswith("stage:sample") for n in names)


@pytest.fixture(scope="module")
def annotated_case(tmp_path_factory):
    """test_torch_transcriptome's annotated genome and pairs as FASTQ files,
    with the genome index, transcriptome index and known junctions the CLI
    would load (on the CPU)."""
    from test_torch_transcriptome import annotated

    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.index.fm import build_fm_index
    from tophat_tpu_torch.io.gtf import gtf_junctions, parse_gtf
    from tophat_tpu_torch.pipeline.transcriptome import (
        build_transcriptome_index)

    d = tmp_path_factory.mktemp("trace_case")
    codes, gtf, r1, r2 = annotated()
    n = len(codes)
    genome = Genome(codes=codes, offsets=np.array([0, n // 2, n]),
                    names=["chrA", "chrB"])
    (d / "genes.gtf").write_text(gtf)
    transcripts = parse_gtf(str(d / "genes.gtf"))
    known, accept = gtf_junctions(genome, transcripts)
    fqs = []
    for i, recs in enumerate((r1, r2)):
        fq = d / f"r{i + 1}.fq"
        fq.write_text("".join(f"@{nm}/{i + 1}\n{s}\n+\n{q.decode()}\n"
                              for nm, s, q in recs))
        fqs.append(str(fq))
    return dict(genome=genome, fqs=fqs, known=known, accept=accept,
                reads=len(r1),
                fm=build_fm_index(genome, device="cpu"),
                trans=build_transcriptome_index(genome, transcripts,
                                                device="cpu"))


def _run(case, out, mates, traced_run):
    """One streaming run as the CLI makes it once its indexes are loaded;
    the tracer's snapshot of it (None untraced)."""
    from tophat_tpu_torch.pipeline.paired import (
        run_pipeline_paired_streaming)
    from tophat_tpu_torch.pipeline.params import Params
    from tophat_tpu_torch.pipeline.run import (iter_read_batches,
                                               run_pipeline_streaming)

    params = Params()
    batches = lambda f: iter_read_batches([f], params.quals_scale, CHUNK)
    kw = dict(fm=case["fm"], known_events=case["known"],
              gtf_accept=case["accept"], trans=case["trans"],
              log=lambda *a: None, device="cpu")
    trace.reset()
    (trace.enable if traced_run else trace.disable)()
    try:
        if mates == 2:
            run_pipeline_paired_streaming(
                case["genome"], zip(*(batches(f) for f in case["fqs"])),
                params, str(out), **kw)
        else:
            run_pipeline_streaming(case["genome"], batches(case["fqs"][0]),
                                   params, str(out), **kw)
        return trace.snapshot() if traced_run else None
    finally:
        trace.disable()


@pytest.mark.parametrize("mates", [2, 1])
def test_streaming_pipelines_traced(annotated_case, tmp_path, mates):
    """Every stage span, under its parent and one pipeline call; the root's
    self time (what no span covers) under 5% of its wall; counters of the
    sample; the same files with tracing on and off."""
    snap = _run(annotated_case, tmp_path / "on", mates, True)
    _run(annotated_case, tmp_path / "off", mates, False)
    for f in OUTPUTS:
        assert (tmp_path / "on" / f).read_bytes() == \
            (tmp_path / "off" / f).read_bytes(), f
    recs = snap["records"]
    assert {r.sample for r in recs} == {0} and snap["samples"] == 1
    seen = {r.name: r.parent for r in recs}
    for name, parent in SPANS.items():
        assert seen.get(name, "missing") == parent, name
    root = _adds_up(recs)
    assert root.self_s < 0.05 * root.wall_s
    sp = snap["spans"]
    chunks = -(-annotated_case["reads"] // CHUNK)
    assert sp["map"]["calls"] == mates * chunks > mates
    # each chunk's parse, and the first file's parse that finds its end
    assert sp["fastq.parse"]["calls"] == mates * chunks + 1
    c = snap["counters"]
    sam = (tmp_path / "on" / "accepted_hits.sam").read_text().splitlines()
    assert c["records"] == len(sam) > 0
    assert c["events"] >= len(annotated_case["known"]["left"])
    assert c["realign.rows"] > 0 and c["segments"] > 0
    assert c["coverage.islands"] > 0
    assert c["host_syncs"] > 0 and c["host_sync_bytes"] > 0
    assert sp["realign"]["counts"]["realign.rows"] == c["realign.rows"]
    # the one emitter formats every record natively when its library
    # loads; records with extra tags are the single-end secondaries (CC/CP)
    extra = sum(1 for ln in sam if "\tCC:Z:" in ln or "\tXF:Z:" in ln)
    assert c["records.extra"] == extra
    assert (extra > 0) == (mates == 1)
    assert c["records.native"] == (c["records"] if bamenc.available else 0)
    assert sp["output.sam"]["counts"] == {
        "records": c["records"], "records.native": c["records.native"],
        "records.extra": extra}
    assert "junctions.shadowed" in sp["junctions.filter"]["counts"]


def _adds_up(recs):
    """Every record under one pipeline call, no span's children longer
    than itself, and the self times of all spans summing to the root's
    wall; the root's record."""
    root = next(r for r in recs if r.name == trace.ROOT)
    assert {r.sample for r in recs} == {0}
    assert all(r.self_s >= 0 for r in recs)
    assert sum(r.self_s for r in recs) == pytest.approx(root.wall_s,
                                                        rel=1e-6)
    return root


@pytest.fixture(scope="module")
def multi_junction_case(tmp_path_factory):
    """A 40-kb genome holding one gene of four exons (60/30/30/60 bp,
    GT..AG introns of 180, 150 and 220 bp), as test_chains_default builds
    it, and a FASTQ of 100-bp reads at every second offset of its
    transcript: most cross two or three introns, a few one."""
    from tophat_tpu_torch.index.fasta import Genome, decode_seq
    from tophat_tpu_torch.index.fm import build_fm_index

    rng = np.random.default_rng(11)
    n = 40_000
    codes = rng.integers(0, 4, n).astype(np.int8)
    exons, p = [], 5_000
    for el, il in zip((60, 30, 30, 60), (180, 150, 220, 0)):
        exons.append((p, p + el))
        if il:
            codes[p + el:p + el + 2] = (2, 3)                 # GT
            codes[p + el + il - 2:p + el + il] = (0, 2)       # AG
        p += el + il
    tx = np.concatenate([codes[a:b] for a, b in exons])
    genome = Genome(codes=codes, offsets=np.array([0, n]), names=["chrT"])
    fq = tmp_path_factory.mktemp("multi_junction") / "reads.fq"
    starts = range(0, len(tx) - 100 + 1, 2)
    fq.write_text("".join(f"@r{s}\n{decode_seq(tx[s:s + 100])}\n+\n"
                          f"{'I' * 100}\n" for s in starts))
    juncs = {(a[1] - 1, b[0]) for a, b in zip(exons, exons[1:])}
    return dict(genome=genome, fq=str(fq), reads=len(starts), juncs=juncs,
                fm=build_fm_index(genome, device="cpu"))


def test_de_novo_single_end_spans_and_counters(multi_junction_case,
                                               tmp_path, monkeypatch):
    """An unannotated single-end streaming run with the coverage search
    off, as the CLI makes it with a tmp dir: `map.segments` once a chunk
    inside `map`, `candidates.chains` once a chunk inside `candidates`,
    the discovery counters equal to the tables discover_events returned,
    `chains.found` equal to the chains that joined candidate lists, and
    the span tree nesting and adding up."""
    from tophat_tpu_torch.ops.splice import (KIND_DELETION, KIND_INSERTION,
                                             KIND_JUNCTION)
    from tophat_tpu_torch.pipeline import run as prun
    from tophat_tpu_torch.pipeline.params import Params

    case = multi_junction_case
    tables, chains = [], []
    discover, select = prun.discover_events, prun._select

    def discover_kept(*a, **k):
        tables.append(discover(*a, **k))
        return tables[-1]

    def select_seen(m, *a, **k):
        chains.extend(c for cl in m.cands.values() for c in cl
                      if c.kind == -2)
        return select(m, *a, **k)

    monkeypatch.setattr(prun, "discover_events", discover_kept)
    monkeypatch.setattr(prun, "_select", select_seen)
    params = Params(coverage_search=False)
    out = tmp_path / "out"
    trace.reset()
    trace.enable()
    try:
        res = prun.run_pipeline_streaming(
            case["genome"], prun.iter_read_batches([case["fq"]],
                                                   params.quals_scale,
                                                   CHUNK),
            params, str(out), fm=case["fm"], tmp_dir=str(out / "tmp"),
            log=lambda *a: None, device="cpu")
        snap = trace.snapshot()
    finally:
        trace.disable()
        trace.reset()
    chunks = -(-case["reads"] // CHUNK)
    recs = snap["records"]
    root = _adds_up(recs)
    assert root.self_s < 0.05 * root.wall_s
    sp = snap["spans"]
    for name, parent in (("map.segments", "map"),
                         ("candidates.chains", "candidates"),
                         ("chunk.artifact", "sample")):
        assert {r.parent for r in recs if r.name == name} == {parent}, name
    assert sp["map.segments"]["calls"] == sp["map"]["calls"] == chunks > 1
    assert sp["candidates.chains"]["calls"] == chunks
    assert "coverage_search" not in sp
    assert sp["map.segments"]["counts"]["segments"] == \
        snap["counters"]["segments"] > 0
    c = snap["counters"]
    assert len(tables) == chunks
    for name, kind in (("discovery.junctions", KIND_JUNCTION),
                       ("discovery.insertions", KIND_INSERTION),
                       ("discovery.deletions", KIND_DELETION)):
        assert c[name] == sum(int((t["kind"] == kind).sum())
                              for t in tables), name
    assert c["discovery.junctions"] > 0
    # the chains joined the reads' candidate lists, and the three introns
    # reached the junction track through them and the one-event reads
    assert c["chains.found"] == len(chains) > 0
    assert 0 < c["chains.rows"]
    assert sp["candidates.chains"]["counts"]["chains.found"] == len(chains)
    ev = res["events"]
    for lt, rt in case["juncs"]:
        assert ((ev["left"] == lt) & (ev["right"] == rt)).any()


def test_junction_filter_counts_shadowed():
    """junctions.shadowed counts exactly the junctions that pass acceptance
    but that the JAX package's shadow knockout rejects (tracing off: the
    counter counts all the same)."""
    import types

    from test_torch_junction_filter import clustered, run_both, shadowed

    rows, _ = clustered(23, 6, 40)
    params = types.SimpleNamespace(min_anchor_len=8, splice_mismatches=2)
    trace.reset()
    got, want, alone = run_both(rows, params, None)
    assert got == want
    n = trace.snapshot()["counters"]["junctions.shadowed"]
    assert n == len(shadowed(want, alone)) > 0
    trace.reset()


def test_cli_trace_writes_trace_json(tmp_path, monkeypatch):
    """--trace writes logs/trace.json (every span's calls and seconds,
    every counter); without it nothing is written and nothing traced."""
    from test_torch_paired import _pairs

    from tophat_tpu_torch.cli.main import main

    monkeypatch.setenv("TOPHAT_TPU_DEVICES", "1")
    codes, r1, r2 = _pairs(30000, seed=8)
    (tmp_path / "g.fa").write_text(
        ">chrA\n" + "".join("ACGTN"[c] for c in codes) + "\n")
    fqs = []
    for i, recs in enumerate((r1, r2)):
        fq = tmp_path / f"r{i + 1}.fq"
        fq.write_text("".join(f"@{nm}/{i + 1}\n{s}\n+\n{q.decode()}\n"
                              for nm, s, q in recs))
        fqs.append(str(fq))
    args = ["--device", "cpu", "--batch-size", "40", str(tmp_path / "g.fa")]
    assert main(["-o", str(tmp_path / "on"), "--trace"] + args + fqs) == 0
    assert not trace._on
    got = json.loads((tmp_path / "on" / "logs" / "trace.json").read_text())
    assert got["samples"] == 1
    # 2 files x 2 chunks, and the first file's parse that finds its end
    assert got["spans"]["fastq.parse"]["calls"] == 5
    for name in set(SPANS) - {"map.transcriptome"}:
        s = got["spans"][name]
        assert s["calls"] >= 1 and s["wall_s"] >= s["self_s"] >= 0, name
    assert got["counters"]["records"] > 0
    assert got["counters"]["host_syncs"] > 0
    trace.reset()
    assert main(["-o", str(tmp_path / "off")] + args + fqs) == 0
    assert not (tmp_path / "off" / "logs" / "trace.json").exists()
    assert trace.snapshot()["records"] == []
    assert (tmp_path / "on" / "accepted_hits.sam").read_bytes() == \
        (tmp_path / "off" / "accepted_hits.sam").read_bytes()
