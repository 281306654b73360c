"""Fusion-search parity: the port's FF fusion windows and their scan, the
FR/RF anchor pairs, their split scan and per-event realignment, the
cross-strand chains, the sparse realign over fusion events, the fusion
table and whole --fusion-search runs (single-end and paired, one batch and
chunked) against the JAX package on a synthetic three-contig genome with
intra- and inter-contig ff, fr and rf breaks, a junction and a deletion —
exact equality of every integer output and every output file.

Numpy only at import time: test_torch_gpu.py reuses the workload."""

import numpy as np
import pytest
import torch

NAMES = ["chrA", "chrB", "chrC"]
CONTIGS = (30000, 20000, 25000)
L = 76
FILES = ("accepted_hits.sam", "junctions.bed", "insertions.bed",
         "deletions.bed", "fusions.out")
PARAMS = dict(fusion_search=True, max_intron_length=1000,
              fusion_min_dist=2000, fusion_anchor_length=13,
              coverage_search=False)


def _rc(s):
    return np.where(s < 4, 3 - s, s)[::-1].astype(np.int8)


def _fusion_read(codes, d, a, b, t, n):
    """n bases across a break after t read bases: ff = genome[..a] +
    genome[b..]; fr = genome[..a] + revcomp(genome[..b]); rf =
    revcomp(genome[a..]) + genome[b..]."""
    if d == "ff":
        return np.concatenate([codes[a - t + 1:a + 1], codes[b:b + n - t]])
    if d == "fr":
        return np.concatenate([codes[a - t + 1:a + 1],
                               _rc(codes[b - (n - t) + 1:b + 1])])
    return np.concatenate([_rc(codes[a:a + t]), codes[b:b + n - t]])


def _mate2(codes, d, b, t, gap):
    """Mate 2 of a break read: downstream of the partner piece, on the
    strand a fragment across the break puts it."""
    if d == "fr":
        q = b - (L - t) - gap - L + 1
        return codes[q:q + L].copy()
    q = b + L - t + gap
    return _rc(codes[q:q + L])


def fusion_workload(seed=5):
    """(codes, offsets, mate-1 records, mate-2 records, designed breaks
    [(dir, a, b)], {break read name: (contig, 1-based POS, CIGAR) of its
    record at the true break}). Mate 1: six breaks (ff, fr, rf; one intra- and one
    inter-contig each), 5 reads each with 25..50 bases before the break
    plus one with a 14-base piece (and a mismatch in every third read);
    fr reads whose first piece crosses a GT-AG intron; reads across that
    intron and across a 2-bp deletion; contiguous reads. Mate 2 lies
    downstream of the read's last piece; spanning pairs put one mate on
    each partner."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, sum(CONTIGS)).astype(np.int8)
    offs = np.concatenate([[0], np.cumsum(CONTIGS)]).astype(np.int64)
    pos = lambda c, lo, hi: int(offs[c] + rng.integers(lo, hi))
    gap = lambda: max(0, int(round(rng.normal(50, 20))))
    ia = pos(0, 20000, 26000)
    il = 300
    codes[ia:ia + 2] = [2, 3]
    codes[ia + il - 2:ia + il] = [0, 2]
    dl = pos(1, 8000, 10000)
    m1, m2, breaks, truth = [], [], [], {}
    for d, ca, cb in [("ff", 0, 1), ("ff", 2, 2), ("fr", 1, 2),
                      ("fr", 0, 0), ("rf", 0, 2), ("rf", 1, 1)]:
        a = pos(ca, 1000, 6000)
        b = pos(cb, 12000, 18000)
        breaks.append((d, a, b))
        for k in range(6):
            t = 14 if k == 5 else int(rng.integers(25, L - 25))
            s = _fusion_read(codes, d, a, b, t, L)
            at, cig = ((b, f"{t}S{L - t}M") if d == "rf"
                       else (a - t + 1, f"{t}M{L - t}S"))
            c = int(np.searchsorted(offs, at, side="right")) - 1
            truth[f"p{len(m1)}"] = (NAMES[c], int(at - offs[c]) + 1, cig)
            if k % 3 == 1:
                p = int(rng.integers(0, L))
                s[p] = (s[p] + 1) % 4
            m1.append(s)
            m2.append(_mate2(codes, d, b, t, gap()))
        for k in range(2):                       # spanning pairs
            x = int(rng.integers(L + 20, 200))
            m1.append(codes[a - x + 1:a - x + 1 + L].copy())
            m2.append(_mate2(codes, d, b, int(rng.integers(-150, -20)),
                             0))
    fb = pos(2, 19000, 22000)                    # fr with a spliced piece
    for k in range(3):
        t1 = 30 + k
        piece = np.concatenate([codes[ia - t1:ia], codes[ia + il:ia + il + 20]])
        s = np.concatenate([piece, _rc(codes[fb - (L - t1 - 20) + 1:fb + 1])])
        m1.append(s)
        m2.append(_mate2(codes, "fr", fb, t1 + 20, gap()))
    for k in range(6):                           # junction reads
        t = int(rng.integers(20, L - 20))
        m1.append(np.concatenate([codes[ia - t:ia],
                                  codes[ia + il:ia + il + L - t]]))
        q = ia + il + L - t + gap()
        m2.append(_rc(codes[q:q + L]))
    for k in range(4):                           # deletion reads
        t = int(rng.integers(26, L - 26))
        m1.append(np.concatenate([codes[dl - t:dl],
                                  codes[dl + 2:dl + 2 + L - t]]))
        q = dl + 2 + L - t + gap()
        m2.append(_rc(codes[q:q + L]))
    for k in range(14):                          # contiguous pairs
        c = int(rng.integers(0, 3))
        p = pos(c, 200, CONTIGS[c] - 600)
        m1.append(codes[p:p + L].copy())
        q = p + L + gap()
        m2.append(_rc(codes[q:q + L]))
    rec = lambda i, s: (f"p{i}", "".join("ACGTN"[c] for c in s),
                        b"I" * len(s))
    return (codes, offs, [rec(i, s) for i, s in enumerate(m1)],
            [rec(i, s) for i, s in enumerate(m2)], breaks, truth)


def break_recall(sam_path, truth):
    """Share of the break reads whose mate-1 record lies at the true break
    (contig, POS and the clipped CIGAR)."""
    found = set()
    with open(sam_path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            x = line.split("\t")
            if int(x[1]) & 128 == 0 and truth.get(x[0]) == (
                    x[2], int(x[3]), x[5]):
                found.add(x[0])
    return len(found) / len(truth)


def write_inputs(path):
    """FASTA + mate FASTQ files of fusion_workload; returns (fa, fq1, fq2,
    truth)."""
    codes, offs, r1, r2, _, truth = fusion_workload()
    fa = path / "g.fa"
    with open(fa, "w") as f:
        for i, name in enumerate(NAMES):
            f.write(f">{name}\n" + "".join(
                "ACGT"[c] for c in codes[offs[i]:offs[i + 1]]) + "\n")
    fqs = []
    for k, recs in ((1, r1), (2, r2)):
        fq = path / f"r_{k}.fq"
        with open(fq, "w") as f:
            for name, seq, qual in recs:
                f.write(f"@{name}\n{seq}\n+\n{qual.decode()}\n")
        fqs.append(str(fq))
    return str(fa), fqs[0], fqs[1], truth


def _pkg(which):
    if which == "jax":
        from tophat_tpu.index.fasta import Genome
        from tophat_tpu.io.fastq import batch_reads
        from tophat_tpu.pipeline import paired, run
        from tophat_tpu.pipeline.params import Params
        return Genome, batch_reads, Params, run, paired, {}
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.io.fastq import batch_reads
    from tophat_tpu_torch.pipeline import paired, run
    from tophat_tpu_torch.pipeline.params import Params
    return Genome, batch_reads, Params, run, paired, {"device": "cpu"}


def map_workload():
    """Genome-space rows of every mate-1 read (pow2 padded), their segment
    tables (host numpy) from the port's CPU index, and the event table of
    discovery with fusion search on."""
    from tophat_tpu_torch.index.fm import build_fm_index
    from tophat_tpu_torch.ops.align import pad_reads
    from tophat_tpu_torch.index.fasta import encode_seq
    from tophat_tpu_torch.pipeline.juncs import discover_events
    from tophat_tpu_torch.pipeline.params import Params
    from tophat_tpu_torch.pipeline.segment import (build_genome_space,
                                                   map_segments)

    codes, offs, r1, _, _, _ = fusion_workload()
    rf, rr, lens = pad_reads([encode_seq(s) for _, s, _ in r1])
    gs = build_genome_space(rf, rr, lens, 25, pad_rows_pow2=True)
    fm = build_fm_index(codes, device="cpu")
    tables = map_segments(fm, offs, gs, segment_mismatches=2,
                          hits_per_seed=32, max_hits=16)
    events = discover_events(fm, offs, gs, Params(**PARAMS),
                             seg_tables=tables)
    return codes, offs, gs, tuple(a.numpy() for a in tables), events


@pytest.fixture(scope="module")
def mapped():
    return map_workload()


def _jt(a):
    import jax.numpy as jnp
    return jnp.asarray(np.asarray(a))


def test_fusion_windows_match_jax(mapped):
    import tophat_tpu.ops.splice as J
    from tophat_tpu_torch.ops import splice

    codes, offs, gs, (pos, _, valid), _ = mapped
    sup_max = int(np.max(gs.cuts[:, 1:] - gs.cuts[:, :-1])) + 17
    jw = J.build_fusion_windows(_jt(pos), _jt(valid), _jt(gs.cuts),
                                _jt(gs.nseg), _jt(gs.lengths), offs, 2000)
    t = lambda a: torch.as_tensor(a).long()
    w = splice.build_fusion_windows(torch.as_tensor(pos),
                                    torch.as_tensor(valid), t(gs.cuts),
                                    t(gs.nseg), t(gs.lengths), offs, 2000)
    for f in ("row", "gl", "gr", "sup_start", "sup_len", "valid"):
        np.testing.assert_array_equal(getattr(w, f).numpy(),
                                      np.asarray(getattr(jw, f)), f)
    jw, _ = J.compact_windows(jw, 4096)
    w, ovf = splice.compact_windows(w, 4096)
    assert not ovf and int(w.valid.sum()) >= 8
    want = J.scan_fusion_windows(_jt(codes), _jt(gs.readsg), jw, sup_max)
    got = splice.scan_fusion_windows(torch.as_tensor(codes),
                                     torch.as_tensor(gs.readsg), w, sup_max)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got[3].sum()) >= 8


@pytest.mark.parametrize("pattern", ["prefix", "suffix"])
def test_fr_pairs_and_scan_match_jax(mapped, pattern):
    import tophat_tpu.ops.fusion_fr as J
    from tophat_tpu_torch.ops import fusion_fr

    codes, _, gs, (pos, _, valid), _ = mapped
    R = gs.rows // 2
    jp = J.build_fr_pairs(_jt(pos), _jt(valid), _jt(gs.cuts),
                          _jt(gs.lengths), 4096)
    p, ovf = fusion_fr.build_fr_pairs(
        torch.as_tensor(pos), torch.as_tensor(valid),
        torch.as_tensor(gs.cuts), torch.as_tensor(gs.lengths), 4096)
    assert not ovf and int(p.valid.sum()) > 10
    for f in ("read", "anchor_a", "anchor_b", "valid"):
        np.testing.assert_array_equal(getattr(p, f).numpy(),
                                      np.asarray(getattr(jp, f)), f)
    rg = gs.readsg
    want = J.scan_fr_pairs(_jt(codes), _jt(rg[:R]), _jt(rg[R:]),
                           _jt(gs.lengths[:R]), jp, rg.shape[1], pattern)
    g = torch.as_tensor(rg)
    got = fusion_fr.scan_fr_pairs(torch.as_tensor(codes), g[:R], g[R:],
                                  torch.as_tensor(gs.lengths[:R]), p,
                                  rg.shape[1], pattern)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got[4].sum()) >= 3


def test_fr_pair_cap_keeps_jax_order_and_warns(mapped):
    """A cap below the valid count keeps the JAX package's first `cap`
    combos and says so; find_fr_fusions warns at its cap."""
    import tophat_tpu.ops.fusion_fr as J
    from tophat_tpu_torch.index.fm import build_fm_index
    from tophat_tpu_torch.ops import fusion_fr
    from tophat_tpu_torch.pipeline.params import Params

    codes, _, gs, (pos, mm, valid), _ = mapped
    jp = J.build_fr_pairs(_jt(pos), _jt(valid), _jt(gs.cuts),
                          _jt(gs.lengths), 5)
    p, ovf = fusion_fr.build_fr_pairs(
        torch.as_tensor(pos), torch.as_tensor(valid),
        torch.as_tensor(gs.cuts), torch.as_tensor(gs.lengths), 5)
    assert ovf
    np.testing.assert_array_equal(p.read.numpy(), np.asarray(jp.read))
    np.testing.assert_array_equal(p.anchor_b.numpy(),
                                  np.asarray(jp.anchor_b))
    fm = build_fm_index(codes, device="cpu")
    with pytest.warns(UserWarning, match="FR/RF anchor pairs overflowed"):
        fusion_fr.find_fr_fusions(fm, gs, (pos, mm, valid), Params(), cap=5)


@pytest.mark.parametrize("pattern", ["fr", "rf"])
def test_realign_fr_events_match_jax(mapped, pattern, monkeypatch):
    """Every read against the discovered cross-strand breaks plus random
    ones (some off the genome's ends), in row chunks smaller than R."""
    import tophat_tpu.ops.fusion_fr as J
    from tophat_tpu_torch.ops import fusion_fr

    codes, _, gs, _, _ = mapped
    R = gs.rows // 2
    rng = np.random.default_rng(3)
    n = len(codes)
    pa = rng.integers(-20, n + 20, 40).astype(np.int32)
    pb = rng.integers(-20, n + 20, 40).astype(np.int32)
    valid = np.arange(40) % 7 != 3
    rg = gs.readsg
    want = J.realign_fr_events(_jt(codes), _jt(rg[:R]), _jt(rg[R:]),
                               _jt(gs.lengths[:R]), _jt(pa), _jt(pb),
                               _jt(valid), pattern)
    monkeypatch.setattr(fusion_fr, "_CHUNK_ELEMS", 40 * L * 9)
    g = torch.as_tensor(rg)
    got = fusion_fr.realign_fr_events(
        torch.as_tensor(codes), g[:R], g[R:], torch.as_tensor(gs.lengths[:R]),
        torch.as_tensor(pa), torch.as_tensor(pb), torch.as_tensor(valid),
        pattern)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_find_fr_fusions_matches_jax(mapped):
    import types

    from tophat_tpu.ops.fusion_fr import find_fr_fusions as jfind
    from tophat_tpu_torch.ops.fusion_fr import find_fr_fusions
    from tophat_tpu_torch.pipeline.params import Params

    codes, _, gs, tables, _ = mapped
    want = jfind(types.SimpleNamespace(genome=_jt(codes)), gs, tables, None,
                 Params())
    got = find_fr_fusions(types.SimpleNamespace(
        genome=torch.as_tensor(codes)), gs, tables, Params())
    assert [r["pattern"] for r in got] == ["fr", "rf"]
    assert [r["pattern"] for r in want] == ["fr", "rf"]
    for a, b in zip(got, want):
        for k in ("read", "t", "posA", "posB", "mm"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], k)


def test_cross_strand_chains_match_jax(mapped):
    """Chains over every row, FR/RF chains whose pieces cross the intron
    or the deletion, from the event table with fusions in it; the port
    computes the segment event hits once for both."""
    import types

    from tophat_tpu.pipeline.chains import chain_stitch as jstitch
    from tophat_tpu.pipeline.chains import cross_strand_chains as jcross
    from tophat_tpu_torch.ops.fusion_fr import find_fr_fusions
    from tophat_tpu_torch.pipeline import chains
    from tophat_tpu_torch.pipeline.params import Params

    codes, _, gs, tables, events = mapped
    assert (events["kind"] == 3).sum() >= 2 and (events["kind"] == 0).any()
    fm = types.SimpleNamespace(genome=torch.as_tensor(codes),
                               genome_host=codes)
    jfm = types.SimpleNamespace(genome=_jt(codes))
    fr_events = {"fr": (), "rf": ()}
    for res in find_fr_fusions(fm, gs, tables, Params()):
        fr_events[res["pattern"]] = tuple(sorted(
            {(int(a), int(b)) for a, b in zip(res["posA"], res["posB"])}
            | {(int(b), int(a)) for a, b in zip(res["posA"], res["posB"])}
        ))[:64]
    params = Params(**PARAMS)
    hits = chains.segment_event_hits(fm, gs, events, params)
    got = chains.chain_stitch(fm, gs, tables, events, params, seg_hits=hits)
    want = jstitch(jfm, gs, tables, events, params)
    assert [vars(c) for c in got] == [vars(c) for c in want]
    got = chains.cross_strand_chains(fm, gs, tables, events, params,
                                     fr_events=fr_events, seg_hits=hits)
    want = jcross(jfm, gs, tables, events, params, fr_events=fr_events)
    assert [vars(c) for c in got] == [vars(c) for c in want]
    assert any(op[0] == "FUS" for c in got for op in c.ops)


def test_sparse_realign_over_fusion_events_right_before_left():
    """Fusion events whose right flank lies before the left one, or on
    another contig: the sparse realign entry finds every planted read at
    its split, equal to the JAX package's records."""
    from tophat_tpu.ops.events import realign_events_sparse as jsparse
    from tophat_tpu_torch.ops.events import realign_events_sparse

    rng = np.random.default_rng(4)
    n = 20000
    genome = rng.integers(0, 4, n).astype(np.int8)
    E = 12
    lefts = rng.integers(9000, 19000, E).astype(np.int32)
    rights = rng.integers(200, 8000, E).astype(np.int32)   # right < left
    rights[::3] = rng.integers(10000, 19000, 4)           # mixed with after
    ev = dict(left=lefts, right=rights, kind=np.full(E, 3, np.int8),
              ins_len=np.zeros(E, np.int8),
              ins_seq=np.full((E, 8), -1, np.int8),
              antisense=np.zeros(E, bool), valid=np.ones(E, bool))
    R, Lr = 60, 50
    reads = rng.integers(0, 4, (R, Lr)).astype(np.int8)
    plant = {}
    for i in range(0, R, 2):
        e = int(rng.integers(0, E))
        t = int(rng.integers(8, Lr - 8))
        reads[i] = np.concatenate([genome[lefts[e] - t + 1:lefts[e] + 1],
                                   genome[rights[e]:rights[e] + Lr - t]])
        plant[i] = (e, t)
    lengths = np.full(R, Lr, np.int32)
    got = realign_events_sparse(torch.as_tensor(genome), reads, lengths, ev,
                                max_mm=2)
    want = jsparse(_jt(genome), reads, lengths, ev, 2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    found = {(int(r), int(e)): int(t) for r, e, t in zip(*got[:3])}
    for i, (e, t) in plant.items():
        assert found[(i, e)] == t


def test_fusion_table_matches_jax(tmp_path):
    """FusionTable on the same candidates (ff events, table-free fr/rf
    candidates, fused chains, contiguous reads straddling breaks, mate
    pairs): both packages write the same fusions.out."""
    from tophat_tpu.index.fasta import Genome as JGenome
    from tophat_tpu.pipeline.fusion_stats import FusionTable as JTable
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.pipeline.fusion_stats import FusionTable
    from tophat_tpu_torch.pipeline.params import Params
    from tophat_tpu_torch.pipeline.report import Candidate

    codes, offs, _, _, _, _ = fusion_workload()
    events = dict(left=np.array([5000, 41000], np.int32),
                  right=np.array([40000, 12000], np.int32),
                  kind=np.array([3, 3], np.int8))
    C = lambda **k: Candidate(**{"strand": 0, "mm": 0, "ev": -1, "t": 0,
                                 **k})
    cands = [C(read=0, pos=4961, kind=3, ev=0, t=40),
             C(read=1, pos=40971, kind=3, ev=1, t=30),
             C(read=2, pos=60000, kind=3, t=35, fdir="fr", fpos2=70500),
             C(read=3, pos=62000, kind=3, t=25, fdir="rf", fpos2=1500),
             C(read=4, pos=4990, kind=-2, chain_ops=(
                 ("M", 11), ("EV", 0, 3, 0), ("M", 65))),
             C(read=5, pos=200, kind=-2, chain_ops=(
                 ("FUS", 33000, "rf"), ("M", 40))),
             C(read=6, pos=4970, kind=-1),
             C(read=7, pos=39990, kind=-1)]
    params = Params(fusion_anchor_length=10, fusion_min_dist=2000,
                    fusion_ignore_chromosomes="chrZ")
    outs = []
    for G, T in ((JGenome, JTable), (Genome, FusionTable)):
        ft = T(G(codes=codes, offsets=offs, names=NAMES), events, params)
        for c in cands:
            ft.add_alignment(c, L)
        for c in cands:
            ft.add_unsupport(c, L)
        ft.add_pair(cands[0], cands[7], L, L)
        ft.add_pair(cands[6], cands[7], L, L)
        ft.add_pair(cands[2], C(read=2, pos=70700, kind=-1, strand=1), L, L)
        path = tmp_path / f"{T.__module__.split('.')[0]}.out"
        ft.write(str(path))
        outs.append(path.read_bytes())
    assert outs[0] == outs[1]
    assert outs[0].count(b"\n") >= 4


def _run(which, tmp_path, mode, chunk=None):
    Genome, batch_reads, Params, run, paired, dev = _pkg(which)
    codes, offs, r1, r2, _, _ = fusion_workload()
    genome = Genome(codes=codes, offsets=offs, names=NAMES)
    out = tmp_path / f"{mode}_{which}"
    P = Params(**PARAMS)
    quiet = lambda *a: None
    if mode == "single":
        run.run_pipeline(genome, batch_reads(r1), P, str(out), log=quiet,
                         **dev)
    elif mode == "single_chunked":
        chunks = (batch_reads(r1[s:s + chunk])
                  for s in range(0, len(r1), chunk))
        run.run_pipeline_streaming(genome, chunks, P, str(out), log=quiet,
                                   **dev)
    elif mode == "paired":
        paired.run_pipeline_paired(genome, batch_reads(r1), batch_reads(r2),
                                   P, str(out), log=quiet, **dev)
    else:
        chunks = ((batch_reads(r1[s:s + chunk]), batch_reads(r2[s:s + chunk]))
                  for s in range(0, len(r1), chunk))
        paired.run_pipeline_paired_streaming(genome, chunks, P, str(out),
                                             log=quiet, **dev)
    return out


@pytest.mark.parametrize("mode,chunk", [("single", None),
                                        ("single_chunked", 40),
                                        ("paired", None),
                                        ("paired_chunked", 48)])
def test_fusion_runs_identical(tmp_path, mode, chunk):
    """Whole --fusion-search runs: every output file byte-identical; every
    designed break in fusions.out with its direction, and every break read
    placed at its break."""
    a = _run("jax", tmp_path, mode, chunk)
    b = _run("torch", tmp_path, mode, chunk)
    for f in FILES:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f
    fus = (b / "fusions.out").read_text().splitlines()
    assert sorted(ln.split("\t")[3] for ln in fus) == \
        ["ff", "ff", "fr", "fr", "rf", "rf"]
    assert break_recall(b / "accepted_hits.sam", fusion_workload()[5]) == 1
    assert len((b / "junctions.bed").read_text().splitlines()) >= 2
    assert len((b / "deletions.bed").read_text().splitlines()) >= 2
    if mode.startswith("paired"):
        assert any(int(ln.split("\t")[5]) > 0 for ln in fus)   # pair_count


def test_chain_across_two_fusions_ranks_below_one_fusion():
    """A mate-1 read explained with no mismatch both as one fr fusion and
    as a chain through a chance ff fusion and back across an fr fusion
    (chip_smoke.py phase 18 met 38 such reads of one break on the 3.1 Gbp
    genome): the JAX package scores both alike, so both are kept and the
    pair grading takes the chain by candidate order. The port ranks a
    chain across two fusions below a one-fusion alignment, so the fr
    fusion alone is selected; a chain across one fusion keeps its rank."""
    from tophat_tpu.pipeline.report import Candidate as JCandidate
    from tophat_tpu.pipeline.report import select_best as jselect
    from tophat_tpu_torch.pipeline.report import Candidate, select_best

    fus = dict(read=4, pos=500887, strand=0, mm=0, kind=3, ev=-1, t=66,
               fdir="fr", fpos2=300001)
    chain = dict(read=4, pos=500887, strand=0, mm=0, kind=-2, ev=-1, t=0,
                 chain_ops=(("M", 59), ("EV", 1, 3, 0), ("M", 16),
                            ("FUS", 299992, "fr")), chain_events=(1,))
    one = dict(chain, chain_ops=(("M", 59), ("EV", 1, 3, 0), ("M", 41)))
    jc = [JCandidate(**chain), JCandidate(**fus)]
    assert jc[0].score == jc[1].score
    assert [c.kind for c in jselect(jc, 20, np.random.default_rng(1))] == \
        [-2, 3]
    tc = [Candidate(**chain), Candidate(**fus)]
    assert tc[0].score < tc[1].score
    assert [c.kind for c in select_best(tc, 20, np.random.default_rng(1))] \
        == [3]
    assert Candidate(**one).score == Candidate(**fus).score == \
        JCandidate(**one).score
    assert Candidate(**dict(chain, mm=1)).score < tc[0].score
