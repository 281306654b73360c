"""Contig-group (whole-genome) parity: the port's grouped index and grouped
pipeline against the JAX package's — single-end and paired library runs,
CLI runs with --max-index-bases (single-end, -G, --fusion-search), the
group split, the group caches (either package reusing the other's), the
int64 rebase and merge — and against the port's own single-index run;
plus the chain path's sparse segment hits against the dense tables they
replace, and a single-index --fusion-search -G run against the JAX
package's. Exact equality of every integer output and every output file.

No JAX at import time: test_torch_gpu.py reuses the fixture on a machine
without JAX."""

import os

import numpy as np
import pytest
import torch

K = 12_000                  # bases per contig
L = 76
MAX_BASES = 25_000          # two contigs per group -> two groups
NAMES = [f"chr{i}" for i in range(4)]
OUTPUTS = ("accepted_hits.sam", "junctions.bed", "insertions.bed",
           "deletions.bed")
QUIET = lambda *a: None     # noqa: E731


def _rc(s):
    return np.where(s < 4, 3 - s, s)[::-1].astype(np.int8)


def _seq(codes):
    return "".join("ACGTN"[c] for c in codes)


def grouped_fixture(seed=41):
    """The JAX package's grouped fixture (tests/test_grouped.py): four
    12-kb contigs; contigs 0 and 2 carry a GT-AG intron, contig 1 a 2-bp
    deletion; contiguous reads on every contig, junction reads on 0 and 2,
    deletion reads on 1, junk. Added here: mates 2 (the reverse complement
    60 bp past the read's end on its contig; junk for junk) and six ff
    fusion reads, four within group 0 (chr0 -> chr1) and two across the
    groups (chr0 -> chr2, which grouped fusion search does not see).
    Returns (codes, offsets, mate-1 records, mate-2 records, juncs)."""
    rng = np.random.default_rng(seed)
    contigs = [rng.integers(0, 4, K).astype(np.int8) for _ in range(4)]
    juncs = {}
    for ci in (0, 2):
        c = contigs[ci]
        a, il = 4_000, 300
        c[a] = 2
        c[a + 1] = 3
        c[a + il - 2] = 0
        c[a + il - 1] = 2
        juncs[ci] = (a - 1, a + il)
    del_at = 6_000
    codes = np.concatenate(contigs)
    offsets = np.concatenate([[0], np.cumsum([len(c) for c in contigs])])

    r1, r2 = [], []

    def add(name, seq, ci, end):
        r1.append((name, _seq(seq), b"I" * L))
        m2 = (_rc(contigs[ci][end + 60:end + 60 + L]) if ci >= 0
              else rng.integers(0, 4, L).astype(np.int8))
        r2.append((name, _seq(m2), b"I" * L))

    for ci in range(4):
        for k in range(6):
            s = 1000 + 700 * k
            seq = contigs[ci][s: s + L].copy()
            seq[10 + k] = (seq[10 + k] + 1) % 4
            add(f"c{ci}_{k}", seq, ci, s + L)
    for ci in (0, 2):
        lft, rgt = juncs[ci]
        for k in range(8):
            t = 20 + 4 * k
            seq = np.concatenate([contigs[ci][lft - t + 1: lft + 1],
                                  contigs[ci][rgt: rgt + L - t]])
            add(f"j{ci}_{k}", seq, ci, rgt + L - t)
    for k in range(6):
        s = del_at - 30 - 2 * k
        seq = np.concatenate([contigs[1][s: del_at],
                              contigs[1][del_at + 2: s + L + 2]])[:L]
        add(f"d{k}", seq, 1, s + L + 2)
    for k in range(4):
        add(f"x{k}", rng.integers(0, 4, L).astype(np.int8), -1, 0)
    for k, (cb, b) in enumerate([(1, 9000)] * 4 + [(2, 9000)] * 2):
        t = 30 + 4 * k
        a = 8000
        seq = np.concatenate([contigs[0][a - t + 1: a + 1],
                              contigs[cb][b: b + L - t]])
        add(f"f{k}", seq, cb, b + L - t)
    return codes, offsets.astype(np.int64), r1, r2, juncs


GTF = "".join(
    f'{c}\ttest\texon\t{s + 1}\t{e}\t.\t+\t.\tgene_id "{g}"; '
    f'transcript_id "{t}";\n'
    for c, g, t, exons in [
        ("chr0", "g0", "t0", [(3600, 4000), (4300, 4700)]),
        ("chr2", "g2", "t2", [(3700, 4000), (4300, 4900)]),
        ("chr3", "g3", "t3", [(2000, 2300), (2800, 3100), (5000, 5400)])]
    for s, e in exons)


def _pkg(which):
    if which == "jax":
        from tophat_tpu.index import grouped as index
        from tophat_tpu.index.fasta import Genome
        from tophat_tpu.io.fastq import batch_reads
        from tophat_tpu.pipeline import grouped, paired, run
        from tophat_tpu.pipeline.params import Params
        return Genome, batch_reads, Params, index, grouped, paired, run
    from tophat_tpu_torch.index import grouped as index
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.io.fastq import batch_reads
    from tophat_tpu_torch.pipeline import grouped, paired, run
    from tophat_tpu_torch.pipeline.params import Params
    return Genome, batch_reads, Params, index, grouped, paired, run


def run_library(which, out, mode, grouped=True, device="cpu", **params):
    """A grouped (or single-index) library run of the fixture; the port's
    runs on `device`."""
    Genome, batch_reads, Params, index, gp, paired, run = _pkg(which)
    dev = {} if which == "jax" else {"device": device}
    codes, offsets, r1, r2, _ = grouped_fixture()
    genome = Genome(codes=codes, offsets=offsets, names=NAMES)
    gfm = index.build_grouped_fm(genome, max_bases=MAX_BASES) \
        if grouped else None
    if gfm is not None:
        assert gfm.n_groups == 2
    P = Params(**params)
    if mode == "paired":
        paired.run_pipeline_paired(genome, batch_reads(r1), batch_reads(r2),
                                   P, str(out), log=QUIET, gfm=gfm, **dev)
    elif which == "torch":
        run.run_pipeline(genome, batch_reads(r1), P, str(out), log=QUIET,
                         gfm=gfm, **dev)
    elif grouped:
        gp.run_pipeline_grouped(genome, batch_reads(r1), P, str(out), gfm,
                                log=QUIET)
    else:
        run.run_pipeline(genome, batch_reads(r1), P, str(out), log=QUIET)
    return out


def write_fixture(path):
    """FASTA, mate FASTQs and genes.gtf of the fixture; returns their
    paths (fa, fq1, fq2, gtf)."""
    codes, offsets, r1, r2, _ = grouped_fixture()
    fa = path / "g.fa"
    with open(fa, "w") as f:
        for i, name in enumerate(NAMES):
            f.write(f">{name}\n{_seq(codes[offsets[i]:offsets[i + 1]])}\n")
    fqs = []
    for k, recs in ((1, r1), (2, r2)):
        fq = path / f"r_{k}.fq"
        with open(fq, "w") as f:
            for name, seq, qual in recs:
                f.write(f"@{name}\n{seq}\n+\n{qual.decode()}\n")
        fqs.append(str(fq))
    gtf = path / "genes.gtf"
    gtf.write_text(GTF)
    return str(fa), fqs[0], fqs[1], str(gtf)


def _same(a, b, files):
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


@pytest.mark.parametrize("mode", ["single", "paired"])
def test_grouped_run_matches_jax(tmp_path, mode):
    """Library grouped runs over two groups in TopHat's default mode
    (coverage search on), single-end and paired: identical files."""
    a = run_library("jax", tmp_path / "jax", mode)
    b = run_library("torch", tmp_path / "torch", mode)
    _same(a, b, OUTPUTS + ("align_summary.txt",))
    bed = (b / "junctions.bed").read_text()
    assert "chr0" in bed and "chr2" in bed


def test_grouped_run_matches_single_index(tmp_path):
    """The port's grouped run writes what its single-index run writes
    (the JAX package's own contract, coverage search off)."""
    a = run_library("torch", tmp_path / "single", "single", grouped=False,
                    coverage_search=False)
    b = run_library("torch", tmp_path / "grouped", "single",
                    coverage_search=False)
    _same(a, b, OUTPUTS + ("align_summary.txt",))


CLI_CASES = {
    "single": [],
    "paired_gtf": ["-G", "GTF"],
    "paired_fusion": ["--fusion-search", "--fusion-min-dist", "2000",
                      "--fusion-anchor-length", "13",
                      "--no-coverage-search"],
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_grouped_cli_matches_jax(tmp_path, case):
    """CLI runs with --max-index-bases (two groups; the group caches go
    beside the FASTA, the default prefix): single-end default mode, a
    paired -G run and a paired --fusion-search run. Identical files; the
    fusion run finds the chr0 -> chr1 fusion (one group) and not the
    chr0 -> chr2 one (two groups: the JAX package's limit, kept)."""
    from tophat_tpu.cli.main import main as jmain
    from tophat_tpu_torch.cli.main import main as tmain

    fa, fq1, fq2, gtf = write_fixture(tmp_path)
    flags = [gtf if x == "GTF" else x for x in CLI_CASES[case]]
    reads = [fq1] if case == "single" else [fq1, fq2]
    argv = ["--max-index-bases", str(MAX_BASES)] + flags + [fa] + reads
    assert jmain(["-o", str(tmp_path / "jax")] + argv) == 0
    assert os.path.exists(fa + ".g1.tt.npz")
    assert tmain(["-o", str(tmp_path / "torch"), "--device", "cpu"]
                 + argv) == 0
    files = OUTPUTS + (("align_summary.txt",) if len(reads) == 2 else ())
    if case == "paired_fusion":
        files += ("fusions.out",)
        fus = (tmp_path / "torch" / "fusions.out").read_text()
        assert "chr0-chr1" in fus and "chr0-chr2" not in fus
    _same(tmp_path / "jax", tmp_path / "torch", files)
    log = (tmp_path / "torch" / "logs" / "tophat.log").read_text()
    assert "2 contig groups" in log and "reusing FM index" in log


@pytest.mark.parametrize("max_bases,want", [
    (1000, [(0, 3)]), (70, [(0, 2), (2, 3)]),
    (40, [(0, 1), (1, 2), (2, 3)]), (30, None)])
def test_group_ranges_match_jax(max_bases, want):
    from tophat_tpu.index.fasta import Genome as JGenome
    from tophat_tpu.index.grouped import contig_group_ranges as jranges
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.index.grouped import contig_group_ranges

    args = dict(codes=np.zeros(100, np.int8),
                offsets=np.array([0, 40, 70, 100]), names=["a", "b", "c"])
    if want is None:
        for fn, G in ((contig_group_ranges, Genome), (jranges, JGenome)):
            with pytest.raises(SystemExit):
                fn(G(**args), max_bases=max_bases)
        return
    got = contig_group_ranges(Genome(**args), max_bases=max_bases)
    assert got == [range(a, b) for a, b in want]
    assert got == jranges(JGenome(**args), max_bases=max_bases)


def test_grouped_fm_cache_reuse(tmp_path):
    """<prefix>.g<i>.tt.npz: the port reuses its own cache and one the JAX
    package wrote; the tables equal a fresh build's."""
    from tophat_tpu.index.fasta import Genome as JGenome
    from tophat_tpu.index.grouped import build_grouped_fm as jbuild
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.index.grouped import build_grouped_fm

    rng = np.random.default_rng(3)
    args = dict(codes=rng.integers(0, 4, 3000).astype(np.int8),
                offsets=np.array([0, 1500, 3000]), names=["a", "b"])
    for who, prefix in (("torch", tmp_path / "t"), ("jax", tmp_path / "j")):
        if who == "torch":
            g1 = build_grouped_fm(Genome(**args), max_bases=1600,
                                  cache_prefix=str(prefix))
            assert g1.fms[0].device.type == "cpu"
        else:
            jbuild(JGenome(**args), max_bases=1600, cache_prefix=str(prefix))
        assert os.path.exists(f"{prefix}.g1.tt.npz")
        msgs = []
        g2 = build_grouped_fm(Genome(**args), max_bases=1600,
                              cache_prefix=str(prefix), log=msgs.append)
        assert sum("reusing" in m for m in msgs) == 2, msgs
        for a, b in zip(g1.fms, g2.fms):
            for t in ("sa", "packed_bwt", "occ_ck", "genome"):
                assert torch.equal(getattr(a, t), getattr(b, t)), t
        assert np.array_equal(g2.bases, [0, 1500])


def test_rebase_and_merge_keep_int64():
    """Group-local candidates and event tables rebased to a base of
    3 * 2^30 (past int32) keep exact int64 values."""
    from tophat_tpu.pipeline import grouped as jg
    from tophat_tpu_torch.pipeline import grouped as tg
    from tophat_tpu_torch.pipeline.juncs import empty_events
    from tophat_tpu_torch.pipeline.report import Candidate

    base = 3 << 30
    ev = empty_events()
    local = dict(ev, left=np.array([5, 2_000_000_000], np.int32),
                 right=np.array([900, 2_000_000_300], np.int32),
                 kind=np.zeros(2, np.int8), antisense=np.zeros(2, bool),
                 ins_len=np.zeros(2, np.int8),
                 ins_seq=np.full((2, ev["ins_seq"].shape[1]), -1, np.int8))
    merged = tg._merge_event_tables([ev, local], [0, base])
    assert merged["left"].dtype == np.int64
    assert merged["left"].tolist() == [base + 5, base + 2_000_000_000]
    assert merged["right"].tolist() == [base + 900, base + 2_000_000_300]
    want = jg._merge_event_tables([ev, local], [0, base])
    for k in merged:
        assert np.array_equal(merged[k], want[k]), k

    def cands():
        return {0: [Candidate(read=0, pos=2_000_000_100, strand=0, mm=0,
                              kind=-2, ev=-1, t=0, fpos2=1_999_999_000,
                              chain_events=(0, 1),
                              chain_ops=(("M", 10), ("EV", 1, 0, 50),
                                         ("FUS", 1_500_000_000, "fr")))]}
    got, ref = cands(), cands()
    tg._rebase_candidates(got, base, 7)
    jg._rebase_candidates(ref, base, 7)
    c = got[0][0]
    assert c.pos == base + 2_000_000_100 and c.fpos2 == base + 1_999_999_000
    assert c.chain_events == (7, 8)
    assert c.chain_ops == (("M", 10), ("EV", 8, 0, 50),
                           ("FUS", base + 1_500_000_000, "fr"))
    assert vars(c) == vars(ref[0][0])


def _chain_inputs(seed):
    """Seeded random chain inputs: a 40-kb genome, 60 random events
    (junctions, deletions, 1-3 bp insertions) plus 12 planted pairs that
    reads cross twice, and those reads (with mismatches) among random
    ones; genome-space rows and segment tables from the port's CPU index."""
    from tophat_tpu_torch.index.fasta import encode_seq
    from tophat_tpu_torch.index.fm import build_fm_index
    from tophat_tpu_torch.ops.align import pad_reads
    from tophat_tpu_torch.pipeline.juncs import dedup_events
    from tophat_tpu_torch.pipeline.segment import (build_genome_space,
                                                   map_segments)

    rng = np.random.default_rng(seed)
    n = 40_000
    codes = rng.integers(0, 4, n).astype(np.int8)
    lefts, rights, kinds, ilens = [], [], [], []
    seqs = []
    for k in range(12):
        a = int(rng.integers(500, n - 5000))
        b = a + int(rng.integers(80, 400))
        c = b + int(rng.integers(30, 45))
        d = c + int(rng.integers(80, 400))
        lefts += [a, c]
        rights += [b, d]
        kinds += [0, 1 if k % 3 == 0 else 0]
        ilens += [0, 0]
        t = int(rng.integers(20, 35))
        r = np.concatenate([codes[a - t + 1:a + 1], codes[b:c + 1],
                            codes[d:d + 100]])[:L]
        if k % 2:
            r[int(rng.integers(0, L))] ^= 1
        seqs.append(r)
    for k in range(60):
        a = int(rng.integers(100, n - 6000))
        q = int(rng.integers(1, 4)) if k % 5 == 0 else 0
        lefts.append(a)
        rights.append(a + 1 if q else a + int(rng.integers(2, 5000)))
        kinds.append(2 if q else int(k % 3 == 0))
        ilens.append(q)
    ins_seq = np.full((len(lefts), 8), -1, np.int8)
    for i, q in enumerate(ilens):
        ins_seq[i, :q] = rng.integers(0, 4, q)
    events = dedup_events(dict(
        left=np.array(lefts, np.int32), right=np.array(rights, np.int32),
        kind=np.array(kinds, np.int8),
        antisense=np.zeros(len(lefts), bool),
        ins_len=np.array(ilens, np.int8), ins_seq=ins_seq))
    seqs += [codes[s:s + L].copy() for s in rng.integers(0, n - L, 20)]
    seqs += [rng.integers(0, 4, L).astype(np.int8) for _ in range(4)]
    rf, rr, lens = pad_reads([encode_seq(_seq(s)) for s in seqs])
    gs = build_genome_space(rf, rr, lens, 25, pad_rows_pow2=True)
    fm = build_fm_index(codes, device="cpu")
    tables = map_segments(fm, np.array([0, n]), gs, segment_mismatches=2,
                          hits_per_seed=32, max_hits=16)
    return fm, gs, tuple(a.numpy() for a in tables), events


def dense_segment_hits(fm, gs, events, params):
    """The segment hits the chain path took before it went sparse: the
    realign kernel's dense (rows*S, E) tables, their ok entries listed per
    segment row in ascending event order (np.nonzero), in
    segment_event_hits' form."""
    from tophat_tpu_torch.ops.events import realign_events
    from tophat_tpu_torch.pipeline.segment import segment_rows

    seg_reads, seg_len = segment_rows(gs)
    ev = dict(events, valid=np.ones(len(events["left"]), bool))
    bt, mm, ok = realign_events(
        fm.genome.cpu(), seg_reads,
        np.maximum(seg_len.reshape(-1), 1).astype(np.int32), ev,
        max_mm=params.segment_mismatches)
    rows, evs = np.nonzero(ok)
    offsets = np.zeros(ok.shape[0] + 1, np.int64)
    np.cumsum(ok.sum(1), out=offsets[1:])
    return (offsets, evs, bt[rows, evs], mm[rows, evs]), seg_len


@pytest.mark.parametrize("seed", [1, 2])
def test_chains_sparse_hits_equal_dense(seed):
    """chain_stitch and cross_strand_chains give the same chains from the
    sparse segment hits (the realign kernel's sparse entry) as from the
    dense tables the chain path read before."""
    from tophat_tpu_torch.pipeline import chains
    from tophat_tpu_torch.pipeline.params import Params

    fm, gs, tables, events = _chain_inputs(seed)
    params = Params()
    sparse = chains.segment_event_hits(fm, gs, events, params)
    dense = dense_segment_hits(fm, gs, events, params)
    for a, b in zip(sparse[0], dense[0]):
        assert np.array_equal(a, b)
    assert len(sparse[0][1]) > 0
    got = chains.chain_stitch(fm, gs, tables, events, params,
                              seg_hits=sparse)
    want = chains.chain_stitch(fm, gs, tables, events, params,
                               seg_hits=dense)
    assert [vars(c) for c in got] == [vars(c) for c in want]
    assert len(got) >= 6
    assert chains.chain_stitch(fm, gs, tables, events, params) == got
    got = chains.cross_strand_chains(fm, gs, tables, events, params,
                                     seg_hits=sparse)
    want = chains.cross_strand_chains(fm, gs, tables, events, params,
                                      seg_hits=dense)
    assert [vars(c) for c in got] == [vars(c) for c in want]


def test_fusion_gtf_run_matches_jax(tmp_path):
    """A single-index paired --fusion-search -G CLI run (the chain path
    over every row against the annotated event table) writes the JAX
    package's files."""
    from test_torch_fusion import FILES, write_inputs
    from tophat_tpu.cli.main import main as jmain
    from tophat_tpu_torch.cli.main import main as tmain

    fa, fq1, fq2, _ = write_inputs(tmp_path)
    gtf = tmp_path / "genes.gtf"
    gtf.write_text(
        'chrA\ttest\texon\t2001\t2300\t.\t+\t.\tgene_id "a"; '
        'transcript_id "a1";\n'
        'chrA\ttest\texon\t2701\t3000\t.\t+\t.\tgene_id "a"; '
        'transcript_id "a1";\n'
        'chrB\ttest\texon\t5001\t5200\t.\t-\t.\tgene_id "b"; '
        'transcript_id "b1";\n'
        'chrB\ttest\texon\t5601\t5800\t.\t-\t.\tgene_id "b"; '
        'transcript_id "b1";\n')
    argv = ["-G", str(gtf), "--fusion-search", "--max-intron-length",
            "1000", "--fusion-min-dist", "2000", "--fusion-anchor-length",
            "13", "--no-coverage-search", fa, fq1, fq2]
    assert jmain(["-o", str(tmp_path / "jax")] + argv) == 0
    assert tmain(["-o", str(tmp_path / "torch"), "--device", "cpu"]
                 + argv) == 0
    _same(tmp_path / "jax", tmp_path / "torch", FILES)
    assert (tmp_path / "torch" / "fusions.out").read_text().count("\n") >= 6


def _smoke():
    """chip_smoke.py, whose phase 16 maps the human-scale ladder."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    return chip_smoke


def _ladder(G, per_mbp=1_000_000):
    """The 24-contig human ladder (3,093,000,000 bases at full scale) as a
    Genome of class G over a zero-stride codes view: nothing of its size
    is allocated."""
    sizes = np.array(_smoke().HUMAN_CONTIG_MBP, np.int64) * per_mbp
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    return G(codes=np.broadcast_to(np.int8(0), (int(offsets[-1]),)),
             offsets=offsets, names=[f"chr{i + 1}" for i in range(24)])


def test_human_ladder_groups_match_jax():
    """The default --max-index-bases cuts the human ladder into chr1-11
    and chr12-24 at global bases [0, 1,950,000,000], in both packages."""
    from tophat_tpu.index.fasta import Genome as JGenome
    from tophat_tpu.index.grouped import MAX_GROUP_BASES as JMAX
    from tophat_tpu.index.grouped import contig_group_ranges as jranges
    from tophat_tpu.index.grouped import sub_genome as jsub
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.index.grouped import (MAX_GROUP_BASES,
                                                contig_group_ranges,
                                                sub_genome)

    g, jg = _ladder(Genome), _ladder(JGenome)
    assert g.n == 3_093_000_000 and MAX_GROUP_BASES == JMAX
    got = contig_group_ranges(g)
    assert got == [range(0, 11), range(11, 24)] == jranges(jg)
    assert [int(g.offsets[r.start]) for r in got] == [0, 1_950_000_000]
    for r, n in zip(got, (1_950_000_000, 1_143_000_000)):
        s, js = sub_genome(g, r), jsub(jg, r)
        assert s.n == js.n == n and s.names == js.names
        np.testing.assert_array_equal(s.offsets, js.offsets)
        assert s.offsets.dtype == np.int64 and s.offsets[-1] == n


def test_global_to_contig_past_2p31_matches_jax():
    """Global positions either side of 2^31 (chr13 spans it; chr14 starts
    at 2,199,000,000) map to the same contig and local position in both
    packages, at int64, and back."""
    from tophat_tpu.index.fasta import Genome as JGenome
    from tophat_tpu_torch.index.fasta import Genome

    g, jg = _ladder(Genome), _ladder(JGenome)
    off = [int(x) for x in g.offsets]
    pos = [0, (1 << 31) - 1, 1 << 31, (1 << 31) + 1, off[13] - 1, off[13],
           off[13] + 1, off[22] + 5, g.n - 1]
    want_c = [max(c for c in range(24) if off[c] <= p) for p in pos]
    want_l = [p - off[c] for p, c in zip(pos, want_c)]
    for G in (g, jg):
        cid, local = G.global_to_contig(np.array(pos, np.int64))
        assert cid.tolist() == want_c and local.tolist() == want_l
        assert local.dtype == np.int64
        back = G.contig_to_global(cid, local)
        assert back.dtype == np.int64 and back.tolist() == pos
    assert want_c[1:4] == [12, 12, 12] and want_c[5] == 13


def test_human_scale_design_matches_jax(tmp_path, monkeypatch):
    """chip_smoke.py's phase 16 at 1/1,000 of its ladder (24 contigs,
    3,093,000 bases, its planted introns and reads) through both
    packages' CLIs, --no-coverage-search, --max-index-bases cutting at
    chr12 as the default cuts the full ladder (2 groups): identical
    files, and the phase's own checks pass on them."""
    from tophat_tpu.cli.main import main as jmain
    from tophat_tpu_torch.cli.main import main as tmain

    cs = _smoke()
    monkeypatch.setattr(cs, "HUMAN_PER_MBP", 1000)
    codes, offsets, names, introns = cs.human_genome()
    assert len(codes) == 3_093_000 and len(introns) == 48
    seqs, truth = cs.human_reads(codes, offsets, introns, 82, 2048)
    fa, fq = str(tmp_path / "hs.fa"), str(tmp_path / "r.fq")
    cs.write_fasta(fa, codes, cuts=offsets[:-1])
    cs.write_fastq(fq, seqs)
    argv = ["--no-coverage-search", "--max-index-bases", "1950000", fa, fq]
    assert jmain(["-o", str(tmp_path / "jax"), "--tt-index",
                  str(tmp_path / "j")] + argv) == 0
    assert tmain(["-o", str(tmp_path / "torch"), "--tt-index",
                  str(tmp_path / "t"), "--device", "cpu"] + argv) == 0
    _same(tmp_path / "jax", tmp_path / "torch",
          OUTPUTS + ("align_summary.txt",))
    log = (tmp_path / "torch" / "logs" / "tophat.log").read_text()
    assert "2 contig groups" in log
    got = cs.human_placement(str(tmp_path / "torch"), names, offsets,
                             introns, truth)
    assert got["recall_pct"] == 100.0
    assert got["missing_introns"] == [] and got["misplaced"] == []
    assert got["n_contiguous"] == 1536


def test_grouped_mapper_keeps_one_group_resident(tmp_path, monkeypatch):
    """A group's index arrives on the device only after the group before
    it is gone: no device copy of an earlier group is alive at any
    FMIndex.to of the grouped run (single-end and paired), so a human
    genome's two groups (8.9 and 5.5 GB) never sit on the card at once."""
    import weakref

    from tophat_tpu_torch.index.fm import FMIndex

    to = FMIndex.to
    copies, alive_at_to = [], []

    def to_tracked(self, device):
        alive_at_to.append(sum(r() is not None for r in copies))
        out = to(self, device)
        copies.append(weakref.ref(out))
        return out

    monkeypatch.setattr(FMIndex, "to", to_tracked)
    for mode in ("single", "paired"):
        copies.clear()
        alive_at_to.clear()
        run_library("torch", tmp_path / mode, mode)
        assert len(alive_at_to) >= 3 and not any(alive_at_to), alive_at_to


@pytest.mark.parametrize("avail_gb,want", [(100, 2), (75, 2), (60, 1),
                                           (None, 1)])
def test_build_workers_fit_the_human_groups(avail_gb, want, monkeypatch):
    """The group-build budget sums the scratch of the groups that can
    build at once: a human genome's two groups (1.95 and 1.143 Gbp) build
    together on a host with ~71 GB free, where charging every worker the
    largest group's scratch allowed one; less memory, or none readable,
    builds them one after the other."""
    import types

    from tophat_tpu_torch.index import grouped

    monkeypatch.setattr(grouped.os, "cpu_count", lambda: 8)
    subs = [types.SimpleNamespace(n=n) for n in (1_950_000_000,
                                                 1_143_000_000)]
    avail = None if avail_gb is None else avail_gb * 10 ** 9
    if avail is None:
        monkeypatch.setattr(grouped, "_mem_available", lambda: None)
    assert grouped._build_workers(subs, [0, 1], avail) == want
    assert grouped._build_workers(subs, [1], avail) == 1


def _ladder_gtf(path, names):
    """A two-exon transcript on every contig of the ladder: exons
    [1000, 1200) and [1500, 1700), contig-local, so its intron is (1199,
    1500); '-' on even contigs."""
    path.write_text("".join(
        f'{c}\tt\texon\t{s + 1}\t{e}\t.\t{"-+"[i % 2]}\t.\tgene_id "g{i}"; '
        f'transcript_id "t{i}";\n'
        for i, c in enumerate(names) for s, e in ((1000, 1200), (1500, 1700))))
    return str(path)


def test_known_events_past_2p31(tmp_path):
    """On the human ladder (chr14-chrY start past 2^31) the port's -G
    junctions and its -j / --insertions / --deletions tables keep every
    global position, at int64, and _slice_known_events gives each back
    at group-local coordinates; the JAX package's gtf_junctions
    overflows int32 there (a reference fault, kept in the reference).
    Where every position fits, the tables stay int32, as JAX's are."""
    from tophat_tpu.index.fasta import Genome as JGenome
    from tophat_tpu.io import gtf as jgtf
    from tophat_tpu_torch.cli.main import load_known_events
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.index.grouped import contig_group_ranges
    from tophat_tpu_torch.io import gtf
    from tophat_tpu_torch.pipeline.grouped import _slice_known_events

    g = _ladder(Genome)
    off = [int(x) for x in g.offsets]
    gtf_path = _ladder_gtf(tmp_path / "genes.gtf", g.names)
    ev, accept = gtf.gtf_junctions(g, gtf.parse_gtf(gtf_path))
    assert ev["left"].dtype == ev["right"].dtype == np.int64
    got = sorted(zip(ev["left"].tolist(), ev["right"].tolist()))
    assert got == [(o + 1199, o + 1500) for o in off[:24]]
    assert sum(o >= 1 << 31 for o in off[:24]) == 11
    assert (off[23] + 1199, off[23] + 1500, False) in accept
    with pytest.raises(OverflowError):
        jgtf.gtf_junctions(_ladder(JGenome), jgtf.parse_gtf(gtf_path))

    (tmp_path / "j.juncs").write_text(
        "chr1\t99\t400\t+\nchr14\t99\t400\t-\nchr24\t5\t7000\t+\n")
    (tmp_path / "ins.bed").write_text(
        "track name=ins\nchr2\t50\t50\tAC\nchr20\t60\t60\tGTT\n")
    (tmp_path / "del.bed").write_text(
        "track name=del\nchr3\t70\t72\t-\nchr22\t80\t83\t-\n")
    known = load_known_events(g, str(tmp_path / "ins.bed"),
                              str(tmp_path / "del.bed"),
                              str(tmp_path / "j.juncs"))
    assert known["left"].dtype == known["right"].dtype == np.int64
    want = {(1, off[1] + 50, off[1] + 51), (1, off[19] + 60, off[19] + 61),
            (2, off[2] + 69, off[2] + 72), (2, off[21] + 79, off[21] + 83),
            (0, off[0] + 99, off[0] + 400), (0, off[13] + 99, off[13] + 400),
            (0, off[23] + 5, off[23] + 7000)}
    from tophat_tpu_torch.ops.splice import (KIND_DELETION, KIND_INSERTION,
                                             KIND_JUNCTION)
    kind = {KIND_JUNCTION: 0, KIND_INSERTION: 1, KIND_DELETION: 2}
    assert {(kind[int(k)], int(a), int(b)) for k, a, b in zip(
        known["kind"], known["left"], known["right"])} == want

    merged = {k: np.concatenate([ev[k], known[k]]) for k in ev}
    for r in contig_group_ranges(g):
        base, length = off[r.start], off[r.stop] - off[r.start]
        part = _slice_known_events(merged, base, length)
        assert part["left"].dtype == np.int32
        inside = [(a - base, b - base)
                  for a, b in zip(merged["left"].tolist(),
                                  merged["right"].tolist())
                  if base <= a and b < base + length]
        assert sorted(zip(part["left"].tolist(),
                          part["right"].tolist())) == sorted(inside)
        assert len(inside) == len(r) + (3 if r.start == 0 else 4)

    small = Genome(codes=np.zeros(5000, np.int8),
                   offsets=np.array([0, 2500, 5000], np.int64),
                   names=["chr1", "chr2"])
    ev, _ = gtf.gtf_junctions(small, gtf.parse_gtf(gtf_path))
    jev, _ = jgtf.gtf_junctions(JGenome(codes=small.codes,
                                        offsets=small.offsets,
                                        names=small.names),
                                jgtf.parse_gtf(gtf_path))
    for k in jev:
        np.testing.assert_array_equal(ev[k], jev[k])
        assert ev[k].dtype == jev[k].dtype, k
    assert ev["left"].dtype == np.int32 and len(ev["left"]) == 2


def test_human_annotated_design_matches_jax(tmp_path, monkeypatch):
    """chip_smoke.py's phase 17 at 1/1,000 of its ladder: its GENCODE-
    sized annotation (58 genes, 197 transcripts here) and its check run's
    4,096 annotated pairs on phase 16's genome, through both packages'
    CLIs as TopHat's annotated paired default run (-G, --transcriptome-index, coverage
    search on), --max-index-bases cutting at chr12 as the default cuts
    the full ladder (2 groups): identical files, transcriptome files
    included, and the phase's own checks pass on them."""
    from tophat_tpu.cli.main import main as jmain
    from tophat_tpu_torch.cli.main import main as tmain

    cs = _smoke()
    monkeypatch.setattr(cs, "HUMAN_PER_MBP", 1000)
    codes, offsets, names, introns = cs.human_genome()
    gtf = str(tmp_path / "genes.gtf")
    transcripts, distinct = cs.write_human_gtf(gtf, codes, offsets, names,
                                               introns)
    assert len(transcripts) == 197 and len(distinct) >= 300
    planted = [(int(offsets[c]) + a, int(offsets[c]) + b)
               for c, a, b in introns]
    crossed = {}
    m1, m2, spans, unannotated = cs.make_annotated_pairs(
        codes, cs.human_transcripts(gtf, names, offsets), planted, 91,
        cs.HUMAN_CHECK_PAIRS, offsets=offsets, crossed=crossed)
    fa = str(tmp_path / "hs.fa")
    fqs = [str(tmp_path / f"r_{k}.fq") for k in (1, 2)]
    cs.write_fasta(fa, codes, cuts=offsets[:-1])
    cs.write_fastq(fqs[0], m1, "p")
    cs.write_fastq(fqs[1], m2, "p")
    for pkg, run, extra in (("jax", jmain, []),
                            ("torch", tmain, ["--device", "cpu"])):
        argv = ["-o", str(tmp_path / pkg), "-G", gtf,
                "--transcriptome-index", str(tmp_path / f"{pkg}_tx" / "g"),
                "--tt-index", str(tmp_path / pkg[0]), "--max-index-bases",
                "1950000"] + extra + [fa] + fqs
        assert run(argv) == 0
    _same(tmp_path / "jax", tmp_path / "torch",
          OUTPUTS + ("align_summary.txt",))
    for suffix in (".fa", ".fa.tlst", ".gff", ".ver"):
        assert (tmp_path / "jax_tx" / f"g{suffix}").read_bytes() == \
            (tmp_path / "torch_tx" / f"g{suffix}").read_bytes(), suffix
    log = (tmp_path / "torch" / "logs" / "tophat.log").read_text()
    assert "2 contig groups" in log
    got = cs.human_annotated_placement(str(tmp_path / "torch"), names,
                                       offsets, (fqs, spans, unannotated),
                                       crossed, codes, (m1, m2))
    assert got["recall_annotated_pct"] == got["recall_unannotated_pct"] \
        == 100.0
    assert got["planted_crossed"] == 48 and got["missing_planted"] == []
    assert got["missing_annotated_past_2p31"] == []


def test_kmer_map_rebase_past_2p31(tmp_path, monkeypatch):
    """Fusion-post's kmer map on the human ladder (chr13 straddles 2^31,
    chr14-chrY start past it; the default group cap makes 2 groups at
    global bases 0 and 1,950,000,000): each group's int32 local
    placements are rebased by the group's base at int64 and written at
    their contig names and contig-local coordinates, group 0's first,
    up to the 100-placement cap. The group indexes and the aligner are
    stubbed (the ladder's codes are a zero-stride view): what is held is
    the rebase, the order and the cap."""
    import types

    from test_torch_fusion_post import _fusions_out
    from tophat_tpu_torch.cli import fusion_post
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.index.grouped import (GroupedFM,
                                                contig_group_ranges,
                                                sub_genome)

    g = _ladder(Genome)
    off = [int(x) for x in g.offsets]
    ranges = contig_group_ranges(g)
    fake = types.SimpleNamespace(to=lambda device: fake)
    gfm = GroupedFM(fms=[fake, fake],
                    sub_genomes=[sub_genome(g, r) for r in ranges],
                    bases=np.array([off[r.start] for r in ranges], np.int64))
    assert gfm.bases.tolist() == [0, 1_950_000_000]
    kmers = ["A" * 23, "C" * 23, "G" * 23, "T" * 23]
    # global placements of each kmer, group by group
    want = {
        kmers[0]: [[off[10] + 5, off[0]], [(1 << 31) + 7, off[13] + 1]],
        kmers[1]: [[], [off[23] + 9, off[12] + 3, g.n - 23]],
        kmers[2]: [[off[1] + j for j in range(64)],
                   [off[20] + j for j in range(64)]],
        kmers[3]: [[], []]}

    def placements(fm, sub, ks):
        gi = [s.n for s in gfm.sub_genomes].index(sub.n)
        pos = np.zeros((len(ks), 64), np.int32)
        valid = np.zeros((len(ks), 64), bool)
        for i, s in enumerate(ks):
            ps = [p - int(gfm.bases[gi]) for p in want[s][gi]]
            pos[i, :len(ps)] = ps
            valid[i, :len(ps)] = True
        return pos, valid

    monkeypatch.setattr(fusion_post, "group_indexes",
                        lambda *a, **k: gfm)
    monkeypatch.setattr(fusion_post, "_align_kmers", placements)
    _fusions_out(str(tmp_path / "tophat_s" / "fusions.out"), kmers)
    kmap = fusion_post.build_kmer_map(g, ["s"], str(tmp_path),
                                      cwd=str(tmp_path), device="cpu")

    def where(p):
        c = max(i for i in range(24) if off[i] <= p)
        return (g.names[c], p - off[c])

    assert kmap == {s: [where(p) for p in (want[s][0] + want[s][1])[:100]]
                    for s in kmers[:3]}
    assert kmap[kmers[0]][2:] == [("chr13", (1 << 31) + 7 - off[12]),
                                  ("chr14", 1)]
    assert kmap[kmers[1]][-1] == ("chr24", off[24] - off[23] - 23)
    assert [c for c, _ in kmap[kmers[2]]] == ["chr2"] * 64 + ["chr21"] * 36
    lines = (tmp_path / "fusion_seq.map").read_text().splitlines()
    assert lines[1] == kmers[1] + "\t" + ",".join(
        f"{c}:{p}" for c, p in kmap[kmers[1]])
