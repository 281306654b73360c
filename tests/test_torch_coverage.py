"""Parity of the coverage, butterfly and microexon searches: the port's
pipeline/coverage.py and pipeline/butterfly.py against the JAX package's,
on the same segment tables (equal event arrays), and run_pipeline with
each search switched on (byte-identical output files)."""

import numpy as np
import pytest

OUTPUTS = ("accepted_hits.sam", "junctions.bed", "insertions.bed",
           "deletions.bed", "prep_reads.info")


def _workload(n, seed=3, L=76):
    """Genome with planted GT-AG introns (80-300 bp); per intron, reads
    spliced with both anchors >= 20 bp, reads whose junction lies inside
    the first or the last 25-bp segment (short anchors: the coverage and
    microexon searches' cases), and contiguous reads over both exons so
    coverage islands form; plus contiguous reads with a mismatch."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.int8)
    codes[n // 4:n // 4 + 15] = 4
    seqs = []
    for k in range(8):
        a = int(rng.integers(2000, n - 3000))
        il = int(rng.integers(80, 300))
        codes[a:a + 2] = [2, 3]
        codes[a + il - 2:a + il] = [0, 2]
        ts = [int(rng.integers(20, L - 20)) for _ in range(2)]
        ts += [int(rng.integers(9, 16)), L - int(rng.integers(9, 16))]
        for t in ts:
            seqs.append(np.concatenate([codes[a - t:a],
                                        codes[a + il:a + il + L - t]]))
        for s in (a - L - 20, a - L // 2 - 10, a + il + 5, a + il + 30):
            seqs.append(codes[s:s + L].copy())
    for k in range(24):
        s = int(rng.integers(0, n - L))
        seq = codes[s:s + L].copy()
        p = int(rng.integers(0, L))
        seq[p] = (seq[p] + 1) % 4
        seqs.append(seq)
    recs = [(f"r{i}", "".join("ACGTN"[c] for c in s), b"I" * len(s))
            for i, s in enumerate(seqs)]
    return codes, recs


@pytest.fixture(scope="module")
def mapped():
    """One workload mapped by the port on the CPU: its genome-space rows
    and segment tables, plus the JAX package's genome-space rows."""
    from tophat_tpu.pipeline.segment import build_genome_space as jgs
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.index.fm import build_fm_index
    from tophat_tpu_torch.io.fastq import batch_reads
    from tophat_tpu_torch.pipeline.params import Params
    from tophat_tpu_torch.pipeline.run import _align_mate, _spliced_mate

    n = 30000
    codes, recs = _workload(n)
    genome = Genome(codes=codes, offsets=np.array([0, n]), names=["chrC"])
    fm = build_fm_index(genome, kmer_k=0, device="cpu")
    params = Params()
    m, ium, rf, rr, lens = _align_mate(fm, genome.offsets.astype(np.int32),
                                       batch_reads(recs), params,
                                       lambda *a: None)
    _spliced_mate(fm, genome.offsets.astype(np.int32), m, params, ium, rf,
                  rr, lens)
    gs_jax = jgs(rf, rr, lens, params.segment_length, row_mask=ium,
                 pad_rows_pow2=True)
    for f in ("readsg", "lengths", "strand", "read_idx", "cuts", "nseg"):
        np.testing.assert_array_equal(getattr(gs_jax, f), getattr(m.gs, f))
    return genome, fm, m, gs_jax


def _jax_params(**kw):
    from tophat_tpu.pipeline.params import Params as JParams

    return JParams(**kw)


@pytest.mark.parametrize("search", ["coverage", "butterfly", "microexon"])
def test_search_events_match_jax(mapped, search):
    import types

    from tophat_tpu.pipeline import butterfly as jb
    from tophat_tpu.pipeline import coverage as jc
    from tophat_tpu_torch.pipeline import butterfly, coverage
    from tophat_tpu_torch.pipeline.params import Params

    genome, fm, m, gs_jax = mapped
    port_fn, jax_fn = {
        "coverage": (coverage.coverage_search_events,
                     jc.coverage_search_events),
        "butterfly": (butterfly.butterfly_search_events,
                      jb.butterfly_search_events),
        "microexon": (butterfly.microexon_events, jb.microexon_events),
    }[search]
    got = port_fn(fm, genome, m.gs, m.seg_tables, Params())
    jfm = types.SimpleNamespace(n=fm.n, genome=genome.codes)
    ref = jax_fn(jfm, genome, gs_jax,
                 tuple(x.numpy() for x in m.seg_tables), _jax_params())
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    assert len(got["left"]) >= 4


def test_mer_table_and_extend_checker_match_jax(mapped):
    from tophat_tpu.pipeline.butterfly import ExtendChecker as JChecker
    from tophat_tpu.pipeline.butterfly import build_mer_table as jtable
    from tophat_tpu_torch.pipeline.butterfly import (ExtendChecker,
                                                     build_mer_table)

    genome, fm, m, _ = mapped
    gs = m.gs
    rows = [gs.readsg[i, :int(gs.lengths[i])] for i in range(gs.rows)
            if int(gs.strand[i]) == 0]
    got, ref = build_mer_table(rows), jtable(rows)
    assert sorted(got) == sorted(ref) and len(got) > 100
    for k in ref:
        assert [(a.tobytes(), b.tobytes()) for a, b in got[k]] == \
            [(a.tobytes(), b.tobytes()) for a, b in ref[k]]
    check, jcheck = ExtendChecker(genome.codes, got), JChecker(genome.codes,
                                                                ref)
    rng = np.random.default_rng(1)
    n = genome.n
    donors = np.nonzero((genome.codes[:-1] == 2)
                        & (genome.codes[1:] == 3))[0] - 1
    accs = np.nonzero((genome.codes[:-1] == 0) & (genome.codes[1:] == 2))[0]
    pairs = [(int(l), int(r) + 2) for l in donors
             for r in accs[(accs > l + 60) & (accs < l + 900)]]
    pairs += [(int(l), int(r)) for l, r in rng.integers(0, n, (200, 2))]
    pairs += [(0, 5), (3, n - 2), (n - 6, n - 1)]
    got_ok = [check(l, r) for l, r in pairs]
    assert got_ok == [jcheck(l, r) for l, r in pairs]
    assert sum(got_ok) >= 8


@pytest.mark.parametrize("mode,n", [
    ("default", 30000), ("default", (1 << 21) + 4096),
    ("butterfly", 30000), ("microexon", 30000)])
def test_run_pipeline_search_modes_identical(tmp_path, mode, n):
    from tophat_tpu.index.fasta import Genome as JGenome
    from tophat_tpu.io.fastq import batch_reads as jbatch
    from tophat_tpu.pipeline.run import run_pipeline as jrun
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.io.fastq import batch_reads
    from tophat_tpu_torch.pipeline.params import Params
    from tophat_tpu_torch.pipeline.run import run_pipeline

    kw = {"default": {}, "butterfly": {"butterfly_search": True},
          "microexon": {"microexon_search": True}}[mode]
    codes, recs = _workload(n, seed=4)
    offsets = np.array([0, n])
    logs = []
    jrun(JGenome(codes=codes, offsets=offsets, names=["chrC"]),
         jbatch(recs), _jax_params(**kw), str(tmp_path / "jax"),
         log=lambda *a: None)
    out = run_pipeline(Genome(codes=codes, offsets=offsets, names=["chrC"]),
                       batch_reads(recs), Params(**kw),
                       str(tmp_path / "torch"), log=logs.append,
                       device="cpu")
    for f in OUTPUTS:
        assert (tmp_path / "jax" / f).read_bytes() == \
            (tmp_path / "torch" / f).read_bytes(), f
    sam = (tmp_path / "torch" / "accepted_hits.sam").read_text()
    assert sum(1 for ln in sam.splitlines()
               if "N" in ln.split("\t")[5]) >= 24
    what = {"default": "coverage", "butterfly": "butterfly",
            "microexon": "microexon"}[mode]
    assert any(ln.startswith(f"{what} search: ") for ln in logs), logs
    assert len(out["events"]["left"]) >= 8


def _hit_tables(gs, seg_pos, case, seed):
    """Segment hit tables (pos, mm, valid) shaped like `seg_pos` for the
    coverage search's edge cases, on a genome of n = 30,000 bases: the
    run's own hits with random ones mixed in, islands at base 0 and
    running past n, islands that touch end to start (one island), and no
    hit at all."""
    rng = np.random.default_rng(seed)
    n = 30000
    pos = np.array(seg_pos, np.int32)
    valid = pos >= 0
    seg_len = gs.cuts[:, 1:] - gs.cuts[:, :-1]
    if case == "random":
        extra = rng.random(pos.shape) < 0.3
        pos = np.where(extra, rng.integers(0, n, pos.shape),
                       pos).astype(np.int32)
        valid = valid | extra
    elif case == "edges":
        # islands at base 0 and ending on (or clipped to) base n, and two
        # pairs of hits that touch: [a, a + l) then [a + l, a + 2 l)
        first = np.unravel_index(np.arange(8), pos.shape)
        for k, (r, s, h) in enumerate(zip(*first)):
            ln = int(seg_len[r, s])
            at = [0, 3, n - ln, n - 5, 12000, 12000 + ln, 20000,
                  20000 + ln][k]
            pos[r, s, h], valid[r, s, h] = at, True
    elif case == "empty":
        valid[:] = False
    return (pos, np.zeros(pos.shape, np.int8), valid)


@pytest.mark.parametrize("case,seed,contigs", [
    ("random", 1, (0, 30000)), ("random", 2, (0, 12010, 12060, 30000)),
    ("random", 3, (0, 200, 29900, 30000)), ("edges", 4, (0, 30000)),
    ("edges", 5, (0, 12000, 12030, 30000)), ("empty", 6, (0, 30000))])
def test_coverage_search_from_intervals_matches_jax(mapped, case, seed,
                                                    contigs):
    """The port's coverage search finds islands, look windows and
    dinucleotide sites from the hits' intervals, with no pass over the
    genome; its event tables equal the JAX package's painted search,
    element for element and in order: random hits over the run's own,
    islands at base 0 and past n, touching islands, look windows that
    overlap across contig ends (contigs of 50, 30 and 100 bases), and
    an empty hit set."""
    import types

    import torch

    from tophat_tpu.pipeline import coverage as jc
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.pipeline import coverage
    from tophat_tpu_torch.pipeline.params import Params

    genome, fm, m, gs_jax = mapped
    g = Genome(codes=genome.codes, offsets=np.array(contigs, np.int64),
               names=[f"c{i}" for i in range(len(contigs) - 1)])
    tables = _hit_tables(m.gs, m.seg_tables[0].numpy(), case, seed)
    got = coverage.coverage_search_events(
        fm, g, m.gs, tuple(torch.as_tensor(t) for t in tables), Params())
    ref = jc.coverage_search_events(
        types.SimpleNamespace(n=fm.n, genome=genome.codes), g, gs_jax,
        tables, _jax_params())
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
        assert got[k].dtype == np.asarray(ref[k]).dtype, k
    if case == "empty":
        assert len(got["left"]) == 0
    elif contigs == (0, 30000):
        assert len(got["left"]) >= 4
