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


def _table_facts(table):
    """The port's extension table as sorted (key, side, length, bases)
    facts: the entry layout read back bit by bit."""
    facts = []
    for t in table.tolist():
        length = (t >> 28) & 15
        ext = t & ((1 << 28) - 1)
        bases = tuple((ext >> 2 * (length - 1 - j)) & 3
                      for j in range(length))
        facts.append((t >> 33, (t >> 32) & 1, length, bases))
    return facts


def _dict_facts(table):
    """The JAX package's dict table as the same sorted facts, less the
    extensions that can never match (shorter than 7 bases, or holding a
    code outside 0..3)."""
    facts = set()
    for key, exts in table.items():
        for side, ext in ((s, e) for le, ri in exts
                          for s, e in ((0, le), (1, ri))):
            if len(ext) >= 7 and ((ext >= 0) & (ext < 4)).all():
                facts.add((key, side, len(ext),
                           tuple(int(c) for c in ext)))
    return sorted(facts)


def _check_both(genome_codes, rows, pairs):
    """The port's batched check and the JAX package's scalar checker on
    the same pairs, after holding the two tables' facts equal."""
    from tophat_tpu.pipeline.butterfly import ExtendChecker as JChecker
    from tophat_tpu.pipeline.butterfly import build_mer_table as jtable
    from tophat_tpu_torch.pipeline.butterfly import (ExtendChecker,
                                                     build_mer_table,
                                                     pad_rows)

    table, ref = build_mer_table(*pad_rows(rows)), jtable(rows)
    assert _table_facts(table) == _dict_facts(ref)
    check = ExtendChecker(genome_codes, table)
    jcheck = JChecker(genome_codes, ref)
    want = [jcheck(l, r) for l, r in pairs]
    got = check.check([l for l, _ in pairs], [r for _, r in pairs])
    assert got.dtype == bool and got.tolist() == want
    return table, want


def test_mer_table_and_extend_checker_match_jax(mapped):
    """The array table holds the JAX dict's facts (less those that cannot
    match), and the batched check answers as the JAX scalar checker does,
    pair by pair."""
    from tophat_tpu_torch.pipeline.butterfly import forward_mer_table

    genome, fm, m, _ = mapped
    gs = m.gs
    rows = [gs.readsg[i, :int(gs.lengths[i])] for i in range(gs.rows)
            if int(gs.strand[i]) == 0]
    rng = np.random.default_rng(1)
    n = genome.n
    donors = np.nonzero((genome.codes[:-1] == 2)
                        & (genome.codes[1:] == 3))[0] - 1
    accs = np.nonzero((genome.codes[:-1] == 0) & (genome.codes[1:] == 2))[0]
    pairs = [(int(l), int(r) + 2) for l in donors
             for r in accs[(accs > l + 60) & (accs < l + 900)]]
    pairs += [(int(l), int(r)) for l, r in rng.integers(0, n, (200, 2))]
    pairs += [(0, 5), (3, n - 2), (n - 6, n - 1)]
    table, ok = _check_both(genome.codes, rows, pairs)
    assert len(table) > 100 and sum(ok) >= 8
    np.testing.assert_array_equal(forward_mer_table(gs), table)


def _edge_case(case):
    """(genome codes, read rows, (left, right) pairs) of one edge case of
    the extension check: reads hold a junction's 10-mer (5 bases ending
    at `left`, 5 starting at `right`) with `a` read bases before it and
    `b` after it, copied from the reference beside the junction."""
    from tophat_tpu_torch.index.fasta import revcomp

    rng = np.random.default_rng(list(EDGE_CASES).index(case) + 70)
    n = 3000
    g = rng.integers(0, 4, n).astype(np.int8)

    def read(l, r, a, b):
        return np.concatenate([g[max(0, l - 4 - a):l + 1],
                               g[r:r + 5 + b]])

    rows, pairs = [], []
    if case == "genome_start":      # l - 4 < 0, and short up windows
        for l in range(0, 26):
            rows.append(read(l, 1500 + l, 14, 0))
            pairs.append((l, 1500 + l))
    elif case == "genome_end":      # r + 5 > n, and short down windows
        for r in range(n - 28, n + 1):
            rows.append(read(700 + r % 97, r, 0, 14))
            pairs.append((700 + r % 97, r))
    elif case == "n_codes":         # N in the key, or in an extension
        for k in range(24):
            l, r = 100 + 60 * k, 1700 + 50 * k
            rows.append(read(l, r, 14, 14))
            pairs.append((l, r))
        for k in range(0, 24, 4):   # the reference's key
            g[100 + 60 * k - 2] = 4
        for k in range(1, 24, 4):   # the reference's up side
            g[100 + 60 * k - 4 - 3] = 4
        for k in range(2, 24, 4):   # both reference sides
            g[100 + 60 * k - 4 - 9] = 4
            g[1700 + 50 * k + 5 + 6] = 4
        for k in range(3, 24, 8):   # the read's key and its extensions
            rows[k][16] = 4
            rows[k + 4][3] = 4
            rows[k + 4][-2] = 4
    elif case == "ext_6_7":         # extensions of exactly 6 and 7 bases
        for k, (a, b) in enumerate([(6, 0), (7, 0), (0, 6), (0, 7),
                                    (6, 6), (7, 6), (6, 7), (13, 14)]):
            l, r = 200 + 97 * k, 1900 + 89 * k
            rows.append(read(l, r, a, b))
            pairs.append((l, r))
    elif case == "short_rows":      # rows of under 10 bases, and 10-16
        for k in range(12):
            l, r = 150 + 91 * k, 1800 + 83 * k
            rows.append(read(l, r, 14, 14)[:4 + k])
            rows.append(read(l, r, k // 2, 6 - k // 2))
            pairs.append((l, r))
        rows.append(read(2600, 2700, 14, 14))
        pairs.append((2600, 2700))
    elif case == "many_occurrences":    # one key in hundreds of reads
        l, r = 500, 2000
        base = read(l, r, 14, 14)
        for k in range(400):
            row = base.copy()
            row[:14] = rng.integers(0, 4, 14)
            row[-14:] = rng.integers(0, 4, 14)
            rows.append(row)
        # the same key at (1200, 2500), with other bases beside it
        g[1200 - 4:1200 + 1] = g[l - 4:l + 1]
        g[2500:2505] = g[r:r + 5]
        rows.append(base)
        pairs += [(l, r), (1200, 2500), (501, 2001), (l, 2003)]
    elif case == "antisense":       # reads of the other strand
        for k in range(20):
            l, r = 120 + 70 * k, 1600 + 61 * k
            a, b = [(14, 14), (14, 0), (0, 14), (7, 3), (3, 7)][k % 5]
            rows.append(revcomp(read(l, r, a, b)))
            pairs.append((l, r))
            if k % 3 == 0:
                rows.append(read(l + 1, r, a, b))
    for l, r in rng.integers(0, n, (60, 2)):
        pairs.append((int(l), int(r)))
    return g, rows, pairs


EDGE_CASES = ("genome_start", "genome_end", "n_codes", "ext_6_7",
              "short_rows", "many_occurrences", "antisense")


@pytest.mark.parametrize("case", EDGE_CASES)
def test_extend_check_edge_cases_match_jax(case):
    """The batched check against the JAX package's scalar checker on
    hand-made cases: junctions at the genome's two ends (l - 4 < 0,
    r + 5 > n, short reference windows), N codes in the key and in the
    extensions of the reference and of the reads, extensions of exactly
    6 and 7 bases, rows shorter than 10 bases, one key in hundreds of
    reads, and reads of either strand."""
    g, rows, pairs = _edge_case(case)
    _table, ok = _check_both(g, rows, pairs)
    assert any(ok) and not all(ok)


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


def _long_row_search(seed=11):
    """A coverage search over 300-bp rows on a (2^21 + 4096)-base genome
    in two contigs: 1,100 forward rows (1,020 contiguous reads, 80 rows of
    spliced pieces: 14 + 10 + 14 bases across a donor site near one
    island's end and an acceptor near the next island's start) and 100
    reverse rows; one hit a 25-base island, 1,500 islands 600 bases apart
    on random bases and 1,500 islands 200 bases apart on a 23-base repeat
    whose every donor pairs with far more than MAX_PAIRS_PER_SITE
    acceptors, all extendable (one spliced piece each way), so that the
    event table runs past MAX_COV_EVENTS. Returns (codes, offsets, rows'
    fields, hit tables)."""
    from tophat_tpu_torch.index.fasta import revcomp

    rng = np.random.default_rng(seed)
    n = (1 << 21) + 4096
    codes = rng.integers(0, 4, n).astype(np.int8)
    motif = {(2, 3), (0, 2), (1, 3), (0, 1)}      # GT, AG, CT, AC
    while True:     # one site of each motif a repeat unit, no other
        unit = rng.integers(0, 4, 23).astype(np.int8)
        unit[[3, 4, 9, 10, 14, 15, 19, 20]] = [2, 3, 0, 2, 1, 3, 0, 1]
        if sum((int(unit[i]), int(unit[(i + 1) % 23])) in motif
               for i in range(23)) == 4:
            break
    p0, p1 = 1_000_000, 1_300_000
    codes[p0:p1] = np.tile(unit, (p1 - p0) // 23 + 1)[:p1 - p0]
    offsets = np.array([0, 1_180_003, n], np.int64)
    starts = np.concatenate([np.arange(200_000, 1_100_000, 600),
                             np.arange(p0 + 100, p1 - 100, 200)])

    def piece(d, a):
        l, r = d - 1, a + 2
        return np.concatenate([codes[l - 18:l + 1], codes[r:r + 19]])

    def site(lo, hi, x, y):
        at = lo + np.nonzero((codes[lo:hi - 1] == x)
                             & (codes[lo + 1:hi] == y))[0]
        return int(at[0]) if at.size else None

    pieces = []
    for x, y, u, v in ((2, 3, 0, 2), (1, 3, 0, 1)):   # the repeat
        d = site(p0 + 300, p0 + 400, x, y)
        pieces.append(piece(d, site(d + 300, d + 400, u, v)))
    for s in starts[:1500:3]:       # random bases: a junction each way
        fall, rise = s + 25, s + 600
        for (x, y), (u, v) in (((2, 3), (0, 2)), ((1, 3), (0, 1))):
            d, a = site(fall - 5, fall + 45, x, y), site(rise - 45,
                                                         rise + 5, u, v)
            if d is not None and a is not None:
                pieces.append(piece(d, a))
    L = 300
    fwd = [codes[s:s + L] for s in rng.integers(0, n - L, 1020)]
    for k in range(0, len(pieces), 7):
        row = np.concatenate(pieces[k:k + 7])
        fwd.append(np.concatenate([row, rng.integers(0, 4, L - len(row))]
                                  ).astype(np.int8))
    fwd = fwd[:1100]
    assert len(fwd) == 1100
    rows = fwd + [revcomp(r) for r in fwd[:100]]
    readsg = np.stack(rows).astype(np.int8)
    readsg[5, 40] = 4                               # an N in a read
    R = len(rows)
    fields = dict(
        readsg=readsg, lengths=np.full(R, L, np.int32),
        cuts=np.tile(np.arange(0, L + 1, 25, dtype=np.int32), (R, 1)),
        nseg=np.full(R, L // 25, np.int32),
        read_idx=np.arange(R, dtype=np.int32) % 1100,
        strand=(np.arange(R) >= 1100).astype(np.int8))
    pos = np.full((R, L // 25, 2), -1, np.int32)
    pos.reshape(-1)[:len(starts)] = starts
    return codes, offsets, fields, (pos, np.zeros(pos.shape, np.int8),
                                    pos >= 0)


def test_coverage_search_300bp_rows_match_jax():
    """The coverage search over 300-bp rows, 1,100 forward, on a genome
    past 2^21 bases: its event table equals the JAX package's element for
    element, in order and dtype, with the per-site pair cap engaged and
    the table cut at MAX_COV_EVENTS; the three counters say how often the
    gate ran and passed."""
    import types

    import torch

    from tophat_tpu.pipeline import coverage as jc
    from tophat_tpu.pipeline.segment import GenomeSpaceReads as JGs
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.pipeline import coverage
    from tophat_tpu_torch.pipeline.butterfly import MAX_PAIRS_PER_SITE
    from tophat_tpu_torch.pipeline.params import Params
    from tophat_tpu_torch.pipeline.segment import GenomeSpaceReads
    from tophat_tpu_torch.utils import trace

    codes, offsets, fields, tables = _long_row_search()
    genome = Genome(codes=codes, offsets=offsets, names=["c0", "c1"])
    fm = types.SimpleNamespace(n=len(codes), genome=codes)
    before = dict(trace.snapshot()["counters"])
    got = coverage.coverage_search_events(
        fm, genome, GenomeSpaceReads(**fields),
        tuple(torch.as_tensor(t) for t in tables), Params())
    after = trace.snapshot()["counters"]
    ref = jc.coverage_search_events(fm, genome, JGs(**fields), tables,
                                    _jax_params())
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
        assert got[k].dtype == np.asarray(ref[k]).dtype, k
    grew = {k: after.get(k, 0) - before.get(k, 0)
            for k in ("coverage.mers", "coverage.pairs",
                      "coverage.extendable")}
    assert len(got["left"]) == coverage.MAX_COV_EVENTS
    assert grew["coverage.extendable"] > coverage.MAX_COV_EVENTS
    assert grew["coverage.pairs"] > grew["coverage.extendable"]
    # two extensions a 10-mer of the random rows; the rows that fall on
    # the repeat collapse into a few entries
    assert grew["coverage.mers"] > 1100 * 300
    assert 0 < got["antisense"].sum() < len(got["left"])
    _, per_left = np.unique(got["left"], return_counts=True)
    assert per_left.max() == MAX_PAIRS_PER_SITE
    random_part = got["left"] < 1_000_000
    assert random_part.sum() >= 100
