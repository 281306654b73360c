"""The port's coverage search (pipeline/coverage.py) against the
benchmark's plain reference (benchmarks/reference/coverage.py: a painted
genome, a per-10-mer dict and a scalar walk of each extension), event for
event and in order, on seeded random genomes of 2^16-2^20 bases in 2-4
contigs: IUM rows whose introns lie near a read end, islands at contig and
genome ends, antisense (CT..AC) introns read from the minus strand, a left
site with more right sites than the 16-pair cap, a MAX_COV_EVENTS cut, and
the rows and hits of the port's own mapping; the search's three phase
spans and its counters."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmarks.reference import coverage as ref  # noqa: E402
from tophat_tpu_torch.index.fasta import Genome, revcomp  # noqa: E402
from tophat_tpu_torch.pipeline import coverage  # noqa: E402
from tophat_tpu_torch.pipeline.params import Params  # noqa: E402
from tophat_tpu_torch.pipeline.segment import GenomeSpaceReads  # noqa: E402
from tophat_tpu_torch.utils import trace  # noqa: E402

L, SEG, HITS = 100, 25, 2
SENSE, ANTI = ((2, 3), (0, 2)), ((1, 3), (0, 1))   # GT..AG, CT..AC


class Case:
    """A genome in contigs and the rows and segment hits of one call:
    every row 100 bases in four 25-base segments, its reverse-complement
    row beside it; a segment has a hit where it lies whole in one exon."""

    def __init__(self, seed, n, contigs):
        self.rng = np.random.default_rng(seed)
        self.codes = self.rng.integers(0, 4, n).astype(np.int8)
        cut = np.sort(self.rng.choice(np.arange(4000, n - 4000, 1000),
                                      contigs - 1, replace=False))
        self.offsets = np.concatenate([[0], cut, [n]]).astype(np.int64)
        self.rows, self.hits = [], []

    def intron(self, a, length, motif=SENSE):
        """Plant an intron [a, a + length) with the motif's dinucleotides;
        the exon after it starts at a + length."""
        (d1, d2), (a1, a2) = motif
        self.codes[a:a + 2] = [d1, d2]
        self.codes[a + length - 2:a + length] = [a1, a2]
        return a + length

    def read(self, a, b, t, minus=False):
        """A read of t bases ending at a, then L - t from b (t = L: a
        contiguous read ending at a); from the minus strand its forward
        row is the reverse complement."""
        seq = np.concatenate([self.codes[a - t:a], self.codes[b:b + L - t]])
        hits = []
        for j in range(0, L, SEG):
            if j + SEG <= t:
                hits.append(a - t + j)
            elif j >= t:
                hits.append(b + j - t)
            else:
                hits.append(-1)
        if minus:
            seq, hits = revcomp(seq), hits[::-1]
        self.rows += [seq, revcomp(seq)]
        self.hits += [hits, hits[::-1]]

    def contiguous(self, start):
        self.read(start + L, start + L, L)

    def noise(self, k):
        """k rows of random bases with hits at random positions."""
        n = len(self.codes)
        for _ in range(k):
            seq = self.rng.integers(0, 4, L).astype(np.int8)
            hits = [int(h) if self.rng.random() < 0.5 else -1
                    for h in self.rng.integers(0, n - SEG, L // SEG)]
            self.rows += [seq, revcomp(seq)]
            self.hits += [hits, hits[::-1]]

    def inputs(self):
        """(fm, genome, gs, seg tables) as the pipeline hands them over."""
        import types

        rows = len(self.rows)
        S = L // SEG
        gs = GenomeSpaceReads(
            readsg=np.stack(self.rows).astype(np.int8),
            lengths=np.full(rows, L, np.int32),
            cuts=np.tile(np.arange(0, L + 1, SEG, dtype=np.int32),
                         (rows, 1)),
            nseg=np.full(rows, S, np.int32),
            read_idx=np.arange(rows, dtype=np.int32) // 2,
            strand=np.tile(np.array([0, 1], np.int8), rows // 2))
        pos = np.full((rows, S, HITS), -1, np.int32)
        pos[:, :, 0] = np.array(self.hits, np.int32)
        valid = pos >= 0
        tables = (torch.as_tensor(pos),
                  torch.zeros(pos.shape, dtype=torch.int8),
                  torch.as_tensor(valid))
        fm = types.SimpleNamespace(n=len(self.codes), genome_host=self.codes)
        genome = Genome(codes=self.codes, offsets=self.offsets,
                        names=[f"c{i}" for i in range(len(self.offsets) - 1)])
        return fm, genome, gs, tables


def _both(fm, genome, gs, tables, params=None, max_events=None):
    """The port's events and the reference's, after holding them equal
    element for element and in order; the port's."""
    params = params or Params()
    got = coverage.coverage_search_events(fm, genome, gs, tables, params)
    hs, hl, rows = ref.call_inputs(gs.readsg, gs.lengths, gs.strand,
                                   gs.cuts, tables[0].numpy(),
                                   tables[2].numpy())
    left, right, anti = ref.coverage_events(
        genome.codes, genome.offsets, hs, hl, rows, params.min_coverage_intron,
        params.max_coverage_intron,
        coverage.MAX_COV_EVENTS if max_events is None else max_events)
    np.testing.assert_array_equal(got["left"], left)
    np.testing.assert_array_equal(got["right"], right)
    np.testing.assert_array_equal(got["antisense"], anti)
    return got


def _near_ends(seed, n, contigs, motif=SENSE, minus=False):
    """Introns of 60-2,000 bases, each crossed by reads whose junction lies
    within one segment of a read end (t = 12-24 or 76-88: no pair of
    mapped segments flanks it) and by one read with a long anchor each
    side; contiguous reads beside both exons make the islands."""
    c = Case(seed, n, contigs)
    junctions = []
    for lo, hi in zip(c.offsets[:-1], c.offsets[1:]):
        for a in range(int(lo) + 600, int(hi) - 4000, 3000):
            a += int(c.rng.integers(0, 200))
            b = c.intron(a, int(c.rng.integers(60, 2000)), motif)
            for t in (int(c.rng.integers(12, 25)),
                      int(c.rng.integers(76, 89)), 50):
                c.read(a, b, t, minus)
            c.contiguous(a - L - int(c.rng.integers(0, 20)))
            c.contiguous(b + int(c.rng.integers(0, 20)))
            junctions.append((a - 1, b))
    return c, junctions


@pytest.mark.parametrize("seed,n,contigs", [
    (1, 1 << 16, 2), (2, 1 << 18, 3), (3, 1 << 20, 4)])
def test_introns_near_read_ends_match_reference(seed, n, contigs):
    c, junctions = _near_ends(seed, n, contigs)
    c.noise(40)
    got = _both(*c.inputs())
    sense = ~got["antisense"]
    found = set(zip(got["left"][sense].tolist(), got["right"][sense].tolist()))
    # a noise hit beside an exon moves its island's end, and TopHat's
    # search then misses that junction; most are found
    assert len(junctions) >= 8
    assert len(found & set(junctions)) >= 0.75 * len(junctions)


@pytest.mark.parametrize("seed,n,contigs", [(4, 1 << 17, 2),
                                            (5, 1 << 19, 4)])
def test_antisense_introns_match_reference(seed, n, contigs):
    """CT..AC introns whose reads come from the minus strand: their
    forward rows hold the reverse complement, so only the check's
    reverse-complement orientation admits them."""
    c, junctions = _near_ends(seed, n, contigs, motif=ANTI, minus=True)
    got = _both(*c.inputs())
    anti = set(zip(got["left"][got["antisense"]].tolist(),
                   got["right"][got["antisense"]].tolist()))
    assert len(anti & set(junctions)) >= 0.9 * len(junctions)


@pytest.mark.parametrize("seed,n,contigs", [(6, 1 << 16, 3),
                                            (7, 1 << 18, 4)])
def test_islands_at_contig_and_genome_ends_match_reference(seed, n,
                                                           contigs):
    """Islands that start at base 0, end at the genome's end, end on a
    contig's last base and start on the next contig's first (one painted
    island across the boundary), with introns just inside each contig
    end, so look windows run across contig ends."""
    c = Case(seed, n, contigs)
    ends = [int(x) for x in c.offsets]
    c.contiguous(0)
    c.contiguous(n - L)
    for i, e in enumerate(ends[1:-1]):
        c.contiguous(e - L)
        if i % 2:
            # an island ends on the contig's last base: its look-right
            # window runs into the next contig, which holds a donor
            b = c.intron(e + 10, 200)
            c.read(e + 10, b, 30)
            c.contiguous(b + 5)
            continue
        c.contiguous(e)
        # an intron whose donor lies 3 bases before the contig's end, and
        # one whose acceptor's exon starts 2 bases into the next contig
        b = c.intron(e - 3, 120)
        c.read(e - 3, b, 30)
        c.contiguous(b)
        a = e - 400
        c.intron(a, 402)
        c.read(a, e + 2, 70)
        c.contiguous(a - L)
    for a in (150, n - 2600):
        b = c.intron(a, 300)
        c.read(a, b, 40)
        c.contiguous(b + 10)
    c.noise(20)
    got = _both(*c.inputs())
    assert len(got["left"]) >= 2


def test_site_past_the_pair_cap_matches_reference(monkeypatch):
    """A donor with 40 acceptor sites in range, one island each, and a
    read for its junction to the 30th: the 16-pair cap keeps that
    junction out of both; without the cap the reference finds it."""
    c = Case(8, 1 << 18, 2)
    a = 5000
    c.contiguous(a - L)
    accs = []
    for k in range(40):
        b = c.intron(a, 80 + 150 * k, SENSE)
        c.contiguous(b + 30)
        accs.append(b)
    c.read(a, accs[29], 40)
    c.read(a, accs[1], 40)
    fm, genome, gs, tables = c.inputs()
    got = _both(fm, genome, gs, tables)
    found = set(zip(got["left"].tolist(), got["right"].tolist()))
    assert (a - 1, accs[1]) in found and (a - 1, accs[29]) not in found
    monkeypatch.setattr(ref, "MAX_PAIRS_PER_SITE", 1000)
    hs, hl, rows = ref.call_inputs(gs.readsg, gs.lengths, gs.strand,
                                   gs.cuts, tables[0].numpy(),
                                   tables[2].numpy())
    left, right, _ = ref.coverage_events(c.codes, c.offsets, hs, hl, rows,
                                         50, 20000)
    assert (a - 1, accs[29]) in set(zip(left.tolist(), right.tolist()))


def test_max_cov_events_cut_matches_reference(monkeypatch):
    c, _ = _near_ends(9, 1 << 17, 2)
    full = _both(*c.inputs())
    cap = len(full["left"]) // 2
    assert cap >= 3
    monkeypatch.setattr(coverage, "MAX_COV_EVENTS", cap)
    trace.reset()
    got = _both(*c.inputs(), max_events=cap)
    np.testing.assert_array_equal(got["left"], full["left"][:cap])
    cnt = trace.snapshot()["counters"]
    assert cnt["coverage.events"] == cap
    assert cnt["coverage.dropped"] == len(full["left"]) - cap


def test_mapped_rows_match_reference():
    """The rows and segment hits of the port's own mapping on a 2^16-base
    genome in 2 contigs (introns planted, reads with short anchors)."""
    from tophat_tpu_torch.index.fm import build_fm_index
    from tophat_tpu_torch.io.fastq import batch_reads
    from tophat_tpu_torch.pipeline.run import _align_mate, _spliced_mate

    c, _ = _near_ends(10, 1 << 16, 2)
    genome = Genome(codes=c.codes, offsets=c.offsets, names=["a", "b"])
    fm = build_fm_index(genome, kmer_k=0, device="cpu")
    recs = [(f"r{i}", "".join("ACGTN"[x] for x in s), b"I" * len(s))
            for i, s in enumerate(c.rows[::2])]
    params = Params()
    m, ium, rf, rr, lens = _align_mate(fm, genome.offsets.astype(np.int32),
                                       batch_reads(recs), params,
                                       lambda *a: None)
    _spliced_mate(fm, genome.offsets.astype(np.int32), m, params, ium, rf,
                  rr, lens, log=lambda *a: None)
    got = _both(fm, genome, m.gs, m.seg_tables, params)
    assert len(got["left"]) >= 4


def test_phase_spans_and_counters():
    """Each call opens the three phase spans once, inside coverage_search;
    the events returned and those the cut drops add up to the extendable
    pairs, and the sites and events are counted."""
    c, _ = _near_ends(11, 1 << 16, 2)
    inputs = c.inputs()
    trace.reset()
    trace.enable()
    try:
        out = [coverage.coverage_search_events(*inputs, Params())
               for _ in range(2)]
    finally:
        trace.disable()
    snap = trace.snapshot()
    trace.reset()
    parents = {r.name: r.parent for r in snap["records"]}
    sp = snap["spans"]
    assert sp["coverage_search"]["calls"] == 2
    for phase in ("islands", "mers", "pairs"):
        name = f"coverage_search.{phase}"
        assert parents[name] == "coverage_search"
        assert sp[name]["calls"] == 2
    cnt = snap["counters"]
    assert cnt["coverage.events"] == sum(len(o["left"]) for o in out) > 0
    assert cnt["coverage.dropped"] == 0
    assert (cnt["coverage.events"] + cnt["coverage.dropped"]
            == cnt["coverage.extendable"])
    assert cnt["coverage.sites"] > 0
    assert sp["coverage_search.islands"]["counts"]["coverage.sites"] == \
        cnt["coverage.sites"]
    assert sp["coverage_search.pairs"]["counts"]["coverage.pairs"] == \
        cnt["coverage.pairs"]
