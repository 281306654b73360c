"""Mate pairs (or single reads) of a traffic mix, with where each mate
truly lies.

A vectorised frozen copy of the port's smoke generators make_pairs and
make_annotated_pairs. A traffic file gives the read length, the mates a
fragment (2: pairs, the default; 1: single-end reads, mate 1 of each
pair), the fragments a sample, the mix of kinds and the inner-distance
law; a sample is drawn from (run seed, sample index), so the same seed
gives the same reads. Every sample of a mix has the same number of
fragments of each kind: seeds change where the reads lie, not how much
work they are. No fragment crosses from one contig into another.

Kinds of pairs, assigned by the pair's index within the mix's period:
  transcript   both mates a fragment of an annotated transcript (in
               transcript space, so a mate crosses the exon junctions
               inside it); the mates swap in every other period
  junction     mate 1 crosses one of the genome's unannotated introns
               with at least `anchor` bases on each side; mate 2 is
               contiguous downstream
  contiguous   both mates contiguous, each with `mismatches` mismatches,
               anywhere in the genome (repeats included)
Mate 2 is the reverse complement of the downstream fragment (mate 1 of a
swapped transcript pair). The truth of a mate is the genome position of
each of its bases in genome order (`gp`) and its strand (`rev`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

KINDS = ("transcript", "junction", "contiguous")
LUT = np.frombuffer(b"ACGTN", np.uint8)


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of code rows (A<->T, C<->G; N stays N)."""
    return np.where(codes < 4, 3 - codes, codes)[..., ::-1].astype(np.int8)


def sample_rng(seed: int, tag: int, index: int) -> np.random.Generator:
    """The generator of sample `index` of stream `tag` (harness/core:
    the window's samples, the warm sample, the check's draws, the order
    of a sample's pairs) of a run seeded with `seed`."""
    ss = np.random.SeedSequence(entropy=seed & (2 ** 64 - 1),
                                spawn_key=(tag, index))
    return np.random.default_rng(ss)


@dataclasses.dataclass
class TranscriptTable:
    """Transcripts as flat exon tables: transcript t is the concatenation
    of its exons' forward-strand codes."""

    length: np.ndarray       # (T,) bases
    start: np.ndarray        # (T,) offset of transcript t in the concatenation
    exon_cstart: np.ndarray  # (X,) offset of each exon in the concatenation
    exon_gstart: np.ndarray  # (X,) genome position of each exon's first base

    @classmethod
    def of(cls, transcripts) -> "TranscriptTable":
        lens = np.array([sum(b - a for a, b in ex) for ex in transcripts],
                        np.int64)
        start = np.zeros(len(lens), np.int64)
        np.cumsum(lens[:-1], out=start[1:])
        gstart = np.array([a for ex in transcripts for a, _ in ex], np.int64)
        elen = np.array([b - a for ex in transcripts for a, b in ex],
                        np.int64)
        cstart = np.zeros(len(elen), np.int64)
        np.cumsum(elen[:-1], out=cstart[1:])
        return cls(lens, start, cstart, gstart)

    def genome_positions(self, t: np.ndarray, off: np.ndarray) -> np.ndarray:
        """Genome positions of transcript offsets off (n, L) of transcripts
        t (n,)."""
        cc = self.start[t][:, None] + off
        k = np.searchsorted(self.exon_cstart, cc, side="right") - 1
        return self.exon_gstart[k] + (cc - self.exon_cstart[k])


@dataclasses.dataclass
class Sample:
    m1: np.ndarray           # (n, L) int8 codes as sequenced
    m2: object               # (n, L) codes, or None for single-end reads
    kind: np.ndarray         # (n,) index into KINDS
    gp: np.ndarray           # (n, mates, L) int64 genome positions, genome
    #                          order
    rev: np.ndarray          # (n, mates) bool: the mate reads the reverse
    #                          strand

    @property
    def pairs(self) -> int:
        return len(self.kind)

    @property
    def mates(self) -> tuple:
        return (self.m1,) if self.m2 is None else (self.m1, self.m2)

    def take(self, rows: np.ndarray) -> "Sample":
        return Sample(*(None if getattr(self, f.name) is None
                        else getattr(self, f.name)[rows]
                        for f in dataclasses.fields(self)))


def kinds_of(traffic: dict, n: int) -> np.ndarray:
    """(n,) kind of each pair: the mix's period repeated."""
    period = np.concatenate([np.full(int(traffic["mix"][k]), i, np.int8)
                             for i, k in enumerate(KINDS)])
    return period[np.arange(n) % len(period)]


def make_pairs(codes, offsets, tx: TranscriptTable, introns, traffic: dict,
               rng: np.random.Generator, n: int) -> Sample:
    """n fragments of the mix; `offsets` the contigs' spans (global)."""
    L = int(traffic["read_len"])
    anchor = int(traffic["anchor"])
    n_g = len(codes)
    contig = lambda p: np.searchsorted(offsets, p, side="right") - 1
    ar = np.arange(L)
    kind = kinds_of(traffic, n)
    period = sum(int(v) for v in traffic["mix"].values())
    d = traffic["inner_dist"]
    inner = np.maximum(0, np.rint(rng.normal(d["mean"], d["sd"], n))
                       ).astype(np.int64)
    up = np.empty((n, L), np.int64)      # upstream fragment, genome order
    down = np.empty((n, L), np.int64)

    i = np.nonzero(kind == 0)[0]
    if len(i):
        need = 2 * L + inner[i]
        t = rng.integers(0, len(tx.length), len(i))
        short = tx.length[t] < need
        while short.any():
            t[short] = rng.integers(0, len(tx.length), int(short.sum()))
            short = tx.length[t] < need
        s = rng.integers(0, tx.length[t] - need + 1)
        up[i] = tx.genome_positions(t, s[:, None] + ar)
        down[i] = tx.genome_positions(t, (s + L + inner[i])[:, None] + ar)

    i = np.nonzero(kind == 1)[0]
    if len(i):
        left, right = np.array(introns, np.int64).T
        c = contig(left)
        ok = (left - L >= offsets[c]) & (right + 3 * L + 400 < offsets[c + 1])
        left, right = left[ok], right[ok]
        j = rng.integers(0, len(left), len(i))
        t = rng.integers(anchor, L - anchor + 1, len(i))[:, None]
        up[i] = np.where(ar < t, left[j, None] - t + 1 + ar,
                         right[j, None] + ar - t)
        down[i] = (right[j, None] + L - t + inner[i, None]) + ar

    i = np.nonzero(kind == 2)[0]
    if len(i):
        span = 3 * L + 400
        s = rng.integers(0, n_g - span, len(i))
        cross = contig(s) != contig(s + span)
        while cross.any():
            s[cross] = rng.integers(0, n_g - span, int(cross.sum()))
            cross = contig(s) != contig(s + span)
        s = s[:, None]
        up[i] = s + ar
        down[i] = s + L + inner[i, None] + ar

    a = codes[up]
    b = codes[down]
    i = np.nonzero(kind == 2)[0]
    for x in (a, b):
        for _ in range(int(traffic["mismatches"])):
            p = rng.integers(0, L, len(i))
            x[i, p] = (x[i, p] + 1) % 4
    swap = (kind == 0) & ((np.arange(n) // period) % 2 == 1)
    m1 = np.where(swap[:, None], revcomp(b), a).astype(np.int8)
    m2 = np.where(swap[:, None], a, revcomp(b)).astype(np.int8)
    gp = np.stack([np.where(swap[:, None], down, up),
                   np.where(swap[:, None], up, down)], axis=1)
    rev = np.stack([swap, ~swap], axis=1)
    if int(traffic.get("mates", 2)) == 1:
        return Sample(m1, None, kind, gp[:, :1], rev[:, :1])
    return Sample(m1, m2, kind, gp, rev)


def write_fastq(path: str, reads: np.ndarray, prefix: str = "p") -> None:
    """FASTQ of code rows, named <prefix><row>, all qualities 'I'."""
    seqs = LUT[reads]
    qual = b"I" * reads.shape[1]
    with open(path, "wb") as f:
        f.write(b"".join(b"@%s%d\n%s\n+\n%s\n" % (prefix.encode(), k,
                                                 row.tobytes(), qual)
                         for k, row in enumerate(seqs)))
