"""The configuration's genome, its repeats, unannotated introns and
annotation.

Generators in the manner of the port's smoke (make_genome, pick_junctions,
make_annotation), grown to a published assembly's layout: named contigs of
given lengths, repeat families planted as diverged copies, genes placed
independently (so they may overlap) with a two-mode intron-length law.
They stand for a published assembly and annotation: the same seeds give
the same genome, introns and GTF on every run. They import nothing of the
port.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# codes A0 C1 G2 T3 (N4 never occurs: random codes, no gaps)
A, C, G, T = 0, 1, 2, 3
EDGE = 2000          # introns and genes keep this far from a contig's ends


@dataclasses.dataclass
class Layout:
    """Contig names and their spans in the flat (global) coordinates."""

    names: list
    offsets: np.ndarray      # (contigs + 1,) int64

    @property
    def n(self) -> int:
        return int(self.offsets[-1])

    def start(self, name: str) -> int:
        return int(self.offsets[self.names.index(name)])

    def span(self, name: str):
        i = self.names.index(name)
        return int(self.offsets[i]), int(self.offsets[i + 1])

    def contig_of(self, pos) -> np.ndarray:
        return np.searchsorted(self.offsets, pos, side="right") - 1


def make_genome(contigs, seed: int):
    """(codes, Layout): contigs [[name, bases], ...] of int8 codes drawn
    uniformly from A, C, G, T in one call, concatenated in order."""
    names = [str(c[0]) for c in contigs]
    lens = np.array([int(c[1]) for c in contigs], np.int64)
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    codes = np.random.default_rng(seed).integers(0, 4, int(offsets[-1]),
                                                 dtype=np.int8)
    return codes, Layout(names, offsets)


def plant_repeats(codes, layout: Layout, rep: dict) -> int:
    """Copies of `families` random consensus sequences (lengths
    log-uniform in `length`) written over the genome in place: a share
    `share` of each contig's bases (`share_of` by name overrides it), each
    copy a full-length copy with probability `full`, else a fragment of at
    least `min_copy` bases, on either strand, with its own substitution
    rate drawn uniformly from `divergence`. Returns the bases written."""
    rng = np.random.default_rng(int(rep["seed"]))
    lo, hi = rep["length"]
    F = int(rep["families"])
    flen = np.exp(rng.uniform(np.log(lo), np.log(hi), F)).astype(np.int64)
    cons = rng.integers(0, 4, int(flen.sum())).astype(np.int8)
    cstart = np.concatenate([[0], np.cumsum(flen)[:-1]])
    dlo, dhi = rep["divergence"]
    written = 0
    for name in layout.names:
        a, b = layout.span(name)
        share = float(rep.get("share_of", {}).get(name, rep["share"]))
        want = int(share * (b - a))
        done = 0
        while done < want:
            f = int(rng.integers(F))
            n = int(flen[f])
            if rng.random() >= float(rep["full"]) and n > rep["min_copy"]:
                n = int(rng.integers(int(rep["min_copy"]), n + 1))
            if n >= b - a:
                break
            s = int(cstart[f]) + int(rng.integers(0, int(flen[f]) - n + 1))
            copy = cons[s:s + n].copy()
            k = int(rng.binomial(n, rng.uniform(dlo, dhi)))
            at = rng.integers(0, n, k)
            copy[at] = (copy[at] + rng.integers(1, 4, k)) % 4
            if rng.random() < 0.5:
                copy = (3 - copy)[::-1]
            p = a + int(rng.integers(0, b - a - n + 1))
            codes[p:p + n] = copy
            done += n
        written += done
    return written


def motifs(codes, pairs) -> list:
    """For each (a, b) of `pairs` the sorted positions i with codes[i],
    codes[i + 1] == a, b, in one scan."""
    v = (codes[:-1] << 2) | codes[1:]
    want = [4 * a + b for a, b in pairs]
    lut = np.zeros(16, bool)
    lut[want] = True
    at = np.nonzero(lut[v])[0]
    va = v[at]
    return [at[va == w] for w in want]


def splice_sites(codes) -> tuple:
    """The sorted positions of GT, AG, CT and AC."""
    return tuple(motifs(codes, [(G, T), (A, G), (C, T), (A, C)]))


def pick_introns(codes, layout: Layout, count: int, seed: int, sites):
    """`count` naturally occurring GT..AG introns, each from a GT to the
    first AG at least 100 bases on (100-5,000 bp; on random sequence
    mostly under 130), the genome not mutated, each inside one contig at
    least EDGE bases
    from its ends, as (left, right): the last exonic base before the
    intron and the first exonic base after it. `sites`: splice_sites."""
    rng = np.random.default_rng(seed)
    gt = sites[0]
    introns = []
    for s in rng.choice(len(gt) - 1, 4 * count, replace=False):
        d = int(gt[s])                        # intron starts at d
        a, b = layout.span(layout.names[int(layout.contig_of(d))])
        if d - EDGE < a or d + 5002 + EDGE >= b:
            continue
        win = codes[d + 100: d + 5000]
        ag = np.nonzero((win[:-1] == A) & (win[1:] == G))[0]
        if len(ag) == 0:
            continue
        introns.append((d - 1, d + 100 + int(ag[0]) + 2))
        if len(introns) == count:
            break
    return introns


class Pool:
    """Draws made in bulk (draw(n) -> array) and handed out one at a
    time."""

    def __init__(self, draw, n: int = 1 << 16):
        self.draw, self.n = draw, n
        self.buf, self.i = draw(n), 0

    def __call__(self):
        if self.i == len(self.buf):
            self.buf, self.i = self.draw(self.n), 0
        self.i += 1
        return self.buf[self.i - 1]


def intron_lengths(rng, law: dict, n: int) -> np.ndarray:
    """n intron lengths: each with probability `short_share` from the
    short mode N(short_mean, short_sd), else log-uniform over `long`."""
    lo, hi = law["long"]
    short = np.rint(rng.normal(law["short_mean"], law["short_sd"], n))
    long_ = np.exp(rng.uniform(np.log(lo), np.log(hi), n))
    return np.where(rng.random(n) < float(law["short_share"]), short,
                    long_).astype(np.int64)


def exon_chain(u, lengths, starts, ends, s: int, k: int, a: dict,
               limit: int):
    """k exons from base s, ending before `limit`: the first and last of
    `end_exon_len` bases, the others of `exon_len`, joined by introns of
    lengths from the pool `lengths` at the sorted intron-start and
    intron-end motif positions `starts` and `ends` (the intron end nearest
    the drawn length, at least `min_intron` long); `u` a pool of uniform
    draws. [(start, end), ...] 0-based, end exclusive; None where the
    motifs or the contig run out."""
    exons = []
    least = int(a["intron_len"]["min_intron"])
    for i in range(k - 1):
        lo, hi = a["end_exon_len"] if i == 0 else a["exon_len"]
        j0 = int(starts.searchsorted(s + lo))
        j1 = int(starts.searchsorted(s + hi + 1))
        if j1 <= j0:
            return None
        d = int(starts[j0 + int(u() * (j1 - j0))])
        want = d + max(int(lengths()), least) - 2
        j = int(ends.searchsorted(want))
        if j > 0 and (j == len(ends) or want - ends[j - 1] < ends[j] - want) \
                and ends[j - 1] + 2 - d >= least:
            j -= 1
        if j >= len(ends) or ends[j] + 2 >= limit:
            return None
        exons.append((s, d))
        s = int(ends[j]) + 2
    lo, hi = a["end_exon_len"] if k > 1 else a["exon_len"]
    e = s + lo + int(u() * (hi - lo + 1))
    if e >= limit:
        return None
    exons.append((s, e))
    return exons


def isoforms_of(u, exons, n: int):
    """Up to n distinct isoforms of a gene: every exon; one internal exon
    skipped; the first exon dropped; a second internal exon skipped."""
    k = len(exons)
    out = [exons]
    skip = 1 + int(u() * (k - 2)) if k >= 3 else None
    if skip is not None:
        out.append(exons[:skip] + exons[skip + 1:])
    if k >= 2:
        out.append(exons[1:])
    if k >= 4:
        other = [j for j in range(1, k - 1) if j != skip]
        j2 = other[int(u() * len(other))]
        out.append(exons[:j2] + exons[j2 + 1:])
    return out[:n]


def make_annotation(codes, layout: Layout, avoid, a: dict, sites):
    """A synthetic GTF: `a["genes"]` genes on the contigs `a["contigs"]`,
    each placed at a uniform start (by contig length), so genes may
    overlap; a random strand; exons uniform in `a["exons"]`; introns at
    natural GT..AG (CT..AC on the forward strand for '-' genes); 1, 2 or 3
    isoforms with the probabilities `a["isoforms"]` (isoforms_of). No
    intron equals one of `avoid`. Returns (GTF text, transcripts
    [[(start, end), ...] global 0-based end-exclusive, ...], the distinct
    introns as global (left, right)). `sites`: splice_sites."""
    rng = np.random.default_rng(int(a["seed"]))
    u = Pool(rng.random)
    lengths = Pool(lambda n: intron_lengths(rng, a["intron_len"], n))
    gt, ag, ct, ac = sites
    by_strand = {"+": (gt, ag), "-": (ct, ac)}
    avoid = set(avoid)
    names = list(a["contigs"])
    spans = np.array([layout.span(n) for n in names], np.int64)
    size = spans[:, 1] - spans[:, 0]
    cum = np.cumsum(size) / size.sum()
    kmin, kmax = a["exons"]
    cum_iso = np.cumsum(np.asarray(a["isoforms"], float))
    lines, transcripts, introns = [], [], set()
    gi = tries = 0
    while gi < int(a["genes"]):
        tries += 1
        if tries > 20 * int(a["genes"]):
            raise ValueError(f"placed only {gi} of {a['genes']} genes")
        c = min(int(cum.searchsorted(u())), len(names) - 1)
        lo, hi = int(spans[c, 0]) + EDGE, int(spans[c, 1]) - EDGE
        strand = "+" if u() < 0.5 else "-"
        k = kmin + int(u() * (kmax - kmin + 1))
        exons = exon_chain(u, lengths, *by_strand[strand],
                           lo + int(u() * (hi - lo)), k, a, hi)
        if exons is None:
            continue
        n_iso = min(int(cum_iso.searchsorted(u())), len(cum_iso) - 1) + 1
        isoforms = isoforms_of(u, exons, n_iso)
        gene_introns = {(e1 - 1, s2) for ex in isoforms
                        for (_, e1), (s2, _) in zip(ex, ex[1:])}
        if gene_introns & avoid:
            continue
        introns |= gene_introns
        off = int(spans[c, 0])
        for ti, ex in enumerate(isoforms):
            tid = f"g{gi}.{ti + 1}"
            lines += [f'{names[c]}\tbench\texon\t{s - off + 1}\t{e - off}\t.'
                      f'\t{strand}\t.\tgene_id "g{gi}"; transcript_id '
                      f'"{tid}";\n' for s, e in ex]
            transcripts.append(ex)
        gi += 1
    return "".join(lines), transcripts, introns
