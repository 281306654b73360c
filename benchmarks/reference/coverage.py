"""The plain reference for the coverage search.

TopHat's coverage search (segment_juncs.cpp) written the straightforward
way, from the genome's codes, the segment hits of one call and the reads
that no contiguous alignment placed (IUM reads). It imports nothing of the
port.

  islands     paint coverage over every base from the segment hits
              (capture_island_ends :4268), keep runs of >= 20 covered
              bases (min_cov_length :62)
  windows     look-left windows [start - 45, start + 5) around each
              island's start, look-right windows [end - 5, end + 45)
              around its end (extend 45, repeat tolerance 5 :4349-4350)
  sites       GT donors and CT (antisense acceptors) in the look-right
              windows, AG acceptors and AC (antisense donors) in the
              look-left windows: a site is the position of the
              dinucleotide's first base
  pairing     per contig, each left site (GT, or CT) with the right sites
              (AG, or AC) in [left + min_intron, left + max_intron)
              (pair_covered_sites :4178); the junction's ends are
              left - 1 and right + 2
  gate        a pair is kept when its 10-mer (the 5 bases ending at the
              junction's left end, the 5 from its right end), in either
              orientation, is a 10-mer of an IUM read whose read bases
              before it (up to 14) or after it (up to 14) are at least 7
              long and equal, all valid, to the genome's bases beside the
              junction (extendable_junction :1520, RecordExtendableJuncs
              :1570, extension_mismatches 0): a per-10-mer dict over the
              reads' forward rows and a scalar walk of its entries

Departures from segment_juncs.cpp, each the port's (the JAX package's)
design, kept here so that the reference decides the same events:
  * the contigs lie end to end as one array of codes, as in the port's
    index, so an island, a window or a dinucleotide may run across a
    contig's end; TopHat paints each reference sequence apart. Pairs are
    made within one contig (the left and right sites' first bases) all
    the same.
  * at most MAX_PAIRS_PER_SITE (16) right sites a left site, the nearest;
    TopHat pairs every one.
  * the forward pairs (GT..AG) come first, then the antisense ones
    (CT..AC), each left site by left site and right sites ascending, and
    the list is cut after MAX_COV_EVENTS (65,536) events; TopHat's cap,
    max_cov_juncs, is 5,000,000.
  * the search runs over the hits and reads of one call (one chunk of
    one mate); TopHat's segment_juncs sees every mapping of a sample.
"""

from __future__ import annotations

import bisect

import numpy as np

EXTEND = 45
REPEAT_TOL = 5
MIN_COV_LENGTH = 20
HALF_MER = 5
MER = 2 * HALF_MER
MAX_EXT = 14
MIN_EXT = 7
MAX_PAIRS_PER_SITE = 16
MAX_COV_EVENTS = 65536

GT, AG, CT, AC = (2, 3), (0, 2), (1, 3), (0, 1)


def paint(n: int, lo, hi) -> np.ndarray:
    """Boolean mask of the bases of [0, n) that some [lo, hi) covers."""
    diff = np.zeros(n + 1, np.int32)
    np.add.at(diff, np.clip(np.asarray(lo, np.int64), 0, n), 1)
    np.add.at(diff, np.clip(np.asarray(hi, np.int64), 0, n), -1)
    return np.cumsum(diff[:-1]) > 0


def runs(mask: np.ndarray):
    """[start, end) of every run of True in mask."""
    c = mask.astype(np.int8)
    starts = np.nonzero(np.diff(np.concatenate([[0], c])) == 1)[0]
    ends = np.nonzero(np.diff(np.concatenate([c, [0]])) == -1)[0] + 1
    return starts, ends


def sites(codes: np.ndarray, window: np.ndarray, motif) -> np.ndarray:
    """Positions p < n - 1 in the window with codes p, p + 1 == motif."""
    a, b = motif
    p = np.arange(len(codes) - 1)
    return p[window[:-1] & (codes[:-1] == a) & (codes[1:] == b)]


def valid(x) -> bool:
    return bool(((x >= 0) & (x < 4)).all())


def revcomp(x: np.ndarray) -> np.ndarray:
    return np.where((x >= 0) & (x < 4), 3 - x, x)[::-1]


def mer_key(mer: np.ndarray) -> int:
    key = 0
    for c in mer:
        key = 4 * key + int(c)
    return key


def mer_table(rows) -> dict:
    """10-mer -> [(the read bases before it, the read bases after it), ...]
    over every 10-mer of valid codes of every row (index_read_mers,
    store_read_extensions :241): up to 14 bases each side."""
    table = {}
    for row in rows:
        row = np.asarray(row, np.int8)
        for i in range(len(row) - MER + 1):
            mer = row[i:i + MER]
            if valid(mer):
                table.setdefault(mer_key(mer), []).append(
                    (row[max(0, i - MAX_EXT):i],
                     row[i + MER:i + MER + MAX_EXT]))
    return table


def matches(ext: np.ndarray, ref: np.ndarray, at_end: bool) -> bool:
    """An extension of >= MIN_EXT bases equal to the reference's bases
    beside the 10-mer (its last bases when at_end, else its first), all
    valid."""
    k = len(ext)
    if k < MIN_EXT or len(ref) < k:
        return False
    r = ref[len(ref) - k:] if at_end else ref[:k]
    return valid(r) and bool((ext == r).all())


def extendable(codes: np.ndarray, table: dict, left: int,
               right: int) -> bool:
    """extendable_junction: the junction (left, right) read in either
    orientation."""
    n = len(codes)
    if left - 4 < 0 or right + 5 > n:
        return False
    mer = np.concatenate([codes[left - 4:left + 1], codes[right:right + 5]])
    up = codes[max(0, left - 4 - MAX_EXT):left - 4]
    down = codes[right + 5:right + 5 + MAX_EXT]
    for m, before, after in ((mer, up, down),
                             (revcomp(mer), revcomp(down), revcomp(up))):
        if not valid(m):
            continue
        for ext_l, ext_r in table.get(mer_key(m), ()):
            if matches(ext_l, before, True) or matches(ext_r, after, False):
                return True
    return False


def call_inputs(readsg, lengths, strand, cuts, seg_pos, seg_valid):
    """(hit starts, hit lengths, forward rows) of one call from its plain
    arrays: the genome-space rows (codes, -1 padded; lengths; strand, 0
    forward; segment boundaries, one row of S + 1 a row) and the segment
    hit tables (positions and validity, (rows, S, hits))."""
    seg_pos, seg_valid = np.asarray(seg_pos), np.asarray(seg_valid, bool)
    seg_len = np.diff(np.asarray(cuts, np.int64), axis=1)
    lens = np.broadcast_to(seg_len[:, :, None], seg_pos.shape)
    rows = [np.asarray(readsg[i, :int(lengths[i])])
            for i in range(len(lengths)) if int(strand[i]) == 0]
    return seg_pos[seg_valid], lens[seg_valid], rows


def coverage_events(codes, offsets, hit_starts, hit_lens, rows,
                    min_intron: int, max_intron: int,
                    max_events: int = MAX_COV_EVENTS):
    """The coverage search's junctions: (left, right, antisense) arrays,
    forward pairs first, cut after max_events.

    codes: the genome (contigs end to end); offsets: each contig's first
    position and the genome's length; hit_starts, hit_lens: every segment
    hit of the call; rows: the code arrays of the IUM reads' forward
    rows; min_intron, max_intron: the coverage intron range."""
    codes = np.asarray(codes)
    offsets = np.asarray(offsets, np.int64)
    n = len(codes)
    hit_starts = np.asarray(hit_starts, np.int64)
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64),
             np.zeros(0, bool))
    if hit_starts.size == 0:
        return empty
    rises, falls = runs(paint(n, hit_starts,
                              hit_starts + np.asarray(hit_lens, np.int64)))
    keep = falls - rises >= MIN_COV_LENGTH
    rises, falls = rises[keep], falls[keep]
    if rises.size == 0:
        return empty
    look_left = paint(n, rises - EXTEND, rises + REPEAT_TOL)
    look_right = paint(n, falls - REPEAT_TOL, falls + EXTEND)
    table = mer_table(rows)

    def pair(lefts, rights, antisense):
        out = []
        for lo, hi in zip(offsets[:-1], offsets[1:]):
            # the contig's sites (both lists ascending)
            ls = lefts[np.searchsorted(lefts, lo):np.searchsorted(lefts, hi)]
            rs = rights[np.searchsorted(rights, lo):
                        np.searchsorted(rights, hi)].tolist()
            for s in ls.tolist():
                j = bisect.bisect_left(rs, s + min_intron)
                for r in rs[j:j + MAX_PAIRS_PER_SITE]:
                    if r >= s + max_intron:
                        break
                    if extendable(codes, table, s - 1, r + 2):
                        out.append((s - 1, r + 2, antisense))
        return out

    found = (pair(sites(codes, look_right, GT), sites(codes, look_left, AG),
                  False)
             + pair(sites(codes, look_right, CT),
                    sites(codes, look_left, AC), True))[:max_events]
    if not found:
        return empty
    left, right, anti = zip(*found)
    return (np.array(left, np.int64), np.array(right, np.int64),
            np.array(anti, bool))
