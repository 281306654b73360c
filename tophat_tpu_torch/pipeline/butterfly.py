# Port of tophat_tpu/pipeline/butterfly.py (host code): the same events,
# with the mer-extension table as one sorted array and its check batched.
"""Butterfly and microexon junction searches.

The reference's two remaining discovery strategies (segment_juncs.cpp):

* **butterfly search** (`pair_covered_sites` :4178, opt-in via
  --butterfly-search): pair GT/AG motif sites across whole coverage-island
  spans (not just island ends), gated by the *mer-extension* check — the
  10 bp of exonic sequence spanning the candidate junction must occur in
  some unmapped read, and that read must extend >= 7 bp into the reference
  on at least one side (`extendable_junction` :1520, half_splice_mer_len=5,
  extension_mismatches=0 :4998-5009).
* **microexon search** (`align_microexon_segs` :3737, opt-in via
  --microexon-search): for reads whose edge segment is unmapped while all
  other segments mapped, scan a max_microexon_stretch=2000 bp window
  beyond the innermost mapped hit (:3880-3941) for GT/AG pairs extendable
  by the unmapped edge segment itself.

Both re-use the same extension-table machinery, which the coverage search
shares too: one sorted int64 array of (10-mer, side, length, extension)
entries, checked for arrays of candidate pairs at once; candidate events
feed the shared realignment/event pipeline, which replaces the
reference's seed-and-extend hit synthesis.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from tophat_tpu_torch.index.fasta import COMP
from tophat_tpu_torch.index.fm import host_codes
from tophat_tpu_torch.ops.events import MAX_INS
from tophat_tpu_torch.ops.splice import KIND_JUNCTION
from tophat_tpu_torch.pipeline.juncs import empty_events
from tophat_tpu_torch.utils import trace

HALF_MER = 5          # half_splice_mer_len (driver :5009, :5025)
MER = 2 * HALF_MER
MAX_EXT = 14          # MerExtension::MAX_EXTENSION_BP (:148)
MIN_EXT = 7           # RecordExtendableJuncs (:1606-1612)
MAX_STRETCH = 2000    # max_microexon_stretch (:60)
EXTEND = 45           # island extension (:4189)
MIN_COV_LENGTH = 20
MAX_EVENTS = 65536
MAX_PAIRS_PER_SITE = 16

_POW4 = (4 ** np.arange(MER - 1, -1, -1)).astype(np.int64)
_POW4_EXT = (4 ** np.arange(MAX_EXT - 1, -1, -1)).astype(np.int64)

# One extension-table entry is an int64: the 10-mer's key (20 bits), the
# side (0: the read bases before the 10-mer, 1: after it), the
# extension's length (4 bits) and its bases, 2 bits each, first base
# highest.
_EXT_BITS = 2 * MAX_EXT
_LEN_BITS = 4
_CHECK_BLOCK = 1 << 16   # pairs a step of ExtendChecker.check


def _entry(key, side, length, ext):
    return ((((key << 1) | side) << _LEN_BITS | length) << _EXT_BITS) | ext


def _valid(codes):
    return (codes >= 0) & (codes < 4)


def pad_rows(rows: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Code arrays as one (rows, L) int8 matrix, -1 padded, and lengths."""
    lengths = np.array([len(r) for r in rows], np.int64)
    mat = np.full((len(rows), int(lengths.max(initial=0))), -1, np.int8)
    for i, r in enumerate(rows):
        mat[i, :len(r)] = r
    return mat, lengths


def build_mer_table(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """The mer-extension table of the rows codes[i, :lengths[i]]
    (store_read_extensions :241): for every 10-mer of valid codes, its
    left extension (the up-to-14 read bases before it) and its right one
    (the up-to-14 after it), each kept when it is at least MIN_EXT long
    and all its codes are valid (no shorter or invalid extension can ever
    match the reference), as sorted unique `_entry` values."""
    lengths = np.asarray(lengths, np.int64)
    held = lengths >= MER
    lengths = lengths[held]
    if lengths.size == 0:
        return np.zeros(0, np.int64)
    width = int(lengths.max())
    codes = np.asarray(codes, np.int8)[held, :width]
    rows = lengths.size
    # a base outside its row counts as invalid
    ok = _valid(codes) & (np.arange(width)[None, :] < lengths[:, None])
    # bad[r, p]: invalid codes among the row's first p
    bad = np.zeros((rows, width + 1), np.int32)
    np.cumsum(~ok, axis=1, out=bad[:, 1:])
    n_at = width - MER + 1
    r, i = np.nonzero(bad[:, MER:] == bad[:, :n_at])
    if r.size == 0:
        return np.zeros(0, np.int64)
    # codes of valid bases, 0 elsewhere, with MAX_EXT columns either side
    z = np.zeros((rows, width + 2 * MAX_EXT), np.int32)
    z[:, MAX_EXT:MAX_EXT + width] = np.where(ok, codes, 0)

    def packed(first, span):
        """Column i: the `span` bases of z from column first + i on, 2 bits
        each, first base highest (28 bits at most)."""
        acc = np.zeros((rows, n_at), np.int32)
        for j in range(first, first + span):
            acc <<= 2
            acc |= z[:, j:j + n_at]
        return acc[r, i].astype(np.int64)

    key = packed(MAX_EXT, MER)
    kl = np.minimum(i, MAX_EXT)
    left = packed(0, MAX_EXT)       # the 14 columns before the 10-mer
    keep_l = (kl >= MIN_EXT) & (bad[r, i] == bad[r, i - kl])
    kr = np.minimum(lengths[r] - i - MER, MAX_EXT)
    # the 14 columns after it, shifted down to the extension's own bases
    right = packed(MAX_EXT + MER, MAX_EXT) >> (2 * (MAX_EXT - kr))
    keep_r = (kr >= MIN_EXT) & (bad[r, i + MER + kr] == bad[r, i + MER])
    return np.unique(np.concatenate([
        _entry(key[keep_l], 0, kl[keep_l], left[keep_l]),
        _entry(key[keep_r], 1, kr[keep_r], right[keep_r])]))


class ExtendChecker:
    """extendable_junction (:1520): is the candidate junction's exon-side
    10-mer present in a read with a >=7bp exact extension into the
    reference on either side, in either orientation? `check` answers for
    arrays of (left, right) pairs: a pair's 10-mer finds the (side,
    length) groups the table holds for it, at most 16, and each group is
    one sorted-table lookup of the reference's bases, so the cost of a
    pair does not depend on how many reads hold its 10-mer."""

    def __init__(self, genome_codes: np.ndarray, table: np.ndarray):
        self.g = np.asarray(genome_codes)
        self.table = table
        # the (key, side, length) groups of the entries, sorted
        self.groups = np.unique(table >> _EXT_BITS)

    def check(self, lefts, rights) -> np.ndarray:
        lefts = np.asarray(lefts, np.int64)
        rights = np.asarray(rights, np.int64)
        out = np.zeros(lefts.shape[0], bool)
        if self.table.size == 0:
            return out
        n = self.g.shape[0]
        live = np.nonzero((lefts >= 4) & (lefts < n) & (rights >= 0)
                          & (rights + 5 <= n))[0]
        for b in range(0, live.size, _CHECK_BLOCK):
            at = live[b:b + _CHECK_BLOCK]
            out[at] = self._check(lefts[at], rights[at])
        return out

    def _codes(self, pos):
        """Genome codes at pos, -1 off the genome."""
        n = self.g.shape[0]
        return np.where((pos >= 0) & (pos < n),
                        self.g[np.clip(pos, 0, n - 1)], -1)

    def _check(self, left, right):
        ext = np.arange(MAX_EXT)
        mer = self._codes(np.concatenate(
            [left[:, None] - 4 + np.arange(HALF_MER),
             right[:, None] + np.arange(HALF_MER)], axis=1))
        up = self._codes(left[:, None] - 4 - MAX_EXT + ext)
        down = self._codes(right[:, None] + 5 + ext)
        # revcomp(key), with the reference sides as extendable_junction
        # reads them in that orientation: revcomp(down), revcomp(up)
        return (self._orientation(mer, up, down)
                | self._orientation(COMP[mer][:, ::-1], COMP[down][:, ::-1],
                                    COMP[up][:, ::-1]))

    def _orientation(self, mer, up, down):
        """Extendable through a read extension that ends where `up` ends
        or starts where `down` starts."""
        hit = np.zeros(mer.shape[0], bool)
        valid = _valid(mer)
        key = np.where(valid, mer, 0) @ _POW4
        per_key = 1 << (_LEN_BITS + 1)
        lo = np.searchsorted(self.groups, key * per_key)
        cnt = np.where(valid.all(axis=1),
                       np.searchsorted(self.groups, (key + 1) * per_key)
                       - lo, 0)
        idx = np.nonzero(cnt)[0]
        if idx.size == 0:
            return hit
        lo, cnt = lo[idx], cnt[idx]
        up, down = up[idx], down[idx]
        vu, vd = _valid(up), _valid(down)
        # valid bases adjacent to the junction's 10-mer on each side, and
        # the reference's bases packed as the table packs an extension
        run = np.stack([np.cumprod(vu[:, ::-1], axis=1).sum(axis=1),
                        np.cumprod(vd, axis=1).sum(axis=1)])
        packed = np.stack([np.where(vu, up, 0) @ _POW4_EXT,
                           np.where(vd, down, 0) @ _POW4_EXT])
        # one lookup per group: the reference's last k bases before the
        # 10-mer (side 0) or its first k after it (side 1)
        first = np.cumsum(cnt) - cnt
        row = np.repeat(np.arange(idx.size), cnt)
        group = self.groups[np.repeat(lo - first, cnt)
                            + np.arange(int(cnt.sum()))]
        side, k = (group >> _LEN_BITS) & 1, group & ((1 << _LEN_BITS) - 1)
        bases = packed[side, row]
        bases = np.where(side == 0, bases & ((1 << 2 * k) - 1),
                         bases >> 2 * (MAX_EXT - k))
        q = (group << _EXT_BITS) | bases
        j = np.minimum(np.searchsorted(self.table, q), self.table.size - 1)
        found = (run[side, row] >= k) & (self.table[j] == q)
        hit[idx[row[found]]] = True
        return hit


def forward_mer_table(gs) -> np.ndarray:
    """The extension table over the IUM reads' forward rows
    (index_read_mers)."""
    fwd = gs.strand == 0
    return build_mer_table(gs.readsg[fwd], gs.lengths[fwd])


def site_pairs(left_sites, right_sites, min_gap, max_gap):
    """Every pair of a left site and a right site in [left + min_gap,
    left + max_gap), the first MAX_PAIRS_PER_SITE of each left site; left
    site by left site, right sites ascending."""
    lo = np.searchsorted(right_sites, left_sites + min_gap)
    hi = np.searchsorted(right_sites, left_sites + max_gap)
    cnt = np.maximum(np.minimum(hi, lo + MAX_PAIRS_PER_SITE) - lo, 0)
    first = np.cumsum(cnt) - cnt
    j = np.repeat(lo - first, cnt) + np.arange(int(cnt.sum()))
    return np.repeat(left_sites, cnt), right_sites[j]


def _paint(n, a, b):
    diff = np.zeros(n + 1, np.int32)
    np.add.at(diff, np.clip(a, 0, n), 1)
    np.add.at(diff, np.clip(b, 0, n), -1)
    return np.cumsum(diff[:-1]) > 0


def _motif_sites(g, mask):
    g1, g2 = g[:-1], g[1:]
    m = mask[:-1]
    pos = np.arange(g.shape[0] - 1)
    return (pos[m & (g1 == 2) & (g2 == 3)],    # GT donor
            pos[m & (g1 == 0) & (g2 == 2)],    # AG acceptor
            pos[m & (g1 == 1) & (g2 == 3)],    # CT (rev acceptor)
            pos[m & (g1 == 0) & (g2 == 1)])    # AC (rev donor)


def _pair_and_check(left_sites, right_sites, antisense, offsets, check,
                    min_intron, max_intron):
    """The (left, right) junction ends of the extendable site pairs, each
    pair's ends on one contig, and their antisense flags."""
    ls, rs = site_pairs(left_sites, right_sites, min_intron, max_intron)
    ls, rs = ls - 1, rs + 2
    same = (np.searchsorted(offsets, ls, "right")
            == np.searchsorted(offsets, rs, "right"))
    ls, rs = ls[same], rs[same]
    ok = check.check(ls, rs)
    return ls[ok], rs[ok], np.full(int(ok.sum()), antisense, bool)


def _events_from(ls, rs, anti):
    if not len(ls):
        return empty_events()
    left = np.asarray(ls, np.int32)[:MAX_EVENTS]
    right = np.asarray(rs, np.int32)[:MAX_EVENTS]
    a = np.asarray(anti, bool)[:MAX_EVENTS]
    k = len(left)
    return dict(left=left, right=right,
                kind=np.full(k, KIND_JUNCTION, np.int8), antisense=a,
                ins_len=np.zeros(k, np.int8),
                ins_seq=np.full((k, MAX_INS), -1, np.int8))


@trace.span("butterfly_search", sync=True)
def butterfly_search_events(fm, genome, gs, seg_tables, params):
    """Junctions between/within coverage islands, gated by read-mer
    extendability (pair_covered_sites :4178)."""
    n = fm.n
    seg_pos, _seg_mm, seg_valid = (trace.to_host(x) for x in seg_tables)
    seg_len = gs.cuts[:, 1:] - gs.cuts[:, :-1]
    starts = seg_pos[seg_valid]
    lens = np.broadcast_to(seg_len[:, :, None], seg_pos.shape)[seg_valid]
    if starts.size == 0:
        return empty_events()
    cov = _paint(n, starts, starts + lens)
    c = cov.astype(np.int8)
    rises = np.nonzero(np.diff(np.concatenate([[0], c])) == 1)[0]
    falls = np.nonzero(np.diff(np.concatenate([c, [0]])) == -1)[0] + 1
    keep = (falls - rises) >= MIN_COV_LENGTH
    rises, falls = rises[keep], falls[keep]
    if rises.size == 0:
        return empty_events()
    window = _paint(n, rises - EXTEND, falls + EXTEND)

    g = host_codes(fm)
    check = ExtendChecker(g, forward_mer_table(gs))
    fd, fa, ra, rd = _motif_sites(g, window)
    offsets = genome.offsets
    found = [_pair_and_check(ls, rs, anti, offsets, check,
                             params.min_coverage_intron,
                             params.max_coverage_intron)
             for ls, rs, anti in ((fd, fa, False), (ra, rd, True))]
    return _events_from(*(np.concatenate(x) for x in zip(*found)))


@trace.span("microexon_search", sync=True)
def microexon_events(fm, genome, gs, seg_tables, params):
    """Junctions reachable only through an unmapped edge segment
    (align_microexon_segs :3737 + window collection :3880-3941)."""
    if gs.rows == 0 or seg_tables is None:
        return empty_events()
    seg_pos, _seg_mm, seg_valid = (trace.to_host(x) for x in seg_tables)
    seg_len = gs.cuts[:, 1:] - gs.cuts[:, :-1]
    n = fm.n
    ma = params.min_anchor_len

    # windows: (lo, hi) genomic span; queries: unmapped edge segments
    spans: List[Tuple[int, int, np.ndarray]] = []
    for row in range(gs.rows):
        nseg = int(gs.nseg[row])
        if nseg < 2:
            continue
        has = [bool(seg_valid[row, j].any()) for j in range(nseg)]
        first_missing = not has[0] and all(has[1:])
        last_missing = not has[-1] and all(has[:-1])
        if not (first_missing or last_missing):
            continue
        if first_missing:
            q = gs.readsg[row, int(gs.cuts[row, 0]):int(gs.cuts[row, 1])]
            for h in np.nonzero(seg_valid[row, 1])[0]:
                hi = min(n - 2, int(seg_pos[row, 1, h]) + ma)
                lo = max(0, hi - MAX_STRETCH)
                if hi - lo >= MER:
                    spans.append((lo, hi, q))
        else:
            q = gs.readsg[row, int(gs.cuts[row, nseg - 1]):
                          int(gs.cuts[row, nseg])]
            for h in np.nonzero(seg_valid[row, nseg - 2])[0]:
                end = (int(seg_pos[row, nseg - 2, h])
                       + int(seg_len[row, nseg - 2]))
                lo = max(0, end - ma)
                hi = min(n - 2, lo + MAX_STRETCH)
                if hi - lo >= MER:
                    spans.append((lo, hi, q))
    if not spans:
        return empty_events()

    # merge overlapping windows, pooling their query segments
    # (add_to_microexon_windows :3672)
    spans.sort(key=lambda s: (s[0], s[1]))
    merged: List[List] = []
    for lo, hi, q in spans:
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
            merged[-1][2].append(q)
        else:
            merged.append([lo, hi, [q]])

    g = host_codes(fm)
    offsets = genome.offsets
    found = []
    for lo, hi, queries in merged:
        check = ExtendChecker(g, build_mer_table(*pad_rows(queries)))
        mask = np.zeros(n, bool)
        mask[lo:hi] = True
        fd, fa, ra, rd = _motif_sites(g, mask)
        found += [_pair_and_check(ls, rs, anti, offsets, check,
                                  params.min_coverage_intron, MAX_STRETCH)
                  for ls, rs, anti in ((fd, fa, False), (ra, rd, True))]
    return _events_from(*(np.concatenate(x) for x in zip(*found)))
