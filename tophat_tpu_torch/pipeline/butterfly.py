# Copy of tophat_tpu/pipeline/butterfly.py (host code), imports rewritten.
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

Both re-use the same extension-table machinery, re-expressed as a host
dict of 10-mer keys -> (left, right) read extensions; candidate events
feed the shared realignment/event pipeline, which replaces the
reference's seed-and-extend hit synthesis.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from tophat_tpu_torch.index.fm import host_codes

from tophat_tpu_torch.index.fasta import revcomp
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


def build_mer_table(rows: List[np.ndarray]) -> Dict[int, list]:
    """10-mer -> [(left_ext, right_ext)] over the given read code arrays
    (store_read_extensions :241 semantics: extensions are the up-to-14bp
    of read sequence flanking each 10-mer occurrence)."""
    table: Dict[int, list] = {}
    for row in rows:
        row = np.asarray(row, np.int8)
        l = row.shape[0]
        if l < MER:
            continue
        win = np.lib.stride_tricks.sliding_window_view(row, MER)
        ok = ((win >= 0) & (win < 4)).all(axis=1)
        keys = (win.astype(np.int64) * _POW4).sum(axis=1)
        for i in np.nonzero(ok)[0]:
            i = int(i)
            table.setdefault(int(keys[i]), []).append(
                (row[max(0, i - MAX_EXT):i], row[i + MER:i + MER + MAX_EXT]))
    return table


def _key_of(codes: np.ndarray) -> int:
    if codes.shape[0] != MER or ((codes < 0) | (codes >= 4)).any():
        return -1
    return int((codes.astype(np.int64) * _POW4).sum())


def _ext_match(ext: np.ndarray, ref: np.ndarray, from_right: bool) -> bool:
    """Exact match of a read extension against the adjacent reference
    sequence (left_/right_extendable_junction :1558-1601,
    extension_mismatches=0)."""
    k = ext.shape[0]
    if k < MIN_EXT:
        return False
    r = ref[-k:] if from_right else ref[:k]
    if r.shape[0] != k:
        return False
    return bool((ext == r).all() and (r >= 0).all() and (r < 4).all())


class ExtendChecker:
    """extendable_junction (:1520): is the candidate junction's exon-side
    10-mer present in a read with a >=7bp exact extension into the
    reference on either side, in either orientation?"""

    def __init__(self, genome_codes: np.ndarray, table: Dict[int, list]):
        self.g = genome_codes
        self.table = table

    def __call__(self, left: int, right: int) -> bool:
        g = self.g
        n = g.shape[0]
        if left - 4 < 0 or right + 5 > n:
            return False
        key_seq = np.concatenate([g[left - 4:left + 1],
                                  g[right:right + 5]])
        up = g[max(0, left - 4 - MAX_EXT):left - 4]
        down = g[right + 5:right + 5 + MAX_EXT]
        for ks, u, d in ((key_seq, up, down),
                         (revcomp(key_seq), revcomp(down), revcomp(up))):
            key = _key_of(ks)
            if key < 0:
                continue
            for le, ri in self.table.get(key, ()):
                if _ext_match(le, u, True) or _ext_match(ri, d, False):
                    return True
        return False


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
    ls_out, rs_out = [], []
    if left_sites.size and right_sites.size:
        lo = np.searchsorted(right_sites, left_sites + min_intron)
        hi = np.searchsorted(right_sites, left_sites + max_intron)
        hi = np.minimum(hi, lo + MAX_PAIRS_PER_SITE)
        for i in range(len(left_sites)):
            for j in range(int(lo[i]), int(hi[i])):
                l = int(left_sites[i]) - 1
                r = int(right_sites[j]) + 2
                if np.searchsorted(offsets, l, "right") \
                        != np.searchsorted(offsets, r, "right"):
                    continue
                if check(l, r):
                    ls_out.append(l)
                    rs_out.append(r)
    return ls_out, rs_out, [antisense] * len(ls_out)


def _events_from(ls, rs, anti):
    if not ls:
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

    # extension table over the IUM reads' forward rows (index_read_mers)
    fwd = [gs.readsg[i, :int(gs.lengths[i])]
           for i in range(gs.rows) if int(gs.strand[i]) == 0]
    check = ExtendChecker(host_codes(fm), build_mer_table(fwd))

    g = host_codes(fm)
    fd, fa, ra, rd = _motif_sites(g, window)
    offsets = genome.offsets
    fl, fr, fan = _pair_and_check(fd, fa, False, offsets, check,
                                  params.min_coverage_intron,
                                  params.max_coverage_intron)
    rl, rr, ran = _pair_and_check(ra, rd, True, offsets, check,
                                  params.min_coverage_intron,
                                  params.max_coverage_intron)
    return _events_from(fl + rl, fr + rr, fan + ran)


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
    ls, rs, an = [], [], []
    for lo, hi, queries in merged:
        check = ExtendChecker(g, build_mer_table(queries))
        mask = np.zeros(n, bool)
        mask[lo:hi] = True
        fd, fa, ra, rd = _motif_sites(g, mask)
        a, b, c = _pair_and_check(fd, fa, False, offsets, check,
                                  params.min_coverage_intron, MAX_STRETCH)
        ls += a
        rs += b
        an += c
        a, b, c = _pair_and_check(ra, rd, True, offsets, check,
                                  params.min_coverage_intron, MAX_STRETCH)
        ls += a
        rs += b
        an += c
    return _events_from(ls, rs, an)
