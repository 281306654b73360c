# Copy of tophat_tpu/pipeline/coverage.py (host code), imports rewritten.
"""Coverage search: junctions from island-end pairing.

Reference: segment_juncs.cpp capture_island_ends (:4268) + pair_covered_sites
(:4178) + RecordExtendableJuncs (:1570). Segment-hit coverage forms boolean
islands; island edges spawn LOOK_LEFT/LOOK_RIGHT windows (extend=45,
repeat_tol=5, min island length 20) scanned for splice dinucleotides, and
donor/acceptor sites pair within [min_coverage_intron, max_coverage_intron).

Candidate pairs are gated by the mer-extension "extendable junction" check
(segment_juncs.cpp:1520, via RecordExtendableJuncs :1570): a junction is
admitted only when its exon-side 10-mer occurs in an IUM read with a >= 7bp
exact extension into the reference on either side — the same table the
butterfly search uses (pipeline/butterfly.py). This keeps the candidate
event table (which every read realigns against) from inflating on noisy
genomes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from tophat_tpu_torch.index.fm import host_codes
from tophat_tpu_torch.ops.events import MAX_INS
from tophat_tpu_torch.ops.splice import KIND_JUNCTION
from tophat_tpu_torch.pipeline.juncs import empty_events

EXTEND = 45          # reference: segment_juncs.cpp:4349
REPEAT_TOL = 5       # :4350
MIN_COV_LENGTH = 20  # :62
MAX_PAIRS_PER_SITE = 16
MAX_COV_EVENTS = 65536


def _paint(n, starts, lo_off, hi_off):
    """Boolean mask with [s+lo_off, s+hi_off) painted for every s."""
    diff = np.zeros(n + 1, np.int32)
    a = np.clip(starts + lo_off, 0, n)
    b = np.clip(starts + hi_off, 0, n)
    np.add.at(diff, a, 1)
    np.add.at(diff, b, -1)
    return np.cumsum(diff[:-1]) > 0


def coverage_search_events(fm, genome, gs, seg_tables,
                           params) -> Dict[str, np.ndarray]:
    n = fm.n
    seg_pos, seg_mm, seg_valid = (x.cpu().numpy() for x in seg_tables)
    seg_len = (gs.cuts[:, 1:] - gs.cuts[:, :-1])  # (rows, S)

    valid = seg_valid
    starts = seg_pos[valid]
    lens = np.broadcast_to(seg_len[:, :, None], seg_pos.shape)[valid]
    if starts.size == 0:
        return empty_events()

    diff = np.zeros(n + 1, np.int32)
    np.add.at(diff, np.clip(starts, 0, n), 1)
    np.add.at(diff, np.clip(starts + lens, 0, n), -1)
    cov = np.cumsum(diff[:-1]) > 0

    # islands of length >= MIN_COV_LENGTH
    c = cov.astype(np.int8)
    rises = np.nonzero(np.diff(np.concatenate([[0], c])) == 1)[0]
    falls = np.nonzero(np.diff(np.concatenate([c, [0]])) == -1)[0] + 1
    keep = (falls - rises) >= MIN_COV_LENGTH
    rises, falls = rises[keep], falls[keep]
    if rises.size == 0:
        return empty_events()

    look_left = _paint(n, rises, -EXTEND, REPEAT_TOL)    # island left edges
    look_right = _paint(n, falls, -REPEAT_TOL, EXTEND)   # island right edges

    g = host_codes(fm)
    g1 = g[:-1]
    g2 = g[1:]
    di_pos = np.arange(n - 1)
    lookL = look_left[:-1]
    lookR = look_right[:-1]

    fwd_donors = di_pos[lookR & (g1 == 2) & (g2 == 3)]      # GT
    fwd_acceptors = di_pos[lookL & (g1 == 0) & (g2 == 2)]   # AG
    rev_acceptors = di_pos[lookR & (g1 == 1) & (g2 == 3)]   # CT
    rev_donors = di_pos[lookL & (g1 == 0) & (g2 == 1)]      # AC

    offsets = genome.offsets

    # mer-extension table over the IUM reads' forward rows (the butterfly
    # machinery's index_read_mers; extendable_junction :1520)
    from tophat_tpu_torch.pipeline.butterfly import (ExtendChecker,
                                                     build_mer_table)

    fwd = [gs.readsg[i, :int(gs.lengths[i])]
           for i in range(gs.rows) if int(gs.strand[i]) == 0]
    check = ExtendChecker(g, build_mer_table(fwd))

    def pair(left_sites, right_sites, antisense):
        """RecordExtendableJuncs pairing: right in [left+min, left+max),
        each admitted pair mer-extendable."""
        if left_sites.size == 0 or right_sites.size == 0:
            return [], [], []
        lo = np.searchsorted(right_sites,
                             left_sites + params.min_coverage_intron)
        hi = np.searchsorted(right_sites,
                             left_sites + params.max_coverage_intron)
        hi = np.minimum(hi, lo + MAX_PAIRS_PER_SITE)
        ls, rs = [], []
        for i in range(len(left_sites)):
            for j in range(lo[i], hi[i]):
                ls.append(left_sites[i])
                rs.append(right_sites[j])
        ls = np.array(ls, np.int64)
        rs = np.array(rs, np.int64)
        if ls.size:
            same = (np.searchsorted(offsets, ls, "right")
                    == np.searchsorted(offsets, rs, "right"))
            ls, rs = ls[same], rs[same]
        if ls.size:
            ext = np.fromiter(
                (check(int(l), int(r)) for l, r in zip(ls - 1, rs + 2)),
                bool, count=len(ls))
            ls, rs = ls[ext], rs[ext]
        return (ls - 1, rs + 2, np.full(len(ls), antisense, bool))

    fl, fr, fa = pair(fwd_donors, fwd_acceptors, False)
    rl, rr, ra = pair(rev_acceptors, rev_donors, True)
    left = np.concatenate([fl, rl])[:MAX_COV_EVENTS].astype(np.int32)
    right = np.concatenate([fr, rr])[:MAX_COV_EVENTS].astype(np.int32)
    anti = np.concatenate([fa, ra])[:MAX_COV_EVENTS].astype(bool)

    return dict(left=left, right=right,
                kind=np.full(len(left), KIND_JUNCTION, np.int8),
                antisense=anti, ins_len=np.zeros(len(left), np.int8),
                ins_seq=np.full((len(left), MAX_INS), -1, np.int8))
