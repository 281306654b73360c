# Port of tophat_tpu/pipeline/coverage.py (host code): the same events,
# found from the hits' intervals without genome-wide passes.
"""Coverage search: junctions from island-end pairing.

Reference: segment_juncs.cpp capture_island_ends (:4268) + pair_covered_sites
(:4178) + RecordExtendableJuncs (:1570). Segment-hit coverage forms boolean
islands; island edges spawn LOOK_LEFT/LOOK_RIGHT windows (extend=45,
repeat_tol=5, min island length 20) scanned for splice dinucleotides, and
donor/acceptor sites pair within [min_coverage_intron, max_coverage_intron).

Candidate pairs are gated by the mer-extension "extendable junction" check
(segment_juncs.cpp:1520, via RecordExtendableJuncs :1570): a junction is
admitted only when its exon-side 10-mer occurs in an IUM read with a >= 7bp
exact extension into the reference on either side — the same table and
batched check the butterfly search uses (pipeline/butterfly.py). This keeps
the candidate event table (which every read realigns against) from
inflating on noisy genomes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from tophat_tpu_torch.index.fm import host_codes
from tophat_tpu_torch.ops.events import MAX_INS
from tophat_tpu_torch.ops.splice import KIND_JUNCTION
from tophat_tpu_torch.pipeline.butterfly import (ExtendChecker,
                                                 forward_mer_table,
                                                 site_pairs)
from tophat_tpu_torch.pipeline.juncs import empty_events
from tophat_tpu_torch.utils import trace

EXTEND = 45          # reference: segment_juncs.cpp:4349
REPEAT_TOL = 5       # :4350
MIN_COV_LENGTH = 20  # :62
MAX_COV_EVENTS = 65536


def _positive_runs(lo, hi, n):
    """Sorted, disjoint [start, end) runs of the bases of [0, n) where the
    intervals [lo, hi), both ends clipped to [0, n), overlap positively:
    np.cumsum of their +1/-1 difference array > 0, computed from the
    interval ends alone (no pass over the n bases)."""
    lo = np.clip(np.asarray(lo, np.int64), 0, n)
    hi = np.clip(np.asarray(hi, np.int64), 0, n)
    pts = np.concatenate([lo, hi])
    step = np.concatenate([np.ones(len(lo), np.int64),
                           np.full(len(hi), -1, np.int64)])
    inside = pts < n            # a step at n falls outside the genome
    pts, step = pts[inside], step[inside]
    if pts.size == 0:
        z = np.zeros(0, np.int64)
        return z, z.copy()
    at, which = np.unique(pts, return_inverse=True)
    level = np.cumsum(np.bincount(which, weights=step,
                                  minlength=len(at)).astype(np.int64)) > 0
    ends = np.append(at[1:], n)     # level k holds on [at[k], ends[k])
    before = np.concatenate([[False], level[:-1]])
    after = np.concatenate([level[1:], [False]])
    return at[level & ~before], ends[level & ~after]


def _run_positions(starts, ends, n):
    """Every position of the runs [starts, ends), clipped to [0, n), in
    order (runs sorted and disjoint)."""
    ends = np.minimum(ends, n)
    lens = np.maximum(ends - starts, 0)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    first = np.cumsum(lens) - lens
    return (np.repeat(starts - first, lens)
            + np.arange(total, dtype=np.int64))


def _motif_sites(g, starts, ends, n, a: int, b: int):
    """Positions p in the runs, p < n - 1, with g[p], g[p + 1] == a, b."""
    p = _run_positions(starts, ends, n - 1)
    return p[(g[p] == a) & (g[p + 1] == b)]


@trace.span("coverage_search", sync=True)
def coverage_search_events(fm, genome, gs, seg_tables,
                           params) -> Dict[str, np.ndarray]:
    """The JAX package's coverage_search_events, element for element, in
    O(hits + window bases): islands, look windows and dinucleotide sites
    come from the segment hits' intervals, where the reference paints
    every base of the genome (diff/cumsum masks)."""
    n = fm.n
    seg_pos, seg_mm, seg_valid = (trace.to_host(x) for x in seg_tables)
    seg_len = (gs.cuts[:, 1:] - gs.cuts[:, :-1])  # (rows, S)

    valid = seg_valid
    starts = seg_pos[valid]
    lens = np.broadcast_to(seg_len[:, :, None], seg_pos.shape)[valid]
    if starts.size == 0:
        return empty_events()

    # islands of length >= MIN_COV_LENGTH
    rises, falls = _positive_runs(starts, starts + lens, n)
    keep = (falls - rises) >= MIN_COV_LENGTH
    rises, falls = rises[keep], falls[keep]
    trace.count("coverage.islands", rises.size)
    if rises.size == 0:
        return empty_events()

    # look-left windows around island starts, look-right around ends
    left_runs = _positive_runs(rises - EXTEND, rises + REPEAT_TOL, n)
    right_runs = _positive_runs(falls - REPEAT_TOL, falls + EXTEND, n)

    g = host_codes(fm)
    fwd_donors = _motif_sites(g, *right_runs, n, 2, 3)      # GT
    fwd_acceptors = _motif_sites(g, *left_runs, n, 0, 2)    # AG
    rev_acceptors = _motif_sites(g, *right_runs, n, 1, 3)   # CT
    rev_donors = _motif_sites(g, *left_runs, n, 0, 1)       # AC

    offsets = genome.offsets

    # mer-extension table over the IUM reads' forward rows (the butterfly
    # machinery's index_read_mers; extendable_junction :1520)
    check = ExtendChecker(g, forward_mer_table(gs))
    trace.count("coverage.mers", check.table.size)

    def pair(left_sites, right_sites, antisense):
        """RecordExtendableJuncs pairing: right in [left+min, left+max),
        both sites on one contig, each admitted pair mer-extendable."""
        ls, rs = site_pairs(left_sites, right_sites,
                            params.min_coverage_intron,
                            params.max_coverage_intron)
        same = (np.searchsorted(offsets, ls, "right")
                == np.searchsorted(offsets, rs, "right"))
        ls, rs = ls[same], rs[same]
        ext = check.check(ls - 1, rs + 2)
        trace.count("coverage.pairs", ls.size)
        trace.count("coverage.extendable", int(ext.sum()))
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
