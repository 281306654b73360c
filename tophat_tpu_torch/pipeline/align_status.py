# Copy of tophat_tpu/pipeline/align_status.py (host code), imports rewritten.
"""AlignStatus v2 rescoring: bowtie2-style alignment scores with
coverage-scaled splice penalties (reference: src/align_status.cpp:37-250,
used by tophat_reports' read/pair_best_alignments in 2.1.2 mode).

Score model (bowtie2 defaults the reference driver passes,
src/tophat.py:2253-2339): each mismatch costs mp_max=6; each indel costs
gap open 5 + 3/base. Per junction crossed:
  - GTF junction: +2 (align_status.cpp:139)
  - unknown junction: -6 (bowtie2_max_penalty, :96)
  - known junction: penalty 8, scaled by min(avg_cov/supporting + extent
    penalty, 1) once support >= 5, where avg_cov is the mean read depth at
    the two exonic boundary bases and the extent penalty is 0.5 when
    either anchor extent < min(read_len/4, 10) (:100-117); gtf_match
    subtracts 6 (:124).

The depth query is sparse: only junction boundary bases are ever queried,
so coverage is two sorted arrays of M-block starts/ends and depth(q) =
#starts <= q minus #ends <= q — no dense genome-length array (the
reference's delta-encoded Coverage map role, src/coverage.cpp)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from tophat_tpu_torch.ops.splice import (KIND_DELETION, KIND_INSERTION,
                                   KIND_JUNCTION)

MP_MAX = 6      # bowtie2 mp max (reference common.cpp bowtie2_* defaults)
GAP_OPEN = 5
GAP_EXT = 3


def _m_blocks(c, rl: int):
    """Genome [start, end) intervals of a candidate's M runs."""
    blocks = []
    gp = c.pos
    for op, n in c.cigar(rl):
        if op == "M":
            blocks.append((gp, gp + n))
            gp += n
        elif op in ("D", "N"):
            gp += n
        # I/S consume read only
    return blocks


class SparseCoverage:
    """Depth at a position from sorted M-block boundaries (the
    Coverage.get_coverage role, src/coverage.h:27)."""

    def __init__(self, starts: np.ndarray, ends: np.ndarray):
        self.starts = np.sort(starts)
        self.ends = np.sort(ends)

    def depth(self, q: int) -> int:
        return int(np.searchsorted(self.starts, q, "right")
                   - np.searchsorted(self.ends, q, "right"))


def build_coverage(cands_lists: List[Dict[int, list]],
                   read_lens_list) -> SparseCoverage:
    """Coverage over every candidate alignment's M blocks (the reference
    accumulates pass-1 coverage from all hits, tophat_reports.cpp:1193)."""
    starts, ends = [], []
    for cands, read_lens in zip(cands_lists, read_lens_list):
        for r, clist in cands.items():
            rl = int(read_lens[r])
            for c in clist:
                for s, e in _m_blocks(c, rl):
                    starts.append(s)
                    ends.append(e)
    return SparseCoverage(np.array(starts, np.int64),
                          np.array(ends, np.int64))


def _junctions_of(c, events, rl: int):
    """(event_index, left, right) for each junction the candidate spans."""
    out = []
    if c.kind == KIND_JUNCTION:
        out.append((c.ev, int(events["left"][c.ev]),
                    int(events["right"][c.ev])))
    elif c.kind == -2:
        for op in c.chain_ops:
            if op[0] == "EV" and op[2] == KIND_JUNCTION:
                e = op[1]
                out.append((e, int(events["left"][e]),
                            int(events["right"][e])))
    return out


def v2_score(c, rl: int, events, stats, cov: SparseCoverage) -> float:
    """The AlignStatus alignment score of one candidate."""
    score = -MP_MAX * c.mm
    if c.kind in (KIND_DELETION, KIND_INSERTION):
        score -= GAP_OPEN + GAP_EXT * c.gap
    elif c.kind == -2:
        for op in c.chain_ops:
            if op[0] == "EV" and op[2] in (KIND_DELETION, KIND_INSERTION):
                score -= GAP_OPEN + GAP_EXT * op[3]
    min_extent = min(rl // 4, 10)
    for e, left, right in _junctions_of(c, events, rl):
        st = stats.get(e)
        if st is None or not st.accepted:
            score -= MP_MAX          # unknown junction (:96)
            continue
        if st.gtf_match and st.supporting == 0:
            score += 2               # pure GTF junction (:139)
            continue
        penalty = float(MP_MAX + 2)
        if st.supporting >= 5:
            avg_cov = (cov.depth(left) + cov.depth(right)) / 2.0
            extent_pen = (0.5 if (st.left_extent < min_extent
                                  or st.right_extent < min_extent) else 0.0)
            penalty *= min(avg_cov / st.supporting + extent_pen, 1.0)
        if st.gtf_match:
            penalty -= MP_MAX
        score -= penalty
    return score


def v2_score_map(cands_lists, read_lens_list, events, stats):
    """{id(candidate): score} over every candidate of every chunk/mate —
    the selection key for --v2-sam runs."""
    cov = build_coverage(cands_lists, read_lens_list)
    out: Dict[int, float] = {}
    for cands, read_lens in zip(cands_lists, read_lens_list):
        for r, clist in cands.items():
            rl = int(read_lens[r])
            for c in clist:
                out[id(c)] = v2_score(c, rl, events, stats, cov)
    return out
