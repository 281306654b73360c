# Copy of tophat_tpu/pipeline/report.py (host code), imports rewritten;
# a chain across two or more fusions ranks below a one-fusion alignment
# (Candidate.score); filter_junctions is array work (a range maximum over
# sorted junction ends in place of the pairwise knockout loop), with the
# same result.
"""Reporting stage: junction filtering, best-alignment selection, output
emission — the tophat_reports equivalent (reference:
src/tophat_reports.cpp:2655 driver; src/junctions.cpp:305 filter_junctions).

Pass 1 accumulates candidate junction/indel statistics from every spliced
candidate alignment, applies accept_if_valid (min anchor extent, splice
mismatch cap, long-intron support rule) and the shadow-junction knockout.
Pass 2 keeps only alignments whose events were accepted, merges them with
contiguous alignments, picks the best-scoring set per read (bowtie2-style
penalties: mismatch 6, gap open 5 + 3/base), dedups by position, caps at
max_multihits, and emits accepted_hits + BED tracks with the reference's
exact formats (print_junction junctions.cpp:98; MAPQ rule
tophat_reports.cpp:734 generalized to the gold 255-for-unique convention).

Host-side numpy: this stage is output formatting + small-set logic; the
heavy per-read work happened on device upstream.
"""

from __future__ import annotations

import dataclasses
import operator
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from tophat_tpu_torch.index.fasta import Genome
from tophat_tpu_torch.io import emit
from tophat_tpu_torch.io import sam as samio
from tophat_tpu_torch.ops.splice import (KIND_DELETION, KIND_FUSION,
                                   KIND_INSERTION, KIND_JUNCTION)
from tophat_tpu_torch.pipeline.fusion_stats import build_fusion_table
from tophat_tpu_torch.utils import trace

MISMATCH_PENALTY = 6   # bowtie2 mp max (reference: common.h bowtie2_* defaults)
GAP_OPEN = 5
GAP_EXTEND = 3


@dataclasses.dataclass
class Candidate:
    """One candidate alignment of one read.

    kind -1 = contiguous; -2 = multi-event chain (chain_ops set); else the
    single crossed event's kind."""

    read: int
    pos: int            # global 0-based leftmost coordinate
    strand: int         # 0 fwd, 1 rev
    mm: int             # base mismatches
    kind: int           # -1 contiguous, -2 chain, else event kind
    ev: int             # event index or -1
    t: int              # prefix length (split point) for event alignments
    gap: int = 0        # I/D length
    chain_ops: tuple = ()    # chain: (("M", len) | ("EV", ev, kind, gap))...
    chain_events: tuple = ()
    fdir: str = "ff"    # fusion direction (kind == KIND_FUSION)
    fpos2: int = -1     # fusion partner coordinate for table-free fusions
    splice_mms: int = 0  # mismatches within min_anchor of the event split
    pair_only: bool = False  # usable only as the spliced half of a proper
    #                          pair (3' anchor in [3, three_min); gold
    #                          test_Paired keeps 21M157N3M mates)
    pair_ok: bool = False    # indel reachable via the ungapped segment-pair
    #                          closure (competes per chain, one winner:
    #                          _closure_competition)
    record_ok: bool = False  # indel reachable via a flank-record hit
    #                          (its own chain: exempt from the competition)

    @property
    def edit_dist(self) -> int:
        if self.kind == -2:
            e = self.mm
            for op in self.chain_ops:
                if op[0] == "EV" and op[2] in (KIND_DELETION,
                                               KIND_INSERTION):
                    e += op[3]
            return e
        if self.kind in (KIND_DELETION, KIND_INSERTION):
            return self.mm + self.gap
        return self.mm

    @property
    def score(self) -> int:
        """Selection rank (higher wins): primary = edit distance, tie-break
        prefers contiguous over gapped/spliced alignments — matches the gold
        outputs where 24M/NM:3 beats 5M2D19M/NM:3 (v1.1.4 ordering; the
        2.1.2 bowtie2-score ranking tophat_reports.cpp:86 orders these the
        other way). Fusions rank below same-edit spliced alignments, and a
        chain across two or more fusions below both (TopHat's hit carries
        one fusion partner; the JAX package ranks it as a one-fusion
        alignment, so a chance chimera ties the true fusion and wins the
        tie by candidate order)."""
        if self.kind == -1:
            pen = 0
        elif self.kind == KIND_FUSION or (
                self.kind == -2 and any(op[0] == "EV" and op[2] == KIND_FUSION
                                        for op in self.chain_ops)):
            pen = 2
        else:
            pen = 1
        if self.kind == -2 and sum(
                op[0] == "FUS" or (op[0] == "EV" and op[2] == KIND_FUSION)
                for op in self.chain_ops) > 1:
            pen = 3
        return -(self.edit_dist * 4) - pen

    def cigar(self, read_len: int) -> List[Tuple[str, int]]:
        if self.kind == -2:
            out: List[Tuple[str, int]] = []
            consumed = 0
            ops = list(self.chain_ops)
            if ops and ops[0][0] == "FUS":  # rf chain: lead soft clip
                rest = sum(op[1] for op in ops[1:]
                           if op[0] == "M"
                           or (op[0] == "EV" and op[2] == KIND_INSERTION))
                out.append(("S", read_len - rest))
                consumed = read_len - rest
                ops = ops[1:]
            for op in ops:
                if op[0] == "M":
                    out.append(("M", op[1]))
                    consumed += op[1]
                elif op[0] == "FUS":
                    out.append(("S", read_len - consumed))
                    return out
                else:
                    _, ev, kind, gap = op
                    if kind == KIND_JUNCTION:
                        out.append(("N", gap))
                    elif kind == KIND_DELETION:
                        out.append(("D", gap))
                    elif kind == KIND_INSERTION:
                        out.append(("I", gap))
                        consumed += gap
                    elif kind == KIND_FUSION:
                        # left piece only; fused remainder soft-clipped
                        out.append(("S", read_len - consumed))
                        return out
            return out
        if self.kind == KIND_JUNCTION:
            return [("M", self.t), ("N", self.gap), ("M", read_len - self.t)]
        if self.kind == KIND_DELETION:
            return [("M", self.t), ("D", self.gap), ("M", read_len - self.t)]
        if self.kind == KIND_INSERTION:
            return [("M", self.t), ("I", self.gap),
                    ("M", read_len - self.t - self.gap)]
        if self.kind == KIND_FUSION:
            # one piece aligned, the fused other piece soft-clipped and
            # described by the XF tag (reference represents the whole
            # alignment with fusion cigar opcodes, bwt_map.h:36-68)
            if self.fdir == "rf":
                return [("S", self.t), ("M", read_len - self.t)]
            return [("M", self.t), ("S", read_len - self.t)]
        return [("M", read_len)]

    def nm(self) -> int:
        if self.kind == -2:
            return self.edit_dist
        return self.mm + (self.gap if self.kind in (KIND_DELETION,
                                                    KIND_INSERTION) else 0)


def _junction_checks_vec(genome, gs, rows, rls, ts, lefts, rights,
                         seg_budget, min_anchor):
    """Vectorized _candidate_checks for KIND_JUNCTION candidates: one
    (N, L) gather/compare instead of a per-candidate Python call. Returns
    (ok, splice_mms) arrays of length N; semantics identical to the scalar
    path (out-of-genome bases count as mismatches, per-segment budget over
    the spliced placement, near-splice window sum)."""
    n = genome.shape[0]
    N = len(rows)
    L = gs.readsg.shape[1]
    u = np.arange(L, dtype=np.int64)[None, :]
    t = ts[:, None]
    gpos = np.where(u < t, lefts[:, None] - t + 1 + u,
                    rights[:, None] + (u - t))
    inb = (gpos >= 0) & (gpos < n)
    g = genome[np.clip(gpos, 0, n - 1)]
    r = gs.readsg[rows]
    bad = np.where(u < rls[:, None],
                   (g != r) | (g >= 4) | (r >= 4) | ~inb, False)
    cum = np.zeros((N, L + 1), np.int32)
    np.cumsum(bad, axis=1, out=cum[:, 1:])
    ar = np.arange(N)
    lo = np.maximum(ts - min_anchor, 0)
    hi = np.minimum(ts + min_anchor, rls)
    splice_mms = cum[ar, hi] - cum[ar, lo]
    cuts = np.minimum(gs.cuts[rows].astype(np.int64), rls[:, None])
    segsum = cum[ar[:, None], cuts[:, 1:]] - cum[ar[:, None], cuts[:, :-1]]
    ok = (segsum <= seg_budget).all(axis=1)
    return ok, splice_mms


def _candidate_checks(genome, row_codes, cuts_row, rl, seg_budget,
                      min_anchor, kind, left, right, q, seq, t,
                      segment_length=None):
    """Gate a spliced candidate by segment-path feasibility and compute its
    near-splice mismatch count.

    Feasibility mirrors how the gold-era pipeline could have produced the
    candidate at all (long_spanning_reads join semantics): every segment of
    the read must fit `seg_budget` mismatches with the event applied, and —
    for indels — the event must be reachable through one of the two actual
    candidate paths (see _indel_admission).
    splice_mms: mismatches within min_anchor of the split point (reference:
    bwt_map.cpp:723 counts |spl_ofs - o| < min_anchor_len into _splice_mms).

    Returns (ok, splice_mms)."""
    n = genome.shape[0]
    mmv = np.zeros(rl, bool)

    def cmp(ridx, gpos):
        rp = row_codes[ridx]
        inb = (gpos >= 0) & (gpos < n)
        g = genome[np.clip(gpos, 0, n - 1)]
        return np.where(inb, (g != rp) | (g >= 4) | (rp >= 4), True)

    pre = np.arange(t)
    mmv[:t] = cmp(pre, left - t + 1 + pre)
    if kind == KIND_INSERTION:
        mid = np.arange(q)
        rp = row_codes[t + mid]
        mmv[t: t + q] = (rp != seq[:q]) | (rp >= 4) | (seq[:q] >= 4)
        suf = np.arange(rl - t - q)
        mmv[t + q:] = cmp(t + q + suf, left + 1 + suf)
    else:
        suf = np.arange(rl - t)
        mmv[t:] = cmp(t + suf, right + suf)

    splice_mms = int(mmv[max(0, t - min_anchor): t + min_anchor].sum())

    if kind in (KIND_DELETION, KIND_INSERTION, KIND_FUSION):
        record_ok, pair_ok = _indel_admission(
            genome, row_codes, cuts_row, rl, seg_budget, kind, left, right,
            q, t, mmv, segment_length or seg_budget, cmp)
        return record_ok or pair_ok, splice_mms, (record_ok, pair_ok)

    for j in range(len(cuts_row) - 1):
        a, b = int(cuts_row[j]), int(cuts_row[j + 1])
        if b > a and mmv[a:b].sum() > seg_budget:
            return False, splice_mms, (False, False)
    return True, splice_mms, (False, False)


def _indel_admission(genome, row_codes, cuts_row, rl, seg_budget, kind,
                     left, right, q, t, mmv, segment_length, cmp):
    """v1.1.4 indel candidate admission: the alignment must be reachable
    through one of the two paths that actually generated indel candidates
    in the gold-era pipeline (reference: long_spanning_reads merge_chain +
    the juncs_db record mapping, juncs_db.cpp:73 print_insertion /
    :109 print_splice):

    1. RECORD path — the split t is interior to one segment (the spanning
       segment), which maps against the event's flank record: both in-
       segment anchors >= 1 base, the segment's flank extents fit the
       record geometry (insertion half = segment_length - 3, the juncs_db
       `3 <seg_len>` call; deletion half = segment_length), the inserted
       read bases equal the event sequence exactly (an insertion record
       embeds the sequence — a read mismatching inside the insert cannot
       map it), and every segment fits seg_budget mismatches under the
       spliced placement.
    2. PAIR path — t falls exactly on a segment boundary (or the insert
       ends on one): both flanking segments have plain UNGAPPED genomic
       hits (<= seg_budget mismatches, inserted bases counted raw against
       the genome) that merge_chain closes with the event; for insertions
       the inserted read bases must equal the event sequence (merge
       requires the event's sequence).
    """
    pos = left - t + 1
    gap = q if kind == KIND_INSERTION else right - left - 1
    segs = []
    for j in range(len(cuts_row) - 1):
        a, b = int(cuts_row[j]), int(cuts_row[j + 1])
        if b > a:
            segs.append((a, b))
    if kind == KIND_INSERTION and np.any(mmv[t: t + q]):
        return False, False  # inserted bases must equal the event sequence
    cons = q if kind == KIND_INSERTION else 0  # read bases the event eats
    cutset = {a for a, _ in segs} | {segs[-1][1]} if segs else set()

    record_ok = False
    # RECORD path: spanning segment with t (and the insert) strictly inside.
    # Anchor floor within the spanning segment: 1 base for insertions
    # (record offsets allow a 1-base flank, juncs_db.cpp:73), 2 bases for
    # deletions (gold keeps 2-base-anchor record hits and drops 1-base ones:
    # read387 11M2D13M vs read_rc70 6M2D18M, test_IndelWithErrors)
    # fusion flank records are built as `juncs_db 3 <seg_len>` too: half =
    # seg_len - 3, which both floors the in-segment anchor at 3 and caps it
    # at seg_len - 3 (print_fusion, juncs_db.cpp:152)
    if kind == KIND_FUSION:
        min_anchor_rec = 3
        half = max(segment_length - 3, 1)
    elif kind == KIND_INSERTION:
        min_anchor_rec = 1
        half = segment_length - 3
    else:
        min_anchor_rec = 2
        half = segment_length
    for a, b in segs:
        if not (t - a >= min_anchor_rec and b - (t + cons) >= min_anchor_rec):
            continue
        if (t - a) > half or (b - (t + cons)) > half:
            continue
        ok = True
        for a2, b2 in segs:
            if mmv[a2:b2].sum() > seg_budget:
                ok = False
                break
        if ok:
            record_ok = True
            break

    # PAIR path: two adjacent segments with plain ungapped genomic hits,
    # gap closed by the event. The event split may sit up to 4 bases from
    # the segment boundary (merge_chain's dist_to_left/right <= 4 window,
    # long_spanning_reads.cpp:1341); for insertions the boundary must fall
    # within the inserted span (insert_to_prev_right/curr_left_to_insert
    # geometry, :1036-1046).
    inner_cuts = sorted(cutset - {segs[0][0], segs[-1][1]}) if segs else []
    for c in inner_cuts:
        if kind == KIND_INSERTION:
            if not (t <= c <= t + q):
                continue
        else:
            if abs(c - t) > 4:
                continue
        ok = True
        for a, b in segs:
            if kind == KIND_INSERTION:
                # ungapped hit: segments at/after the boundary shift back
                # by q; inserted bases count raw against the genome
                p = pos + a - (q if a >= c else 0)
            else:
                p = pos + a + (gap if a >= c else 0)
            idx = np.arange(a, b)
            if cmp(idx, p + idx - a).sum() > seg_budget:
                ok = False
                break
        if ok:
            return record_ok, True
    return record_ok, False


def collect_candidates(aln, gs, events, spl_rows, spl_evs, spl_ts,
                       spl_mm_flat,
                       params, stitched=None, genome_codes=None,
                       chain_cands=None,
                       paired=False) -> Dict[int, List[Candidate]]:
    """Merge contiguous alignments, stitched-chain alignments and event
    realignments into per-read candidate lists (the long_spanning_reads
    output analog). Realignment results arrive SPARSE — flat (row, event,
    split, mm) arrays of the passing pairs (ops/events.
    realign_events_sparse), so no dense (R, E) tables cross the
    host-device boundary."""
    cands: Dict[int, List[Candidate]] = {}

    glen_all = genome_codes.shape[0] if genome_codes is not None else None
    pos = np.asarray(aln.pos)
    strand = np.asarray(aln.strand)
    mm = np.asarray(aln.mm)
    valid = np.asarray(aln.valid)
    for r, c in zip(*np.nonzero(valid)):
        p0 = int(pos[r, c])
        if p0 < 0 or (glen_all is not None and p0 >= glen_all):
            continue
        cands.setdefault(int(r), []).append(Candidate(
            read=int(r), pos=p0, strand=int(strand[r, c]),
            mm=int(mm[r, c]), kind=-1, ev=-1, t=0))

    # contiguous stitched chains: full-read placements whose mismatch count
    # may exceed the full-read limit but respects per-segment limits
    if stitched is not None:
        st_pos, st_mm, st_ok = stitched
        for row, h in zip(*np.nonzero(st_ok)):
            read = int(gs.read_idx[row])
            if read < 0:  # pow2 padding row (pipeline/segment.py)
                continue
            p0 = int(st_pos[row, h])
            rl_row = int(gs.lengths[row])
            if p0 < 0 or (glen_all is not None and p0 + rl_row > glen_all):
                continue
            c = Candidate(read=read, pos=p0,
                          strand=int(gs.strand[row]), mm=int(st_mm[row, h]),
                          kind=-1, ev=-1, t=0)
            # the full-read aligner may have found the same placement
            existing = cands.get(read, [])
            if not any(x.pos == c.pos and x.strand == c.strand
                       and x.kind == -1 for x in existing):
                cands.setdefault(read, []).append(c)

    # anchor policy for spliced (junction) alignments, derived from the gold
    # regression outputs (v1.1.4 behavior): the read's 5' overhang must reach
    # min(min_anchor, segment_length - 2) and its 3' overhang at least 5;
    # indel alignments carry no anchor requirement (gold has 2M anchors).
    five_min = min(params.min_anchor_len, params.segment_length - 2)
    three_min = 5

    if len(spl_rows):
        ev_left = events["left"]
        ev_right = events["right"]
        ev_kind = events["kind"]
        ev_ilen = events["ins_len"]

        rows_all = np.asarray(spl_rows)
        es_all = np.asarray(spl_evs)
        ts_all = np.asarray(spl_ts)
        mm_all = np.asarray(spl_mm_flat)
        is_junc = (ev_kind[es_all] == KIND_JUNCTION) \
            if len(rows_all) else np.zeros(0, bool)
        # ---- junction candidates: fully vectorized gates + checks ----
        jsel = is_junc & (gs.read_idx[rows_all] >= 0)
        if genome_codes is not None and jsel.any():
            jr = rows_all[jsel]
            je = es_all[jsel]
            tj = ts_all[jsel].astype(np.int64)
            lj = ev_left[je].astype(np.int64)
            rj = ev_right[je].astype(np.int64)
            gapj = rj - lj - 1
            rlj = gs.lengths[jr].astype(np.int64)
            strj = gs.strand[jr].astype(np.int64)
            ga_l, ga_r = tj, rlj - tj
            five = np.where(strj == 0, ga_l, ga_r)
            three = np.where(strj == 0, ga_r, ga_l)
            nsegj = gs.nseg[jr]
            pair_onlyj = (three < three_min) & (three >= 3) & paired \
                & (nsegj <= 2)
            min_i = min(params.min_intron_length, params.min_segment_intron)
            pos0j = lj - tj + 1
            glen = genome_codes.shape[0]
            keep = ((gapj > 0) & (five >= five_min)
                    & ((three >= three_min) | pair_onlyj)
                    & (gapj >= min_i) & (gapj <= params.max_intron_length)
                    & (pos0j >= 0) & (pos0j + rlj + gapj <= glen))
            if keep.any():
                okv, smv = _junction_checks_vec(
                    genome_codes, gs, jr[keep], rlj[keep], tj[keep],
                    lj[keep], rj[keep], params.segment_mismatches,
                    params.min_anchor_len)
                jr_k = jr[keep]
                je_k = je[keep]
                tj_k = tj[keep]
                po_k = pair_onlyj[keep]
                mm_k = mm_all[jsel][keep]
                gap_k = gapj[keep]
                pos_k = pos0j[keep]
                str_k = strj[keep]
                ridx_k = gs.read_idx[jr_k]
                for i in np.nonzero(okv)[0]:
                    read = int(ridx_k[i])
                    cands.setdefault(read, []).append(Candidate(
                        read=read, pos=int(pos_k[i]), strand=int(str_k[i]),
                        mm=int(mm_k[i]), kind=KIND_JUNCTION,
                        ev=int(je_k[i]), t=int(tj_k[i]), gap=int(gap_k[i]),
                        splice_mms=int(smv[i]),
                        pair_only=bool(po_k[i])))
            rows_iter = rows_all[~jsel]
            es_iter = es_all[~jsel]
            ts_iter = ts_all[~jsel]
            mm_iter = mm_all[~jsel]
        else:
            rows_iter = rows_all
            es_iter = es_all
            ts_iter = ts_all
            mm_iter = mm_all

        for row, e, t_e, mm_e in zip(rows_iter, es_iter, ts_iter,
                                     mm_iter):
            read = int(gs.read_idx[row])
            if read < 0:  # pow2 padding row
                continue
            t = int(t_e)
            kind = int(ev_kind[e])
            if kind == KIND_INSERTION:
                gap = int(ev_ilen[e])
            elif kind == KIND_FUSION:
                gap = 0
            else:
                gap = int(ev_right[e]) - int(ev_left[e]) - 1
                if gap <= 0:
                    continue
            strand = int(gs.strand[row])
            rl = int(gs.lengths[row])
            # fusion candidates: no hard fusion_anchor_length gate here —
            # the reference reports fusion-spanning ALIGNMENTS whose anchors
            # satisfy only the flank-record geometry (>= 3 bases each side,
            # juncs_db.cpp:152); fusion_anchor_length gates FusionStat
            # counting (fusions.cpp:193) and discovery, not accepted_hits.
            # Admission happens in _candidate_checks below.
            pair_only = False
            if kind == KIND_JUNCTION:
                ganchor_l = t
                ganchor_r = rl - t
                five, three = ((ganchor_l, ganchor_r) if strand == 0
                               else (ganchor_r, ganchor_l))
                if five < five_min:
                    continue
                if three < three_min:
                    # paired runs rescue spliced mates with a 3' anchor of
                    # 3-4 bp when the other mate anchors the pair (gold
                    # test_Paired 21M157N3M records). Gold only contains
                    # these for 2-segment reads (segment_length 12); the
                    # 3-segment run of the same reads (test_3Segment,
                    # segment_length 8) has a hard floor of 5 — the rescue
                    # path goes through the last segment's flank-record
                    # hit, which longer chains never produce.
                    if not (paired and three >= 3
                            and int(gs.nseg[row]) <= 2):
                        continue
                    pair_only = True
            elif kind == KIND_DELETION:
                # read-space anchor floors from the gold outputs: 5' must
                # reach min_anchor (deletion-record hits shorter than that
                # never merge), 3' >= 3 (gold test_IndelWithErrors keeps a
                # 3M2D21M minus-strand record)
                ganchor_l = t
                ganchor_r = rl - t
                five, three = ((ganchor_l, ganchor_r) if strand == 0
                               else (ganchor_r, ganchor_l))
                if five < five_min or three < 3:
                    continue
            if kind == KIND_JUNCTION:
                # reported-intron bounds (-i/-I; reference passes them to
                # every stage as --min/max-report-intron, run.log contract)
                min_i = min(params.min_intron_length,
                            params.min_segment_intron)
                if not (min_i <= gap <= params.max_intron_length):
                    continue
            # bounds: the placement must stay inside the genome
            pos0 = int(ev_left[e]) - t + 1
            glen = (genome_codes.shape[0] if genome_codes is not None
                    else None)
            if pos0 < 0:
                continue
            if glen is not None:
                if kind == KIND_FUSION:
                    if (pos0 + t > glen or int(ev_right[e]) < 0
                            or int(ev_right[e]) + (rl - t) > glen):
                        continue
                else:
                    span = rl + (gap if kind != KIND_INSERTION else -gap)
                    if pos0 + span > glen:
                        continue
            if genome_codes is not None:
                ok, spl_mms, (rec_ok, pr_ok) = _candidate_checks(
                    genome_codes, gs.readsg[row], gs.cuts[row], rl,
                    params.segment_mismatches, params.min_anchor_len, kind,
                    int(ev_left[e]), int(ev_right[e]), int(ev_ilen[e]),
                    events["ins_seq"][e], t,
                    segment_length=params.segment_length)
                if not ok:
                    continue
            else:
                spl_mms = int(mm_e)
                rec_ok = pr_ok = False
            cands.setdefault(read, []).append(Candidate(
                read=read, pos=int(ev_left[e]) - t + 1,
                strand=strand, mm=int(mm_e),
                kind=kind, ev=int(e), t=t, gap=gap, splice_mms=spl_mms,
                pair_only=pair_only, pair_ok=pr_ok, record_ok=rec_ok))

    # multi-event chains (pipeline/chains.py)
    for cc in (chain_cands or []):
        if any(op[0] == "EV" and op[2] == KIND_FUSION
               for op in cc.ops):
            # fusion anchor: enough aligned bases on both sides of the break
            pre = post = 0
            seen_fusion = False
            for op in cc.ops:
                n = op[1] if op[0] == "M" else (
                    op[3] if op[2] == KIND_INSERTION else 0)
                if op[0] == "EV" and op[2] == KIND_FUSION:
                    seen_fusion = True
                elif seen_fusion:
                    post += n
                else:
                    pre += n
            if pre < 3 or post < 3:  # record-geometry floor (see above)
                continue
        cands.setdefault(cc.read, []).append(Candidate(
            read=cc.read, pos=cc.pos, strand=cc.strand, mm=cc.mm,
            kind=-2, ev=-1, t=0, chain_ops=tuple(cc.ops),
            chain_events=tuple(cc.events)))
    for r in cands:
        cands[r] = _closure_competition(cands[r])
    return cands


def _closure_competition(clist: List[Candidate]) -> List[Candidate]:
    """merge_chain closes one segment-pair gap with at most ONE event: it
    keeps the strictly-best closure scanning events in (left, right) order
    (ties lose; long_spanning_reads.cpp:1326 new_diff_mismatches), and a
    second successful INSERTION closure drops the read's chain entirely
    (:1246 'multiple closures found'). All pair-path-admissible candidates
    of one chain compete; the losers survive only if they are separately
    reachable as flank-record hits (their own chains)."""
    groups: Dict[Tuple[int, int, int], List[Candidate]] = {}
    for c in clist:
        if c.pair_ok:
            groups.setdefault((c.strand, c.pos, c.kind), []).append(c)
    if not groups:
        return clist
    drop = set()
    for (strand, pos, kind), grp in groups.items():
        if len(grp) < 2:
            continue
        if kind == KIND_INSERTION and len({c.ev for c in grp}) > 1:
            drop.update(id(c) for c in grp if not c.record_ok)
            continue
        # the reference scans its event set in (left, right) order and keeps
        # the strictly-best closure, so ties go to the smallest coordinate
        # (event left = pos + t - 1 for both indel kinds)
        best = min(grp, key=lambda c: (c.mm, c.pos + c.t))
        drop.update(id(c) for c in grp
                    if c is not best and not c.record_ok)
    return [c for c in clist if id(c) not in drop]


@dataclasses.dataclass
class EventStats:
    supporting: int = 0
    left_extent: int = 0
    right_extent: int = 0
    min_mm: int = 255
    accepted: bool = False
    gtf_match: bool = False

    def add(self, left_anchor: int, right_anchor: int, mm: int):
        self.supporting += 1
        self.left_extent = max(self.left_extent, left_anchor)
        self.right_extent = max(self.right_extent, right_anchor)
        self.min_mm = min(self.min_mm, mm)


def accumulate_event_stats(cands: Dict[int, List[Candidate]], events,
                           read_lens) -> Dict[int, EventStats]:
    stats: Dict[int, EventStats] = {}
    for clist in cands.values():
        for c in clist:
            if c.kind == -2:
                for i, op in enumerate(c.chain_ops):
                    if op[0] != "EV":
                        continue
                    pre = (c.chain_ops[i - 1][1]
                           if i > 0 and c.chain_ops[i - 1][0] == "M" else 0)
                    post = (c.chain_ops[i + 1][1]
                            if i + 1 < len(c.chain_ops)
                            and c.chain_ops[i + 1][0] == "M" else 0)
                    stats.setdefault(op[1], EventStats()).add(pre, post, c.mm)
                continue
            if c.ev < 0:
                continue
            st = stats.setdefault(c.ev, EventStats())
            rl = int(read_lens[c.read])
            right_anchor = rl - c.t - (c.gap if events["kind"][c.ev] ==
                                       KIND_INSERTION else 0)
            st.add(c.t, right_anchor, c.splice_mms)
    return stats


def filter_junctions(events, stats: Dict[int, EventStats], params,
                     gtf_accept: Optional[set] = None):
    """accept_if_valid + knockout_shadow_junctions
    (reference: junctions.cpp:190-240, 242-303), as array work over the
    stats' events; sets each EventStats' accepted (and gtf_match) in place.

    The knockout rejects an accepted junction without a GTF match when a
    junction of the opposite sense with more support has its left or its
    right end within min_anchor_len of the same end. Every junction of
    `stats` can knock out, rejected and GTF-matched ones too, so the result
    does not depend on order: a range maximum of `supporting` over the
    opposite sense's junctions sorted by each end decides it, O(J log J).
    The junctions it rejects are counted as `junctions.shadowed`."""
    n = len(stats)
    ids = np.fromiter(stats.keys(), np.int64, count=n)
    sts = list(stats.values())
    cols = np.array([(st.supporting, st.left_extent, st.right_extent,
                      st.min_mm, st.gtf_match) for st in sts],
                    np.int64).reshape(n, 5)
    sup, ext = cols[:, 0], np.minimum(cols[:, 1], cols[:, 2])
    junc = np.asarray(events["kind"])[ids] == KIND_JUNCTION
    left = np.asarray(events["left"])[ids].astype(np.int64)
    right = np.asarray(events["right"])[ids].astype(np.int64)
    anti = np.asarray(events["antisense"])[ids].astype(bool)

    gtf = np.zeros(n, bool)
    if gtf_accept:
        jj = np.flatnonzero(junc)
        gtf[jj] = [k in gtf_accept for k in zip(
            left[jj].tolist(), right[jj].tolist(), anti[jj].tolist())]
    a = params.min_anchor_len
    accepted = ((ext >= a) & (cols[:, 3] <= params.splice_mismatches)
                & ((right - left <= 50000) | ((sup >= 2) & (ext > 12))))
    accepted |= ~junc | gtf   # indels have no anchor filter at this stage

    # shadow knockout
    query = junc & accepted & ~gtf & (cols[:, 4] == 0)
    shadowed = np.zeros(n, bool)
    for sense in (False, True):
        q = np.flatnonzero(query & (anti == sense))
        k = np.flatnonzero(junc & (anti != sense))
        if not len(q) or not len(k):
            continue
        for end in (left, right):
            order = np.argsort(end[k])
            at, table = end[k][order], _max_table(sup[k][order])
            lo = np.searchsorted(at, end[q] - a, side="left")
            hi = np.searchsorted(at, end[q] + a, side="right")
            shadowed[q] |= _range_max(table, lo, hi) > sup[q]
    accepted &= ~shadowed
    trace.count("junctions.shadowed", int(shadowed.sum()))

    for st, acc, g in zip(sts, accepted.tolist(), gtf.tolist()):
        st.accepted = acc
        if g:
            st.gtf_match = True


def _max_table(vals: np.ndarray) -> np.ndarray:
    """Sparse table for range maxima: row j holds max(vals[i:i + 2**j]) at
    i (rows past a full window padded with -1)."""
    n = len(vals)
    table = np.full((n.bit_length(), n), -1, np.int64)
    table[0] = vals
    for j in range(1, len(table)):
        w = 1 << (j - 1)
        table[j, :n - 2 * w + 1] = np.maximum(table[j - 1, :n - 2 * w + 1],
                                              table[j - 1, w:n - w + 1])
    return table


def _range_max(table: np.ndarray, lo: np.ndarray,
               hi: np.ndarray) -> np.ndarray:
    """max(vals[lo:hi]) per query from _max_table's table; -1 where the
    window is empty."""
    nz = hi > lo
    j = np.frexp(np.maximum(hi - lo, 1))[1] - 1     # floor(log2(size))
    lo = np.where(nz, lo, 0)
    hi = np.where(nz, hi - np.left_shift(1, j), 0)
    return np.where(nz, np.maximum(table[j, lo], table[j, hi]), -1)


def select_best(cands: List[Candidate], max_multihits: int,
                rng: np.random.Generator,
                report_secondary: bool = False,
                score_of=None) -> List[Candidate]:
    """read_best_alignments semantics (reference: tophat_reports.cpp:113):
    keep all alignments tied at the best score, dedup by placement, cap at
    max_multihits with random tie down-sampling. report_secondary keeps
    below-best alignments too (--report-secondary-alignments).
    score_of overrides the ranking (the --v2-sam AlignStatus rescoring,
    pipeline/align_status.py)."""
    if not cands:
        return []
    if score_of is None:
        score_of = lambda c: c.score
    best = max(score_of(c) for c in cands)
    kept = (list(cands) if report_secondary
            else [c for c in cands if score_of(c) == best])
    seen = set()
    uniq = []
    for c in sorted(kept, key=lambda c: (c.strand, c.pos, c.kind, c.t)):
        # tied best alignments dedup by (start, split point): two events
        # that place a read identically (same pos AND same split — e.g.
        # the CAT/CAC insertion variants in test_IndelWithErrors) are one
        # record; different splits at the same start survive as NH>1 ties
        # with CC/CP, which the gold outputs do contain (read34/read_rc70)
        pkey = (c.strand, c.pos, c.t, c.chain_ops)
        if pkey not in seen:
            seen.add(pkey)
            uniq.append(c)
    if len(uniq) > max_multihits:
        idx = rng.choice(len(uniq), size=max_multihits, replace=False)
        uniq = [uniq[i] for i in sorted(idx)]
    return uniq


def write_outputs_multi(out_dir: str, genome: Genome, params, parts,
                        events):
    """Emit accepted_hits.sam/.bam, unmapped.bam, BED tracks and
    align_summary for one or many processed read chunks.

    parts: [(ReadBatch, selected)] — the streaming pipeline passes one entry
    per chunk (the k-way-merge role of the reference's per-thread output
    parts, src/bam_merge.cpp + tophat.py:2736-2830)."""
    os.makedirs(out_dir, exist_ok=True)
    records, final_stats, bam_blob, tally = _write_sam(out_dir, genome,
                                                       params, parts, events)
    write_bam_outputs(out_dir, genome, parts, bam_blob,
                      skip_accepted=params.no_convert_bam, params=params)

    with trace.span("output.beds"):
        _write_beds(out_dir, genome, events, final_stats)
    if params.fusion_search:
        build_fusion_table(genome, events, params, parts).write(
            os.path.join(out_dir, "fusions.out"))

    with trace.span("output.summary"):
        write_align_summary(out_dir, ("Reads",) + tally + (0,), None, None,
                            None, params.max_multihits)
    return records


@trace.span("output.sam")
def _write_sam(out_dir, genome, params, parts, events):
    """accepted_hits.sam of the selected candidates, coordinate-sorted;
    (records, the events' final stats, the BAM records' bytes, (reads,
    aligned reads, multi-mapped reads))."""
    records = []  # (c, nh, rl, part_idx)
    n_aligned_reads = 0
    multimapped = 0
    total = 0
    for pi, (batch, selected) in enumerate(parts):
        total += batch.size
        lengths = batch.lengths.tolist()
        for r, clist in selected.items():
            if not clist:
                continue
            n_aligned_reads += 1
            nh = len(clist)
            if nh > 1:
                multimapped += 1
            records += [(c, nh, lengths[r], pi) for c in clist]

    cs, nh, rl, part = _unzip(records, 4)
    cand = gather_candidates(cs)
    nh, rl, part = (np.asarray(x, np.int64) for x in (nh, rl, part))
    read, pos, t = cand[_READ], cand[_POS], cand[_T]
    if params.no_sort_bam:
        # --no-sort-bam: keep read order (reference leaves the merge
        # unsorted, tophat.py:2783)
        order = np.lexsort((t, pos, read, part))
    else:
        # coordinate sort; ties by global read order then split point
        order = np.lexsort((t, read, part, pos))
    cs = list(map(cs.__getitem__, order.tolist()))
    cand, nh, rl, part = cand[:, order], nh[order], rl[order], part[order]
    f = record_columns(genome, events, cs, cand, rl)
    final_stats = _event_stats(events, cand, rl, order, f["chains"])

    # multi-mapped reads: all but the read's last emitted record are
    # secondary (0x100) and carry CC/CP pointing at the next record, the
    # bowtie convention the gold outputs preserve
    pool = emit.ReadPool([b for b, _ in parts])
    gread, _ = pool.locate(part, cand[_READ])
    nxt = _next_of_read(gread)
    secondary = (nh > 1) & (nxt >= 0)
    flag = np.where(cand[_STRAND] != 0, samio.FLAG_REVERSE, 0)
    flag[secondary] |= samio.FLAG_SECONDARY
    rows = np.flatnonzero(secondary | f["fused"])
    tags = []
    for i in rows.tolist():
        extra = []
        if secondary[i]:
            j = int(nxt[i])
            nref = genome.names[int(f["cid"][j])]
            cc = "=" if nref == genome.names[int(f["cid"][i])] else nref
            extra += [f"CC:Z:{cc}", f"CP:i:{int(f['local'][j]) + 1}"]
        if f["fused"][i]:
            extra += _fusion_tags(cs[i], int(f["cid"][i]),
                                  int(f["local"][i]), genome, events)
        tags.append(extra)
    bam_blob = write_records(
        out_dir, genome, params, pool, part, cand, rl, nh, flag, f,
        f["xs"] + f["xs_chain"], extras=emit.extra_tags(len(cs), rows, tags))
    trace.count("records", len(records))
    return (records, final_stats, bam_blob,
            (total, n_aligned_reads, multimapped))


def write_align_summary(out_dir, left, right, unpaired, pairs,
                        max_multihits):
    """align_summary.txt in the reference layout (print_alnStats,
    tophat_reports.cpp:2119). left/right/unpaired: (title, input, mapped,
    multi, xmulti) or None; pairs: (aligned, multi, discordant) or None."""
    def side(f, title, total, mapped, multi, xmulti):
        f.write(f"{title}:\n")
        f.write("          Input     : %9d\n" % total)
        f.write("           Mapped   : %9d (%4.1f%% of input)\n"
                % (mapped, 100.0 * mapped / max(total, 1)))
        if mapped and multi > 0:
            f.write("            of these: %9d (%4.1f%%) have multiple "
                    "alignments (%d have >%d)\n"
                    % (multi, 100.0 * multi / mapped, xmulti, max_multihits))

    with open(os.path.join(out_dir, "align_summary.txt"), "w") as f:
        title, total, mapped, multi, xmulti = left
        side(f, title, total, mapped, multi, xmulti)
        total_input, total_mapped = total, mapped
        if right is not None:
            side(f, *right)
            total_input += right[1]
            total_mapped += right[2]
        if unpaired is not None and unpaired[1]:
            side(f, *unpaired)
            total_input += unpaired[1]
            total_mapped += unpaired[2]
        f.write("%4.1f%% overall read mapping rate.\n"
                % (100.0 * total_mapped / max(total_input, 1)))
        if pairs is not None and pairs[0]:
            aligned, multi_p, disc = pairs
            f.write("\nAligned pairs: %9d\n" % aligned)
            if multi_p > 0:
                f.write("     of these: %9d (%4.1f%%) have multiple "
                        "alignments\n"
                        % (multi_p, 100.0 * multi_p / aligned))
            if disc > 0:
                f.write("               %9d (%4.1f%%) are discordant "
                        "alignments\n" % (disc, 100.0 * disc / aligned))
            conc = aligned - disc
            f.write("%4.1f%% concordant pair alignment rate.\n"
                    % (100.0 * conc / max(aligned, 1)))


# candidate fields gathered into columns (gather_candidates' rows)
_CAND_FIELDS = ("read", "pos", "strand", "mm", "kind", "ev", "t", "gap")
_READ, _POS, _STRAND, _MM, _KIND, _EV, _T, _GAP = range(8)
_CHAIN_OP = {"M": 0, "EV": 1, "FUS": 2}
_XS = (ord("+"), ord("-"))


def _unzip(records, k: int):
    """The k fields of a list of k-tuples as k lists."""
    return [list(x) for x in zip(*records)] if records else [[]] * k


def gather_candidates(cs) -> np.ndarray:
    """(8, n) int64: every candidate's read, pos, strand, mm, kind, ev, t
    and gap, in one pass."""
    get = operator.attrgetter(*_CAND_FIELDS)
    return np.array(list(map(get, cs)), np.int64).reshape(-1, 8).T.copy()


def _seg_sum(v: np.ndarray, off: np.ndarray) -> np.ndarray:
    """Sum of v over each segment [off[i], off[i+1])."""
    c = np.zeros(len(v) + 1, np.int64)
    np.cumsum(v, out=c[1:])
    return c[off[1:]] - c[off[:-1]]


def _flatten_chains(chains):
    """The chain_ops of these chains in one pass, as flat arrays: (ops a
    chain, op type: 0 M, 1 EV, 2 FUS; op[1]: an M's length, an EV's event,
    a FUS's partner; an EV's kind, -1 elsewhere; an EV's gap, 0
    elsewhere)."""
    ops_l = [c.chain_ops for c in chains]
    cnt = np.fromiter(map(len, ops_l), np.int64, len(ops_l))
    flat = [op for ops in ops_l for op in ops]
    m = len(flat)
    typ = np.fromiter((_CHAIN_OP[op[0]] for op in flat), np.int64, m)
    a = np.fromiter((op[1] for op in flat), np.int64, m)
    ev_ops = [op for op in flat if op[0] == "EV"]
    ekind = np.full(m, -1, np.int64)
    egap = np.zeros(m, np.int64)
    ekind[typ == 1] = np.fromiter((op[2] for op in ev_ops), np.int64,
                                  len(ev_ops))
    egap[typ == 1] = np.fromiter((op[3] for op in ev_ops), np.int64,
                                 len(ev_ops))
    return cnt, typ, a, ekind, egap


def _chain_cigars(flat, rl, mm, events):
    """Candidate.cigar, nm() and the first junction's XS of multi-event
    chains from their flattened ops (_flatten_chains): (ops a chain,
    packed BAM ops, NM, XS byte or 0, whether a fusion is crossed)."""
    cnt, typ, a, ekind, egap = flat
    k, m = len(cnt), len(typ)
    is_m, is_fus = typ == 0, typ == 2
    off = emit.offsets(cnt)
    owner = np.repeat(np.arange(k), cnt)
    j = np.arange(m) - off[:-1][owner]
    lead = np.zeros(k, bool)       # an rf chain: a lead soft clip
    has = cnt > 0
    lead[has] = is_fus[off[:-1][has]]
    lead_op = lead[owner] & (j == 0)
    is_ins = ekind == KIND_INSERTION
    # the lead clip is what the rest leaves of the read, the rest counted
    # as Candidate.cigar counts it (M lengths, and op[1] of insertions)
    rest = _seg_sum(np.where(is_m | is_ins, a, 0), off)
    used = np.where(is_m, a, 0) + np.where(is_ins, egap, 0)
    c = np.zeros(m + 1, np.int64)
    np.cumsum(used, out=c[1:])
    before = (np.where(lead, rl - rest, 0)[owner] + c[:-1]
              - c[off[:-1][owner]])          # read bases before each op
    crosses = is_fus | (ekind == KIND_FUSION)
    stop = crosses & ~lead_op               # the last op: a clip of the rest
    stop_j = np.full(k, m, np.int64)
    np.minimum.at(stop_j, owner[stop], j[stop])
    kinds = (ekind == KIND_JUNCTION) | (ekind == KIND_DELETION) | is_ins
    keep = (j <= stop_j[owner]) & (lead_op | is_m | is_fus | kinds
                                   | (ekind == KIND_FUSION))
    length = np.where(is_m, a, egap)
    length = np.where(stop, rl[owner] - before, length)
    length = np.where(lead_op, (rl - rest)[owner], length)
    code = np.select([is_m, ekind == KIND_JUNCTION, ekind == KIND_DELETION,
                      is_ins], [emit.OP_M, emit.OP_N, emit.OP_D, emit.OP_I],
                     emit.OP_S)
    packed = ((length[keep] << 4) | code[keep]).astype(np.uint32)
    n_ops = np.bincount(owner[keep], minlength=k)
    nm = mm + _seg_sum(np.where((ekind == KIND_DELETION) | is_ins, egap, 0),
                       off)
    xs = np.zeros(k, np.int64)
    junc = np.flatnonzero(ekind == KIND_JUNCTION)
    if len(junc):
        first_of, at = np.unique(owner[junc], return_index=True)
        anti = np.asarray(events["antisense"])[a[junc[at]]]
        xs[first_of] = np.where(anti, _XS[1], _XS[0])
    fused = np.zeros(k, bool)
    fused[owner[crosses]] = True
    return n_ops, packed, nm, xs, fused


def record_columns(genome, events, cs, cand, rl) -> dict:
    """What both writers derive alike from their sorted candidates, as
    arrays: contig and local position (`cid`, `local`), the packed BAM
    CIGAR (`cigar`, `cig_off`; Candidate.cigar), `nm` (Candidate.nm), the
    XS byte of junction rows (`xs`) and of chains (`xs_chain`: the first
    junction crossed), and the rows whose XF tags take a fusion's partner
    (`fused`)."""
    n = len(cs)
    kind, t, gap, ev = cand[_KIND], cand[_T], cand[_GAP], cand[_EV]
    cid, local = genome.global_to_contig(cand[_POS])
    cid = np.asarray(cid, np.int64).reshape(-1)
    local = np.asarray(local, np.int64).reshape(-1)
    lens = np.zeros((n, 3), np.int64)
    codes = np.full((n, 3), emit.OP_M, np.int64)
    cnt = np.ones(n, np.int64)
    lens[:, 0] = rl                 # contiguous, and any other kind
    three = ((kind == KIND_JUNCTION) | (kind == KIND_DELETION)
             | (kind == KIND_INSERTION))
    lens[three, 0] = t[three]
    lens[three, 1] = gap[three]
    lens[three, 2] = (rl - t - np.where(kind == KIND_INSERTION, gap, 0))[three]
    codes[three, 1] = np.select([kind == KIND_JUNCTION,
                                 kind == KIND_DELETION],
                                [emit.OP_N, emit.OP_D], emit.OP_I)[three]
    cnt[three] = 3
    fus = kind == KIND_FUSION
    if fus.any():
        fi = np.flatnonzero(fus)
        rf = np.zeros(n, bool)
        rf[fi] = [cs[i].fdir == "rf" for i in fi.tolist()]
        lens[fus, 0] = t[fus]
        lens[fus, 1] = (rl - t)[fus]
        codes[rf, 0] = emit.OP_S            # rf: [S t, M rl-t]
        codes[fus & ~rf, 1] = emit.OP_S     # ff: [M t, S rl-t]
        cnt[fus] = 2
    nm = cand[_MM] + np.where((kind == KIND_DELETION)
                              | (kind == KIND_INSERTION), gap, 0)
    xs = np.zeros(n, np.int64)
    jr = np.flatnonzero(kind == KIND_JUNCTION)
    if len(jr):
        xs[jr] = np.where(np.asarray(events["antisense"])[ev[jr]], _XS[1],
                          _XS[0])
    xs_chain = np.zeros(n, np.int64)
    fused = fus.copy()
    ci = np.flatnonzero(kind == -2)
    flat = _flatten_chains([cs[i] for i in ci.tolist()])
    if len(ci):
        c_ops, c_packed, nm[ci], xs_chain[ci], fused[ci] = _chain_cigars(
            flat, rl[ci], cand[_MM][ci], events)
        cnt[ci] = c_ops
    cig_off = emit.offsets(cnt)
    cigar = np.zeros(int(cig_off[-1]), np.uint32)
    simple = kind != -2
    for k in range(3):
        rows = simple & (cnt > k)
        cigar[cig_off[:-1][rows] + k] = (
            (lens[rows, k] << 4) | codes[rows, k]).astype(np.uint32)
    if len(ci):
        from tophat_tpu_torch.io.bam import _ragged_index

        cigar[_ragged_index(cig_off[ci], cnt[ci])] = c_packed
    return dict(cid=cid, local=local, cigar=cigar, cig_off=cig_off, nm=nm,
                xs=xs, xs_chain=xs_chain, fused=fused, chains=(ci,) + flat)


def _event_stats(events, cand, rl, enc, chains) -> Dict[int, EventStats]:
    """The events' final stats over the written records (cand, rl: table
    order; enc: each row's place in the order the records were made, which
    orders the dict), as one loop over the records adds them: a
    single-event record adds (t, its right anchor, mm) to its event; a
    chain adds, for each event it crosses, the M lengths on either side."""
    ev, t = cand[_EV], cand[_T]
    one = np.flatnonzero(ev >= 0)
    e1 = ev[one]
    right1 = rl[one] - t[one] - np.where(
        np.asarray(events["kind"])[e1] == KIND_INSERTION, cand[_GAP][one], 0)
    ci, cnt, typ, a = chains[:4]
    off = emit.offsets(cnt)
    owner = np.repeat(np.arange(len(ci)), cnt)
    j = np.arange(len(typ)) - off[:-1][owner]
    is_m = typ == 0
    nxt = np.flatnonzero((typ == 1) & (ev[ci][owner] < 0))
    pre = np.where((j[nxt] > 0) & is_m[nxt - 1], a[nxt - 1], 0)
    has_post = j[nxt] + 1 < cnt[owner[nxt]]
    post_at = np.minimum(nxt + 1, max(len(typ) - 1, 0))
    post = np.where(has_post & is_m[post_at], a[post_at], 0)
    rows2 = ci[owner[nxt]]
    width = int(cnt.max(initial=0)) + 1
    key = np.concatenate([enc[one] * width, enc[rows2] * width + j[nxt]])
    evs = np.concatenate([e1, a[nxt]])
    left = np.concatenate([t[one], pre])
    right = np.concatenate([right1, post])
    mm = np.concatenate([cand[_MM][one], cand[_MM][rows2]])
    o = np.argsort(key, kind="stable")
    evs, left, right, mm = evs[o], left[o], right[o], mm[o]
    u, first, inv = np.unique(evs, return_index=True, return_inverse=True)
    inv = inv.reshape(-1)
    sup = np.bincount(inv, minlength=len(u))
    lext = np.zeros(len(u), np.int64)
    rext = np.zeros(len(u), np.int64)
    mn = np.full(len(u), 255, np.int64)
    np.maximum.at(lext, inv, left)
    np.maximum.at(rext, inv, right)
    np.minimum.at(mn, inv, mm)
    return {e: EventStats(*vals) for e, *vals in zip(
        *(x[np.argsort(first)].tolist() for x in (u, sup, lext, rext, mn)))}


def _next_of_read(gread: np.ndarray) -> np.ndarray:
    """Per record, the next record of the same read in table order (-1 for
    the read's last)."""
    n = len(gread)
    by_read = np.lexsort((np.arange(n), gread))
    nxt = np.full(n, -1, np.int64)
    same = gread[by_read[1:]] == gread[by_read[:-1]]
    nxt[by_read[:-1][same]] = by_read[1:][same]
    return nxt


def _fusion_tags(c, cid, local, genome, events) -> List[str]:
    """XF tags of a fusion record, or of a chain across a fusion, placed
    at contig cid, local position `local`."""
    tags = []
    fusion_ev = None
    if c.kind == KIND_FUSION:
        fusion_ev = c.ev
    elif c.kind == -2:
        fus_pos2 = None
        fus_dir = "ff"
        for op in c.chain_ops:
            if op[0] == "FUS":
                fus_pos2, fus_dir = op[1], op[2]
            elif (op[0] == "EV" and op[2] == KIND_FUSION
                  and fusion_ev is None):
                fusion_ev = op[1]
        if fus_pos2 is not None:
            rcid, rlocal = genome.global_to_contig(np.int64(fus_pos2))
            tags.append(f"XF:Z:{genome.names[cid]}-"
                        f"{genome.names[int(rcid)]} "
                        f"{local + 1} {int(rlocal) + 1} {fus_dir}")
    if fusion_ev is not None or (c.kind == KIND_FUSION and c.fpos2 >= 0):
        if fusion_ev is not None:
            pos2 = int(events["right"][fusion_ev])
            pos1 = int(events["left"][fusion_ev])
            fdir = "ff"
        else:
            pos2 = c.fpos2
            pos1 = c.pos + (c.t - 1 if c.fdir != "rf" else 0)
            fdir = c.fdir
        rcid, rlocal = genome.global_to_contig(np.int64(pos2))
        tags.append(f"XF:Z:{genome.names[cid]}-{genome.names[int(rcid)]} "
                    f"{pos1 - int(genome.offsets[cid]) + 1} "
                    f"{int(rlocal) + 1} {fdir}")
    return tags


def write_records(out_dir, genome, params, pool, part, cand, rl, nh, flag,
                  f, xs, mate_cid=None, mate_pos=None, tlen=None,
                  extras=None) -> bytes:
    """accepted_hits.sam of sorted records through the one emitter
    (io/emit.py); returns their BAM records' bytes. f: record_columns(...);
    xs: the XS byte a record (0: none); mate columns None: no mate."""
    n = len(rl)
    cols = np.empty((n, len(emit.COLUMNS)), np.int64)
    col = emit.COL
    cols[:, col["read"]], cols[:, col["seq"]] = pool.locate(part,
                                                            cand[_READ])
    cols[:, col["rl"]] = rl
    cols[:, col["flag"]] = flag
    cols[:, col["cid"]] = f["cid"]
    cols[:, col["pos"]] = f["local"]
    cols[:, col["mapq"]] = emit.mapq_column(
        nh, bool(getattr(params, "v2_sam", False)))
    cols[:, col["nm"]] = f["nm"]
    cols[:, col["nh"]] = nh
    cols[:, col["xs"]] = xs
    cols[:, col["mate_cid"]] = -1 if mate_cid is None else mate_cid
    cols[:, col["mate_pos"]] = -1 if mate_pos is None else mate_pos
    cols[:, col["tlen"]] = 0 if tlen is None else tlen
    sam, bam = emit.emit(pool, cols, f["cigar"], f["cig_off"], genome.names,
                         extras, getattr(params, "rg_id", ""))
    with open(os.path.join(out_dir, "accepted_hits.sam"), "wb") as fh:
        fh.write(sam)
    return bam


def _unmapped_blob(parts, part_flags):
    """Columnar encode of the unmapped reads of each part (its flag, no
    cigar or tags)."""
    from tophat_tpu_torch.io.bam import encode_records_columns

    names_b = []
    seq_list = []
    qual_list = []
    nq_list = []
    flags = []
    for (batch, selected), flag in zip(parts, part_flags):
        mapped = {r for r, clist in selected.items() if clist}
        L = batch.codes.shape[1]
        seq = emit.ascii_bases(batch.codes).tobytes()
        for r in range(batch.size):
            if r in mapped:
                continue
            rl = int(batch.lengths[r])
            names_b.append(batch.names[r].encode())
            seq_list.append(seq[r * L: r * L + rl])
            q = batch.quals[r][:rl]
            nq = q in (b"", b"*")
            nq_list.append(nq)
            qual_list.append(b"\x00" * rl if nq else q)
            flags.append(flag)
    n = len(names_b)
    z = np.zeros(n, np.int64)
    return encode_records_columns(
        names_b, np.asarray(flags, np.int64), np.full(n, -1, np.int64),
        np.full(n, -1, np.int64), z, z, np.zeros(0, np.uint32), z,
        seq_list, qual_list, np.asarray(nq_list, bool), [b""] * n)


def write_bam_outputs(out_dir, genome, parts, bam_blob,
                      skip_accepted=False, params=None, unmapped_flags=None):
    """accepted_hits.bam (coordinate-sorted, same order as the SAM) and
    unmapped.bam (reference output contract: SURVEY.md appendix);
    skip_accepted = --no-convert-bam (SAM only). bam_blob: pre-encoded
    record bytes from write_records; unmapped_flags: each part's flag for
    its unmapped reads (default: unmapped, unpaired)."""
    from tophat_tpu_torch.io.bam import BamWriter

    header = "\n".join(samio.header_lines(genome, params=params)) + "\n"
    lens = [int(x) for x in genome.contig_lengths()]
    if not skip_accepted:
        with trace.span("output.bam"):
            w = BamWriter(os.path.join(out_dir, "accepted_hits.bam"), header,
                          genome.names, lens)
            w.write_encoded(bam_blob)
            w.close()

    with trace.span("output.unmapped"):
        w = BamWriter(os.path.join(out_dir, "unmapped.bam"),
                      "\n".join(samio.header_lines(genome, "unsorted",
                                                   params=params)) + "\n",
                      genome.names, lens)
        if unmapped_flags is None:
            unmapped_flags = [samio.FLAG_UNMAPPED] * len(parts)
        w.write_encoded(_unmapped_blob(parts, unmapped_flags))
        w.close()


def _write_beds(out_dir, genome, events, stats: Dict[int, EventStats]):
    juncs, dels, ins = [], [], []
    for e, st in sorted(stats.items(),
                        key=lambda kv: (int(events["left"][kv[0]]),
                                        int(events["right"][kv[0]]))):
        kind = int(events["kind"][e])
        left = int(events["left"][e])
        right = int(events["right"][e])
        cid, l_local = genome.global_to_contig(np.int64(left))
        name = genome.names[int(cid)]
        off = int(genome.offsets[int(cid)])
        if kind == KIND_JUNCTION:
            juncs.append((name, left - off, right - off, st,
                          bool(events["antisense"][e])))
        elif kind == KIND_DELETION:
            dels.append((name, left - off, right - off, st))
        elif kind == KIND_INSERTION:
            seq = events["ins_seq"][e]
            s = "".join("ACGTN"[b] for b in seq if b >= 0)
            ins.append((name, left - off, st, s))

    with open(os.path.join(out_dir, "junctions.bed"), "w") as f:
        f.write('track name=junctions description="TopHat junctions"\n')
        for i, (name, l, r, st, anti) in enumerate(juncs, 1):
            lp1 = l + 1
            f.write("%s\t%d\t%d\tJUNC%08d\t%d\t%c\t%d\t%d\t255,0,0\t2\t"
                    "%d,%d\t0,%d\n" % (
                        name, lp1 - st.left_extent, r + st.right_extent, i,
                        st.supporting, "-" if anti else "+",
                        lp1 - st.left_extent, r + st.right_extent,
                        st.left_extent, st.right_extent,
                        r - (lp1 - st.left_extent)))
    with open(os.path.join(out_dir, "deletions.bed"), "w") as f:
        f.write('track name=deletions description="TopHat deletions"\n')
        for name, l, r, st in dels:
            f.write("%s\t%d\t%d\t-\t%d\n" % (name, l + 1, r, st.supporting))
    with open(os.path.join(out_dir, "insertions.bed"), "w") as f:
        # insertions print `left` raw; counts cap at 1000
        # (reference: insertions.cpp print_insertions)
        f.write('track name=insertions description="TopHat insertions"\n')
        for name, l, st, s in ins:
            f.write("%s\t%d\t%d\t%s\t%d\n" % (name, l, l, s,
                                              min(st.supporting, 1000)))
