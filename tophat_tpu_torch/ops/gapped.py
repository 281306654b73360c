"""Bowtie2-mode gapped initial alignment.

Port of tophat_tpu/ops/gapped.py. The reference's default aligner is
bowtie2 end-to-end `-k` with a driver-computed score floor:
`--score-min C,-(mp_max*edit_dist + 2),0` with mp = 6,2 / rdg = rfg = 5,3
(reference: src/tophat.py:2328-2339, option assembly :2246-2353). Reads
carrying one small indel align DIRECTLY, without the segment pipeline.

For every unaligned read and every seed candidate q, one compare tensor
over diagonal shifts s in [-g, g] yields prefix/suffix mismatch cumsums for
ALL placements with one gap: a deletion of d genome bases with anchor
a = q + s0 costs pref[s0][t] + suf[s0 + d][t]; an insertion of i read bases
costs pref[s0][t] + suf_from[t + i][s0 - i]. Scoring follows bowtie2:
6*mm + 5 + 3*gap <= 6*read_edit_dist + 2.

The scan is plain torch on the genome's device (XLA in the JAX package,
not Pallas). The result feeds the pipeline as (a) novel indel EVENTS and
(b) direct read candidates that bypass the segment-path admission; the
host loop over the passing placements reads the scan's results through
one counted read each (utils/trace.to_host).
"""

from __future__ import annotations

import numpy as np
import torch

from tophat_tpu_torch.ops.events import MAX_INS
from tophat_tpu_torch.ops.splice import (KIND_DELETION, KIND_INSERTION,
                                         first_argmin)
from tophat_tpu_torch.utils import trace

BIG = 32767
MAX_CAND = 8


def gapped_scan(genome, reads, lengths, cand, cand_valid, floor,
                max_gap: int, mp_max: int = 6, rdg_open: int = 5,
                rdg_ext: int = 3, rfg_open: int = 5, rfg_ext: int = 3):
    """Best single-gap alignment per (read, candidate anchor).

    genome (n,) int8; reads (B, L) genome-space codes; lengths (B,);
    cand (B, C) candidate window starts; cand_valid (B, C) bool; floor (B,)
    per-read penalty budget (-score_min); all on one device. Returns per
    (read, candidate), each (B, C):
      (pos, t, gap, mm, pen, ok) int32 (ok bool) — gap > 0 deletion of gap
    genome bases after read prefix t; gap < 0 insertion of -gap read bases
    at t; penalty mp_max*mm + rdg(d) or rfg(i) <= floor, leftmost-best
    (pen is BIG where not ok)."""
    n = genome.shape[0]
    B, L = reads.shape
    C = cand.shape[1]
    g = max_gap
    S = 2 * g + 1                              # diagonal shifts -g..g
    dev = genome.device
    u = torch.arange(L, device=dev)
    lengths = lengths.long()

    # compare tensor: bad[b, c, s, u] = read[b,u] vs genome[cand+s-g+u]; the
    # clamp + mask keeps every gather in range (a CUDA index out of range is
    # a device assert)
    shifts = torch.arange(-g, g + 1, device=dev)
    gidx = (cand.long()[:, :, None, None] + shifts[None, None, :, None]
            + u[None, None, None, :])
    gv = torch.where((gidx >= 0) & (gidx < n),
                     genome[gidx.clamp(0, n - 1)],
                     torch.tensor(5, dtype=genome.dtype, device=dev))
    r = reads[:, None, None, :]
    in_read = u[None, None, None, :] < lengths[:, None, None, None]
    bad = ((gv != r) | (gv >= 4) | (r >= 4) | (r < 0)) & in_read

    zero = torch.zeros((B, C, S, 1), dtype=torch.int32, device=dev)
    pref = torch.cumsum(bad, dim=3, dtype=torch.int32)   # mm in read[0..u]
    pref_before = torch.cat([zero, pref[..., :-1]], dim=3)  # mm in [0, t)
    suf = torch.flip(torch.cumsum(torch.flip(bad, [3]), dim=3,
                                  dtype=torch.int32), [3])  # mm in read[u:)
    suf = torch.cat([suf, zero], dim=3)                   # (B, C, S, L + 1)

    t = u[None, None, :]
    big = torch.tensor(BIG, dtype=torch.int32, device=dev)
    best_pen = torch.full((B, C), BIG, dtype=torch.int32, device=dev)
    best_t = torch.zeros((B, C), dtype=torch.int32, device=dev)
    best_gap = torch.zeros((B, C), dtype=torch.int32, device=dev)
    best_mm = torch.zeros((B, C), dtype=torch.int32, device=dev)
    best_s0 = torch.zeros((B, C), dtype=torch.int32, device=dev)

    def consider(pen_t, d, s0, mm_t):
        nonlocal best_pen, best_t, best_gap, best_mm, best_s0
        pen, tmin = first_argmin(pen_t, 2)
        mmv = torch.gather(mm_t, 2, tmin[:, :, None])[:, :, 0]
        better = pen < best_pen
        best_pen = torch.where(better, pen, best_pen)
        best_t = torch.where(better, tmin.int(), best_t)
        best_gap = torch.where(better, d, best_gap)
        best_mm = torch.where(better, mmv, best_mm)
        best_s0 = torch.where(better, s0, best_s0)

    interior = (t >= 1) & (t <= lengths[:, None, None] - 1)
    for s0 in range(-g, g + 1):
        # deletions: suffix diagonal s0 + d
        for d in range(1, g + 1):
            if not (-g <= s0 + d <= g):
                continue
            mm_t = (pref_before[:, :, s0 + g, :]
                    + suf[:, :, s0 + d + g, :L])
            pen_t = torch.where(interior,
                                mp_max * mm_t + rdg_open + rdg_ext * d, big)
            consider(pen_t, d, s0, mm_t)
        # insertions: suffix starts at read index t + i, diagonal s0 - i
        for i in range(1, g + 1):
            if not (-g <= s0 - i <= g):
                continue
            suf_at = (t + i).clamp(0, L).expand(B, C, L)
            sfi = torch.gather(suf[:, :, s0 - i + g, :], 2, suf_at)
            mm_t = pref_before[:, :, s0 + g, :] + sfi
            ins_ok = interior & (t + i <= lengths[:, None, None] - 1)
            pen_t = torch.where(ins_ok,
                                mp_max * mm_t + rfg_open + rfg_ext * i, big)
            consider(pen_t, -i, s0, mm_t)

    ok = cand_valid & (best_pen <= floor[:, None])
    pos = cand.int() + best_s0
    # PER-CANDIDATE results: every passing anchor reports its best placement
    # (the bowtie2 `-k` multi-hit contract, src/tophat.py:2286-2353)
    return pos, best_t, best_gap, best_mm, torch.where(ok, best_pen, big), ok


def b2_score_model(params):
    """Parse the --b2-* tuning surface into (mp_max, rdg, rfg,
    floor_fn(read_len) -> penalty budget). Defaults are the reference
    driver's: mp 6,2 / rdg 5,3 / rfg 5,3 and score-min
    C,-(mp_max*edit+2),0 (src/tophat.py:2328-2339)."""
    def pair(s, d):
        try:
            a, b = str(s).split(",")[:2]
            return int(a), int(b)
        except (ValueError, AttributeError):
            return d

    mp_max, _mp_min = pair(getattr(params, "b2_mp", "6,2"), (6, 2))
    rdg = pair(getattr(params, "b2_rdg", "5,3"), (5, 3))
    rfg = pair(getattr(params, "b2_rfg", "5,3"), (5, 3))
    smin = getattr(params, "b2_score_min", "") or ""
    if smin:
        # bowtie2 function string: C,a[,b] constant / L,a,b linear in
        # read length; the floor is the negated minimum score
        parts = smin.split(",")
        kind = parts[0].strip().upper()
        a = float(parts[1]) if len(parts) > 1 else 0.0
        b = float(parts[2]) if len(parts) > 2 else 0.0
        if kind == "L":
            floor_fn = lambda rl: -(a + b * rl)
        else:                     # C (S/G unsupported -> constant)
            floor_fn = lambda rl: -a
    else:
        edit = params.read_edit_dist
        floor_fn = lambda rl: mp_max * edit + 2
    return mp_max, rdg, rfg, floor_fn


def gapped_from_segments(genome_codes, gs, seg_tables, params,
                         offsets=None):
    """Bowtie2-mode direct gapped alignment of the IUM rows, seeded by the
    ungapped segment hits (the role of bowtie2's own seed-and-extend; the
    score contract is the driver's, reference src/tophat.py:2253-2259).

    genome_codes: the genome tensor (the scan runs on its device);
    seg_tables: the (rows, S, H) segment tables (device tensors or numpy).
    Multi-hit: every passing seed anchor contributes its best placement
    (deduped by (pos, t, gap)), up to MAX_CAND per row — the bowtie2 `-k`
    contract. offsets: contig offset table — placements that leave the
    genome or span a contig boundary are dropped.

    Returns (events, results): `events` is an event-table dict of the
    novel indels found; `results` is a list of (row, pos, t, gap, mm,
    ev_key) with ev_key = (kind, left, right) for looking the merged event
    index back up in candidates_for_mate."""
    seg_pos, seg_mm, seg_valid = (trace.to_host(a) for a in seg_tables[:3])
    rows = gs.rows
    if rows == 0:
        return None, []
    S = seg_pos.shape[1]
    # candidate window start implied by each segment hit: hit - cut offset
    anchors = (seg_pos - gs.cuts[:, :S, None]).reshape(rows, -1)
    amm = np.broadcast_to(seg_mm, seg_pos.shape).reshape(rows, -1)
    avalid = seg_valid.reshape(rows, -1) & (gs.read_idx >= 0)[:, None]
    if not avalid.any():
        return None, []

    # unique anchors per row, best segment quality first: sort lanes by
    # (anchor, mm) and keep the first of each anchor run (min mm), then
    # re-rank survivors by (mm, anchor) and take the MAX_CAND best
    W = anchors.shape[1]
    a64 = anchors.astype(np.int64) + (1 << 31)
    m64 = np.clip(amm.astype(np.int64), 0, 255)
    key1 = np.where(avalid, (a64 << 16) | m64, np.int64(1) << 62)
    order1 = np.argsort(key1, axis=1, kind="stable")
    a_s = np.take_along_axis(anchors, order1, axis=1)
    m_s = np.take_along_axis(amm, order1, axis=1)
    v_s = np.take_along_axis(avalid, order1, axis=1)
    first = np.ones((rows, W), bool)
    first[:, 1:] = a_s[:, 1:] != a_s[:, :-1]
    v_u = v_s & first
    key2 = np.where(
        v_u, (np.clip(m_s.astype(np.int64), 0, 255) << 33)
        | (a_s.astype(np.int64) + (1 << 31)), np.int64(1) << 62)
    order2 = np.argsort(key2, axis=1, kind="stable")[:, :MAX_CAND]
    cand = np.take_along_axis(a_s, order2, axis=1).astype(np.int32)
    cvalid = np.take_along_axis(v_u, order2, axis=1)
    if not cvalid.any():
        return None, []

    # cap the scan's diagonal window at MAX_INS: an insertion wider than
    # the event-table slot cannot be represented
    g = max(1, min(params.read_gap_length,
                   max(params.max_deletion_length,
                       min(params.max_insertion_length, MAX_INS))))
    mp_max, rdg, rfg, floor_fn = b2_score_model(params)
    floor = np.array([floor_fn(int(l)) for l in gs.lengths], np.int32)
    dev = genome_codes.device
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    pos, t, gap, mm, _pen, ok = (trace.to_host(x) for x in gapped_scan(
        genome_codes, put(gs.readsg), put(gs.lengths), put(cand),
        put(cvalid), put(floor), max_gap=g, mp_max=mp_max,
        rdg_open=rdg[0], rdg_ext=rdg[1], rfg_open=rfg[0], rfg_ext=rfg[1]))

    glen = int(genome_codes.shape[0])
    off = np.asarray(offsets) if offsets is not None else None
    ev_left, ev_right, ev_kind = [], [], []
    ev_ilen, ev_iseq = [], []
    results = []
    seen = set()
    for r, c in zip(*np.nonzero(ok)):
        r, c = int(r), int(c)
        if int(gs.read_idx[r]) < 0:     # pow2 padding row
            continue
        gp, tt, p0 = int(gap[r, c]), int(t[r, c]), int(pos[r, c])
        if gp == 0:
            continue                    # pure-mismatch placement: the
        #                                 ungapped aligner's domain
        if (r, p0, tt, gp) in seen:     # same placement via another seed
            continue
        seen.add((r, p0, tt, gp))
        rl = int(gs.lengths[r])
        span = rl + gp                  # genome bases consumed
        if p0 < 0 or p0 + span > glen:
            continue                    # out-of-genome placement
        if gp > 0:
            if gp > params.max_deletion_length:
                continue
            left, right = p0 + tt - 1, p0 + tt + gp
            if off is not None and (np.searchsorted(off, left, "right")
                                    != np.searchsorted(off, right, "right")):
                continue                # cross-contig "deletion"
            kind, ilen = KIND_DELETION, 0
            iseq = np.full(MAX_INS, -1, np.int8)
        else:
            if -gp > min(params.max_insertion_length, MAX_INS):
                continue
            left, right = p0 + tt - 1, p0 + tt
            kind, ilen = KIND_INSERTION, -gp
            iseq = np.full(MAX_INS, -1, np.int8)
            iseq[:ilen] = gs.readsg[r, tt:tt + ilen]
        if off is not None and (np.searchsorted(off, p0, "right")
                                != np.searchsorted(off, p0 + span - 1,
                                                   "right")):
            continue                    # placement spans a contig boundary
        ev_left.append(left)
        ev_right.append(right)
        ev_kind.append(kind)
        ev_ilen.append(ilen)
        ev_iseq.append(iseq)
        results.append((int(r), p0, tt, gp, int(mm[r, c]),
                        (int(kind), left, right)))
    if not results:
        return None, []
    events = dict(left=np.array(ev_left, np.int32),
                  right=np.array(ev_right, np.int32),
                  kind=np.array(ev_kind, np.int8),
                  antisense=np.zeros(len(ev_left), bool),
                  ins_len=np.array(ev_ilen, np.int8),
                  ins_seq=np.stack(ev_iseq))
    return events, results
