"""Splice-junction and small-indel discovery over segment-hit pairs.

Port of tophat_tpu/ops/splice.py (the reference's segment_juncs
split-segment search, src/segment_juncs.cpp): every read works in genome
space (the read on strand +, its reverse complement on strand -),
candidate windows come from pairs of segment hits with an intron-sized
gap, and every split point of every window is scanned for GT-AG / GC-AG /
AT-AC motifs (and their reverse complements) under a 2-mismatch budget.
Fusion windows pair hits on different contigs or far apart and keep the
split with the fewest mismatches (no motif).

Event kinds unify junctions, deletions and insertions into one table:
  kind 0: junction  (left = last exonic base, right = first exonic base)
  kind 1: deletion  (same coordinates; right - left - 1 bases deleted)
  kind 2: insertion (left = last base before insert; seq = inserted bases)
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from tophat_tpu_torch.parallel import auto
from tophat_tpu_torch.utils import trace

LOOK_BP = 8       # anchor bases examined each side of a segment boundary
WINDOW_MM = 2     # split-point mismatch budget (segment_juncs.cpp:2265)

KIND_JUNCTION = 0
KIND_DELETION = 1
KIND_INSERTION = 2
KIND_FUSION = 3   # left on one locus, right on another (contig/strand/far)

BIG = 32767


@dataclasses.dataclass
class PairWindows:
    """Flat table of donor/acceptor scan windows (one per admissible segment
    hit pair). All tensors (W,)."""

    row: Any        # read-row (genome-space strand row) of the window
    gl: Any         # genome pos one past the left anchor hit's end
    gr: Any         # genome pos of the right anchor hit's start
    sup_start: Any  # support span start in the genome-space read
    sup_len: Any    # support span length
    valid: Any      # bool


def first_argmin(x, dim: int):
    """(min, leftmost index of the min) along `dim`."""
    best = x.min(dim=dim, keepdim=True).values
    idx = torch.arange(x.shape[dim], device=x.device).reshape(
        [-1 if d == dim % x.dim() else 1 for d in range(x.dim())])
    first = torch.where(x == best, idx, x.shape[dim]).min(dim=dim).values
    return best.squeeze(dim), first


def _end_cut(cuts, doff):
    """end_cut[:, j] = cuts[:, min(j + doff, S)] (partner's start boundary)."""
    parts = [cuts[:, doff:]]
    if doff > 1:
        parts.append(cuts[:, -1:].repeat(1, doff - 1))
    return torch.cat(parts, dim=1)


def _pairs_for_offset(seg_pos, seg_valid, cuts, nseg, doff,
                      min_gap, max_gap):
    """(left-hit, partner-hit) combos where the partner is the segment
    `doff` places to the right: the (R, S, H, H) mask of admissible
    combos, and a function that makes the PairWindows of the lanes a
    mask selects, in row-major lane order."""
    R, S, H = seg_pos.shape
    dev = seg_pos.device
    pl = seg_pos[:, :, :, None]                      # (R, S, H, 1) left hit
    vl = seg_valid[:, :, :, None]
    partner = torch.roll(seg_pos, -doff, dims=1)     # (R, S, H) partner hits
    pr = partner[:, :, None, :]
    vr = torch.roll(seg_valid, -doff, dims=1)[:, :, None, :]
    j = torch.arange(S, device=dev)[None, :, None, None]
    has_partner_seg = (j + doff) < nseg[:, None, None, None]

    llen = (cuts[:, 1:] - cuts[:, :-1])[:, :, None, None]   # left seg length
    left_end = pl + llen
    dist = pr - left_end
    ok = (vl & vr & has_partner_seg
          & (dist >= min_gap) & (dist < max_gap))

    # a contiguous next-segment partner suppresses all windows for this hit
    # (reference: found_right_seg_partner, segment_juncs.cpp:3531-3536)
    pr1 = torch.roll(seg_pos, -1, dims=1)[:, :, None, :]
    vr1 = torch.roll(seg_valid, -1, dims=1)[:, :, None, :]
    has_next = (j + 1) < nseg[:, None, None, None]
    contiguous = (vl & vr1 & has_next & (pr1 - left_end == 0)).any(
        dim=3, keepdim=True)
    ok &= ~contiguous
    end_cut = _end_cut(cuts, doff)

    def windows(mask):
        r, s, h, k = mask.nonzero(as_tuple=True)
        trace.note_sync(8)            # nonzero reads its count back
        # support span: [boundary_after_left - 8, partner_start_boundary + 8)
        sup_start = cuts[r, s + 1] - LOOK_BP
        return PairWindows(
            row=r, gl=seg_pos[r, s, h] + (cuts[r, s + 1] - cuts[r, s]),
            gr=partner[r, s, k], sup_start=sup_start,
            sup_len=end_cut[r, s] + LOOK_BP - sup_start,
            valid=torch.ones_like(r, dtype=torch.bool))

    return ok, windows


def build_pair_windows(seg_pos, seg_valid, cuts, nseg, lengths,
                       min_seg_intron: int, max_seg_intron: int,
                       segment_length: int):
    """The valid candidate windows of a batch: the valid lanes of the JAX
    package's flat (R*S*H*H) drs and rrs tables, in their order, with no
    table of all the lanes made (a read of 8 kb has 328 segments, so R*S*H*H
    lanes of five int64 fields took ~12 GB at 1,024 rows).

    seg_pos/seg_valid : (R, S, H) genome-space segment hit tables
    cuts              : (R, S+1) genome-space segment boundary offsets
    nseg              : (R,) segments per read
    lengths           : (R,) read lengths

    drs windows pair adjacent segments with gap in [min, max); rrs windows
    skip one (unmapped) segment with gap in [min+seg_len, max+seg_len).
    rrs windows take precedence when both exist for a left hit."""
    seg_pos = seg_pos.long()
    drs_ok, drs = _pairs_for_offset(seg_pos, seg_valid, cuts, nseg, 1,
                                    min_seg_intron, max_seg_intron)
    rrs_ok, rrs = _pairs_for_offset(seg_pos, seg_valid, cuts, nseg, 2,
                                    min_seg_intron + segment_length,
                                    max_seg_intron + segment_length)
    parts = (drs(drs_ok & ~rrs_ok.any(dim=3, keepdim=True)), rrs(rrs_ok))
    out = PairWindows(**{f.name: torch.cat([getattr(p, f.name)
                                            for p in parts])
                         for f in dataclasses.fields(PairWindows)})

    # clamp the support span to the read (reference substr semantics)
    rl = lengths[out.row]
    s0 = torch.minimum(out.sup_start.clamp(min=0), rl)
    s1 = torch.minimum((out.sup_start + out.sup_len).clamp(min=0), rl)
    out.sup_start = s0
    out.sup_len = s1 - s0
    return out


def _genome_window(genome, idx):
    """Genome codes at idx (any shape); out-of-genome positions read 5."""
    n = genome.shape[0]
    g = genome[idx.clamp(0, n - 1)]
    return torch.where((idx >= 0) & (idx < n), g, torch.tensor(
        5, dtype=genome.dtype, device=genome.device))


def _mismatch(g, r):
    return (g != r) | (g >= 4) | (r >= 4)


def _suffix_cumsum(x):
    """cumsum from the right along dim 1."""
    return torch.flip(torch.cumsum(torch.flip(x.long(), [1]), 1), [1])


def _scan_windows(genome, readsg, win: PairWindows, sup_max: int):
    """Scan every split point of every window for donor/acceptor pairs.

    Returns (left, right, antisense, valid), each (W, sup_max): junction
    left/right in the TopHat convention (last exonic base, first exonic
    base). Split i is admissible when prefix(support[:i]) anchored at the
    window start plus suffix(support[i:]) anchored at the window end have
    <= 2 mismatches and the dinucleotides at both ends of the implied
    intron are GT..AG / GC..AG / AT..AC (forward) or their reverse
    complements."""
    n = genome.shape[0]
    W = win.row.shape[0]
    dev = genome.device
    t = torch.arange(sup_max, device=dev)[None, :]

    sup_idx = win.sup_start[:, None] + t
    in_sup = t < win.sup_len[:, None]
    support = readsg[win.row[:, None], sup_idx.clamp(0, readsg.shape[1] - 1)]
    support = torch.where(in_sup, support, torch.tensor(
        -1, dtype=support.dtype, device=dev))

    wl = win.gl[:, None] - LOOK_BP          # window start (prefix anchor)
    wr = win.gr[:, None] + LOOK_BP          # window end (suffix anchor)

    gl_codes = _genome_window(genome, wl + t)
    pref_mm = torch.cumsum((_mismatch(gl_codes, support) & in_sup).long(), 1)
    gr_codes = _genome_window(genome, wr - win.sup_len[:, None] + t)
    suf_mm_rev = _suffix_cumsum(_mismatch(gr_codes, support) & in_sup)

    # split at i: prefix [0, i), suffix [i, end)
    pref_before = torch.cat([pref_mm.new_zeros((W, 1)), pref_mm[:, :-1]],
                            dim=1)
    budget_ok = (pref_before + suf_mm_rev) <= WINDOW_MM

    # dinucleotides: donor side at window-start + i, acceptor side at the
    # suffix-anchored position
    dpos = wl + t
    apos = wr - (win.sup_len[:, None] - t) - 2
    g1 = genome[dpos.clamp(0, n - 1)]
    g2 = genome[(dpos + 1).clamp(0, n - 1)]
    a1 = genome[apos.clamp(0, n - 1)]
    a2 = genome[(apos + 1).clamp(0, n - 1)]
    dinuc_ok = (dpos >= 0) & (dpos + 1 < n) & (apos >= 0) & (apos + 1 < n)

    # A=0 C=1 G=2 T=3
    fwd = (((g1 == 2) & (g2 == 3) & (a1 == 0) & (a2 == 2))    # GT..AG
           | ((g1 == 2) & (g2 == 1) & (a1 == 0) & (a2 == 2))  # GC..AG
           | ((g1 == 0) & (g2 == 3) & (a1 == 0) & (a2 == 1)))  # AT..AC
    rev = (((g1 == 1) & (g2 == 3) & (a1 == 0) & (a2 == 1))    # CT..AC
           | ((g1 == 1) & (g2 == 3) & (a1 == 2) & (a2 == 1))  # CT..GC
           | ((g1 == 2) & (g2 == 3) & (a1 == 0) & (a2 == 3)))  # GT..AT

    scan_ok = in_sup & (t <= win.sup_len[:, None] - 2)  # i <= read_len - 2
    valid = (win.valid[:, None] & scan_ok & budget_ok & dinuc_ok
             & (fwd | rev) & (apos > dpos))
    return dpos - 1, apos + 2, rev, valid


def _window_sharded(scan, genome, readsg, win: PairWindows, sup_max: int):
    """`scan` with the window rows sharded over the active mesh's reads
    axis (parallel/auto.py): genome and genome-space reads replicated,
    the flat window table split across devices like the reference's
    read-range thread partition (segment_juncs.cpp:4763)."""
    return auto.by_rows(lambda dev, w: scan(
        auto.replicated(genome, dev), readsg.to(dev), w, sup_max), win)


def scan_windows(genome, readsg, win: PairWindows, sup_max: int):
    return _window_sharded(_scan_windows, genome, readsg, win, sup_max)


def _fusion_pairs_for_offset(seg_pos, seg_valid, cuts, nseg, offsets,
                             fusion_min_dist, doff):
    """Same-row hit pairs (partner `doff` segments to the right) placed on
    different contigs or >= fusion_min_dist apart. Flat (R*S*H*H,)."""
    R, S, H = seg_pos.shape
    dev = seg_pos.device
    pl = seg_pos[:, :, :, None]
    vl = seg_valid[:, :, :, None]
    pr = torch.roll(seg_pos, -doff, dims=1)[:, :, None, :]
    vr = torch.roll(seg_valid, -doff, dims=1)[:, :, None, :]
    j = torch.arange(S, device=dev)[None, :, None, None]
    has_partner = (j + doff) < nseg[:, None, None, None]

    llen = (cuts[:, 1:] - cuts[:, :-1])[:, :, None, None]
    left_end = pl + llen
    cid_l = torch.searchsorted(offsets, pl.contiguous(), right=True)
    cid_r = torch.searchsorted(offsets, pr.contiguous(), right=True)
    fusionish = ((cid_l != cid_r)
                 | ((pr - left_end).abs() >= fusion_min_dist))
    ok = vl & vr & has_partner & fusionish

    rowi = torch.arange(R, device=dev)[:, None, None, None]
    sup_start = cuts[:, 1:][:, :, None, None] - LOOK_BP
    sup_end = _end_cut(cuts, doff)[:, :, None, None] + LOOK_BP

    flat = lambda a: a.expand(ok.shape).reshape(-1)
    return PairWindows(
        row=flat(rowi), gl=flat(left_end), gr=flat(pr),
        sup_start=flat(sup_start), sup_len=flat(sup_end - sup_start),
        valid=ok.reshape(-1))


def build_fusion_windows(seg_pos, seg_valid, cuts, nseg, lengths, offsets,
                         fusion_min_dist: int):
    """Candidate fusion windows: same-row segment-hit pairs (adjacent, or
    skipping one unmapped break-spanning segment) whose placements are on
    different contigs or >= fusion_min_dist apart on the same contig
    (reference: detect_fusion gating, segment_juncs.cpp:3288). FF
    orientation only; FR/RF come from ops/fusion_fr.py. `offsets` are the
    contig start offsets (numpy or tensor)."""
    seg_pos = seg_pos.long()
    offsets = torch.as_tensor(offsets, device=seg_pos.device).long()
    parts = [_fusion_pairs_for_offset(seg_pos, seg_valid, cuts, nseg,
                                      offsets, fusion_min_dist, doff)
             for doff in (1, 2)]
    win = PairWindows(**{f.name: torch.cat([getattr(p, f.name)
                                            for p in parts])
                         for f in dataclasses.fields(PairWindows)})
    rl = lengths[win.row]
    s0 = torch.minimum(win.sup_start.clamp(min=0), rl)
    s1 = torch.minimum((win.sup_start + win.sup_len).clamp(min=0), rl)
    win.sup_start = s0
    win.sup_len = s1 - s0
    return win


def _scan_fusion_windows(genome, readsg, win: PairWindows, sup_max: int):
    """Best breakpoint per fusion window: the leftmost split minimizing the
    support span's mismatches against the left-anchored and right-anchored
    genome windows (no splice motif: detect_fusion scans every split,
    segment_juncs.cpp:2629). Returns per-window (left, right, best_mm,
    valid)."""
    W = win.row.shape[0]
    dev = genome.device
    t = torch.arange(sup_max, device=dev)[None, :]

    sup_idx = win.sup_start[:, None] + t
    in_sup = t < win.sup_len[:, None]
    support = readsg[win.row[:, None], sup_idx.clamp(0, readsg.shape[1] - 1)]
    support = torch.where(in_sup, support, torch.tensor(
        -1, dtype=support.dtype, device=dev))

    wl = win.gl[:, None] - LOOK_BP
    wr = win.gr[:, None] + LOOK_BP
    gl_codes = _genome_window(genome, wl + t)
    pref_mm = torch.cumsum((_mismatch(gl_codes, support) & in_sup).long(), 1)
    gr_codes = _genome_window(genome, wr - win.sup_len[:, None] + t)
    suf_mm = _suffix_cumsum(_mismatch(gr_codes, support) & in_sup)
    pref_before = torch.cat([pref_mm.new_zeros((W, 1)), pref_mm[:, :-1]],
                            dim=1)

    errs = torch.where(in_sup & (t >= 1), pref_before + suf_mm, BIG)
    best, best_t = first_argmin(errs, 1)
    left = wl[:, 0] + best_t - 1
    right = wr[:, 0] - (win.sup_len - best_t)
    return left, right, best, win.valid & (best <= WINDOW_MM)


def scan_fusion_windows(genome, readsg, win: PairWindows, sup_max: int):
    return _window_sharded(_scan_fusion_windows, genome, readsg, win,
                           sup_max)


def compact_by_valid(valid, arrays, cap: int):
    """Stable-partition `arrays` so valid rows come first; keep `cap` rows.
    Returns (compacted_arrays, compacted_valid, overflowed). Slots past the
    valid count are zero."""
    valid = valid.reshape(-1)
    dev = valid.device
    csum = torch.cumsum(valid.long(), 0)
    nvalid = int(trace.to_host(csum[-1])) if csum.numel() else 0
    keep = valid & (csum <= cap)
    slot = (csum - 1)[keep]
    # each boolean-mask index reads its count back
    trace.note_sync(8)
    out = []
    for a in arrays:
        a = a.reshape(valid.shape[0], *a.shape[1:])
        o = torch.zeros((cap,) + tuple(a.shape[1:]), dtype=a.dtype,
                        device=dev)
        o[slot] = a[keep]
        trace.note_sync(8)
        out.append(o)
    cvalid = torch.arange(cap, device=dev) < min(nvalid, cap)
    return out, cvalid, nvalid > cap


def compact_windows(win: PairWindows, cap: int):
    arrays, valid, overflow = compact_by_valid(
        win.valid, [win.row, win.gl, win.gr, win.sup_start, win.sup_len], cap)
    return PairWindows(row=arrays[0], gl=arrays[1], gr=arrays[2],
                       sup_start=arrays[3], sup_len=arrays[4],
                       valid=valid), overflow


def compact_scan_hits(left, right, rev, valid, win_row, cap: int):
    """Compact the (W, sup_max) scan grids to flat (cap,) hit lists
    (left, right, rev, row, count, overflow)."""
    W, T = valid.shape
    rows = win_row[:, None].expand(W, T)
    (l, r, v, rw), cvalid, ovf = compact_by_valid(
        valid.reshape(-1),
        [left.reshape(-1), right.reshape(-1), rev.reshape(-1),
         rows.reshape(-1)], cap)
    return l, r, v, rw, int(trace.to_host(cvalid.sum())), ovf


def build_indel_pairs(seg_pos, seg_mm, seg_valid, cuts, nseg,
                      max_deletion: int, max_insertion: int, cap: int):
    """Adjacent same-strand segment-hit pairs whose genomic extent differs
    from the 2-segment read span by a small amount (the indel gating of
    reference segment_juncs.cpp:2921-2938). Output compacted to `cap` rows:
    dict of (cap,) tensors row, pl, right_end, span, disc, c0, segs_mm,
    valid; plus the overflow flag."""
    R, S, H = seg_pos.shape
    dev = seg_pos.device
    seg_pos = seg_pos.long()
    seg_mm = seg_mm.long()

    pl = seg_pos[:, :, :, None]
    vl = seg_valid[:, :, :, None]
    ml = seg_mm[:, :, :, None]
    pr = torch.roll(seg_pos, -1, dims=1)[:, :, None, :]
    vr = torch.roll(seg_valid, -1, dims=1)[:, :, None, :]
    mr = torch.roll(seg_mm, -1, dims=1)[:, :, None, :]
    j = torch.arange(S, device=dev)[None, :, None, None]
    has_partner = (j + 1) < nseg[:, None, None, None]

    c0 = cuts[:, :-1][:, :, None, None]                 # pair span start
    c2 = torch.roll(cuts, -2, dims=1)[:, :S][:, :, None, None]  # span end
    span = c2 - c0                                       # 2-seg read length
    c1 = torch.roll(cuts, -1, dims=1)[:, :S][:, :, None, None]
    right_end = pr + (c2 - c1)
    disc = right_end - pl - span                         # length discrepancy

    pair_ok = vl & vr & has_partner
    indel_ok = pair_ok & (
        ((disc > 0) & (disc <= max_deletion))
        | ((disc < 0) & (disc >= -max_insertion)))

    shape = (R, S, H, H)
    flat = lambda a: a.expand(shape).reshape(-1)
    rowf = torch.arange(R, device=dev)[:, None, None, None]
    arrays, valid, overflow = compact_by_valid(
        indel_ok.reshape(-1),
        [flat(rowf), flat(pl), flat(right_end), flat(span), flat(disc),
         flat(c0), flat(ml + mr)], cap)
    return dict(row=arrays[0], pl=arrays[1], right_end=arrays[2],
                span=arrays[3], disc=arrays[4], c0=arrays[5],
                segs_mm=arrays[6], valid=valid), overflow


def _scan_indel_pairs(genome, readsg, lengths, pairs, two_seg_max: int):
    """detect_small_deletion / detect_small_insertion semantics
    (reference: segment_juncs.cpp:2470-2628).

    For a pair with discrepancy d: d>0 -> deletion of d bases, d<0 ->
    insertion of |d| read bases. The event position is the leftmost split
    minimizing mismatches of the 2-segment read portion against the
    left-anchored and right-anchored genome windows; kept only if that
    minimum improves on the segment alignments' own mismatch total
    (strictly, when the two segments cover the whole read).

    Returns per-pair: kind, left, right, ins_len, valid, best_t, row,
    ins_read_off (all (P,))."""
    dev = genome.device
    rowf = pairs["row"]
    plf = pairs["pl"]
    ref_ = pairs["right_end"]
    spanf = pairs["span"]
    discf = pairs["disc"]
    c0f = pairs["c0"]
    segs_mm = pairs["segs_mm"]
    pvalid = pairs["valid"]
    P = rowf.shape[0]
    del_okf = pvalid & (discf > 0)
    ins_okf = pvalid & (discf < 0)

    T = two_seg_max + 1
    t = torch.arange(T, device=dev)[None, :]
    ar = torch.arange(two_seg_max, device=dev)[None, :]

    # the 2-segment read portion, genome space
    ridx = c0f[:, None] + ar
    in_span = ar < spanf[:, None]
    rseq = readsg[rowf[:, None], ridx.clamp(0, readsg.shape[1] - 1)]
    rseq = torch.where(in_span, rseq, torch.tensor(
        -1, dtype=rseq.dtype, device=dev))

    gL = _genome_window(genome, plf[:, None] + ar)
    pref_mm = torch.cumsum((_mismatch(gL, rseq) & in_span).long(), 1)
    # pref_before[t] = mismatches in read[0:t); width T so t may reach span
    pref_before = torch.cat([pref_mm.new_zeros((P, 1)), pref_mm], dim=1)

    gR = _genome_window(genome, ref_[:, None] - spanf[:, None] + ar)
    suf_mm = _suffix_cumsum(_mismatch(gR, rseq) & in_span)
    # suf_mm[t] = mismatches in read[t:span); extend so t may reach span
    suf_mm = torch.cat([suf_mm, suf_mm.new_zeros((P, 1))], dim=1)

    # deletion: split t in [0, span]; insertion: genome prefix [0, g) vs
    # the read start, suffix [g - disc, span) right-anchored
    errs_del = pref_before[:, :T] + torch.where(
        t <= spanf[:, None], suf_mm[:, :T], BIG)
    suf_at = (t - discf[:, None]).clamp(0, two_seg_max)
    errs_ins = pref_before[:, :T] + torch.where(
        (t - discf[:, None]) <= spanf[:, None],
        torch.gather(suf_mm, 1, suf_at), BIG)
    glen = spanf + discf  # genomic length for insertions
    errs_ins = torch.where(t <= glen[:, None], errs_ins, BIG)
    errs_del = torch.where(t <= spanf[:, None], errs_del, BIG)

    errs = torch.where(del_okf[:, None], errs_del,
                       torch.where(ins_okf[:, None], errs_ins, BIG))
    best_err, best_t = first_argmin(errs, 1)

    # improvement gating (reference: segment_juncs.cpp:2527-2538, 2608-2619)
    covers_whole = spanf >= lengths[rowf]
    adjustment = torch.where(covers_whole, -1, 0)
    improved = best_err <= (segs_mm + adjustment)
    # insertion extra guard: bestInsertPosition + |disc| <= genomic length
    ins_guard = (best_t - discf) <= (spanf + discf)

    kind = torch.where(del_okf, KIND_DELETION, KIND_INSERTION).to(torch.int8)
    left = plf + best_t - 1
    right = torch.where(del_okf, plf + best_t + discf, left + 1)
    ins_len = torch.where(ins_okf, -discf, 0).to(torch.int8)
    valid = (del_okf | (ins_okf & ins_guard)) & improved
    # inserted read bases start at read offset c0 + best_t in genome space
    ins_read_off = c0f + best_t
    return kind, left, right, ins_len, valid, best_t, rowf, ins_read_off


def scan_indel_pairs(genome, readsg, lengths, pairs, two_seg_max: int):
    """_scan_indel_pairs with the pair rows sharded over the active mesh
    (parallel/auto.py); genome, reads and lengths replicated."""
    return auto.by_rows(lambda dev, p: _scan_indel_pairs(
        auto.replicated(genome, dev), readsg.to(dev), lengths.to(dev), p,
        two_seg_max), pairs)
