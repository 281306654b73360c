"""Half-split + k-mer-variant full-sensitivity short-segment alignment.

Port of tophat_tpu/ops/beam.py (see its docstring for the search plan):
exact half seeds by backward search, split-pair (one mismatch per half)
variants by k-mer-table key arithmetic, every family's occurrences laid out
as back-to-back runs in a per-row candidate grid, resolved through the SA
and verified as the full segment against the word-packed genome. The
plan's caps (beam_plan) are identical, so the same lanes survive.

Sensitivity contract: for max_mismatches <= 2 every placement is found
for rows with length >= kmer_k + 2; shorter rows keep same-half-only
sensitivity.
"""

from __future__ import annotations

import numpy as np
import torch

from tophat_tpu_torch.ops.search import backward_search, resolve_sa
from tophat_tpu_torch.ops.verify import (count_mismatches_packed, pack_reads,
                                         same_contig)
from tophat_tpu_torch.parallel import auto
from tophat_tpu_torch.utils import trace

MIN_BEAM_LEN = 10   # shortest row the half-split handles sensibly


def _compact(valid, K, vals):
    """Keep the first K valid lanes in lane order via cumsum + scatter.
    vals: list of (tensor, fill). Returns (compacted_list, dropped_mask
    aligned with valid)."""
    csum = torch.cumsum(valid.long(), 0)
    keep = valid & (csum <= K)
    slot = (csum - 1)[keep]
    # each boolean-mask index reads its count back
    trace.note_sync(8)
    outs = []
    for v, fill in vals:
        o = torch.full((K,), fill, dtype=v.dtype, device=v.device)
        o[slot] = v[keep]
        trace.note_sync(8)
        outs.append(o)
    return outs, valid & ~keep


def _pack_rows(seg, pos, mm, B: int, max_hits: int):
    """Flat verified hits -> (B, max_hits) tables sorted by pos with
    exact (row, pos) duplicates dropped. seg == B marks dead lanes."""
    dev = seg.device
    R = seg.shape[0]
    order = torch.sort((seg << 32) | pos, stable=True).indices
    s_seg, s_pos, s_mm = seg[order], pos[order], mm[order]
    dup = torch.zeros(R, dtype=torch.bool, device=dev)
    dup[1:] = (s_seg[1:] == s_seg[:-1]) & (s_pos[1:] == s_pos[:-1])
    keep = (s_seg < B) & ~dup
    P = torch.cat([keep.new_zeros(1, dtype=torch.long),
                   torch.cumsum(keep.long(), 0)])
    first = torch.searchsorted(s_seg.contiguous(), s_seg.contiguous())
    slot = P[:R] - P[first]          # kept lanes before i in i's row
    ok = keep & (slot < max_hits)
    row_i, col_i = s_seg[ok], slot[ok]
    pos_t = torch.zeros((B, max_hits), dtype=torch.int32, device=dev)
    mm_t = torch.zeros((B, max_hits), dtype=torch.int8, device=dev)
    val_t = torch.zeros((B, max_hits), dtype=torch.bool, device=dev)
    pos_t[row_i, col_i] = s_pos[ok].int()
    mm_t[row_i, col_i] = s_mm[ok].to(torch.int8)
    val_t[row_i, col_i] = True
    for _ in range(4):      # each boolean-mask index above reads its count
        trace.note_sync(8)
    n_hits = torch.zeros(B, dtype=torch.int32, device=dev)
    n_hits.index_add_(0, s_seg.clamp(0, B - 1), keep.int())
    return pos_t, mm_t, val_t, n_hits


def _variant_intervals(fm, rows, lengths, h, seg_ok, *, K: int, nsw: int,
                       h_max: int, pa_cap: int, pb_cap: int):
    """SA intervals of every enumerated window variant, via k-mer-table
    key arithmetic. Returns (lo, hi, pos_off, band_short) with lo/hi/
    pos_off of shape (B, NV); pos_off is the window start; band_short flags
    rows whose midband exceeds the static double-variant caps."""
    B, L = rows.shape
    dev = rows.device
    bidx = torch.arange(B, device=dev)[:, None, None]
    # window slots: 0 = W [0, K); 1..nsw-1 = suffix [h + t*K, +K);
    # nsw = tail [l-K, l)
    t = torch.arange(max(nsw - 1, 0), device=dev)
    starts = torch.cat([
        torch.zeros((B, 1), dtype=torch.long, device=dev),
        h[:, None] + t[None, :] * K,
        (lengths - K)[:, None]], dim=1)                     # (B, NS)
    NS = nsw + 1
    act = torch.cat([
        ((lengths - K) < h)[:, None],                       # W needed only
        (h[:, None] + (t[None, :] + 1) * K) <= lengths[:, None],
        torch.ones((B, 1), dtype=torch.bool, device=dev)], dim=1)
    act &= ((lengths >= K + 2) & (seg_ok >= 0))[:, None]
    src = starts[:, :, None] + torch.arange(K, device=dev)[None, None, :]
    wchars = rows[bidx, src.clamp(0, L - 1)].long()
    wok = act & ((wchars >= 0) & (wchars <= 3)).all(dim=2) & (starts >= 0)
    pw = 4 ** (K - 1 - torch.arange(K, device=dev))
    key = (wchars.clamp(0, 3) * pw[None, None, :]).sum(dim=2)

    keys_v, off_v, ok_v = [], [], []

    def add(k, o, v):
        keys_v.append(k.reshape(B, -1))
        off_v.append(o.reshape(B, -1))
        ok_v.append(v.reshape(B, -1))

    a3 = torch.arange(3, device=dev)
    ones3 = torch.ones((1, 1, 3), dtype=torch.bool, device=dev)
    # W singles: prefix positions p < h
    if h_max:
        p = torch.arange(h_max, device=dev)
        cw = wchars[:, 0, :]                                # (B, K)
        c0 = cw[:, p.clamp(max=K - 1)]                      # (B, h_max)
        cvar = (c0[:, :, None] + 1 + a3[None, None, :]) % 4
        delta = (cvar - c0[:, :, None]) * pw[p.clamp(max=K - 1)][
            None, :, None]
        vv = (wok[:, 0:1] & (p[None, :] < torch.clamp(h, max=K)[:, None])
              )[:, :, None] & ones3
        add(key[:, 0:1, None] + delta,
            starts[:, 0:1, None].expand(delta.shape), vv)
    # suffix-window singles: any window position that is a suffix position
    # (family exclusivity: when W is active, the tail keeps only j < K)
    p = torch.arange(K, device=dev)
    w_act = (lengths - K) < h                                # W active
    for s in range(1, NS):
        cs = wchars[:, s, :]
        cvar = (cs[:, :, None] + 1 + a3[None, None, :]) % 4
        delta = (cvar - cs[:, :, None]) * pw[None, :, None]
        jpos = starts[:, s:s + 1] + p[None, :]
        in_suffix = jpos >= h[:, None]
        excl = ~w_act[:, None] | (jpos < K)
        vv = (wok[:, s:s + 1] & in_suffix & excl)[:, :, None] & ones3
        add(key[:, s:s + 1, None] + delta,
            starts[:, s:s + 1, None].expand(delta.shape), vv)
    # midband doubles on the tail window: i = (l-K)+pa in the prefix,
    # j = h+pb in the suffix with j < K
    band_short = torch.zeros(B, dtype=torch.bool, device=dev)
    if pa_cap and pb_cap:
        tail = NS - 1
        pa = torch.arange(pa_cap, device=dev)
        pb = torch.arange(pb_cap, device=dev)
        pj = (h - (lengths - K))[:, None] + pb[None, :]     # tail coords
        cA = wchars[:, tail, :][:, pa.clamp(max=K - 1)]     # (B, pa)
        cB = torch.gather(wchars[:, tail, :], 1, pj.clamp(0, K - 1))
        band_on = (lengths - K) < h
        okA = band_on[:, None] & (((lengths - K)[:, None] + pa[None, :])
                                  < h[:, None])
        okB = band_on[:, None] & ((h[:, None] + pb[None, :]) < K) \
            & (pj >= 0) & (pj < K)
        dA = (((cA[:, :, None] + 1 + a3[None, None, :]) % 4
               - cA[:, :, None]) * pw[pa.clamp(max=K - 1)][None, :, None])
        dB = (((cB[:, :, None] + 1 + a3[None, None, :]) % 4
               - cB[:, :, None]) * pw[pj.clamp(0, K - 1)][:, :, None])
        kd = (key[:, tail, None, None, None, None]
              + dA[:, :, None, :, None] + dB[:, None, :, None, :])
        vd = (wok[:, tail, None, None, None, None]
              & okA[:, :, None, None, None] & okB[:, None, :, None, None]
              & torch.ones((1, 1, 1, 3, 3), dtype=torch.bool, device=dev))
        od = (lengths - K)[:, None, None, None, None].expand(kd.shape)
        add(kd, od, vd)
        band_short = band_on & (
            ((h - (lengths - K)) > pa_cap) | ((K - h) > pb_cap))

    keyv = torch.cat(keys_v, dim=1)
    offv = torch.cat(off_v, dim=1)
    okv = torch.cat(ok_v, dim=1)
    kc = keyv.clamp(0, fm.kmer_lo.shape[0] - 1)
    lo = torch.where(okv, fm.kmer_lo[kc].long(), 0)
    hi = torch.where(okv, fm.kmer_hi[kc].long(), 0)
    return lo, hi, offv, band_short


def _beam_core(fm, rows, lengths, offsets, *, n_steps: int, max_mm: int,
               max_hits: int, cap_s: int, cap_p: int, cap_v: int,
               spc: int, split_pair: bool, nsw: int, h_max: int,
               pa_cap: int, pb_cap: int, owned_width: int = 0,
               flat_out: bool = False, flat_cap: int = 0):
    """The whole search; see module docstring. Returns (pos, mm, valid,
    n_hits, truncated) with (B, max_hits) tables.

    owned_width > 0 (range-sharded index, parallel/shard_fm.py):
    candidates starting at or past it are dropped before packing.
    flat_out: return the flat (seg, pos, mm) lanes before packing and the
    truncation flags, so the sharded caller merges shards first.
    flat_cap > 0: keep that many verified lanes instead of
    B * max(8, max_hits) (a reads shard keeps the whole batch's cap)."""
    B, L = rows.shape
    dev = rows.device
    h = lengths // 2
    bidx = torch.arange(B, device=dev)[:, None]
    col = torch.arange(n_steps, device=dev)[None, :]

    # exact half seeds, right-aligned for backward_search
    sidx = lengths[:, None] - n_steps + col
    sq = torch.where(sidx >= h[:, None],
                     rows[bidx, sidx.clamp(0, L - 1)].long(), -1)
    pidx = h[:, None] - n_steps + col
    pq = torch.where(pidx >= 0, rows[bidx, pidx.clamp(0, L - 1)].long(), -1)
    lo2, hi2 = backward_search(fm, torch.cat([sq, pq]))

    ok_len = lengths >= MIN_BEAM_LEN
    seg_ok = torch.where(ok_len, torch.arange(B, device=dev), -1)
    trunc = torch.zeros(B, dtype=torch.bool, device=dev)

    # candidate-run tables, one column per seed family variant: column 0 =
    # suffix-exact half, 1 = prefix-exact half, 2.. = window variants
    lo_list = [lo2[:B, None], lo2[B:, None]]
    hi_list = [hi2[:B, None], hi2[B:, None]]
    off_list = [h[:, None], torch.zeros((B, 1), dtype=torch.long,
                                        device=dev)]
    caps = [cap_s, cap_p]
    if split_pair:
        vlo, vhi, voff, band_short = _variant_intervals(
            fm, rows, lengths, h, seg_ok, K=fm.kmer_k, nsw=nsw,
            h_max=h_max, pa_cap=pa_cap, pb_cap=pb_cap)
        lo_list.append(vlo)
        hi_list.append(vhi)
        off_list.append(voff)
        caps += [cap_v] * vlo.shape[1]
        trunc |= band_short
    lot = torch.cat(lo_list, dim=1)
    hit = torch.cat(hi_list, dim=1)
    offt = torch.cat(off_list, dim=1)
    NV2 = lot.shape[1]
    w = torch.where((seg_ok >= 0)[:, None], hit - lot, 0).clamp(min=0)
    capv = torch.tensor(caps, dtype=torch.long, device=dev)[None, :]
    trunc |= (w > capv).any(dim=1)
    w = torch.minimum(w, capv)
    cumw = torch.cumsum(w, dim=1)
    total = cumw[:, -1]
    trunc |= total > spc
    starts = cumw - w

    # run-constant quantities reach lanes through scatter-added deltas at
    # each run's start column + row cumsums (piecewise-linear rebuild)
    rowi = torch.arange(B, device=dev)[:, None].expand(B, NV2)
    scol = starts.clamp(0, spc - 1)
    base = lot - starts
    zero1 = torch.zeros((B, 1), dtype=torch.long, device=dev)
    d_base = base - torch.cat([zero1, base[:, :-1]], dim=1)
    d_off = offt - torch.cat([zero1, offt[:, :-1]], dim=1)
    base_p = torch.zeros((B, spc), dtype=torch.long, device=dev)
    base_p.index_put_((rowi, scol), d_base, accumulate=True)
    off_p = torch.zeros((B, spc), dtype=torch.long, device=dev)
    off_p.index_put_((rowi, scol), d_off, accumulate=True)
    j = torch.arange(spc, device=dev)[None, :]
    sa_row = torch.cumsum(base_p, dim=1) + j
    pos_off = torch.cumsum(off_p, dim=1)
    lane_valid = j < total[:, None]
    pos = resolve_sa(fm, torch.where(lane_valid, sa_row, 0)) - pos_off

    r_packed, bad_e, len_e = pack_reads(rows, lengths)
    dn = ((fm.n + 15) // 16) if fm.pg_dual else 0
    mm = count_mismatches_packed(
        fm.packed_genome, fm.n_mask, pos, r_packed, bad_e, len_e, L,
        has_n=fm.has_n, dual_nwp=dn)
    ok = (lane_valid & (mm <= max_mm) & (pos >= 0)
          & (pos + lengths[:, None] <= fm.n))
    if offsets.shape[0] > 2:    # multi-contig: reject boundary-crossers
        ok &= same_contig(offsets, pos, lengths[:, None])
    if owned_width:
        ok &= pos < owned_width

    K2 = flat_cap or B * max(8, max_hits)
    segf = torch.arange(B, device=dev)[:, None].expand(B, spc).reshape(-1)
    (f_seg, f_pos, f_mm), dropped2 = _compact(
        ok.reshape(-1), K2,
        [(segf, B), (pos.reshape(-1), 2 ** 30), (mm.reshape(-1), 0)])
    trunc |= dropped2.reshape(B, spc).any(dim=1)
    if flat_out:
        return f_seg, f_pos, f_mm, trunc

    pos_t, mm_t, val_t, n_hits = _pack_rows(f_seg, f_pos, f_mm, B,
                                            max_hits)
    trunc |= n_hits > max_hits
    return pos_t, mm_t, val_t, n_hits, trunc


def beam_plan(fm, L: int, lengths_np, max_mismatches: int):
    """Static search-plan parameters for a batch: grid caps sized from
    expected Poisson interval widths (mean + 6 sigma) and the
    variant-window layout from the batch's min/max row lengths."""
    def cap(mu, lo, hi, pad):
        return int(np.clip(mu + 6 * np.sqrt(mu) + pad, lo, hi))

    n_steps = (L + 1) // 2 + 1
    cap_s = cap(fm.n / 4 ** (L - L // 2), 16, 512, 8)
    cap_p = cap(fm.n / 4 ** (L // 2), 16, 512, 8)
    K = getattr(fm, "kmer_k", 0)
    split_pair = bool(
        max_mismatches >= 2 and K >= 6
        and fm.kmer_lo.shape[0] > 0 and L >= K + 2)
    nsw = h_max = pa_cap = pb_cap = 0
    cap_v = 8
    nv = 0
    if split_pair:
        h_max = L // 2
        m_max = L - L // 2
        nsw = max(1, -(-(m_max - K) // K) + 1) if m_max > K else 1
        lens = lengths_np[lengths_np >= K + 2]
        lmin = int(lens.min()) if len(lens) else L
        pa_cap = int(np.clip(K - (lmin + 1) // 2, 0, 4))
        pb_cap = int(np.clip(K - lmin // 2, 0, 4))
        cap_v = cap(fm.n / 4 ** K, 6, 64, 6)
        if L <= 2 * K:
            nv = (3 * h_max + 3 * max(0, K - (L - L // 2))
                  + 9 * pa_cap * pb_cap)
        else:
            nv = 3 * K * nsw
    mu_base = fm.n / 4 ** (L // 2) + fm.n / 4 ** (L - L // 2)
    exp = mu_base + nv * fm.n / 4 ** max(K, 1) if split_pair else mu_base
    spc = int(np.clip(exp + 6 * np.sqrt(max(exp, 1)) + 48, 128, 8192))
    spc = -(-spc // 128) * 128
    return dict(n_steps=n_steps, max_mm=max_mismatches, cap_s=cap_s,
                cap_p=cap_p, cap_v=cap_v, spc=spc,
                split_pair=split_pair, nsw=nsw, h_max=h_max,
                pa_cap=pa_cap, pb_cap=pb_cap)


def beam_align_rows(fm, rows, lengths, offsets, *, max_mismatches: int,
                    max_hits: int):
    """Drop-in for ops.align.align_forward_rows on short rows, with full
    bowtie1 -v mismatch sensitivity at any genome size. The plan comes from
    the whole batch; with an active mesh the rows shard over its reads
    axis, or search the range-sharded index (parallel/shard_fm.py).

    The verified lanes the batch keeps are the first B * max(8, max_hits)
    in row order. A reads shard keeps at most that many of its own and
    returns only those, flat; merge applies the cap once over the shards
    in row order, so a mesh keeps the lanes of the one-device run however
    a repeat-heavy batch falls across the shards."""
    lengths_np = np.asarray(lengths, np.int32)
    B, L = rows.shape
    plan = beam_plan(fm, L, lengths_np, max_mismatches)
    K2 = B * max(8, max_hits)

    def local(dev, rows, lengths):
        fm_d = auto.replicated(fm, dev)
        d = fm_d.device
        shard = {} if dev is None else dict(
            flat_out=True, flat_cap=min(K2, rows.shape[0] * plan["spc"]))
        out = _beam_core(fm_d, torch.as_tensor(rows, device=d),
                         torch.as_tensor(lengths, device=d).long(),
                         torch.as_tensor(offsets, device=d).long(),
                         max_hits=max_hits, **plan, **shard)
        if dev is None:
            return out
        f_seg, f_pos, f_mm, trunc = out
        live = f_seg < rows.shape[0]      # the kept lanes lead, in order
        return f_seg[live], f_pos[live], f_mm[live], trunc

    def merge(flats, per, B):
        home = flats[0][0].device
        segs, poss, mms, truncs = [], [], [], []
        for i, (f_seg, f_pos, f_mm, trunc) in enumerate(flats):
            seg = f_seg.to(home) + i * per
            segs.append(torch.where(seg < B, seg, B))     # pad rows
            poss.append(f_pos.to(home))
            mms.append(f_mm.to(home))
            truncs.append(trunc.to(home))
        seg = torch.cat(segs)
        trunc = torch.cat(truncs)[:B]
        (f_seg, f_pos, f_mm), dropped = _compact(
            seg < B, K2, [(seg, B), (torch.cat(poss), 2 ** 30),
                          (torch.cat(mms), 0)])
        trunc[seg[dropped]] = True
        pos_t, mm_t, val_t, n_hits = _pack_rows(f_seg, f_pos, f_mm, B,
                                                max_hits)
        return pos_t, mm_t, val_t, n_hits, trunc | (n_hits > max_hits)

    return auto.by_rows(
        local, rows, lengths_np, fm=fm, merge=merge,
        sharded=lambda: auto.sharded_beam_rows(
            rows, lengths_np, offsets, max_hits=max_hits, plan=plan))
