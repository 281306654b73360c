"""Cross-strand fusion search (FR / RF directions).

Port of tophat_tpu/ops/fusion_fr.py. An FR read is piece A on strand +
followed by piece B on strand -: its forward codes have a genomic PREFIX
match and its reverse-complement codes have a genomic PREFIX match, the two
prefixes together covering the read (reference: detect_fusion
reverse-complements one side, segment_juncs.cpp:2629; fusion dirs in
fusions.h:24). An RF read is the suffix+suffix mirror.

In the genome-space row layout (pipeline/segment.py) read r owns rows r
(forward) and r+R (reverse complement). Every segment hit implies an
"unspliced anchor" — the genome position read base 0 would occupy if the
whole row were contiguous (hit_pos - segment_cut). Candidate (A, B) anchor
pairs are scanned over all split points t with two per-row cumulative
mismatch tables:
  FR: prefix_mm_fwd(t) + prefix_mm_rc(L - t)
  RF: suffix_mm_fwd(t) + suffix_mm_rc(L - t)
keeping splits within a 2-mismatch budget. Mis-anchored pairs self-reject
because a wrong anchor cannot fit the budget.

Every stage runs as plain torch on the genome's device; the per-event
realignment (realign_fr_events) is a one-hot cross-correlation
(torch.nn.functional.conv1d) over row chunks, exact: its 0/1 products sum
to at most L.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from tophat_tpu_torch.ops.splice import BIG, first_argmin
from tophat_tpu_torch.utils import trace

FR_MM = 2
FR_PAIR_CAP = 16384   # anchor pairs kept per batch (the JAX package's cap)
MAX_FR_EVENTS = 256   # unique breakpoints realigned per direction
# conv output elements per row chunk of realign_fr_events (int32 tables of
# this many elements stay well under 1 GB each)
_CHUNK_ELEMS = 1 << 25


@dataclasses.dataclass
class FrPairs:
    read: Any      # (P,) original read index
    anchor_a: Any  # (P,) fwd-row implied unspliced anchor (read base 0)
    anchor_b: Any  # (P,) rev-row implied unspliced anchor
    valid: Any


def build_fr_pairs(seg_pos, seg_valid, cuts, lengths, cap: int):
    """All (fwd-row hit, rev-row hit) anchor combos per read, valid ones
    first in flat (read, fwd hit, rev hit) order, then the leading invalid
    ones, `cap` in all (the JAX package's stable argsort of ~valid).
    Returns (FrPairs, overflowed): overflowed when more than `cap` combos
    were valid. Only the kept combos are materialized."""
    rows, S, H = seg_pos.shape
    R = rows // 2
    SH = S * H
    anchors = (seg_pos.long() - cuts[:, :-1].long()[:, :, None]).reshape(
        rows, SH)
    vflat = seg_valid.reshape(rows, SH)
    ok = (vflat[:R, :, None] & vflat[R:, None, :]).reshape(-1)  # (R*SH*SH,)
    P = ok.shape[0]
    keep = min(P, cap)
    idx = torch.nonzero(ok).reshape(-1)
    trace.note_sync(8)                # nonzero reads its count back
    nvalid = idx.shape[0]
    if nvalid < keep:
        # the first (keep - nvalid) invalid combos lie in ok[:keep]
        idx = torch.cat([idx, torch.nonzero(~ok[:keep]).reshape(-1)[
            :keep - nvalid]])
        trace.note_sync(8)
    idx = idx[:keep]
    read = idx // (SH * SH)
    ja = (idx // SH) % SH
    jb = idx % SH
    pairs = FrPairs(read=read, anchor_a=anchors[read, ja],
                    anchor_b=anchors[read + R, jb], valid=ok[idx])
    return pairs, nvalid > cap


def scan_fr_pairs(genome, reads_f, reads_r, lengths, pairs: FrPairs,
                  L: int, pattern: str):
    """Best split per anchor pair (leftmost minimum).

    pattern "prefix" (FR): fwd prefix [0:t) at anchor_a, rc prefix
    [0:rl-t) at anchor_b. Returns (t, leftA, leftB, mm, valid) where
    leftA/leftB are each piece's LAST aligned genome base.
    pattern "suffix" (RF): fwd suffix [t:) and rc suffix [rl-t:).
    Returns (t, rightA, rightB, mm, valid) with each piece's FIRST base.
    """
    n = genome.shape[0]
    dev = genome.device
    P = pairs.read.shape[0]
    rl = lengths[pairs.read].long()
    u = torch.arange(L, device=dev)[None, :]
    five = torch.tensor(5, dtype=genome.dtype, device=dev)

    def mk(idx):
        return torch.where((idx >= 0) & (idx < n),
                           genome[idx.clamp(0, n - 1)], five)

    def bad(g, r):
        return (g != r) | (g >= 4) | (r >= 4) | (r < 0)

    in_read = u < rl[:, None]
    bad_a = bad(mk(pairs.anchor_a[:, None] + u),
                reads_f[pairs.read[:, None], u]) & in_read
    bad_b = bad(mk(pairs.anchor_b[:, None] + u),
                reads_r[pairs.read[:, None], u]) & in_read

    t = torch.arange(L + 1, device=dev)[None, :]
    ut = (rl[:, None] - t).clamp(0, L)
    zero = torch.zeros((P, 1), dtype=torch.long, device=dev)
    if pattern == "prefix":
        mmA = torch.cat([zero, torch.cumsum(bad_a.long(), 1)], dim=1)
        mmB = torch.cat([zero, torch.cumsum(bad_b.long(), 1)], dim=1)
    else:
        rev = lambda x: torch.flip(torch.cumsum(torch.flip(x.long(), [1]), 1),
                                   [1])
        mmA = torch.cat([rev(bad_a), zero], dim=1)
        mmB = torch.cat([rev(bad_b), zero], dim=1)
    tot = mmA + torch.gather(mmB, 1, ut)

    interior = (t >= 1) & (t <= rl[:, None] - 1)
    tot = torch.where(interior, tot, BIG)
    best, best_t = first_argmin(tot, 1)
    valid = pairs.valid & (best <= FR_MM)
    if pattern == "prefix":
        posA = pairs.anchor_a + best_t - 1              # last base, piece A
        posB = pairs.anchor_b + (rl - best_t) - 1       # last base, piece B
    else:
        posA = pairs.anchor_a + best_t                  # first base, piece A
        posB = pairs.anchor_b + (rl - best_t)           # first base, piece B
    return best_t, posA, posB, best, valid


def _one_hot(codes):
    """(N, L) codes -> (N, 4, L) float32 one-hot (codes outside 0..3 are
    all-zero: they match nothing)."""
    ch = torch.arange(4, device=codes.device)[None, :, None]
    return (codes.long()[:, None, :] == ch).float()


def _flank(genome, start):
    """(E, L) genome codes from start[e] on; off-genome positions read 5."""
    n = genome.shape[0]
    return torch.where((start >= 0) & (start < n),
                       genome[start.clamp(0, n - 1)],
                       torch.tensor(5, dtype=genome.dtype,
                                    device=genome.device))


def _xcorr(a, b, L):
    """out[i, j, lag] = sum_w [a[i, w + lag] == b[j, w]] (codes 0..3),
    lag in 0..L-1, a zero-padded on the right: a one-hot cross-correlation,
    rounded back to integers (0/1 products, sums <= L)."""
    x = F.pad(_one_hot(a), (0, L - 1))
    return torch.round(F.conv1d(x, _one_hot(b))).to(torch.int32)


def realign_fr_events(genome, rows_f, rows_r, lengths, pA, pB, ev_valid,
                      pattern: str):
    """Realign every read against known cross-strand fusion breakpoints —
    the role of bowtie mapping segments against juncs_db's fr/rev fusion
    flank records (juncs_db.cpp:152 print_fusion): reads whose short piece
    has no mappable segment still align across an already-discovered break.

    pattern "fr": pA/pB are each piece's LAST genome base (piece A = fwd
    prefix of the read, piece B = fwd prefix of the read's revcomp).
    mm(t) = rightanch(rows_f[0:t) @ pA) + rightanch(rows_r[0:rl-t) @ pB).
    pattern "rf": pA/pB are each piece's FIRST base; suffix mirror.

    Returns (best_t, mm, ok): (R, E) tensors. Rows run in chunks so the
    (chunk, E, L) tables stay bounded."""
    dev = genome.device
    R, L = rows_f.shape
    E = pA.shape[0]
    t = torch.arange(L, device=dev)
    pA = pA.long()
    pB = pB.long()
    if pattern == "fr":   # flanks ending at the piece's last base
        flA = _flank(genome, pA[:, None] - (L - 1) + t)
        flB = _flank(genome, pB[:, None] - (L - 1) + t)
    else:                 # flanks starting at the piece's first base
        flA = _flank(genome, pA[:, None] + t)
        flB = _flank(genome, pB[:, None] + t)
    lag_r = (L - t).clamp(0, L - 1)
    tt = t.int()[None, None, :]     # int32 tables: mismatch counts <= L
    best_t = torch.zeros((R, E), dtype=torch.int32, device=dev)
    best = torch.zeros((R, E), dtype=torch.int32, device=dev)
    step = max(1, _CHUNK_ELEMS // max(1, E * L))
    for r0 in range(0, R, step):
        rf = rows_f[r0:r0 + step]
        rr = rows_r[r0:r0 + step]
        rl = lengths[r0:r0 + step].int()[:, None, None]
        Rc = rf.shape[0]
        idx = (rl - tt).clamp(0, L - 1).long().expand(Rc, E, L)
        if pattern == "fr":
            # out[r, e, k] = k - matches(rows[r][0:k), flank ending at p[e])
            mA = _xcorr(flA, rf, L).permute(1, 0, 2)        # (Rc, E, lag)
            mmA = tt - mA[:, :, lag_r]
            mB = _xcorr(flB, rr, L).permute(1, 0, 2)
            mmB = torch.gather(tt - mB[:, :, lag_r], 2, idx)
        else:
            # out[r, e, s] = (rl - s) - matches(rows[r][s:), flank at p[e])
            mmA = (rl - tt) - _xcorr(rf, flA, L)
            mmB = torch.gather((rl - tt) - _xcorr(rr, flB, L), 2, idx)
        interior = (tt >= 3) & (tt <= rl - 3)
        mm = torch.where(interior & ev_valid[None, :, None], mmA + mmB, BIG)
        b, bt = first_argmin(mm, 2)
        best[r0:r0 + Rc] = b.int()
        best_t[r0:r0 + Rc] = bt.int()
    return best_t, best, best <= FR_MM


def find_fr_fusions(fm, gs, seg_tables, params, cap: int = FR_PAIR_CAP):
    """Host driver: list of dicts, one per direction with hits, of numpy
    arrays {"pattern": "fr"|"rf", "read", "t", "posA", "posB", "mm"}
    (read = genome-space row of the forward strand)."""
    R = gs.rows // 2
    if R == 0:
        return []
    dev = fm.genome.device
    seg_pos, _, seg_valid = (torch.as_tensor(x, device=dev)
                             for x in seg_tables)
    cuts = torch.as_tensor(gs.cuts, device=dev)
    lengths = torch.as_tensor(gs.lengths, device=dev)
    L = gs.readsg.shape[1]
    readsg = torch.as_tensor(gs.readsg, device=dev)
    reads_f = readsg[:R]
    reads_r = readsg[R:]
    pairs, overflow = build_fr_pairs(seg_pos, seg_valid, cuts, lengths, cap)
    if overflow:
        warnings.warn(
            f"FR/RF anchor pairs overflowed {cap} slots; some candidates "
            "were dropped (raise the cap or reduce the chunk size)",
            stacklevel=2)
    host = lambda x: trace.to_host(x).astype(np.int32)

    out = []
    for pattern, dirname in (("prefix", "fr"), ("suffix", "rf")):
        t, posA, posB, mm, valid = scan_fr_pairs(
            fm.genome, reads_f, reads_r, lengths[:R], pairs, L, pattern)
        valid = trace.to_host(valid)
        if not valid.any():
            continue
        rd = host(pairs.read)[valid]
        tt = host(t)[valid]
        pa = host(posA)[valid]
        pb = host(posB)[valid]
        mmv = host(mm)[valid]

        # realign EVERY read against the unique discovered breakpoints;
        # a break seen from the revcomp read is the same break with the
        # pieces swapped — include swapped coords so twins realign too
        uniq = np.unique(np.concatenate(
            [np.stack([pa, pb], axis=1),
             np.stack([pb, pa], axis=1)]), axis=0)[:MAX_FR_EVENTS]
        E = len(uniq)
        bt, bmm, ok = realign_fr_events(
            fm.genome, reads_f, reads_r, lengths[:R],
            torch.as_tensor(uniq[:, 0], device=dev),
            torch.as_tensor(uniq[:, 1], device=dev),
            torch.ones(E, dtype=torch.bool, device=dev), dirname)
        bt, bmm, ok = (trace.to_host(x) for x in (bt, bmm, ok))
        # np.nonzero is row-major over (R, E): that order decides which
        # duplicates `seen` drops
        seen = set(zip(rd.tolist(), tt.tolist(), pa.tolist(), pb.tolist()))
        add_r, add_t, add_a, add_b, add_m = [], [], [], [], []
        for r, e in zip(*np.nonzero(ok)):
            ra_pa, ra_pb = int(uniq[e, 0]), int(uniq[e, 1])
            key = (int(r), int(bt[r, e]), ra_pa, ra_pb)
            if key in seen:
                continue
            seen.add(key)
            add_r.append(int(r))
            add_t.append(int(bt[r, e]))
            add_a.append(ra_pa)
            add_b.append(ra_pb)
            add_m.append(int(bmm[r, e]))
        if add_r:
            rd = np.concatenate([rd, np.array(add_r, rd.dtype)])
            tt = np.concatenate([tt, np.array(add_t, tt.dtype)])
            pa = np.concatenate([pa, np.array(add_a, pa.dtype)])
            pb = np.concatenate([pb, np.array(add_b, pb.dtype)])
            mmv = np.concatenate([mmv, np.array(add_m, mmv.dtype)])
        out.append(dict(pattern=dirname, read=rd, t=tt, posA=pa, posB=pb,
                        mm=mmv))
    return out
