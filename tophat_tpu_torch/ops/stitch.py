"""Contiguous segment stitching.

Port of tophat_tpu/ops/stitch.py (the contiguous case of the reference's
long_spanning_reads join, src/long_spanning_reads.cpp:805): a chain exists
for seg-0 hit h iff every following segment has a hit at exactly the
previous segment's end. Each SEGMENT obeys the segment mismatch limit, so a
stitched alignment may carry up to 2*nseg mismatches.
"""

from __future__ import annotations

import torch


def stitch_contiguous(seg_pos, seg_mm, seg_valid, cuts, nseg):
    """seg_pos/seg_mm/seg_valid: (R, S, H) genome-space segment hit tables;
    cuts: (R, S+1); nseg: (R,).

    Returns (pos, mm, ok): (R, H) — for each seg-0 hit slot, the stitched
    full-read placement (pos = seg-0 hit position), the summed mismatch
    count, and whether a complete contiguous chain exists."""
    dev = seg_pos.device
    cuts = torch.as_tensor(cuts, device=dev).long()
    nseg = torch.as_tensor(nseg, device=dev).long()
    R, S, H = seg_pos.shape
    seg_len = cuts[:, 1:] - cuts[:, :-1]                 # (R, S)
    seg_pos = seg_pos.long()
    seg_mm = seg_mm.long()

    pos0 = seg_pos[:, 0, :]
    ok = seg_valid[:, 0, :].clone()
    total_mm = torch.where(ok, seg_mm[:, 0, :], 0)
    nxt = pos0 + seg_len[:, 0][:, None]

    for j in range(1, S):
        needed = (j < nseg)[:, None]                     # (R, 1)
        match = ((seg_pos[:, j, None, :] == nxt[:, :, None])
                 & seg_valid[:, j, None, :])             # (R, H, H)
        found = match.any(-1)
        mmj = (match * seg_mm[:, j, None, :]).sum(-1)
        ok &= torch.where(needed, found, True)
        total_mm += torch.where(needed & found, mmj, 0)
        nxt = nxt + seg_len[:, j][:, None]
    return pos0.int(), total_mm.int(), ok
