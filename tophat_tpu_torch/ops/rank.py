"""Batched Occ/rank queries on the packed BWT (the FM-index inner loop).

Port of tophat_tpu/ops/rank.py as plain torch gathers + a SWAR popcount
(torch has no popcount op). Packed words are int64 tensors holding uint32
values; every index is int64.
"""

from __future__ import annotations

import torch

from tophat_tpu_torch.index.fm import OCC_BLOCK, WORDS_PER_BLOCK

EVEN = 0x55555555
MASK32 = 0xFFFFFFFF


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 element holding a value in [0, 2^32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def low_mask(bits: torch.Tensor) -> torch.Tensor:
    """(1 << bits) - 1 for bits in [0, 32], as int64."""
    return torch.where(bits >= 32, MASK32, (1 << bits.clamp(0, 31)) - 1)


def rank(fm, c, i):
    """#occurrences of code `c` (0..3) in bwt[0:i). Broadcasts over c/i.

    i in [0, n+1]; the sentinel row (fm.primary, stored as code 0) is
    excluded from the count."""
    dev = fm.packed_bwt.device
    c = torch.as_tensor(c, device=dev).long()
    i = torch.as_tensor(i, device=dev).long()
    c, i = torch.broadcast_tensors(c, i)
    packed_bwt = fm.packed_bwt
    nw = packed_bwt.shape[0]

    blk = i // OCC_BLOCK
    ck = fm.occ_ck[blk, c].long()
    occ_mid = fm.occ_mid
    if occ_mid.shape[0] > 0:
        # mid-checkpoint path: 1 byte + 2 words instead of 8 words
        sub = i // 32
        ck = ck + occ_mid[sub.clamp(max=occ_mid.shape[0] - 1), c].long()
        word0 = sub * 2
        nwords = 2
        j = i - sub * 32   # bases included past the mid-checkpoint, [0, 32]
    else:
        word0 = blk * WORDS_PER_BLOCK
        nwords = WORDS_PER_BLOCK
        j = i - blk * OCC_BLOCK

    ar = torch.arange(nwords, device=dev)
    widx = word0[..., None] + ar
    words = packed_bwt[widx.clamp(max=nw - 1)]
    x = words ^ (c * EVEN)[..., None]
    m = ~(x | (x >> 1)) & EVEN        # bit 2k set iff base k == c
    covered = (j[..., None] - ar * 16).clamp(0, 16)
    within = popcount32(m & low_mask(2 * covered)).sum(-1)
    sentinel = ((c == 0) & (fm.primary < i)).long()
    return ck + within - sentinel


def bwt_symbol(fm, i):
    """Symbol code stored at BWT row i (the sentinel row reads as 0)."""
    i = torch.as_tensor(i, device=fm.packed_bwt.device).long()
    word = fm.packed_bwt[i // 16]
    return (word >> (2 * (i % 16))) & 3


def lf(fm, i):
    """LF-mapping: row of the predecessor suffix. LF(primary) = 0."""
    i = torch.as_tensor(i, device=fm.packed_bwt.device).long()
    c = bwt_symbol(fm, i)
    out = fm.C.long()[c] + rank(fm, c, i)
    return torch.where(i == fm.primary, 0, out)
