"""Candidate-alignment verification: word-packed gather + mismatch count.

Port of tophat_tpu/ops/verify.py. Packed words are int64 tensors holding
uint32 values, so every shift is exact and left shifts are masked back to
32 bits explicitly.
"""

from __future__ import annotations

import torch

from tophat_tpu_torch.ops.rank import MASK32, popcount32

EVEN = 0x55555555


def _pack_even_bits(bits, W):
    """bool (..., L) -> int64 (..., W): position i lands on bit 2*(i%16)
    of word i//16 (the 'even' lanes of the 2-bit layout)."""
    lead = bits.shape[:-1]
    L = bits.shape[-1]
    padded = torch.zeros(lead + (W * 16,), dtype=torch.long,
                         device=bits.device)
    padded[..., :L] = bits.long()
    shifts = 2 * torch.arange(16, device=bits.device)
    return (padded.reshape(lead + (W, 16)) << shifts).sum(-1)


def pack_reads(codes, lengths):
    """Pack read codes for word-wise verification.

    codes: (B, L) int8, -1 padded, N = 4. Returns
      packed (B, W) 2-bit codes,
      bad_e  (B, W) even-bit mask of N positions (always mismatch),
      len_e  (B, W) even-bit mask of in-read positions,
    all int64 holding uint32 values, with W = ceil(L/16)."""
    B, L = codes.shape
    W = (L + 15) // 16
    dev = codes.device
    cp = torch.zeros((B, W * 16), dtype=torch.long, device=dev)
    cp[:, :L] = codes.long().clamp(0, 3)
    shifts = 2 * torch.arange(16, device=dev)
    packed = (cp.reshape(B, W, 16) << shifts).sum(-1)
    in_len = torch.arange(L, device=dev)[None, :] < lengths.long()[:, None]
    bad_e = _pack_even_bits(codes >= 4, W)
    len_e = _pack_even_bits(in_len, W)
    return packed, bad_e, len_e


def _expand_1bit_to_even(x16):
    """Data in the low 16 bits -> bits spread to even positions."""
    x = x16 & 0xFFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def _funnel(cur, nxt, sh):
    """32-bit window of the word pair (cur | nxt << 32) starting at bit sh."""
    hi = torch.where(sh > 0, (nxt << (32 - sh)) & MASK32, 0)
    return (cur >> sh) | hi


def count_mismatches_packed(packed_genome, n_mask, pos, r_packed, bad_e,
                            len_e, L: int, has_n: bool = True,
                            dual_nwp: int = 0):
    """Word-packed mismatch count of each candidate window: ~L/16 word
    gathers per candidate instead of L bytes, XOR + popcount.

    pos: (B, C) candidate window starts (or any shape matching r_packed's
    leading dims). Caller masks out-of-bounds candidates (their counts are
    garbage). dual_nwp > 0: packed_genome carries the appended 8-shifted
    copy (primary region dual_nwp words); when L <= 16*W - 7 the copy that
    puts pos in the low half of a word is chosen per lane, so W instead of
    W+1 genome words are gathered."""
    W = r_packed.shape[-1]
    NW = packed_genome.shape[0]
    pos = pos.long()

    dual = bool(dual_nwp) and L <= 16 * W - 7
    if dual:
        sel = (pos & 15) >= 8
        eff = torch.where(sel, pos - 8, pos)
        word0 = torch.where(sel, dual_nwp + (eff >> 4), eff >> 4)
        sh2 = (eff & 15) * 2
    else:
        word0 = pos >> 4
        sh2 = (pos & 15) * 2
    rp = r_packed[:, None, :] if r_packed.dim() == 2 else r_packed
    be = bad_e[:, None, :] if bad_e.dim() == 2 else bad_e
    le = len_e[:, None, :] if len_e.dim() == 2 else len_e

    if has_n:
        W1 = (W + 1) // 2 + 1
        NW1 = n_mask.shape[0]
        w0n = pos >> 5
        shn = pos & 31
        n_words = []
        rawn_next = n_mask[w0n.clamp(0, NW1 - 1)]
        for j2 in range(W1):
            rawn_cur = rawn_next
            rawn_next = n_mask[(w0n + (j2 + 1)).clamp(0, NW1 - 1)]
            n_words.append(_funnel(rawn_cur, rawn_next, shn))

    total = torch.zeros(pos.shape, dtype=torch.long, device=pos.device)
    raw_next = packed_genome[word0.clamp(0, NW - 1)]
    for jw in range(W):
        raw_cur = raw_next
        if dual and jw == W - 1:     # word W would cross into the other
            raw_next = torch.zeros_like(raw_cur)   # copy: never needed
        else:
            raw_next = packed_genome[(word0 + (jw + 1)).clamp(0, NW - 1)]
        x = _funnel(raw_cur, raw_next, sh2) ^ rp[..., jw]
        m2 = (x | (x >> 1)) & EVEN
        if has_n:
            half = n_words[jw // 2] >> (16 * (jw % 2))
            m2 = m2 | _expand_1bit_to_even(half)
        m = (m2 | be[..., jw]) & le[..., jw]
        total = total + popcount32(m)
    return total


def same_contig(offsets, pos, read_len):
    """True where [pos, pos+read_len) lies inside one contig of the
    concatenated genome (offsets: (num_contigs+1,))."""
    offsets = torch.as_tensor(offsets, device=pos.device).long()
    pos = pos.long()
    a = torch.searchsorted(offsets, pos.contiguous(), right=True)
    b = torch.searchsorted(offsets, (pos + read_len - 1).contiguous(),
                           right=True)
    return a == b
