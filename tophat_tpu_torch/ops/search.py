"""Batched FM backward search and hit resolution.

Port of tophat_tpu/ops/search.py. A query's SA interval is narrowed one
character at a time from its last base (after an optional k-mer table
seed); queries are left-padded with -1, dead intervals collapse to
lo == hi, and hits resolve into a fixed-width (B, H) position table.
"""

from __future__ import annotations

import torch

from tophat_tpu_torch.ops.rank import low_mask, lf, popcount32, rank


def backward_search(fm, queries):
    """Exact-match SA intervals for a batch of queries.

    queries : (B, L) integer codes, LEFT-padded with -1 (or any code
              outside 0..3); column L-1 is every query's last base. Codes 4
              (N) make a query unmatchable.

    Returns (lo, hi): int64 (B,) SA interval [lo, hi) of full-query matches.
    """
    dev = fm.packed_bwt.device
    q = torch.as_tensor(queries, device=dev).long()
    B, L = q.shape
    m = fm.n + 1
    C = fm.C.long()

    k = fm.kmer_k
    if k and fm.kmer_lo.shape[0] > 0 and L >= k:
        lastk = q[:, L - k:]
        seedable = ((lastk >= 0) & (lastk <= 3)).all(dim=1)
        pw = 4 ** torch.arange(k - 1, -1, -1, device=dev)
        v = (lastk.clamp(0, 3) * pw[None, :]).sum(dim=1)
        lo = torch.where(seedable, fm.kmer_lo.long()[v], 0)
        hi = torch.where(seedable, fm.kmer_hi.long()[v], m)
        skip = torch.where(seedable, k, 0)
        # even when L == k the loop below must still run: rows that cannot
        # seed (padding or an N in the k-char window) consume their chars
    else:
        lo = torch.zeros(B, dtype=torch.long, device=dev)
        hi = torch.full((B,), m, dtype=torch.long, device=dev)
        skip = torch.zeros(B, dtype=torch.long, device=dev)

    for t in range(L):                      # last base first
        c = q[:, L - 1 - t]
        is_n = c > 3                        # N: unmatchable, kill interval
        active = t >= skip
        do = (c >= 0) & ~is_n & (lo < hi) & active
        cc = c.clamp(0, 3)
        nlo = torch.where(do, C[cc] + rank(fm, cc, lo), lo)
        nhi = torch.where(do, C[cc] + rank(fm, cc, hi), hi)
        hi = torch.where(is_n & active, nlo, nhi)
        lo = nlo
    return lo, hi


def resolve_sa(fm, idx):
    """SA values for BWT rows `idx` (any shape). With a full SA this is one
    gather; with text-order sampling (fm.sa_rate > 0) each row LF-walks to
    the nearest marked row (<= sa_rate - 1 steps)."""
    idx = torch.as_tensor(idx, device=fm.packed_bwt.device).long()
    if fm.sa_rate == 0:
        sa = fm.sa
        return sa[idx.clamp(0, sa.shape[0] - 1)].long()

    marks = fm.sa_marks
    ck = fm.sa_mark_ck.long()
    mark_mid = fm.sa_mark_mid
    samples = fm.sa_samples.long()
    packed_bwt = fm.packed_bwt
    occ_ck = fm.occ_ck.long()
    occ_mid = fm.occ_mid
    C = fm.C.long()
    m = fm.n + 1
    fused = occ_mid.shape[0] > 0

    def is_marked(i):
        w = marks[(i >> 5).clamp(0, marks.shape[0] - 1)]
        return ((w >> (i & 31)) & 1).bool()

    def rank1(i):
        """#marked rows < i (for a marked row i: its sample index)."""
        if mark_mid.shape[0] > 0:
            sub = i // 32
            base = (ck[(i // 128).clamp(0, ck.shape[0] - 1)]
                    + mark_mid[sub.clamp(0, mark_mid.shape[0] - 1)].long())
            word = marks[sub.clamp(0, marks.shape[0] - 1)]
            return base + popcount32(word & low_mask(i - sub * 32))
        blk = i // 128
        base = ck[blk.clamp(0, ck.shape[0] - 1)]
        ar = torch.arange(4, device=i.device)
        widx = (blk * 4)[..., None] + ar
        words = marks[widx.clamp(0, marks.shape[0] - 1)]
        covered = ((i - blk * 128)[..., None] - ar * 32).clamp(0, 32)
        return base + popcount32(words & low_mask(covered)).sum(-1)

    def lf_fused(i):
        """LF-mapping with one fused word-pair fetch (the symbol word is one
        of the two words rank() needs past the 32-base mid-checkpoint)."""
        sub = i // 32
        w0 = packed_bwt[(sub * 2).clamp(max=packed_bwt.shape[0] - 1)]
        w1 = packed_bwt[(sub * 2 + 1).clamp(max=packed_bwt.shape[0] - 1)]
        wsym = torch.where(((i // 16) & 1).bool(), w1, w0)
        c = (wsym >> (2 * (i % 16))) & 3
        base = (occ_ck[(i // 128).clamp(0, occ_ck.shape[0] - 1), c]
                + occ_mid[sub.clamp(0, occ_mid.shape[0] - 1), c].long())
        j = i - sub * 32
        cnt = torch.zeros_like(i)
        for w, off in ((w0, 0), (w1, 16)):
            x = w ^ (c * 0x55555555)
            mbits = ~(x | (x >> 1)) & 0x55555555
            covered = (j - off).clamp(0, 16)
            cnt = cnt + popcount32(mbits & low_mask(2 * covered))
        sentinel = ((c == 0) & (fm.primary < i)).long()
        out = C[c] + base + cnt - sentinel
        return torch.where(i == fm.primary, 0, out)

    i = idx.clamp(0, m - 1)
    steps = torch.zeros_like(i)
    done = torch.zeros(i.shape, dtype=torch.bool, device=i.device)
    for _ in range(fm.sa_rate):
        # walk to the nearest marked row; the sample lookup (rank1 over the
        # mark bits) only depends on the final row, so it runs once after
        done = done | is_marked(i)
        nxt = lf_fused(i) if fused else lf(fm, i)
        i = torch.where(done, i, nxt)
        steps = torch.where(done, steps, steps + 1)
    val = samples[rank1(i).clamp(0, samples.shape[0] - 1)]
    return val + steps


def resolve_hits(fm, lo, hi, max_hits: int):
    """Expand SA intervals to genomic positions.

    Returns (pos, valid, truncated): (B, max_hits) text positions (-1 where
    invalid), their mask, and (B,) flags for intervals wider than
    max_hits."""
    lo = torch.as_tensor(lo).long()
    hi = torch.as_tensor(hi).long()
    idx = lo[:, None] + torch.arange(max_hits, device=lo.device)[None, :]
    valid = idx < hi[:, None]
    pos = resolve_sa(fm, idx)
    truncated = (hi - lo) > max_hits
    return torch.where(valid, pos, -1), valid, truncated
