# Copy of tophat_tpu/index/suffix.py (host code), imports rewritten.
"""Suffix-array construction (host side).

The reference delegates this to the external `bowtie-build` / `bowtie2-build`
executables (reference: src/tophat.py:2514 build_juncs_bwt_index,
:2600 build_idx_from_fa). Here the index is built in-process: a numpy
prefix-doubling algorithm (O(n log^2 n), vectorized) that is fast enough for
transcriptomes / test genomes; a C++ SA-IS builder (O(n)) plugs in behind the
same function for chromosome-scale genomes (see tophat_tpu/native/).
"""

from __future__ import annotations

import numpy as np


def suffix_array_doubling(codes: np.ndarray) -> np.ndarray:
    """SA of `codes` + implicit terminal sentinel smaller than every symbol.

    Returns SA of length n+1 with SA[0] == n (the sentinel suffix).
    """
    t = np.asarray(codes, dtype=np.int64)
    n = t.shape[0]
    if n == 0:
        return np.zeros(1, dtype=np.int64)

    # rank over T$; sentinel gets rank 0, real symbols rank code+1
    rank = np.concatenate([t + 1, [0]])
    m = n + 1
    sa = np.argsort(rank, kind="stable")
    k = 1
    idx = np.arange(m)
    while True:
        # sort by (rank[i], rank[i+k]) with out-of-range treated as -1
        key2 = np.full(m, -1, dtype=np.int64)
        valid = idx + k < m
        key2[valid] = rank[idx[valid] + k]
        order = np.lexsort((key2, rank))
        sa = order
        # recompute ranks
        new_rank = np.zeros(m, dtype=np.int64)
        r1 = rank[sa]
        r2 = key2[sa]
        changed = np.ones(m, dtype=bool)
        changed[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        new_rank[sa] = np.cumsum(changed) - 1
        rank = new_rank
        k *= 2
        if rank[sa[-1]] == m - 1 or k >= m:
            break
    return sa.astype(np.int64)


def suffix_array(codes: np.ndarray) -> np.ndarray:
    """Build the suffix array (with sentinel) using the best available builder."""
    try:
        from tophat_tpu_torch.native import sais  # C++ builder, optional

        return sais.suffix_array(codes)
    except Exception:
        return suffix_array_doubling(codes)


def bwt_from_sa(codes: np.ndarray, sa: np.ndarray) -> tuple[np.ndarray, int]:
    """BWT of T$ from its suffix array.

    Returns (bwt_codes, primary): bwt_codes is int8 of length n+1 with the
    sentinel row's symbol stored as 0 (A); `primary` is that row's index.
    """
    try:
        from tophat_tpu_torch.native import sais  # threaded gather, no temps

        return sais.bwt_from_sa(codes, sa)
    except Exception:
        pass
    t = np.asarray(codes, dtype=np.int8)
    n = t.shape[0]
    bwt = np.zeros(n + 1, dtype=np.int8)
    prev = sa - 1
    nz = sa > 0
    bwt[nz] = t[prev[nz]]
    primary = int(np.nonzero(sa == 0)[0][0])
    bwt[primary] = 0
    return bwt, primary
