"""Published peaks of one NVIDIA H100 and the realign kernel's least time.

A frozen copy of the port smoke's realign_bound (chip_smoke.py), with the
bytes of the sparse entry's records in place of the dense tables.
Peaks: NVIDIA's H100 SXM data sheet, dense (no sparsity), at the full
700 W power limit.
"""

from __future__ import annotations

INT8_OPS_PER_S = 1.979e15    # int8 tensor-core peak
BYTES_PER_S = 3.35e12        # HBM3


def realign_work(splits: int, R: int, E: int, L: int, records=None):
    """(operations, bytes) of one realign call. Operations: a split is a
    K = 8 L one-hot dot product per (row, event), 2 operations a byte
    product, over the splits the rows need (1 .. min(L - 1, len - 1 - q)
    each). Bytes: the rows, their lengths and both targets read once;
    the dense tables (best_t, mm int32 and ok) written once, or with
    `records` the sparse entry's (row, event, split, mm) int32 records and
    its (E,) event mask."""
    ops = 2.0 * E * 8 * L * splits
    out = 9 * R * E if records is None else 16 * records + E
    return ops, R * L + 4 * R + 2 * E * L + out


def least_seconds(ops: float, nbytes: float):
    """(seconds, what bounds it) at the published peaks."""
    t_ops, t_bytes = ops / INT8_OPS_PER_S, nbytes / BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")
