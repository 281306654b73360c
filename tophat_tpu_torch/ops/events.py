"""Realign reads across candidate events (junctions / deletions / insertions).

Port of tophat_tpu/ops/events.py (the reference's juncs_db flank-FASTA ->
bowtie -> rebase loop, src/juncs_db.cpp:109, src/bwt_map.cpp:885, as one
batched device computation). Events are grouped by insertion length q and
every group runs the realign kernel (ops/realign_kernel.py); with an
active mesh (parallel/auto.py) the kernel runs once per reads shard and
q-group, so the mesh run computes what the one-device run computes (the
JAX mesh path's conv formulation, realign_chunk, is not ported: it
counts a read N over a genome N as a mismatch, the kernel as a match).

Split semantics per kind:
  junction/deletion: read[0:t] ends at left; read[t:] starts at right
  insertion (ins_len=q): read[0:t] ends at left; read[t:t+q] is the inserted
  sequence (compared against the event's seq); read[t+q:] starts at left+1
"""

from __future__ import annotations

import numpy as np
import torch

from tophat_tpu_torch.ops.realign_kernel import (BIG, prepare_targets,
                                                 realign_group,
                                                 realign_group_sparse)
from tophat_tpu_torch.ops.splice import KIND_INSERTION
from tophat_tpu_torch.parallel import auto

MAX_INS = 8  # inserted-sequence slot width


def _groups(genome, readsg, lengths, events):
    """Yield (event indices, q, realign inputs (reads, lengths, flank_l,
    comb)) per insertion-length group, in np.unique order of q, on the
    genome's device."""
    dev = genome.device
    R, L = readsg.shape
    reads = torch.as_tensor(readsg, device=dev).to(torch.int8).contiguous()
    lens = torch.as_tensor(np.asarray(lengths, np.int32), device=dev)
    kinds = np.asarray(events["kind"])
    ilen = np.where(kinds == KIND_INSERTION,
                    np.asarray(events["ins_len"]), 0).astype(np.int32)
    for q in np.unique(ilen):
        idx = np.nonzero(ilen == q)[0]
        sel = lambda a: torch.as_tensor(np.asarray(a)[idx], device=dev)
        flank_l, comb = prepare_targets(
            genome, sel(events["left"]), sel(events["right"]),
            sel(kinds), sel(events["ins_seq"]), int(q), L)
        yield idx, int(q), (reads, lens, flank_l, comb)


def _dense(args, q: int, max_mm: int):
    """realign_group on one q-group; with an active mesh, once per reads
    shard on its device (events replicated), gathered in row order."""
    reads, lens, flank_l, comb = args
    return auto.by_rows(lambda dev, r, n: realign_group(
        r, n, flank_l.to(dev), comb.to(dev), q, max_mm), reads, lens)


def _sparse(args, q: int, max_mm: int, valid):
    """realign_group_sparse on one q-group as (4, n) host records; with an
    active mesh, once per reads shard: each shard's rows offset by its
    first row, pad rows (past the true row count) dropped, shards in
    order — the one-call row-major order, with no sort."""
    reads, lens, flank_l, comb = args

    def merge(recs, per, R):
        parts = []
        for i, rec in enumerate(recs):
            rec = rec.to(recs[0].device)
            rows = rec[0] + i * per
            keep = rows < R
            parts.append(torch.cat([rows[None, keep], rec[1:, keep]]))
        return torch.cat(parts, dim=1)

    return auto.by_rows(
        lambda dev, r, n: realign_group_sparse(
            r, n, flank_l.to(dev), comb.to(dev), q, max_mm, valid.to(dev)),
        reads, lens, merge=merge).cpu().numpy()


def realign_events(genome, readsg, lengths, events, max_mm: int):
    """Dense realignment: (best_t, mm, ok) as (R, E) numpy arrays.

    events: dict of numpy arrays (left, right, kind, ins_len, ins_seq,
    valid); ok is masked by `valid`."""
    R = readsg.shape[0]
    E = len(events["left"])
    best_t = np.zeros((R, E), np.int32)
    mm = np.full((R, E), BIG, np.int32)
    ok = np.zeros((R, E), bool)
    if E == 0:
        return best_t, mm, ok
    for idx, q, args in _groups(genome, readsg, lengths, events):
        bt, m, o = _dense(args, q, max_mm)
        best_t[:, idx] = bt.cpu().numpy()
        mm[:, idx] = m.cpu().numpy()
        ok[:, idx] = o.cpu().numpy()
    ok &= np.asarray(events["valid"]).astype(bool)[None, :]
    return best_t, mm, ok


def realign_events_sparse(genome, readsg, lengths, events, max_mm: int):
    """Flat-result realignment for the production candidate path: returns
    (rows, evs, best_t, mm) numpy arrays of the passing (row, event) pairs
    of valid events only — q-groups in np.unique order, row-major within a
    group. On the card no (R, E) table is made: the kernel writes the
    records (realign_group_sparse)."""
    R = readsg.shape[0]
    E = len(events["left"])
    z = np.zeros(0, np.int32)
    if E == 0 or R == 0:
        return z, z.copy(), z.copy(), z.copy()
    valid = np.asarray(events["valid"]).astype(bool)
    acc = ([], [], [], [])
    for idx, q, args in _groups(genome, readsg, lengths, events):
        vsel = torch.as_tensor(valid[idx], device=genome.device)
        rj, ej, tj, mj = _sparse(args, q, max_mm, vsel)
        acc[0].append(rj)
        acc[1].append(idx[ej].astype(np.int32))
        acc[2].append(tj)
        acc[3].append(mj)
    return tuple(np.concatenate(a) for a in acc)
