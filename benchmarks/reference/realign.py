"""The plain reference for the realignment layer.

One call of the port's realignment entry (ops/events.realign_events_sparse)
takes read rows, their lengths, an event table and a mismatch cap, and
returns the passing (row, event, split, mismatches) records. This file
works the records out again in plain PyTorch from the benchmark's own
genome codes: the targets from the event coordinates, then for every
split the matches as a 0/1 product (float32, TF32 off: sums of at most
a row's width of 0/1 products are exact). It imports nothing of the port;
its arithmetic is a frozen copy of the port's realign_plain and
prepare_targets.

The rule, per insertion-length group q (q = ins_len for insertions, else
0), for each row of length len and each event:
  mm(t) = (t - matchL(t)) + ((len - t) - matchC(t)),  1 <= t <= len-1-q
where read[0:t] is held against the genome ending at the event's left
base and read[t:] against [the inserted bases | the genome from `right`
(junctions, deletions) or left + 1 (insertions)]; a position matches when
the codes are equal and lie in 0..7; genome positions off the genome read
5. The record is the leftmost t of least mm, kept when mm <= max_mm.
"""

from __future__ import annotations

import numpy as np
import torch

KIND_INSERTION = 2
CHANNELS = 8
OFF_GENOME = 5


def targets(genome, left, right, kind, ins_seq, q: int, L: int):
    """int8 (E, L) left flanks and (E, L) right-hand targets on the
    genome's device; `left`/`right` are int64 tensors."""
    n = genome.shape[0]
    dev = genome.device
    ar = torch.arange(L, device=dev)

    def window(first, width):
        idx = first[:, None] + ar[:width]
        inside = (idx >= 0) & (idx < n)
        return torch.where(inside, genome[idx.clamp(0, n - 1)],
                           torch.tensor(OFF_GENOME, dtype=torch.int8,
                                        device=dev))

    flank_l = window(left - (L - 1), L)
    start_r = torch.where(kind == KIND_INSERTION, left + 1, right)
    comb = torch.cat([ins_seq[:, :q].to(torch.int8), window(start_r, L - q)],
                     dim=1)
    return flank_l, comb


def best_splits(reads, lengths, flank_l, comb, q: int, max_mm: int):
    """(best_t, mm, ok), each (R, E): the leftmost split of least
    mismatches of every row against every event of one q-group."""
    R, L = reads.shape
    E = flank_l.shape[0]
    dev = reads.device
    ch = torch.arange(CHANNELS, device=dev)
    onehot = lambda x: (x.long()[..., None] == ch).float()
    X = onehot(reads).reshape(R, L * CHANNELS)
    T = onehot(torch.cat([flank_l, comb], 1)).reshape(E, 2 * L * CHANNELS)
    lens = lengths.long()[:, None, None]
    big = torch.iinfo(torch.int32).max
    best = torch.full((R, E), big, dtype=torch.long, device=dev)
    best_t = torch.zeros((R, E), dtype=torch.long, device=dev)
    step = max(1, (1 << 25) // max(1, E * L * CHANNELS, R * E))
    for t0 in range(1, L, step):
        k = min(L - t0, step)
        # the windows of splits t0 + k - 1 down to t0: the read's first
        # base sits at target position L - t
        win = T.as_strided((E, k, L * CHANNELS), (2 * L * CHANNELS,
                                                  CHANNELS, 1),
                           (L - t0 - k + 1) * CHANNELS)
        match = (X @ win.reshape(E * k, L * CHANNELS).T).reshape(R, E, k)
        t = torch.arange(t0 + k - 1, t0 - 1, -1, device=dev)
        mm = torch.where(t + q <= lens - 1, lens - match.long(), big)
        low = mm.min(dim=2).values
        t_low = torch.where(mm == low[..., None], t, L).min(dim=2).values
        upd = low < best
        best = torch.where(upd, low, best)
        best_t = torch.where(upd, t_low, best_t)
    return best_t, best, best <= max_mm


def records(genome_codes, rows, lengths, events, max_mm: int,
            device="cpu", event_block: int = 4096, left=None, right=None):
    """{(row, event, split, mm)} of the rows `rows` ((R, L) int8 codes,
    lengths (R,)) against every valid event, worked out from the genome.
    `left`/`right` replace the event coordinates (the control)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        g = torch.as_tensor(np.asarray(genome_codes, np.int8), device=device)
        reads = torch.as_tensor(np.asarray(rows, np.int8), device=device)
        lens = torch.as_tensor(np.asarray(lengths, np.int64), device=device)
        L = reads.shape[1]
        kind = np.asarray(events["kind"])
        ilen = np.where(kind == KIND_INSERTION,
                        np.asarray(events["ins_len"]), 0).astype(np.int64)
        valid = np.asarray(events.get("valid", np.ones(len(kind), bool)),
                           bool)
        left = np.asarray(events["left"] if left is None else left, np.int64)
        right = np.asarray(events["right"] if right is None else right,
                           np.int64)
        ins_seq = np.asarray(events["ins_seq"])
        out = set()
        for q in np.unique(ilen):
            idx = np.nonzero((ilen == q) & valid)[0]
            for b in range(0, len(idx), event_block):
                ev = idx[b:b + event_block]
                sel = lambda a: torch.as_tensor(a[ev], device=device)
                fl, comb = targets(g, sel(left), sel(right), sel(kind),
                                   sel(ins_seq), int(q), L)
                bt, mm, ok = best_splits(reads, lens, fl, comb, int(q),
                                         max_mm)
                r, e = torch.nonzero(ok, as_tuple=True)
                for rr, ee, tt, m in zip(r.tolist(), e.tolist(),
                                         bt[r, e].tolist(),
                                         mm[r, e].tolist()):
                    out.add((rr, int(ev[ee]), tt, m))
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def compare(call, genome_codes, rows: np.ndarray, device="cpu", left=None,
            right=None) -> int:
    """Records of the sampled rows `rows` on which one captured call of
    the realignment entry and the reference disagree (missing, extra or
    different), counted once each side."""
    readsg, lengths, events, max_mm, (r, e, t, m) = call
    readsg = np.asarray(readsg)
    lengths = np.asarray(lengths)
    ref = records(genome_codes, readsg[rows], lengths[rows], events, max_mm,
                  device=device, left=left, right=right)
    pos = {int(x): k for k, x in enumerate(rows)}
    got = {(pos[int(a)], int(b), int(c), int(d))
           for a, b, c, d in zip(r, e, t, m) if int(a) in pos}
    return len(ref ^ got)
