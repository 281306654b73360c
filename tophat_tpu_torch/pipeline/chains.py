"""Multi-event chain stitching for the default (non-fusion) mode.

Port of the default-mode part of tophat_tpu/pipeline/chains.py (the
reference's long_spanning_reads join, long_spanning_reads.cpp:2222, 805):
every segment gets genomic hits plus event-crossing hits, and a bounded DFS
chains adjacent segments whose genome coordinates are contiguous,
accumulating the crossed events. Only chains crossing >= 2 events are
emitted — 0- and 1-event placements come from stitch_contiguous and
realign_events_sparse.

The per-segment event-hit tables come from the realign kernel
(ops/events.realign_events over segment rows); the chain join itself is
host-side Python over those tables, run only for reads still unresolved
after contiguous + single-event candidates (pipeline/run.default_chains).
The cross-strand (fusion) chains are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from tophat_tpu_torch.index.fm import host_codes
from tophat_tpu_torch.ops.events import realign_events
from tophat_tpu_torch.ops.splice import (KIND_DELETION, KIND_FUSION,
                                         KIND_INSERTION)
from tophat_tpu_torch.pipeline.segment import GenomeSpaceReads, segment_rows

MAX_TRIES = 10000   # reference: long_spanning_reads.cpp:2647
MAX_EVENTS_PER_CHAIN = 3
MAX_FUSIONS_PER_CHAIN = 1  # reference rejects >=2 fusions (:2698-2700)


def _host(a, rows=None):
    """Host numpy view of a segment table (device tensor or numpy), with
    an optional row selection made before the transfer."""
    if isinstance(a, torch.Tensor):
        if rows is not None:
            a = a[torch.as_tensor(rows, device=a.device)]
        return a.cpu().numpy()
    a = np.asarray(a)
    return a if rows is None else a[rows]


def subset_rows(gs, seg_tables, rows_sel):
    """Restrict a GenomeSpaceReads + its segment tables to a row subset
    (compact view) so chain stitching pays only for the rows that need it —
    in a default (non-fusion) run, the reads still unresolved after
    contiguous + single-event candidates."""
    rows_sel = np.asarray(rows_sel, np.int64)
    n = len(rows_sel)
    npad = (1 << max(2, int(n - 1).bit_length())) - n  # pow2: stable jit
    #                                                    shapes across chunks
    pad_rows = np.repeat(rows_sel[:1], npad)
    rows_p = np.concatenate([rows_sel, pad_rows])
    read_idx = gs.read_idx[rows_p].copy()
    read_idx[n:] = -1                       # padding rows are skipped
    sub = GenomeSpaceReads(
        readsg=gs.readsg[rows_p], lengths=gs.lengths[rows_p],
        cuts=gs.cuts[rows_p], nseg=gs.nseg[rows_p],
        read_idx=read_idx, strand=gs.strand[rows_p])
    sub_tables = tuple(_host(a, rows_p) for a in seg_tables)
    return sub, sub_tables


@dataclasses.dataclass
class ChainCandidate:
    read: int
    strand: int
    pos: int                 # genome start of the first piece
    mm: int
    ops: List[Tuple]         # ("M", len) | ("EV", ev, kind, gap) |
                             # ("FUS", partner_pos, dir)
    events: Tuple[int, ...]  # crossed event indices, in read order

    @property
    def edit_dist(self) -> int:
        e = self.mm
        for op in self.ops:
            if op[0] == "EV" and op[2] in (KIND_DELETION, KIND_INSERTION):
                e += op[3]
        return e

    @property
    def n_fusions(self) -> int:
        return sum(1 for op in self.ops
                   if op[0] == "EV" and op[2] == KIND_FUSION)


def _segment_event_hits(fm, gs, events, params):
    """Per-segment event-crossing hits: realign every segment row against
    the event table. Returns ((best_t, mm, ok) shaped (rows*S, E),
    seg_len (rows, S))."""
    seg_reads, seg_len = segment_rows(gs)
    ev = dict(events)
    ev["valid"] = np.ones(len(ev["left"]), bool)
    return realign_events(
        fm.genome, seg_reads, np.maximum(seg_len.reshape(-1), 1).astype(
            np.int32), ev, max_mm=params.segment_mismatches), seg_len


def chain_stitch(fm, gs, seg_tables, events, params,
                 max_chains_per_read: int = 8) -> List[ChainCandidate]:
    """Assemble multi-event chains for every genome-space row."""
    if gs.rows == 0 or len(events["left"]) == 0:
        return []
    seg_pos, seg_mm, seg_valid = (_host(x) for x in seg_tables)
    (ev_t, ev_mm, ev_ok), seg_len = _segment_event_hits(fm, gs, events,
                                                        params)
    rows, S, H = seg_pos.shape
    ev_t = ev_t.reshape(rows, S, -1)
    ev_mm = ev_mm.reshape(rows, S, -1)
    ev_ok = ev_ok.reshape(rows, S, -1)
    kinds = events["kind"]
    lefts = events["left"]
    rights = events["right"]
    ilens = events["ins_len"]

    out: List[ChainCandidate] = []
    for row in range(rows):
        nseg = int(gs.nseg[row])
        if nseg < 2 or int(gs.read_idx[row]) < 0:
            continue
        # hit lists per segment: (start, end, mm, ev or -1, t_seg)
        hits: List[List[Tuple[int, int, int, int, int]]] = []
        for j in range(nseg):
            slen = int(seg_len[row, j])
            lst = []
            for h in range(H):
                if seg_valid[row, j, h]:
                    p = int(seg_pos[row, j, h])
                    lst.append((p, p + slen, int(seg_mm[row, j, h]), -1, 0))
            for e in np.nonzero(ev_ok[row, j])[0]:
                t = int(ev_t[row, j, e])
                kind = int(kinds[e])
                start = int(lefts[e]) - t + 1
                if kind == KIND_INSERTION:
                    end = int(lefts[e]) + 1 + (slen - t - int(ilens[e]))
                else:
                    end = int(rights[e]) + (slen - t)
                lst.append((start, end, int(ev_mm[row, j, e]), int(e), t))
            hits.append(lst)
        if not hits[0]:
            continue

        chains = []
        tries = 0

        def closures(end, s):
            """Events that close a gap between adjacent UNGAPPED segment
            hits ending at `end` and starting at `s` — merge_chain's pair
            closure with the split up to 4 bases from the boundary
            (long_spanning_reads.cpp:1341); for insertions the boundary
            must fall inside the inserted span (:1036). Yields (ev, delta)
            where delta = split read-offset minus the boundary offset."""
            for e2 in range(len(kinds)):
                k2 = int(kinds[e2])
                d = int(lefts[e2]) + 1 - end
                if k2 == KIND_INSERTION:
                    q = int(ilens[e2])
                    if -q <= d <= 0 and s == end - q:
                        yield e2, d
                else:
                    if abs(d) <= 4 and s == int(rights[e2]) - d:
                        yield e2, d

        def dfs(j, end, mm, evs, path):
            nonlocal tries
            if tries > MAX_TRIES or len(chains) >= max_chains_per_read:
                return
            if j == nseg:
                if len(evs) >= 2:
                    chains.append((mm, tuple(evs), tuple(path)))
                return
            for (s, e, hmm, ev, t) in hits[j]:
                tries += 1
                nevs = evs + [ev] if ev >= 0 else evs
                if len(nevs) > MAX_EVENTS_PER_CHAIN:
                    continue
                nf = sum(1 for x in nevs if kinds[x] == KIND_FUSION)
                if nf > MAX_FUSIONS_PER_CHAIN:
                    continue
                if j == 0 or s == end:
                    dfs(j + 1, e, mm + hmm, nevs,
                        path + [("SEG", j, s, e, ev, t)])
                else:
                    for e2, d in closures(end, s):
                        cevs = nevs + [e2]
                        if len(cevs) > MAX_EVENTS_PER_CHAIN:
                            continue
                        if (sum(1 for x in cevs
                                if kinds[x] == KIND_FUSION)
                                > MAX_FUSIONS_PER_CHAIN):
                            continue
                        dfs(j + 1, e, mm + hmm, cevs,
                            path + [("CLOSE", e2, d),
                                    ("SEG", j, s, e, ev, t)])

        dfs(0, -1, 0, [], [])
        row_codes = gs.readsg[row]
        genome = host_codes(fm)
        for mm, evs, path in chains:
            # assemble ops: merge M runs, insert event ops at crossings
            ops: List[Tuple] = []

            def add_m(x):
                if x == 0:
                    return
                if ops and ops[-1][0] == "M":
                    ops[-1] = ("M", ops[-1][1] + x)  # x<0 shrinks (closures
                    #                                  shift <=4 bases)
                    if ops[-1][1] <= 0:
                        ops.pop()
                elif x > 0:
                    ops.append(("M", x))

            carry = 0  # read bases borrowed across a closure boundary
            pos0 = None
            for entry in path:
                if entry[0] == "CLOSE":
                    _, e2, d = entry
                    kind = int(kinds[e2])
                    gap = (int(ilens[e2]) if kind == KIND_INSERTION
                           else max(int(rights[e2]) - int(lefts[e2]) - 1, 0))
                    if kind == KIND_INSERTION:
                        add_m(d)               # d <= 0 shrinks the last M
                        carry = -(gap + d)
                    else:
                        add_m(d)
                        carry = -d
                    ops.append(("EV", e2, kind, gap))
                    continue
                _, j, s, e, ev, t = entry
                if pos0 is None:
                    pos0 = s
                slen = int(seg_len[row, j])
                if ev < 0:
                    add_m(slen + carry)
                    carry = 0
                else:
                    kind = int(kinds[ev])
                    gap = (int(ilens[ev]) if kind == KIND_INSERTION
                           else max(int(rights[ev]) - int(lefts[ev]) - 1, 0))
                    pre, post = t, slen - t
                    if kind == KIND_INSERTION:
                        post -= gap
                    add_m(pre + carry)
                    carry = 0
                    ops.append(("EV", ev, kind, gap))
                    add_m(post)
            mm = _chain_mm(genome, row_codes, pos0, ops, events)
            if mm is None:
                continue
            out.append(ChainCandidate(
                read=int(gs.read_idx[row]), strand=int(gs.strand[row]),
                pos=pos0, mm=mm, ops=ops, events=evs))
    return out


def _chain_mm(genome, row_codes, pos0, ops, events):
    """Exact mismatch count of a chain alignment (closures shift bases to
    the other side of an event, so per-hit raw counts over/under-count).
    Returns None when any op walks out of bounds."""
    n = genome.shape[0]
    rights = events["right"]
    gp = pos0
    rp = 0
    mm = 0
    for op in ops:
        if op[0] == "M":
            ln = op[1]
            if ln < 0 or gp < 0 or gp + ln > n:
                return None
            g = genome[gp:gp + ln]
            r = row_codes[rp:rp + ln]
            if len(r) < ln:
                return None
            mm += int(((g != r) | (g >= 4) | (r >= 4)).sum())
            gp += ln
            rp += ln
        elif op[0] == "EV":
            _, ev, kind, gap = op
            if kind == KIND_INSERTION:
                # inserted bases vs the event sequence
                seq = events["ins_seq"][ev][:gap]
                r = row_codes[rp:rp + gap]
                mm += int(((r != seq[: len(r)]) | (r >= 4)).sum())
                rp += gap
            elif kind == KIND_FUSION:
                gp = int(rights[ev])
            else:
                gp = int(rights[ev]) + (gp - int(events["left"][ev]) - 1)
    return mm
