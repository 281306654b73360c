"""Multi-event chain stitching.

Port of tophat_tpu/pipeline/chains.py (the reference's long_spanning_reads
join, long_spanning_reads.cpp:2222, 805):
every segment gets genomic hits plus event-crossing hits, and a bounded DFS
chains adjacent segments whose genome coordinates are contiguous,
accumulating the crossed events. Only chains crossing >= 2 events are
emitted — 0- and 1-event placements come from stitch_contiguous and
realign_events_sparse.

The per-segment event hits come from the realign kernel's sparse entry
(ops/events.realign_events_sparse over segment rows): the records of the
ok (segment, event) pairs only, so no (rows*S, E) table is made at an
annotation's event count. The chain join itself is host-side Python over
those records. In the default mode it runs only for reads still
unresolved after contiguous + single-event candidates
(pipeline/run.default_chains); with fusion search it runs over every row,
and cross_strand_chains pairs forward-row and reverse-row chains of a read
into FR/RF fusion chains whose pieces cross junctions or indels. Both take
the same per-segment event hits (one realign call per mate).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from tophat_tpu_torch.index.fm import host_codes
from tophat_tpu_torch.ops.events import realign_events_sparse
from tophat_tpu_torch.ops.splice import (KIND_DELETION, KIND_FUSION,
                                         KIND_INSERTION)
from tophat_tpu_torch.pipeline.segment import GenomeSpaceReads, segment_rows
from tophat_tpu_torch.utils import trace

MAX_TRIES = 10000   # reference: long_spanning_reads.cpp:2647
MAX_EVENTS_PER_CHAIN = 3
MAX_FUSIONS_PER_CHAIN = 1  # reference rejects >=2 fusions (:2698-2700)
CROSS_EXT_MM = 2    # mismatch budget for fusion-break extensions


def _host(a, rows=None):
    """Host numpy view of a segment table (device tensor or numpy), with
    an optional row selection made before the transfer."""
    if isinstance(a, torch.Tensor):
        if rows is not None:
            a = a[torch.as_tensor(rows, device=a.device)]
        return trace.to_host(a)
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


def segment_event_hits(fm, gs, events, params):
    """Per-segment event-crossing hits: realign every segment row against
    the event table through the realign kernel's sparse entry, which
    returns the ok (segment row, event) records only. Returns ((offsets,
    ev, best_t, mm), seg_len (rows, S)): the records sorted by (segment
    row, event), segment row k = row * S + j owning records
    offsets[k]:offsets[k + 1] in ascending event order (the order
    np.nonzero gives over a dense ok table). chain_stitch and
    cross_strand_chains take it as `seg_hits`."""
    seg_reads, seg_len = segment_rows(gs)
    ev = dict(events)
    ev["valid"] = np.ones(len(ev["left"]), bool)
    rows, evs, best_t, mm = realign_events_sparse(
        fm.genome, seg_reads, np.maximum(seg_len.reshape(-1), 1).astype(
            np.int32), ev, max_mm=params.segment_mismatches)
    order = np.lexsort((evs, rows))      # (row, event) pairs are unique
    offsets = np.zeros(seg_reads.shape[0] + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=seg_reads.shape[0]),
              out=offsets[1:])
    return (offsets, evs[order], best_t[order], mm[order]), seg_len


def _hit_tables(fm, gs, seg_tables, events, params, seg_hits):
    """(seg_pos, seg_mm, seg_valid, seg_len) host tables and the segment
    event-hit records (offsets, ev, best_t, mm) of segment_event_hits."""
    seg_pos, seg_mm, seg_valid = (_host(x) for x in seg_tables)
    if seg_hits is None:
        seg_hits = segment_event_hits(fm, gs, events, params)
    seg_ev, seg_len = seg_hits
    return (seg_pos, seg_mm, seg_valid, seg_len), seg_ev


def _row_hit_lists(gs, seg_tables, seg_ev, events, row):
    """Per-segment hit lists for one genome-space row:
    [(start, end, mm, ev, t_seg)], genomic + event-crossing (events in
    ascending index order)."""
    seg_pos, seg_mm, seg_valid, seg_len = seg_tables
    offsets, ev_idx, ev_t, ev_mm = seg_ev
    kinds = events["kind"]
    lefts = events["left"]
    rights = events["right"]
    ilens = events["ins_len"]
    nseg = int(gs.nseg[row])
    S, H = seg_pos.shape[1:]
    hits = []
    for j in range(nseg):
        slen = int(seg_len[row, j])
        lst = []
        for h in range(H):
            if seg_valid[row, j, h]:
                p = int(seg_pos[row, j, h])
                lst.append((p, p + slen, int(seg_mm[row, j, h]), -1, 0))
        k = row * S + j
        for i in range(int(offsets[k]), int(offsets[k + 1])):
            e = int(ev_idx[i])
            t = int(ev_t[i])
            kind = int(kinds[e])
            start = int(lefts[e]) - t + 1
            if kind == KIND_INSERTION:
                end = int(lefts[e]) + 1 + (slen - t - int(ilens[e]))
            else:
                end = int(rights[e]) + (slen - t)
            lst.append((start, end, int(ev_mm[i]), e, t))
        hits.append(lst)
    return hits, nseg


def chain_stitch(fm, gs, seg_tables, events, params,
                 max_chains_per_read: int = 8,
                 seg_hits=None) -> List[ChainCandidate]:
    """Assemble multi-event chains for every genome-space row. seg_hits:
    segment_event_hits' result for these rows, computed here if None."""
    trace.count("chains.rows", gs.rows)
    if gs.rows == 0 or len(events["left"]) == 0:
        return []
    tables4, seg_ev = _hit_tables(fm, gs, seg_tables, events, params,
                                  seg_hits)
    seg_len = tables4[3]
    kinds = events["kind"]
    lefts = events["left"]
    rights = events["right"]
    ilens = events["ins_len"]
    closures = _Closures(events)

    out: List[ChainCandidate] = []
    for row in range(gs.rows):
        nseg = int(gs.nseg[row])
        if nseg < 2 or int(gs.read_idx[row]) < 0:
            continue
        # hit lists per segment: (start, end, mm, ev or -1, t_seg)
        hits, _ = _row_hit_lists(gs, tables4, seg_ev, events, row)
        if not hits[0]:
            continue

        chains = []
        tries = 0

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
    trace.count("chains.found", len(out))
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


class _Closures:
    """The events that close a gap between adjacent ungapped hits ending at
    `end` and starting at `s` (merge_chain pair closure, split within 4
    bases of the boundary; insertion boundary inside the inserted span).
    A closing event's left end lies in [end - 1 - max(4, q), end + 3], so a
    query reads only the events there, through the table sorted by left
    end, and not all E of an annotation-sized table."""

    def __init__(self, events):
        self.kinds = events["kind"]
        self.lefts = events["left"]
        self.rights = events["right"]
        self.ilens = events["ins_len"]
        lefts = np.asarray(self.lefts, np.int64)
        self.order = np.argsort(lefts, kind="stable")
        self.sorted_left = lefts[self.order]
        ins = np.asarray(self.ilens)[np.asarray(self.kinds) == KIND_INSERTION]
        self.reach = 1 + max(4, int(ins.max()) if len(ins) else 0)

    def __call__(self, end, s):
        """Yields (ev, delta) in ascending event order."""
        lo = int(np.searchsorted(self.sorted_left, end - self.reach, "left"))
        hi = int(np.searchsorted(self.sorted_left, end + 3, "right"))
        for e2 in np.sort(self.order[lo:hi]):
            e2 = int(e2)
            d = int(self.lefts[e2]) + 1 - end
            if int(self.kinds[e2]) == KIND_INSERTION:
                q = int(self.ilens[e2])
                if -q <= d <= 0 and s == end - q:
                    yield e2, d
            elif abs(d) <= 4 and s == int(self.rights[e2]) - d:
                yield e2, d


def _prefix_chains(hits, nseg, max_out=16, closures=None):
    """All contiguous chains covering segments 0..j (any j), as
    (j, genome_end, mm, events, path); path holds ("SEG", s, e, ev, t)
    and ("CLOSE", ev, delta) entries. Bounded enumeration; with
    `closures` (a _Closures), adjacent-hit gaps closable by an event
    continue the chain."""
    out = []
    frontier = [(-1, None, 0, (), ())]
    for j in range(nseg):
        nxt = []
        for (_, end, mm, evs, path) in frontier:
            for (s, e, hmm, ev, t) in hits[j]:
                links = []
                if j == 0 or s == end:
                    links.append(None)
                elif closures is not None:
                    links.extend(closures(end, s))
                for link in links[:4]:
                    nevs = evs + (ev,) if ev >= 0 else evs
                    npath = path
                    if link is not None:
                        nevs = nevs + (link[0],)
                        npath = npath + (("CLOSE",) + tuple(link),)
                    if len(nevs) > MAX_EVENTS_PER_CHAIN:
                        continue
                    nxt.append((j, e, mm + hmm, nevs,
                                npath + (("SEG", s, e, ev, t),)))
        frontier = nxt[:max_out]
        out.extend(frontier)
        if not frontier:
            break
    return out


def _suffix_chains(hits, nseg, max_out=16, closures=None):
    """All contiguous chains covering segments j..nseg-1, as
    (j, genome_start, mm, events, path)."""
    out = []
    frontier = [(nseg, None, 0, (), ())]
    for j in range(nseg - 1, -1, -1):
        nxt = []
        for (_, start, mm, evs, path) in frontier:
            for (s, e, hmm, ev, t) in hits[j]:
                links = []
                if j == nseg - 1 or e == start:
                    links.append(None)
                elif closures is not None:
                    links.extend(closures(e, start))
                for link in links[:4]:
                    nevs = (ev,) + evs if ev >= 0 else evs
                    npath = path
                    if link is not None:
                        nevs = (link[0],) + nevs
                        npath = (("CLOSE",) + tuple(link),) + npath
                    if len(nevs) > MAX_EVENTS_PER_CHAIN:
                        continue
                    nxt.append((j, s, mm + hmm, nevs,
                                (("SEG", s, e, ev, t),) + npath))
        frontier = nxt[:max_out]
        out.extend(frontier)
        if not frontier:
            break
    return out


def _path_pos0(path):
    """Genome start of the first SEG entry of a chain path."""
    for entry in path:
        if entry[0] == "SEG":
            return int(entry[1])
    return None


def _ops_from_path(path, seg_len_row, events, extend_last=0):
    """Assemble M/EV ops from a chain path of ("SEG", s, e, ev, t_seg) and
    ("CLOSE", ev, delta) entries (segments consecutive from the path's
    first); extend_last grows the final M run (fusion-break extension)."""
    kinds = events["kind"]
    lefts = events["left"]
    rights = events["right"]
    ilens = events["ins_len"]
    ops: List[Tuple] = []

    def add_m(n):
        if n == 0:
            return
        if ops and ops[-1][0] == "M":
            ops[-1] = ("M", ops[-1][1] + n)
            if ops[-1][1] <= 0:
                ops.pop()
        elif n > 0:
            ops.append(("M", n))

    idx = 0
    carry = 0
    for entry in path:
        if entry[0] == "CLOSE":
            _, e2, d = entry
            kind = int(kinds[e2])
            gap = (int(ilens[e2]) if kind == KIND_INSERTION
                   else max(int(rights[e2]) - int(lefts[e2]) - 1, 0))
            add_m(d)
            carry = -(gap + d) if kind == KIND_INSERTION else -d
            ops.append(("EV", e2, kind, gap))
            continue
        _, s, e, ev, t = entry
        slen = int(seg_len_row[idx])
        idx += 1
        if ev < 0:
            add_m(slen + carry)
            carry = 0
        else:
            kind = int(kinds[ev])
            gap = (int(ilens[ev]) if kind == KIND_INSERTION
                   else max(int(rights[ev]) - int(lefts[ev]) - 1, 0))
            post = slen - t - (gap if kind == KIND_INSERTION else 0)
            add_m(t + carry)
            carry = 0
            ops.append(("EV", ev, kind, gap))
            add_m(post)
    add_m(extend_last)
    return ops


def cross_strand_chains(fm, gs, seg_tables, events, params,
                        max_pairs: int = 128, fr_events=None,
                        seg_hits=None) -> List[ChainCandidate]:
    """FR/RF fusion chains whose pieces may themselves cross events: pair a
    forward-row prefix (suffix) chain with a reverse-row prefix (suffix)
    chain of the same read and scan the uncovered middle for the fusion
    break. Only pairs crossing >= 1 non-fusion event are emitted — pure
    cross-strand fusions come from ops/fusion_fr.py.

    Reference analog: detect_fusion over reverse-complemented sides
    (segment_juncs.cpp:2629) combined with merge_chain gap closing.
    seg_hits: segment_event_hits' result for these rows (None: computed
    here)."""
    if gs.rows == 0 or len(events["left"]) == 0:
        return []
    tables4, seg_ev = _hit_tables(fm, gs, seg_tables, events, params,
                                  seg_hits)
    seg_len = tables4[3]
    genome = host_codes(fm)
    n = genome.shape[0]
    R = gs.rows // 2
    closures = _Closures(events)
    # flank-record anchor floor (juncs_db fusion record geometry: >= 3
    # aligned bases each side; fusion_anchor_length only gates FusionStat
    # counting, fusions.cpp:193)
    fa = 3

    def ext_mm(read_codes, u0, u1, gpos0, step=1):
        """Mismatches of read_codes[u0:u1] vs genome starting gpos0."""
        if u1 <= u0:
            return 0
        idx = gpos0 + step * np.arange(u1 - u0)
        inb = (idx >= 0) & (idx < n)
        g = np.where(inb, genome[np.clip(idx, 0, n - 1)], 5)
        rp = read_codes[u0:u1]
        return int(((g != rp) | (g >= 4) | (rp >= 4)).sum())

    out: List[ChainCandidate] = []
    for r in range(R):
        rf, rr = r, r + R
        if int(gs.read_idx[rf]) < 0:
            continue
        L = int(gs.lengths[rf])
        read_f = gs.readsg[rf]
        read_r = gs.readsg[rr]
        hits_f, nseg_f = _row_hit_lists(gs, tables4, seg_ev, events, rf)
        hits_r, nseg_r = _row_hit_lists(gs, tables4, seg_ev, events, rr)
        if not hits_f or not hits_r:
            continue
        cuts_f = gs.cuts[rf]
        cuts_r = gs.cuts[rr]
        maxseg = int(seg_len[rf].max())

        best = []
        # ---- FR: fwd prefix + rc prefix ----
        pf = _prefix_chains(hits_f, nseg_f, closures=closures)
        pr = _prefix_chains(hits_r, nseg_r, closures=closures)

        # event-anchored virtual pieces: when one strand's piece is too
        # short to hold any mappable segment, anchor it on an already-
        # discovered cross-strand breakpoint (the role of segments mapping
        # juncs_db fusion flank records) and pair it with the other
        # strand's chain, which may itself cross junctions/indels.
        for (pa, pb) in (fr_events or {}).get("fr", ()):
            for (jb, endB, mmB, evsB, pathB) in pr:
                if not evsB:
                    continue
                covB = int(cuts_r[jb + 1])
                s = int(pb) - endB + covB + 1   # piece B total length
                t = L - s
                if not (fa <= t <= L - fa) or s < covB or s - covB > maxseg:
                    continue
                e1 = ext_mm(read_f, 0, t, int(pa) - t + 1)
                e2 = ext_mm(read_r, covB, s, endB)
                if e1 + e2 > CROSS_EXT_MM:
                    continue
                ops = [("M", t), ("FUS", int(pb), "fr")]
                best.append(ChainCandidate(
                    read=int(gs.read_idx[rf]), strand=0,
                    pos=int(pa) - t + 1, mm=mmB + e1 + e2, ops=ops,
                    events=tuple(evsB)))
            for (ja, endA, mmA, evsA, pathA) in pf:
                if not evsA:
                    continue
                covA = int(cuts_f[ja + 1])
                t = int(pa) - endA + covA + 1   # piece A total length
                if not (fa <= t <= L - fa) or t < covA or t - covA > maxseg:
                    continue
                e1 = ext_mm(read_f, covA, t, endA)
                e2 = ext_mm(read_r, 0, L - t, int(pb) - (L - t) + 1)
                if e1 + e2 > CROSS_EXT_MM:
                    continue
                ops = _ops_from_path(pathA, seg_len[rf], events,
                                     extend_last=t - covA)
                ops.append(("FUS", int(pb), "fr"))
                best.append(ChainCandidate(
                    read=int(gs.read_idx[rf]), strand=0,
                    pos=_path_pos0(pathA), mm=mmA + e1 + e2, ops=ops,
                    events=tuple(evsA)))
        for (ra, rb) in (fr_events or {}).get("rf", ()):
            # piece A = fwd suffix starting at ra; piece B = rc suffix
            # starting at rb (covers the read's first t bases, revcomp)
            for (jb, startB, mmB, evsB, pathB) in _suffix_chains(
                    hits_r, nseg_r, closures=closures):
                if not evsB:
                    continue
                tB0 = int(cuts_r[jb])
                t = L - tB0 + (startB - int(rb))
                if not (fa <= t <= L - fa):
                    continue
                back = tB0 - (L - t)
                if back < 0 or back > maxseg:
                    continue
                e1 = ext_mm(read_f, t, L, int(ra))
                e2 = ext_mm(read_r, L - t, tB0, int(rb))
                if e1 + e2 > CROSS_EXT_MM:
                    continue
                ops = [("FUS", int(rb), "rf"), ("M", L - t)]
                best.append(ChainCandidate(
                    read=int(gs.read_idx[rf]), strand=0, pos=int(ra),
                    mm=mmB + e1 + e2, ops=ops, events=tuple(evsB)))
            for (ja, startA, mmA, evsA, pathA) in _suffix_chains(
                    hits_f, nseg_f, closures=closures):
                if not evsA:
                    continue
                tA0 = int(cuts_f[ja])
                t = tA0 - (startA - int(ra))
                if not (fa <= t <= L - fa):
                    continue
                back = tA0 - t
                if back < 0 or back > maxseg:
                    continue
                e1 = ext_mm(read_f, t, tA0, int(ra))
                e2 = ext_mm(read_r, L - t, L, int(rb))
                if e1 + e2 > CROSS_EXT_MM:
                    continue
                ops = [("FUS", int(rb), "rf")]
                ops += _ops_from_path(pathA, seg_len[rf][ja:], events)
                if back:
                    for i2, op in enumerate(ops):
                        if op[0] == "M":
                            ops[i2] = ("M", op[1] + back)
                            break
                best.append(ChainCandidate(
                    read=int(gs.read_idx[rf]), strand=0, pos=int(ra),
                    mm=mmA + e1 + e2, ops=ops, events=tuple(evsA)))

        tried = 0
        for (ja, endA, mmA, evsA, pathA) in pf:
            covA = int(cuts_f[ja + 1])
            for (jb, endB, mmB, evsB, pathB) in pr:
                tried += 1
                if tried > max_pairs:
                    break
                if not evsA and not evsB:
                    continue
                covB = int(cuts_r[jb + 1])
                mid = L - covA - covB
                if mid < 0 or mid > 2 * maxseg:
                    continue
                # best split in the uncovered middle
                cand = None
                for t in range(max(covA, 1), min(L - covB, L - 1) + 1):
                    e1 = ext_mm(read_f, covA, t, endA)
                    e2 = ext_mm(read_r, covB, L - t, endB)
                    if e1 + e2 <= CROSS_EXT_MM and (cand is None
                                                    or e1 + e2 < cand[1]):
                        cand = (t, e1 + e2)
                if cand is None:
                    continue
                t, ext = cand
                if t < fa or L - t < fa:
                    continue
                ops = _ops_from_path(pathA, seg_len[rf], events,
                                     extend_last=t - covA)
                posB = endB + (L - t - covB) - 1
                ops.append(("FUS", int(posB), "fr"))
                best.append(ChainCandidate(
                    read=int(gs.read_idx[rf]), strand=0,
                    pos=_path_pos0(pathA), mm=mmA + mmB + ext, ops=ops,
                    events=tuple(evsA) + tuple(evsB)))

        # ---- RF: fwd suffix + rc suffix ----
        sf = _suffix_chains(hits_f, nseg_f, closures=closures)
        sr = _suffix_chains(hits_r, nseg_r, closures=closures)
        tried = 0
        for (ja, startA, mmA, evsA, pathA) in sf:
            tA0 = int(cuts_f[ja])
            for (jb, startB, mmB, evsB, pathB) in sr:
                tried += 1
                if tried > max_pairs:
                    break
                if not evsA and not evsB:
                    continue
                tB0 = int(cuts_r[jb])
                # piece B covers read[0 : L - tB0]; piece A covers read[t:]
                lo_t = max(L - tB0 - 0, 1)
                mid = tA0 - (L - tB0)
                if mid < 0 or mid > 2 * maxseg:
                    continue
                cand = None
                for t in range(max(L - tB0, 1), min(tA0, L - 1) + 1):
                    e1 = ext_mm(read_f, t, tA0, startA - (tA0 - t))
                    e2 = ext_mm(read_r, L - t, tB0,
                                startB - (tB0 - (L - t)))
                    if e1 + e2 <= CROSS_EXT_MM and (cand is None
                                                    or e1 + e2 < cand[1]):
                        cand = (t, e1 + e2)
                if cand is None:
                    continue
                t, ext = cand
                if t < fa or L - t < fa:
                    continue
                ops = [("FUS", int(startB + (tB0 - (L - t))), "rf")]
                ops += _ops_from_path(pathA, seg_len[rf][ja:], events)
                # prepend the backward extension to the first M run
                if t < tA0:
                    for i2, op in enumerate(ops):
                        if op[0] == "M":
                            ops[i2] = ("M", op[1] + (tA0 - t))
                            break
                best.append(ChainCandidate(
                    read=int(gs.read_idx[rf]), strand=0,
                    pos=int(startA - (tA0 - t)), mm=mmA + mmB + ext,
                    ops=ops, events=tuple(evsA) + tuple(evsB)))
        out.extend(best[:4])
    return out
