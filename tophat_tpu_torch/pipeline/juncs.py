"""Junction / indel discovery driver (the segment_juncs stage).

Port of tophat_tpu/pipeline/juncs.py: segment hit tables -> pair windows
-> motif scans (device) -> a unique event table (host numpy), consumed by
ops/events.realign_events. Fusion discovery is not ported yet.
"""

from __future__ import annotations

import warnings
from typing import Dict

import numpy as np
import torch

from tophat_tpu_torch.ops.events import MAX_INS
from tophat_tpu_torch.ops.splice import (KIND_DELETION, KIND_INSERTION,
                                         KIND_JUNCTION, build_indel_pairs,
                                         build_pair_windows,
                                         compact_scan_hits, compact_windows,
                                         scan_indel_pairs, scan_windows)
from tophat_tpu_torch.pipeline.segment import GenomeSpaceReads, map_segments

MAX_WINDOWS = 32768
# junction scan hits are capped independently of the window count: every
# window can yield several motif hits
MAX_SCAN_HITS = MAX_WINDOWS * 4
MAX_INDEL_PAIRS = 16384


def empty_events() -> Dict[str, np.ndarray]:
    return dict(left=np.zeros(0, np.int32), right=np.zeros(0, np.int32),
                kind=np.zeros(0, np.int8), antisense=np.zeros(0, bool),
                ins_len=np.zeros(0, np.int8),
                ins_seq=np.zeros((0, MAX_INS), np.int8))


def merge_events(*tables: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {}
    for k in empty_events():
        out[k] = np.concatenate([t[k] for t in tables])
    return dedup_events(out)


def dedup_events(ev: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Unique by (kind, left, right, antisense) — first occurrence wins
    (insertions with different sequences at one coordinate collapse to the
    first one seen, in read order)."""
    if len(ev["left"]) == 0:
        return ev
    key = np.stack([ev["kind"].astype(np.int64), ev["left"].astype(np.int64),
                    ev["right"].astype(np.int64),
                    ev["antisense"].astype(np.int64)], axis=1)
    _, idx = np.unique(key, axis=0, return_index=True)
    idx = np.sort(idx)
    return {k: v[idx] for k, v in ev.items()}


def _library_type_keep(params, strands, rev, read_side):
    """Strand-specific protocols restrict which splice directions a read
    may support (reference: segment_juncs.cpp:2110-2137)."""
    if params.library_type == "fr-unstranded":
        return np.ones_like(rev, bool)
    anti = strands.astype(bool)
    side_right = read_side == 1
    skip_rev = anti ^ side_right        # fr-firststrand rule
    if params.library_type == "fr-secondstrand":
        skip_rev = ~skip_rev
    return np.where(rev, ~skip_rev, skip_rev)


def discover_events(fm, offsets, gs: GenomeSpaceReads, params,
                    seg_tables=None, log=None,
                    read_side: int = 0) -> Dict[str, np.ndarray]:
    """Split-segment junction search + small-indel detection for one batch
    of genome-space reads. Returns the deduped event table (numpy)."""
    if gs.rows == 0:
        return empty_events()
    if params.fusion_search:
        raise NotImplementedError(
            "fusion discovery is not ported yet (ROADMAP Queue 1, fusion)")
    if seg_tables is None:
        seg_tables = map_segments(
            fm, offsets, gs, segment_mismatches=params.segment_mismatches,
            hits_per_seed=params.hits_per_seed, max_hits=16)
    seg_pos, seg_mm, seg_valid = seg_tables

    dev = fm.device
    readsg = torch.as_tensor(gs.readsg, device=dev)
    cuts = torch.as_tensor(gs.cuts, device=dev).long()
    nseg = torch.as_tensor(gs.nseg, device=dev).long()
    lengths = torch.as_tensor(gs.lengths, device=dev).long()

    # --- junction windows -------------------------------------------------
    win = build_pair_windows(
        seg_pos, seg_valid, cuts, nseg, lengths,
        params.min_segment_intron, params.max_segment_intron,
        params.segment_length)
    win, w_ovf = compact_windows(win, MAX_WINDOWS)
    if w_ovf:
        warnings.warn(
            f"junction windows overflowed {MAX_WINDOWS} slots; some "
            "candidates were dropped (raise MAX_WINDOWS or reduce the "
            "chunk size)", stacklevel=2)
    sup_max = int(np.max(gs.cuts[:, 1:] - gs.cuts[:, :-1])) + 16 + 1
    jl, jr, jrev, jvalid = scan_windows(fm.genome, readsg, win, sup_max)
    cl, cr, crev, crow, cnt, covf = compact_scan_hits(
        jl, jr, jrev, jvalid, win.row, MAX_SCAN_HITS)
    if covf:
        warnings.warn(
            f"junction scan hits overflowed {MAX_SCAN_HITS} slots; "
            "some candidates were dropped (raise MAX_SCAN_HITS or "
            "reduce the chunk size)", stacklevel=2)
    jl = cl[:cnt].cpu().numpy()
    jr = cr[:cnt].cpu().numpy()
    jrev = crev[:cnt].cpu().numpy().astype(bool)
    if params.library_type != "fr-unstranded":
        row_strand = gs.strand[crow[:cnt].cpu().numpy()]
        keep_dir = _library_type_keep(params, row_strand, jrev, read_side)
        jl, jr, jrev = jl[keep_dir], jr[keep_dir], jrev[keep_dir]
    juncs = dict(left=jl.astype(np.int32), right=jr.astype(np.int32),
                 kind=np.full(len(jl), KIND_JUNCTION, np.int8),
                 antisense=jrev.astype(bool),
                 ins_len=np.zeros(len(jl), np.int8),
                 ins_seq=np.full((len(jl), MAX_INS), -1, np.int8))

    # --- indels -----------------------------------------------------------
    indels = empty_events()
    if params.allow_indels:
        pairs, p_ovf = build_indel_pairs(
            seg_pos, seg_mm, seg_valid, cuts, nseg,
            params.max_deletion_length, params.max_insertion_length,
            MAX_INDEL_PAIRS)
        if p_ovf:
            warnings.warn(
                f"indel pairs overflowed {MAX_INDEL_PAIRS} slots; some "
                "candidates were dropped (raise MAX_INDEL_PAIRS or reduce "
                "the chunk size)", stacklevel=2)
        two_seg_max = int(2 * np.max(gs.cuts[:, 1:] - gs.cuts[:, :-1])) + 1
        out = scan_indel_pairs(fm.genome, readsg, lengths, pairs,
                               two_seg_max)
        kind, left, right, ins_len, valid, _, rowf, ins_off = (
            a.cpu().numpy() for a in out)
        kind, left, right = kind[valid], left[valid], right[valid]
        ins_len = ins_len[valid]
        rowf = rowf[valid]
        ins_off = ins_off[valid]
        ins_seq = np.full((len(kind), MAX_INS), -1, np.int8)
        for i in range(len(kind)):
            if kind[i] == KIND_INSERTION and ins_len[i] > 0:
                s = gs.readsg[rowf[i], ins_off[i]: ins_off[i] + ins_len[i]]
                ins_seq[i, : len(s)] = s
        indels = dict(left=left.astype(np.int32), right=right.astype(np.int32),
                      kind=kind.astype(np.int8),
                      antisense=np.zeros(len(kind), bool),
                      ins_len=ins_len.astype(np.int8), ins_seq=ins_seq)

    ev = merge_events(juncs, indels)

    # contig-consistency guard: junctions/deletions must not span contig
    # boundaries of the concatenated genome
    if len(ev["left"]):
        offs = np.asarray(offsets, np.int64)
        cid_l = np.searchsorted(offs, ev["left"], side="right")
        cid_r = np.searchsorted(offs, ev["right"], side="right")
        keep = ((ev["kind"] == KIND_INSERTION)
                | ((cid_l == cid_r) & (ev["left"] < ev["right"])))
        ev = {k: v[keep] for k, v in ev.items()}

    if log:
        nj = int((ev["kind"] == KIND_JUNCTION).sum())
        nd = int((ev["kind"] == KIND_DELETION).sum())
        ni = int((ev["kind"] == KIND_INSERTION).sum())
        log(f"Found {nj} potential split-segment junctions")
        log(f"Found {nd} potential small deletions")
        log(f"Found {ni} potential small insertions")
    return ev
