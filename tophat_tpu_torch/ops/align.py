"""End-to-end unspliced read alignment: pigeonhole seeding + verification.

Port of tophat_tpu/ops/align.py (Bowtie1 `-v <k>` semantics: split each
read into k+1 pieces, exact-search every piece, verify every candidate
placement against the word-packed genome). Reverse-strand placements come
from the reverse-complemented reads against the same forward index.

The TPU package ranks slots with an all-pairs comparison and moves them
with a one-hot matmul (_lex_rank/_permute_by_rank) because row sorts are
slow on a TPU; here one stable torch.sort on a composite key does both.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from tophat_tpu_torch.index.fasta import revcomp
from tophat_tpu_torch.ops.rank import rank
from tophat_tpu_torch.ops.search import backward_search, resolve_sa
from tophat_tpu_torch.ops.verify import (count_mismatches_packed, pack_reads,
                                         same_contig)
from tophat_tpu_torch.parallel import auto
from tophat_tpu_torch.utils import trace

NEG = 2 ** 30   # sentinel candidate offset for invalid seed lanes


@dataclasses.dataclass
class Alignments:
    """Fixed-width per-read alignment table (struct of arrays): all
    placements of read b live in row b, valid ones flagged by `valid`.
    pos is a 0-based global genome coordinate of the leftmost aligned base;
    strand 0 = forward, 1 = reverse complement. Fields are tensors on the
    device, or numpy arrays once transferred (transfer_alignments)."""

    pos: Any        # int32 (B, M)
    strand: Any     # int8  (B, M)
    mm: Any         # int8  (B, M) mismatch count
    valid: Any      # bool  (B, M)
    n_hits: Any     # int32 (B,) total valid placements (pre-truncation)
    truncated: Any  # bool (B,) seed-hit cap hit; counts may be lower bounds


def sort_slots(keys, arrays, width: int):
    """Stable row-wise sort of `arrays` by the int64 composite `keys`
    (B, W), truncated or zero-padded to `width` columns."""
    order = torch.sort(keys, dim=1, stable=True).indices[:, :width]
    out = []
    for a in arrays:
        s = torch.gather(a, 1, order)
        if s.shape[1] < width:
            s = torch.cat([s, s.new_zeros((s.shape[0], width - s.shape[1]))],
                          dim=1)
        out.append(s)
    return out


def _piece_queries(reads, lengths, num_pieces: int, piece_len: int):
    """Cut each read into num_pieces contiguous pieces, right-aligned into a
    (B, num_pieces, piece_len) query array padded with -1; also return piece
    start offsets (B, num_pieces) and piece lengths."""
    B, L = reads.shape
    dev = reads.device
    j = torch.arange(num_pieces, device=dev)
    s = (j[None, :] * lengths[:, None]) // num_pieces
    e = ((j[None, :] + 1) * lengths[:, None]) // num_pieces
    plen = e - s
    t = torch.arange(piece_len, device=dev)
    src = s[:, :, None] + t[None, None, :] - (piece_len - plen)[:, :, None]
    ok = src >= s[:, :, None]
    b_idx = torch.arange(B, device=dev)[:, None, None]
    q = reads[b_idx, src.clamp(0, L - 1)].long()
    return torch.where(ok, q, -1), s, plen


def _key_window(reads, end: int, k: int):
    """(B, k) codes at columns end-1, end-2, ..., end-k of every row, the
    k-mer window of a piece ending at `end`: a reversed column slice, or
    clamped columns where the window leaves the row."""
    L = reads.shape[1]
    if k <= end <= L:
        return reads[:, end - k:end].flip(1)
    cols = (end - 1 - torch.arange(k, device=reads.device)).clamp(0, L - 1)
    return reads[:, cols]


def _fast_seed_intervals(fm, reads, lengths, P: int, span: int,
                         uniform_len: int = 0):
    """SA intervals for the last `span` characters of each of the P
    pigeonhole pieces, via the k-mer table. Requires span >= k and every
    piece length >= span (kmer_fast_ok).

    uniform_len: the read length when every row has it. The piece
    boundaries are then Python ints, and the key bases come from column
    slices instead of a row-wise gather.

    Returns (lo, hi, cand_base): (B, P) interval bounds and the candidate
    read-start offset base (piece_end - span)."""
    k = fm.kmer_k
    B, L = reads.shape
    dev = reads.device
    j = torch.arange(1, P + 1, device=dev)
    t_off = torch.arange(k, device=dev)
    if uniform_len:
        ends = [(jj * uniform_len) // P for jj in range(1, P + 1)]
        e = ((j * uniform_len) // P)[None, :]
        s = (((j - 1) * uniform_len) // P)[None, :]
        x = torch.stack([_key_window(reads, ee, k) for ee in ends],
                        dim=1).long()                   # (B, P, k)
        cols = e[:, :, None] - 1 - t_off[None, None, :]
    else:
        e = (j[None, :] * lengths[:, None]) // P       # piece ends (B, P)
        s = ((j - 1)[None, :] * lengths[:, None]) // P
        cols = e[:, :, None] - 1 - t_off[None, None, :]  # (B, P, k)
        x = torch.gather(reads.long(), 1, cols.clamp(0, L - 1).reshape(
            B, P * k)).reshape(B, P, k)
    pw = 4 ** t_off
    key_e = (x.clamp(0, 3) * pw).sum(dim=2)
    kok = ((x >= 0) & (x <= 3) & (cols >= 0)).all(dim=2)
    ok = kok & (e - s >= span) & (e >= span)
    lo = torch.where(ok, fm.kmer_lo[key_e].long(), 0)
    hi = torch.where(ok, fm.kmer_hi[key_e].long(), 0)
    if span > k:
        # extend the table interval by the span-k characters preceding the
        # k-mer window (backward search continues leftward)
        C = fm.C.long()
        b_idx = torch.arange(B, device=dev)[:, None]
        for t in range(span - k):
            if uniform_len:
                c = torch.stack([reads[:, min(max(ee - k - 1 - t, 0), L - 1)]
                                 for ee in ends], dim=1).long()
            else:
                c = reads[b_idx, (e - k - 1 - t).clamp(0, L - 1)].long()
            is_n = c > 3
            do = (c >= 0) & ~is_n & (lo < hi)
            cc = c.clamp(0, 3)
            nlo = torch.where(do, C[cc] + rank(fm, cc, lo), lo)
            nhi = torch.where(do, C[cc] + rank(fm, cc, hi), hi)
            hi = torch.where(is_n, nlo, nhi)
            lo = nlo
    return lo, hi, (e - span).expand(B, P)


def seed_span(fm, max_mismatches: int, read_len: int):
    """Width of the shortened seed search (see _align_one_strand)."""
    P = max_mismatches + 1
    piece_len = (read_len + P - 1) // P + 1
    k = getattr(fm, "kmer_k", 0)
    if not k:
        return piece_len
    extend = max(0, math.ceil(math.log(max(4 * fm.n, 4), 4)) - k)
    return min(piece_len, k + extend)


def kmer_fast_ok(fm, min_read_len: int, max_mismatches: int) -> bool:
    """True when seed shortening is complete for every read length >=
    min_read_len (the shortest piece must still cover the shortened span)."""
    k = getattr(fm, "kmer_k", 0)
    if not k:
        return False
    P = max_mismatches + 1
    extend = max(0, math.ceil(math.log(max(4 * fm.n, 4), 4)) - k)
    return (min_read_len // P) >= k + extend


def _flat_compact(valid, K: int, vals):
    """Keep the first K valid lanes of flat `valid` in lane order. Returns
    (keep mask, slot of each lane (K for dropped), compacted values). Every
    lane is scattered, the dropped ones onto the spare slot K: a boolean
    mask index would read its count back to the host."""
    csum = torch.cumsum(valid.long(), 0)
    keep = valid & (csum <= K)
    slot = torch.where(keep, csum - 1, K)
    outs = []
    for v in vals:
        o = torch.zeros(K + 1, dtype=v.dtype, device=v.device)
        o[slot] = v
        outs.append(o[:K])
    return keep, slot, outs


def _first_occurrence(cand):
    """(B, W) -> True where an equal value appears earlier in the row."""
    srt, order = torch.sort(cand, dim=1, stable=True)
    dup_sorted = torch.zeros_like(cand, dtype=torch.bool)
    dup_sorted[:, 1:] = srt[:, 1:] == srt[:, :-1]
    dup = torch.zeros_like(dup_sorted)
    dup.scatter_(1, order, dup_sorted)
    return dup


def _align_one_strand(fm, reads, lengths, max_mismatches: int,
                      hits_per_seed: int, verify_slots: int = 32,
                      kmer_fast: bool = False, resolve_cap: int = 0,
                      uniform_len: int = 0):
    """All placements of `reads` on the forward text with <= max_mismatches.

    Returns (cand_pos, cand_mm, cand_valid, truncated) with the candidate
    tables (B, P * hits_per_seed)."""
    B, L = reads.shape
    dev = reads.device
    P = max_mismatches + 1
    piece_len = (L + P - 1) // P + 1

    if kmer_fast:
        span = seed_span(fm, max_mismatches, L)
        lo, hi, cand_base = _fast_seed_intervals(fm, reads, lengths, P, span,
                                                 uniform_len=uniform_len)
    else:
        span = piece_len
        q, piece_start, plen = _piece_queries(reads, lengths, P, piece_len)
        lo, hi = backward_search(fm, q[:, :, piece_len - span:]
                                 .reshape(B * P, span))
        lo = lo.reshape(B, P)
        hi = hi.reshape(B, P)
        cand_base = piece_start + (plen - span).clamp(min=0)
    truncated = ((hi - lo) > hits_per_seed).any(dim=1)

    h = torch.arange(hits_per_seed, device=dev)
    idx = lo[:, :, None] + h[None, None, :]                   # (B, P, H)
    seed_valid = idx < hi[:, :, None]
    if resolve_cap and resolve_cap * B * P < B * P * hits_per_seed:
        # compact valid SA rows before the SA walk; reads whose lanes
        # overflow the cap are flagged truncated (the wide tier re-runs them)
        K = B * P * resolve_cap
        flat_valid = seed_valid.reshape(-1)
        keep, slot, (sel,) = _flat_compact(flat_valid, K, [idx.reshape(-1)])
        truncated |= (flat_valid & ~keep).reshape(B, -1).any(dim=1)
        pos_k = resolve_sa(fm, sel)
        pos_k = torch.cat([pos_k, pos_k.new_zeros(1)])
        hitpos = torch.where(keep, pos_k[slot.clamp(max=K)], 0).reshape(
            B, P, hits_per_seed)
        seed_valid = keep.reshape(B, P, hits_per_seed)
    else:
        hitpos = resolve_sa(fm, idx)
    cand = hitpos - cand_base[:, :, None]                     # read start
    W = P * hits_per_seed
    cand = torch.where(seed_valid, cand, -NEG).reshape(B, W)

    # dedup identical candidate positions (several pieces exact at one spot)
    prevalid = (cand != -NEG) & ~_first_occurrence(cand) & (cand >= 0)
    truncated |= prevalid.sum(dim=1) > verify_slots

    r_packed, bad_e, len_e = pack_reads(reads, lengths)
    dn = ((fm.n + 15) // 16) if fm.pg_dual else 0
    if resolve_cap:
        # flat-compact candidates across the batch before verification;
        # rows whose candidates overflow the cap re-run in the wide tier
        KV = B * max(resolve_cap * 2, 4)
        flatv = prevalid.reshape(-1)
        rows = torch.arange(B, device=dev)[:, None].expand(B, W).reshape(-1)
        keep2, slot, (sel_pos, sel_row) = _flat_compact(
            flatv, KV, [cand.reshape(-1), rows])
        truncated |= (flatv & ~keep2).reshape(B, W).any(dim=1)
        mm_k = count_mismatches_packed(
            fm.packed_genome, fm.n_mask, sel_pos[None, :],
            r_packed[sel_row][None], bad_e[sel_row][None],
            len_e[sel_row][None], L, has_n=fm.has_n, dual_nwp=dn)[0]
        mm_k = torch.cat([mm_k, mm_k.new_full((1,), 127)])
        mm = torch.where(keep2, mm_k[slot.clamp(max=KV)], 127).reshape(B, W)
        cand_valid = keep2.reshape(B, W)
    else:
        mm = count_mismatches_packed(fm.packed_genome, fm.n_mask, cand,
                                     r_packed, bad_e, len_e, L,
                                     has_n=fm.has_n, dual_nwp=dn)
        cand_valid = prevalid
    cand_valid &= (mm <= max_mismatches) & (cand + lengths[:, None] <= fm.n)
    return cand, mm, cand_valid, truncated


def _align_batch_core(fm, reads_f, reads_r, lengths, offsets, *,
                      max_mismatches: int, hits_per_seed: int,
                      max_alignments: int, kmer_fast: bool,
                      resolve_cap: int, uniform_len: int = 0) -> Alignments:
    """Align a batch on both strands in one stacked pass; reads_r must be
    revcomp(reads_f) with the same per-read lengths (both LEFT-aligned,
    padded with -1). Placements crossing a contig boundary are rejected."""
    B0 = reads_f.shape[0]
    reads2 = torch.cat([reads_f, reads_r], dim=0)
    len2 = torch.cat([lengths, lengths], dim=0)
    p2, m2, v2, t2 = _align_one_strand(fm, reads2, len2, max_mismatches,
                                       hits_per_seed, kmer_fast=kmer_fast,
                                       resolve_cap=resolve_cap,
                                       uniform_len=uniform_len)
    pos = torch.cat([p2[:B0], p2[B0:]], dim=1)
    mm = torch.cat([m2[:B0], m2[B0:]], dim=1)
    valid = torch.cat([v2[:B0], v2[B0:]], dim=1)
    strand = torch.cat([torch.zeros_like(m2[:B0]), torch.ones_like(m2[B0:])],
                       dim=1)
    valid &= same_contig(offsets, pos, lengths[:, None])
    n_hits = valid.sum(dim=1).int()

    # valid slots first, then (strand, pos), stable
    key = ((~valid).long() << 34) | (strand << 33) | (pos + 2 ** 31)
    pos_s, strand_s, mm_s, valid_s = sort_slots(
        key, [pos, strand, mm, valid], max_alignments)
    return Alignments(pos=pos_s.int(), strand=strand_s.to(torch.int8),
                      mm=mm_s.to(torch.int8), valid=valid_s, n_hits=n_hits,
                      truncated=t2[:B0] | t2[B0:])


def seed_widths(fm, reads, lengths, max_mismatches: int):
    """(B,) the widest SA interval among each read's pigeonhole pieces: the
    hits_per_seed at which align_reads (without the k-mer fast path) keeps
    every occurrence of every piece."""
    reads, lengths = _as_device(fm, reads, lengths)
    B, L = reads.shape
    P = max_mismatches + 1
    piece_len = (L + P - 1) // P + 1
    q, _, _ = _piece_queries(reads, lengths.long(), P, piece_len)
    lo, hi = backward_search(fm, q.reshape(B * P, piece_len))
    return (hi - lo).reshape(B, P).max(dim=1).values


def _as_device(fm, *arrays):
    return tuple(torch.as_tensor(a, device=fm.device) for a in arrays)


def _align_local(fm, reads_f, reads_r, lengths, offsets, **kw):
    reads_f, reads_r, lengths, offsets = _as_device(
        fm, reads_f, reads_r, lengths, offsets)
    return _align_batch_core(fm, reads_f, reads_r, lengths.long(), offsets,
                             **kw)


def align_reads(fm, reads_f, reads_r, lengths, offsets, *,
                max_mismatches: int = 2, hits_per_seed: int = 32,
                max_alignments: int = 64, kmer_fast: bool = False,
                resolve_cap: int = 0, uniform_len: int = 0) -> Alignments:
    """Both-strand alignment of a batch (see _align_batch_core). With an
    active mesh (parallel/auto.py) the rows shard over its reads axis,
    each shard aligned on its device against the index placed there, or
    against the range-sharded index (parallel/shard_fm.py) when the mesh
    has a genome axis for `fm`."""
    kw = dict(max_mismatches=max_mismatches, hits_per_seed=hits_per_seed,
              max_alignments=max_alignments, kmer_fast=kmer_fast,
              resolve_cap=resolve_cap, uniform_len=uniform_len)
    return auto.by_rows(
        lambda dev, *r: _align_local(auto.replicated(fm, dev), *r, offsets,
                                     **kw),
        reads_f, reads_r, lengths, fm=fm,
        sharded=lambda: auto.sharded_align(reads_f, reads_r, lengths,
                                           offsets, **kw))


def _align_forward_local(fm, reads, lengths, offsets, *, max_mismatches: int,
                         hits_per_seed: int, max_hits: int):
    reads, lengths, offsets = _as_device(fm, reads, lengths, offsets)
    lengths = lengths.long()
    cand, mm, valid, trunc = _align_one_strand(
        fm, reads, lengths, max_mismatches, hits_per_seed)
    valid &= same_contig(offsets, cand, lengths[:, None])
    n_hits = valid.sum(dim=1).int()
    key = ((~valid).long() << 33) | (cand + 2 ** 31)
    pos_s, mm_s, valid_s = sort_slots(key, [cand, mm, valid], max_hits)
    return pos_s.int(), mm_s.to(torch.int8), valid_s, n_hits, trunc


def align_forward_rows(fm, reads, lengths, offsets, *, max_mismatches: int,
                       hits_per_seed: int, max_hits: int):
    """Forward-text-only variant for rows already in genome space (segment
    mapping: the caller supplies revcomp rows itself). Returns
    (pos, mm, valid) compacted to (N, max_hits) plus n_hits and
    truncation. Row-sharded over the active mesh, if any."""
    kw = dict(max_mismatches=max_mismatches, hits_per_seed=hits_per_seed,
              max_hits=max_hits)
    return auto.by_rows(
        lambda dev, *r: _align_forward_local(auto.replicated(fm, dev), *r,
                                             offsets, **kw),
        reads, lengths, fm=fm,
        sharded=lambda: auto.sharded_align_rows(reads, lengths, offsets,
                                                **kw))


FIELDS = ("pos", "strand", "mm", "valid", "n_hits", "truncated")


def _adaptive(align, fm, reads_f, reads_r, lengths, offsets, *,
              narrow_hits: int, wide_hits: int, resolve_cap: int, **kw):
    """The two tiers through `align` (one device's, or the range-sharded
    index's align_reads), the truncated rows read back and re-run."""
    reads_f, reads_r, lengths, offsets = _as_device(
        fm, reads_f, reads_r, lengths, offsets)
    al = align(fm, reads_f, reads_r, lengths, offsets,
               hits_per_seed=narrow_hits, resolve_cap=resolve_cap, **kw)
    idx = torch.nonzero(al.truncated).reshape(-1)
    trace.note_sync(8)                # nonzero reads its count back
    if idx.numel() == 0:
        return al
    wide = align(fm, reads_f[idx], reads_r[idx], lengths[idx], offsets,
                 hits_per_seed=wide_hits, resolve_cap=0, **kw)
    for f in FIELDS:
        getattr(al, f)[idx] = getattr(wide, f).to(al.pos.device)
    return al


def _adaptive_in_program(fm, reads_f, reads_r, lengths, offsets, *,
                         narrow_hits: int, wide_hits: int, resolve_cap: int,
                         uniform_len: int, wide_budget: int, **kw):
    """Both tiers with no host sync between them: the narrow pass over
    the batch, then the wide pass over a fixed wide_budget rows, the
    first truncated rows by cumsum slot, gathered, searched at wide_hits
    uncompacted and scattered back. Torch has no lax.cond, so the wide
    pass runs on every batch; its unused slots hold a row of Ns (it finds
    nothing), which an extra row B takes on the scatter and is sliced
    off. Truncated rows past the budget keep truncated=True."""
    dev = reads_f.device
    B, L = reads_f.shape
    RW = wide_budget
    al = _align_batch_core(fm, reads_f, reads_r, lengths, offsets,
                           hits_per_seed=narrow_hits, resolve_cap=resolve_cap,
                           uniform_len=uniform_len, **kw)
    csum = torch.cumsum(al.truncated.long(), 0)
    sel = al.truncated & (csum <= RW)
    idx = torch.full((RW + 1,), B, dtype=torch.long, device=dev)
    idx[torch.where(sel, csum - 1, RW)] = torch.arange(B, device=dev)
    idx = idx[:RW]
    extra = lambda a, fill: torch.cat([a, a.new_full((1,) + a.shape[1:],
                                                     fill)])
    wide = _align_batch_core(fm, extra(reads_f, 4)[idx],
                             extra(reads_r, 4)[idx],
                             extra(lengths, uniform_len or L)[idx], offsets,
                             hits_per_seed=wide_hits, resolve_cap=0,
                             uniform_len=uniform_len, **kw)
    out = {}
    for f in FIELDS:
        dst = extra(getattr(al, f), 0)
        dst[idx] = getattr(wide, f)
        out[f] = dst[:B]
    return Alignments(**out)


def align_reads_adaptive(fm, reads_f, reads_r, lengths, offsets, *,
                         max_mismatches: int = 2, max_alignments: int = 64,
                         kmer_fast: bool = False, narrow_hits: int = 8,
                         wide_hits: int = 32, resolve_cap: int = 1,
                         uniform_len: int = 0, wide_budget: int = 0,
                         defer: bool = False) -> Alignments:
    """Two-tier alignment: a narrow seed-hit budget + compacted SA walk for
    the batch, then an uncompacted wide re-run of only the rows whose seeds
    truncated or whose lanes overflowed the cap. Equals align_reads with
    hits_per_seed=wide_hits on every truncated read, at close to
    narrow-budget cost. The result stays on the device. uniform_len: the
    read length when every row has it (the seed search slices instead of
    gathering).

    defer=True, with no mesh and resolve_cap set: both tiers run with no
    host sync (_adaptive_in_program), the wide pass over up to
    `wide_budget` truncated rows (default max(B // 8, 8)), and the caller
    gets the device result as it stands (truncated rows past the budget
    keep truncated=True), so batches dispatch back to back with one final
    sync. Otherwise the truncated rows are read back once and all re-run:
    exact, as JAX's in-program tier plus its host re-run is, and cheaper
    on the card than the fixed wide pass, which a read-back would follow
    anyway (PERF.md §6).

    With an active mesh each reads shard runs both tiers on its device;
    against a range-sharded index both tiers search the sub-indexes."""
    kw = dict(max_mismatches=max_mismatches, max_alignments=max_alignments,
              kmer_fast=kmer_fast, narrow_hits=narrow_hits,
              wide_hits=wide_hits, resolve_cap=resolve_cap,
              uniform_len=uniform_len)
    B = reads_f.shape[0]
    if defer and auto.active() is None and resolve_cap and B:
        reads_f, reads_r, lengths, offsets = _as_device(
            fm, reads_f, reads_r, lengths, offsets)
        return _adaptive_in_program(
            fm, reads_f, reads_r, lengths.long(), offsets,
            wide_budget=wide_budget or max(B // 8, 8), **kw)
    return auto.by_rows(
        lambda dev, *r: _adaptive(_align_local, auto.replicated(fm, dev), *r,
                                  offsets, **kw),
        reads_f, reads_r, lengths, fm=fm,
        sharded=lambda: _adaptive(align_reads, fm, reads_f, reads_r,
                                  lengths, offsets, **kw))


def pack_alignments(al: Alignments, cap: int):
    """Compaction of the (B, M) alignment tables to a flat (cap,) list of
    valid entries (read, pos, strand, mm) in table order. Returns
    (read, pos, strand, mm, count, overflow)."""
    B, M = al.pos.shape
    dev = al.pos.device
    flat_valid = al.valid.reshape(-1)
    rows = torch.arange(B, device=dev)[:, None].expand(B, M).reshape(-1)
    csum = torch.cumsum(flat_valid.long(), 0)
    n = csum[-1]
    src = torch.searchsorted(csum, torch.arange(1, cap + 1, device=dev))
    src = src.clamp(max=B * M - 1)
    kept = torch.arange(cap, device=dev) < torch.clamp(n, max=cap)
    take = lambda a: torch.where(kept, a.reshape(-1)[src].long(), 0)
    return (torch.where(kept, rows[src], -1), take(al.pos), take(al.strand),
            take(al.mm), n, n > cap)


def transfer_alignments(al: Alignments, cap: int | None = None
                        ) -> Alignments:
    """Bring a device Alignments to host numpy via flat packing, falling
    back to direct table transfer when the flat budget overflows. The
    rebuilt tables hold the same valid entries at the same leading slots
    (invalid tails zeroed)."""
    B, M = al.pos.shape
    if cap is None:
        cap = max(4 * B, 64)
    n_hits = trace.to_host(al.n_hits)
    truncated = trace.to_host(al.truncated)
    if B == 0:
        return Alignments(pos=np.zeros((0, M), np.int32),
                          strand=np.zeros((0, M), np.int8),
                          mm=np.zeros((0, M), np.int8),
                          valid=np.zeros((0, M), bool),
                          n_hits=n_hits, truncated=truncated)
    read, pos, strand, mm, n, ovf = pack_alignments(al, cap)
    if bool(trace.to_host(ovf)):
        # rare: heavy-multihit batch — take the full tables
        return Alignments(pos=trace.to_host(al.pos),
                          strand=trace.to_host(al.strand),
                          mm=trace.to_host(al.mm),
                          valid=trace.to_host(al.valid),
                          n_hits=n_hits, truncated=truncated)
    k = int(trace.to_host(n))
    read = trace.to_host(read[:k])
    pos_t = np.zeros((B, M), np.int32)
    strand_t = np.zeros((B, M), np.int8)
    mm_t = np.zeros((B, M), np.int8)
    valid_t = np.zeros((B, M), bool)
    if k:
        first = np.searchsorted(read, read, side="left")
        slot = np.arange(k) - first
        pos_t[read, slot] = trace.to_host(pos[:k])
        strand_t[read, slot] = trace.to_host(strand[:k])
        mm_t[read, slot] = trace.to_host(mm[:k])
        valid_t[read, slot] = True
    return Alignments(pos=pos_t, strand=strand_t, mm=mm_t, valid=valid_t,
                      n_hits=n_hits, truncated=truncated)


def pad_reads(seqs, max_len: int | None = None):
    """Host helper: list of int8 code arrays -> (reads_f, reads_r, lengths)
    left-aligned, -1-padded numpy arrays ready for align_reads."""
    B = len(seqs)
    L = max_len or max((len(s) for s in seqs), default=1)
    reads_f = np.full((B, L), -1, np.int8)
    reads_r = np.full((B, L), -1, np.int8)
    lengths = np.zeros(B, np.int32)
    for i, s in enumerate(seqs):
        n = min(len(s), L)
        reads_f[i, :n] = s[:n]
        reads_r[i, :n] = revcomp(np.asarray(s[:n], np.int8))
        lengths[i] = n
    return reads_f, reads_r, lengths
