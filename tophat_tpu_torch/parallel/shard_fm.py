"""FM-index range sharding over the genome axis.

Port of tophat_tpu/parallel/shard_fm.py. When the index outgrows one
device's memory, the genome is cut into equal ranges with an overlap
margin; genome shard j holds the FM index of its range and searches every
read of its reads shard; per-shard hits rebase to global coordinates and
merge on the reads shard's first device, in the order the one-index
search gives them. The reference itself has no analog (bowtie maps
everything against one whole-genome index, src/tophat.py:2286).

Correctness contract: any alignment whose start lies in shard j's owned
range [j*W, (j+1)*W) is fully contained in shard j's slice because the
slice extends `overlap` >= max_read_len - 1 bases past the owned range;
hits starting inside the margin are dropped locally (the next shard owns
them), so the merged set equals the one-index result exactly.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np
import torch

from tophat_tpu_torch.index.fasta import Genome
from tophat_tpu_torch.index.fm import FMIndex, build_fm_index
from tophat_tpu_torch.ops.align import (NEG, Alignments, _align_batch_core,
                                        _align_one_strand, sort_slots)
from tophat_tpu_torch.ops.beam import _beam_core, _pack_rows
from tophat_tpu_torch.ops.verify import same_contig
from tophat_tpu_torch.parallel import auto
from tophat_tpu_torch.parallel.mesh import gather_rows, split_rows


def build_sharded_fm(genome: Genome, n_shards: int, overlap: int,
                     kmer_k: int = 0, sa_rate: int = 0, devices=None
                     ) -> Tuple[List[FMIndex], np.ndarray]:
    """Build n_shards range sub-indexes on the host, sub-index j placed on
    devices[j]. Returns (sub-indexes, shard starts).

    All slices pad to equal width with N (code 4). build_fm_index maps N
    to A in the FM text, so pad runs enter backward search as A-runs and
    can occupy per-seed hit slots in the last shard; they are rejected
    afterwards — verification counts them as mismatches through n_mask,
    and the ownership/contig filters drop anything starting past the owned
    width — so padding never yields a reported hit.

    The sub-indexes build in one thread each: the suffix array, the bulk
    of a build, runs in native code without the GIL, and together the
    builds hold about the host memory of one whole-genome build."""
    codes = np.asarray(genome.codes)
    n = codes.shape[0]
    w = (n + n_shards - 1) // n_shards          # owned width
    width = w + overlap                          # slice width (padded)
    starts = np.arange(n_shards, dtype=np.int64) * w

    def build(j):
        s = int(starts[j])
        sl = codes[s: min(n, s + width)]
        if sl.shape[0] < width:
            sl = np.concatenate(
                [sl, np.full(width - sl.shape[0], 4, np.int8)])
        return build_fm_index(
            Genome(codes=sl, offsets=np.array([0, width]), names=["shard"]),
            kmer_k=kmer_k, sa_rate=sa_rate, device=devices[j])

    with ThreadPoolExecutor(n_shards) as pool:
        subs = list(pool.map(build, range(n_shards)))
    return subs, starts


def _local(subs, starts, j: int, dev, *arrays):
    """Sub-index j on `dev`, its start, its one-contig local offsets and
    `arrays` moved to `dev`."""
    fm = auto.replicated(subs[j], dev)
    return (fm, int(starts[j]), torch.tensor([0, fm.n], device=dev),
            *(a.to(dev) for a in arrays))


def sharded_align(mesh, subs, starts, owned_width: int, offsets, reads_f,
                  reads_r, lengths, *, max_mismatches: int = 2,
                  hits_per_seed: int = 16, max_alignments: int = 16,
                  kmer_fast: bool = False, resolve_cap: int = 0
                  ) -> Alignments:
    """Both-strand alignment of every reads shard against every genome
    shard's sub-index, merged as JAX's make_sharded_align: each shard's
    owned hits (pos < owned_width, rebased, inside one real contig) of its
    max_alignments-wide table, then valid first by (strand, pos); n_hits
    counts the merged tables' valid slots, truncated is OR'd over shards.
    Returns an Alignments on the mesh's first device."""
    shards, B = split_rows(mesh, reads_f, reads_r, lengths)
    outs = []
    for row, (rf, rr, ln) in zip(mesh.devices, shards):
        home = row[0]
        parts = []
        for j, dev in enumerate(row):
            fm, start, local_off, rf_j, rr_j, ln_j = _local(
                subs, starts, j, dev, rf, rr, ln.long())
            al = _align_batch_core(fm, rf_j, rr_j, ln_j, local_off,
                                   max_mismatches=max_mismatches,
                                   hits_per_seed=hits_per_seed,
                                   max_alignments=max_alignments,
                                   kmer_fast=kmer_fast,
                                   resolve_cap=resolve_cap)
            gpos = al.pos.long() + start
            owned = (al.valid & (al.pos < owned_width)
                     & same_contig(offsets, gpos, ln_j[:, None]))
            gpos = torch.where(owned, gpos, -NEG)
            parts.append([x.to(home) for x in (
                gpos, al.strand.long(), al.mm, owned, al.truncated)])
        pos, strand, mm, valid = (torch.cat([p[k] for p in parts], 1)
                                  for k in range(4))
        key = ((~valid).long() << 34) | (strand << 33) | (pos + 2 ** 31)
        pos_s, st_s, mm_s, va_s = sort_slots(key, [pos, strand, mm, valid],
                                             max_alignments)
        outs.append(Alignments(
            pos=pos_s.int(), strand=st_s.to(torch.int8),
            mm=mm_s.to(torch.int8), valid=va_s, n_hits=valid.sum(1).int(),
            truncated=torch.stack([p[4] for p in parts]).any(0)))
    return gather_rows(mesh, outs, B)


def sharded_align_rows(mesh, subs, starts, owned_width: int, offsets,
                       reads, lengths, *, max_mismatches: int,
                       hits_per_seed: int, max_hits: int):
    """Forward-text-only variant for genome-space rows (segment mapping),
    merged valid first by pos (JAX's make_sharded_align_rows). Returns
    (pos, mm, valid, n_hits, truncated) on the mesh's first device."""
    shards, B = split_rows(mesh, reads, lengths)
    outs = []
    for row, (rd, ln) in zip(mesh.devices, shards):
        home = row[0]
        parts = []
        for j, dev in enumerate(row):
            fm, start, _, rd_j, ln_j = _local(subs, starts, j, dev, rd,
                                              ln.long())
            cand, mm, valid, trunc = _align_one_strand(
                fm, rd_j, ln_j, max_mismatches, hits_per_seed)
            gpos = cand + start
            owned = (valid & (cand < owned_width)
                     & same_contig(offsets, gpos, ln_j[:, None]))
            gpos = torch.where(owned, gpos, -NEG)
            parts.append([x.to(home) for x in (gpos, mm, owned, trunc)])
        pos, mm, valid = (torch.cat([p[k] for p in parts], 1)
                          for k in range(3))
        key = ((~valid).long() << 33) | (pos + 2 ** 31)
        pos_s, mm_s, va_s = sort_slots(key, [pos, mm, valid], max_hits)
        outs.append((pos_s.int(), mm_s.to(torch.int8), va_s,
                     valid.sum(1).int(),
                     torch.stack([p[3] for p in parts]).any(0)))
    return gather_rows(mesh, outs, B)


def sharded_beam_rows(mesh, subs, starts, owned_width: int, offsets, reads,
                      lengths, *, max_hits: int, plan: dict):
    """Half-split + variant (full-sensitivity) segment search: each genome
    shard runs the beam core over its sub-index with local ownership
    filtering, the flat verified hits of every shard are re-checked
    against the real contigs and packed per row once (ops/beam._pack_rows;
    JAX's make_sharded_beam_rows). Returns (pos, mm, valid, n_hits,
    truncated) on the mesh's first device."""
    shards, B = split_rows(mesh, reads, lengths)
    outs = []
    for row, (rd, ln) in zip(mesh.devices, shards):
        home = row[0]
        Bs = rd.shape[0]
        parts = []
        for j, dev in enumerate(row):
            fm, start, local_off, rd_j, ln_j = _local(subs, starts, j, dev,
                                                      rd, ln.long())
            f_seg, f_pos, f_mm, trunc = _beam_core(
                fm, rd_j, ln_j, local_off, max_hits=max_hits,
                owned_width=owned_width, flat_out=True, **plan)
            live = f_seg < Bs
            gpos = torch.where(live, f_pos + start, f_pos)
            len_l = torch.cat([ln_j, ln_j.new_zeros(1)])[f_seg.clamp(max=Bs)]
            ok = live & same_contig(offsets, gpos, len_l)
            parts.append([x.to(home) for x in (
                torch.where(ok, f_seg, Bs), torch.where(ok, gpos, 2 ** 30),
                f_mm, trunc)])
        seg, pos, mm = (torch.cat([p[k] for p in parts]) for k in range(3))
        pos_t, mm_t, val_t, n_hits = _pack_rows(seg, pos, mm, Bs, max_hits)
        trunc = torch.stack([p[3] for p in parts]).any(0) | (n_hits
                                                             > max_hits)
        outs.append((pos_t, mm_t, val_t, n_hits, trunc))
    return gather_rows(mesh, outs, B)
