"""Read segmentation and segment mapping, in genome space.

Port of tophat_tpu/pipeline/segment.py: build_genome_space is the same
host code; map_segments returns the segment tables as device tensors.

Replaces split_reads + per-segment bowtie invocations (reference:
src/tophat.py:2878 split_reads, :3573 segment mapping loop). Instead of
writing seg1..segN FASTQ files and renaming reads `name|offset:seg:nsegs`,
each read becomes two genome-space rows (forward codes; reverse-complement
codes) and segments are row-local slices — the whole segment batch maps in
one aligner call.

Genome-space convention: row r < R is read r on strand +; row R + r is
revcomp(read r) (strand -). Segment index is GENOME order: for strand -,
segment j is the original read's segment nseg-1-j, and cut offsets mirror
accordingly, so all downstream gap/window logic is strand-agnostic.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from tophat_tpu_torch.ops.align import align_forward_rows
from tophat_tpu_torch.ops.beam import beam_align_rows
from tophat_tpu_torch.pipeline.prep import segment_offsets


@dataclasses.dataclass
class GenomeSpaceReads:
    readsg: np.ndarray    # (2R, L) int8 genome-space codes, -1 padded
    lengths: np.ndarray   # (2R,) int32
    cuts: np.ndarray      # (2R, S+1) int32 genome-space segment boundaries
    nseg: np.ndarray      # (2R,) int32
    read_idx: np.ndarray  # (2R,) int32 original read index
    strand: np.ndarray    # (2R,) int8 0=+ 1=-

    @property
    def rows(self) -> int:
        return self.readsg.shape[0]


def build_genome_space(reads_f: np.ndarray, reads_r: np.ndarray,
                       lengths: np.ndarray, segment_length: int,
                       row_mask: np.ndarray | None = None,
                       pad_rows_pow2: bool = False) -> GenomeSpaceReads:
    """reads_f/reads_r: (R, L) left-aligned, -1 padded; row_mask selects the
    subset of reads to include (e.g. the IUM reads).

    pad_rows_pow2 pads the read count to the next power of two with dummy
    rows (read_idx -1, length 0) so the device stages of successive batches
    hit the same compiled shapes instead of recompiling per IUM count."""
    if row_mask is None:
        row_mask = np.ones(len(lengths), bool)
    idx = np.nonzero(row_mask)[0].astype(np.int32)
    R = len(idx)
    L = reads_f.shape[1]
    pad = 0
    if pad_rows_pow2 and R:
        pad = (1 << max(3, (R - 1).bit_length())) - R

    @lru_cache(maxsize=None)
    def offs(l):
        return segment_offsets(int(l), segment_length)

    nseg1 = np.array([len(offs(l)) - 1 for l in lengths[idx]], np.int32)
    S = int(nseg1.max()) if R else 1
    cuts_f = np.zeros((R, S + 1), np.int32)
    cuts_r = np.zeros((R, S + 1), np.int32)
    for i, ridx in enumerate(idx):
        o = offs(lengths[ridx])
        k = len(o) - 1
        cuts_f[i, : k + 1] = o
        cuts_f[i, k + 1:] = o[-1]
        rev = [int(lengths[ridx]) - v for v in o[::-1]]
        cuts_r[i, : k + 1] = rev
        cuts_r[i, k + 1:] = rev[-1]

    rf_sel = reads_f[idx]
    rr_sel = reads_r[idx]
    len_sel = lengths[idx].astype(np.int32)
    if pad:
        z8 = np.full((pad, L), -1, np.int8)
        rf_sel = np.concatenate([rf_sel, z8])
        rr_sel = np.concatenate([rr_sel, z8])
        len_sel = np.concatenate([len_sel, np.zeros(pad, np.int32)])
        cuts_f = np.concatenate([cuts_f, np.zeros((pad, S + 1), np.int32)])
        cuts_r = np.concatenate([cuts_r, np.zeros((pad, S + 1), np.int32)])
        nseg1 = np.concatenate([nseg1, np.ones(pad, np.int32)])
        idx = np.concatenate([idx, np.full(pad, -1, np.int32)])
        R += pad

    return GenomeSpaceReads(
        readsg=np.concatenate([rf_sel, rr_sel]),
        lengths=np.concatenate([len_sel, len_sel]),
        cuts=np.concatenate([cuts_f, cuts_r]),
        nseg=np.concatenate([nseg1, nseg1]),
        read_idx=np.concatenate([idx, idx]),
        strand=np.concatenate(
            [np.zeros(R, np.int8), np.ones(R, np.int8)]),
    )


BEAM_MIN_N = 1 << 21  # below this, pigeonhole piece intervals fit the
#                       hits budget and the pigeonhole path is exact


def segment_rows(gs: GenomeSpaceReads):
    """(rows*S, SEGL) int8 segment codes (-1 padded) and (rows, S) segment
    lengths of every genome-space row, segment-major within a row."""
    rows, L = gs.readsg.shape
    S = gs.cuts.shape[1] - 1
    seg_len = gs.cuts[:, 1:] - gs.cuts[:, :-1]              # (2R, S)
    SEGL = int(seg_len.max()) if rows else 1
    t = np.arange(SEGL)
    src = gs.cuts[:, :-1][:, :, None] + t[None, None, :]     # (2R, S, SEGL)
    ok = t[None, None, :] < seg_len[:, :, None]
    gathered = np.take_along_axis(
        gs.readsg, np.clip(src, 0, L - 1).reshape(rows, -1), axis=1
    ).reshape(rows, S, SEGL)
    seg_reads = np.where(ok, gathered, -1).reshape(rows * S, SEGL)
    return seg_reads.astype(np.int8), seg_len


def map_segments(fm, offsets, gs: GenomeSpaceReads, *,
                 segment_mismatches: int, hits_per_seed: int, max_hits: int,
                 engine: str = "auto"):
    """Align every segment of every row against the forward text.

    engine: "pigeonhole" (ops/align.py — exact only while piece SA
    intervals fit hits_per_seed, i.e. small genomes), "beam" (ops/beam.py
    half-split + k-mer-variant search — full bowtie1 -v sensitivity at
    any genome size), or "auto" (beam whenever the genome is at least
    BEAM_MIN_N bases and every segment is long enough for the half split).

    Returns (seg_pos, seg_mm, seg_valid): (2R, S, H) device tensors in
    genome order. Under a mesh (parallel/auto.py) the engines shard the
    segment rows and gather them onto the mesh's first device, where the
    one-device run keeps them, so nothing here changes."""
    rows = gs.readsg.shape[0]
    S = gs.cuts.shape[1] - 1
    seg_reads, seg_len_tbl = segment_rows(gs)
    seg_lens = seg_len_tbl.reshape(-1).astype(np.int32)

    min_seg = int(seg_len_tbl[seg_len_tbl > 0].min()) \
        if rows and (seg_len_tbl > 0).any() else 0
    use_beam = engine == "beam" or (
        engine == "auto" and fm.n >= BEAM_MIN_N and min_seg >= 10)
    if use_beam:
        pos, mm, valid, n_hits, trunc = beam_align_rows(
            fm, seg_reads, np.maximum(seg_lens, 1), offsets,
            max_mismatches=segment_mismatches, max_hits=max_hits)
    else:
        pos, mm, valid, n_hits, trunc = align_forward_rows(
            fm, seg_reads, np.maximum(seg_lens, 1), offsets,
            max_mismatches=segment_mismatches, hits_per_seed=hits_per_seed,
            max_hits=max_hits)
    H = max_hits
    zero_len = torch.as_tensor(seg_lens == 0, device=valid.device)[:, None]
    valid = valid & ~zero_len
    return (pos.reshape(rows, S, H), mm.reshape(rows, S, H),
            valid.reshape(rows, S, H))
