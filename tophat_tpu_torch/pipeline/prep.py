# Copy of tophat_tpu/pipeline/prep.py (host code), imports rewritten.
"""prep_reads stage: read QC and filtering (vectorized, host-side).

Mirrors the reference's per-read trash rules (src/prep_reads.cpp:212-270):
  'S' : shorter than 12 bp
  'L' : low complexity — one of A/C/G/T makes up > 90% of the read
  'N' : >= 10% ambiguous bases
Reads are uppercased and qualities normalized to phred33 upstream in
io/fastq.py. Filtering is a few numpy reductions over the whole (B, L) code
array instead of a per-read C++ loop.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from tophat_tpu_torch.io.fastq import ReadBatch

MIN_READ_LEN = 12


@dataclasses.dataclass
class PrepStats:
    """Feeds prep_reads.info / align_summary (reference: prep_reads.cpp aux
    stats; consumed at src/tophat.py:3550)."""

    reads_in: int = 0
    reads_out: int = 0
    trashed_short: int = 0
    trashed_lowcomplexity: int = 0
    trashed_n: int = 0
    min_read_len: int = 0
    max_read_len: int = 0

    def info_text(self) -> str:
        return (f"min_read_len={self.min_read_len}\n"
                f"max_read_len={self.max_read_len}\n"
                f"reads_in ={self.reads_in}\n"
                f"reads_out={self.reads_out}\n")

    def merge(self, other: "PrepStats") -> None:
        """Accumulate another chunk's stats (streamed inputs)."""
        first = self.reads_in == 0
        self.reads_in += other.reads_in
        self.reads_out += other.reads_out
        self.trashed_short += other.trashed_short
        self.trashed_lowcomplexity += other.trashed_lowcomplexity
        self.trashed_n += other.trashed_n
        self.min_read_len = (other.min_read_len if first else
                             min(self.min_read_len, other.min_read_len))
        self.max_read_len = max(self.max_read_len, other.max_read_len)


def prep_filter(batch: ReadBatch) -> tuple[np.ndarray, PrepStats]:
    """Returns (keep_mask, stats). Does not reorder or renumber — read IDs
    are array indices; the caller subsets arrays with the mask."""
    codes = batch.codes
    lengths = batch.lengths.astype(np.int32)
    B, L = codes.shape

    in_read = np.arange(L)[None, :] < lengths[:, None]
    base_counts = np.stack(
        [((codes == c) & in_read).sum(axis=1) for c in range(4)], axis=1)
    n_counts = ((codes == 4) & in_read).sum(axis=1)

    with np.errstate(divide="ignore", invalid="ignore"):
        frac = base_counts / np.maximum(lengths[:, None], 1)
        nfrac = n_counts / np.maximum(lengths, 1)

    too_short = lengths < MIN_READ_LEN
    low_complex = ~too_short & (frac > 0.9).any(axis=1)
    too_many_n = ~too_short & ~low_complex & (nfrac >= 0.1)
    keep = ~(too_short | low_complex | too_many_n)

    kept_lens = lengths[keep]
    stats = PrepStats(
        reads_in=B,
        reads_out=int(keep.sum()),
        trashed_short=int(too_short.sum()),
        trashed_lowcomplexity=int(low_complex.sum()),
        trashed_n=int(too_many_n.sum()),
        min_read_len=int(kept_lens.min()) if kept_lens.size else 0,
        max_read_len=int(kept_lens.max()) if kept_lens.size else 0,
    )
    return keep, stats


def segment_offsets(read_len: int, segment_length: int) -> list[int]:
    """Segment cut offsets for one read length (reference:
    src/tophat.py:2974-2991): L//seg equal cuts; a remainder >=
    min(seg-2, 20) becomes its own segment, otherwise the last segment
    absorbs it."""
    nseg = read_len // segment_length
    offsets = [segment_length * i for i in range(nseg + 1)]
    if read_len % segment_length >= min(segment_length - 2, 20):
        offsets.append(read_len)
    else:
        offsets[-1] = read_len
    if len(offsets) <= 2:
        return [0, read_len]
    return offsets
