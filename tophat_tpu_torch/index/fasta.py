# Copy of tophat_tpu/index/fasta.py (host code), imports rewritten.
"""FASTA reading and genome packing.

Replaces the roles of SeqAn packed Dna5 strings (reference: src/bwt_map.h:579
RefSequenceTable) and gclib GFaSeqGet random-access FASTA fetch
(reference: src/gclib/GFaSeqGet.cpp) with a single flat int8 code array plus a
contig offset table — the layout a TPU wants: one gatherable device array in
global coordinates.

Base coding: A=0, C=1, G=2, T=3, anything else (N/ambiguity)=4.
Lowercase (soft-masked) bases are uppercased, matching TopHat's prep
(reference: src/prep_reads.cpp:229 uppercases reads; SeqAn Dna5 uppercases
references implicitly).
"""

from __future__ import annotations

import dataclasses
import io
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

# Byte -> code lookup table. 4 == N / unknown.
_CODE_LUT = np.full(256, 4, dtype=np.int8)
for i, b in enumerate(b"ACGT"):
    _CODE_LUT[b] = i
    _CODE_LUT[b + 32] = i  # lowercase

_CODE_TO_BASE = np.frombuffer(b"ACGTN", dtype=np.uint8)

# code -> complement code (N complements to N)
COMP = np.array([3, 2, 1, 0, 4], dtype=np.int8)


def encode_seq(seq: bytes | str) -> np.ndarray:
    """ASCII sequence -> int8 codes (A0 C1 G2 T3 N4)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _CODE_LUT[np.frombuffer(seq, dtype=np.uint8)]


def decode_seq(codes: np.ndarray) -> str:
    return _CODE_TO_BASE[np.asarray(codes, dtype=np.int64)].tobytes().decode()


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a code array (any leading axis batched)."""
    return COMP[codes][..., ::-1]


@dataclasses.dataclass
class Genome:
    """A multi-contig reference in one flat global coordinate space.

    codes      : (n,) int8 — concatenated contig base codes (N stored as 4)
    offsets    : (num_contigs + 1,) int64 — contig c spans
                 [offsets[c], offsets[c+1]) in global coordinates
    names      : contig names in input order (defines the SAM @SQ order,
                 matching reference get_index_sam_header, src/tophat.py:1415)
    """

    codes: np.ndarray
    offsets: np.ndarray
    names: List[str]

    @property
    def n(self) -> int:
        return int(self.codes.shape[0])

    @property
    def pos_dtype(self):
        """dtype of global-position tables (known events): int32 where
        every position fits, as the JAX package makes them; int64 on a
        genome past the int32 range."""
        return np.int32 if self.n <= np.iinfo(np.int32).max else np.int64

    @property
    def num_contigs(self) -> int:
        return len(self.names)

    def contig_lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def name_to_id(self) -> Dict[str, int]:
        return {n: i for i, n in enumerate(self.names)}

    def global_to_contig(self, pos: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Global positions -> (contig_id, contig-local 0-based position)."""
        pos = np.asarray(pos)
        cid = np.searchsorted(self.offsets, pos, side="right") - 1
        return cid, pos - self.offsets[cid]

    def contig_to_global(self, cid: np.ndarray, local: np.ndarray) -> np.ndarray:
        return self.offsets[np.asarray(cid)] + np.asarray(local)

    def fetch(self, start: int, end: int) -> np.ndarray:
        return self.codes[start:end]


def read_fasta(path_or_file) -> Genome:
    """Parse a (multi-)FASTA file into a Genome."""
    if hasattr(path_or_file, "read"):
        data = path_or_file.read()
        if isinstance(data, str):
            data = data.encode()
    else:
        with open(path_or_file, "rb") as f:
            data = f.read()

    names: List[str] = []
    chunks: List[np.ndarray] = []
    cur: List[bytes] = []
    for line in data.splitlines():
        if line.startswith(b">"):
            if names:
                chunks.append(encode_seq(b"".join(cur)))
                cur = []
            names.append(line[1:].split()[0].decode())
        elif line:
            cur.append(line.strip())
    if names:
        chunks.append(encode_seq(b"".join(cur)))
    if not names:
        raise ValueError("empty FASTA input")

    lengths = np.array([c.shape[0] for c in chunks], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    codes = np.concatenate(chunks) if chunks else np.zeros(0, np.int8)
    return Genome(codes=codes, offsets=offsets, names=names)


def genome_from_seqs(seqs: Sequence[Tuple[str, str]]) -> Genome:
    """Build a Genome from (name, sequence-string) pairs (tests/synthetic)."""
    buf = io.BytesIO()
    for name, seq in seqs:
        buf.write(b">" + name.encode() + b"\n" + seq.encode() + b"\n")
    buf.seek(0)
    return read_fasta(buf)
