# Copy of tophat_tpu/io/fastq.py (host code), imports rewritten.
"""Host-side FASTQ/FASTA read ingestion into batched numpy arrays.

Replaces the reference's FastxReader/ZReader (src/tophat.py:1583,1756) and
the C++ ReadStream (src/reads.h:264). Reads land directly in the fixed-shape
(B, L) code arrays the device pipeline consumes; names/quals stay host-side
for final SAM emission. Transparent gzip/bz2 by extension, like the zipper
subprocesses of the reference.
"""

from __future__ import annotations

import bz2
import dataclasses
import gzip
from typing import IO, Iterator, List, Tuple

import numpy as np

from tophat_tpu_torch.index.fasta import encode_seq


def _open(path: str) -> IO[bytes]:
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    if path.endswith(".bz2"):
        return bz2.open(path, "rb")
    return open(path, "rb")


@dataclasses.dataclass
class ReadBatch:
    """A batch of reads, host layout. `codes` are LEFT-aligned, -1-padded."""

    names: List[str]
    codes: np.ndarray    # (B, L) int8
    quals: List[bytes]   # phred33 ASCII, one per read (original length)
    lengths: np.ndarray  # (B,) int32

    @property
    def size(self) -> int:
        return len(self.names)


def _iter_fastq(f: IO[bytes]) -> Iterator[Tuple[str, bytes, bytes]]:
    while True:
        name = f.readline()
        if not name:
            return
        name = name.strip()
        if not name:
            continue
        seq = f.readline().strip()
        f.readline()  # '+'
        qual = f.readline().strip()
        yield name[1:].split()[0].decode(), seq, qual


def _iter_fasta(f: IO[bytes]) -> Iterator[Tuple[str, bytes, bytes]]:
    name = None
    seq: List[bytes] = []
    for line in f:
        line = line.strip()
        if line.startswith(b">"):
            if name is not None:
                s = b"".join(seq)
                yield name, s, b"I" * len(s)  # FASTA default qual, prep_reads.cpp:273
            name = line[1:].split()[0].decode()
            seq = []
        elif line:
            seq.append(line)
    if name is not None:
        s = b"".join(seq)
        yield name, s, b"I" * len(s)


def sniff_format(path: str) -> str:
    with _open(path) as f:
        first = f.readline().strip()
    if first.startswith(b">"):
        return "fasta"
    return "fastq"


def convert_quals(qual: bytes, scale: str) -> bytes:
    """Convert qualities to phred33 (reference: format_qual_string,
    src/prep_reads.cpp:27 + qual.cpp scales)."""
    if scale == "phred33":
        return qual
    arr = np.frombuffer(qual, dtype=np.uint8).astype(np.int32)
    if scale == "phred64":
        out = arr - 64 + 33
    elif scale == "solexa":
        # solexa odds -> phred: 10*log10(1+10^(s/10))
        s = arr - 64
        out = np.rint(10.0 * np.log10(1.0 + 10.0 ** (s / 10.0))).astype(np.int32) + 33
    else:
        raise ValueError(f"unknown quality scale {scale!r}")
    return np.clip(out, 33, 126).astype(np.uint8).tobytes()


def read_all(path: str, quals_scale: str = "phred33",
             integer_quals: bool = False
             ) -> Iterator[Tuple[str, bytes, bytes]]:
    """Yield (name, seq_ascii, qual_phred33) for every record in the file.

    Accepts FASTQ/FASTA (optionally gzip/bz2) and BAM — the reference feeds
    BAM-stored reads back into the aligner via bam2fastx
    (src/bam2fastx.cpp:365); here BAM records stream directly. Reverse-flag
    records are restored to original read orientation."""
    if path.endswith(".bam"):
        from tophat_tpu_torch.index.fasta import encode_seq
        from tophat_tpu_torch.io.bam import read_bam
        from tophat_tpu_torch.io.sam import FLAG_REVERSE, revcomp_ascii

        _, _, _, records = read_bam(path)
        for rec in records:
            seq, qual = rec.seq, rec.qual
            if rec.flag & FLAG_REVERSE:
                seq = revcomp_ascii(seq)
                qual = qual[::-1]
            if qual == b"*":
                qual = b"I" * len(seq)
            yield rec.name, seq, qual
        return
    fmt = sniff_format(path)
    with _open(path) as f:
        it = _iter_fasta(f) if fmt == "fasta" else _iter_fastq(f)
        for name, seq, qual in it:
            if fmt == "fastq":
                if integer_quals:
                    # --integer-quals: space-delimited numeric qualities
                    # (reference: ReadParams.integer_quals feeding
                    # prep_reads' quality parser, src/qual.cpp)
                    vals = np.array([int(v) for v in qual.split()],
                                    np.int32)
                    qual = np.clip(vals + 33, 33, 126).astype(
                        np.uint8).tobytes()
                else:
                    qual = convert_quals(qual, quals_scale)
            yield name, seq, qual


def batch_reads(records: List[Tuple[str, bytes, bytes]],
                max_len: int | None = None) -> ReadBatch:
    """Pack (name, seq, qual) records into a ReadBatch."""
    names = [r[0] for r in records]
    quals = [r[2] for r in records]
    lengths = np.array([len(r[1]) for r in records], dtype=np.int32)
    L = max_len or (int(lengths.max()) if len(records) else 1)
    codes = np.full((len(records), L), -1, np.int8)
    for i, (_, seq, _) in enumerate(records):
        c = encode_seq(seq.upper())[:L]
        codes[i, : len(c)] = c
    return ReadBatch(names=names, codes=codes, quals=quals,
                     lengths=np.minimum(lengths, L))
