# Copy of tophat_tpu/io/color.py (host code), imports rewritten.
"""SOLiD colorspace (CS) support.

The reference maps colorspace reads with bowtie -C against a color-encoded
index and decodes alignments back to bases with a reference-guided decoder
(reference: src/tophat.py:2896-2928 colorspace driver flags, the FIFO decode
path :2193-2244, and BWA_decode in src/long_spanning_reads.cpp /
segment_juncs.cpp). The TPU-native counterpart here:

- the genome transforms into color space ONCE (`genome_to_color`) — the
  dinucleotide-transition code is XOR under the A=0 C=1 G=2 T=3 encoding
  (AA/CC/GG/TT=0, AC/CA/GT/TG=1, AG/GA/CT/TC=2, AT/TA/CG/GC=3), so the
  transform is one vectorized op and contig boundaries mask to N;
- color reads (csfasta `T0123..` or colorspace FASTQ) drop the primer base
  and its leading transition and align AS COLORS against the color FM index
  with the standard machinery — a sequencing error is ONE color mismatch
  instead of corrupting every downstream base, which is the entire point of
  colorspace alignment;
- reverse-strand search uses plain reversal (colors are complement-
  invariant: color(b1,b2) == color(revcomp b2, revcomp b1));
- accepted placements decode with `decode_alignment`: isolated color
  mismatches are sequencing errors (decode the reference base), adjacent
  consistent mismatch pairs are real SNPs (decode the variant base) — the
  greedy form of the reference's ML decode.

Spliced discovery for colorspace IUM reads runs in base space on the
primer-chain decode (`decode_chain`) — documented difference from the
reference, which realigns segments in color space (COVERAGE.md).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

_COLOR_CHARS = {ord("0"): 0, ord("1"): 1, ord("2"): 2, ord("3"): 3,
                ord("."): 4, ord("4"): 4, ord("N"): 4, ord("n"): 4}
_BASE_CODE = {ord("A"): 0, ord("C"): 1, ord("G"): 2, ord("T"): 3,
              ord("a"): 0, ord("c"): 1, ord("g"): 2, ord("t"): 3}


def is_colorspace_read(seq: bytes) -> bool:
    """True for `T0123..`-style records: a primer base followed by color
    digits (reference csfasta layout, bam2fastx.cpp color path)."""
    if len(seq) < 2:
        return False
    if seq[0] not in _BASE_CODE:
        return False
    body = seq[1:]
    digits = sum(1 for b in body if b in _COLOR_CHARS)
    return digits == len(body)


def encode_color_read(seq: bytes) -> Tuple[int, np.ndarray]:
    """`T0123..` -> (primer_code, colors int8[L]); '.' becomes 4 (no-call).
    The leading color (primer->base1 transition) is kept — callers drop it
    for alignment but need it for primer-chain decoding."""
    primer = _BASE_CODE.get(seq[0], 4)
    colors = np.fromiter((_COLOR_CHARS.get(b, 4) for b in seq[1:]),
                         np.int8, count=len(seq) - 1)
    return primer, colors


def genome_to_color(codes: np.ndarray,
                    offsets: np.ndarray | None = None) -> np.ndarray:
    """Base codes (n,) -> transition colors (n-1,): color[i] encodes the
    (base[i], base[i+1]) dinucleotide; any N side -> 4, and transitions
    crossing a contig boundary of the concatenated genome mask to 4 so no
    color alignment spans contigs."""
    a, b = codes[:-1], codes[1:]
    col = (a ^ b).astype(np.int8)
    col = np.where((a > 3) | (a < 0) | (b > 3) | (b < 0), np.int8(4), col)
    if offsets is not None:
        for off in np.asarray(offsets)[1:-1]:
            if 0 < off <= len(col):
                col[off - 1] = 4
    return col


def decode_chain(primer: int, colors: np.ndarray) -> np.ndarray:
    """Primer-chain decode: base[i] = base[i-1] ^ color[i] starting from the
    primer. Fast but error-propagating — used only to hand colorspace IUM
    reads to the base-space spliced stages (the reference instead realigns
    segments in color space)."""
    out = np.empty(len(colors), np.int8)
    prev = primer
    for i, c in enumerate(colors):
        prev = prev ^ int(c) if c <= 3 and prev <= 3 else 4
        out[i] = prev
    return out


def decode_alignment(genome: np.ndarray, pos: int, colors: np.ndarray
                     ) -> Tuple[np.ndarray, int, int]:
    """Reference-guided decode of an ungapped color placement.

    colors: the read's alignment colors (primer transition dropped), length
    L-1 for L decoded bases; the placement spans genome[pos : pos+L].
    Returns (bases int8[L], color_mismatches, base_mismatches_vs_ref).

    Greedy form of the reference's ML decode (BWA_decode): scan colors
    against the genome's transition colors; an isolated mismatch is a
    sequencing error (keep reference bases — zero base mismatches); two
    adjacent mismatching colors whose XOR composition is consistent
    (c[i]^g[i] == c[i+1]^g[i+1]) are a real SNP at base i+1 (decode the
    variant base, one base mismatch)."""
    L = len(colors) + 1
    ref = genome[pos: pos + L].astype(np.int8)
    bases = ref.copy()
    gcol = (ref[:-1] ^ ref[1:]).astype(np.int8)
    bad = np.where((ref[:-1] > 3) | (ref[1:] > 3), np.int8(4), gcol)
    cmm = 0
    bmm = 0
    i = 0
    n = len(colors)
    while i < n:
        c = int(colors[i])
        g = int(bad[i])
        if c > 3 or g > 3:
            cmm += c > 3
            i += 1
            continue
        if c == g:
            i += 1
            continue
        cmm += 1
        if i + 1 < n and int(colors[i + 1]) <= 3 and int(bad[i + 1]) <= 3 \
                and int(colors[i + 1]) != int(bad[i + 1]) \
                and (c ^ g) == (int(colors[i + 1]) ^ int(bad[i + 1])):
            # consistent adjacent pair -> SNP at base i+1
            bases[i + 1] = ref[i + 1] ^ (c ^ g)
            bmm += 1
            cmm += 1
            i += 2
        else:
            i += 1  # isolated -> sequencing error, keep reference base
    return bases, cmm, bmm


def read_csfasta(path: str, qual_path: str | None = None):
    """Yield (name, primer, colors, qual_phred33) from a .csfasta file (and
    optional matching _QV.qual file of space-separated phred values)."""
    from tophat_tpu_torch.io.fastq import _open

    quals = None
    if qual_path:
        quals = {}
        name = None
        with _open(qual_path) as f:
            for line in f:
                line = line.strip()
                if line.startswith(b">"):
                    name = line[1:].split()[0].decode()
                elif line and name:
                    vals = np.clip(np.fromiter(
                        (int(v) for v in line.split()), np.int32), 0, 60)
                    quals[name] = (vals + 33).astype(np.uint8).tobytes()
                    name = None
    name = None
    seq: List[bytes] = []
    with _open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith(b"#"):
                continue
            if line.startswith(b">"):
                if name is not None:
                    s = b"".join(seq)
                    primer, colors = encode_color_read(s)
                    q = (quals or {}).get(name, b"I" * len(colors))
                    yield name, primer, colors, q
                name = line[1:].split()[0].decode()
                seq = []
            elif line:
                seq.append(line)
    if name is not None:
        s = b"".join(seq)
        primer, colors = encode_color_read(s)
        q = (quals or {}).get(name, b"I" * len(colors))
        yield name, primer, colors, q
