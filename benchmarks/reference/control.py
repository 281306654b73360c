"""The control: the reference in the program's place, breaking one
guarantee the configurations state, that every genome position is exact.

A port that carried global genome positions in float32 (a 24-bit
significand) would round every position past 2^24 to a multiple of 2, 4,
8 or 16 on a genome of up to 2^28 bases (the configurations' 143.7 Mbp).
The control writes such a port's answers: the program's records and
junctions with every position rounded so (as global positions, then put
back on their contigs), and the realignment records of the reference
worked out at event coordinates rounded the same way, with that rounded
event table. The comparison must call each of them wrong.

On a genome of up to 2^b bases the significand is b - 4 bits, float32's
24 at 2^28, so that a test on a small genome breaks positions as often.
"""

from __future__ import annotations

import math

import numpy as np

from benchmarks.reference import realign as realignref

SPARE_BITS = 4      # 2^28 bases in float32's 24-bit significand


def significand_bits(genome_bases: int) -> int:
    return max(1, math.ceil(math.log2(genome_bases)) - SPARE_BITS)


def f32(pos, bits: int = 24):
    """Non-negative positions rounded to a `bits`-bit significand, ties to
    even, as float32 rounds them at bits = 24; int64."""
    pos = np.asarray(pos, np.int64)
    e = np.floor(np.log2(np.maximum(pos, 1))).astype(np.int64)
    step = np.left_shift(1, np.maximum(e - (bits - 1), 0))
    return (np.round(pos / step) * step).astype(np.int64)


def _rounded(layout, contig: str, pos0: int, bits: int) -> int:
    start = layout.start(contig) if contig in layout.names else 0
    return int(f32(start + pos0, bits)) - start


def round_sam(src: str, dst: str, layout, bits: int) -> None:
    """src with every record's POS and PNEXT (1-based, on RNAME's and
    RNEXT's contig) rounded, as global 0-based positions, to a `bits`-bit
    significand."""
    with open(src) as f, open(dst, "w") as g:
        for line in f:
            if not line.startswith("@"):
                t = line.split("\t")
                for k, c in ((3, t[2]), (7, t[2] if t[6] == "=" else t[6])):
                    if int(t[k]) > 0:
                        t[k] = str(_rounded(layout, c, int(t[k]) - 1,
                                            bits) + 1)
                line = "\t".join(t)
            g.write(line)


def round_bed(src: str, dst: str, layout, bits: int) -> None:
    """src with every junction's start rounded, as a global position, to a
    `bits`-bit significand (its blocks keep their sizes and offsets)."""
    with open(src) as f, open(dst, "w") as g:
        for line in f:
            if not line.startswith("track"):
                t = line.split("\t")
                shift = _rounded(layout, t[0], int(t[1]), bits) - int(t[1])
                for k in (1, 2, 6, 7):
                    t[k] = str(int(t[k]) + shift)
                line = "\t".join(t)
            g.write(line)


def rounded_events(events, bits: int):
    """The event table's coordinates rounded: (left, right)."""
    return f32(events["left"], bits), f32(events["right"], bits)


def realign_wrong(call, genome_codes, rows, left, right,
                  device="cpu") -> int:
    """The realignment comparison with the reference at the event
    coordinates left/right (rounded) in the program's place."""
    readsg, lengths, events, max_mm = call
    ref = realignref.records(genome_codes, np.asarray(readsg)[rows],
                             np.asarray(lengths)[rows], events, max_mm,
                             device=device, left=left, right=right)
    r, e, t, m = zip(*sorted(ref)) if ref else ((), (), (), ())
    placed = (readsg, lengths, events, max_mm,
              (np.asarray(rows)[list(r)] if r else np.zeros(0, int),
               np.asarray(e), np.asarray(t), np.asarray(m)))
    return realignref.compare(placed, genome_codes, rows, device=device)
