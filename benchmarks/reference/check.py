"""The plain reference for a sample's output files.

It knows where each mate truly lies (the generator's truth), the genome
(the benchmark's own codes, its contigs) and every true intron, and reads
what the program wrote: accepted_hits.sam and junctions.bed. It imports
nothing of the port.

Per checked fragment it counts, for each of its mates:
  unspliced mates   mates that cross no junction (contiguous reads, each
                    mate with one mismatch; transcript fragments inside one
                    exon; the mate 2 of a junction pair): missed when no
                    record is placed
  spliced mates     mates that cross junctions with at least `anchor`
                    bases in every block and introns of at least
                    `min_intron` bases: missed when no record is placed,
                    or when the record at the truth is there but a crossed
                    intron that the program had to discover (one not in
                    the annotation it was given) is absent from
                    junctions.bed
  records           every record of a checked mate: wrong when its SEQ is
                    not the mate's read (reverse-complemented on the
                    reverse strand), its CIGAR does not span the read, it
                    runs off its contig, or its NM is not the edit
                    distance worked out again against the genome
A record is placed when it has the true contig, strand, POS and CIGAR (M
and N blocks), or, where the read has copies in the genome (repeats), when
it is a right record, clips nothing and has no more edits than the read
has at its truth: an alignment as good as the truth, which a multi-hit
aligner may report in its place.
Per sample, of junctions.bed:
  bed junctions     every junction: spurious when it is no true intron
                    (neither annotated nor one of the genome's unannotated
                    introns)
Mates crossing a junction with fewer than `anchor` bases in a block, or an
intron shorter than `min_intron` (the program's least reported intron:
min(-i, --min-segment-intron)), are not counted as either kind: TopHat
promises nothing of them without an annotation.
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np

CIGAR_OP = re.compile(r"(\d+)([MIDNSHP=X])")
BASE = np.full(256, 4, np.int8)
for _i, _c in enumerate(b"ACGT"):
    BASE[_c] = _i


@dataclasses.dataclass
class Tally:
    """Counts over the checked fragments of one or more samples."""

    unspliced: int = 0
    unspliced_missed: int = 0
    spliced: int = 0
    spliced_missed: int = 0
    records_wrong: int = 0
    bed: int = 0
    bed_spurious: int = 0

    def add(self, other: "Tally") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name)
                    + getattr(other, f.name))

    def numbers(self) -> dict:
        pct = lambda a, b: 100.0 * a / b if b else 0.0
        return {"unspliced_missed_pct": pct(self.unspliced_missed,
                                            self.unspliced),
                "spliced_missed_pct": pct(self.spliced_missed, self.spliced),
                "records_wrong": self.records_wrong,
                "bed_spurious_pct": pct(self.bed_spurious, self.bed)}


def true_cigar(gp: np.ndarray):
    """(CIGAR, introns as (left, right), shortest M block) of a mate whose
    bases lie at genome positions gp (genome order)."""
    jumps = np.nonzero(np.diff(gp) != 1)[0]
    ops, introns, blocks = [], [], []
    a = 0
    for j in jumps:
        blocks.append(int(j) + 1 - a)
        ops += [f"{j + 1 - a}M", f"{gp[j + 1] - gp[j] - 1}N"]
        introns.append((int(gp[j]), int(gp[j + 1])))
        a = int(j) + 1
    blocks.append(len(gp) - a)
    ops.append(f"{len(gp) - a}M")
    return "".join(ops), introns, min(blocks)


def read_junctions(path: str) -> set:
    """(contig, left, right) of every junction in a junctions.bed: left the
    last exonic base before the intron, right the first after, 0-based."""
    out = set()
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            if line.startswith("track"):
                continue
            t = line.split("\t")
            start = int(t[1])
            size0 = int(t[10].split(",")[0])
            start1 = int(t[11].split(",")[1])
            out.add((t[0], start + size0 - 1, start + start1))
    return out


def read_records(path: str, names: set) -> dict:
    """{(name, mate 1 or 2): [(flag, contig, pos0, cigar, seq, nm), ...]}
    of the SAM records of the reads named in `names`."""
    recs = {}
    if not os.path.exists(path):
        return recs
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            name = line[:line.index("\t")]
            if name not in names:
                continue
            t = line.rstrip("\n").split("\t")
            flag = int(t[1])
            nm = next((int(x[5:]) for x in t[11:] if x.startswith("NM:i:")),
                      None)
            mate = 2 if flag & 0x80 else 1
            recs.setdefault((name, mate), []).append(
                (flag, t[2], int(t[3]) - 1, t[5], t[9], nm))
    return recs


def edit_distance_ok(codes, span, rec, read: np.ndarray) -> bool:
    """Whether one record agrees with the genome and the read: SEQ is the
    read (reverse-complemented on the reverse strand), the CIGAR spans the
    read and stays on its contig (`span`: its global (start, end)), and NM
    is the edit distance worked out again along the CIGAR."""
    flag, _, pos0, cigar, seq, nm = rec
    s = BASE[np.frombuffer(seq.encode(), np.uint8)]
    want = read if not flag & 0x10 else np.where(read < 4, 3 - read,
                                                 read)[::-1]
    if len(s) != len(want) or not np.array_equal(s, want):
        return False
    g = span[0] + pos0
    q = 0
    edits = 0
    for n, op in CIGAR_OP.findall(cigar):
        n = int(n)
        if op in "M=X":
            if g < span[0] or g + n > span[1]:
                return False
            edits += int(np.count_nonzero(codes[g:g + n] != s[q:q + n]))
            g += n
            q += n
        elif op == "I":
            edits += n
            q += n
        elif op == "D":
            edits += n
            g += n
        elif op == "N":
            g += n
        elif op == "S":
            q += n
        else:
            return False
    return q == len(s) and nm == edits


def check_sample(codes, layout, truth, pairs: np.ndarray, sam_path: str,
                 bed_path: str, anchor: int, min_intron: int,
                 given=frozenset(), true_introns=frozenset()) -> Tally:
    """The tally of one sample's output over its checked fragments:
    fragment pairs[j] (its reads named p<pairs[j]>) is row j of `truth` (a
    gen.pairs.Sample cut to the checked fragments). `layout` holds the
    contigs (gen.genome.Layout); `given` the global (left, right) introns
    of the annotation the program was given, `true_introns` every true
    intron. A missing file reads as empty."""
    recs = read_records(sam_path, {f"p{int(i)}" for i in pairs})
    juncs = {(layout.start(c) + lt, layout.start(c) + rt)
             for c, lt, rt in read_junctions(bed_path)}
    t = Tally(bed=len(juncs), bed_spurious=len(juncs - set(true_introns)))
    spans = {n: layout.span(n) for n in layout.names}
    reads = truth.mates
    for j, i in enumerate(pairs):
        i = int(i)
        for mate in range(1, len(reads) + 1):
            got = recs.get((f"p{i}", mate), [])
            read = reads[mate - 1][j]
            gp = truth.gp[j, mate - 1]
            rev = bool(truth.rev[j, mate - 1])
            cigar, introns, shortest = true_cigar(gp)
            name = layout.names[int(layout.contig_of(gp[0]))]
            start = spans[name][0]
            ok = [edit_distance_ok(codes, spans.get(r[1], (0, -1)), r, read)
                  for r in got]
            t.records_wrong += ok.count(False)
            at_truth = any(bool(r[0] & 0x10) == rev and r[1] == name
                           and r[2] == int(gp[0]) - start
                           and r[3] == cigar for r in got)
            seen = read if not rev else np.where(read < 4, 3 - read,
                                                 read)[::-1]
            edits = int(np.count_nonzero(codes[gp] != seen))
            as_good = any(k and r[5] <= edits and "S" not in r[3]
                          and "H" not in r[3] for k, r in zip(ok, got))
            if not introns:
                t.unspliced += 1
                t.unspliced_missed += not (at_truth or as_good)
            elif shortest >= anchor and min(
                    rt - lt - 1 for lt, rt in introns) >= min_intron:
                t.spliced += 1
                in_bed = all((lt, rt) in juncs for lt, rt in introns
                             if (lt, rt) not in given)
                t.spliced_missed += not ((at_truth and in_bed) or
                                         (as_good and not at_truth))
    return t


def expected_introns(truth, anchor: int, min_intron: int) -> set:
    """The global (left, right) introns that a sample's mates cross with
    at least `anchor` bases in each block adjoining the intron and at
    least `min_intron` bases of intron: the ones discovery must find."""
    gp = truth.gp.reshape(-1, truth.gp.shape[-1])
    L = gp.shape[1]
    row, col = np.nonzero(np.diff(gp, axis=1) != 1)
    if len(row) == 0:
        return set()
    first = np.r_[True, row[1:] != row[:-1]]
    last = np.r_[row[1:] != row[:-1], True]
    prev = np.where(first, -1, np.r_[-1, col[:-1]])
    nxt = np.where(last, L - 1, np.r_[col[1:], 0])
    left, right = gp[row, col], gp[row, col + 1]
    keep = ((col - prev >= anchor) & (nxt - col >= anchor)
            & (right - left - 1 >= min_intron))
    return set(zip(left[keep].tolist(), right[keep].tolist()))


def events_missed(events, expected) -> set:
    """Expected introns that are no valid junction event (kind 0, left the
    last exonic base, right the first after) of a realignment call's event
    table."""
    kind = np.asarray(events["kind"])
    valid = np.asarray(events.get("valid", np.ones(len(kind), bool)), bool)
    sel = (kind == 0) & valid
    have = set(zip(np.asarray(events["left"], np.int64)[sel].tolist(),
                   np.asarray(events["right"], np.int64)[sel].tolist()))
    return set(expected) - have


def checked_pairs(rng: np.random.Generator, n: int, k: int) -> np.ndarray:
    """The fragments of a sample of n that are checked: k drawn from the
    seed (all of them where k >= n), sorted."""
    if k >= n:
        return np.arange(n)
    return np.sort(rng.choice(n, k, replace=False))
