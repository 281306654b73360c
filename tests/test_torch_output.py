"""The one record emitter (tophat_tpu_torch/io/emit.py) behind both output
writers: from the same record columns, the native pass and the Python
fallback write the same accepted_hits.sam bytes and BAM record blob, for
every record kind and field the writers emit; each BAM record decodes to
its SAM line; the columnar CIGAR, NM and XS equal Candidate.cigar,
Candidate.nm and the junction's strand."""

import numpy as np
import pytest

from tophat_tpu_torch import native
from tophat_tpu_torch.index.fasta import Genome
from tophat_tpu_torch.io.bam import decode_record
from tophat_tpu_torch.io.fastq import ReadBatch
from tophat_tpu_torch.ops.splice import (KIND_DELETION, KIND_FUSION,
                                         KIND_INSERTION, KIND_JUNCTION)
from tophat_tpu_torch.pipeline import paired, report
from tophat_tpu_torch.pipeline.params import Params
from tophat_tpu_torch.pipeline.report import Candidate

# three contigs, the last past 2^29 bases (its records take BAI bin 0)
OFFSETS = np.array([0, 50_000, 120_000, 120_000 + (1 << 30)], np.int64)
NAMES = ["chrA", "chrB", "chrLong"]
EVENTS = {  # junctions on both strands, a deletion, an insertion, a fusion
    "left": np.array([1_000, 2_000, 3_000, 4_000, 5_000, 60_000]),
    "right": np.array([1_400, 2_300, 3_003, 4_001, 70_000, 61_000]),
    "kind": np.array([KIND_JUNCTION, KIND_JUNCTION, KIND_DELETION,
                      KIND_INSERTION, KIND_FUSION, KIND_JUNCTION], np.int8),
    "antisense": np.array([0, 1, 0, 0, 0, 1], bool),
}


def _genome():
    return Genome(codes=np.zeros(8, np.int8), offsets=OFFSETS,
                  names=list(NAMES))


def _batch(lengths, seed, no_qual=()):
    """Reads of these (odd and even) lengths, random bases with some N;
    reads in no_qual have no qualities."""
    rng = np.random.default_rng(seed)
    L = max(lengths)
    codes = np.full((len(lengths), L), -1, np.int8)
    quals = []
    for i, n in enumerate(lengths):
        codes[i, :n] = rng.choice(5, n, p=[0.24, 0.24, 0.24, 0.24, 0.04])
        quals.append(b"" if i in no_qual else
                     bytes(rng.integers(35, 74, n).astype(np.uint8)))
    return ReadBatch(names=[f"r{seed}_{i}" for i in range(len(lengths))],
                     codes=codes, quals=quals,
                     lengths=np.array(lengths, np.int32))


def _c(read, pos, strand=0, mm=0, kind=-1, ev=-1, t=0, gap=0, ops=(),
       **kw):
    return Candidate(read=read, pos=pos, strand=strand, mm=mm, kind=kind,
                     ev=ev, t=t, gap=gap, chain_ops=tuple(ops),
                     chain_events=tuple(op[1] for op in ops
                                        if op[0] == "EV"), **kw)


LONG = int(OFFSETS[2]) + (1 << 29) + 777     # past 2^29 on chrLong


def _single_end(case):
    """(params, parts) of a single-end case."""
    b = _batch([75, 76, 51, 100, 99, 75], seed=len(case),
               no_qual=(2,) if case == "rg_noqual" else ())
    sel = {
        "contiguous": {0: [_c(0, 10, mm=1)], 1: [_c(1, 60_123, strand=1)],
                       2: [_c(2, 49_949)]},
        "junction": {0: [_c(0, 1_000 - 39, kind=KIND_JUNCTION, ev=0, t=40,
                            gap=400)],
                     1: [_c(1, 2_000 - 10, strand=1, mm=2,
                            kind=KIND_JUNCTION, ev=1, t=11, gap=300)],
                     3: [_c(3, 60_000 - 59, kind=KIND_JUNCTION, ev=5, t=60,
                            gap=1_000)]},
        "indels": {0: [_c(0, 3_000 - 29, kind=KIND_DELETION, ev=2, t=30,
                          gap=3, mm=1)],
                   1: [_c(1, 4_000 - 19, strand=1, kind=KIND_INSERTION,
                          ev=3, t=20, gap=2)]},
        "fusion": {0: [_c(0, 5_000 - 29, kind=KIND_FUSION, ev=4, t=30)],
                   1: [_c(1, 5_100, strand=1, kind=KIND_FUSION, ev=4, t=25,
                          fdir="rf")],
                   2: [_c(2, 5_300, kind=KIND_FUSION, t=20,
                          fpos2=80_000)]},
        "chain": {
            # a lead soft clip (rf chain), then a junction
            0: [_c(0, 1_200, kind=-2, mm=1,
                   ops=[("FUS", 90_000, "rf"), ("M", 20),
                        ("EV", 0, KIND_JUNCTION, 400), ("M", 30)])],
            # junction, deletion, insertion: N, D and I ops, NM of both
            3: [_c(3, 1_000 - 19, strand=1, kind=-2, mm=2,
                   ops=[("M", 20), ("EV", 0, KIND_JUNCTION, 400),
                        ("M", 30), ("EV", 2, KIND_DELETION, 3), ("M", 20),
                        ("EV", 3, KIND_INSERTION, 2), ("M", 28)])],
            # antisense junction first, then a fusion: the rest clipped
            4: [_c(4, 2_000 - 9, kind=-2,
                   ops=[("M", 10), ("EV", 1, KIND_JUNCTION, 300),
                        ("M", 40), ("EV", 4, KIND_FUSION, 0), ("M", 49)])],
            # a trailing fusion partner
            5: [_c(5, 6_000, kind=-2,
                   ops=[("M", 40), ("FUS", 100_000, "ff"), ("M", 35)])]},
        "secondary": {
            0: [_c(0, 10), _c(0, 700, strand=1), _c(0, 60_000, mm=1)],
            1: [_c(1, 200), _c(1, 300)],
            3: [_c(3, 1_000 - 49, kind=KIND_JUNCTION, ev=0, t=50, gap=400),
                _c(3, 65_000)]},
        "rg_noqual": {0: [_c(0, LONG)], 1: [_c(1, LONG + 5, strand=1)],
                      2: [_c(2, 11, strand=1), _c(2, 90)]},
    }[case]
    params = Params(rg_id="grp1", rg_sample="s1") if case == "rg_noqual" \
        else Params()
    return params, [(b, sel)]


def _paired_records():
    """Records as paired._select_pairs makes them: cross-contig mates
    (RNEXT named), negative TLEN, a proper pair, an unmapped mate, reverse
    mates, reads past 2^29; two chunks."""
    parts = [(_batch([76, 75, 101], seed=11), {}),
             (_batch([76, 75, 101], seed=12), {}),
             (_batch([75, 76], seed=13), {}),
             (_batch([75, 76], seed=14), {})]
    P, R1, R2 = 0x1, 0x40, 0x80
    rev, mrev, proper, munmapped = 0x10, 0x20, 0x2, 0x8
    recs = [
        # chunk 0, pair 0: proper, mate 2 reverse, TLEN +/-
        (_c(0, 1_000), 1, 76, P | R1 | proper | mrev, 1_150, 226, 0),
        (_c(0, 1_150, strand=1), 1, 76, P | R2 | proper | rev, 1_000,
         -226, 1),
        # pair 1: mate 1 on chrA, mate 2 on chrB (RNEXT named both ways)
        (_c(1, 40_000, kind=KIND_JUNCTION, ev=0, t=30, gap=400), 1, 75,
         P | R1, 70_000, 0, 0),
        (_c(1, 70_000, strand=1), 1, 75, P | R2 | rev | mrev, 40_000, 0, 1),
        # pair 2: mate 2 unmapped; mate 1 two placements
        (_c(2, 2_000, mm=1), 2, 101, P | R1 | munmapped, -1, 0, 0),
        (_c(2, 3_000, strand=1), 2, 101, P | R1 | munmapped | rev, -1, 0,
         0),
        # chunk 1: a chain, and mates past 2^29 on chrLong
        (_c(0, 1_000 - 19, kind=-2, mm=1,
            ops=[("M", 20), ("EV", 0, KIND_JUNCTION, 400), ("M", 55)]), 1,
         75, P | R1 | mrev, LONG, 0, 2),
        (_c(0, LONG, strand=1), 1, 75, P | R2 | rev, 1_000 - 19, 0, 3),
        (_c(1, LONG + 300), 1, 76, P | R1 | proper | mrev, LONG + 100,
         -276, 2),
        (_c(1, LONG + 100, strand=1, kind=KIND_DELETION, ev=2, t=40,
            gap=3), 1, 76, P | R2 | proper | rev, LONG + 300, 276, 3),
    ]
    return parts, recs


CASES = ["contiguous", "junction", "indels", "fusion", "chain", "secondary",
         "rg_noqual", "mates", "mates_v2"]


def _write(case, out, native_on, monkeypatch):
    """Write the case's accepted_hits.sam under out with the native
    library on or off; (SAM bytes, BAM blob)."""
    out.mkdir()
    with monkeypatch.context() as m:
        if not native_on:
            m.setattr(native.bamenc, "_lib", None)
            m.setattr(native.bamenc, "_failed", True)
        if case.startswith("mates"):
            parts, recs = _paired_records()
            params = Params(v2_sam=case == "mates_v2")
            blob = paired._emit_paired(str(out), _genome(), params, EVENTS,
                                       list(recs), parts)
        else:
            params, parts = _single_end(case)
            blob = report._write_sam(str(out), _genome(), params, parts,
                                     EVENTS)[2]
    return (out / "accepted_hits.sam").read_bytes(), blob


def _bam_as_sam(blob):
    """Each BAM record of the blob as the fields of its SAM line."""
    out, p = [], 0
    while p < len(blob):
        rec, p = decode_record(blob, p)
        cig = "".join(f"{n}{op}" for op, n in rec.cigar if n > 0) or "*"
        rnext = ("*" if rec.ref_id2 < 0 else
                 "=" if rec.ref_id2 == rec.ref_id else NAMES[rec.ref_id2])
        tags = [f"{t}:{ty}:{v}" for t, ty, v in rec.tags]
        out.append([rec.name, str(rec.flag), NAMES[rec.ref_id],
                    str(rec.pos + 1), str(rec.mapq), cig, rnext,
                    str(rec.pos2 + 1 if rec.pos2 >= 0 else 0),
                    str(rec.tlen), rec.seq.decode(), rec.qual.decode()]
                   + tags)
    return out


@pytest.mark.parametrize("case", CASES)
def test_native_and_fallback_write_the_same_bytes(case, tmp_path,
                                                  monkeypatch):
    if not native.bamenc.available:
        pytest.skip("the native library cannot be built here")
    sam_c, bam_c = _write(case, tmp_path / "native", True, monkeypatch)
    sam_py, bam_py = _write(case, tmp_path / "python", False, monkeypatch)
    assert sam_c == sam_py
    assert bam_c == bam_py
    lines = [ln.split("\t") for ln in sam_c.decode().splitlines()]
    assert len(lines) >= 2
    bam = _bam_as_sam(bam_c)
    for s, b in zip(lines, bam):
        if s[6] not in ("=", "*"):
            b[7] = s[7]      # BAM keeps a mate's position on its own contig
        assert s == b
    assert len(bam) == len(lines)
    text = sam_c.decode()
    want = {"junction": ["XS:A:+", "XS:A:-", "N"],
            "indels": ["D", "I"],
            "fusion": ["XF:Z:chrA-chrB", "S"],
            "chain": ["XS:A:+", "XS:A:-", "XF:Z:chrA-chrB", "D", "I"],
            "secondary": ["CC:Z:=", "CC:Z:chrB", "CP:i:"],
            "rg_noqual": ["RG:Z:grp1", "\t*\tNM:i:", "chrLong"],
            "mates": ["\tchrB\t", "\t-226\t", "\t=\t"],
            "mates_v2": ["\t-276\t", "\t50\t"]}.get(case, [])
    for w in want:
        assert w in text, w
    if case == "rg_noqual":
        long_recs = [b for b in _bam_blob_bins(bam_c) if b[0] == 2]
        assert long_recs and all(bin_ == 0 for _, bin_ in long_recs)


def _bam_blob_bins(blob):
    """(ref_id, bin) of every BAM record in the blob."""
    import struct

    out, p = [], 0
    while p < len(blob):
        (size, ref, _, _, _, bin_) = struct.unpack_from("<iiiBBH", blob, p)
        out.append((ref, bin_))
        p += 4 + size
    return out


@pytest.mark.parametrize("case", ["contiguous", "junction", "indels",
                                  "fusion", "chain", "secondary"])
def test_columns_match_candidate_methods(case):
    """record_columns' packed CIGAR, NM and XS against Candidate.cigar,
    Candidate.nm and the junction's strand, record by record."""
    _, parts = _single_end(case)
    batch, sel = parts[0]
    cs = [c for cl in sel.values() for c in cl]
    rl = np.array([int(batch.lengths[c.read]) for c in cs], np.int64)
    f = report.record_columns(_genome(), EVENTS, cs,
                              report.gather_candidates(cs), rl)
    for i, c in enumerate(cs):
        ops = f["cigar"][f["cig_off"][i]:f["cig_off"][i + 1]]
        got = [("MIDNSHP=X"[v & 0xF], int(v >> 4)) for v in ops]
        assert got == c.cigar(int(rl[i])), i
        assert f["nm"][i] == c.nm()
        juncs = ([c.ev] if c.kind == KIND_JUNCTION else
                 [op[1] for op in c.chain_ops
                  if op[0] == "EV" and op[2] == KIND_JUNCTION])
        xs = f["xs"][i] + f["xs_chain"][i]
        assert xs == (0 if not juncs else
                      ord("-" if EVENTS["antisense"][juncs[0]] else "+"))
