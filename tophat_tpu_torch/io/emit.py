"""One record emitter for both output writers: accepted_hits.sam's record
lines and the BAM record blob from one pass over record columns.

The paired writer (pipeline/paired.py) and the single-end writer
(pipeline/report.py) gather their sorted records into the same table,
`COLUMNS` record-major in an int64 array, with the packed BAM CIGAR ops,
and hand it to emit() with the reads it points into (ReadPool) and each
record's extra tags. The native pass (native/bamenc.cpp, emit_records)
formats both outputs at C speed; without the library, _emit_python does
the same in Python, byte for byte (role of rewrite_sam_record and
print_sam_for_single, reference src/tophat_reports.cpp:656-1050, and of
samtools bam_write1).

The fields follow the reference's final rewrite: MAPQ from NH; aux order
NM:i, [XS:A], NH:i, the writer's extras, RG:Z last; RNEXT "*" with no
mate, "=" on the same contig, else the mate's contig name; reverse-strand
records store the reverse-complemented sequence and reversed qualities.
BAM stores the mate's position only when the mate lies on the record's
own contig.
"""

from __future__ import annotations

import struct
from typing import List, Sequence, Tuple

import numpy as np

from tophat_tpu_torch.index.fasta import _CODE_TO_BASE
from tophat_tpu_torch.io import sam as samio
from tophat_tpu_torch.utils import trace

COLUMNS = ("read", "seq", "rl", "flag", "cid", "pos", "mapq", "nm", "nh",
           "xs", "mate_cid", "mate_pos", "tlen")
COL = {name: i for i, name in enumerate(COLUMNS)}

# BAM CIGAR op codes (the low 4 bits of a packed op)
OP_M, OP_I, OP_D, OP_N, OP_S = 0, 1, 2, 3, 4
_CIGAR_CHARS = "MIDNSHP=X"
_REF_OPS = (0, 2, 3, 7, 8)   # M, D, N, =, X consume the reference
_I4 = struct.Struct("<i")
_RC = bytes.maketrans(b"ACGTNacgtn", b"TGCANtgcan")


def offsets(lengths) -> np.ndarray:
    """[0, cumsum(lengths)...]: the starts of segments of these lengths,
    and their end."""
    out = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=out[1:])
    return out


def ascii_bases(codes: np.ndarray) -> np.ndarray:
    """A batch's read codes as ASCII bases, (B, L) uint8, in one lookup;
    padding past a read's length decodes too and is never read."""
    return _CODE_TO_BASE[np.clip(codes, 0, 4)]


def _blob(b: bytes) -> np.ndarray:
    return np.frombuffer(b, np.uint8) if b else np.zeros(1, np.uint8)


class ReadPool:
    """Every part's reads under one global index: the names, the bases as
    ASCII (one vectorised decode a batch) and the qualities, each a blob
    with offsets, so a record points at its read by two integers."""

    def __init__(self, batches: Sequence):
        names, quals, seqs = [], [], []
        self.read_base, self.seq_base, self.width = [], [], []
        n_reads = n_seq = 0
        for b in batches:
            L = int(b.codes.shape[1])
            self.read_base.append(n_reads)
            self.seq_base.append(n_seq)
            self.width.append(L)
            names += b.names
            quals += b.quals
            seqs.append(ascii_bases(b.codes).reshape(-1))
            n_reads += b.size
            n_seq += b.size * L
        text = "".join(names)
        blob = text.encode()
        if len(blob) == len(text):
            name_len = np.fromiter(map(len, names), np.int64, len(names))
        else:
            enc = [n.encode() for n in names]
            name_len = np.fromiter(map(len, enc), np.int64, len(enc))
        self.names = _blob(blob)
        self.name_off = offsets(name_len)
        self.qual = _blob(b"".join(quals))
        self.qual_off = offsets(np.fromiter(map(len, quals), np.int64,
                                             len(quals)))
        self.seq = (np.concatenate(seqs) if seqs and n_seq
                    else np.zeros(1, np.uint8))

    def locate(self, part: np.ndarray, read: np.ndarray):
        """(global read index, offset of the read's bases) per record."""
        base = np.asarray(self.read_base, np.int64)[part]
        seq = (np.asarray(self.seq_base, np.int64)[part]
               + read * np.asarray(self.width, np.int64)[part])
        return base + read, seq


def mapq_column(nh: np.ndarray, v2: bool) -> np.ndarray:
    """MAPQ of every record from its NH (samio.mapq_for_nh, one call per
    distinct NH)."""
    u, inv = np.unique(nh, return_inverse=True)
    table = np.array([samio.mapq_for_nh(int(x), v2) for x in u], np.int64)
    return table[inv].reshape(-1)


def extra_tags(n: int, rows: Sequence[int], tags: Sequence[List[str]]):
    """Ragged extra-tag columns of n records from the rows that have any:
    (SAM blob, offsets, BAM blob, offsets). tags: each row's SAM tags
    ("CC:Z:=", "CP:i:101", ...), in row order."""
    sam_frags = [("\t" + "\t".join(t)).encode() for t in tags]
    bam_frags = [_bam_tags(t) for t in tags]
    sam_len = np.zeros(n, np.int64)
    bam_len = np.zeros(n, np.int64)
    rows = np.asarray(rows, np.int64)
    sam_len[rows] = np.fromiter(map(len, sam_frags), np.int64, len(rows))
    bam_len[rows] = np.fromiter(map(len, bam_frags), np.int64, len(rows))
    return (_blob(b"".join(sam_frags)), offsets(sam_len),
            _blob(b"".join(bam_frags)), offsets(bam_len))


def _bam_tags(tags: List[str]) -> bytes:
    out = b""
    for e in tags:
        tg, ty, val = e.split(":", 2)
        if ty == "i":
            out += tg.encode() + b"i" + _I4.pack(int(val))
        elif ty == "Z":
            out += tg.encode() + b"Z" + val.encode() + b"\x00"
        else:
            out += tg.encode() + ty.encode() + val.encode()
    return out


def emit(pool: ReadPool, cols: np.ndarray, cigar: np.ndarray,
         cig_off: np.ndarray, ref_names: List[str], extras=None,
         rg_id: str = "") -> Tuple[bytes, bytes]:
    """(accepted_hits.sam's record lines, the BAM record blob) of the
    table's records in its order. cols: (n, len(COLUMNS)) int64; cigar:
    packed BAM ops (uint32), record i's at [cig_off[i], cig_off[i+1]);
    extras: extra_tags(...) or None. Counts `records.native` (records the
    native pass formatted) and `records.extra` (records with extra
    tags)."""
    from tophat_tpu_torch.native import bamenc as native_enc

    n = len(cols)
    cols = np.ascontiguousarray(cols, np.int64)
    cigar = np.ascontiguousarray(cigar, np.uint32)
    cig_off = np.ascontiguousarray(cig_off, np.int64)
    # the BAM prefix stores l_read_name in a uint8 and n_cigar_op in a
    # uint16: fail loud instead of wrapping the record stream
    name_len = np.diff(pool.name_off)[cols[:, COL["read"]]]
    if name_len.max(initial=0) > 254:
        raise ValueError("BAM query name longer than 254 bytes")
    if np.diff(cig_off).max(initial=0) > 65535:
        raise ValueError("BAM record with more than 65535 CIGAR ops")
    if extras is None:
        z = np.zeros(n + 1, np.int64)
        extras = (np.zeros(1, np.uint8), z, np.zeros(1, np.uint8), z)
    trace.count("records.extra", int(np.count_nonzero(np.diff(extras[1]))))
    rg_sam = f"\tRG:Z:{rg_id}".encode() if rg_id else b""
    rg_bam = (b"RGZ" + rg_id.encode() + b"\x00") if rg_id else b""
    if not native_enc.available:
        trace.count("records.native", 0)
        return _emit_python(pool, cols, cigar, cig_off, ref_names, extras,
                            rg_sam, rg_bam)
    trace.count("records.native", n)
    if n == 0:
        return b"", b""
    xsam, xsam_off, xbam, xbam_off = extras
    refs = [r.encode() for r in ref_names]
    ref_len = np.fromiter(map(len, refs), np.int64, len(refs))
    rl = cols[:, COL["rl"]]
    n_cig = np.diff(cig_off)
    sam_cap = int((name_len + 2 * ref_len.max(initial=1) + 12 * n_cig
                   + 2 * rl + np.diff(xsam_off) + len(rg_sam) + 256).sum())
    bam_cap = int((36 + name_len + 1 + 4 * n_cig + (rl + 1) // 2 + rl + 18
                   + np.diff(xbam_off) + len(rg_bam)).sum())
    return native_enc.emit(
        cols, cigar, cig_off, pool.names, pool.name_off, pool.seq,
        pool.qual, pool.qual_off, _blob(b"".join(refs)), offsets(ref_len),
        xsam, xsam_off, xbam, xbam_off, rg_sam, rg_bam, sam_cap, bam_cap)


def _emit_python(pool, cols, cigar, cig_off, ref_names, extras, rg_sam,
                 rg_bam):
    """The emitter without the native library: the same bytes, a record
    at a time in Python; the BAM records through
    io/bam.encode_records_columns."""
    from tophat_tpu_torch.io.bam import encode_records_columns

    xsam, xsam_off, xbam, xbam_off = extras
    names = pool.names.tobytes()
    seq_pool = pool.seq.tobytes()
    qual_pool = pool.qual.tobytes()
    n = len(cols)
    lines = []
    names_b, seq_list, qual_list, tag_list = [], [], [], []
    ends = np.zeros(n, np.int64)
    pos2 = np.full(n, -1, np.int64)
    no_qual = np.zeros(n, bool)
    for i, row in enumerate(cols.tolist()):
        (r, s, rl, flag, cid, pos, mapq, nm, nh, xs, mcid, mpos,
         tlen) = row
        name = names[pool.name_off[r]:pool.name_off[r + 1]]
        seq = seq_pool[s:s + rl]
        qual = qual_pool[pool.qual_off[r]:pool.qual_off[r + 1]][:rl] or b"*"
        if flag & samio.FLAG_REVERSE:
            seq = seq.translate(_RC)[::-1]
            qual = qual[::-1]
        ops = cigar[cig_off[i]:cig_off[i + 1]].tolist()
        cig = "".join(f"{v >> 4}{_CIGAR_CHARS[v & 0xF]}" for v in ops
                      if v >> 4 > 0) or "*"
        if mcid < 0:
            rnext = "*"
        elif mcid == cid:
            rnext = "="
            pos2[i] = mpos
        else:
            rnext = ref_names[mcid]
        line = (name + f"\t{flag}\t{ref_names[cid]}\t{pos + 1}\t{mapq}\t"
                f"{cig}\t{rnext}\t{mpos + 1 if mpos >= 0 else 0}\t{tlen}\t"
                .encode() + seq + b"\t" + qual + f"\tNM:i:{nm}".encode())
        tags = b"NMi" + _I4.pack(nm)
        if xs:
            line += b"\tXS:A:" + bytes([xs])
            tags += b"XSA" + bytes([xs])
        line += f"\tNH:i:{nh}".encode()
        tags += b"NHi" + _I4.pack(nh)
        line += xsam[xsam_off[i]:xsam_off[i + 1]].tobytes() + rg_sam
        tags += xbam[xbam_off[i]:xbam_off[i + 1]].tobytes() + rg_bam
        lines.append(line)
        span = sum(v >> 4 for v in ops if v & 0xF in _REF_OPS)
        ends[i] = pos + max(1, span)
        names_b.append(name)
        seq_list.append(seq)
        no_qual[i] = qual == b"*"
        qual_list.append(b"\x00" * len(seq) if no_qual[i] else qual)
        tag_list.append(tags)
    sam = b"".join(ln + b"\n" for ln in lines)
    bam = encode_records_columns(
        names_b, cols[:, COL["flag"]], cols[:, COL["cid"]],
        cols[:, COL["pos"]], ends, cols[:, COL["mapq"]], cigar,
        np.diff(cig_off), seq_list, qual_list, no_qual, tag_list,
        mate_ref=cols[:, COL["mate_cid"]], mate_pos=pos2,
        tlen=cols[:, COL["tlen"]])
    return sam, bam
