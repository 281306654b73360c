# Copy of tophat_tpu/io/bam.py (host code), imports rewritten; records are
# written columnar only (io/emit.py), with their mate columns.
"""BAM/BGZF reading and writing (pure Python + zlib).

Replaces the role of the vendored samtools-0.1.18 libbam (reference:
src/samtools-0.1.18/bam.h, sam.h, bgzf.h — linked into every stage binary
and also invoked as the `samtools` CLI for sort/merge/view,
src/tophat.py:2753-2812). The pipeline itself keeps alignments in arrays;
BAM exists at the edges, so a host-side codec is sufficient. Readers accept
any BGZF stream (including the reference's gold files); the writer emits
standard BGZF blocks with the canonical EOF marker.
"""

from __future__ import annotations

import struct
import zlib
from typing import BinaryIO, Iterator, List, Optional, Tuple

import numpy as np

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

_SEQ_CODE = "=ACMGRSVTWYHKDBN"
_SEQ_ENC = {c: i for i, c in enumerate(_SEQ_CODE)}
_CIGAR_OPS = "MIDNSHP=X"

# byte -> 4-bit code LUT (unknown bytes -> 15 = N), upper/lowercase
_SEQ_ENC_LUT = np.full(256, 15, np.uint8)
for _i, _c in enumerate(_SEQ_CODE):
    _SEQ_ENC_LUT[ord(_c)] = _i
    _SEQ_ENC_LUT[ord(_c.lower())] = _i


# ---------------------------------------------------------------------------
# BGZF container
# ---------------------------------------------------------------------------

def bgzf_blocks(f: BinaryIO) -> Iterator[bytes]:
    """Yield decompressed BGZF block payloads."""
    while True:
        header = f.read(18)
        if len(header) < 18:
            return
        if header[:4] != b"\x1f\x8b\x08\x04":
            raise ValueError("not a BGZF stream")
        xlen = struct.unpack("<H", header[10:12])[0]
        extra = header[12:18] + f.read(xlen - 6)
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            si1, si2, slen = extra[i], extra[i + 1], struct.unpack(
                "<H", extra[i + 2: i + 4])[0]
            if si1 == 66 and si2 == 67:
                bsize = struct.unpack("<H", extra[i + 4: i + 6])[0]
            i += 4 + slen
        if bsize is None:
            raise ValueError("BGZF block without BC field")
        cdata = f.read(bsize - xlen - 19)
        f.read(8)  # crc32 + isize
        data = zlib.decompress(cdata, -15)
        if data:
            yield data


class BgzfWriter:
    MAX_BLOCK = 65000

    def __init__(self, f: BinaryIO):
        self.f = f
        self.buf = bytearray()

    def write(self, data: bytes) -> None:
        self.buf += data
        while len(self.buf) >= self.MAX_BLOCK:
            self._flush_block(self.buf[: self.MAX_BLOCK])
            del self.buf[: self.MAX_BLOCK]

    def _flush_block(self, data) -> None:
        data = bytes(data)
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        cdata = co.compress(data) + co.flush()
        if len(cdata) + 26 > 65536 and len(data) > 1:
            # incompressible payload expanded past the BGZF 16-bit BSIZE
            # field: split and emit two blocks (samtools caps the
            # compressed size the same way, bgzf.c deflate_block)
            half = len(data) // 2
            self._flush_block(data[:half])
            self._flush_block(data[half:])
            return
        bsize = len(cdata) + 25  # BSIZE = total block size - 1
        header = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
                  + struct.pack("<H", 6)
                  + b"BC" + struct.pack("<H", 2)
                  + struct.pack("<H", bsize))
        self.f.write(header + cdata
                     + struct.pack("<I", zlib.crc32(data))
                     + struct.pack("<I", len(data)))

    def close(self) -> None:
        if self.buf:
            self._flush_block(self.buf)
            self.buf = bytearray()
        self.f.write(BGZF_EOF)


# ---------------------------------------------------------------------------
# BAM records
# ---------------------------------------------------------------------------

class BamRecord:
    __slots__ = ("name", "flag", "ref_id", "pos", "mapq", "cigar", "ref_id2",
                 "pos2", "tlen", "seq", "qual", "tags")

    def __init__(self, name, flag, ref_id, pos, mapq, cigar, ref_id2, pos2,
                 tlen, seq, qual, tags):
        self.name = name
        self.flag = flag
        self.ref_id = ref_id
        self.pos = pos            # 0-based
        self.mapq = mapq
        self.cigar = cigar        # [(op_char, len)]
        self.ref_id2 = ref_id2
        self.pos2 = pos2
        self.tlen = tlen
        self.seq = seq            # ASCII bytes
        self.qual = qual          # phred33 ASCII bytes (b"*" if absent)
        self.tags = tags          # [(tag, type_char, value)]


def _ragged_index(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Flat indices covering [starts[i], starts[i]+lengths[i]) for every i,
    concatenated in order — the gather/scatter pattern for variable-length
    record sections. One cumsum over a delta array (no np.repeat): out is
    +1 within a record and jumps to the next start at each boundary."""
    lengths = np.asarray(lengths, np.int64)
    nz = lengths > 0
    s = np.asarray(starts, np.int64)[nz]
    l = lengths[nz]
    if len(l) == 0:
        return np.zeros(0, np.int64)
    ends = np.cumsum(l)
    out = np.ones(int(ends[-1]), np.int64)
    out[0] = s[0]
    if len(s) > 1:
        out[ends[:-1]] = s[1:] - s[:-1] - l[:-1] + 1
    return np.cumsum(out)


def reg2bin_vec(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """BAI bin of each [beg, end) (SAM spec 5.3; the 16-bit scheme covers
    [0, 2^29): past it htslib stores the pseudo-bin 0, as here)."""
    beg = beg.astype(np.int64)
    end = end.astype(np.int64) - 1
    out = np.zeros(len(beg), np.int64)
    done = (beg >= 1 << 29) | (end >= 1 << 29)  # pseudo-bin 0
    for shift, base in ((14, ((1 << 15) - 1) // 7),
                        (17, ((1 << 12) - 1) // 7),
                        (20, ((1 << 9) - 1) // 7),
                        (23, ((1 << 6) - 1) // 7),
                        (26, ((1 << 3) - 1) // 7)):
        hit = ~done & ((beg >> shift) == (end >> shift))
        out[hit] = base + (beg[hit] >> shift)
        done |= hit
    return out.astype(np.uint16)


_PREFIX_DT = np.dtype([
    ("block_size", "<i4"), ("ref_id", "<i4"), ("pos", "<i4"),
    ("l_rn", "u1"), ("mapq", "u1"), ("bin", "<u2"), ("n_cig", "<u2"),
    ("flag", "<u2"), ("l_seq", "<i4"), ("ref_id2", "<i4"),
    ("pos2", "<i4"), ("tlen", "<i4")])

# ASCII base byte -> BAM 4-bit code (vector form of _SEQ_ENC_LUT)
_ASCII_TO_4BIT = _SEQ_ENC_LUT


def encode_records_columns(names, flag, ref_id, pos, end, mapq,
                           cigar_flat, n_cig, seq_list, qual_list,
                           no_qual, tag_list, mate_ref=None, mate_pos=None,
                           tlen=None) -> bytes:
    """Columnar BAM record encoder: the whole record blob is assembled with
    numpy ragged scatters instead of per-record struct.pack calls —
    replaces a ~50 us/record Python loop with ~1 us/record array work (the
    batched-encode ask of the round-3 review; role of samtools bam_write1,
    reference src/samtools-0.1.18/bam.c).

    names:      list[bytes] query names (no NUL)
    flag/ref_id/pos/mapq:  int arrays (N,)
    end:        pos + reference span (for the BAI bin)
    cigar_flat: uint32 array of packed cigar ops, record-major
    n_cig:      int array (N,) ops per record
    seq_list:   list[bytes] ASCII sequences in stored orientation (b"" for
                none) — 4-bit packing happens here
    qual_list:  list[bytes] phred33 ASCII quals, same lengths as seq_list
                (content ignored where no_qual)
    no_qual:    bool array (N,) — emit 0xFF fill (SAM "*")
    tag_list:   list[bytes] pre-encoded tag blocks
    mate_ref/mate_pos/tlen: int arrays (N,), or None for -1, -1 and 0
    """
    n = len(names)
    if n == 0:
        return b""
    mate_ref = np.full(n, -1) if mate_ref is None else mate_ref
    mate_pos = np.full(n, -1) if mate_pos is None else mate_pos
    tlen = np.zeros(n) if tlen is None else tlen
    names_join = b"\x00".join(names) + b"\x00"
    name_len = np.fromiter((len(b) + 1 for b in names), np.int64, n)
    # the BAM prefix stores l_read_name in a uint8 and n_cigar_op in a
    # uint16 — fail loud instead of silently wrapping the record stream
    if name_len.max(initial=0) > 255:
        bad = names[int(np.argmax(name_len))]
        raise ValueError(f"BAM query name longer than 254 bytes: "
                         f"{bad[:40]!r}... ({len(bad)} bytes)")
    if np.asarray(n_cig, np.int64).max(initial=0) > 65535:
        raise ValueError("BAM record with more than 65535 CIGAR ops")
    tags_join = b"".join(tag_list)
    tag_len = np.fromiter((len(b) for b in tag_list), np.int64, n)
    seq_join = b"".join(seq_list)
    l_seq = np.fromiter((len(b) for b in seq_list), np.int64, n)
    qual_join = b"".join(qual_list)
    n_cig = np.asarray(n_cig, np.int64)

    from tophat_tpu_torch.native import bamenc as native_enc

    if native_enc.available:
        names_cat = b"".join(names)          # no separators: offset-indexed
        zero = np.zeros(1, np.int64)
        name_off = np.concatenate([zero, np.cumsum(name_len - 1)])
        seq_off = np.concatenate([zero, np.cumsum(l_seq)])
        cig_off = np.concatenate([zero, np.cumsum(n_cig)])
        tag_off = np.concatenate([zero, np.cumsum(tag_len)])
        total = int((4 + 32 + name_len + 4 * n_cig + (l_seq + 1) // 2
                     + l_seq + tag_len).sum())
        return native_enc.encode(
            np.frombuffer(names_cat, np.uint8) if names_cat
            else np.zeros(0, np.uint8),
            np.ascontiguousarray(name_off),
            np.ascontiguousarray(np.asarray(flag, np.int32)),
            np.ascontiguousarray(np.asarray(ref_id, np.int32)),
            np.ascontiguousarray(np.asarray(pos, np.int32)),
            np.ascontiguousarray(np.asarray(end, np.int32)),
            np.ascontiguousarray(np.asarray(mapq, np.int32)),
            np.ascontiguousarray(np.asarray(mate_ref, np.int32)),
            np.ascontiguousarray(np.asarray(mate_pos, np.int32)),
            np.ascontiguousarray(np.asarray(tlen, np.int32)),
            np.ascontiguousarray(np.asarray(cigar_flat, np.uint32)),
            np.ascontiguousarray(cig_off),
            np.frombuffer(seq_join, np.uint8) if seq_join
            else np.zeros(0, np.uint8),
            np.ascontiguousarray(seq_off),
            np.frombuffer(qual_join, np.uint8) if qual_join
            else np.zeros(0, np.uint8),
            np.ascontiguousarray(np.asarray(no_qual, np.uint8)),
            np.frombuffer(tags_join, np.uint8) if tags_join
            else np.zeros(0, np.uint8),
            np.ascontiguousarray(tag_off), total)

    seq4_len = (l_seq + 1) // 2
    body_len = 32 + name_len + 4 * n_cig + seq4_len + l_seq + tag_len
    rec_len = 4 + body_len
    off = np.zeros(n + 1, np.int64)
    np.cumsum(rec_len, out=off[1:])
    big = np.zeros(int(off[-1]), np.uint8)

    pre = np.zeros(n, dtype=_PREFIX_DT)
    pre["block_size"] = body_len
    pre["ref_id"] = np.asarray(ref_id, np.int64)
    pre["pos"] = np.asarray(pos, np.int64)
    pre["l_rn"] = name_len
    pre["mapq"] = np.asarray(mapq, np.int64)
    pre["bin"] = reg2bin_vec(np.asarray(pos), np.asarray(end))
    pre["n_cig"] = n_cig
    pre["flag"] = np.asarray(flag, np.int64)
    pre["l_seq"] = l_seq
    pre["ref_id2"] = np.asarray(mate_ref, np.int64)
    pre["pos2"] = np.asarray(mate_pos, np.int64)
    pre["tlen"] = np.asarray(tlen, np.int64)
    big[off[:-1, None] + np.arange(36)] = \
        pre.view(np.uint8).reshape(n, 36)

    cur = off[:-1] + 36
    src = np.frombuffer(names_join, np.uint8)
    big[_ragged_index(cur, name_len)] = src  # names are contiguous in src
    cur = cur + name_len

    if len(cigar_flat):
        cig_u8 = np.asarray(cigar_flat, "<u4").view(np.uint8)
        big[_ragged_index(cur, 4 * n_cig)] = cig_u8
    cur = cur + 4 * n_cig

    # 4-bit packed SEQ: per-record odd lengths pad with 0 — expand each
    # record's codes into a 2*seq4_len staging area, then pack pairs
    if len(seq_join):
        codes = _ASCII_TO_4BIT[np.frombuffer(seq_join, np.uint8)]
        stage = np.zeros(int(seq4_len.sum()) * 2, np.uint8)
        stage[_ragged_index(2 * np.cumsum(seq4_len) - 2 * seq4_len,
                            l_seq)] = codes
        packed = (stage[0::2] << 4) | stage[1::2]
        big[_ragged_index(cur, seq4_len)] = packed
    cur = cur + seq4_len

    if len(qual_join):
        q = np.frombuffer(qual_join, np.uint8) - np.uint8(33)
        big[_ragged_index(cur, l_seq)] = q
        nq = np.asarray(no_qual, bool)
        if nq.any():
            big[_ragged_index(cur[nq], l_seq[nq])] = 0xFF
    cur = cur + l_seq

    if len(tags_join):
        big[_ragged_index(cur, tag_len)] = np.frombuffer(tags_join,
                                                         np.uint8)
    return big.tobytes()


def decode_record(buf: bytes, off: int) -> Tuple[BamRecord, int]:
    (block_size,) = struct.unpack_from("<i", buf, off)
    p = off + 4
    (ref_id, pos, l_rn, mapq, _bin, n_cig, flag, l_seq, ref_id2, pos2,
     tlen) = struct.unpack_from("<iiBBHHHiiii", buf, p)
    p += 32
    name = buf[p: p + l_rn - 1].decode()
    p += l_rn
    cigar = []
    for _ in range(n_cig):
        (v,) = struct.unpack_from("<I", buf, p)
        cigar.append((_CIGAR_OPS[v & 0xF], v >> 4))
        p += 4
    seq = bytearray()
    for i in range(l_seq):
        b = buf[p + i // 2]
        code = (b >> 4) if i % 2 == 0 else (b & 0xF)
        seq.append(ord(_SEQ_CODE[code]))
    p += (l_seq + 1) // 2
    qual_raw = buf[p: p + l_seq]
    qual = (b"*" if (l_seq == 0 or all(q == 0xFF for q in qual_raw))
            else bytes(q + 33 for q in qual_raw))
    p += l_seq
    tags = []
    tag_end = off + 4 + block_size
    while p < tag_end:
        tag = buf[p: p + 2].decode()
        typ = chr(buf[p + 2])
        p += 3
        if typ in "cC":
            val = struct.unpack_from("<b" if typ == "c" else "<B", buf, p)[0]
            p += 1
            typ = "i"
        elif typ in "sS":
            val = struct.unpack_from("<h" if typ == "s" else "<H", buf, p)[0]
            p += 2
            typ = "i"
        elif typ in "iI":
            val = struct.unpack_from("<i" if typ == "i" else "<I", buf, p)[0]
            p += 4
            typ = "i"
        elif typ == "A":
            val = chr(buf[p])
            p += 1
        elif typ == "f":
            (val,) = struct.unpack_from("<f", buf, p)
            p += 4
        elif typ == "Z":
            z = buf.index(b"\x00", p)
            val = buf[p:z].decode()
            p = z + 1
        elif typ == "B":
            sub = chr(buf[p])
            (cnt,) = struct.unpack_from("<I", buf, p + 1)
            size = dict(c=1, C=1, s=2, S=2, i=4, I=4, f=4)[sub]
            val = buf[p: p + 5 + cnt * size]
            p += 5 + cnt * size
        else:
            raise ValueError(f"unknown tag type {typ}")
        tags.append((tag, typ, val))
    return BamRecord(name, flag, ref_id, pos, mapq, cigar, ref_id2, pos2,
                     tlen, bytes(seq) if l_seq else b"*", qual, tags), tag_end


class BamWriter:
    """BAM writer: records buffer in memory; compression happens at
    close() via the native multithreaded BGZF encoder (native/bgzf.cpp —
    the vendored-libbam + pigz role) with a pure-Python fallback."""

    def __init__(self, path: str, header_text: str, ref_names: List[str],
                 ref_lengths: List[int]):
        self.path = path
        self.buf = bytearray()
        text = header_text.encode()
        hdr = b"BAM\x01" + struct.pack("<i", len(text)) + text
        hdr += struct.pack("<i", len(ref_names))
        for name, ln in zip(ref_names, ref_lengths):
            nb = name.encode() + b"\x00"
            hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", int(ln))
        self.buf += hdr

    def write_encoded(self, blob: bytes) -> None:
        """Append pre-encoded record bytes (encode_records_columns)."""
        self.buf += blob

    def close(self) -> None:
        from tophat_tpu_torch.native import bgzf as native_bgzf

        if native_bgzf.available:
            native_bgzf.write_file(self.path, bytes(self.buf))
        else:
            with open(self.path, "wb") as f:
                w = BgzfWriter(f)
                w.write(bytes(self.buf))
                w.close()
        self.buf = bytearray()


def read_bam(path: str):
    """Returns (header_text, ref_names, ref_lengths, records)."""
    from tophat_tpu_torch.native import bgzf as native_bgzf

    if native_bgzf.available:
        data = native_bgzf.read_file(path)
    else:
        with open(path, "rb") as f:
            data = b"".join(bgzf_blocks(f))
    if data[:4] != b"BAM\x01":
        raise ValueError("not a BAM file")
    (l_text,) = struct.unpack_from("<i", data, 4)
    text = data[8: 8 + l_text].decode()
    p = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, p)
    p += 4
    names, lengths = [], []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, p)
        p += 4
        names.append(data[p: p + l_name - 1].decode())
        p += l_name
        (ln,) = struct.unpack_from("<i", data, p)
        p += 4
        lengths.append(ln)
    records = []
    while p < len(data):
        rec, p = decode_record(data, p)
        records.append(rec)
    return text, names, lengths, records
