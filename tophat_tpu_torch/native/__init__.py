# Copied from tophat_tpu/native/__init__.py; builds into build/native.
"""Native (C++) host components, loaded via ctypes with on-demand compilation.

The C++ sources are this package's own copies (tophat_tpu_torch/native/
*.cpp, each naming the file it was copied from):
  sais.cpp   — linear-time suffix array construction (index build)
  bgzf.cpp   — multithreaded BGZF encode/decode
  bamenc.cpp — columnar BAM record assembly
Build artifacts land in <repo>/build/native (never under tophat_tpu/); a
build failure degrades to the pure-numpy fallbacks rather than erroring.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_ROOT, "build", "native")


def _build_and_load(name: str, extra_flags=()):
    src = os.path.join(_SRC_DIR, f"{name}.cpp")
    so = os.path.join(_BUILD_DIR, f"lib{name}.so")
    if (not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(src)):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        # build to a private name, then rename: concurrent builds (test
        # workers, parallel/shard_fm's build threads) never load a
        # half-written library
        tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = (["g++", "-O2", "-shared", "-fPIC", "-pthread",
                "-std=c++17", src, "-o", tmp] + list(extra_flags))
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so)
    return ctypes.CDLL(so)


def _bytes(codes: np.ndarray) -> np.ndarray:
    """Codes as a contiguous uint8 array: a view of int8 codes (a genome's
    worth of bytes is not copied), else a converted copy."""
    codes = np.ascontiguousarray(codes)
    if codes.dtype in (np.int8, np.uint8):
        return codes.view(np.uint8)
    return codes.astype(np.uint8)


class _Sais:
    def __init__(self):
        self._lib = None

    @property
    def lib(self):
        if self._lib is None:
            self._lib = _build_and_load("sais")
        return self._lib

    @staticmethod
    def _sa_args(sa: np.ndarray):
        """(contiguous SA, ctypes pointer type, symbol suffix) of an SA of
        32- or 64-bit indexes: each width has its own native entry."""
        if sa.dtype == np.int32:
            return (np.ascontiguousarray(sa), ctypes.POINTER(ctypes.c_int32),
                    "32")
        return (np.ascontiguousarray(sa, dtype=np.int64),
                ctypes.POINTER(ctypes.c_int64), "")

    def bwt_from_sa(self, codes: np.ndarray, sa: np.ndarray):
        """Threaded BWT gather; returns (bwt int8[n+1], primary)."""
        import os

        sa, sa_ptr, width = self._sa_args(sa)
        fn = getattr(self.lib, f"sais_bwt_from_sa{width}")
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, sa_ptr,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        codes = _bytes(codes)
        n = codes.shape[0]
        bwt = np.empty(n + 1, np.uint8)
        primary = fn(
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(n), sa.ctypes.data_as(sa_ptr),
            bwt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            min(os.cpu_count() or 1, 8))
        if primary < 0:
            raise RuntimeError("bwt_from_sa: no sentinel row")
        return bwt.view(np.int8), int(primary)

    def kmer_table(self, codes: np.ndarray, sa: np.ndarray, k: int):
        """SA interval [lo, hi) int32[4^k] of every k-mer (0, 0 where it
        is absent), threaded single pass over the SA rows."""
        import os

        sa, sa_ptr, width = self._sa_args(sa)
        fn = getattr(self.lib, f"sais_kmer_table{width}")
        fn.restype = ctypes.c_int
        i32 = ctypes.POINTER(ctypes.c_int32)
        fn.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                       sa_ptr, ctypes.c_int, i32, i32, ctypes.c_int]
        codes = _bytes(codes)
        lo = np.empty(4 ** k, np.int32)
        hi = np.empty(4 ** k, np.int32)
        fn(codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
           ctypes.c_int64(codes.shape[0]), sa.ctypes.data_as(sa_ptr),
           ctypes.c_int(k), lo.ctypes.data_as(i32), hi.ctypes.data_as(i32),
           min(os.cpu_count() or 1, 8))
        return lo, hi

    def suffix_array(self, codes: np.ndarray) -> np.ndarray:
        """SA of codes + implicit sentinel (sa[0] == n), like
        suffix.suffix_array_doubling: int32 while n + 1 + 64 < 2^31 (half
        the bytes of every pass over it), else int64."""
        codes = _bytes(codes)
        n = codes.shape[0]
        if n + 1 + 64 < (1 << 31):
            out = np.empty(n + 1, dtype=np.int32)
            fn, ptr = self.lib.sais_suffix_array32, ctypes.c_int32
        else:
            out = np.empty(n + 1, dtype=np.int64)
            fn, ptr = self.lib.sais_suffix_array, ctypes.c_int64
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                       ctypes.POINTER(ptr)]
        rc = fn(codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.c_int64(n), out.ctypes.data_as(ctypes.POINTER(ptr)))
        if rc != 0:
            raise RuntimeError(f"sais_suffix_array failed ({rc})")
        return out


sais = _Sais()


class _Bgzf:
    """Multithreaded BGZF encode/decode (bgzf.cpp) — the libbam-bgzf +
    pigz role. `available` degrades to the pure-Python writer on any
    build failure."""

    def __init__(self):
        self._lib = None
        self._failed = False

    @property
    def lib(self):
        if self._lib is None and not self._failed:
            try:
                self._lib = _build_and_load("bgzf", extra_flags=["-lz",
                                                                 "-pthread"])
                self._lib.bgzf_write_file.restype = ctypes.c_int
                self._lib.bgzf_write_file.argtypes = [
                    ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
                    ctypes.c_int64, ctypes.c_int, ctypes.c_int]
                self._lib.bgzf_read_file.restype = ctypes.c_int64
                self._lib.bgzf_read_file.argtypes = [
                    ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
                    ctypes.c_int64]
            except Exception:
                self._failed = True
        return self._lib

    @property
    def available(self) -> bool:
        return self.lib is not None

    def write_file(self, path: str, data: bytes, level: int = 6,
                   nthreads: int = 0) -> None:
        if nthreads <= 0:
            nthreads = os.cpu_count() or 1
        buf = np.frombuffer(data, np.uint8)
        rc = self.lib.bgzf_write_file(
            path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(len(data)), level, nthreads)
        if rc != 0:
            raise OSError(f"bgzf_write_file({path!r}) failed ({rc})")

    def read_file(self, path: str) -> bytes:
        cap = max(4 * os.path.getsize(path) + (1 << 16), 1 << 20)
        while True:
            out = np.empty(cap, np.uint8)
            n = self.lib.bgzf_read_file(
                path.encode(),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.c_int64(cap))
            if n == -2:
                cap *= 4
                continue
            if n < 0:
                raise OSError(f"bgzf_read_file({path!r}) failed")
            return out[:n].tobytes()


bgzf = _Bgzf()


class _BamEnc:
    """Columnar BAM record assembler and the record emitter (bamenc.cpp) —
    `available` degrades to the numpy ragged-scatter encoder and the
    Python emitter on any build failure."""

    def __init__(self):
        self._lib = None
        self._failed = False

    @property
    def lib(self):
        if self._lib is None and not self._failed:
            try:
                self._lib = _build_and_load("bamenc")
                u8 = ctypes.POINTER(ctypes.c_uint8)
                i32 = ctypes.POINTER(ctypes.c_int32)
                i64 = ctypes.POINTER(ctypes.c_int64)
                u32 = ctypes.POINTER(ctypes.c_uint32)
                n64 = ctypes.c_int64
                f = self._lib.bam_encode_records
                f.restype = n64
                f.argtypes = [n64, u8, i64, i32, i32, i32, i32, i32, i32,
                              i32, i32, u32, i64, u8, i64, u8, u8, u8, i64,
                              u8, n64]
                f = self._lib.emit_records
                f.restype = n64
                f.argtypes = [n64, i64, u32, i64, u8, i64, u8, u8, i64, u8,
                              i64, u8, i64, u8, i64, u8, n64, u8, n64, u8,
                              n64, i64, u8, n64]
            except Exception:
                self._failed = True
        return self._lib

    @property
    def available(self) -> bool:
        return self.lib is not None

    def encode(self, names_blob, name_off, flag, ref_id, pos, end, mapq,
               ref_id2, pos2, tlen, cig_flat, cig_off, seq_blob, seq_off,
               qual_blob, no_qual, tag_blob, tag_off, out_cap: int) -> bytes:
        out = np.empty(out_cap, np.uint8)
        w = self.lib.bam_encode_records(
            len(flag), *(_ptr(a) for a in (
                names_blob, name_off, flag, ref_id, pos, end, mapq, ref_id2,
                pos2, tlen, cig_flat, cig_off, seq_blob, seq_off, qual_blob,
                no_qual, tag_blob, tag_off, out)), out_cap)
        if w < 0:
            raise OSError("bam_encode_records overflow")
        return out[:w].tobytes()

    def emit(self, cols, cig, cig_off, names, name_off, seq, qual, qual_off,
             refs, ref_off, xsam, xsam_off, xbam, xbam_off, rg_sam: bytes,
             rg_bam: bytes, sam_cap: int, bam_cap: int):
        """(SAM bytes, BAM record bytes) of the record table `cols`
        (io/emit.py)."""
        sam = np.empty(sam_cap, np.uint8)
        bam = np.empty(bam_cap, np.uint8)
        sam_len = np.zeros(1, np.int64)
        rg = [np.frombuffer(x or b"\0", np.uint8) for x in (rg_sam, rg_bam)]
        w = self.lib.emit_records(
            len(cols), *(_ptr(a) for a in (
                cols, cig, cig_off, names, name_off, seq, qual, qual_off,
                refs, ref_off, xsam, xsam_off, xbam, xbam_off, rg[0])),
            len(rg_sam), _ptr(rg[1]), len(rg_bam), _ptr(sam), sam_cap,
            _ptr(sam_len), _ptr(bam), bam_cap)
        if w < 0:
            raise OSError("emit_records overflow")
        return sam[:int(sam_len[0])].tobytes(), bam[:w].tobytes()


def _ptr(a: np.ndarray):
    """A C-contiguous array's data pointer, typed by its dtype."""
    if not a.flags.c_contiguous:
        raise ValueError("native arguments must be C-contiguous")
    return a.ctypes.data_as(ctypes.POINTER(np.ctypeslib.as_ctypes_type(
        a.dtype)))


bamenc = _BamEnc()
