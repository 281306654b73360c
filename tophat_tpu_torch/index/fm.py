"""FM-index: build on the host (numpy), search on the device (torch).

Port of tophat_tpu/index/fm.py. The host build (SA-IS, BWT, Occ
checkpoints, k-mer seed table, sampled SA) is the same numpy code; the
index itself is a dataclass of torch tensors instead of a JAX pytree:

  packed_bwt : int64[ceil((n+1)/16)]    BWT(T$), 2-bit codes, 16 per word
  occ_ck     : int32[nblocks+1, 4]      Occ checkpoints every OCC_BLOCK bases
  C          : int32[5]                 C[c] = 1 + #{symbols < c in T}
  sa         : int32[n+1]               full suffix array (or empty, sampled)
  genome     : int8[n]                  original codes incl. N=4
  primary    : int                      row of the sentinel in the BWT

Packed uint32 words are carried as int64 tensors holding values in
[0, 2^32): torch implements no shifts on uint32, and int64 keeps every
shift/XOR/popcount step exact. `save` writes them back as uint32, so the
.npz files are interchangeable with the JAX package's.

`genome_host` keeps a numpy copy of the genome codes so host stages
(chains, report) never pull a device tensor back.
"""

from __future__ import annotations

import dataclasses
import types
import zipfile
from typing import Any

import numpy as np
import torch

from tophat_tpu_torch.index.fasta import Genome
from tophat_tpu_torch.index.suffix import bwt_from_sa, suffix_array
from tophat_tpu_torch.utils.device import resolve_device

OCC_BLOCK = 128  # bases per Occ checkpoint block
WORDS_PER_BLOCK = OCC_BLOCK // 16


# what a stale or corrupt saved index raises on FMIndex.load; anything else
# (a CUDA error while the tables upload, a bad device) propagates
STALE_INDEX = (OSError, ValueError, KeyError, zipfile.BadZipFile)

_PACK_CHUNK = 1 << 24  # bases per packing/counting chunk (blocked builds:
#                        scratch stays O(chunk), not O(genome))

# table fields and their on-disk numpy dtypes (the JAX package's layout)
TABLES = {
    "packed_bwt": np.uint32, "occ_ck": np.int32, "C": np.int32,
    "sa": np.int32, "genome": np.int8, "packed_genome": np.uint32,
    "n_mask": np.uint32, "occ_mid": np.uint8, "kmer_lo": np.int32,
    "kmer_hi": np.int32, "sa_marks": np.uint32, "sa_mark_ck": np.int32,
    "sa_mark_mid": np.uint8, "sa_samples": np.int32,
}


def _to_tensor(a, np_dtype, device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a).astype(np_dtype, copy=False))
    if np_dtype == np.uint32:   # no torch shifts on uint32: widen
        a = a.astype(np.int64)
    return torch.from_numpy(a).to(device)


def _words(packed: np.ndarray, nwords: int) -> np.ndarray:
    """Little-endian bytes (zero-padded to whole words) -> uint32 words."""
    out = np.zeros(nwords * 4, np.uint8)
    out[:packed.shape[0]] = packed
    return out.view("<u4").astype(np.uint32, copy=False)


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack int8 2-bit codes (values 0..3) into uint32 words, 16 per word,
    code i at bits [2*(i%16), 2*(i%16)+1]: four codes a byte, the bytes
    read as little-endian words. Blocked: scratch is one chunk's."""
    n = codes.shape[0]
    nbytes = (n + 3) // 4
    out = np.zeros(nbytes, np.uint8)
    for s in range(0, n, _PACK_CHUNK):   # a multiple of 4
        c = np.asarray(codes[s:s + _PACK_CHUNK]).astype(np.uint8)
        if c.shape[0] % 4:
            c = np.concatenate([c, np.zeros(4 - c.shape[0] % 4, np.uint8)])
        q = c.reshape(-1, 4)
        out[s // 4:s // 4 + q.shape[0]] = (q[:, 0] | (q[:, 1] << 2)
                                           | (q[:, 2] << 4) | (q[:, 3] << 6))
    return _words(out, (n + 15) // 16)


@dataclasses.dataclass
class FMIndex:
    packed_bwt: Any     # int64 tensor, uint32 word values
    occ_ck: Any         # int32 [nblocks+1, 4]
    C: Any              # int32 [5]
    sa: Any             # int32 [n+1] (empty when sampled)
    genome: Any         # int8 [n]
    packed_genome: Any  # int64, uint32 word values (+ 8-shifted copy)
    n_mask: Any         # int64, uint32 word values
    occ_mid: Any        # uint8 [ceil((n+1)/32), 4] or [0, 4]
    kmer_lo: Any        # int32 [4^k] or [0]
    kmer_hi: Any        # int32 [4^k] or [0]
    sa_marks: Any       # int64, uint32 word values, or [0]
    sa_mark_ck: Any     # int32 [nblocks+1] or [0]
    sa_mark_mid: Any    # uint8 or [0]
    sa_samples: Any     # int32 [#marked] or [0]
    primary: int
    n: int
    kmer_k: int = 0
    sa_rate: int = 0
    has_n: bool = True
    pg_dual: bool = False
    genome_host: Any = None  # numpy int8 [n]

    @property
    def device(self) -> torch.device:
        return self.genome.device

    @property
    def nbytes(self) -> int:
        """Bytes of all table tensors — the per-device cost of replicating
        this index (drives the range-sharding decision in
        parallel/auto.configure_genome_axis)."""
        return sum(getattr(self, k).numel() * getattr(self, k).element_size()
                   for k in TABLES)

    def to(self, device) -> "FMIndex":
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device) for k in TABLES})

    @staticmethod
    def from_numpy(fm_np, device="cuda") -> "FMIndex":
        """Tensors on `device` from any index-like object whose table
        fields are numpy arrays (this module's host build, an .npz, or a
        tophat_tpu FMIndex) — the carrying-across of the index tables.
        A CUDA device without CUDA raises."""
        device = resolve_device(device)
        tabs = {k: _to_tensor(getattr(fm_np, k), dt, device)
                for k, dt in TABLES.items()}
        return FMIndex(
            **tabs, primary=int(np.asarray(fm_np.primary)),
            n=int(fm_np.n), kmer_k=int(getattr(fm_np, "kmer_k", 0)),
            sa_rate=int(getattr(fm_np, "sa_rate", 0)),
            has_n=bool(getattr(fm_np, "has_n", True)),
            pg_dual=bool(getattr(fm_np, "pg_dual", False)),
            genome_host=np.asarray(fm_np.genome).astype(np.int8))

    def save(self, path: str) -> None:
        # copy=False: a host index's tables go out as they are (a 2^30-base
        # index's 4 GiB SA is not copied); uint32 words narrow from int64
        tables = {k: getattr(self, k).cpu().numpy().astype(dt, copy=False)
                  for k, dt in TABLES.items()}
        np.savez(path, **tables, primary=np.int32(self.primary), n=self.n,
                 kmer_k=self.kmer_k, sa_rate=self.sa_rate, has_n=self.has_n,
                 pg_dual=self.pg_dual)

    @staticmethod
    def load(path: str, device="cuda") -> "FMIndex":
        device = resolve_device(device)
        z = np.load(path)
        get = lambda k, d: z[k] if k in z.files else d
        fields = dict(
            packed_bwt=z["packed_bwt"], occ_ck=z["occ_ck"],
            occ_mid=get("occ_mid", np.zeros((0, 4), np.uint8)), C=z["C"],
            sa=z["sa"], genome=z["genome"], primary=z["primary"][()],
            packed_genome=z["packed_genome"], n_mask=z["n_mask"],
            kmer_lo=z["kmer_lo"], kmer_hi=z["kmer_hi"],
            sa_marks=get("sa_marks", np.zeros(0, np.uint32)),
            sa_mark_ck=get("sa_mark_ck", np.zeros(0, np.int32)),
            sa_mark_mid=get("sa_mark_mid", np.zeros(0, np.uint8)),
            sa_samples=get("sa_samples", np.zeros(0, np.int32)),
            n=int(z["n"][()]), kmer_k=int(z["kmer_k"][()]),
            sa_rate=int(z["sa_rate"][()]) if "sa_rate" in z.files else 0,
            has_n=bool(z["has_n"][()]) if "has_n" in z.files
            else bool(np.any(z["n_mask"])),
            pg_dual=bool(z["pg_dual"][()]) if "pg_dual" in z.files
            else False)
        return FMIndex.from_numpy(types.SimpleNamespace(**fields), device)


def pack_1bit(bits: np.ndarray) -> np.ndarray:
    """Pack a boolean array into uint32 words, bit i%32 of word i//32."""
    return _words(np.packbits(np.asarray(bits, bool), bitorder="little"),
                  (bits.shape[0] + 31) // 32)


def _sub_block_counts(arr: np.ndarray, nblocks: int, sub: int,
                      classes: int):
    """Per-`sub`-base-window class counts of an int8 array, blocked.

    Returns (nblocks * (OCC_BLOCK // sub), classes) uint8 counts —
    the shared scratch-free core of the Occ / SA-mark checkpoint builds.
    """
    m = arr.shape[0]
    per = OCC_BLOCK // sub
    out = np.zeros((nblocks * per, classes), np.uint8)
    step = _PACK_CHUNK  # multiple of OCC_BLOCK
    for s in range(0, max(m, 1), step):
        e = min(s + step, m)
        r0, r1 = s // sub, (e + sub - 1) // sub
        seg = np.full((r1 - r0) * sub, classes, arr.dtype)  # pad value is
        seg[: e - s] = arr[s:e]                             # outside [0, C)
        seg2 = seg.reshape(-1, sub)
        for c in range(classes):
            out[r0:r1, c] = (seg2 == c).sum(axis=1).astype(np.uint8)
    return out


def _build_kmer_table(text: np.ndarray, sa: np.ndarray, k: int):
    """SA interval [lo, hi) of every k-mer, exploiting that fixed-length
    prefixes appear in sorted, contiguous runs along the suffix array."""
    n = text.shape[0]
    if n < k:
        z = np.zeros(4 ** k, np.int32)
        return z, z.copy()
    try:
        from tophat_tpu_torch.native import sais

        return sais.kmer_table(text, sa, k)   # threaded single pass
    except Exception:
        v = np.zeros(n - k + 1, dtype=np.int64)
        for j in range(k):
            v = v * 4 + text[j: n - k + 1 + j]
        rows = np.nonzero(sa <= n - k)[0]
        vals_sorted = v[sa[rows]]      # non-decreasing along SA order
    cnt = np.bincount(vals_sorted, minlength=4 ** k).astype(np.int32)
    first = np.concatenate([[0], np.cumsum(cnt[:-1])])
    lo = np.where(cnt > 0,
                  rows[np.minimum(first, len(rows) - 1)], 0).astype(np.int32)
    return lo, lo + cnt


def _occ_tables(bwt: np.ndarray, m: int):
    """Occ checkpoints + 32-base mid-checkpoints for a BWT (blocked
    scratch). Returns (occ_ck int32[nblocks+1, 4], occ_mid uint8)."""
    nblocks = (m + OCC_BLOCK - 1) // OCC_BLOCK
    per_sub = _sub_block_counts(bwt, nblocks, 32, 4)
    per_sub = per_sub.reshape(nblocks, OCC_BLOCK // 32, 4)
    per_block = per_sub.sum(axis=1, dtype=np.int64)
    occ_ck = np.zeros((nblocks + 1, 4), dtype=np.int32)
    occ_ck[1:] = np.cumsum(per_block, axis=0).astype(np.int32)
    occ_mid = np.zeros_like(per_sub)
    occ_mid[:, 1:] = np.cumsum(per_sub, axis=1, dtype=np.int64)[
        :, :-1].astype(np.uint8)
    occ_mid = np.concatenate([occ_mid.reshape(-1, 4),
                              np.zeros((4, 4), np.uint8)]).astype(np.uint8)
    return occ_ck, occ_mid


def host_codes(fm) -> np.ndarray:
    """Host numpy genome codes of an index, without a device transfer."""
    gh = getattr(fm, "genome_host", None)
    if gh is not None:
        return gh
    g = fm.genome
    return g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)


def default_kmer_k(n: int) -> int:
    """Seed-table k for an in-process index build (0 below the beam
    threshold — tiny genomes search fine without a table)."""
    if n < (1 << 21):
        return 0
    return int(np.clip(int(np.log(max(n, 4)) / np.log(4)) - 1, 8, 14))


def build_fm_index(genome: Genome | np.ndarray,
                   kmer_k: int = 0, sa_rate: int = 0,
                   sa: np.ndarray | None = None,
                   device="cuda") -> FMIndex:
    """Build the FM-index of a genome's forward strand on the host and
    place its tables on `device`.

    Reverse-strand alignment searches the reverse complement of the read
    against this same index. kmer_k > 0 additionally builds the k-mer
    SA-interval seed table; sa_rate > 0 stores a text-order-sampled SA.
    sa: precomputed suffix array of text (N->A) with sentinel. A CUDA
    device without CUDA raises before anything is built."""
    device = resolve_device(device)
    codes = genome.codes if isinstance(genome, Genome) else np.asarray(genome)
    codes = codes.astype(np.int8)
    text = np.where(codes == 4, 0, codes).astype(np.int8, copy=False)  # N->A
    n = text.shape[0]

    if sa is None:
        sa = suffix_array(text)
    else:
        sa = np.asarray(sa)
        if sa.shape[0] != n + 1:
            raise ValueError("precomputed SA length mismatch")
    bwt, primary = bwt_from_sa(text, sa)
    m = n + 1

    occ_ck, occ_mid = _occ_tables(bwt, m)

    # C[c] = 1 (sentinel) + #symbols < c in the text
    counts = np.bincount(text, minlength=4)[:4]
    C = np.zeros(5, dtype=np.int32)
    C[1:] = np.cumsum(counts)
    C += 1
    C[0] = 1

    if kmer_k:
        kmer_lo, kmer_hi = _build_kmer_table(text, sa, kmer_k)
    else:
        kmer_lo = kmer_hi = np.zeros(0, np.int32)

    if sa_rate:
        marked = np.empty(m, bool)   # blocked: no O(n) remainder temporary
        for s in range(0, m, _PACK_CHUNK):
            np.equal(sa[s:s + _PACK_CHUNK] % sa_rate, 0,
                     out=marked[s:s + _PACK_CHUNK])
        sa_marks = pack_1bit(marked)
        nb = (m + 127) // 128
        # per-32-row marked counts, blocked (class 1 of the int8 view)
        per_sub = _sub_block_counts(marked.view(np.int8), nb, 32,
                                    2)[:, 1].reshape(nb, 4)
        csum = np.cumsum(per_sub.sum(axis=1, dtype=np.int64))
        sa_mark_ck = np.concatenate([[0], csum]).astype(np.int32)
        # per-32-row mid counts (exclusive prefix within block, +4 pad rows)
        mid = np.zeros_like(per_sub)
        mid[:, 1:] = np.cumsum(per_sub, axis=1, dtype=np.int64)[
            :, :-1].astype(np.uint8)
        sa_mark_mid = np.concatenate(
            [mid.reshape(-1), np.zeros(4, np.uint8)]).astype(np.uint8)
        sa_samples = sa[marked].astype(np.int32, copy=False)
        sa_store = np.zeros(0, np.int32)
        del marked
    else:
        sa_marks = np.zeros(0, np.uint32)
        sa_mark_ck = np.zeros(0, np.int32)
        sa_mark_mid = np.zeros(0, np.uint8)
        sa_samples = np.zeros(0, np.int32)
        sa_store = sa.astype(np.int32, copy=False)

    del sa          # the build's largest array, freed before the packing
    packed_bwt = pack_2bit(bwt)
    del bwt
    tables = types.SimpleNamespace(
        packed_bwt=packed_bwt, occ_ck=occ_ck, occ_mid=occ_mid, C=C,
        sa=sa_store, genome=codes, primary=int(primary),
        packed_genome=np.concatenate([pack_2bit(text), pack_2bit(text[8:])]),
        pg_dual=True, n_mask=pack_1bit(codes == 4),
        kmer_lo=kmer_lo, kmer_hi=kmer_hi,
        sa_marks=sa_marks, sa_mark_ck=sa_mark_ck, sa_mark_mid=sa_mark_mid,
        sa_samples=sa_samples, has_n=bool((codes == 4).any()),
        n=n, kmer_k=kmer_k, sa_rate=sa_rate)
    return FMIndex.from_numpy(tables, device)
