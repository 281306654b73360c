"""Event realignment kernel: best split of every read row across every event.

Replaces the Pallas TPU kernel tophat_tpu/ops/pallas/realign_kernel.py
(_realign_kernel, launched by realign_pallas and fed by prepare_inputs).
The CUDA C++ kernel is tophat_tpu_torch/csrc/realign.cu (its header gives
the design and what bounds it on an H100): int8 tensor-core products for
every row width up to MAX_L = 262,143, with one-hot operands up to 256
positions and one-byte codes expanded in registers above (streamed
through shared memory in K chunks past 1,783 positions). It is compiled
for sm_90a with nvcc into <repo>/build/cuda at first use and called
through ctypes.

For one insertion-length group q, every (row, event) pair gets
  mm(t) = (t - matchL(t)) + ((len - t) - matchC(t)),  1 <= t <= len-1-q
against the left flank ending at the event's left base and the combined
target [inserted seq (q) | right flank]. A position matches iff the codes
are equal and lie in 0..7 — the TPU kernel's 8-channel one-hot rule, under
which a read N matches a genome N (the conv reference realign_chunk, with
4 channels, counts that as a mismatch; the port follows the kernel).

realign_group (dense (R, E) tables) and realign_group_sparse (the records
of the ok pairs only, row-major) take the kernel for CUDA tensors and the
plain torch version (an fp32 one-hot matmul per block of split points,
exact below 2^24) for CPU tensors; there is no other fallback. CUDA inputs past the
kernel's int32 limits (rows wider than MAX_L, where its argmin
accumulator would overflow; R or E of 2^31 or more; a sparse call that
finds 2^31 records or more) raise ValueError naming the limit; the plain
version takes any width.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import torch

from tophat_tpu_torch.utils import trace

BIG = 32767
C = 8                # one-hot channels of the plain version (codes 0..7)
MAX_L = (1 << 18) - 1  # widest row the kernel takes: -2^30 + 4,096 L + 7
#                        stays negative in its int32 argmin accumulator
INT32_LIMIT = 2 ** 31

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "tophat_tpu_torch", "csrc", "realign.cu")
_BUILD_DIR = os.path.join(_ROOT, "build", "cuda")
_LIB = []            # the loaded library, once built


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def build() -> ctypes.CDLL:
    """Compile csrc/realign.cu for sm_90a (if the library is missing or
    older than its source) and load it."""
    if _LIB:
        return _LIB[0]
    so = os.path.join(_BUILD_DIR, "librealign.so")
    if (not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(_SRC)):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-o", tmp, _SRC]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {_SRC}:\n{res.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.realign_launch.argtypes = [p, p, p, p, i, i, i, i, i, p, p, p, p,
                                   p, i, p, p, p]
    lib.realign_launch.restype = i
    lib.realign_scratch_words.argtypes = [i, i, i]
    lib.realign_scratch_words.restype = ctypes.c_longlong
    lib.realign_error_string.argtypes = [i]
    lib.realign_error_string.restype = ctypes.c_char_p
    if lib.realign_max_width() != MAX_L:
        raise RuntimeError(f"{so} takes rows up to "
                           f"{lib.realign_max_width()}, not {MAX_L}")
    _LIB.append(lib)
    return lib


def prepare_targets(genome, ev_left, ev_right, ev_kind, ev_ins_seq,
                    q: int, L: int):
    """int8 (E, L) left flanks and combined right-hand targets.

    The left flank ends at ev_left; the combined target is
    [ins_seq[:q] | right flank], the right flank starting at ev_right
    (junction/deletion) or ev_left + 1 (insertion, kind 2). Positions
    outside the genome read 5 (never match)."""
    n = genome.shape[0]
    dev = genome.device
    five = torch.tensor(5, dtype=torch.int8, device=dev)
    ev_left = ev_left.long()
    li = ev_left[:, None] - (L - 1) + torch.arange(L, device=dev)
    flank_l = torch.where((li >= 0) & (li < n), genome[li.clamp(0, n - 1)],
                          five)
    r_start = torch.where(ev_kind == 2, ev_left + 1, ev_right.long())
    ri = r_start[:, None] + torch.arange(L - q, device=dev)
    flank_r = torch.where((ri >= 0) & (ri < n), genome[ri.clamp(0, n - 1)],
                          five)
    comb = torch.cat([ev_ins_seq[:, :q].to(torch.int8), flank_r], dim=1)
    return flank_l.contiguous(), comb.contiguous()


def realign_plain(reads, lengths, flank_l, comb, q: int, max_mm: int):
    """Plain torch version. match(t) is the one-hot dot product of the
    read with the window [flank_l | comb][L - t : 2L - t] of the event's
    target; the windows of a block of splits are a strided view of the
    target, so one fp32 matmul a block counts them all (0/1 products,
    sums <= L: exact). Then mm = len - match over the interior splits,
    the leftmost minimum below BIG."""
    R, L = reads.shape
    E = flank_l.shape[0]
    dev = reads.device
    ch = torch.arange(C, device=dev)
    onehot = lambda x: (x.long()[..., None] == ch).float()
    X = onehot(reads).reshape(R, L * C)
    T = onehot(torch.cat([flank_l, comb], 1)).reshape(E, 2 * L * C)
    lens = lengths.long()[:, None, None]
    best = torch.full((R, E), BIG, dtype=torch.long, device=dev)
    best_t = torch.zeros((R, E), dtype=torch.long, device=dev)
    # splits a block: the windows' copy and the (R, E, n) match block
    # within 2^25 elements
    n_max = max(1, (1 << 25) // max(1, E * L * C, R * E))
    for t0 in range(1, L, n_max):
        n = min(L - t0, n_max)
        # windows of t0 + n - 1, ..., t0: starts (L - t) C, ascending
        win = T.as_strided((E, n, L * C), (2 * L * C, C, 1),
                           (L - t0 - n + 1) * C)
        match = (X @ win.reshape(E * n, L * C).T).reshape(R, E, n)
        t = torch.arange(t0 + n - 1, t0 - 1, -1, device=dev)
        mm = torch.where(t + q <= lens - 1, lens - match.long(), BIG)
        low = mm.min(dim=2).values
        t_low = torch.where(mm == low[..., None], t, L).min(dim=2).values
        upd = low < best
        best = torch.where(upd, low, best)
        best_t = torch.where(upd, t_low, best_t)
    ok = best <= max_mm
    return best_t.int(), torch.where(ok, best, BIG).int(), ok


def pack_sparse(bt, mm, ok):
    """The ok entries of an (R, E) result as a (4, n) int32 tensor of
    (row, event, best_t, mm) in row-major order: cumsum slots and a masked
    scatter, on the tables' device."""
    R, E = ok.shape
    dev = ok.device
    flat = ok.reshape(-1)
    csum = torch.cumsum(flat.long(), 0)
    n = int(trace.to_host(csum[-1])) if csum.numel() else 0
    slot = (csum - 1)[flat]
    lane = torch.arange(R * E, device=dev)
    out = torch.empty((4, n), dtype=torch.int32, device=dev)
    out[:, slot] = torch.stack([
        (lane // E)[flat].int(), (lane % E)[flat].int(),
        bt.reshape(-1)[flat], mm.reshape(-1)[flat]])
    return out


def _check(reads, lengths, flank_l, comb, q: int, valid=None):
    R, L = reads.shape
    E = flank_l.shape[0]
    args = [("reads", reads, torch.int8, (R, L)),
            ("lengths", lengths, torch.int32, (R,)),
            ("flank_l", flank_l, torch.int8, (E, L)),
            ("comb", comb, torch.int8, (E, L))]
    if valid is not None:
        args.append(("valid", valid, torch.bool, (E,)))
    for name, x, dt, shape in args:
        if x.device != reads.device or x.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor on "
                             f"{reads.device}, got {x.device}")
        if x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected {dt} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    if not 1 <= L <= MAX_L:
        raise ValueError(f"row width {L} outside the realign kernel's "
                         f"1..{MAX_L} (MAX_L: its int32 argmin accumulator)")
    if max(R, E) >= INT32_LIMIT:
        raise ValueError(f"R = {R}, E = {E}: the realign kernel takes R and "
                         "E below 2^31 (int32 sizes)")
    if not 0 <= q < L:
        raise ValueError(f"insertion length {q} outside 0..{L - 1}")


def _launch(reads, lengths, flank_l, comb, q: int, max_mm: int,
            dense=(None, None, None), sparse=(None, None, 0, None)):
    """One kernel launch on the current stream: dense = (best_t, mm, ok)
    tables, or sparse = (valid, records (4, cap), cap, count (1,) int64)."""
    R, L = reads.shape
    E = flank_l.shape[0]
    lib = build()
    scratch = torch.empty(max(1, lib.realign_scratch_words(R, E, L)),
                          dtype=torch.int32, device=reads.device)
    ptr = lambda x: None if x is None else x.data_ptr()
    valid, rec, cap, count = sparse
    args = (reads.data_ptr(), lengths.data_ptr(), flank_l.data_ptr(),
            comb.data_ptr(), R, E, L, q, max_mm, ptr(dense[0]),
            ptr(dense[1]), ptr(dense[2]), ptr(valid), ptr(rec), cap,
            ptr(count), scratch.data_ptr())
    if reads.device.index == torch.cuda.current_device():
        rc = lib.realign_launch(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(reads.device):
            rc = lib.realign_launch(
                *args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("realign kernel launch failed: "
                           + lib.realign_error_string(rc).decode())


def realign_group(reads, lengths, flank_l, comb, q: int, max_mm: int):
    """(best_t, mm, ok), each (R, E), for one insertion-length group.

    reads: (R, L) int8 codes (-1 padded); lengths: (R,) int32 in 0..L;
    flank_l, comb: (E, L) int8 from prepare_targets. CUDA tensors launch
    the kernel on the current stream (any width 1 <= L <= MAX_L, all on
    the int8 tensor cores; a device scratch buffer holds the targets, and
    past 1,783 positions the rows' codes too); CPU tensors take
    realign_plain, at any width."""
    if reads.device.type == "cpu":
        return realign_plain(reads, lengths, flank_l, comb, q, max_mm)
    _check(reads, lengths, flank_l, comb, q)
    R, E = reads.shape[0], flank_l.shape[0]
    dev = reads.device
    best_t = torch.empty((R, E), dtype=torch.int32, device=dev)
    mm = torch.empty((R, E), dtype=torch.int32, device=dev)
    ok = torch.empty((R, E), dtype=torch.bool, device=dev)
    if R == 0 or E == 0:
        return best_t, mm, ok
    _launch(reads, lengths, flank_l, comb, q, max_mm, dense=(best_t, mm, ok))
    trace.count("realign.launches")
    trace.count("realign.dense_launches")
    return best_t, mm, ok


def realign_group_sparse(reads, lengths, flank_l, comb, q: int, max_mm: int,
                         valid):
    """The ok pairs of one insertion-length group whose event is `valid`
    ((E,) bool), as a (4, n) int32 tensor (row, event, best_t, mm),
    row-major: what pack_sparse makes of realign_group's tables, without
    the (R, E) tables. CUDA tensors launch the kernel's sparse epilogue
    (records appended, then sorted on row * E + event; if more records
    than the buffer holds were found, it relaunches with room for all of
    them, and later calls start with that room); CPU tensors take
    realign_plain and pack_sparse."""
    if reads.device.type == "cpu":
        bt, mm, ok = realign_plain(reads, lengths, flank_l, comb, q, max_mm)
        return pack_sparse(bt, mm, ok & valid.to(ok.device)[None, :])
    _check(reads, lengths, flank_l, comb, q, valid)
    R, E = reads.shape[0], flank_l.shape[0]
    dev = reads.device
    if R == 0 or E == 0:
        return torch.empty((4, 0), dtype=torch.int32, device=dev)
    cap = min(R * E, max(4096, 2 * R, realign_group_sparse.cap_hint))
    while True:
        rec = torch.empty((4, cap), dtype=torch.int32, device=dev)
        count = torch.zeros(1, dtype=torch.int64, device=dev)
        _launch(reads, lengths, flank_l, comb, q, max_mm,
                sparse=(valid, rec, cap, count))
        trace.count("realign.launches")
        n = int(trace.to_host(count)[0])
        if n <= cap:
            break
        if n >= INT32_LIMIT:
            raise ValueError(f"the sparse realign entry found {n} records: "
                             "its int32 record table holds fewer than 2^31")
        cap = realign_group_sparse.cap_hint = n
        trace.count("realign.relaunches")
    rec = rec[:, :n]
    # row * E + event is unique to a pair: any sort gives one order
    key = (rec[0] if R * E < 2 ** 31 else rec[0].long()) * E + rec[1]
    return rec[:, torch.sort(key).indices]


realign_group_sparse.cap_hint = 0   # the most records one call has found
