#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tophat_tpu_torch) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. the card's name and power limit (nvidia-smi); no CUDA -> exit 1
  2. build every kernel of the spliced main path from csrc/ (nvcc, sm_90a)
  3. each kernel against its plain torch version on the card, at the main
     path's shapes and wider, through the realign kernel's dense and sparse
     entries, demanding exact equality; kernel, sparse-entry and plain
     times, the bound and share of bound, and at L = 100 the conv1d
     yardstick (phases 4 and 6 repeat the check on the exact inputs the
     main path gave the kernel)
  4. the spliced main path through the CLI entry point
     (python -m tophat_tpu_torch.cli.main --no-coverage-search --tt-index)
     on a synthetic 2^27-base genome and 32,768 100-bp reads (25%
     junction-spanning): a warm run, then one timed steady run; fails if
     junction-read recall is under 100% or the sparse realign entry was
     not launched by that run; then the same pipeline on a small input on the
     card and on the CPU (plain versions), which must write identical files
  5. unspliced align_reads_adaptive on 16,384 x 100-bp batches
  6. TopHat's default invocation, paired-end with the coverage search on,
     through the CLI (--tt-index, no --no-coverage-search) on the phase-4
     genome and index, 32,768 pairs of 2 x 100 bp (mate 1 crosses an
     intron in 25% of pairs): a run holding every realign call against
     its plain version, then a timed run with stage seconds; fails if
     mate-1 junction-read recall is under 100% or that run launched no
     sparse realign kernel
  7. on a 2^21 + 4096-base slice: the paired default mode and a single-end
     run with the butterfly and microexon searches, on the card and on the
     CPU, which must write identical files
Launches in the kernels line are summed over phases 4 and 6 (each counted
from 0 just before its timed run), max_abs_err over every check.
Standard output ends with four lines: the measured numbers (JSON), the
kernels (JSON), the nvidia-smi name/power line, and the result JSON.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(REPO, ".smoke_cache")
GENOME_N = 1 << 27          # Drosophila-scale genome
READ_LEN = 100
N_READS = 32768
BATCH = 16384
UNSPLICED_ITERS = 8
N_PAIRS = 32768             # phase 6: two chunk pairs at --batch-size 16384
SMALL_PAIRS = 2048


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of fn() over `iters` runs (after one warm
    run), by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


# ---------------------------------------------------------------- phase 3

def realign_case(R: int, E: int, L: int, q: int, seed: int):
    """Inputs of one realign q-group at the main path's shapes: reads
    planted across events (some with a mismatch or an N), random rows,
    zero-length rows, N runs in the genome, events at both genome ends."""
    import torch

    from tophat_tpu_torch.ops.realign_kernel import prepare_targets

    rng = np.random.default_rng(seed)
    n = 1 << 20
    genome = rng.integers(0, 4, n).astype(np.int8)
    for s in rng.integers(0, n - 64, 64):
        genome[s: s + int(rng.integers(1, 40))] = 4
    lefts = rng.integers(L, n - 2 * L, E)
    lefts[:4] = [0, 3, n - 2, n - 1]                     # genome ends
    if q:
        kinds = np.full(E, 2, np.int8)
        rights = lefts + 1
    else:
        kinds = np.where(rng.random(E) < 0.8, 0, 1).astype(np.int8)
        rights = lefts + rng.integers(2, 5000, E)
        rights[4] = n + 7                                # past the end
    ins_seq = np.full((E, 8), -1, np.int8)
    ins_seq[:, :q] = rng.integers(0, 5, (E, q))
    reads = np.full((R, L), -1, np.int8)
    lengths = np.full(R, L, np.int32)
    for i in range(R):
        e = int(rng.integers(0, E))
        lf, rt = int(lefts[e]), int(rights[e])
        t = int(rng.integers(1, max(2, L - 1 - q)))
        if i % 16 == 0:
            lengths[i] = 0                               # padding rows
            continue
        if i % 16 == 1 or lf - t + 1 < 0 or rt + L > n:
            reads[i] = rng.integers(0, 5, L)
            continue
        start = lf + 1 if q else rt
        read = np.concatenate([genome[lf - t + 1: lf + 1], ins_seq[e, :q],
                               genome[start: start + L - t - q]])
        if i % 3 == 0:
            p = int(rng.integers(0, L))
            read[p] = (read[p] + 1) % 5
        if i % 16 == 2:
            lengths[i] = int(rng.integers(q + 1, L))
            read[lengths[i]:] = -1
        reads[i] = read
    dev = torch.device("cuda")
    g = torch.as_tensor(genome, device=dev)
    t = lambda a: torch.as_tensor(a, device=dev)
    flank_l, comb = prepare_targets(g, t(lefts), t(rights), t(kinds),
                                    t(ins_seq), q, L)
    return t(reads).contiguous(), t(lengths), flank_l, comb


INT8_OPS_PER_S = 1.979e15   # H100 SXM dense int8 tensor-core peak
BYTES_PER_S = 3.35e12       # H100 SXM HBM3


def realign_bound(lengths, R: int, E: int, L: int, q: int):
    """(ms, what bounds it): the least time for one dense realign call on
    these inputs. Operations: a split is a K = 8 L one-hot dot product per
    (row, event), 2 ops a byte, over the splits these rows need (1..
    min(L - 1, len - 1 - q)), at the int8 tensor-core peak. Bytes: reads,
    lengths, both targets read once; best_t, mm (int32) and ok written
    once."""
    import torch

    splits = int(torch.clamp(torch.clamp(lengths.long() - 1 - q, max=L - 1),
                             min=0).sum())
    ops = 2.0 * E * 8 * L * splits
    nbytes = R * L + 4 * R + 2 * E * L + 9 * R * E
    t_ops, t_bytes = ops / INT8_OPS_PER_S, nbytes / BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def conv_yardstick(reads, lengths, flank_l, comb, q: int, max_mm: int):
    """The library yardstick (the port never calls it): one fp16
    torch.nn.functional.conv1d of the one-hot targets (E, 8, 2L) with the
    one-hot reads (R, 8, L) as weights gives the match volume (E, R,
    L + 1), window j = L - t; then the masked, leftmost argmin over the
    splits. Returns (best_t, mm, ok) like realign_group."""
    import torch
    import torch.nn.functional as F

    from tophat_tpu_torch.ops.realign_kernel import BIG

    R, L = reads.shape
    ch = torch.arange(8, dtype=torch.int8, device=reads.device)
    tgt = torch.cat([flank_l, comb], 1)
    x = (tgt[:, None, :] == ch[None, :, None]).half()
    w = (reads[:, None, :] == ch[None, :, None]).half()
    match = F.conv1d(x, w).flip(-1)[:, :, 1:L]       # [e, r, t - 1]
    t = torch.arange(1, L, device=reads.device)
    mm = lengths.half()[None, :, None] - match
    split_ok = t[None, None, :] <= (lengths.long() - 1 - q)[None, :, None]
    best, idx = mm.masked_fill(~split_ok, 4096.0).min(-1)
    none = best >= 4096
    best = torch.where(none, BIG, best.int())
    ok = best <= max_mm
    return (torch.where(none, 0, idx + 1).int().T.contiguous(),
            torch.where(ok, best, BIG).int().T.contiguous(), ok.T.contiguous())


def max_err(got, ref) -> int:
    return max((int((a.long() - b.long()).abs().max()) if a.numel() else 0)
               for a, b in zip(got, ref))


def phase_kernels():
    import torch

    from tophat_tpu_torch.ops.realign_kernel import (pack_sparse,
                                                     realign_group,
                                                     realign_group_sparse,
                                                     realign_plain)

    # the main path's widths, then wider rows (150-bp reads on the fast
    # path; 300 and 1,000 positions on the wide path, which has no cap),
    # the main path's own shape and an event table of a real
    # transcriptome's size
    cases = [(16384, 128, 100, 0), (16384, 128, 100, 3), (16384, 128, 25, 0),
             (8192, 128, 150, 0), (8192, 128, 300, 3), (8192, 128, 1000, 0),
             (8192, 69, 100, 0), (8192, 4096, 100, 0)]
    report = []
    for ci, (R, E, L, q) in enumerate(cases):
        shape = f"R={R} E={E} L={L} q={q}"
        args = realign_case(R, E, L, q, seed=11 + ci)
        valid = torch.as_tensor(
            np.random.default_rng(ci).random(E) < 0.9, device="cuda")
        got = realign_group(*args, q, 8)
        ref = realign_plain(*args, q, 8)
        got_s = realign_group_sparse(*args, q, 8, valid)
        ref_s = pack_sparse(ref[0], ref[1], ref[2] & valid[None, :])
        torch.cuda.synchronize()
        err = max_err(got, ref)
        n_ok = int(ref[2].sum())
        if err or not all(torch.equal(a, b) for a, b in zip(got, ref)):
            fail(f"realign kernel disagrees with its plain version at "
                 f"{shape} (max abs err {err})")
        if not torch.equal(got_s, ref_s):
            fail(f"sparse realign entry disagrees with the packed plain "
                 f"result at {shape} ({got_s.shape[1]} vs {ref_s.shape[1]} "
                 "records)")
        if n_ok < R // 4:
            fail(f"realign case {shape}: only {n_ok} ok pairs; the check "
                 "input is degenerate")
        iters = 20 if L <= 300 else 3
        ms = cuda_ms(lambda: realign_group(*args, q, 8), iters)
        sparse_ms = cuda_ms(lambda: realign_group_sparse(*args, q, 8, valid),
                            iters)
        plain_ms = cuda_ms(lambda: realign_plain(*args, q, 8),
                           2 if E > 1000 else 3)
        bound_ms, bound_by = realign_bound(args[1], R, E, L, q)
        row = dict(R=R, E=E, L=L, q=q, max_abs_err=err, ms=ms,
                   sparse_ms=sparse_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, share_of_bound=bound_ms / ms,
                   library_ms=None, library_exact=None)
        if L == 100:
            lib = conv_yardstick(*args, q, 8)
            row["library_exact"] = all(torch.equal(a, b)
                                       for a, b in zip(lib, ref))
            del lib
            row["library_ms"] = cuda_ms(lambda: conv_yardstick(*args, q, 8),
                                        2 if E > 1000 else 5)
            torch.cuda.empty_cache()
        log(f"realign {shape}: exact, dense and sparse ({n_ok} ok pairs); "
            f"kernel {ms:.4f} ms (sparse entry {sparse_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"share of bound {100 * bound_ms / ms:.1f}%"
            + ("" if row["library_ms"] is None else
               f"; conv1d yardstick {row['library_ms']:.4f} ms ("
               + ("exact" if row["library_exact"] else "NOT exact") + ")"))
        report.append(row)
    return report


def realign_launches(reset: bool = False):
    """(dense, sparse) launch counts of the realign kernel's two entries;
    reset=True sets both to 0 first."""
    from tophat_tpu_torch.ops.realign_kernel import (realign_group,
                                                     realign_group_sparse)

    if reset:
        realign_group.launches = realign_group_sparse.launches = 0
    return realign_group.launches, realign_group_sparse.launches


class RealignHooks:
    """Within the block, every call the pipeline makes to the realign
    kernel's entries (ops/events' realign_group_sparse for candidates,
    realign_group for chains) also goes to on_call(kind, args, out)."""

    def __init__(self, events, on_call):
        self.events, self.on_call = events, on_call
        self.saved = (events.realign_group, events.realign_group_sparse)

    def __enter__(self):
        dense, sparse = self.saved

        def hook(kind, fn):
            def call(*args):
                out = fn(*args)
                self.on_call(kind, args, out)
                return out
            return call

        self.events.realign_group = hook("dense", dense)
        self.events.realign_group_sparse = hook("sparse", sparse)

    def __exit__(self, *exc):
        self.events.realign_group, self.events.realign_group_sparse = \
            self.saved


def hold_realign(kind, args, got):
    """Hold one realign call of the main path against realign_plain:
    a dense call's tables directly; a sparse call's records against
    pack_sparse of the plain tables, and the dense entry on the same
    inputs too. Returns (max abs error of the dense tables, shape)."""
    import torch

    from tophat_tpu_torch.ops.realign_kernel import (pack_sparse,
                                                     realign_group,
                                                     realign_plain)

    plain_args = args[:6]
    ref = realign_plain(*plain_args)
    dense = got if kind == "dense" else realign_group(*plain_args)
    err = max_err(dense, ref)
    shape = (f"R={args[0].shape[0]} E={args[2].shape[0]} "
             f"L={args[0].shape[1]} q={args[4]}")
    if err or not all(torch.equal(a, b) for a, b in zip(dense, ref)):
        fail(f"realign kernel disagrees with its plain version on the main "
             f"path's inputs {shape} (max abs err {err})")
    if kind == "sparse":
        ref_s = pack_sparse(ref[0], ref[1], ref[2] & args[6][None, :])
        if not torch.equal(got, ref_s):
            fail(f"sparse realign entry disagrees with the packed plain "
                 f"result on the main path's inputs {shape}")
    return err, shape


# ---------------------------------------------------------------- phase 4

def make_genome(seed: int = 7):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, GENOME_N).astype(np.int8)


def pick_junctions(codes, n_junc: int = 64):
    """Naturally occurring GT..AG introns (the genome is not mutated)."""
    rng = np.random.default_rng(3)
    gt = np.nonzero((codes[:-1] == 2) & (codes[1:] == 3))[0]
    juncs = []
    for s in rng.choice(len(gt) - 1, 4 * n_junc, replace=False):
        d = int(gt[s])                        # donor: intron starts d..d+1
        left = d - 1                          # last exonic base
        win = codes[d + 100: d + 5000]
        ag = np.nonzero((win[:-1] == 0) & (win[1:] == 2))[0]
        if len(ag) == 0 or left < 200 or d + 5002 >= len(codes) - 200:
            continue
        right = d + 100 + int(ag[0]) + 2      # first exonic base after AG
        juncs.append((left, right))
        if len(juncs) == n_junc:
            break
    return juncs


def make_reads(codes, juncs, seed: int, n_reads: int = N_READS):
    """25% junction-spanning reads (r0, r4, ...), the rest contiguous with
    one mismatch — the JAX package's bench generator (bench.py)."""
    r = np.random.default_rng(seed)
    seqs = []
    for i in range(n_reads):
        if i % 4 == 0:
            left, right = juncs[int(r.integers(0, len(juncs)))]
            t = int(r.integers(30, 70))
            seq = np.concatenate([codes[left - t + 1:left + 1],
                                  codes[right:right + READ_LEN - t]])
        else:
            s = int(r.integers(0, len(codes) - READ_LEN))
            seq = codes[s:s + READ_LEN].copy()
            p = int(r.integers(0, READ_LEN))
            seq[p] = (seq[p] + 1) % 4
        seqs.append(seq)
    return np.stack(seqs)


def write_fasta(path, codes, width: int = 4096):
    lut = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "wb") as f:
        f.write(b">chr1\n")
        for s in range(0, len(codes), width):
            f.write(lut[codes[s:s + width]].tobytes() + b"\n")


def write_fastq(path, seqs, prefix: str = "r"):
    lut = np.frombuffer(b"ACGTN", np.uint8)
    qual = b"I" * seqs.shape[1]
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b"@%s%d\n%s\n+\n%s\n" % (prefix.encode(), i,
                                            lut[s].tobytes(), qual))


def junction_recall(sam_path, n_reads: int = N_READS,
                    prefix: str = "r", flag_bit: int = 0) -> float:
    """% of junction-spanning reads (prefix0, prefix4, ...) with an
    N-CIGAR record; flag_bit restricts the records to one mate."""
    spliced = set()
    with open(sam_path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            t = line.split("\t", 6)
            if "N" in t[5] and (not flag_bit or int(t[1]) & flag_bit):
                spliced.add(t[0])
    n_span = (n_reads + 3) // 4
    n_hit = sum(1 for i in range(0, n_reads, 4) if f"{prefix}{i}" in spliced)
    return 100.0 * n_hit / n_span


def phase_spliced():
    import torch

    from tophat_tpu_torch.cli.main import main as cli_main
    from tophat_tpu_torch.ops import events

    os.makedirs(CACHE, exist_ok=True)
    fa = os.path.join(CACHE, "genome_2p27.fa")
    t0 = time.time()
    codes = make_genome()
    if not os.path.exists(fa):
        write_fasta(fa, codes)
    juncs = pick_junctions(codes)
    fq_warm = os.path.join(CACHE, "warm.fq")
    fq = os.path.join(CACHE, "steady.fq")
    write_fastq(fq_warm, make_reads(codes, juncs, 5))
    write_fastq(fq, make_reads(codes, juncs, 6))
    log(f"inputs: {GENOME_N} bases, {len(juncs)} junctions, "
        f"{N_READS} reads ({time.time() - t0:.1f} s)")

    index = os.path.join(CACHE, "fm_2p27")
    argv = lambda out, reads: ["-o", out, "--no-coverage-search",
                               "--tt-index", index, fa, reads]
    # the warm run keeps every realign call's inputs and outputs, so the
    # kernel is also held against its plain version on the exact tensors
    # the main path gave it (the timed steady run records nothing)
    calls = []
    t0 = time.time()
    with RealignHooks(events, lambda kind, args, out: calls.append(
            (kind, tuple(a.clone() if torch.is_tensor(a) else a
                         for a in args), out.clone() if kind == "sparse"
             else tuple(o.clone() for o in out)))):
        rc = cli_main(argv(os.path.join(CACHE, "out_warm"), fq_warm))
    if rc != 0:
        fail("warm CLI run returned non-zero")
    warm_s = time.time() - t0
    log(f"warm run (index build or load included): {warm_s:.1f} s")
    if not any(kind == "sparse" for kind, _, _ in calls):
        fail("the warm run made no sparse realign call")
    path_err, shapes = 0, []
    for kind, args, got in calls:
        err, shape = hold_realign(kind, args, got)
        path_err = max(path_err, err)
        shapes.append(f"{kind} {shape}")
    log("realign on the main path's own inputs: exact in "
        + ", ".join(shapes))

    out = os.path.join(CACHE, "out_steady")
    realign_launches(reset=True)
    torch.cuda.synchronize()
    t0 = time.time()
    rc = cli_main(argv(out, fq))
    torch.cuda.synchronize()
    steady_s = time.time() - t0
    launches = realign_launches()
    if rc != 0:
        fail("steady CLI run returned non-zero")
    recall = junction_recall(os.path.join(out, "accepted_hits.sam"))
    n_sam = sum(1 for ln in open(os.path.join(out, "accepted_hits.sam"))
                if not ln.startswith("@"))
    n_junc_bed = sum(1 for _ in open(os.path.join(out, "junctions.bed"))) - 1
    log(f"steady run: {steady_s:.2f} s, {N_READS / steady_s:.1f} reads/s; "
        f"{n_sam} alignments, {n_junc_bed} junctions; recall {recall:.2f}%; "
        f"realign launches {launches} (dense, sparse)")
    if launches[1] == 0:
        fail("the spliced main path never launched the sparse realign "
             "kernel")
    if recall < 100.0:
        fail(f"junction-read recall {recall:.2f}% < 100%")
    return dict(steady_s=steady_s, reads_per_s=N_READS / steady_s,
                recall_pct=recall, warm_s=warm_s, launches=launches,
                path_err=path_err,
                index=index + ".tt.npz", codes=codes, juncs=juncs)


def phase_small_reference(codes):
    """The spliced pipeline on a small input (the first 2^21 + 4096 bases,
    beam engine; 2,048 reads) on the card and on the CPU, where every
    kernel runs its plain torch version: the four output files must be
    byte-identical."""
    from tophat_tpu_torch.index.fasta import Genome, decode_seq
    from tophat_tpu_torch.io.fastq import batch_reads
    from tophat_tpu_torch.pipeline.params import Params
    from tophat_tpu_torch.pipeline.run import run_pipeline

    small = codes[:(1 << 21) + 4096]
    seqs = make_reads(small, pick_junctions(small, 16), 9, n_reads=2048)
    recs = [(f"r{i}", decode_seq(s), b"I" * len(s))
            for i, s in enumerate(seqs)]
    genome = Genome(codes=small, offsets=np.array([0, len(small)]),
                    names=["chr1"])
    outs = {}
    for dev in ("cuda", "cpu"):
        outs[dev] = os.path.join(CACHE, f"small_{dev}")
        run_pipeline(genome, batch_reads(recs), Params(coverage_search=False),
                     outs[dev], log=lambda *a: None, device=dev)
    for f in ("accepted_hits.sam", "junctions.bed", "insertions.bed",
              "deletions.bed"):
        with open(os.path.join(outs["cuda"], f), "rb") as a, \
                open(os.path.join(outs["cpu"], f), "rb") as b:
            if a.read() != b.read():
                fail(f"small input: {f} differs between the card and the "
                     "CPU reference")
    recall = junction_recall(os.path.join(outs["cuda"], "accepted_hits.sam"),
                             len(seqs))
    if recall < 100.0:
        fail(f"small input: junction-read recall {recall:.2f}% < 100%")
    log("small input (2^21 + 4096 bases, 2048 reads): card and CPU outputs "
        f"byte-identical; recall {recall:.2f}%")


# ---------------------------------------------------------------- phase 5

def phase_unspliced(index_path, codes):
    import torch

    from tophat_tpu_torch.index.fasta import revcomp
    from tophat_tpu_torch.index.fm import FMIndex
    from tophat_tpu_torch.ops.align import align_reads_adaptive, kmer_fast_ok

    dev = torch.device("cuda")
    fm = FMIndex.load(index_path, device=dev)
    offsets = torch.tensor([0, fm.n], device=dev)
    fast = kmer_fast_ok(fm, READ_LEN, 2)

    def make_batch(seed):
        r = np.random.default_rng(seed)
        starts = r.integers(0, GENOME_N - READ_LEN, BATCH)
        reads = codes[starts[:, None] + np.arange(READ_LEN)].copy()
        for _ in range(2):
            p = r.integers(0, READ_LEN, BATCH)
            reads[np.arange(BATCH), p] = (
                reads[np.arange(BATCH), p] + r.integers(1, 4, BATCH)) % 4
        flip = r.random(BATCH) < 0.5
        rf = np.where(flip[:, None], revcomp(reads), reads).astype(np.int8)
        rr = revcomp(rf).copy().astype(np.int8)
        return tuple(torch.as_tensor(x, device=dev) for x in
                     (rf, rr, np.full(BATCH, READ_LEN, np.int32)))

    batches = [make_batch(100 + i) for i in range(UNSPLICED_ITERS + 1)]
    run = lambda b: align_reads_adaptive(
        fm, b[0], b[1], b[2], offsets, max_mismatches=2, max_alignments=8,
        kmer_fast=fast, narrow_hits=6, wide_hits=32, resolve_cap=1)
    warm = run(batches[0])
    aligned = int((warm.n_hits > 0).sum())
    if aligned < BATCH * 0.99:
        fail(f"unspliced: only {aligned}/{BATCH} reads aligned")
    torch.cuda.synchronize()
    t0 = time.time()
    outs = [run(b) for b in batches[1:]]
    torch.cuda.synchronize()
    dt = time.time() - t0
    chk = sum(int(o.n_hits.sum()) for o in outs)
    rps = UNSPLICED_ITERS * BATCH / dt
    log(f"unspliced: {rps:.1f} reads/s over {UNSPLICED_ITERS} batches of "
        f"{BATCH} (warm batch {aligned}/{BATCH} aligned; checksum {chk})")
    return rps


# ---------------------------------------------------------------- phase 6

def make_pairs(codes, juncs, seed: int, n_pairs: int):
    """Mate pairs of 2 x READ_LEN bp. The inner distance is drawn from
    N(50, 20) (TopHat's -r / --mate-std-dev defaults), clipped at 0; mate 2
    is the reverse complement downstream of mate 1. In 25% of pairs (p0,
    p4, ...) mate 1 crosses one of `juncs` with >= 20 bp on each side; the
    other pairs are contiguous with one mismatch in each mate."""
    from tophat_tpu_torch.index.fasta import revcomp

    r = np.random.default_rng(seed)
    L = READ_LEN
    juncs = [j for j in juncs if j[1] + 3 * L + 400 < len(codes)]
    m1 = np.empty((n_pairs, L), np.int8)
    m2 = np.empty((n_pairs, L), np.int8)
    for i in range(n_pairs):
        inner = max(0, int(round(r.normal(50, 20))))
        if i % 4 == 0:
            left, right = juncs[int(r.integers(0, len(juncs)))]
            t = int(r.integers(20, L - 19))
            m1[i] = np.concatenate([codes[left - t + 1:left + 1],
                                    codes[right:right + L - t]])
            s2 = right + L - t + inner
            m2[i] = revcomp(codes[s2:s2 + L])
        else:
            s = int(r.integers(0, len(codes) - 3 * L - 400))
            a = codes[s:s + L].copy()
            b = codes[s + L + inner:s + 2 * L + inner].copy()
            for x in (a, b):
                p = int(r.integers(0, L))
                x[p] = (x[p] + 1) % 4
            m1[i] = a
            m2[i] = revcomp(b)
    return m1, m2


class StageClock:
    """Seconds per stage: wraps functions (module or class attributes) with
    a timer that synchronizes the card before and after each call."""

    def __init__(self):
        self.seconds = {}
        self._undo = []

    def wrap(self, owner, name: str, label: str):
        import torch

        saved = owner.__dict__[name]
        fn = getattr(owner, name)

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                self.seconds[label] = (self.seconds.get(label, 0.0)
                                       + time.perf_counter() - t0)

        setattr(owner, name, timed)
        self._undo.append((owner, name, saved))

    def restore(self):
        for owner, name, saved in reversed(self._undo):
            setattr(owner, name, saved)
        self._undo.clear()


def align_summary_pairs(path):
    """(aligned pairs, discordant pairs) from align_summary.txt."""
    aligned = disc = 0
    with open(path) as f:
        for line in f:
            if line.startswith("Aligned pairs:"):
                aligned = int(line.split(":")[1])
            elif "are discordant" in line:
                disc = int(line.split()[0])
    return aligned, disc


def phase_paired(codes, juncs, index):
    """TopHat's default invocation, paired-end with the coverage search on,
    through the CLI on the phase-4 genome and index: one run that holds
    every realign call against realign_plain as it is made, then one timed
    run with stage seconds, realign launches and peak device memory."""
    import torch

    from tophat_tpu_torch.cli import main as cli_mod
    from tophat_tpu_torch.index.fm import FMIndex
    from tophat_tpu_torch.ops import events
    from tophat_tpu_torch.pipeline import paired as paired_mod
    from tophat_tpu_torch.pipeline import run as run_mod

    fa = os.path.join(CACHE, "genome_2p27.fa")
    t0 = time.time()
    fqs = {}
    for tag, seed in (("check", 15), ("steady", 16)):
        m1, m2 = make_pairs(codes, juncs, seed, N_PAIRS)
        fqs[tag] = [os.path.join(CACHE, f"pairs_{tag}_{k}.fq") for k in (1, 2)]
        write_fastq(fqs[tag][0], m1, "p")
        write_fastq(fqs[tag][1], m2, "p")
    log(f"paired inputs: 2 x {N_PAIRS} pairs of 2 x {READ_LEN} bp "
        f"({time.time() - t0:.1f} s)")
    argv = lambda out, reads: ["-o", out, "--tt-index", index, fa] + reads

    path_err = [0]
    checked = []

    def check(kind, args, out):
        err, shape = hold_realign(kind, args, out)
        path_err[0] = max(path_err[0], err)
        checked.append(f"{kind} {shape}")

    t0 = time.time()
    with RealignHooks(events, check):
        cli_main_checked(cli_mod.main,
                         argv(os.path.join(CACHE, "pairs_out_check"),
                              fqs["check"]))
    log(f"paired check run: {time.time() - t0:.1f} s; realign exact in "
        f"{len(checked)} calls: " + ", ".join(checked))
    if not any(c.startswith("sparse") for c in checked):
        fail("the paired check run made no sparse realign call")

    clock = StageClock()
    clock.wrap(cli_mod, "read_fasta", "read_fasta")
    clock.wrap(FMIndex, "load", "FMIndex.load")
    clock.wrap(paired_mod, "_map_mate",
               "map (prep, full-read align, segments, stitch)")
    clock.wrap(paired_mod, "discover_events", "discovery")
    clock.wrap(run_mod, "coverage_search_events", "coverage search")
    clock.wrap(paired_mod, "candidates_for_mate",
               "candidates (realign, collect, chains)")
    clock.wrap(run_mod, "realign_events_sparse", "  of which realign, sparse")
    clock.wrap(run_mod, "default_chains", "  of which default chains")
    clock.wrap(paired_mod, "accumulate_event_stats", "stats + filter")
    clock.wrap(paired_mod, "filter_junctions", "stats + filter")
    n_events = []
    finalize = paired_mod.SingleIndexMapper.finalize_events

    def finalize_counted(self, known_events=None):
        ev = finalize(self, known_events)
        n_events.append(len(ev["left"]))
        return ev

    paired_mod.SingleIndexMapper.finalize_events = finalize_counted
    calls = []
    out = os.path.join(CACHE, "pairs_out_steady")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    realign_launches(reset=True)
    t0 = time.time()
    try:
        with RealignHooks(events, lambda kind, args, _: calls.append(
                f"{kind} R={args[0].shape[0]} E={args[2].shape[0]} "
                f"L={args[0].shape[1]} q={args[4]}")):
            cli_main_checked(cli_mod.main, argv(out, fqs["steady"]))
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = realign_launches()
    finally:
        paired_mod.SingleIndexMapper.finalize_events = finalize
        clock.restore()
    peak = torch.cuda.max_memory_allocated()

    recall = junction_recall(os.path.join(out, "accepted_hits.sam"), N_PAIRS,
                             prefix="p", flag_bit=0x40)
    aligned, disc = align_summary_pairs(os.path.join(out,
                                                     "align_summary.txt"))
    top = sum(s for k, s in clock.seconds.items() if not k.startswith(" "))
    stages = dict(clock.seconds, **{"rest (FASTQ parse, selection, output)":
                                    wall - top})
    log(f"paired steady run: {wall:.2f} s, {N_PAIRS / wall:.1f} pairs/s; "
        f"events E={n_events}; realign launches {launches} (dense, "
        f"sparse); peak device "
        f"memory {peak / 2**30:.3f} GiB")
    for k, s in stages.items():
        log(f"  stage {k}: {s:.3f} s")
    log(f"  realign calls: " + ", ".join(calls))
    log(f"paired: junction-read recall (mate 1) {recall:.2f}%; both mates "
        f"aligned {100.0 * aligned / N_PAIRS:.2f}% of pairs; concordant "
        f"{100.0 * (aligned - disc) / N_PAIRS:.2f}% of pairs "
        f"({aligned} aligned, {disc} discordant)")
    if launches[1] == 0:
        fail("the paired main path never launched the sparse realign "
             "kernel")
    if recall < 100.0:
        fail(f"paired: junction-read recall {recall:.2f}% < 100%")
    return dict(wall_s=wall, pairs_per_s=N_PAIRS / wall, recall_pct=recall,
                launches=launches, path_err=path_err[0],
                events=n_events[0] if n_events else 0,
                realign_calls=calls, peak_device_bytes=peak,
                both_aligned_pct=100.0 * aligned / N_PAIRS,
                concordant_pct=100.0 * (aligned - disc) / N_PAIRS,
                coverage_search_s=stages.get("coverage search", 0.0),
                stages=stages)


def cli_main_checked(cli_main, argv):
    rc = cli_main(argv)
    if rc != 0:
        fail(f"CLI run {argv[1]} returned {rc}")
    return rc


# ---------------------------------------------------------------- phase 7

def phase_small_search_modes(codes, devices=("cuda", "cpu")):
    """On the first 2^21 + 4096 bases: 2,048 pairs in the paired default
    mode (coverage search on) and 2,048 single-end reads with the butterfly
    and microexon searches, on the card and on the CPU (plain versions) in
    this process; every output file must be byte-identical."""
    from tophat_tpu_torch.index.fasta import Genome, decode_seq
    from tophat_tpu_torch.io.fastq import batch_reads
    from tophat_tpu_torch.pipeline.paired import run_pipeline_paired
    from tophat_tpu_torch.pipeline.params import Params
    from tophat_tpu_torch.pipeline.run import run_pipeline

    small = codes[:(1 << 21) + 4096]
    juncs = pick_junctions(small, 16)
    m1, m2 = make_pairs(small, juncs, 19, n_pairs=SMALL_PAIRS)
    single = make_reads(small, juncs, 21, n_reads=SMALL_PAIRS)
    recs = lambda seqs, p: [(f"{p}{i}", decode_seq(s), b"I" * len(s))
                            for i, s in enumerate(seqs)]
    genome = Genome(codes=small, offsets=np.array([0, len(small)]),
                    names=["chr1"])
    files = ("accepted_hits.sam", "junctions.bed", "insertions.bed",
             "deletions.bed", "align_summary.txt")
    outs = {}
    for dev in devices:
        t0 = time.time()
        outs[dev] = (os.path.join(CACHE, f"small_paired_{dev}"),
                     os.path.join(CACHE, f"small_searches_{dev}"))
        run_pipeline_paired(genome, batch_reads(recs(m1, "p")),
                            batch_reads(recs(m2, "p")), Params(),
                            outs[dev][0], log=lambda *a: None, device=dev)
        run_pipeline(genome, batch_reads(recs(single, "r")),
                     Params(butterfly_search=True, microexon_search=True),
                     outs[dev][1], log=lambda *a: None, device=dev)
        log(f"small search modes on {dev}: {time.time() - t0:.1f} s")
    a, b = devices
    for k, what in enumerate(("paired default mode",
                              "butterfly + microexon searches")):
        for f in files:
            with open(os.path.join(outs[a][k], f), "rb") as x, \
                    open(os.path.join(outs[b][k], f), "rb") as y:
                if x.read() != y.read():
                    fail(f"small input, {what}: {f} differs between "
                         f"{a} and {b}")
    recall_p = junction_recall(
        os.path.join(outs[a][0], "accepted_hits.sam"), SMALL_PAIRS,
        prefix="p", flag_bit=0x40)
    recall_s = junction_recall(
        os.path.join(outs[a][1], "accepted_hits.sam"), SMALL_PAIRS)
    if min(recall_p, recall_s) < 100.0:
        fail(f"small search modes: junction-read recall {recall_p:.2f}% "
             f"(paired), {recall_s:.2f}% (searches) < 100%")
    log(f"small input (2^21 + 4096 bases): paired default mode and the "
        f"butterfly + microexon searches byte-identical on {a} and {b}; "
        f"recall {recall_p:.2f}% / {recall_s:.2f}%")


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    if not os.path.isdir(os.path.join(REPO, "tophat_tpu_torch")):
        fail("tophat_tpu_torch/ not found beside chip_smoke.py: run it "
             "from the root of a checkout")
    sys.path.insert(0, REPO)
    card = card_line()
    log(f"card: {card}")

    from tophat_tpu_torch.ops import realign_kernel

    t0 = time.time()
    realign_kernel.build()
    log(f"kernel build: {time.time() - t0:.1f} s")

    kernels = phase_kernels()
    spliced = phase_spliced()
    phase_small_reference(spliced["codes"])
    unspliced_rps = phase_unspliced(spliced["index"], spliced["codes"])
    paired = phase_paired(spliced["codes"], spliced["juncs"],
                          spliced["index"])
    phase_small_search_modes(spliced["codes"])

    print(json.dumps({
        "realign_cases": kernels,
        "spliced_reads_per_s": spliced["reads_per_s"],
        "spliced_steady_s": spliced["steady_s"],
        "spliced_junction_read_recall_pct": spliced["recall_pct"],
        "unspliced_reads_per_s": unspliced_rps,
        "paired": {k: v for k, v in paired.items() if k != "realign_calls"}}),
        flush=True)
    main_case = next(k for k in kernels if (k["R"], k["E"], k["L"], k["q"])
                     == (8192, 69, 100, 0))     # the main path's shape
    print(json.dumps({"kernels": [{
        "name": "realign", "route": "cuda",
        "source": "tophat_tpu_torch/csrc/realign.cu",
        "replaces": "tophat_tpu/ops/pallas/realign_kernel.py:44",
        "launches": sum(spliced["launches"]) + sum(paired["launches"]),
        "max_abs_err": max([spliced["path_err"], paired["path_err"]]
                           + [k["max_abs_err"] for k in kernels]),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"]}]}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
