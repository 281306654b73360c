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
  7. on a 2^21 + 4096-base slice: the paired default mode, a single-end
     run with the butterfly and microexon searches, and through the CLI a
     -G paired run (120 synthetic genes), a --b2 single-end run and a -C
     run from colorspace FASTQ, on the card and on the CPU, which must
     write identical files
  8. TopHat's annotated default run through the CLI (-G genes.gtf
     --transcriptome-index, paired, coverage search on) on the phase-4
     genome: a synthetic annotation of 21,000 transcripts (~50,000
     introns) and 32,768 pairs; a run that builds the transcriptome files
     and index and holds every realign call against its plain version,
     then a timed run with stage seconds, E, every realign call's R and E
     and peak device memory; fails under 100% recall, with no sparse
     realign launch, or with E < 30,000
  9. bowtie2 mode (--b2 --no-coverage-search) single-end on the same
     genome, 32,768 reads (25% spliced, 10% with a 1-2 bp indel): a
     checked run, then a timed run with the gapped stage's seconds and
     placements; fails under 100% junction or indel-read recall or with
     no gapped placement
 10. TopHat-Fusion (--fusion-search ... --tt-index, paired) through the
     CLI on the same genome and index: 24 designed breaks (8 ff, 8 fr,
     8 rf, partners >= 1 Mb apart) and 32,768 pairs (10% with mate 1
     across a break, 10% spanning one, 20% with mate 1 across an
     intron): a run holding every realign call (sparse, and dense over
     every row's segments) against its plain version, then a timed run
     with stage seconds, every realign call's R, E and L and peak device
     memory, then tophat-fusion-post on the card; fails if a designed
     break is missing from fusions.out, break-read or junction-read
     recall is under 100%, either realign entry was never launched, or
     result.txt holds no designed break. Phase 7 also runs a paired and
     a single-end fusion run and fusion-post on the slice, on the card
     and on the CPU, which must write identical files
Launches in the kernels line are summed over phases 4, 6, 8, 9 and 10
(each counted from 0 just before its timed run), max_abs_err over every
check.
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


ANNOTATED_E = 49998         # phase 8's event count (49,929 annotated introns
#                             and the discovered events)
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
    # the main path's own shape, an event table of a real transcriptome's
    # size, the annotated run's (phase 8) own shape, and the fusion run's
    # (phase 10) dense call over every row's segments
    cases = [(16384, 128, 100, 0), (16384, 128, 100, 3), (16384, 128, 25, 0),
             (8192, 128, 150, 0), (8192, 128, 300, 3), (8192, 128, 1000, 0),
             (8192, 69, 100, 0), (8192, 4096, 100, 0),
             (4096, ANNOTATED_E, 100, 0), (65536, 76, 25, 0)]
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
        if L == 100 and R * E * (L + 1) * 2 < 16e9:
            # (the yardstick's fp16 (E, R, L + 1) match volume: 41 GB at
            # the annotated run's shape, so no yardstick there)
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


E_SLICE = 4096     # events per plain-version call in hold_realign


def realign_call_shape(kind, args):
    """'kind R=.. E=.. L=.. q=..' of one call to a realign entry."""
    return (f"{kind} R={args[0].shape[0]} E={args[2].shape[0]} "
            f"L={args[0].shape[1]} q={args[4]}")


def hold_realign(kind, args, got):
    """Hold one realign call of the main path against realign_plain:
    a dense call's tables directly; a sparse call's records against
    pack_sparse of the plain tables, and the dense entry on the same
    inputs too. The plain version runs on slices of E_SLICE events (its
    (R, E) int64 tables at an annotation's E would take tens of GB).
    Returns (max abs error of the dense tables, the call's shape)."""
    import torch

    from tophat_tpu_torch.ops.realign_kernel import (pack_sparse,
                                                     realign_group,
                                                     realign_plain)

    reads, lengths, flank_l, comb, q, max_mm = args[:6]
    R, E = reads.shape[0], flank_l.shape[0]
    dense = got if kind == "dense" else realign_group(*args[:6])
    shape = realign_call_shape(kind, args)
    err, recs = 0, []
    for e0 in range(0, E, E_SLICE):
        e1 = min(E, e0 + E_SLICE)
        ref = realign_plain(reads, lengths, flank_l[e0:e1], comb[e0:e1], q,
                            max_mm)
        part = tuple(x[:, e0:e1] for x in dense)
        err = max(err, max_err(part, ref))
        if err or not all(torch.equal(a, b) for a, b in zip(part, ref)):
            fail(f"realign kernel disagrees with its plain version on the "
                 f"main path's inputs {shape} (max abs err {err})")
        if kind == "sparse":
            rec = pack_sparse(ref[0], ref[1], ref[2] & args[6][None, e0:e1])
            rec[1] += e0
            recs.append(rec)
    if kind == "sparse":
        ref_s = (torch.cat(recs, 1) if recs else
                 torch.empty((4, 0), dtype=torch.int32, device=reads.device))
        ref_s = ref_s[:, torch.argsort(ref_s[0].long() * E + ref_s[1])]
        if not torch.equal(got, ref_s):
            fail(f"sparse realign entry disagrees with the packed plain "
                 f"result on the main path's inputs {shape}")
    return err, shape


class PathCheck:
    """RealignHooks' on_call for a checked run: holds every realign call
    against the plain version (hold_realign), keeping the largest error
    and each call's shape."""

    def __init__(self):
        self.err, self.shapes = 0, []

    def __call__(self, kind, args, out):
        err, shape = hold_realign(kind, args, out)
        self.err = max(self.err, err)
        self.shapes.append(shape)


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
    check = PathCheck()
    for kind, args, got in calls:
        check(kind, args, got)
    log("realign on the main path's own inputs: exact in "
        + ", ".join(check.shapes))

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
                path_err=check.err,
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
    """Seconds and calls per stage: wraps functions (module or class
    attributes) with a timer that synchronizes the card before and after
    each call."""

    def __init__(self):
        self.seconds = {}
        self.calls = {}
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
                self.calls[label] = self.calls.get(label, 0) + 1

        setattr(owner, name, timed)
        self._undo.append((owner, name, saved))

    def restore(self):
        for owner, name, saved in reversed(self._undo):
            setattr(owner, name, saved)
        self._undo.clear()


def calls_note(n) -> str:
    return f" ({n} calls)" if n else ""


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

    check = PathCheck()

    t0 = time.time()
    with RealignHooks(events, check):
        cli_main_checked(cli_mod.main,
                         argv(os.path.join(CACHE, "pairs_out_check"),
                              fqs["check"]))
    log(f"paired check run: {time.time() - t0:.1f} s; realign exact in "
        f"{len(check.shapes)} calls: " + ", ".join(check.shapes))
    if not any(c.startswith("sparse") for c in check.shapes):
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
                realign_call_shape(kind, args))):
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
        log(f"  stage {k}: {s:.3f} s" + calls_note(clock.calls.get(k)))
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
                launches=launches, path_err=check.err,
                events=n_events[0] if n_events else 0,
                realign_calls=calls, peak_device_bytes=peak,
                both_aligned_pct=100.0 * aligned / N_PAIRS,
                concordant_pct=100.0 * (aligned - disc) / N_PAIRS,
                coverage_search_s=stages.get("coverage search", 0.0),
                stages=stages, stage_calls=clock.calls)


def cli_main_checked(cli_main, argv):
    rc = cli_main(argv)
    if rc != 0:
        fail(f"CLI run {argv[1]} returned {rc}")
    return rc


# ------------------------------------------------------------ phases 8, 9

def _motif(codes, a: int, b: int):
    """Sorted positions i with codes[i], codes[i + 1] == a, b."""
    return np.nonzero((codes[:-1] == a) & (codes[1:] == b))[0]


def make_annotation(codes, avoid, n_genes: int, seed: int = 29,
                    chrom: str = "chr1"):
    """A synthetic GTF of the order of a Drosophila annotation (FlyBase r6:
    tens of thousands of transcripts) on `codes`: n_genes non-overlapping
    genes, alternating strands, 3-8 exons of 50-300 bp; introns of 70-5,000
    bp (log-uniform) at naturally occurring GT..AG (CT..AC on the forward
    strand for '-' genes), found as pick_junctions finds its introns. Each
    gene has 2-3 isoforms: every exon; one internal exon skipped; for every
    other gene another internal exon skipped (the first exon dropped when
    there is only one internal exon). No intron equals one in `avoid`
    ((left, right) pairs). Returns (GTF text, transcripts [(exons [start,
    end) 0-based), ...], the distinct introns)."""
    rng = np.random.default_rng(seed)
    motifs = {"+": (_motif(codes, 2, 3), _motif(codes, 0, 2)),
              "-": (_motif(codes, 1, 3), _motif(codes, 0, 1))}
    avoid = set(avoid)
    lines, transcripts, introns = [], [], set()
    p = 5000
    gi = 0
    while gi < n_genes:
        if p + 60000 >= len(codes):
            fail(f"annotation: the genome holds only {gi} genes")
        strand = "+" if gi % 2 == 0 else "-"
        starts, ends = motifs[strand]
        k = int(rng.integers(3, 9))
        exons, s = [], p
        for j in range(k - 1):
            lo = np.searchsorted(starts, s + 50)
            hi = np.searchsorted(starts, s + 301)
            if hi <= lo:
                break
            d = int(starts[int(rng.integers(lo, hi))])   # intron start
            target = int(np.exp(rng.uniform(np.log(70), np.log(5000))))
            a_lo = np.searchsorted(ends, d + max(target, 70) - 2)
            if a_lo >= len(ends) or ends[a_lo] + 2 - d > 5000:
                break
            exons.append((s, d))
            s = int(ends[a_lo]) + 2                     # next exon start
        else:
            exons.append((s, s + int(rng.integers(50, 301))))
        if len(exons) != k:
            p = exons[-1][1] + 100 if exons else p + 100
            continue
        skip = int(rng.integers(1, k - 1))
        isoforms = [exons, exons[:skip] + exons[skip + 1:]]
        if gi % 2 == 0:
            if k >= 4:
                other = [j for j in range(1, k - 1) if j != skip]
                j2 = other[int(rng.integers(0, len(other)))]
                isoforms.append(exons[:j2] + exons[j2 + 1:])
            else:
                isoforms.append(exons[1:])
        gene_introns = {(e1 - 1, s2) for ex in isoforms
                        for (_, e1), (s2, _) in zip(ex, ex[1:])}
        if gene_introns & avoid:
            p = exons[-1][1] + 100
            continue
        introns |= gene_introns
        for ti, ex in enumerate(isoforms):
            tid = f"g{gi}.{ti + 1}"
            lines += [f'{chrom}\tsmoke\texon\t{a + 1}\t{b}\t.\t{strand}\t.\t'
                      f'gene_id "g{gi}"; transcript_id "{tid}";\n'
                      for a, b in ex]
            transcripts.append(ex)
        p = exons[-1][1] + int(rng.integers(300, 3000))
        gi += 1
    return "".join(lines), transcripts, introns


def make_annotated_pairs(codes, transcripts, juncs, seed: int, n_pairs: int):
    """Mate pairs of 2 x READ_LEN bp for the annotated run, inner distance
    from N(50, 20) clipped at 0, mate 2 the reverse complement downstream
    of mate 1: in 50% of pairs (i % 10 < 5) both mates are a fragment of an
    annotated transcript (in transcript space, mates swapped in every other
    such pair); in 10% (i % 10 == 5) mate 1 crosses one of `juncs` (none
    annotated) with >= 20 bp on each side; the rest are contiguous with one
    mismatch per mate. Returns (m1, m2, spans (n, 2) bool: the mate crosses
    an annotated junction, unannotated (n,) bool)."""
    from tophat_tpu_torch.index.fasta import revcomp

    r = np.random.default_rng(seed)
    L = READ_LEN
    seqs = [np.concatenate([codes[a:b] for a, b in ex]) for ex in transcripts]
    cuts = [np.cumsum([b - a for a, b in ex])[:-1] for ex in transcripts]
    juncs = [j for j in juncs if j[1] + 3 * L + 400 < len(codes)]
    m1 = np.empty((n_pairs, L), np.int8)
    m2 = np.empty((n_pairs, L), np.int8)
    spans = np.zeros((n_pairs, 2), bool)
    unannotated = np.zeros(n_pairs, bool)
    for i in range(n_pairs):
        inner = max(0, int(round(r.normal(50, 20))))
        kind = i % 10
        if kind < 5:
            while True:
                ti = int(r.integers(0, len(seqs)))
                if len(seqs[ti]) >= 2 * L + inner:
                    break
            s = int(r.integers(0, len(seqs[ti]) - 2 * L - inner + 1))
            e2 = s + L + inner
            a, b = seqs[ti][s:s + L], revcomp(seqs[ti][e2:e2 + L])
            sp = (bool(((cuts[ti] > s) & (cuts[ti] < s + L)).any()),
                  bool(((cuts[ti] > e2) & (cuts[ti] < e2 + L)).any()))
            if (i // 10) % 2:
                a, b, sp = b, a, sp[::-1]
            m1[i], m2[i], spans[i] = a, b, sp
        elif kind == 5:
            left, right = juncs[int(r.integers(0, len(juncs)))]
            t = int(r.integers(20, L - 19))
            m1[i] = np.concatenate([codes[left - t + 1:left + 1],
                                    codes[right:right + L - t]])
            s2 = right + L - t + inner
            m2[i] = revcomp(codes[s2:s2 + L])
            unannotated[i] = True
        else:
            s = int(r.integers(0, len(codes) - 3 * L - 400))
            a = codes[s:s + L].copy()
            b = codes[s + L + inner:s + 2 * L + inner].copy()
            for x in (a, b):
                p = int(r.integers(0, L))
                x[p] = (x[p] + 1) % 4
            m1[i], m2[i] = a, revcomp(b)
    return m1, m2, spans, unannotated


def make_b2_reads(codes, juncs, seed: int, n_reads: int):
    """Single-end READ_LEN-bp reads for bowtie2 mode: 25% (i % 20 < 5) cross
    one of `juncs` (30-69 bp before the junction); 10% (i % 20 in 5, 6)
    carry a 1-2 bp deletion (i % 20 == 5) or insertion (== 6) 30-70 bp into
    the read, and no mismatch; the rest are contiguous with one mismatch.
    (TopHat's default --read-gap-length 2 caps the gapped aligner's gaps at
    2 bp: 3-bp indels it leaves to the segment search, which finds few of
    them in the JAX package and the port alike.)
    Returns (seqs, junction read ids, {indel read id: true 0-based start})."""
    r = np.random.default_rng(seed)
    L = READ_LEN
    seqs = np.empty((n_reads, L), np.int8)
    spliced, indel = [], {}
    for i in range(n_reads):
        kind = i % 20
        if kind < 5:
            left, right = juncs[int(r.integers(0, len(juncs)))]
            t = int(r.integers(30, 70))
            seqs[i] = np.concatenate([codes[left - t + 1:left + 1],
                                      codes[right:right + L - t]])
            spliced.append(i)
            continue
        s = int(r.integers(0, len(codes) - L - 10))
        if kind in (5, 6):
            p, d = int(r.integers(30, 71)), int(r.integers(1, 3))
            if kind == 5:
                seqs[i] = np.concatenate([codes[s:s + p],
                                          codes[s + p + d:s + L + d]])
            else:
                ins = (codes[s + p - 1] + 1 + r.integers(0, 3, d)) % 4
                seqs[i] = np.concatenate([codes[s:s + p], ins.astype(np.int8),
                                          codes[s + p:s + L - d]])
            indel[i] = s
            continue
        seqs[i] = codes[s:s + L]
        p = int(r.integers(0, L))
        seqs[i, p] = (seqs[i, p] + 1) % 4
    return seqs, spliced, indel


def n_cigar_reads(sam_path, op: str = "N"):
    """{(name, mate)} of the records whose CIGAR has `op`; mate is 1 or 2
    for paired records (flag 0x40 / 0x80), 0 otherwise; with the record's
    0-based position as a third element when op is "ID"."""
    got = set()
    with open(sam_path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            t = line.split("\t", 6)
            if not any(c in t[5] for c in op):
                continue
            flag = int(t[1])
            mate = 1 if flag & 0x40 else 2 if flag & 0x80 else 0
            got.add((t[0], mate) if op == "N"
                    else (t[0], mate, int(t[3]) - 1))
    return got


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


def write_color_fastq(path, seqs, seed: int):
    """Colorspace FASTQ of base-space reads: primer T, then one color per
    base (the transition from the previous base); every third read carries
    one isolated color error."""
    r = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            cols = (np.concatenate([[3], s[:-1]]) ^ s).astype(np.int8)
            if i % 3 == 1:
                cols[int(r.integers(5, len(s) - 5))] ^= int(r.integers(1, 4))
            f.write(f"@c{i}\nT{''.join(map(str, cols))}\n+\n"
                    f"{'I' * (len(s) + 1)}\n")


def phase_small_slice_modes(codes, devices=("cuda", "cpu")):
    """On the first 2^21 + 4096 bases, through the CLI on the card and on
    the CPU: a -G paired run (120 synthetic genes, 2,048 pairs, the
    coverage search on), a --b2 single-end run (2,048 reads, 10% with a
    1-2 bp indel) and a -C single-end run from colorspace FASTQ (2,048
    reads, a third with a color error). Colorspace is held only here: a
    full-width run would build a second 2^27-base index for a legacy
    input. Every output file must be byte-identical."""
    from tophat_tpu_torch.cli.main import main as cli_main

    small = codes[:(1 << 21) + 4096]
    juncs = pick_junctions(small, 16)
    d = os.path.join(CACHE, "slice")
    os.makedirs(d, exist_ok=True)
    fa = os.path.join(d, "genome.fa")
    write_fasta(fa, small)
    gtf_text, transcripts, _ = make_annotation(small, juncs, 120, seed=31)
    gtf = os.path.join(d, "genes.gtf")
    with open(gtf, "w") as f:
        f.write(gtf_text)
    m1, m2, spans, unannotated = make_annotated_pairs(small, transcripts,
                                                      juncs, 33, SMALL_PAIRS)
    fq1, fq2 = (os.path.join(d, f"pairs_{k}.fq") for k in (1, 2))
    write_fastq(fq1, m1, "p")
    write_fastq(fq2, m2, "p")
    b2_seqs, b2_spliced, b2_indel = make_b2_reads(small, juncs, 35,
                                                  SMALL_PAIRS)
    b2_fq = os.path.join(d, "b2.fq")
    write_fastq(b2_fq, b2_seqs)
    color_fq = os.path.join(d, "color.fq")
    write_color_fastq(color_fq, make_reads(small, juncs, 37, SMALL_PAIRS), 39)
    runs = {"gtf": ["-G", gtf, fa, fq1, fq2],
            "b2": ["--b2", "--no-coverage-search", fa, b2_fq],
            "color": ["-C", "--no-coverage-search", fa, color_fq]}
    for dev in devices:
        t0 = time.time()
        for name, args in runs.items():
            cli_main_checked(cli_main, ["-o", os.path.join(d, f"{name}_{dev}"),
                                        "--device", dev] + args)
        log(f"small -G / --b2 / -C runs on {dev}: {time.time() - t0:.1f} s")
    a, b = devices
    for name in runs:
        for f in ("accepted_hits.sam", "junctions.bed", "insertions.bed",
                  "deletions.bed") + (("align_summary.txt",)
                                      if name == "gtf" else ()):
            with open(os.path.join(d, f"{name}_{a}", f), "rb") as x, \
                    open(os.path.join(d, f"{name}_{b}", f), "rb") as y:
                if x.read() != y.read():
                    fail(f"small input, {name} run: {f} differs between {a} "
                         f"and {b}")
    got = n_cigar_reads(os.path.join(d, f"gtf_{a}", "accepted_hits.sam"))
    missed = sum(1 for i, m in zip(*np.nonzero(spans))
                 if (f"p{i}", int(m) + 1) not in got)
    missed += sum(1 for i in np.nonzero(unannotated)[0]
                  if (f"p{i}", 1) not in got)
    sam = os.path.join(d, f"b2_{a}", "accepted_hits.sam")
    got_n, got_id = n_cigar_reads(sam), n_cigar_reads(sam, "ID")
    missed_b2 = sum(1 for i in b2_spliced if (f"r{i}", 0) not in got_n)
    missed_b2 += sum(1 for i, st in b2_indel.items()
                     if (f"r{i}", 0, st) not in got_id)
    with open(os.path.join(d, f"color_{a}", "accepted_hits.sam")) as f:
        color_names = {ln.split("\t", 1)[0] for ln in f}
    # contiguous reads (one SNP: two adjacent color mismatches) without a
    # color error must align color-natively
    missed_c = sum(1 for i in range(SMALL_PAIRS)
                   if i % 4 and i % 3 != 1 and f"c{i}" not in color_names)
    n_color = len(color_names)
    if missed or missed_b2 or missed_c:
        fail(f"small -G / --b2 / -C runs: {missed} annotated-junction or "
             f"intron mates, {missed_b2} --b2 junction or indel reads, "
             f"{missed_c} error-free contiguous colorspace reads missed")
    log(f"small input (2^21 + 4096 bases): -G paired, --b2 and -C runs "
        f"byte-identical on {a} and {b}; recall 100% (-G, --b2); "
        f"{n_color}/{SMALL_PAIRS} colorspace reads aligned")


N_GENES = 8400             # phase 8: 21,000 transcripts
MIN_EVENTS = 30000         # phase 8 fails with fewer events


def reads_on_transcripts(log_path) -> int:
    """Reads placed on annotated transcripts, summed over a run's mates
    and chunks (the transcriptome stage's lines in its tophat.log)."""
    n = 0
    with open(log_path) as f:
        for line in f:
            if "reads placed on annotated transcripts" in line:
                n += int(line.split("transcriptome map: ")[1].split()[0])
    return n


def phase_annotated(codes, juncs, index):
    """TopHat's annotated default run, `tophat -G genes.gtf
    --transcriptome-index ... genome r1.fq r2.fq` (paired-end, coverage
    search on), through the CLI on the phase-4 genome and index: a
    synthetic annotation of N_GENES genes (21,000 transcripts, ~50,000
    distinct introns, none of them a phase-4 intron) and 32,768 pairs of
    2 x 100 bp (50% transcript fragments, 10% with mate 1 across a phase-4
    intron, the rest contiguous). A first run builds the transcriptome
    files and index and holds every realign call against its plain
    version; a timed run reuses them and records stage seconds, E, every
    realign call's R and E, launches and peak device memory. Fails if
    recall is under 100% (annotated-junction mates, unannotated-intron
    mates 1), no sparse realign was launched, or E < 30,000."""
    import types

    import torch

    from tophat_tpu_torch.cli import main as cli_mod
    from tophat_tpu_torch.index.fm import FMIndex
    from tophat_tpu_torch.ops import events
    from tophat_tpu_torch.pipeline import paired as paired_mod
    from tophat_tpu_torch.pipeline import run as run_mod

    fa = os.path.join(CACHE, "genome_2p27.fa")
    t0 = time.time()
    gtf_text, transcripts, introns = make_annotation(codes, juncs, N_GENES)
    gtf = os.path.join(CACHE, "genes.gtf")
    with open(gtf, "w") as f:
        f.write(gtf_text)
    reads = {}
    for tag, seed in (("check", 41), ("steady", 42)):
        m1, m2, spans, unannotated = make_annotated_pairs(
            codes, transcripts, juncs, seed, N_PAIRS)
        fqs = [os.path.join(CACHE, f"annot_{tag}_{k}.fq") for k in (1, 2)]
        write_fastq(fqs[0], m1, "p")
        write_fastq(fqs[1], m2, "p")
        reads[tag] = (fqs, spans, unannotated)
    log(f"annotated inputs: {N_GENES} genes, {len(transcripts)} transcripts, "
        f"{len(introns)} distinct introns; 2 x {N_PAIRS} pairs "
        f"({time.time() - t0:.1f} s)")
    tix = os.path.join(CACHE, "tx", "genes")
    argv = lambda out, fqs: ["-o", out, "-G", gtf, "--transcriptome-index",
                             tix, "--tt-index", index, fa] + fqs

    check = PathCheck()

    build = StageClock()
    build.wrap(cli_mod, "write_transcriptome_files",
               "transcriptome files (.fa, .tlst, .gff, .ver)")
    build.wrap(cli_mod, "build_transcriptome_index",
               "transcriptome FM index build")
    t0 = time.time()
    try:
        with RealignHooks(events, check):
            cli_main_checked(cli_mod.main,
                             argv(os.path.join(CACHE, "annot_out_check"),
                                  reads["check"][0]))
    finally:
        build.restore()
    log(f"annotated check run: {time.time() - t0:.1f} s (transcriptome "
        f"build {build.seconds}); realign exact in {len(check.shapes)} "
        "calls: " + ", ".join(check.shapes))
    if not any(c.startswith("sparse") for c in check.shapes):
        fail("the annotated check run made no sparse realign call")

    clock = StageClock()
    genome_index = types.SimpleNamespace(load=FMIndex.load)
    saved_fm = cli_mod.FMIndex
    cli_mod.FMIndex = genome_index       # the genome index's load alone
    clock.wrap(cli_mod, "read_fasta", "read_fasta")
    clock.wrap(genome_index, "load", "genome FMIndex.load")
    clock.wrap(cli_mod, "parse_gtf", "GTF parse (parse_gtf, gtf_junctions)")
    clock.wrap(cli_mod, "gtf_junctions",
               "GTF parse (parse_gtf, gtf_junctions)")
    clock.wrap(cli_mod, "build_transcriptome_index",
               "transcriptome index reuse (sequences + FMIndex.load)")
    clock.wrap(paired_mod, "_map_mate", "map")
    clock.wrap(run_mod, "map_reads_transcriptome", " transcriptome map")
    clock.wrap(paired_mod, "discover_events", "discovery")
    clock.wrap(run_mod, "coverage_search_events", "coverage search")
    clock.wrap(paired_mod, "candidates_for_mate",
               "candidates (realign, collect, transcriptome, chains)")
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
    out = os.path.join(CACHE, "annot_out_steady")
    fqs, spans, unannotated = reads["steady"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    realign_launches(reset=True)
    t0 = time.time()
    try:
        with RealignHooks(events, lambda kind, args, _: calls.append(
                realign_call_shape(kind, args))):
            cli_main_checked(cli_mod.main, argv(out, fqs))
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = realign_launches()
    finally:
        paired_mod.SingleIndexMapper.finalize_events = finalize
        clock.restore()
        cli_mod.FMIndex = saved_fm
    peak = torch.cuda.max_memory_allocated()

    got = n_cigar_reads(os.path.join(out, "accepted_hits.sam"))
    n_span = int(spans.sum())
    missed_a = sum(1 for i, m in zip(*np.nonzero(spans))
                   if (f"p{i}", int(m) + 1) not in got)
    missed_u = sum(1 for i in np.nonzero(unannotated)[0]
                   if (f"p{i}", 1) not in got)
    recall_a = 100.0 * (n_span - missed_a) / n_span
    recall_u = 100.0 * (1 - missed_u / int(unannotated.sum()))
    placed = reads_on_transcripts(os.path.join(out, "logs", "tophat.log"))
    aligned, disc = align_summary_pairs(os.path.join(out,
                                                     "align_summary.txt"))
    stages = dict(clock.seconds)
    tmap = stages.pop(" transcriptome map", 0.0)
    stages["transcriptome map (align + rebase)"] = tmap
    stages["map: genome (prep, full-read align, segments, stitch)"] = \
        stages.pop("map", 0.0) - tmap
    top = sum(v for k, v in stages.items() if not k.startswith(" "))
    stages["rest (FASTQ parse, selection, output)"] = wall - top
    E = n_events[0] if n_events else 0
    log(f"annotated steady run: {wall:.2f} s, {N_PAIRS / wall:.1f} pairs/s; "
        f"E={E}; {placed} reads placed on transcripts; realign launches "
        f"{launches} (dense, sparse); peak device memory "
        f"{peak / 2**30:.3f} GiB")
    calls_of = dict(build.calls, **clock.calls)
    calls_of["transcriptome map (align + rebase)"] = clock.calls.get(
        " transcriptome map", 0)
    calls_of["map: genome (prep, full-read align, segments, stitch)"] = \
        clock.calls.get("map", 0)
    for k, v in list(build.seconds.items()) + list(stages.items()):
        log(f"  stage {k}: {v:.3f} s" + calls_note(calls_of.get(k)))
    log("  realign calls: " + ", ".join(calls))
    log(f"annotated: recall {recall_a:.2f}% of {n_span} annotated-junction "
        f"mates, {recall_u:.2f}% of {int(unannotated.sum())} unannotated-"
        f"intron mates 1; concordant "
        f"{100.0 * (aligned - disc) / N_PAIRS:.2f}% of pairs")
    if launches[1] == 0:
        fail("the annotated run never launched the sparse realign kernel")
    if E < MIN_EVENTS:
        fail(f"annotated run: E = {E} < {MIN_EVENTS} events")
    if missed_a or missed_u:
        fail(f"annotated run: recall {recall_a:.2f}% (annotated), "
             f"{recall_u:.2f}% (unannotated) < 100%")
    return dict(wall_s=wall, pairs_per_s=N_PAIRS / wall, events=E,
                transcripts=len(transcripts), introns=len(introns),
                reads_on_transcripts=placed, launches=launches,
                path_err=check.err, realign_calls=calls,
                peak_device_bytes=peak, recall_annotated_pct=recall_a,
                recall_unannotated_pct=recall_u,
                concordant_pct=100.0 * (aligned - disc) / N_PAIRS,
                build_stages=build.seconds, stages=stages,
                stage_calls=calls_of)


def phase_bowtie2(codes, juncs, index):
    """Bowtie2 mode at full width: `--b2 --no-coverage-search --tt-index`
    single-end on the phase-4 genome, 32,768 x 100 bp reads (25% across a
    phase-4 intron, 10% with a 1-2 bp indel 30-70 bp in): a run holding
    every realign call against its plain version, then a timed run.
    Fails if junction or indel-read recall is under 100% (an indel read
    counts with an I/D record at its true position) or the gapped stage
    placed nothing."""
    import torch

    from tophat_tpu_torch.cli import main as cli_mod
    from tophat_tpu_torch.ops import events
    from tophat_tpu_torch.pipeline import run as run_mod

    fa = os.path.join(CACHE, "genome_2p27.fa")
    data = {}
    for tag, seed in (("check", 45), ("steady", 46)):
        seqs, spliced, indel = make_b2_reads(codes, juncs, seed, N_READS)
        fq = os.path.join(CACHE, f"b2_{tag}.fq")
        write_fastq(fq, seqs)
        data[tag] = (fq, spliced, indel)
    argv = lambda out, fq: ["-o", out, "--b2", "--no-coverage-search",
                            "--tt-index", index, fa, fq]
    check = PathCheck()

    t0 = time.time()
    with RealignHooks(events, check):
        cli_main_checked(cli_mod.main, argv(os.path.join(CACHE, "b2_check"),
                                            data["check"][0]))
    log(f"bowtie2 check run: {time.time() - t0:.1f} s; realign exact in "
        f"{len(check.shapes)} calls: " + ", ".join(check.shapes))

    clock = StageClock()
    clock.wrap(run_mod, "gapped_from_segments", "gapped stage")
    placements = [0]
    gapped = run_mod.gapped_from_segments

    def counted(*a, **k):
        ev, res = gapped(*a, **k)
        placements[0] += len(res)
        return ev, res

    run_mod.gapped_from_segments = counted
    calls = []
    out = os.path.join(CACHE, "b2_steady")
    fq, spliced, indel = data["steady"]
    realign_launches(reset=True)
    torch.cuda.synchronize()
    t0 = time.time()
    try:
        with RealignHooks(events, lambda kind, args, _: calls.append(
                realign_call_shape(kind, args))):
            cli_main_checked(cli_mod.main, argv(out, fq))
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = realign_launches()
    finally:
        run_mod.gapped_from_segments = gapped
        clock.restore()
    sam = os.path.join(out, "accepted_hits.sam")
    got_n, got_id = n_cigar_reads(sam), n_cigar_reads(sam, "ID")
    missed_j = sum(1 for i in spliced if (f"r{i}", 0) not in got_n)
    missed_i = sum(1 for i, st in indel.items()
                   if (f"r{i}", 0, st) not in got_id)
    recall_j = 100.0 * (1 - missed_j / len(spliced))
    recall_i = 100.0 * (1 - missed_i / len(indel))
    log(f"bowtie2 steady run: {wall:.2f} s, {N_READS / wall:.1f} reads/s; "
        f"gapped stage {clock.seconds.get('gapped stage', 0.0):.3f} s, "
        f"{placements[0]} direct gapped placements; realign launches "
        f"{launches} (dense, sparse); calls: " + ", ".join(calls))
    log(f"bowtie2: junction-read recall {recall_j:.2f}% of {len(spliced)}, "
        f"indel-read recall {recall_i:.2f}% of {len(indel)}")
    if placements[0] == 0:
        fail("bowtie2 run: the gapped stage placed nothing")
    if missed_j or missed_i:
        fail(f"bowtie2 run: recall {recall_j:.2f}% (junctions), "
             f"{recall_i:.2f}% (indels) < 100%")
    return dict(wall_s=wall, reads_per_s=N_READS / wall,
                gapped_s=clock.seconds.get("gapped stage", 0.0),
                gapped_placements=placements[0], launches=launches,
                path_err=check.err, realign_calls=calls,
                recall_junction_pct=recall_j, recall_indel_pct=recall_i)


# --------------------------------------------------------------- phase 10

FUSION_FLAGS = ["--fusion-search", "--keep-fasta-order", "--bowtie1",
                "--no-coverage-search", "-r", "0", "--mate-std-dev", "80",
                "--max-intron-length", "100000", "--fusion-min-dist",
                "100000", "--fusion-anchor-length", "13"]
FUSION_SHIFT = 12          # equivalent break shifts searched each way


def fusion_read(codes, d: str, a: int, b: int, t: int, n: int = READ_LEN):
    """n bases across a break after t read bases: ff = genome[..a] +
    genome[b..]; fr = genome[..a] + revcomp(genome[..b]); rf =
    revcomp(genome[a..]) + genome[b..]."""
    from tophat_tpu_torch.index.fasta import revcomp

    if d == "ff":
        return np.concatenate([codes[a - t + 1:a + 1], codes[b:b + n - t]])
    if d == "fr":
        return np.concatenate([codes[a - t + 1:a + 1],
                               revcomp(codes[b - (n - t) + 1:b + 1])])
    return np.concatenate([revcomp(codes[a:a + t]), codes[b:b + n - t]])


def pick_fusion_breaks(codes, n_each: int = 8, seed: int = 51,
                       min_sep: int = 1_000_000):
    """[(dir, a, b)]: n_each ff, fr and rf breaks at random positions of
    the genome, the partners >= min_sep apart, every other one with its
    second partner before the first."""
    r = np.random.default_rng(seed)
    n, margin = len(codes), 2000
    out = []
    for d in ("ff", "fr", "rf"):
        for k in range(n_each):
            while True:
                a, b = (int(x) for x in r.integers(margin, n - margin, 2))
                if abs(a - b) >= min_sep and (a < b) == (k % 2 == 0):
                    break
            out.append((d, a, b))
    return out


def equivalent_breaks(codes, d: str, a: int, b: int, t: int):
    """The placements (a', b', t') that spell the same read as (a, b, t):
    a break is only defined up to shifts across bases its two partners
    share; the pipelines keep the leftmost."""
    read = fusion_read(codes, d, a, b, t)
    out = []
    for j in range(-FUSION_SHIFT, FUSION_SHIFT + 1):
        a2, b2 = {"ff": (a + j, b + j), "fr": (a + j, b - j),
                  "rf": (a - j, b + j)}[d]
        if 0 < t + j < READ_LEN and np.array_equal(
                fusion_read(codes, d, a2, b2, t + j), read):
            out.append((a2, b2, t + j))
    return out


def make_fusion_pairs(codes, juncs, breaks, seed: int, n_pairs: int):
    """Mate pairs of 2 x READ_LEN bp, inner distance |N(0, 80)|, mate 2
    the reverse complement of the fragment's other end: in 10% of pairs
    (i % 10 == 0) mate 1 crosses a break of `breaks` 30-70 bp in (the
    fragment goes on along the second partner); in 10% (i % 10 == 1) the
    break lies between the mates (mate 1 on the first partner, mate 2 on
    the second); in 20% (i % 10 in 2, 3) mate 1 crosses one of `juncs`
    with >= 20 bp on each side; the rest are contiguous with one mismatch
    per mate. Returns (m1, m2, {i: (dir, a, b, t)} of the break reads)."""
    from tophat_tpu_torch.index.fasta import revcomp

    r = np.random.default_rng(seed)
    L = READ_LEN
    juncs = [j for j in juncs if j[1] + 3 * L + 400 < len(codes)]
    m1 = np.empty((n_pairs, L), np.int8)
    m2 = np.empty((n_pairs, L), np.int8)
    fused = {}

    def downstream(d, b, used, inner):
        """Mate 2 past `used` bases of the second partner."""
        if d == "fr":
            q = b - used - inner - L + 1
            return codes[q:q + L]
        q = b + used + inner
        return revcomp(codes[q:q + L])

    for i in range(n_pairs):
        inner = int(round(abs(r.normal(0, 80))))
        kind = i % 10
        if kind < 2:
            d, a, b = breaks[(i // 10) % len(breaks)]
            if kind == 0:
                t = int(r.integers(30, 71))
                m1[i] = fusion_read(codes, d, a, b, t)
                m2[i] = downstream(d, b, L - t, inner)
                fused[i] = (d, a, b, t)
            else:
                y = int(r.integers(20, 150))
                m1[i] = (revcomp(codes[a + y:a + y + L]) if d == "rf"
                         else codes[a - y - L + 1:a - y + 1])
                m2[i] = downstream(d, b, 0, inner)
        elif kind < 4:
            left, right = juncs[int(r.integers(0, len(juncs)))]
            t = int(r.integers(20, L - 19))
            m1[i] = np.concatenate([codes[left - t + 1:left + 1],
                                    codes[right:right + L - t]])
            s2 = right + L - t + inner
            m2[i] = revcomp(codes[s2:s2 + L])
        else:
            s = int(r.integers(0, len(codes) - 3 * L - 400))
            a_, b_ = codes[s:s + L].copy(), codes[s + L + inner:
                                                   s + 2 * L + inner].copy()
            for x in (a_, b_):
                p = int(r.integers(0, L))
                x[p] = (x[p] + 1) % 4
            m1[i], m2[i] = a_, revcomp(b_)
    return m1, m2, fused


def fusion_recall(out_dir, codes, breaks, fused, n_pairs: int):
    """(break-read recall %, junction-read recall %, breaks missing from
    fusions.out). A break read counts when its mate-1 record lies at its
    break (POS and the clipped CIGAR of an equivalent placement): paired
    records carry no XF:Z tag in either package, and the single-end XF:Z
    of a table-free FR/RF candidate names another event (ROADMAP Queue 3),
    so the record's own placement is what is held. A break counts when
    fusions.out has an equivalent one with its direction."""
    L = READ_LEN
    want = {}
    for i, (d, a, b, t) in fused.items():
        want[f"p{i}"] = {(a2 - t2 + 1, f"{t2}M{L - t2}S") if d != "rf"
                         else (b2, f"{t2}S{L - t2}M")
                         for a2, b2, t2 in equivalent_breaks(codes, d, a, b,
                                                             t)}
    sam = os.path.join(out_dir, "accepted_hits.sam")
    found = set()
    with open(sam) as f:
        for line in f:
            if line.startswith("@"):
                continue
            x = line.split("\t", 6)
            if int(x[1]) & 0x80 == 0 and (int(x[3]) - 1, x[5]) in \
                    want.get(x[0], ()):
                found.add(x[0])
    got = n_cigar_reads(sam)
    spliced = [i for i in range(n_pairs) if i % 10 in (2, 3)]
    recall_j = 100.0 * sum(any((f"p{i}", m) in got for m in (0, 1))
                           for i in spliced) / len(spliced)
    reported = set()
    with open(os.path.join(out_dir, "fusions.out")) as f:
        for line in f:
            x = line.split("\t")
            reported.add((int(x[1]), int(x[2]), x[3]))
    missing = []
    for d, a, b in breaks:
        ts = [t for (d2, a2, b2, t) in fused.values() if (d2, a2, b2) ==
              (d, a, b)]
        eq = {(min(a2, b2), max(a2, b2), d) for t in ts
              for a2, b2, _ in equivalent_breaks(codes, d, a, b, t)}
        if not eq & reported:
            missing.append((d, a, b))
    return 100.0 * len(found) / len(fused), recall_j, missing


def designed_in_result(path, codes, breaks, fused) -> int:
    """How many designed breaks result.txt reports (any equivalent)."""
    rows = set()
    with open(path) as f:
        for line in f:
            if not line.startswith("#") and line.strip():
                x = line.split("\t")
                rows.add((int(x[3]), int(x[6])))
    n = 0
    for d, a, b in breaks:
        eq = {(min(a2, b2), max(a2, b2)) for (d2, a0, b0, t) in
              fused.values() if (d2, a0, b0) == (d, a, b)
              for a2, b2, _ in equivalent_breaks(codes, d, a, b, t)}
        n += bool(eq & rows)
    return n


def run_fusion_post(workdir, fa, device: str):
    """tophat-fusion-post (--skip-blast --no-filter-by-annotation) over
    the tophat_<sample>/ dirs in workdir; returns its seconds."""
    from tophat_tpu_torch.cli.fusion_post import main as post_main

    cwd = os.getcwd()
    os.chdir(workdir)
    t0 = time.time()
    try:
        rc = post_main(["--device", device, "--skip-blast",
                        "--no-filter-by-annotation", fa])
    finally:
        os.chdir(cwd)
    if rc != 0:
        fail(f"fusion-post in {workdir} returned {rc}")
    return time.time() - t0


def phase_small_fusion(codes, devices=("cuda", "cpu")):
    """On the first 2^21 + 4096 bases, through the CLI on the card and on
    the CPU: a paired and a single-end TopHat-Fusion run (2,048 pairs,
    phase 10's design and flags with partners >= 1 Mb apart) and
    tophat-fusion-post over both; accepted_hits.sam, junctions.bed,
    fusions.out, potential_fusion.txt and result.txt must be
    byte-identical."""
    from tophat_tpu_torch.cli.main import main as cli_main

    small = codes[:(1 << 21) + 4096]
    juncs = pick_junctions(small, 16)
    breaks = pick_fusion_breaks(small, seed=53)
    m1, m2, fused = make_fusion_pairs(small, juncs, breaks, 55, SMALL_PAIRS)
    d = os.path.join(CACHE, "fusion_slice")
    os.makedirs(d, exist_ok=True)
    fa = os.path.join(d, "genome.fa")
    write_fasta(fa, small)
    fq1, fq2 = (os.path.join(d, f"pairs_{k}.fq") for k in (1, 2))
    write_fastq(fq1, m1, "p")
    write_fastq(fq2, m2, "p")
    post_s = {}
    for dev in devices:
        t0 = time.time()
        for sample, reads in (("paired", [fq1, fq2]), ("single", [fq1])):
            cli_main_checked(cli_main, ["-o", os.path.join(
                d, dev, f"tophat_{sample}"), "--device", dev] + FUSION_FLAGS
                + [fa] + reads)
        post_s[dev] = run_fusion_post(os.path.join(d, dev), fa, dev)
        log(f"small fusion runs + fusion-post on {dev}: "
            f"{time.time() - t0:.1f} s")
    a, b = devices
    files = [os.path.join(f"tophat_{s}", f) for s in ("paired", "single")
             for f in ("accepted_hits.sam", "junctions.bed", "fusions.out")]
    files += [os.path.join("tophatfusion_out", f)
              for f in ("potential_fusion.txt", "result.txt")]
    for f in files:
        with open(os.path.join(d, a, f), "rb") as x, \
                open(os.path.join(d, b, f), "rb") as y:
            if x.read() != y.read():
                fail(f"small fusion runs: {f} differs between {a} and {b}")
    res = {}
    for s in ("paired", "single"):
        out = os.path.join(d, a, f"tophat_{s}")
        res[s] = fusion_recall(out, small, breaks, fused, SMALL_PAIRS)
        if res[s][2]:
            fail(f"small fusion run ({s}): designed breaks missing from "
                 f"fusions.out: {res[s][2]}")
    n_res = designed_in_result(os.path.join(d, a, "tophatfusion_out",
                                            "result.txt"), small, breaks,
                               fused)
    log(f"small input (2^21 + 4096 bases): paired and single-end fusion "
        f"runs and fusion-post byte-identical on {a} and {b}; break-read "
        f"recall {res['paired'][0]:.2f}% / {res['single'][0]:.2f}%, "
        f"junction-read recall {res['paired'][1]:.2f}% / "
        f"{res['single'][1]:.2f}% (paired / single); all {len(breaks)} "
        f"breaks in fusions.out; {n_res} in result.txt; fusion-post "
        + ", ".join(f"{k} {v:.1f} s" for k, v in post_s.items()))
    return dict(recall={s: res[s][:2] for s in res}, result_breaks=n_res,
                post_s=post_s)


def phase_fusion(codes, juncs, index):
    """TopHat-Fusion at full width: `tophat --fusion-search ... --tt-index`
    paired through the CLI on the phase-4 genome and index, 24 designed
    breaks (8 ff, 8 fr, 8 rf; partners >= 1 Mb apart) and 32,768 pairs
    of 2 x 100 bp in two chunk pairs: a run holding every realign call
    (sparse and dense) against its plain version, then a timed run with
    stage seconds, every realign call's R, E and L, and peak device
    memory; then tophat-fusion-post on the card over the timed run's
    tophat_<sample>/ dir. Fails if a designed break is missing from
    fusions.out, break-read or junction-read recall is under 100%, no
    realign kernel was launched, or result.txt holds no designed break."""
    import torch

    from tophat_tpu_torch.cli import main as cli_mod
    from tophat_tpu_torch.ops import events
    from tophat_tpu_torch.pipeline import fusion_stats
    from tophat_tpu_torch.pipeline import juncs as juncs_mod
    from tophat_tpu_torch.pipeline import paired as paired_mod
    from tophat_tpu_torch.pipeline import run as run_mod

    fa = os.path.join(CACHE, "genome_2p27.fa")
    t0 = time.time()
    breaks = pick_fusion_breaks(codes)
    reads = {}
    for tag, seed in (("check", 61), ("steady", 62)):
        m1, m2, fused = make_fusion_pairs(codes, juncs, breaks, seed,
                                          N_PAIRS)
        fqs = [os.path.join(CACHE, f"fusion_{tag}_{k}.fq") for k in (1, 2)]
        write_fastq(fqs[0], m1, "p")
        write_fastq(fqs[1], m2, "p")
        reads[tag] = (fqs, fused)
    log(f"fusion inputs: {len(breaks)} breaks, 2 x {N_PAIRS} pairs "
        f"({time.time() - t0:.1f} s)")
    argv = lambda out, fqs: (["-o", out, "--tt-index", index, "--batch-size",
                              str(BATCH)] + FUSION_FLAGS + [fa] + fqs)

    check = PathCheck()
    t0 = time.time()
    with RealignHooks(events, check):
        cli_main_checked(cli_mod.main, argv(os.path.join(
            CACHE, "fusion_check"), reads["check"][0]))
    log(f"fusion check run: {time.time() - t0:.1f} s; realign exact in "
        f"{len(check.shapes)} calls: " + ", ".join(check.shapes))
    if not any(c.startswith("dense") for c in check.shapes):
        fail("the fusion check run made no dense realign call")

    clock = StageClock()
    clock.wrap(cli_mod, "read_fasta", "read_fasta")
    clock.wrap(paired_mod, "_map_mate", "map (prep, align, segments, stitch)")
    clock.wrap(paired_mod, "discover_events",
               "discovery (junctions, indels, FF fusions)")
    clock.wrap(juncs_mod, "build_fusion_windows",
               "  of which FF fusion windows + scan")
    clock.wrap(juncs_mod, "scan_fusion_windows",
               "  of which FF fusion windows + scan")
    clock.wrap(paired_mod, "candidates_for_mate", "candidates")
    clock.wrap(run_mod, "realign_events_sparse", "  of which realign, sparse")
    clock.wrap(run_mod, "find_fr_fusions",
               "  of which FR/RF scan + realign_fr_events")
    clock.wrap(run_mod, "segment_event_hits",
               "  of which segment event hits (realign, dense)")
    clock.wrap(run_mod, "chain_stitch",
               "  of which chain stitch + cross-strand chains")
    clock.wrap(run_mod, "cross_strand_chains",
               "  of which chain stitch + cross-strand chains")
    clock.wrap(paired_mod, "accumulate_event_stats", "stats + filter")
    clock.wrap(paired_mod, "filter_junctions", "stats + filter")
    clock.wrap(paired_mod, "build_fusion_table", "fusion stats (fusions.out)")
    clock.wrap(fusion_stats.FusionTable, "add_pair",
               "fusion stats (fusions.out)")
    clock.wrap(fusion_stats.FusionTable, "write",
               "fusion stats (fusions.out)")
    calls = []
    work = os.path.join(CACHE, "fusion")
    out = os.path.join(work, "tophat_smoke")
    fqs, fused = reads["steady"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    realign_launches(reset=True)
    t0 = time.time()
    try:
        with RealignHooks(events, lambda kind, args, _: calls.append(
                realign_call_shape(kind, args))):
            cli_main_checked(cli_mod.main, argv(out, fqs))
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = realign_launches()
    finally:
        clock.restore()
    peak = torch.cuda.max_memory_allocated()
    stages = dict(clock.seconds)
    top = sum(v for k, v in stages.items() if not k.startswith(" "))
    stages["rest (FASTQ parse, selection, output)"] = wall - top
    recall_f, recall_j, missing = fusion_recall(out, codes, breaks, fused,
                                                N_PAIRS)
    n_fus = sum(1 for _ in open(os.path.join(out, "fusions.out")))
    log(f"fusion steady run: {wall:.2f} s, {N_PAIRS / wall:.1f} pairs/s; "
        f"{n_fus} fusions in fusions.out; realign launches {launches} "
        f"(dense, sparse); peak device memory {peak / 2**30:.3f} GiB")
    for k, v in stages.items():
        log(f"  stage {k}: {v:.3f} s" + calls_note(clock.calls.get(k)))
    log("  realign calls: " + ", ".join(calls))
    log(f"fusion: break-read recall {recall_f:.2f}% of {len(fused)} mate-1 "
        f"break reads; junction-read recall {recall_j:.2f}%; designed "
        f"breaks missing from fusions.out: {missing}")
    if missing:
        fail(f"fusion run: designed breaks missing from fusions.out: "
             f"{missing}")
    if recall_f < 100.0 or recall_j < 100.0:
        fail(f"fusion run: recall {recall_f:.2f}% (break reads), "
             f"{recall_j:.2f}% (junction reads) < 100%")
    if launches[0] == 0 or launches[1] == 0:
        fail(f"the fusion run launched the realign kernel's entries "
             f"{launches} (dense, sparse) times; both must run")

    post_s = run_fusion_post(work, fa, "cuda")
    n_res = designed_in_result(os.path.join(work, "tophatfusion_out",
                                            "result.txt"), codes, breaks,
                               fused)
    log(f"fusion-post: {post_s:.1f} s; {n_res} of {len(breaks)} designed "
        "breaks in result.txt")
    if n_res == 0:
        fail("fusion-post: result.txt holds no designed break")
    return dict(wall_s=wall, pairs_per_s=N_PAIRS / wall, launches=launches,
                path_err=check.err, realign_calls=calls,
                peak_device_bytes=peak, recall_break_reads_pct=recall_f,
                recall_junction_pct=recall_j, fusions_out_lines=n_fus,
                stages=stages, stage_calls=clock.calls, post_s=post_s,
                result_designed_breaks=n_res)


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
    phase_small_slice_modes(spliced["codes"])
    annotated = phase_annotated(spliced["codes"], spliced["juncs"],
                                spliced["index"])
    bowtie2 = phase_bowtie2(spliced["codes"], spliced["juncs"],
                            spliced["index"])
    small_fusion = phase_small_fusion(spliced["codes"])
    fusion = phase_fusion(spliced["codes"], spliced["juncs"],
                          spliced["index"])
    path_phases = (spliced, paired, annotated, bowtie2, fusion)

    print(json.dumps({
        "realign_cases": kernels,
        "spliced_reads_per_s": spliced["reads_per_s"],
        "spliced_steady_s": spliced["steady_s"],
        "spliced_junction_read_recall_pct": spliced["recall_pct"],
        "unspliced_reads_per_s": unspliced_rps,
        "paired": {k: v for k, v in paired.items() if k != "realign_calls"},
        "annotated": annotated, "bowtie2": bowtie2,
        "small_fusion": small_fusion, "fusion": fusion}), flush=True)
    main_case = next(k for k in kernels if (k["R"], k["E"], k["L"], k["q"])
                     == (8192, 69, 100, 0))     # the main path's shape
    print(json.dumps({"kernels": [{
        "name": "realign", "route": "cuda",
        "source": "tophat_tpu_torch/csrc/realign.cu",
        "replaces": "tophat_tpu/ops/pallas/realign_kernel.py:44",
        "launches": sum(sum(p["launches"]) for p in path_phases),
        "max_abs_err": max([p["path_err"] for p in path_phases]
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
