#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tophat_tpu_torch) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. the card's name and power limit (nvidia-smi); no CUDA -> exit 1
  2. build every kernel of the spliced main path from csrc/ (nvcc, sm_90a)
  3. each kernel against its plain torch version on the card, at the main
     path's shapes and wider (L = 25 to 1,000; at the annotated event
     count, L = 100 and 300, the latter held and its plain version timed
     on 256 rows; R = 1,024, E = 128 at L = 2,048 to 16,384, streamed,
     8,192 and 16,384 held and timed on 64 rows; R = 4,096, L = 100 at
     phase 17's two groups' E, held and timed on 64 rows), through the
     realign kernel's dense and sparse entries,
     demanding exact equality; kernel, sparse-entry and plain times, the
     bound and share of bound, and at L = 100 and 300 the conv1d
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
     intron in 25% of pairs): a run of 8,192 pairs holding every realign
     call against its plain version, then a timed run of 32,768 pairs
     with stage seconds; fails if mate-1 junction-read recall is under
     100% or that run launched no sparse realign kernel
  7. on a 2^21 + 4096-base slice: the paired default mode, a single-end
     run with the butterfly and microexon searches, and through the CLI a
     -G paired run (120 synthetic genes), a --b2 single-end run, a -C
     run from colorspace FASTQ and a paired run of the slice as three
     contigs in two contig groups (--max-index-bases) and a single-end
     run of 128 reads of 5,000 and 8,192 bp, on the card and on the CPU,
     which must write identical files
  8. TopHat's annotated default run through the CLI (-G genes.gtf
     --transcriptome-index, paired, coverage search on) on the phase-4
     genome: a synthetic annotation of 21,000 transcripts (~50,000
     introns) and 32,768 pairs; a run of 8,192 pairs that builds the
     transcriptome files and index and holds every realign call against
     its plain version, then a timed run of 32,768 pairs with stage
     seconds, E, every realign call's R and E and peak device memory;
     fails under 100% recall, with no sparse realign launch, or with
     E < 30,000
  9. bowtie2 mode (--b2 --no-coverage-search) single-end on the same
     genome, 32,768 reads (25% spliced, 10% with a 1-2 bp indel): a
     checked run, then a timed run with the gapped stage's seconds and
     placements; fails under 100% junction or indel-read recall or with
     no gapped placement
 10. TopHat-Fusion (--fusion-search ... --tt-index, paired) through the
     CLI on the same genome and index: 24 designed breaks (8 ff, 8 fr,
     8 rf, partners >= 1 Mb apart) and 32,768 pairs (10% with mate 1
     across a break, 10% spanning one, 20% with mate 1 across an
     intron): a run of 8,192 pairs holding every realign call (the sparse
     entry, over read rows and over every row's segments) against its
     plain version, then a timed run with stage seconds, every realign
     call's R, E and L and peak device memory, then tophat-fusion-post
     on the card; fails if a designed break is missing from fusions.out,
     break-read or junction-read recall is under 100%, the sparse entry
     was not launched or the dense one was, or result.txt holds no
     designed break. Phase 7 also runs a paired and a single-end fusion
     run and fusion-post on the slice, on the card and on the CPU, which
     must write identical files
 12. TopHat-Fusion with an annotation (phase 10's flags plus phase 8's
     -G genes.gtf --transcriptome-index), paired, 16,384 pairs of phase
     10's design: the chain path realigns every row's segments against
     ~50,000 events through the sparse entry; a timed run with E, the
     chain stage's seconds and peak device memory, every realign call
     then held against its plain version on up to 2,048 of its rows;
     fails below 100% break-read or junction-read recall, with a break
     missing from fusions.out, E < 30,000 or over 12 GiB of device memory
 11. the whole-genome (contig-group) path: the phase-4 genome as 8
     contigs of 2^24 bases through the CLI with --max-index-bases 2^25
     (4 groups, one resident on the card at a time) at the grouped
     design point (k = 13, sa_rate 4): 8,192 reads single-end without
     the coverage search, grouped (group indexes built in forked workers)
     and single-index, which must write identical files; then a timed
     run of 32,768 pairs in the paired default mode (coverage search on)
     with pairs/s, group swaps, each group's FMIndex bytes (B/base and
     the projection to a 3.1 Gbp genome in 2 groups) and peak device
     memory; every realign call of these runs held against its plain
     version; fails under 100% junction-read recall
 13. the mesh path (parallel/) on the card: the CLI with its device list
     replaced by cuda:0 repeated (one process drives every shard; the
     CPU tests repeat the CPU device the same way). (a) phase 6's timed
     run on a reads axis of 4 x cuda:0 (the realign kernel once per row
     shard and q-group), with stage seconds, pairs/s, every realign
     call's R and peak device memory; (b) 8,192 single-end reads without
     the coverage search over the phase-4 index range-sharded in 2
     (TOPHAT_TPU_GENOME_SHARDS=2, a 2 x 2 mesh), with the sub-index build
     seconds and bytes. Both must write their one-device run's files
     (phase 6's for (a)); every realign call of both is held against its
     plain version on up to 2,048 of its rows; fails on a byte
     difference, under 100% junction-read recall or with no sparse
     realign launch
 14. the annotated run at 2 x 300 bp (MiSeq v3's read profile): phase 8's
     flags with --no-coverage-search, on phase 8's genome, annotation and
     transcriptome index (reused): 2,048 pairs holding every realign call
     (each 300 positions wide, the kernel's shift-code operands) against
     its plain version on up to 1,024 of its rows, then a timed run of
     8,192 pairs with pairs/s, stage seconds, every realign call's R, E,
     L and q, the realign stage's seconds and peak device memory; fails
     if a call is not 300 wide or under 100% recall (annotated-junction
     mates, unannotated-intron mates 1)
 15. reads of any length: the single-end CLI (--no-coverage-search) on
     the phase-4 genome and index, reads of 5,000 and 8,192 bp (full-
     length cDNA, assembled transcripts), 25% across a phase-4 intron: a
     run of 512 reads holding every realign call against its plain
     version on up to 256 of its rows, then a timed run of 2,048 reads
     with reads/s, stage seconds, every realign call's R, E, L and q and
     peak device memory, its calls held the same way; fails if no
     realign call is wider than 4,096, no sparse realign was launched, or
     under 100% junction-read recall
 16. a human-scale genome: 24 contigs in hg19's size order (3,093,000,000
     random bases, 48 planted GT..AG introns of 100-5,000 bp, 22 of them
     on contigs that begin past 2^31), single-end through the CLI
     (--no-coverage-search --tt-index, the default --max-index-bases: 2
     contig groups, chr1-11 and chr12-24, k = 13, sa_rate 4). A child
     process started before phase 2 (chip_smoke.py --human-build) writes
     the FASTA and builds the group indexes under the CLI's cache prefix
     while phases 2-15 run; the phase waits for it, then a timed run of
     16,384 reads records reads/s, stage seconds, group loads and swaps,
     each group's FMIndex bytes on the card, peak device and host memory
     and every realign call, each held after the run against its plain
     version on up to 2,048 of its rows; fails
     with other than 2 groups, under 100% junction-read recall, with a
     designed intron missing from junctions.bed at its contig-local
     coordinates, a contiguous read not at its contig and POS, no read on
     a contig past 2^31, no sparse realign launch or any dense one, or the
     genome axis started
 17. TopHat's annotated paired default run on the human-scale genome
     (-G genes.gtf --transcriptome-index ... --tt-index, coverage search
     on, 2 contig groups): phase 16's genome, FASTA and group indexes; a
     synthetic GTF with GENCODE 19's counts (57,820 genes, 196,520
     transcripts, ~378,000 distinct introns, a third of the genes past
     2^31) and its transcriptome files and index, which the build child
     writes after the groups; pairs of 2 x 100 bp (50% transcript
     fragments, 10% with mate 1 across a phase-16 intron, the rest
     contiguous). A run of 4,096 pairs holds every realign call against
     its plain version on up to 2,048 of its rows; a timed run of 16,384
     pairs records pairs/s, stage seconds, group swaps, E, every realign
     call, peak device and host memory, the concordant share and whether
     the coverage search's event cap bound; fails with other than 2
     groups, under 100% recall (annotated-junction mates,
     unannotated-intron mates 1), a crossed planted intron missing from
     junctions.bed or a crossed annotated one past 2^31 placed by no
     record's CIGAR, at its contig-local coordinates, no mate placed past
     2^31, E < 300,000, no
     sparse realign launch or any dense one, or the genome axis started
 18. TopHat-Fusion on the human-scale genome, both entry points as its
     manual gives them: the CLI with FUSION_FLAGS (paired, 2 contig
     groups, no --tt-index: the group caches are found beside the FASTA,
     where symlinks to the build child's files put them), then
     tophat-fusion-post on the card, whose kmer map runs over the same
     group caches. 24 designed breaks within the groups (12 a group, 10
     of the last group's past 2^31, half between two contigs) and 4
     across them (chr9-chr22 among them; no package finds those, and
     their count is only recorded); pairs of phase 10's design. A timed
     run of 16,384 pairs records pairs/s, stage seconds, chain seconds per
     group, group transfers, E per group, every realign call (each held
     after the run against its plain version on up to 2,048 of its rows),
     peak device and host memory, then fusion-post's seconds by stage. It
     runs right after phase 16, beside the build child's phase-17 inputs.
     Fails with other than 2 groups, a
     group index built by either CLI, under 100% break-read or
     junction-read recall, a within-group designed break missing from
     fusions.out at its contig-local coordinates, no designed break in
     result.txt, no sparse realign launch or any dense one, or the
     genome axis started
 19. the JAX package's own benchmark design point (bench.py): one index
     over a 2^30-base random genome (seed 7) with a k = 14 seed table and
     a full SA, built on the host by the port's build_fm_index in a
     process the phase-16 build child starts once its groups are built
     (chip_smoke.py --bench-build; it also writes the genome's FASTA,
     picks bench.py's 64 natural GT..AG introns and writes (b)'s reads).
     (b) the single-end CLI (--no-coverage-search --tt-index) on the FASTA
     and that index, 8,192 reads (25% across an intron); its FMIndex.load
     is the phase's one load, and (a) and (c) run on the index it put on
     the card. (a) bench.py's unspliced run: 25 batches of 16,384 x 100 bp
     through align_reads_adaptive with its arguments (narrow 6, wide 32,
     resolve_cap 1, uniform_len 100, defer=True), one warm batch and 24
     dispatched back to back under torch.cuda.set_sync_debug_mode("error")
     with one final sync (the in-program tier); then the exact call
     (truncated rows read back and re-run) and the narrow tier alone on
     the same batches; (c) bench.py's spliced run through run_pipeline on
     the resident index (32,768 reads, --no-coverage-search): one warm and
     two timed runs, stage seconds, E, every realign call, peak device and
     host memory. Fails if the index is not that design point, under 99%
     of the warm batch aligned, on a host sync in the deferred loop, if a
     deferred row differs from the exact call without being flagged
     truncated (or the checksums differ with no row past the wide
     budget), if the CLI builds an index or does not reuse the built one,
     under 100% junction-read recall in (b) or (c), with no sparse
     realign launch or any dense one, or if a realign call of (b) or (c)
     disagrees with its plain version on up to 2,048 of its rows
Phases run in the order 1-10, 12, 11, 13, 14, 15, 16, 18, 17, 19.
Launches in the kernels line are summed over phases 4, 6, 8, 9, 10, 11,
12, 13, 14, 15, 16, 17, 18 and 19 (each counted from 0 just before its
timed run; in phase 19 the faster timed run of (c) and the run of (b)),
max_abs_err over every check.
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
CHECK_PAIRS = 8192          # the checked runs of phases 6, 8 and 10
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
LONG_READ_LEN = 300         # MiSeq v3's 2 x 300 bp (phase 14)
HUMAN_GROUP_E = (240768, 140930)  # phase 17's event tables as measured,
#                                   one a group
# Phase 3's (R, E, L, q): the main path's widths, then wider rows (150-bp
# reads on one-hot operands; 300 and 1,000 positions on shift codes), the
# main path's own shape, an event table of a real transcriptome's size,
# the annotated run's (phase 8) own shape, the fusion run's (phase 10)
# dense call over every row's segments; then 257 positions (the first
# width past one-hots), 512, phase 14's annotated long-read shape, and
# rows past the 64-row tile, whose operands stream: 2,048 and 4,096
# (where the kernel once kept one- and two-warp tiles whole), 4,097 (past
# the 4,096 its argmin once packed), 8,192 (phase 15's width) and 16,384;
# last, phase 17's two groups' event tables at its read rows.
REALIGN_CASES = [
    (16384, 128, 100, 0), (16384, 128, 100, 3), (16384, 128, 25, 0),
    (8192, 128, 150, 0), (8192, 128, 300, 3), (8192, 128, 1000, 0),
    (8192, 69, 100, 0), (8192, 4096, 100, 0), (4096, ANNOTATED_E, 100, 0),
    (65536, 76, 25, 0), (8192, 128, 257, 0), (8192, 128, 512, 3),
    (4096, ANNOTATED_E, LONG_READ_LEN, 0), (1024, 128, 2048, 0),
    (1024, 128, 4096, 3), (1024, 128, 4097, 0), (1024, 128, 8192, 3),
    (1024, 128, 16384, 0)] + [(4096, E, 100, 0) for E in HUMAN_GROUP_E]
PLAIN_WORK = 3e12           # R E L^2 above which the plain version holds a
#                             row subset (its 2 R E 8 L per split)
PLAIN_ROWS = 256            # rows held and timed there (64 past L = 4,096
#                             or past the annotated E)
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

    cases = REALIGN_CASES
    report = []
    for ci, (R, E, L, q) in enumerate(cases):
        shape = f"R={R} E={E} L={L} q={q}"
        args = realign_case(R, E, L, q, seed=11 + ci)
        valid = torch.as_tensor(
            np.random.default_rng(ci).random(E) < 0.9, device="cuda")
        got = realign_group(*args, q, 8)
        got_s = realign_group_sparse(*args, q, 8, valid)
        held, rows = args, None
        if R * E * L * L <= PLAIN_WORK:
            ref = realign_plain(*args, q, 8)
            ref_s = pack_sparse(ref[0], ref[1], ref[2] & valid[None, :])
            torch.cuda.synchronize()
            err = max_err(got, ref)
            n_ok = int(ref[2].sum())
            if err or not all(torch.equal(a, b) for a, b in zip(got, ref)):
                fail(f"realign kernel disagrees with its plain version at "
                     f"{shape} (max abs err {err})")
            if not torch.equal(got_s, ref_s):
                fail(f"sparse realign entry disagrees with the packed plain "
                     f"result at {shape} ({got_s.shape[1]} vs "
                     f"{ref_s.shape[1]} records)")
        else:
            # the annotated long-read shape and the widest rows: the plain
            # version's R E (L - 1) products and (R, E) int64 tables, held
            # and timed on rows
            rows = np.sort(np.random.default_rng(ci).choice(
                R, PLAIN_ROWS if L <= 4096 and E <= ANNOTATED_E else 64,
                replace=False))
            err, _ = hold_realign("dense", args + (q, 8), got, rows)
            hold_realign("sparse", args + (q, 8, valid), got_s, rows)
            sel = torch.as_tensor(rows, device="cuda")
            held = (args[0][sel].contiguous(), args[1][sel].contiguous(),
                    args[2], args[3])
            n_ok = int(realign_plain(*held, q, 8)[2].sum())
        if n_ok < held[0].shape[0] // 4:
            fail(f"realign case {shape}: only {n_ok} ok pairs; the check "
                 "input is degenerate")
        iters = 20 if L <= 300 and rows is None else 3
        ms = cuda_ms(lambda: realign_group(*args, q, 8), iters)
        sparse_ms = cuda_ms(lambda: realign_group_sparse(*args, q, 8, valid),
                            iters)
        plain_ms = cuda_ms(lambda: realign_plain(*held, q, 8),
                           2 if E > 1000 else 3)
        bound_ms, bound_by = realign_bound(args[1], R, E, L, q)
        row = dict(R=R, E=E, L=L, q=q, max_abs_err=err, ms=ms,
                   sparse_ms=sparse_ms, plain_ms=plain_ms,
                   plain_rows=held[0].shape[0], bound_ms=bound_ms,
                   bound_by=bound_by, share_of_bound=bound_ms / ms,
                   library_ms=None, library_exact=None)
        if L in (100, LONG_READ_LEN) and R * E * (L + 1) * 2 < 16e9:
            # (the yardstick's fp16 (E, R, L + 1) match volume: 41 GB at
            # the annotated run's shape, so no yardstick there)
            lib = conv_yardstick(*args, q, 8)
            row["library_exact"] = all(torch.equal(a, b)
                                       for a, b in zip(lib, ref))
            del lib
            row["library_ms"] = cuda_ms(lambda: conv_yardstick(*args, q, 8),
                                        2 if E > 1000 else 5)
            torch.cuda.empty_cache()
        log(f"realign {shape}: exact, dense and sparse ({n_ok} ok pairs"
            + ("" if rows is None else f" in {len(rows)} rows held") + "); "
            f"kernel {ms:.4f} ms (sparse entry {sparse_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms" + ("" if rows is None else
                                   f" on {len(rows)} rows")
            + f", bound {bound_ms:.4f} ms ({bound_by}), "
            f"share of bound {100 * bound_ms / ms:.1f}%"
            + ("" if row["library_ms"] is None else
               f"; conv1d yardstick {row['library_ms']:.4f} ms ("
               + ("exact" if row["library_exact"] else "NOT exact") + ")"))
        report.append(row)
    return report


def realign_launches(reset: bool = False):
    """(dense, sparse) launch counts of the realign kernel's two entries,
    from the port's tracer counters (relaunches included); reset=True
    clears the tracer first."""
    from tophat_tpu_torch.utils import trace

    if reset:
        trace.reset()
    c = trace.snapshot()["counters"]
    dense = c.get("realign.dense_launches", 0)
    return dense, c.get("realign.launches", 0) - dense


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


def hold_realign(kind, args, got, rows=None):
    """Hold one realign call of the main path against realign_plain:
    a dense call's tables directly; a sparse call's records against
    pack_sparse of the plain tables, and the dense entry on the same
    inputs too. The plain version runs on slices of E_SLICE events (its
    (R, E) int64 tables at an annotation's E would take tens of GB).
    rows (sorted, unique): hold only these read rows of the call (the
    call's records of these rows, renumbered in their order). Returns
    (max abs error of the dense tables, the call's shape)."""
    import torch

    from tophat_tpu_torch.ops.realign_kernel import (pack_sparse,
                                                     realign_group,
                                                     realign_plain)

    shape = realign_call_shape(kind, args)
    if rows is not None:
        sel = torch.as_tensor(rows, dtype=torch.long, device=got[0].device)
        if kind == "sparse":
            got = got[:, torch.isin(got[0].long(), sel)].clone()
            got[0] = torch.searchsorted(sel, got[0].long()).int()
        else:
            got = tuple(x[sel] for x in got)
        args = ((args[0][sel].contiguous(), args[1][sel].contiguous())
                + tuple(args[2:]))
        shape += f" (rows held: {len(rows)})"
    reads, lengths, flank_l, comb, q, max_mm = args[:6]
    R, E = reads.shape[0], flank_l.shape[0]
    dense = got if kind == "dense" else realign_group(*args[:6])
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
    and each call's shape. With max_rows, a call of more rows is held on
    a subset of them (hold_rows)."""

    def __init__(self, max_rows: int = 0):
        self.err, self.shapes, self.max_rows = 0, [], max_rows

    def __call__(self, kind, args, out):
        rows = None
        if self.max_rows and args[0].shape[0] > self.max_rows:
            rows = hold_rows(kind, out, args[0].shape[0], self.max_rows)
        err, shape = hold_realign(kind, args, out, rows)
        self.err = max(self.err, err)
        self.shapes.append(shape)


def keep_calls(kept: list):
    """RealignHooks' on_call for a timed run: appends a copy of each
    call's (kind, inputs, output) to `kept`, to be held by a PathCheck
    after the run."""
    import torch

    def on_call(kind, args, out):
        kept.append((kind, tuple(a.clone() if torch.is_tensor(a) else a
                                 for a in args),
                     out.clone() if kind == "sparse"
                     else tuple(o.clone() for o in out)))
    return on_call


def hold_rows(kind, out, R: int, n: int, seed: int = 0):
    """Sorted rows of a realign call to hold when it has too many for the
    plain version: half of them spread evenly over the rows that have ok
    records (a sparse call's records, a dense call's ok table), the rest
    drawn at random."""
    import torch

    has = torch.unique(out[0] if kind == "sparse"
                       else torch.nonzero(out[2].any(1))[:, 0]).cpu().numpy()
    pick = has[np.linspace(0, len(has) - 1, min(len(has), n // 2)).astype(
        np.int64)] if len(has) else has
    rand = np.random.default_rng(seed).choice(R, n - len(pick), replace=False)
    return np.unique(np.concatenate([pick, rand]).astype(np.int64))


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


def write_fasta(path, codes, width: int = 4096, cuts=(0,)):
    """FASTA of `codes`; contig chr<i + 1> starts at cuts[i]. Whole lines
    go out in blocks of 4,096 (a 3 Gbp genome in seconds)."""
    lut = np.frombuffer(b"ACGTN", np.uint8)
    ends = list(cuts[1:]) + [len(codes)]
    block = 4096 * width
    with open(path, "wb") as f:
        for i, (a, b) in enumerate(zip(cuts, ends)):
            f.write(b">chr%d\n" % (i + 1))
            whole = a + (b - a) // width * width
            for s in range(a, whole, block):
                e = min(s + block, whole)
                lines = np.empty(((e - s) // width, width + 1), np.uint8)
                lines[:, :width] = lut[codes[s:e]].reshape(-1, width)
                lines[:, width] = ord("\n")
                f.write(lines.tobytes())
            if whole < b:
                f.write(lut[codes[whole:b]].tobytes() + b"\n")


def write_fastq(path, seqs, prefix: str = "r"):
    """FASTQ of `seqs` (rows of codes, or a list of them of any lengths)."""
    lut = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b"@%s%d\n%s\n+\n%s\n" % (prefix.encode(), i,
                                            lut[s].tobytes(), b"I" * len(s)))


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

def unspliced_batch(codes, seed: int, batch: int = BATCH):
    """bench.py's make_batch: `batch` reads of READ_LEN drawn uniformly,
    two substitutions each, half of them reverse-complemented. Returns
    numpy (reads_f, reads_r, lengths)."""
    from tophat_tpu_torch.index.fasta import revcomp

    r = np.random.default_rng(seed)
    starts = r.integers(0, len(codes) - READ_LEN, batch)
    reads = codes[starts[:, None] + np.arange(READ_LEN)].copy()
    for _ in range(2):
        p = r.integers(0, READ_LEN, batch)
        reads[np.arange(batch), p] = (
            reads[np.arange(batch), p] + r.integers(1, 4, batch)) % 4
    flip = r.random(batch) < 0.5
    rf = np.where(flip[:, None], revcomp(reads), reads).astype(np.int8)
    rr = revcomp(rf).copy().astype(np.int8)
    return rf, rr, np.full(batch, READ_LEN, np.int32)


def phase_unspliced(index_path, codes):
    import torch

    from tophat_tpu_torch.index.fm import FMIndex
    from tophat_tpu_torch.ops.align import align_reads_adaptive, kmer_fast_ok

    dev = torch.device("cuda")
    fm = FMIndex.load(index_path, device=dev)
    offsets = torch.tensor([0, fm.n], device=dev)
    fast = kmer_fast_ok(fm, READ_LEN, 2)
    batches = [tuple(torch.as_tensor(x, device=dev)
                     for x in unspliced_batch(codes, 100 + i))
               for i in range(UNSPLICED_ITERS + 1)]
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

def make_pairs(codes, juncs, seed: int, n_pairs: int, cut: int = 0):
    """Mate pairs of 2 x READ_LEN bp. The inner distance is drawn from
    N(50, 20) (TopHat's -r / --mate-std-dev defaults), clipped at 0; mate 2
    is the reverse complement downstream of mate 1. In 25% of pairs (p0,
    p4, ...) mate 1 crosses one of `juncs` with >= 20 bp on each side; the
    other pairs are contiguous with one mismatch in each mate. With `cut`,
    no contiguous pair crosses a multiple of it (contigs of `cut` bases;
    the caller picks `juncs` whose pairs stay inside one)."""
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
            while cut and s // cut != (s + 2 * L + inner - 1) // cut:
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
    each call, and notes the running peak of device memory at each call's
    end (peak_stage)."""

    def __init__(self):
        self.seconds = {}
        self.calls = {}
        self.marks = []         # (stage, running device peak) per call end
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
                self.marks.append((label, torch.cuda.max_memory_allocated()))

        setattr(owner, name, timed)
        self._undo.append((owner, name, saved))

    def peak_stage(self, peak: int):
        """The first stage by whose end the running device peak had
        reached `peak` (it, or unclocked code just before it, set the
        peak); None if no clocked stage had."""
        return next((label for label, p in self.marks if p >= peak), None)

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
    for tag, seed, n in (("check", 15, CHECK_PAIRS), ("steady", 16, N_PAIRS)):
        m1, m2 = make_pairs(codes, juncs, seed, n)
        fqs[tag] = [os.path.join(CACHE, f"pairs_{tag}_{k}.fq") for k in (1, 2)]
        write_fastq(fqs[tag][0], m1, "p")
        write_fastq(fqs[tag][1], m2, "p")
    log(f"paired inputs: {CHECK_PAIRS} + {N_PAIRS} pairs of 2 x {READ_LEN} bp "
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


def exon_chain(rng, starts, ends, s: int, k: int):
    """k exons of 50-300 bp from base s, joined by introns of 70-5,000 bp
    (log-uniform) at the sorted intron-start and intron-end motif
    positions `starts` and `ends` (GT and AG for a '+' gene): [(start,
    end), ...] 0-based; fewer than k where the motifs run out."""
    exons = []
    for _ in range(k - 1):
        lo = np.searchsorted(starts, s + 50)
        hi = np.searchsorted(starts, s + 301)
        if hi <= lo:
            return exons
        d = int(starts[int(rng.integers(lo, hi))])      # intron start
        target = int(np.exp(rng.uniform(np.log(70), np.log(5000))))
        a_lo = np.searchsorted(ends, d + max(target, 70) - 2)
        if a_lo >= len(ends) or ends[a_lo] + 2 - d > 5000:
            return exons
        exons.append((s, d))
        s = int(ends[a_lo]) + 2                         # next exon start
    exons.append((s, s + int(rng.integers(50, 301))))
    return exons


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
        k = int(rng.integers(3, 9))
        exons = exon_chain(rng, *motifs[strand], p, k)
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


def make_annotated_pairs(codes, transcripts, juncs, seed: int, n_pairs: int,
                         L: int = READ_LEN, offsets=None, crossed=None):
    """Mate pairs of 2 x L bp for the annotated run, inner distance from
    N(50, 20) clipped at 0, mate 2 the reverse complement downstream of
    mate 1: in 50% of pairs (i % 10 < 5) both mates are a fragment of an
    annotated transcript long enough to hold it (in transcript space,
    mates swapped in every other such pair); in 10% (i % 10 == 5) mate 1
    crosses one of `juncs` (none annotated) with >= 20 bp on each side;
    the rest are contiguous with one mismatch per mate (with contig
    `offsets`, none across a contig end). A dict `crossed` maps (left,
    right, annotated) of every intron a designed mate crosses to the
    [(pair, mate 1 or 2), ...] that cross it. Returns
    (m1, m2, spans (n, 2) bool: the mate crosses an annotated junction,
    unannotated (n,) bool)."""
    from tophat_tpu_torch.index.fasta import revcomp

    r = np.random.default_rng(seed)
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
            swap = (i // 10) % 2
            if crossed is not None:
                ex = transcripts[ti]
                for at, mate in ((s, 1 + swap), (e2, 2 - swap)):
                    for j in np.nonzero((cuts[ti] > at)
                                        & (cuts[ti] < at + L))[0]:
                        crossed.setdefault((ex[j][1] - 1, ex[j + 1][0], True),
                                           []).append((i, mate))
            if swap:
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
            if crossed is not None:
                crossed.setdefault((left, right, False), []).append((i, 1))
        else:
            while True:
                s = int(r.integers(0, len(codes) - 3 * L - 400))
                if offsets is None:
                    break
                c = int(np.searchsorted(offsets, s, side="right")) - 1
                if s + 3 * L + 400 <= offsets[c + 1]:
                    break
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


SLICE_CUTS = (0, 700_000, 1_400_000)   # phase 7's grouped case: 3 contigs
SLICE_GROUP_BASES = 1_500_000           # -> 2 groups (2 contigs, 1)
SMALL_LONG_READS = 128                  # phase 7's reads of 5,000 / 8,192 bp


def phase_small_slice_modes(codes, devices=("cuda", "cpu")):
    """On the first 2^21 + 4096 bases, through the CLI on the card and on
    the CPU: a -G paired run (120 synthetic genes, 2,048 pairs, the
    coverage search on), a --b2 single-end run (2,048 reads, 10% with a
    1-2 bp indel), a -C single-end run from colorspace FASTQ (2,048
    reads, a third with a color error), a grouped paired run (the
    slice as three contigs under --max-index-bases, two contig groups,
    default mode, the -G run's pairs) and a single-end run of 128 reads
    of 5,000 and 8,192 bp without the coverage search (phase 15's
    design: realign rows 8,192 wide). Colorspace is held only here: a
    full-width run would build a second 2^27-base index for a legacy
    input. Every output file must be byte-identical."""
    from tophat_tpu_torch.cli.main import main as cli_main

    small = codes[:(1 << 21) + 4096]
    juncs = pick_junctions(small, 16)
    d = os.path.join(CACHE, "slice")
    os.makedirs(d, exist_ok=True)
    fa = os.path.join(d, "genome.fa")
    write_fasta(fa, small)
    fa3 = os.path.join(d, "genome_3c.fa")
    write_fasta(fa3, small, cuts=SLICE_CUTS)
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
    long_fq = os.path.join(d, "long.fq")
    write_fastq(long_fq, make_long_single_reads(small, juncs, 41,
                                                SMALL_LONG_READS))
    runs = {"gtf": ["-G", gtf, fa, fq1, fq2],
            "b2": ["--b2", "--no-coverage-search", fa, b2_fq],
            "color": ["-C", "--no-coverage-search", fa, color_fq],
            "grouped": ["--max-index-bases", str(SLICE_GROUP_BASES), fa3,
                        fq1, fq2],
            "long": ["--no-coverage-search", fa, long_fq]}
    for dev in devices:
        t0 = time.time()
        for name, args in runs.items():
            cli_main_checked(cli_main, ["-o", os.path.join(d, f"{name}_{dev}"),
                                        "--device", dev] + args)
        log(f"small -G / --b2 / -C / grouped / long-read runs on {dev}: "
            f"{time.time() - t0:.1f} s")
    a, b = devices
    for dev in devices:
        with open(os.path.join(d, f"grouped_{dev}", "logs",
                               "tophat.log")) as f:
            if "partitioned into 2 contig groups" not in f.read():
                fail(f"small grouped run on {dev}: not 2 contig groups")
    for name in runs:
        for f in ("accepted_hits.sam", "junctions.bed", "insertions.bed",
                  "deletions.bed") + (("align_summary.txt",)
                                      if name in ("gtf", "grouped") else ()):
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
    recall_long = junction_recall(os.path.join(d, f"long_{a}",
                                               "accepted_hits.sam"),
                                  SMALL_LONG_READS)
    if missed or missed_b2 or missed_c or recall_long < 100.0:
        fail(f"small -G / --b2 / -C / long-read runs: {missed} annotated-"
             f"junction or intron mates, {missed_b2} --b2 junction or indel "
             f"reads, {missed_c} error-free contiguous colorspace reads "
             f"missed; long-read junction recall {recall_long:.2f}%")
    log(f"small input (2^21 + 4096 bases): -G paired, --b2, -C, grouped "
        f"paired (3 contigs, 2 groups) and long-read single-end "
        f"({SMALL_LONG_READS} reads of "
        f"{' and '.join(map(str, LONG_SE_LENS))} bp) runs byte-identical on "
        f"{a} and {b}; recall 100% (-G, --b2, long reads); "
        f"{n_color}/{SMALL_PAIRS} colorspace reads aligned")


N_GENES = 8400             # phase 8: 21,000 transcripts
MIN_EVENTS = 30000         # phase 8 fails with fewer events


def reads_on_transcripts(log_path) -> int:
    """Reads placed on annotated transcripts, summed over a run's mates
    and chunks (the transcriptome stage's lines in its tophat.log, of
    the single-index or the grouped mapper)."""
    n = 0
    with open(log_path) as f:
        for line in f:
            if "transcriptome map: " in line and " reads placed" in line:
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
    mates 1), no sparse realign was launched, or E < 30,000. Returns (the
    numbers, the annotation's transcripts)."""
    from tophat_tpu_torch.cli import main as cli_mod
    from tophat_tpu_torch.ops import events

    fa = os.path.join(CACHE, "genome_2p27.fa")
    t0 = time.time()
    gtf_text, transcripts, introns = make_annotation(codes, juncs, N_GENES)
    gtf = os.path.join(CACHE, "genes.gtf")
    with open(gtf, "w") as f:
        f.write(gtf_text)
    reads = {}
    for tag, seed, n in (("check", 41, CHECK_PAIRS), ("steady", 42, N_PAIRS)):
        m1, m2, spans, unannotated = make_annotated_pairs(
            codes, transcripts, juncs, seed, n)
        fqs = [os.path.join(CACHE, f"annot_{tag}_{k}.fq") for k in (1, 2)]
        write_fastq(fqs[0], m1, "p")
        write_fastq(fqs[1], m2, "p")
        reads[tag] = (fqs, spans, unannotated)
    log(f"annotated inputs: {N_GENES} genes, {len(transcripts)} transcripts, "
        f"{len(introns)} distinct introns; {CHECK_PAIRS} + {N_PAIRS} pairs "
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

    res = annotated_timed_run("annotated", argv,
                              os.path.join(CACHE, "annot_out_steady"),
                              reads["steady"], N_PAIRS)
    if res["launches"][1] == 0:
        fail("the annotated run never launched the sparse realign kernel")
    if res["events"] < MIN_EVENTS:
        fail(f"annotated run: E = {res['events']} < {MIN_EVENTS} events")
    recall = res["recall_annotated_pct"], res["recall_unannotated_pct"]
    if min(recall) < 100:
        fail(f"annotated run: recall {recall[0]:.2f}% (annotated), "
             f"{recall[1]:.2f}% (unannotated) < 100%")
    res["stage_calls"].update(build.calls)
    return dict(res, transcripts=len(transcripts), introns=len(introns),
                path_err=check.err, build_stages=build.seconds), transcripts


def annotated_recall(out, spans, unannotated):
    """(annotated-junction mate recall %, unannotated-intron mate-1
    recall %, annotated-junction mates) of a run of make_annotated_pairs'
    pairs: a mate counts when it has a record with an N in its CIGAR."""
    got = n_cigar_reads(os.path.join(out, "accepted_hits.sam"))
    n_span = int(spans.sum())
    missed_a = sum(1 for i, m in zip(*np.nonzero(spans))
                   if (f"p{i}", int(m) + 1) not in got)
    missed_u = sum(1 for i in np.nonzero(unannotated)[0]
                   if (f"p{i}", 1) not in got)
    return (100.0 * (n_span - missed_a) / n_span,
            100.0 * (1 - missed_u / int(unannotated.sum())), n_span)


def annotated_timed_run(tag, argv, out, reads, n_pairs: int, kept=None):
    """One timed annotated run through the CLI, argv(out, FASTQs) on
    reads = (FASTQs, spans, unannotated) from make_annotated_pairs: stage
    seconds (a synchronize around
    each stage), E, every realign call's R, E, L and q, launches, peak
    device memory, reads placed on transcripts and recall
    (annotated-junction mates, unannotated-intron mates 1), logged and
    returned. With a list `kept`, each realign call is also kept there
    (keep_calls), to be held after the run."""
    import types

    import torch

    from tophat_tpu_torch.cli import main as cli_mod
    from tophat_tpu_torch.index.fm import FMIndex
    from tophat_tpu_torch.ops import events
    from tophat_tpu_torch.pipeline import paired as paired_mod
    from tophat_tpu_torch.pipeline import run as run_mod

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
    calls, widths = [], set()
    keep = keep_calls(kept) if kept is not None else None

    def on_call(kind, args, got):
        widths.add(int(args[0].shape[1]))
        calls.append(realign_call_shape(kind, args))
        if keep:
            keep(kind, args, got)

    fqs, spans, unannotated = reads
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    realign_launches(reset=True)
    t0 = time.time()
    try:
        with RealignHooks(events, on_call):
            cli_main_checked(cli_mod.main, argv(out, fqs))
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = realign_launches()
    finally:
        paired_mod.SingleIndexMapper.finalize_events = finalize
        clock.restore()
        cli_mod.FMIndex = saved_fm
    peak = torch.cuda.max_memory_allocated()

    recall_a, recall_u, n_span = annotated_recall(out, spans, unannotated)
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
    calls_of = dict(clock.calls)
    calls_of["transcriptome map (align + rebase)"] = calls_of.pop(
        " transcriptome map", 0)
    calls_of["map: genome (prep, full-read align, segments, stitch)"] = \
        calls_of.pop("map", 0)
    E = n_events[0] if n_events else 0
    realign_s = stages.get("  of which realign, sparse", 0.0)
    log(f"{tag} steady run: {wall:.2f} s, {n_pairs / wall:.1f} pairs/s; "
        f"E={E}; {placed} reads placed on transcripts; realign "
        f"{realign_s:.3f} s ({100 * realign_s / wall:.1f}% of the run), "
        f"launches {launches} (dense, sparse); peak device memory "
        f"{peak / 2**30:.3f} GiB")
    for k, v in stages.items():
        log(f"  stage {k}: {v:.3f} s" + calls_note(calls_of.get(k)))
    log("  realign calls: " + ", ".join(calls))
    log(f"{tag}: recall {recall_a:.2f}% of {n_span} annotated-junction "
        f"mates, {recall_u:.2f}% of {int(unannotated.sum())} unannotated-"
        f"intron mates 1; concordant "
        f"{100.0 * (aligned - disc) / n_pairs:.2f}% of pairs")
    return dict(wall_s=wall, pairs_per_s=n_pairs / wall, events=E,
                reads_on_transcripts=placed, launches=launches,
                realign_calls=calls, realign_widths=sorted(widths),
                realign_s=realign_s, peak_device_bytes=peak,
                recall_annotated_pct=recall_a,
                recall_unannotated_pct=recall_u,
                concordant_pct=100.0 * (aligned - disc) / n_pairs,
                stages=stages, stage_calls=calls_of)


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
SEGMENT_L = 25             # --segment-length: the chain path's row width


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


def make_fusion_pairs(codes, juncs, breaks, seed: int, n_pairs: int,
                      offsets=None, cross=()):
    """Mate pairs of 2 x READ_LEN bp, inner distance |N(0, 80)|, mate 2
    the reverse complement of the fragment's other end: in 10% of pairs
    (i % 10 == 0) mate 1 crosses a break of `breaks` 30-70 bp in (the
    fragment goes on along the second partner); in 10% (i % 10 == 1) the
    break lies between the mates (mate 1 on the first partner, mate 2 on
    the second); in 20% (i % 10 in 2, 3) mate 1 crosses one of `juncs`
    with >= 20 bp on each side; the rest are contiguous with one mismatch
    per mate (with contig `offsets`, none across a contig end), but for
    2% of all pairs (i % 50 == 4) given `cross` breaks, which go to
    those, in turn as a read across the break and a pair around it.
    Returns (m1, m2, {i: (dir, a, b, t)} of the break reads, `cross`'
    included)."""
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
        if cross and i % 50 == 4:
            kind = (i // 50) % 2
            d, a, b = cross[(i // 100) % len(cross)]
        elif kind < 2:
            d, a, b = breaks[(i // 10) % len(breaks)]
        if kind < 2:
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
            while True:
                s = int(r.integers(0, len(codes) - 3 * L - 400))
                if offsets is None:
                    break
                c = int(np.searchsorted(offsets, s, side="right")) - 1
                if s + 3 * L + 400 <= offsets[c + 1]:
                    break
            a_, b_ = codes[s:s + L].copy(), codes[s + L + inner:
                                                   s + 2 * L + inner].copy()
            for x in (a_, b_):
                p = int(r.integers(0, L))
                x[p] = (x[p] + 1) % 4
            m1[i], m2[i] = a_, revcomp(b_)
    return m1, m2, fused


def contig_pos(offsets, names, g: int):
    """(contig name, 0-based contig-local position) of global position g."""
    c = int(np.searchsorted(offsets, g, side="right")) - 1
    return names[c], int(g - offsets[c])


def break_key(offsets, names, a: int, b: int):
    """A break's partners as fusions.out and result.txt name them: (contig,
    local position) of each, in global order."""
    return (contig_pos(offsets, names, min(a, b))
            + contig_pos(offsets, names, max(a, b)))


def fusion_recall(out_dir, codes, breaks, fused, n_pairs: int,
                  offsets=None, names=("chr1",)):
    """(break-read recall %, junction-read recall %, breaks missing from
    fusions.out). A break read counts when its mate-1 record lies at its
    break (contig, POS and the clipped CIGAR of an equivalent placement):
    paired records carry no XF:Z tag in either package, and the
    single-end XF:Z of a table-free FR/RF candidate names another event
    (ROADMAP Queue 3), so the record's own placement is what is held. A
    break counts when fusions.out has an equivalent one with its
    direction, at its contigs and contig-local coordinates. `offsets`
    and `names` are the FASTA's contigs (default: one, chr1)."""
    L = READ_LEN
    if offsets is None:
        offsets = np.array([0, len(codes)], np.int64)
    want = {}
    for i, (d, a, b, t) in fused.items():
        want[f"p{i}"] = {
            contig_pos(offsets, names, a2 - t2 + 1) + (f"{t2}M{L - t2}S",)
            if d != "rf" else
            contig_pos(offsets, names, b2) + (f"{t2}S{L - t2}M",)
            for a2, b2, t2 in equivalent_breaks(codes, d, a, b, t)}
    sam = os.path.join(out_dir, "accepted_hits.sam")
    found = set()
    with open(sam) as f:
        for line in f:
            if line.startswith("@"):
                continue
            x = line.split("\t", 6)
            if int(x[1]) & 0x80 == 0 and (x[2], int(x[3]) - 1, x[5]) in \
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
            c1, c2 = x[0].split("-")
            reported.add((c1, int(x[1]), c2, int(x[2]), x[3]))
    missing = []
    for d, a, b in breaks:
        ts = [t for (d2, a2, b2, t) in fused.values() if (d2, a2, b2) ==
              (d, a, b)]
        eq = {break_key(offsets, names, a2, b2) + (d,) for t in ts
              for a2, b2, _ in equivalent_breaks(codes, d, a, b, t)}
        if not eq & reported:
            missing.append((d, a, b))
    return 100.0 * len(found) / len(fused), recall_j, missing


def found_in_result(path, codes, breaks, fused, offsets=None,
                    names=("chr1",)) -> list:
    """The designed breaks result.txt reports (any equivalent, at its
    contigs and contig-local coordinates)."""
    if offsets is None:
        offsets = np.array([0, len(codes)], np.int64)
    rows = set()
    with open(path) as f:
        for line in f:
            if not line.startswith("#") and line.strip():
                x = line.split("\t")
                rows.add((x[2], int(x[3]), x[5], int(x[6])))
    out = []
    for d, a, b in breaks:
        eq = {break_key(offsets, names, a2, b2) for (d2, a0, b0, t) in
              fused.values() if (d2, a0, b0) == (d, a, b)
              for a2, b2, _ in equivalent_breaks(codes, d, a, b, t)}
        if eq & rows:
            out.append((d, a, b))
    return out


def designed_in_result(path, codes, breaks, fused) -> int:
    """How many designed breaks result.txt reports (any equivalent)."""
    return len(found_in_result(path, codes, breaks, fused))


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
    fusions.out, break-read or junction-read recall is under 100%, the
    sparse realign entry was not launched over read rows and over segment
    rows, the dense entry was launched, or result.txt holds no designed
    break."""
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
    for tag, seed, n in (("check", 61, CHECK_PAIRS), ("steady", 62, N_PAIRS)):
        m1, m2, fused = make_fusion_pairs(codes, juncs, breaks, seed, n)
        fqs = [os.path.join(CACHE, f"fusion_{tag}_{k}.fq") for k in (1, 2)]
        write_fastq(fqs[0], m1, "p")
        write_fastq(fqs[1], m2, "p")
        reads[tag] = (fqs, fused)
    log(f"fusion inputs: {len(breaks)} breaks, {CHECK_PAIRS} + {N_PAIRS} pairs "
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
    if not any(c.startswith("sparse") and f" L={SEGMENT_L} " in c
               for c in check.shapes):
        fail("the fusion check run made no sparse realign call over "
             "segment rows")

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
               "  of which segment event hits (sparse realign, records)")
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
    if launches[0] or not launches[1]:
        fail(f"the fusion run launched the realign kernel's entries "
             f"{launches} (dense, sparse) times; the chain path must take "
             "the sparse entry only")

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


# --------------------------------------------------------------- phase 11

GROUP_CONTIGS = 8           # the phase-4 genome as 8 contigs of 2^24 bases
GROUP_MAX_BASES = 1 << 25   # --max-index-bases: 4 groups of 2 contigs
GROUP_SE_READS = 8192
GROUP_ENV = {"TOPHAT_TPU_KMER_K": "13", "TOPHAT_TPU_SA_RATE": "4"}
HUMAN_BASES = 3_100_000_000  # the projection: a human genome, 2 groups
CARD_BYTES = 80e9


def fm_table_bytes(fm) -> dict:
    """Bytes of each of an FMIndex's tensors, as they sit on the card."""
    from tophat_tpu_torch.index.fm import TABLES

    return {k: getattr(fm, k).numel() * getattr(fm, k).element_size()
            for k in TABLES}


def phase_grouped(codes, juncs, index):
    """The whole-genome (contig-group) path at full width: the phase-4
    genome written as 8 contigs of 2^24 bases and run through the CLI
    with --max-index-bases 2^25 (4 groups of 2 contigs, one resident on
    the card at a time), at the index design point of every real grouped
    run (k = 13, sa_rate 4: a genome over 2^28 bases). TopHat's default
    mode, paired, coverage search on; no intron and no pair crosses a
    contig cut. First 8,192 of the timed run's mate-1 reads run
    single-end without the coverage search: grouped (the group indexes
    build in forked workers and are cached under .smoke_cache/; every
    realign call held against its plain version as it is made) and
    single-index (the phase-4 index, which covers the same bases); the
    two must write identical files (their recall is reported: without
    the coverage search, reads with a 20-24 base anchor are not all
    found, in either run). Then a timed run of 32,768 pairs records
    stage seconds, group swaps, each group's FMIndex bytes, peak device
    memory and the realign calls, keeping each call's inputs and
    records, which are held against the plain version after it. Fails
    under 100% junction-read recall in the timed run, with other than 4
    groups, with no sparse realign launch or with any dense one."""
    import torch

    from tophat_tpu_torch.cli import main as cli_mod
    from tophat_tpu_torch.index.fm import FMIndex
    from tophat_tpu_torch.ops import events
    from tophat_tpu_torch.pipeline import grouped as grouped_mod
    from tophat_tpu_torch.pipeline import paired as paired_mod
    from tophat_tpu_torch.pipeline import run as run_mod

    cut = len(codes) // GROUP_CONTIGS
    fa = os.path.join(CACHE, "genome_8x2p24.fa")
    if not os.path.exists(fa):
        write_fasta(fa, codes, cuts=tuple(range(0, len(codes), cut)))
    # introns whose pairs (mate 2 up to 3 L + 400 past the intron) stay
    # inside one contig
    gjuncs = [(a, b) for a, b in juncs if (a - READ_LEN) // cut
              == (b + 3 * READ_LEN + 400) // cut]
    t0 = time.time()
    m1, m2 = make_pairs(codes, gjuncs, 72, N_PAIRS, cut=cut)
    fqs = [os.path.join(CACHE, f"grp_steady_{k}.fq") for k in (1, 2)]
    write_fastq(fqs[0], m1, "p")
    write_fastq(fqs[1], m2, "p")
    se_fq = os.path.join(CACHE, "grp_se.fq")
    write_fastq(se_fq, m1[:GROUP_SE_READS], "p")
    log(f"grouped inputs: {GROUP_CONTIGS} contigs of {cut} bases, "
        f"{len(gjuncs)} introns; {N_PAIRS} pairs "
        f"({time.time() - t0:.1f} s)")
    gprefix = os.path.join(CACHE, "grp_2p27")
    argv = lambda out, reads, *flags: (
        ["-o", out, "--tt-index", gprefix, "--max-index-bases",
         str(GROUP_MAX_BASES)] + list(flags) + [fa] + reads)

    saved_env = {k: os.environ.get(k) for k in GROUP_ENV}
    os.environ.update(GROUP_ENV)
    built = []
    build = cli_mod.build_grouped_fm

    def build_kept(*a, **k):
        built.append(build(*a, **k))
        return built[-1]

    cli_mod.build_grouped_fm = build_kept
    bclock = StageClock()
    bclock.wrap(cli_mod, "build_grouped_fm", "group index build or load")
    try:
        check = PathCheck()
        se = {}
        for kind, args in (("grouped", argv(os.path.join(
                CACHE, "grp_se_grouped"), [se_fq], "--no-coverage-search")),
                           ("single", ["-o", os.path.join(
                               CACHE, "grp_se_single"), "--no-coverage-search",
                               "--tt-index", index, fa, se_fq])):
            t1 = time.time()
            with RealignHooks(events, check):
                cli_main_checked(cli_mod.main, args)
            se[kind] = (args[1], time.time() - t1)
        build_s = bclock.seconds.get("group index build or load", 0.0)
        log(f"grouped single-end runs: grouped {se['grouped'][1]:.1f} s "
            f"(group index build {build_s:.1f} s), single-index "
            f"{se['single'][1]:.1f} s; realign exact in "
            f"{len(check.shapes)} calls: " + ", ".join(check.shapes))
        gfm = built[-1]
        if gfm.n_groups != 4:
            fail(f"grouped run: {gfm.n_groups} contig groups, not 4")

        clock = StageClock()
        clock.wrap(cli_mod, "read_fasta", "read_fasta")
        clock.wrap(cli_mod, "build_grouped_fm",
                   "group index load (4 cached groups)")
        clock.wrap(FMIndex, "to", "group swaps (FMIndex.to)")
        clock.wrap(grouped_mod, "align_reads_adaptive",
                   "full-read align (per group)")
        clock.wrap(grouped_mod, "_spliced_mate",
                   "segments + stitch (per group)")
        clock.wrap(grouped_mod, "discover_events", "discovery")
        clock.wrap(grouped_mod, "coverage_search_events", "coverage search")
        clock.wrap(grouped_mod, "candidates_for_mate",
                   "candidates (realign, collect)")
        clock.wrap(run_mod, "realign_events_sparse",
                   "  of which realign, sparse")
        clock.wrap(grouped_mod, "default_chains", "default chains")
        clock.wrap(paired_mod, "accumulate_event_stats", "stats + filter")
        clock.wrap(paired_mod, "filter_junctions", "stats + filter")
        n_events = []
        finalize = grouped_mod.GroupedMapper.finalize_events

        def finalize_counted(self, known_events=None):
            ev = finalize(self, known_events)
            n_events.append(len(ev["left"]))
            return ev

        grouped_mod.GroupedMapper.finalize_events = finalize_counted
        kept = []
        out = os.path.join(CACHE, "grp_out_steady")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        realign_launches(reset=True)
        t0 = time.time()
        try:
            with RealignHooks(events, keep_calls(kept)):
                cli_main_checked(cli_mod.main, argv(out, fqs))
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = realign_launches()
        finally:
            grouped_mod.GroupedMapper.finalize_events = finalize
            clock.restore()
        peak = torch.cuda.max_memory_allocated()
        calls = [realign_call_shape(kind, args) for kind, args, _ in kept]
        held = PathCheck()
        for kind, args, got in kept:
            held(kind, args, got)
        del kept
    finally:
        bclock.restore()
        cli_mod.build_grouped_fm = build
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    for f in ("accepted_hits.sam", "junctions.bed", "insertions.bed",
              "deletions.bed", "align_summary.txt"):
        with open(os.path.join(se["grouped"][0], f), "rb") as x, \
                open(os.path.join(se["single"][0], f), "rb") as y:
            if x.read() != y.read():
                fail(f"grouped single-end run: {f} differs from the "
                     "single-index run")
    se_recall = junction_recall(os.path.join(se["grouped"][0],
                                             "accepted_hits.sam"),
                                GROUP_SE_READS, prefix="p")

    groups = []
    for g, fm in enumerate(gfm.fms):
        tb = fm_table_bytes(fm)
        fixed = tb["kmer_lo"] + tb["kmer_hi"]
        groups.append(dict(bases=fm.n, bytes=sum(tb.values()),
                           b_per_base=sum(tb.values()) / fm.n,
                           kmer_table_bytes=fixed,
                           other_b_per_base=(sum(tb.values()) - fixed) / fm.n,
                           tables=tb))
    # a human genome in 2 groups at the same design point: the k-mer
    # tables are a fixed 2 x 4^13 int32 per group, the rest scales with
    # the group's bases
    per_base = max(x["other_b_per_base"] for x in groups)
    fixed = max(x["kmer_table_bytes"] for x in groups)
    human_group = fixed + per_base * HUMAN_BASES / 2
    recall = junction_recall(os.path.join(out, "accepted_hits.sam"), N_PAIRS,
                             prefix="p", flag_bit=0x40)
    aligned, disc = align_summary_pairs(os.path.join(out,
                                                     "align_summary.txt"))
    swaps = clock.calls.get("group swaps (FMIndex.to)", 0)
    swap_s = clock.seconds.get("group swaps (FMIndex.to)", 0.0)
    stages = dict(clock.seconds)
    top = sum(v for k, v in stages.items() if not k.startswith(" "))
    stages["rest (FASTQ parse, prep, selection, output)"] = wall - top
    log(f"grouped steady run: {wall:.2f} s, {N_PAIRS / wall:.1f} pairs/s; "
        f"{gfm.n_groups} groups, {swaps} group swaps in {swap_s:.3f} s; "
        f"events E={n_events}; realign launches {launches} (dense, sparse); "
        f"peak device memory {peak / 2**30:.3f} GiB")
    for k, v in stages.items():
        log(f"  stage {k}: {v:.3f} s" + calls_note(clock.calls.get(k)))
    log("  realign calls, each held exact after the run: "
        + ", ".join(calls))
    for g, x in enumerate(groups):
        log(f"  group {g}: {x['bases']} bases, FMIndex tensors "
            f"{x['bytes'] / 2**20:.1f} MiB = {x['b_per_base']:.3f} B/base "
            f"(k-mer tables {x['kmer_table_bytes'] / 2**20:.1f} MiB, the "
            f"rest {x['other_b_per_base']:.3f} B/base)")
    log(f"grouped: projection to {HUMAN_BASES} bases in 2 groups: "
        f"{human_group / 1e9:.2f} GB per resident group, "
        f"{2 * human_group / 1e9:.2f} GB for both "
        + ("(all groups fit resident at once on an 80 GB card)"
           if 2 * human_group < CARD_BYTES else "(they do not fit at once)"))
    log(f"grouped: junction-read recall (mate 1) {recall:.2f}%; concordant "
        f"{100.0 * (aligned - disc) / N_PAIRS:.2f}% of pairs; single-end "
        f"{GROUP_SE_READS} reads grouped and single-index byte-identical, "
        f"recall {se_recall:.2f}%")
    if launches[0] or not launches[1]:
        fail(f"the grouped run launched the realign kernel's entries "
             f"{launches} (dense, sparse) times; it must take the sparse "
             "entry only")
    if recall < 100.0:
        fail(f"grouped run: junction-read recall {recall:.2f}% < 100%")
    return dict(wall_s=wall, pairs_per_s=N_PAIRS / wall, n_groups=gfm.n_groups,
                group_swaps=swaps, group_swap_s=swap_s,
                index_build_s=build_s, groups=groups,
                events=n_events[0] if n_events else 0, launches=launches,
                path_err=max(check.err, held.err), realign_calls=calls,
                peak_device_bytes=peak, recall_pct=recall,
                concordant_pct=100.0 * (aligned - disc) / N_PAIRS,
                se_identical=True, se_recall_pct=se_recall,
                se_grouped_s=se["grouped"][1], se_single_s=se["single"][1],
                human_bytes_per_group=human_group,
                human_groups_fit_at_once=2 * human_group < CARD_BYTES,
                stages=stages, stage_calls=clock.calls)


# --------------------------------------------------------------- phase 12

FUSION_GTF_PAIRS = 16384
FUSION_GTF_MAX_GIB = 12.0   # the dense chain path needed ~59 GB here
HOLD_MAX_ROWS = 2048        # rows of each realign call held in phase 12


def phase_fusion_gtf(codes, juncs, index):
    """TopHat-Fusion with an annotation: phase 10's flags plus phase 8's
    `-G genes.gtf --transcriptome-index` (its files, reused), paired, on
    16,384 pairs of phase 10's design in one chunk pair, through the CLI.
    Every row's segments reach the chain path's realign against the
    annotation-sized event table, through the kernel's sparse entry (the
    dense (rows * S, E) tables would take ~59 GB). One timed run records
    E, wall, pairs/s, the chain stage's seconds and peak device memory,
    and keeps every realign call's inputs and records; each call is then
    held against its plain version on up to 2,048 of its rows. Fails if
    a designed break is missing from fusions.out, break-read or
    junction-read recall is under 100%, E < 30,000, peak device memory
    exceeds 12 GiB, or the dense entry ran or the sparse one did not."""
    import torch

    from tophat_tpu_torch.cli import main as cli_mod
    from tophat_tpu_torch.ops import events
    from tophat_tpu_torch.pipeline import paired as paired_mod
    from tophat_tpu_torch.pipeline import run as run_mod

    fa = os.path.join(CACHE, "genome_2p27.fa")
    gtf = os.path.join(CACHE, "genes.gtf")
    tix = os.path.join(CACHE, "tx", "genes")
    breaks = pick_fusion_breaks(codes)
    m1, m2, fused = make_fusion_pairs(codes, juncs, breaks, 63,
                                      FUSION_GTF_PAIRS)
    fqs = [os.path.join(CACHE, f"fusion_gtf_{k}.fq") for k in (1, 2)]
    write_fastq(fqs[0], m1, "p")
    write_fastq(fqs[1], m2, "p")
    work = os.path.join(CACHE, "fusion_gtf")
    out = os.path.join(work, "tophat_smoke")
    argv = (["-o", out, "--tt-index", index, "--batch-size", str(BATCH),
             "-G", gtf, "--transcriptome-index", tix] + FUSION_FLAGS
            + [fa] + fqs)

    clock = StageClock()
    clock.wrap(cli_mod, "read_fasta", "read_fasta")
    clock.wrap(cli_mod, "build_transcriptome_index",
               "transcriptome index reuse")
    clock.wrap(paired_mod, "_map_mate", "map (transcriptome, genome)")
    clock.wrap(paired_mod, "discover_events", "discovery")
    clock.wrap(paired_mod, "candidates_for_mate", "candidates")
    clock.wrap(run_mod, "realign_events_sparse",
               "  of which realign, sparse (read rows)")
    clock.wrap(run_mod, "find_fr_fusions", "  of which FR/RF scan")
    clock.wrap(run_mod, "segment_event_hits",
               "  of which chain stage: segment event hits (sparse)")
    clock.wrap(run_mod, "chain_stitch",
               "  of which chain stage: chain stitch + cross-strand")
    clock.wrap(run_mod, "cross_strand_chains",
               "  of which chain stage: chain stitch + cross-strand")
    clock.wrap(paired_mod, "accumulate_event_stats", "stats + filter")
    clock.wrap(paired_mod, "filter_junctions", "stats + filter")
    clock.wrap(paired_mod, "build_fusion_table", "fusion stats")
    n_events = []
    finalize = paired_mod.SingleIndexMapper.finalize_events

    def finalize_counted(self, known_events=None):
        ev = finalize(self, known_events)
        n_events.append(len(ev["left"]))
        return ev

    paired_mod.SingleIndexMapper.finalize_events = finalize_counted
    kept = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    realign_launches(reset=True)
    t0 = time.time()
    try:
        with RealignHooks(events, keep_calls(kept)):
            cli_main_checked(cli_mod.main, argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = realign_launches()
    finally:
        paired_mod.SingleIndexMapper.finalize_events = finalize
        clock.restore()
    peak = torch.cuda.max_memory_allocated()
    stages = dict(clock.seconds)
    top = sum(v for k, v in stages.items() if not k.startswith(" "))
    stages["rest (FASTQ parse, selection, output)"] = wall - top
    chain_s = sum(v for k, v in stages.items() if "chain stage" in k)
    check = PathCheck(max_rows=HOLD_MAX_ROWS)
    t0 = time.time()
    for kind, args, got in kept:
        check(kind, args, got)
    hold_s = time.time() - t0
    del kept
    torch.cuda.empty_cache()
    recall_f, recall_j, missing = fusion_recall(out, codes, breaks, fused,
                                                FUSION_GTF_PAIRS)
    E = n_events[0] if n_events else 0
    log(f"fusion -G run: {wall:.2f} s, {FUSION_GTF_PAIRS / wall:.1f} "
        f"pairs/s; E={E}; chain stage {chain_s:.3f} s; realign launches "
        f"{launches} (dense, sparse); peak device memory "
        f"{peak / 2**30:.3f} GiB")
    for k, v in stages.items():
        log(f"  stage {k}: {v:.3f} s" + calls_note(clock.calls.get(k)))
    log(f"  realign exact on the held rows ({hold_s:.1f} s): "
        + ", ".join(check.shapes))
    log(f"fusion -G: break-read recall {recall_f:.2f}% of {len(fused)}; "
        f"junction-read recall {recall_j:.2f}%; designed breaks missing "
        f"from fusions.out: {missing}")
    if missing:
        fail(f"fusion -G run: designed breaks missing from fusions.out: "
             f"{missing}")
    if recall_f < 100.0 or recall_j < 100.0:
        fail(f"fusion -G run: recall {recall_f:.2f}% (break reads), "
             f"{recall_j:.2f}% (junction reads) < 100%")
    if E < MIN_EVENTS:
        fail(f"fusion -G run: E = {E} < {MIN_EVENTS} events")
    if peak > FUSION_GTF_MAX_GIB * 2**30:
        fail(f"fusion -G run: peak device memory {peak / 2**30:.3f} GiB > "
             f"{FUSION_GTF_MAX_GIB} GiB")
    if launches[0] or not launches[1]:
        fail(f"the fusion -G run launched the realign kernel's entries "
             f"{launches} (dense, sparse) times; the chain path must take "
             "the sparse entry only")
    return dict(wall_s=wall, pairs_per_s=FUSION_GTF_PAIRS / wall, events=E,
                chain_s=chain_s, launches=launches, path_err=check.err,
                held_calls=check.shapes, peak_device_bytes=peak,
                recall_break_reads_pct=recall_f,
                recall_junction_pct=recall_j, stages=stages,
                stage_calls=clock.calls)


# --------------------------------------------------------------- phase 13

MESH_SHARDS = 4             # (a): a reads axis of 4 x cuda:0
MESH_DEVICE = "cuda:0"      # the device every shard of the mesh runs on
MESH_SE_READS = 8192        # (b): single-end reads over the sharded index
MESH_GENOME_SHARDS = 2      # (b): a 2 (reads) x 2 (genome) mesh


def same_files(a, b, what: str):
    for f in ("accepted_hits.sam", "junctions.bed", "insertions.bed",
              "deletions.bed", "align_summary.txt"):
        with open(os.path.join(a, f), "rb") as x, \
                open(os.path.join(b, f), "rb") as y:
            if x.read() != y.read():
                fail(f"{what}: {f} differs from the one-device run")


def phase_mesh(codes, juncs, index):
    """The mesh path (parallel/) on the card, through the CLI with its
    device list replaced (parallel.mesh.visible_devices returns cuda:0
    repeated, as the CPU tests repeat the CPU device): (a) phase 6's
    timed run (paired default mode, 32,768 pairs, the phase-4 genome and
    index) on a reads axis of 4 x cuda:0, with stage seconds, pairs/s,
    every realign call's R and peak device memory; (b) 8,192 single-end
    reads without the coverage search over the index range-sharded in 2
    (TOPHAT_TPU_GENOME_SHARDS=2: a 2 x 2 mesh), with the sub-index build
    seconds and bytes. Each must write the files of its one-device run
    (for (a), phase 6's). Every realign call of both runs is kept and then
    held against its plain version on up to 2,048 of its rows. Fails on a
    byte difference, under 100% junction-read recall, or if a run
    launched no sparse realign kernel."""
    import torch

    from tophat_tpu_torch.cli import main as cli_mod
    from tophat_tpu_torch.index.fm import FMIndex
    from tophat_tpu_torch.ops import events
    from tophat_tpu_torch.parallel import auto, shard_fm
    from tophat_tpu_torch.parallel import mesh as mesh_mod
    from tophat_tpu_torch.pipeline import paired as paired_mod
    from tophat_tpu_torch.pipeline import run as run_mod

    t_phase = time.time()
    fa = os.path.join(CACHE, "genome_2p27.fa")
    card = torch.device(MESH_DEVICE)
    visible = mesh_mod.visible_devices
    mesh_mod.visible_devices = lambda device: [card] * MESH_SHARDS
    kept, res = [], {}
    try:
        # (a) phase 6's timed run on 4 row shards
        clock = StageClock()
        clock.wrap(cli_mod, "read_fasta", "read_fasta")
        clock.wrap(FMIndex, "load", "FMIndex.load")
        clock.wrap(paired_mod, "_map_mate",
                   "map (prep, full-read align, segments, stitch)")
        clock.wrap(paired_mod, "discover_events", "discovery")
        clock.wrap(run_mod, "coverage_search_events", "coverage search")
        clock.wrap(paired_mod, "candidates_for_mate",
                   "candidates (realign, collect, chains)")
        clock.wrap(run_mod, "realign_events_sparse",
                   "  of which realign, sparse")
        out = os.path.join(CACHE, "mesh_pairs_out")
        reads = [os.path.join(CACHE, f"pairs_steady_{k}.fq") for k in (1, 2)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        realign_launches(reset=True)
        t0 = time.time()
        try:
            with RealignHooks(events, keep_calls(kept)):
                cli_main_checked(cli_mod.main, ["-o", out, "--tt-index",
                                                index, fa] + reads)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches_a = realign_launches()
        finally:
            clock.restore()
        peak = torch.cuda.max_memory_allocated()
        calls_a = [realign_call_shape(kind, args) for kind, args, _ in kept]
        if auto.active() is not None:
            fail("the CLI left a mesh active")
        same_files(out, os.path.join(CACHE, "pairs_out_steady"),
                   "mesh run (a)")
        recall_a = junction_recall(os.path.join(out, "accepted_hits.sam"),
                                   N_PAIRS, prefix="p", flag_bit=0x40)
        stages = dict(clock.seconds)
        top = sum(v for k, v in stages.items() if not k.startswith(" "))
        stages["rest (FASTQ parse, selection, output)"] = wall - top
        res["a"] = dict(wall_s=wall, pairs_per_s=N_PAIRS / wall,
                        recall_pct=recall_a, launches=launches_a,
                        realign_calls=calls_a, peak_device_bytes=peak,
                        stages=stages, stage_calls=clock.calls)
        log(f"mesh (a), {MESH_SHARDS} x cuda:0: {wall:.2f} s, "
            f"{N_PAIRS / wall:.1f} pairs/s; realign launches {launches_a} "
            f"(dense, sparse); peak device memory {peak / 2**30:.3f} GiB; "
            f"files identical to phase 6's one-device run; recall (mate 1) "
            f"{recall_a:.2f}%")
        for k, v in stages.items():
            log(f"  stage {k}: {v:.3f} s" + calls_note(clock.calls.get(k)))
        log("  realign calls: " + ", ".join(calls_a))

        # (b) single-end over the range-sharded index, 2 x 2
        se_fq = os.path.join(CACHE, "mesh_se.fq")
        write_fastq(se_fq, make_reads(codes, juncs, 81, MESH_SE_READS))
        argv = lambda out: ["-o", out, "--no-coverage-search", "--tt-index",
                            index, fa, se_fq]
        one = os.path.join(CACHE, "mesh_se_one")
        mesh_mod.visible_devices = visible
        cli_main_checked(cli_mod.main, argv(one))
        mesh_mod.visible_devices = lambda device: [card] * MESH_SHARDS
        built = []
        build = shard_fm.build_sharded_fm

        def build_timed(*a, **k):
            t1 = time.time()
            out = build(*a, **k)
            built.append((out[0], time.time() - t1))
            return out

        shard_fm.build_sharded_fm = build_timed
        saved = os.environ.get("TOPHAT_TPU_GENOME_SHARDS")
        os.environ["TOPHAT_TPU_GENOME_SHARDS"] = str(MESH_GENOME_SHARDS)
        n_kept = len(kept)
        realign_launches(reset=True)
        t0 = time.time()
        try:
            with RealignHooks(events, keep_calls(kept)):
                cli_main_checked(cli_mod.main,
                                 argv(os.path.join(CACHE, "mesh_se_gs")))
            torch.cuda.synchronize()
            wall_b = time.time() - t0
            launches_b = realign_launches()
        finally:
            shard_fm.build_sharded_fm = build
            if saved is None:
                os.environ.pop("TOPHAT_TPU_GENOME_SHARDS", None)
            else:
                os.environ["TOPHAT_TPU_GENOME_SHARDS"] = saved
        if not built:
            fail("mesh run (b) did not range-shard the index")
        subs, build_s = built[-1]
        same_files(os.path.join(CACHE, "mesh_se_gs"), one, "mesh run (b)")
        recall_b = junction_recall(os.path.join(CACHE, "mesh_se_gs",
                                                "accepted_hits.sam"),
                                   MESH_SE_READS)
        calls_b = [realign_call_shape(kind, args)
                   for kind, args, _ in kept[n_kept:]]
        res["b"] = dict(wall_s=wall_b, build_s=build_s,
                        sub_index_bytes=[x.nbytes for x in subs],
                        sub_index_bases=[x.n for x in subs],
                        recall_pct=recall_b, launches=launches_b,
                        realign_calls=calls_b)
        log(f"mesh (b), {MESH_GENOME_SHARDS} x {MESH_GENOME_SHARDS}: "
            f"{wall_b:.2f} s (sub-index build {build_s:.1f} s); sub-indexes "
            + ", ".join(f"{x.n} bases / {x.nbytes / 2**30:.3f} GiB"
                        for x in subs)
            + f"; realign launches {launches_b} (dense, sparse); files "
            f"identical to the one-index run; recall {recall_b:.2f}%")
        log("  realign calls: " + ", ".join(calls_b))
    finally:
        mesh_mod.visible_devices = visible
        auto.deactivate()

    held = PathCheck(max_rows=HOLD_MAX_ROWS)
    t0 = time.time()
    for kind, args, got in kept:
        held(kind, args, got)
    log(f"mesh: {len(kept)} realign calls held exact against the plain "
        f"version ({time.time() - t0:.1f} s)")
    del kept
    for tag, launches, recall in (("a", launches_a, recall_a),
                                  ("b", launches_b, recall_b)):
        if launches[1] == 0:
            fail(f"mesh run ({tag}) never launched the sparse realign "
                 "kernel")
        if recall < 100.0:
            fail(f"mesh run ({tag}): junction-read recall {recall:.2f}% "
                 "< 100%")
    phase_s = time.time() - t_phase
    log(f"mesh: phase 13 took {phase_s:.1f} s")
    return dict(res, launches=tuple(x + y for x, y in zip(launches_a,
                                                          launches_b)),
                path_err=held.err, phase_s=phase_s)


# --------------------------------------------------------------- phase 14

LONG_CHECK_PAIRS = 2048
LONG_PAIRS = 8192
LONG_HOLD_ROWS = 1024       # rows of each realign call held in the check


def phase_long_reads(codes, juncs, index, transcripts):
    """The annotated run at 2 x 300 bp, `tophat -G genes.gtf
    --transcriptome-index ... --no-coverage-search`, paired, through the
    CLI on phase 8's genome, annotation and transcriptome index (reused,
    not rebuilt): 50% transcript fragments, 10% with mate 1 across a
    phase-4 intron, the rest contiguous. A run of 2,048 pairs holds every
    realign call against its plain version on up to 1,024 of its rows;
    a timed run of 8,192 pairs records pairs/s, stage seconds, every
    realign call's R, E, L and q, the realign stage's seconds and peak
    device memory, and its calls are held the same way after it. Fails if a realign call is not 300 positions wide, no
    sparse realign was launched, or under 100% recall (annotated-junction
    mates, unannotated-intron mates 1)."""
    from tophat_tpu_torch.cli import main as cli_mod
    from tophat_tpu_torch.ops import events

    t_phase = time.time()
    fa = os.path.join(CACHE, "genome_2p27.fa")
    gtf = os.path.join(CACHE, "genes.gtf")
    tix = os.path.join(CACHE, "tx", "genes")
    reads = {}
    for tag, seed, n in (("check", 61, LONG_CHECK_PAIRS),
                         ("steady", 62, LONG_PAIRS)):
        m1, m2, spans, unannotated = make_annotated_pairs(
            codes, transcripts, juncs, seed, n, LONG_READ_LEN)
        fqs = [os.path.join(CACHE, f"long_{tag}_{k}.fq") for k in (1, 2)]
        write_fastq(fqs[0], m1, "p")
        write_fastq(fqs[1], m2, "p")
        reads[tag] = (fqs, spans, unannotated)
    log(f"long-read inputs: {LONG_CHECK_PAIRS} + {LONG_PAIRS} pairs of 2 x "
        f"{LONG_READ_LEN} bp ({time.time() - t_phase:.1f} s)")
    argv = lambda out, fqs: ["-o", out, "-G", gtf, "--transcriptome-index",
                             tix, "--tt-index", index, "--no-coverage-search",
                             fa] + fqs
    widths = set()

    def on_call(kind, args, out):
        widths.add(int(args[0].shape[1]))
        check(kind, args, out)

    check = PathCheck(max_rows=LONG_HOLD_ROWS)
    t0 = time.time()
    with RealignHooks(events, on_call):
        cli_main_checked(cli_mod.main,
                         argv(os.path.join(CACHE, "long_out_check"),
                              reads["check"][0]))
    log(f"long-read check run: {time.time() - t0:.1f} s; realign exact in "
        f"{len(check.shapes)} calls: " + ", ".join(check.shapes))
    if not any(c.startswith("sparse") for c in check.shapes):
        fail("the long-read check run made no sparse realign call")

    kept = []
    res = annotated_timed_run("long-read", argv,
                              os.path.join(CACHE, "long_out_steady"),
                              reads["steady"], LONG_PAIRS, kept)
    held = PathCheck(max_rows=LONG_HOLD_ROWS)
    t0 = time.time()
    for kind, args, got in kept:
        held(kind, args, got)
    log(f"long-read timed run: realign exact in {len(held.shapes)} calls "
        f"({time.time() - t0:.1f} s): " + ", ".join(held.shapes))
    del kept
    res["phase_s"] = time.time() - t_phase
    log(f"long reads: phase 14 took {res['phase_s']:.1f} s")
    widths |= set(res["realign_widths"])
    if widths != {LONG_READ_LEN}:
        fail(f"long-read runs: realign widths {sorted(widths)}, not "
             f"{LONG_READ_LEN} alone")
    if res["launches"][1] == 0:
        fail("the long-read run never launched the sparse realign kernel")
    recall = res["recall_annotated_pct"], res["recall_unannotated_pct"]
    if min(recall) < 100:
        fail(f"long-read run: recall {recall[0]:.2f}% (annotated), "
             f"{recall[1]:.2f}% (unannotated) < 100%")
    return dict(res, read_len=LONG_READ_LEN,
                path_err=max(check.err, held.err))


# --------------------------------------------------------------- phase 15

LONG_SE_LENS = (5000, 8192)  # full-length cDNA, assembled transcripts
LONG_SE_CHECK = 512
LONG_SE_READS = 2048
LONG_SE_HOLD_ROWS = 256     # rows of each realign call held


def make_long_single_reads(codes, juncs, seed: int, n_reads: int,
                           lens=LONG_SE_LENS):
    """Single-end reads of 5,000 and 8,192 bp (alternating by read pair
    of the junction pattern), 25% across a phase-4 intron (r0, r4, ...;
    anchors of at least 30 bp), the rest contiguous with one mismatch."""
    r = np.random.default_rng(seed)
    n = len(codes)
    seqs = []
    for i in range(n_reads):
        L = int(lens[(i // 2) % len(lens)])
        if i % 4 == 0:
            while True:
                left, right = juncs[int(r.integers(0, len(juncs)))]
                lo, hi = max(30, L - (n - right)), min(L - 30, left + 1)
                if lo <= hi:
                    break
            t = int(r.integers(lo, hi + 1))
            seq = np.concatenate([codes[left - t + 1:left + 1],
                                  codes[right:right + L - t]])
        else:
            st = int(r.integers(0, n - L))
            seq = codes[st:st + L].copy()
            p = int(r.integers(0, L))
            seq[p] = (seq[p] + 1) % 4
        seqs.append(seq)
    return seqs


def phase_long_single(codes, juncs, index):
    """The single-end CLI (--no-coverage-search, phase 4's genome and
    index) on reads of 5,000 and 8,192 bp, 25% across a phase-4 intron:
    a run of 512 reads holding every realign call against its plain
    version on up to 256 of its rows, then a timed run of 2,048 reads
    with reads/s, stage seconds, every realign call's R, E, L and q and
    peak device memory, its calls held the same way after it. Fails if
    no realign call is wider than 4,096 positions, no sparse realign was
    launched, or junction-read recall is under 100%."""
    import torch

    from tophat_tpu_torch.cli import main as cli_mod
    from tophat_tpu_torch.ops import align as align_mod
    from tophat_tpu_torch.ops import beam as beam_mod
    from tophat_tpu_torch.ops import events
    from tophat_tpu_torch.pipeline import run as run_mod

    t_phase = time.time()
    fa = os.path.join(CACHE, "genome_2p27.fa")
    fqs = {}
    for tag, seed, n in (("check", 71, LONG_SE_CHECK),
                         ("steady", 72, LONG_SE_READS)):
        fqs[tag] = os.path.join(CACHE, f"long_se_{tag}.fq")
        write_fastq(fqs[tag], make_long_single_reads(codes, juncs, seed, n))
    log(f"long single-end inputs: {LONG_SE_CHECK} + {LONG_SE_READS} reads of "
        f"{' and '.join(map(str, LONG_SE_LENS))} bp "
        f"({time.time() - t_phase:.1f} s)")
    argv = lambda out, fq: ["-o", out, "--no-coverage-search", "--tt-index",
                            index, fa, fq]
    widths = set()

    def on_call(kind, args, out):
        widths.add(int(args[0].shape[1]))
        check(kind, args, out)

    check = PathCheck(max_rows=LONG_SE_HOLD_ROWS)
    t0 = time.time()
    with RealignHooks(events, on_call):
        cli_main_checked(cli_mod.main, argv(
            os.path.join(CACHE, "long_se_check"), fqs["check"]))
    log(f"long single-end check run: {time.time() - t0:.1f} s; realign "
        f"exact in {len(check.shapes)} calls: " + ", ".join(check.shapes))

    clock = StageClock()
    clock.wrap(cli_mod, "read_fasta", "read_fasta")
    clock.wrap(run_mod, "_map_mate",
               "map (prep, full-read align, segments, stitch)")
    # its word-axis Python loop: 512 words a row at 8,192 bp
    for mod in (align_mod, beam_mod):
        clock.wrap(mod, "count_mismatches_packed",
                   "  of which count_mismatches_packed")
    clock.wrap(run_mod, "discover_events", "discovery")
    clock.wrap(run_mod, "candidates_for_mate",
               "candidates (realign, collect, chains)")
    clock.wrap(run_mod, "realign_events_sparse", "  of which realign, sparse")
    clock.wrap(run_mod, "default_chains", "  of which default chains")
    clock.wrap(run_mod, "accumulate_event_stats", "stats + filter")
    clock.wrap(run_mod, "filter_junctions", "stats + filter")
    kept, calls = [], []
    keep = keep_calls(kept)

    def on_timed(kind, args, got):
        widths.add(int(args[0].shape[1]))
        calls.append(realign_call_shape(kind, args))
        keep(kind, args, got)

    out = os.path.join(CACHE, "long_se_steady")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    realign_launches(reset=True)
    t0 = time.time()
    try:
        with RealignHooks(events, on_timed):
            cli_main_checked(cli_mod.main, argv(out, fqs["steady"]))
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = realign_launches()
    finally:
        clock.restore()
    peak = torch.cuda.max_memory_allocated()
    stages = dict(clock.seconds)
    top = sum(v for k, v in stages.items() if not k.startswith(" "))
    stages["rest (FASTQ parse, index load, selection, output)"] = wall - top
    recall = junction_recall(os.path.join(out, "accepted_hits.sam"),
                             LONG_SE_READS)
    realign_s = stages.get("  of which realign, sparse", 0.0)
    log(f"long single-end timed run: {wall:.2f} s, "
        f"{LONG_SE_READS / wall:.1f} reads/s; realign {realign_s:.3f} s "
        f"({100 * realign_s / wall:.1f}% of the run), launches {launches} "
        f"(dense, sparse); peak device memory {peak / 2**30:.3f} GiB; "
        f"recall {recall:.2f}%")
    for k, v in stages.items():
        log(f"  stage {k}: {v:.3f} s" + calls_note(clock.calls.get(k)))
    log("  realign calls: " + ", ".join(calls))
    held = PathCheck(max_rows=LONG_SE_HOLD_ROWS)
    t0 = time.time()
    for kind, args, got in kept:
        held(kind, args, got)
    log(f"long single-end timed run: realign exact in {len(held.shapes)} "
        f"calls ({time.time() - t0:.1f} s)")
    del kept
    phase_s = time.time() - t_phase
    log(f"long single-end: phase 15 took {phase_s:.1f} s")
    if max(widths) <= 4096:
        fail(f"long single-end runs: realign widths {sorted(widths)}, none "
             "over 4,096")
    if launches[1] == 0:
        fail("the long single-end run never launched the sparse realign "
             "kernel")
    if recall < 100.0:
        fail(f"long single-end run: junction-read recall {recall:.2f}% < "
             "100%")
    return dict(wall_s=wall, reads_per_s=LONG_SE_READS / wall,
                read_lens=list(LONG_SE_LENS), launches=launches,
                realign_calls=calls, realign_widths=sorted(widths),
                realign_s=realign_s, peak_device_bytes=peak,
                recall_pct=recall, stages=stages,
                stage_calls=dict(clock.calls),
                path_err=max(check.err, held.err), phase_s=phase_s)


# --------------------------------------------------------------- phase 16

# hg19's 24 chromosomes in its size order, Mbp: 3,093,000,000 bases, the
# JAX package's scale proof's ladder (its own copy here)
HUMAN_CONTIG_MBP = (249, 243, 198, 191, 181, 171, 159, 146, 141, 136, 135,
                    134, 115, 107, 103, 90, 81, 78, 59, 63, 48, 51, 155, 59)
HUMAN_PER_MBP = 1_000_000   # bases a ladder Mbp; 1,000 rehearses at 1/1,000
HUMAN_MAX_INDEX_BASES = 0   # --max-index-bases; 0: the CLI's default (2
#                             groups here; 1,950,000 cuts the 1/1,000 one)
HUMAN_SEED = 31
HUMAN_INTRONS_PER_CONTIG = 2  # GT..AG, 100-5,000 bp: 22 on chr14-chr24
HUMAN_READS = 16384
HUMAN_HOLD_ROWS = 2048      # rows of each realign call held
HUMAN_DIR = os.path.join(CACHE, "human")
POS_2P31 = 1 << 31


def human_paths():
    """(FASTA, --tt-index prefix, the build child's log, its record)."""
    tag = f"hs{HUMAN_PER_MBP}"
    return tuple(os.path.join(HUMAN_DIR, tag + s) for s in
                 (".fa", "", ".build.log", ".build.json"))


def human_genome():
    """Phase 16's genome: HUMAN_CONTIG_MBP contigs of random codes (seed
    HUMAN_SEED) with HUMAN_INTRONS_PER_CONTIG planted GT..AG introns (100 to
    5,000 bp) on each. Returns (codes, offsets, names, introns); an intron
    is (contig, last exonic base, first exonic base after it), contig-local
    and 0-based."""
    rng = np.random.default_rng(HUMAN_SEED)
    sizes = [m * HUMAN_PER_MBP for m in HUMAN_CONTIG_MBP]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    codes = np.empty(int(offsets[-1]), np.int8)
    introns = []
    for c, size in enumerate(sizes):
        base = int(offsets[c])
        codes[base:base + size] = rng.integers(0, 4, size, dtype=np.int8)
        for _ in range(HUMAN_INTRONS_PER_CONTIG):
            il = int(rng.integers(100, 5001))
            a = base + int(rng.integers(1000, size - 1000 - il))
            codes[a:a + 2] = (2, 3)                  # GT
            codes[a + il - 2:a + il] = (0, 2)        # AG
            introns.append((c, a - 1 - base, a + il - base))
    names = [f"chr{i + 1}" for i in range(len(sizes))]
    return codes, offsets, names, introns


def fasta_bytes(offsets, width: int = 4096) -> int:
    """Size of write_fasta's file of contigs at `offsets`."""
    lens = np.diff(offsets)
    return int(sum(len(b">chr%d\n" % (i + 1)) + n + -(-n // width)
                   for i, n in enumerate(lens)))


def human_reads(codes, offsets, introns, seed: int, n_reads: int):
    """Single-end reads of READ_LEN: 25% (r0, r4, ...) across a designed
    intron (anchors of 30-69 bases), the rest contiguous with one mismatch,
    drawn uniformly over the whole genome (none crossing a contig end).
    Returns (reads, truth): truth[i] is (contig, 0-based local start) of
    a contiguous read, None for a junction read."""
    r = np.random.default_rng(seed)
    n = len(codes)
    seqs, truth = [], []
    for i in range(n_reads):
        if i % 4 == 0:
            c, left, right = introns[int(r.integers(0, len(introns)))]
            base = int(offsets[c])
            t = int(r.integers(30, 70))
            seq = np.concatenate([codes[base + left - t + 1:base + left + 1],
                                  codes[base + right:
                                        base + right + READ_LEN - t]])
            truth.append(None)
        else:
            while True:
                g = int(r.integers(0, n - READ_LEN))
                c = int(np.searchsorted(offsets, g, side="right")) - 1
                if g + READ_LEN <= offsets[c + 1]:
                    break
            seq = codes[g:g + READ_LEN].copy()
            p = int(r.integers(0, READ_LEN))
            seq[p] = (seq[p] + 1) % 4
            truth.append((c, g - int(offsets[c])))
        seqs.append(seq)
    return np.stack(seqs), truth


def bed_junctions(out) -> set:
    """{(contig, last exonic base, first exonic base after)} of a run's
    junctions.bed, contig-local and 0-based."""
    found = set()
    with open(os.path.join(out, "junctions.bed")) as f:
        for line in f:
            if line.startswith("track"):
                continue
            x = line.split("\t")
            start = int(x[1])
            sizes = x[10].split(",")
            starts = x[11].split(",")
            found.add((x[0], start + int(sizes[0]) - 1,
                       start + int(starts[1])))
    return found


def human_placement(out, names, offsets, introns, truth) -> dict:
    """What a run of human_reads' reads wrote: junction-read recall, the
    designed introns missing from junctions.bed (contig and contig-local
    coordinates), the contiguous reads with no record at their designed
    contig and POS, and the records on contigs that start past 2^31."""
    want = {f"r{i}": (names[t[0]], t[1] + 1) for i, t in enumerate(truth)
            if t is not None}
    placed = set()
    past = {names[c] for c in range(len(names)) if offsets[c] >= POS_2P31}
    n_past = n_group = 0
    max_global = -1
    cid = {nm: c for c, nm in enumerate(names)}
    with open(os.path.join(out, "accepted_hits.sam")) as f:
        for line in f:
            if line.startswith("@"):
                continue
            t = line.split("\t", 6)
            if t[2] == "*":
                continue
            pos = int(t[3])
            if want.get(t[0]) == (t[2], pos) and t[5] == f"{READ_LEN}M":
                placed.add(t[0])
            n_past += t[2] in past
            max_global = max(max_global, int(offsets[cid[t[2]]]) + pos - 1)
    found = bed_junctions(out)
    return dict(
        recall_pct=junction_recall(os.path.join(out, "accepted_hits.sam"),
                                   len(truth)),
        missing_introns=[(names[c], a, b) for c, a, b in introns
                         if (names[c], a, b) not in found],
        misplaced=sorted(set(want) - placed, key=lambda s: int(s[1:])),
        n_contiguous=len(want), records_past_2p31=n_past,
        max_global_pos=max_global)


def start_human_build():
    """Start phase 16's index build in a child process (a fresh
    interpreter, not a fork of this process, which holds CUDA): it writes
    the genome's FASTA and builds the group indexes under the CLI's cache
    prefix, then phase 17's annotation and transcriptome index,
    overlapping phases 2-16, and starts phase 19's index build once the
    groups are done. Returns the Popen; the child, its build workers and
    phase 19's index build (one process group) are killed if the smoke exits
    first."""
    import atexit
    import signal

    fa, prefix, logf, rec = human_paths()
    os.makedirs(HUMAN_DIR, exist_ok=True)
    for path in (rec, human_annotation_paths()[2], bench_paths()[3]):
        if os.path.exists(path):
            os.remove(path)
    with open(logf, "w") as f:
        child = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--human-build",
             str(HUMAN_PER_MBP), str(HUMAN_MAX_INDEX_BASES), str(BENCH_N),
             str(BENCH_KMER_K)],
            stdout=f, stderr=subprocess.STDOUT, cwd=REPO,
            start_new_session=True)

    def stop():
        if child.poll() is None:
            os.killpg(child.pid, signal.SIGKILL)
            child.wait()
    atexit.register(stop)
    return child


def human_build():
    """The build child (chip_smoke.py --human-build PER_MBP MAX_BASES
    BENCH_N BENCH_KMER_K): phase 16's FASTA (reused when its size
    matches), then the port's build_grouped_fm as the CLI calls it (its
    --max-index-bases and index design point), under the prefix the CLI
    gets as --tt-index (cached groups are reused). Writes its seconds and
    peak host memory as JSON (phase 16 starts on it). Then it starts phase
    19's index build in a process of its own (never beside the group
    builds, whose workers take most of the host's memory), builds phase
    17's inputs (human_annotation_build) beside it, and exits with the
    index build's code once that ends."""
    import resource

    sys.path.insert(0, REPO)
    from tophat_tpu_torch.cli import main as cli_mod
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.index.grouped import MAX_GROUP_BASES

    fa, prefix, _, rec = human_paths()
    t0 = time.time()
    codes, offsets, names, introns = human_genome()
    synth_s = time.time() - t0
    t0 = time.time()
    fresh_fasta = not (os.path.exists(fa)
                       and os.path.getsize(fa) == fasta_bytes(offsets))
    if fresh_fasta:
        write_fasta(fa + ".tmp", codes, cuts=offsets[:-1])
        os.replace(fa + ".tmp", fa)
    fasta_s = time.time() - t0
    kk, sr = cli_mod._index_design_point(len(codes) > (1 << 28))
    msgs = []
    t0 = time.time()
    gfm = cli_mod.build_grouped_fm(
        Genome(codes=codes, offsets=offsets, names=names),
        max_bases=HUMAN_MAX_INDEX_BASES or MAX_GROUP_BASES, kmer_k=kk,
        sa_rate=sr, cache_prefix=prefix, log=lambda m: (msgs.append(m),
                                                        print(m, flush=True)))
    build_s = time.time() - t0
    with open(rec + ".tmp", "w") as f:
        json.dump(dict(
            synth_s=synth_s, fasta_s=fasta_s, fresh_fasta=fresh_fasta,
            build_s=build_s, kmer_k=kk, sa_rate=sr,
            reused_groups=sum("reusing" in m for m in msgs),
            n_groups=gfm.n_groups, group_bases=[fm.n for fm in gfm.fms],
            group_contigs=[len(g.names) for g in gfm.sub_genomes],
            peak_rss_bytes=1024 * resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss,
            worker_peak_rss_bytes=1024 * resource.getrusage(
                resource.RUSAGE_CHILDREN).ru_maxrss), f)
    os.replace(rec + ".tmp", rec)
    del gfm
    bench = start_bench_build()
    human_annotation_build(codes, offsets, names, introns)
    del codes
    sys.exit(bench.wait())


class HostPeak:
    """Peak resident set of this process within the block, sampled every
    20 ms from /proc/self/statm (a sandbox's kernel may offer no resettable
    VmHWM). Where statm is unreadable, the process's lifetime peak
    (getrusage) stands in, and `lifetime` says so."""

    def __enter__(self):
        import threading

        self.bytes, self.lifetime = 0, False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        page = os.sysconf("SC_PAGE_SIZE")
        while True:
            try:
                with open("/proc/self/statm") as f:
                    rss = int(f.read().split()[1]) * page
            except (OSError, ValueError, IndexError):
                self.lifetime = True
                return
            self.bytes = max(self.bytes, rss)
            if self._stop.wait(0.02):
                return

    def __exit__(self, *exc):
        import resource

        self._stop.set()
        self._thread.join()
        if self.lifetime or not self.bytes:
            self.lifetime = True
            self.bytes = 1024 * resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss


def wait_for_record(build, path):
    """Wait until the build child has written `path` or exited; returns
    the child's exit code, None while it still runs."""
    while not os.path.exists(path) and build.poll() is None:
        time.sleep(1)
    return build.poll()


def phase_human(build, hg, grouped=None):
    """The human-scale genome on the card: HUMAN_CONTIG_MBP's 24 contigs
    (3,093,000,000 bases) through the CLI as a user types it
    (--no-coverage-search --tt-index, the default --max-index-bases: 2
    groups, chr1-11 and chr12-24, k = 13, sa_rate 4), on the group
    indexes the build child wrote (the phase starts once their record is
    written; hg is human_genome()'s tuple). A timed run of 16,384 reads
    records reads/s, stage seconds, group swaps and their seconds, each
    group's FMIndex bytes on the card (with phase 11's projection when
    `grouped` is given), peak device and host memory, whether the genome
    axis started and every realign call's R, E, L and q; its calls are
    held after it against their plain version on up to 2,048 of their
    rows. Fails with other
    than 2 groups, under 100% junction-read recall, with a designed
    intron missing from junctions.bed at its contig-local coordinates, a
    contiguous read not at its designed contig and POS, no read placed on
    a contig past 2^31, no sparse realign launch or any dense one, or the
    genome axis started."""
    import torch

    from tophat_tpu_torch.cli import main as cli_mod
    from tophat_tpu_torch.index.fm import FMIndex
    from tophat_tpu_torch.ops import events
    from tophat_tpu_torch.parallel import auto
    from tophat_tpu_torch.pipeline import grouped as grouped_mod
    from tophat_tpu_torch.pipeline import run as run_mod

    t_phase = time.time()
    fa, prefix, logf, rec = human_paths()
    rc = wait_for_record(build, rec)
    wait_s = time.time() - t_phase
    with open(logf) as f:
        tail = f.read()[-3000:]
    if rc not in (None, 0) or not os.path.exists(rec):
        fail(f"human-scale index build exited {rc}:\n{tail}")
    with open(rec) as f:
        built = json.load(f)
    log(f"human-scale build child: genome {built['synth_s']:.1f} s, FASTA "
        f"{built['fasta_s']:.1f} s ({'written' if built['fresh_fasta'] else 'reused'}), "
        f"{built['n_groups']} group indexes in {built['build_s']:.1f} s ("
        + ("fresh build" if built["reused_groups"] == 0 else
           f"{built['reused_groups']} reused from .smoke_cache/")
        + f"); peak host memory {built['peak_rss_bytes'] / 2**30:.2f} GiB, "
        f"build workers {built['worker_peak_rss_bytes'] / 2**30:.2f} GiB; "
        f"phase 16 waited {wait_s:.1f} s for it")

    t0 = time.time()
    codes, offsets, names, introns = hg
    seqs, truth = human_reads(codes, offsets, introns, 82, HUMAN_READS)
    fq = os.path.join(HUMAN_DIR, "reads_steady.fq")
    write_fastq(fq, seqs)
    n_past_introns = sum(int(offsets[c] >= POS_2P31) for c, _, _ in introns)
    log(f"human-scale inputs: {int(offsets[-1])} bases, {len(names)} "
        f"contigs, {len(introns)} designed introns ({n_past_introns} on "
        f"contigs past 2^31); {HUMAN_READS} reads ({time.time() - t0:.1f} s)")
    argv = lambda out, fq: (
        ["-o", out, "--no-coverage-search", "--tt-index", prefix]
        + (["--max-index-bases", str(HUMAN_MAX_INDEX_BASES)]
           if HUMAN_MAX_INDEX_BASES else []) + [fa, fq])

    to = FMIndex.to
    loads, axis = [], []    # each group transfer; the genome axis then

    def to_measured(self, device):
        axis.append(auto.genome_sharded())
        before = torch.cuda.memory_allocated()
        out = to(self, device)
        if out.device.type == "cuda":
            loads.append(dict(bases=self.n, bytes_on_card=int(
                torch.cuda.memory_allocated() - before),
                table_bytes=sum(fm_table_bytes(out).values())))
        return out

    FMIndex.to = to_measured
    build_fm = cli_mod.build_grouped_fm
    runs = []               # (groups, build messages) of each CLI run

    def build_seen(*a, **k):
        msgs, say = [], k.get("log")
        k["log"] = lambda m: (msgs.append(m), say and say(m))
        gfm = build_fm(*a, **k)
        runs.append((gfm.n_groups, msgs))
        return gfm

    cli_mod.build_grouped_fm = build_seen
    try:
        clock = StageClock()
        clock.wrap(cli_mod, "read_fasta", "read_fasta")
        clock.wrap(cli_mod, "build_grouped_fm",
                   "group index load (2 cached groups)")
        clock.wrap(FMIndex, "to", "group loads and swaps (FMIndex.to)")
        clock.wrap(grouped_mod, "align_reads_adaptive",
                   "full-read align (per group)")
        clock.wrap(grouped_mod, "_spliced_mate",
                   "segments + stitch (per group)")
        clock.wrap(grouped_mod, "discover_events", "discovery")
        clock.wrap(grouped_mod, "candidates_for_mate",
                   "candidates (realign, collect)")
        clock.wrap(run_mod, "realign_events_sparse",
                   "  of which realign, sparse")
        clock.wrap(grouped_mod, "default_chains", "default chains")
        clock.wrap(grouped_mod, "accumulate_event_stats", "stats + filter")
        clock.wrap(grouped_mod, "filter_junctions", "stats + filter")
        clock.wrap(grouped_mod, "write_outputs", "output")
        kept, calls = [], []
        keep = keep_calls(kept)

        def on_timed(kind, args, got):
            calls.append(realign_call_shape(kind, args))
            keep(kind, args, got)

        out = os.path.join(HUMAN_DIR, "out_steady")
        del loads[:]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        realign_launches(reset=True)
        t0 = time.time()
        try:
            with RealignHooks(events, on_timed), HostPeak() as host:
                cli_main_checked(cli_mod.main, argv(out, fq))
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = realign_launches()
        finally:
            clock.restore()
        peak = torch.cuda.max_memory_allocated()
    finally:
        FMIndex.to = to
        cli_mod.build_grouped_fm = build_fm
    n_groups, msgs = runs[-1]
    if n_groups != 2:
        fail(f"human-scale run: {n_groups} contig groups, not 2")
    if sum("reusing FM index" in m for m in msgs) != n_groups:
        fail("the human-scale CLI run did not reuse the child's group "
             f"indexes: {msgs}")
    stages = dict(clock.seconds)
    top = sum(v for k, v in stages.items() if not k.startswith(" "))
    stages["rest (FASTQ parse, prep, selection)"] = wall - top
    placed = human_placement(out, names, offsets, introns, truth)
    transfers = clock.calls.get("group loads and swaps (FMIndex.to)", 0)
    transfer_s = clock.seconds.get("group loads and swaps (FMIndex.to)", 0.0)
    groups = {}
    for x in loads:
        groups.setdefault(x["bases"], x)
    groups = [groups[n] for n in sorted(groups, reverse=True)]
    if grouped:             # phase 11's per-base bytes at these groups' sizes
        per_base = max(x["other_b_per_base"] for x in grouped["groups"])
        fixed = max(x["kmer_table_bytes"] for x in grouped["groups"])
        for x in groups:
            x["phase11_projection"] = fixed + per_base * x["bases"]
    log(f"human-scale timed run: {wall:.2f} s, {HUMAN_READS / wall:.1f} "
        f"reads/s; {transfers} group loads and swaps in {transfer_s:.3f} s; "
        f"realign launches {launches} (dense, sparse); peak device memory "
        f"{peak / 2**30:.3f} GiB (reached by the end of "
        f"{clock.peak_stage(peak)!r}); host peak RSS "
        f"{host.bytes / 2**30:.2f} GiB"
        + (" (the process's lifetime peak)" if host.lifetime else "")
        + f"; genome axis started: {any(axis)}")
    for k, v in stages.items():
        log(f"  stage {k}: {v:.3f} s" + calls_note(clock.calls.get(k)))
    for x in groups:
        log(f"  group of {x['bases']} bases: {x['bytes_on_card'] / 1e9:.3f} "
            f"GB on the card ({x['bytes_on_card'] / x['bases']:.3f} B/base; "
            f"tables {x['table_bytes'] / 1e9:.3f} GB)"
            + (f", phase 11's projection {x['phase11_projection'] / 1e9:.3f} "
               "GB" if "phase11_projection" in x else ""))
    log("  realign calls: " + ", ".join(calls))
    held = PathCheck(max_rows=HUMAN_HOLD_ROWS)
    t0 = time.time()
    for kind, args, got in kept:
        held(kind, args, got)
    log(f"human-scale timed run: realign exact in {len(held.shapes)} calls "
        f"({time.time() - t0:.1f} s)")
    del kept
    p = placed
    log(f"human-scale timed run: junction-read recall "
        f"{p['recall_pct']:.2f}%; designed introns found "
        f"{len(introns) - len(p['missing_introns'])}/{len(introns)}; "
        f"contiguous reads at their contig and POS "
        f"{p['n_contiguous'] - len(p['misplaced'])}/{p['n_contiguous']}; "
        f"{p['records_past_2p31']} records on contigs past 2^31 (largest "
        f"global position {p['max_global_pos']})")
    if p["recall_pct"] < 100.0:
        fail(f"human-scale timed run: junction-read recall "
             f"{p['recall_pct']:.2f}% < 100%")
    if p["missing_introns"]:
        fail(f"human-scale timed run: designed introns missing from "
             f"junctions.bed: {p['missing_introns'][:8]}")
    if p["misplaced"]:
        fail(f"human-scale timed run: {len(p['misplaced'])} contiguous "
             f"reads not at their designed contig and POS, e.g. "
             f"{p['misplaced'][:8]}")
    if not p["records_past_2p31"]:
        fail("human-scale timed run: no read placed on a contig past 2^31")
    if launches[0] or not launches[1]:
        fail(f"the human-scale run launched the realign kernel's entries "
             f"{launches} (dense, sparse) times; it must take the sparse "
             "entry only")
    if any(axis):
        fail("the human-scale run started the genome axis on one card")
    phase_s = time.time() - t_phase
    log(f"human scale: phase 16 took {phase_s:.1f} s")
    return dict(genome_bases=int(offsets[-1]), n_contigs=len(names),
                n_groups=built["n_groups"], build=built, build_wait_s=wait_s,
                wall_s=wall, reads_per_s=HUMAN_READS / wall,
                group_transfers=transfers,
                group_transfer_s=transfer_s, groups=groups,
                peak_device_bytes=peak, host_peak_rss_bytes=host.bytes,
                host_peak_lifetime=host.lifetime,
                genome_axis_started=any(axis),
                launches=launches, realign_calls=calls,
                path_err=held.err, stages=stages,
                stage_calls=dict(clock.calls),
                peak_stage=clock.peak_stage(peak),
                recall_pct=placed["recall_pct"],
                designed_introns=len(introns),
                introns_past_2p31=n_past_introns,
                records_past_2p31=placed["records_past_2p31"],
                max_global_pos=placed["max_global_pos"], phase_s=phase_s)


# --------------------------------------------------------------- phase 17

HUMAN_GENES = 57_820        # GENCODE release 19 (the hg19 annotation TopHat
HUMAN_TRANSCRIPTS = 196_520  # users pass with -G): genes and transcripts
HUMAN_MIN_EVENTS = 300_000  # phase 17 fails with fewer (both scale with the
#                             ladder's HUMAN_PER_MBP)
HUMAN_CHECK_PAIRS = 4096
HUMAN_PAIRS = 16384
GENE_ROOM = 30_000          # bases the widest gene may span (6 exons of 300
#                             bp, 5 introns of 5,000)
GENE_MARGIN = 2000          # no gene within this of a contig end


def human_scaled(count: int) -> int:
    """A count of the full-size ladder at HUMAN_PER_MBP's scale."""
    return int(round(count * HUMAN_PER_MBP / 1_000_000))


def human_annotation_paths():
    """(phase 17's GTF, its --transcriptome-index prefix, the build
    child's record of them)."""
    tag = f"hs{HUMAN_PER_MBP}"
    return (os.path.join(HUMAN_DIR, tag + ".gtf"),
            os.path.join(HUMAN_DIR, "tx", tag),
            os.path.join(HUMAN_DIR, tag + ".annotation.json"))


def write_human_gtf(path, codes, offsets, names, introns,
                    seed: int = HUMAN_SEED + 2):
    """Phase 17's annotation: a synthetic GTF with GENCODE 19's counts
    (HUMAN_GENES genes and HUMAN_TRANSCRIPTS transcripts, scaled) on phase
    16's genome. Genes are spread over the contigs in proportion to
    their length, one a slot, strands alternating; exons of 50-300 bp
    and introns of 70-5,000 bp at naturally occurring GT..AG (CT..AC on
    the forward strand for '-' genes), as exon_chain makes them. A gene
    has 3 isoforms, or 4 in HUMAN_TRANSCRIPTS - 3 HUMAN_GENES genes
    spread evenly: every exon, then one isoform for each of 2 or 3
    internal exons skipped, a different one each. No intron equals one
    of phase 16's `introns`. Writes the GTF; returns (the transcripts'
    exons [(start, end), ...] at global 0-based coordinates, in file
    order, and the distinct introns {(last exonic base, first exonic
    base after)}, global)."""
    rng = np.random.default_rng(seed)
    n_genes = human_scaled(HUMAN_GENES)
    n4 = human_scaled(HUMAN_TRANSCRIPTS) - 3 * n_genes
    sizes = np.diff(offsets)
    per = np.diff(np.rint(n_genes * np.concatenate(
        [[0], np.cumsum(sizes)]) / offsets[-1])).astype(np.int64)
    planted = set(introns)
    transcripts, distinct = [], set()
    gi = 0
    with open(path, "w") as f:
        for c, name in enumerate(names):
            base, size, n_c = int(offsets[c]), int(sizes[c]), int(per[c])
            seq = codes[base:base + size]
            motifs = {"+": (_motif(seq, 2, 3), _motif(seq, 0, 2)),
                      "-": (_motif(seq, 1, 3), _motif(seq, 0, 1))}
            slot = (size - 2 * GENE_MARGIN - GENE_ROOM) / max(n_c, 1)
            p = GENE_MARGIN
            for j in range(n_c):
                p = max(p, GENE_MARGIN + int(j * slot))
                strand = "+-"[gi % 2]
                n_iso = 4 if (gi + 1) * n4 // n_genes > gi * n4 // n_genes \
                    else 3
                while True:
                    if p + GENE_ROOM > size - GENE_MARGIN:
                        fail(f"human annotation: no room for gene {gi} on "
                             f"{name}")
                    k = int(rng.integers(n_iso + 1, 7))
                    exons = exon_chain(rng, *motifs[strand], p, k)
                    if len(exons) == k:
                        skips = sorted(rng.choice(np.arange(1, k - 1),
                                                  n_iso - 1, replace=False))
                        isoforms = [exons] + [exons[:x] + exons[x + 1:]
                                              for x in skips]
                        gene = {(e1 - 1, s2) for ex in isoforms
                                for (_, e1), (s2, _) in zip(ex, ex[1:])}
                        if not any((c, a, b) in planted for a, b in gene):
                            break
                    p = (exons[-1][1] if exons else p) + 100
                for ti, ex in enumerate(isoforms):
                    f.write("".join(
                        f'{name}\tsmoke\texon\t{a + 1}\t{b}\t.\t{strand}\t.'
                        f'\tgene_id "g{gi}"; transcript_id "g{gi}.{ti + 1}";'
                        "\n" for a, b in ex))
                    transcripts.append([(base + a, base + b) for a, b in ex])
                distinct |= {(base + a, base + b) for a, b in gene}
                p = exons[-1][1] + int(rng.integers(300, 3000))
                gi += 1
    return transcripts, distinct


def human_annotation_build(codes, offsets, names, introns):
    """The build child's second part: phase 17's GTF (write_human_gtf),
    then the transcriptome files and FM index that the CLI's
    --transcriptome-index makes (parse_gtf, write_transcriptome_files,
    build_transcriptome_index, on the CPU) under the prefix the CLI
    gets, so the CLI reuses them. Writes their seconds, counts and the
    peak host memory as JSON."""
    import resource

    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.io.gtf import parse_gtf, write_transcriptome_files
    from tophat_tpu_torch.pipeline.transcriptome import \
        build_transcriptome_index

    gtf, tprefix, rec = human_annotation_paths()
    os.makedirs(os.path.dirname(tprefix), exist_ok=True)
    if os.path.exists(tprefix + ".tt.npz"):
        os.remove(tprefix + ".tt.npz")      # build, never reuse, here
    t0 = time.time()
    transcripts, distinct = write_human_gtf(gtf, codes, offsets, names,
                                            introns)
    gtf_s = time.time() - t0
    genome = Genome(codes=codes, offsets=offsets, names=names)
    t0 = time.time()
    parsed = parse_gtf(gtf)
    parse_s = time.time() - t0
    t0 = time.time()
    write_transcriptome_files(tprefix, genome, parsed, gtf)
    files_s = time.time() - t0
    t0 = time.time()
    tix = build_transcriptome_index(genome, parsed, prefix=tprefix,
                                    log=print, device="cpu")
    index_s = time.time() - t0
    lefts = np.array(sorted(a for a, _ in distinct), np.int64)
    contig = np.searchsorted(offsets, lefts, side="right") - 1
    with open(rec + ".tmp", "w") as f:
        json.dump(dict(
            genes=human_scaled(HUMAN_GENES), transcripts=len(transcripts),
            gtf_transcripts=len(parsed), introns=len(distinct),
            introns_past_2p31=int((offsets[contig] >= POS_2P31).sum()),
            gtf_bytes=os.path.getsize(gtf), exon_lines=sum(
                len(t) for t in transcripts),
            transcriptome_bases=int(tix.n), gtf_s=gtf_s, parse_s=parse_s,
            files_s=files_s, index_s=index_s,
            peak_rss_bytes=1024 * resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss), f)
    os.replace(rec + ".tmp", rec)


def human_transcripts(gtf, names, offsets):
    """The transcripts of phase 17's GTF as parse_gtf reads them, in file
    order: [(start, end), ...] exons at global 0-based coordinates."""
    from tophat_tpu_torch.io.gtf import parse_gtf

    cid = {nm: c for c, nm in enumerate(names)}
    return [[(int(offsets[cid[t.chrom]]) + a, int(offsets[cid[t.chrom]]) + b)
             for a, b in t.exons] for t in parse_gtf(gtf).values()]


def sam_introns(out) -> set:
    """{(contig, last exonic base, first exonic base after)} of every N
    in the CIGARs of a run's accepted_hits.sam, contig-local and
    0-based."""
    import re

    found = set()
    with open(os.path.join(out, "accepted_hits.sam")) as f:
        for line in f:
            if line.startswith("@"):
                continue
            t = line.split("\t", 6)
            if "N" not in t[5]:
                continue
            p = int(t[3]) - 1
            for n, op in re.findall(r"(\d+)([MIDNSHP=X])", t[5]):
                if op == "N":
                    found.add((t[2], p - 1, p + int(n)))
                if op in "MDN=X":
                    p += int(n)
    return found


def exact_elsewhere(out, codes, names, offsets, mates, wanted) -> set:
    """The (pair, mate)s of `wanted` that accepted_hits.sam reports
    where they match the genome base for base, at the record's contig,
    contig-local POS and CIGAR: mates placed exactly, wherever that is.
    mates = (mate-1 rows, mate-2 rows) of codes."""
    import re

    from tophat_tpu_torch.index.fasta import revcomp

    cid = {nm: c for c, nm in enumerate(names)}
    ok = set()
    with open(os.path.join(out, "accepted_hits.sam")) as f:
        for line in f:
            if line.startswith("@"):
                continue
            t = line.split("\t", 6)
            flag = int(t[1])
            key = (int(t[0][1:]), 1 if flag & 0x40 else 2)
            if key not in wanted or t[2] == "*":
                continue
            read = mates[key[1] - 1][key[0]]
            read = revcomp(read) if flag & 0x10 else read
            p, q, exact = int(offsets[cid[t[2]]]) + int(t[3]) - 1, 0, True
            for n, op in re.findall(r"(\d+)([MIDNSHP=X])", t[5]):
                n = int(n)
                if op in "M=X":
                    exact &= np.array_equal(codes[p:p + n], read[q:q + n])
                p += n if op in "MDN=X" else 0
                q += n if op in "MIS=X" else 0
            if exact and q == len(read):
                ok.add(key)
    return ok


def human_annotated_placement(out, names, offsets, reads, crossed, codes,
                              mates) -> dict:
    """What a phase-17 run wrote: annotated-junction mate and
    unannotated-intron mate-1 recall, the planted introns that its
    designed mates cross but junctions.bed lacks, the annotated introns
    on contigs past 2^31 that they cross but no record's CIGAR places at
    their contig-local coordinates (a paired run's junctions.bed, in both
    packages, lists no junction of a transcriptome placement), unless
    every mate crossing one is reported elsewhere base for base (a short
    anchor that fits another isoform exactly, which pair grading may
    pick), and the records on contigs past 2^31."""
    _, spans, unannotated = reads
    recall_a, recall_u, n_span = annotated_recall(out, spans, unannotated)
    found = bed_junctions(out)
    placed = sam_introns(out)
    past = {names[c] for c in range(len(names)) if offsets[c] >= POS_2P31}

    def local(left, right):
        c = int(np.searchsorted(offsets, left, side="right")) - 1
        return (names[c], left - int(offsets[c]), right - int(offsets[c]))

    planted = [local(a, b) for a, b, ann in crossed if not ann]
    annotated_past = [local(a, b) for a, b, ann in crossed
                      if ann and local(a, b)[0] in past]
    unplaced = [(a, b) for a, b, ann in crossed if ann
                and local(a, b)[0] in past and local(a, b) not in placed]
    exact = exact_elsewhere(out, codes, names, offsets, mates, {
        m for a, b in unplaced for m in crossed[(a, b, True)]})
    missing = [local(a, b) for a, b in unplaced
               if not all(m in exact for m in crossed[(a, b, True)])]
    n_past = 0
    with open(os.path.join(out, "accepted_hits.sam")) as f:
        for line in f:
            if not line.startswith("@"):
                n_past += line.split("\t", 3)[2] in past
    return dict(recall_annotated_pct=recall_a,
                recall_unannotated_pct=recall_u, annotated_mates=n_span,
                planted_crossed=len(planted),
                missing_planted=[x for x in planted if x not in found],
                annotated_past_2p31_crossed=len(annotated_past),
                missing_annotated_past_2p31=missing,
                annotated_past_2p31_exact_elsewhere=len(unplaced)
                - len(missing),
                annotated_in_bed=sum(x in found for a, b, ann in crossed
                                     if ann for x in [local(a, b)]),
                records_past_2p31=n_past)


def phase_human_annotated(build, hg):
    """TopHat's annotated paired default run on the human-scale genome,
    `tophat -G genes.gtf --transcriptome-index ... genome r1.fq r2.fq`,
    through the CLI: phase 16's genome, FASTA and group indexes (the
    default --max-index-bases: 2 groups), the coverage search on, and the
    build child's GENCODE-sized GTF, transcriptome files and index
    (reused by the CLI). Pairs of 2 x 100 bp as make_annotated_pairs
    makes them (50% transcript fragments, 10% with mate 1 across one of
    phase 16's planted introns, the rest contiguous within a contig). A
    run of 4,096 pairs holds every realign call against its plain
    version on up to 2,048 of its rows; a timed run of 16,384 pairs
    records pairs/s, stage seconds (the coverage search, the GTF parse,
    the transcriptome load and map each their own), group swaps, E (in
    all and per group), every realign call's R, E, L and q (held after
    the run the same way), peak device and host memory, the concordant
    share and whether the coverage search's MAX_COV_EVENTS bound. Fails
    with other than 2 groups, a group or transcriptome index not reused,
    under 100% annotated-junction mate or unannotated-intron mate-1
    recall, a crossed planted intron missing from junctions.bed at its
    contig-local coordinates, a crossed annotated intron on a contig
    past 2^31 that no record's CIGAR places there while a mate crossing
    it is not reported exactly elsewhere (junctions.bed lists no
    junction of a transcriptome placement in a paired run, in the JAX
    package and the port alike), no mate placed past 2^31, E under HUMAN_MIN_EVENTS
    (scaled), no sparse realign launch or any dense one, or the genome
    axis started."""
    import torch

    from tophat_tpu_torch.cli import main as cli_mod
    from tophat_tpu_torch.index.fm import FMIndex
    from tophat_tpu_torch.ops import events
    from tophat_tpu_torch.parallel import auto
    from tophat_tpu_torch.pipeline import grouped as grouped_mod
    from tophat_tpu_torch.pipeline import paired as paired_mod
    from tophat_tpu_torch.pipeline import run as run_mod
    from tophat_tpu_torch.pipeline.coverage import MAX_COV_EVENTS

    t_phase = time.time()
    codes, offsets, names, introns = hg
    fa, prefix, logf, _ = human_paths()
    gtf, tprefix, arec = human_annotation_paths()
    rc = wait_for_record(build, arec)
    wait_s = time.time() - t_phase
    with open(logf) as f:
        tail = f.read()[-3000:]
    if rc not in (None, 0) or not os.path.exists(arec):
        fail(f"human-scale annotation build exited {rc}:\n{tail}")
    with open(arec) as f:
        built = json.load(f)
    log(f"human-scale annotation (build child): {built['genes']} genes, "
        f"{built['transcripts']} transcripts, {built['exon_lines']} exon "
        f"lines, {built['introns']} distinct introns "
        f"({built['introns_past_2p31']} on contigs past 2^31); GTF "
        f"{built['gtf_s']:.1f} s, parse {built['parse_s']:.1f} s, "
        f"transcriptome files {built['files_s']:.1f} s, transcriptome FM "
        f"index of {built['transcriptome_bases']} bases "
        f"{built['index_s']:.1f} s; peak host memory "
        f"{built['peak_rss_bytes'] / 2**30:.2f} GiB; phase 17 waited "
        f"{wait_s:.1f} s for it")

    t0 = time.time()
    transcripts = human_transcripts(gtf, names, offsets)
    planted = [(int(offsets[c]) + a, int(offsets[c]) + b)
               for c, a, b in introns]
    reads, crossed, mates = {}, {}, {}
    for tag, seed, n in (("check", 91, HUMAN_CHECK_PAIRS),
                         ("steady", 92, HUMAN_PAIRS)):
        crossed[tag] = {}
        m1, m2, spans, unannotated = make_annotated_pairs(
            codes, transcripts, planted, seed, n, offsets=offsets,
            crossed=crossed[tag])
        mates[tag] = (m1, m2)
        fqs = [os.path.join(HUMAN_DIR, f"pairs_{tag}_{k}.fq") for k in (1, 2)]
        write_fastq(fqs[0], m1, "p")
        write_fastq(fqs[1], m2, "p")
        reads[tag] = (fqs, spans, unannotated)
    log(f"human-scale annotated inputs: {len(transcripts)} transcripts "
        f"parsed; {HUMAN_CHECK_PAIRS} + {HUMAN_PAIRS} pairs "
        f"({time.time() - t0:.1f} s)")
    argv = lambda out, fqs: (
        ["-o", out, "-G", gtf, "--transcriptome-index", tprefix,
         "--tt-index", prefix]
        + (["--max-index-bases", str(HUMAN_MAX_INDEX_BASES)]
           if HUMAN_MAX_INDEX_BASES else []) + [fa] + fqs)

    to = FMIndex.to
    axis, runs, n_events, cov_sizes = [], [], [], []

    def to_seen(self, device):
        axis.append(auto.genome_sharded())
        return to(self, device)

    build_fm = cli_mod.build_grouped_fm

    def build_seen(*a, **k):
        msgs, say = [], k.get("log")
        k["log"] = lambda m: (msgs.append(m), say and say(m))
        gfm = build_fm(*a, **k)
        runs.append((gfm.n_groups, msgs))
        return gfm

    finalize = grouped_mod.GroupedMapper.finalize_events

    def finalize_counted(self, known_events=None):
        ev = finalize(self, known_events)
        n_events.append((len(ev["left"]),
                         [len(e["left"]) for e in self.group_events]))
        return ev

    coverage = grouped_mod.coverage_search_events

    def coverage_counted(*a, **k):
        ev = coverage(*a, **k)
        cov_sizes.append(len(ev["left"]))
        return ev

    FMIndex.to = to_seen
    cli_mod.build_grouped_fm = build_seen
    grouped_mod.GroupedMapper.finalize_events = finalize_counted
    grouped_mod.coverage_search_events = coverage_counted
    try:
        check = PathCheck(max_rows=HUMAN_HOLD_ROWS)
        out_check = os.path.join(HUMAN_DIR, "annot_out_check")
        t0 = time.time()
        with RealignHooks(events, check):
            cli_main_checked(cli_mod.main, argv(out_check,
                                                reads["check"][0]))
        check_s = time.time() - t0
        log(f"human-scale annotated check run: {check_s:.1f} s; realign "
            f"exact in {len(check.shapes)} calls: " + ", ".join(check.shapes))
        n_groups, msgs = runs[-1]
        if n_groups != 2:
            fail(f"human-scale annotated run: {n_groups} contig groups, "
                 "not 2")
        if sum("reusing FM index" in m for m in msgs) != n_groups:
            fail("the human-scale annotated run did not reuse the group "
                 f"indexes: {msgs}")
        with open(os.path.join(out_check, "logs", "tophat.log")) as f:
            if "transcriptome FM index: reusing" not in f.read():
                fail("the human-scale annotated run did not reuse the "
                     "build child's transcriptome index")
        checked = human_annotated_placement(
            out_check, names, offsets, reads["check"], crossed["check"],
            codes, mates["check"])

        clock = StageClock()
        clock.wrap(cli_mod, "read_fasta", "read_fasta")
        clock.wrap(cli_mod, "build_grouped_fm",
                   "group index load (2 cached groups)")
        clock.wrap(FMIndex, "to", "group loads and swaps (FMIndex.to)")
        clock.wrap(cli_mod, "parse_gtf",
                   "GTF parse (parse_gtf, gtf_junctions)")
        clock.wrap(cli_mod, "gtf_junctions",
                   "GTF parse (parse_gtf, gtf_junctions)")
        clock.wrap(cli_mod, "build_transcriptome_index",
                   "transcriptome index reuse (sequences + FMIndex.load)")
        clock.wrap(grouped_mod, "map_reads_transcriptome",
                   "transcriptome map (align + rebase)")
        clock.wrap(grouped_mod, "align_reads_adaptive",
                   "full-read align (per group)")
        clock.wrap(grouped_mod, "_spliced_mate",
                   "segments + stitch (per group)")
        clock.wrap(grouped_mod, "discover_events", "discovery")
        clock.wrap(grouped_mod, "coverage_search_events", "coverage search")
        clock.wrap(grouped_mod, "candidates_for_mate",
                   "candidates (realign, collect)")
        clock.wrap(run_mod, "realign_events_sparse",
                   "  of which realign, sparse")
        clock.wrap(grouped_mod, "transcriptome_candidates",
                   "transcriptome candidates")
        clock.wrap(grouped_mod, "default_chains", "default chains")
        clock.wrap(paired_mod, "accumulate_event_stats", "stats + filter")
        clock.wrap(paired_mod, "filter_junctions", "stats + filter")
        kept, calls = [], []
        keep = keep_calls(kept)

        def on_timed(kind, args, got):
            calls.append(realign_call_shape(kind, args))
            keep(kind, args, got)

        out = os.path.join(HUMAN_DIR, "annot_out_steady")
        del cov_sizes[:], n_events[:]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        realign_launches(reset=True)
        t0 = time.time()
        try:
            with RealignHooks(events, on_timed), HostPeak() as host:
                cli_main_checked(cli_mod.main, argv(out, reads["steady"][0]))
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = realign_launches()
        finally:
            clock.restore()
        peak = torch.cuda.max_memory_allocated()
    finally:
        FMIndex.to = to
        cli_mod.build_grouped_fm = build_fm
        grouped_mod.GroupedMapper.finalize_events = finalize
        grouped_mod.coverage_search_events = coverage
    stages = dict(clock.seconds)
    top = sum(v for k, v in stages.items() if not k.startswith(" "))
    stages["rest (FASTQ parse, prep, selection, pair grading, output)"] = \
        wall - top
    placed = human_annotated_placement(out, names, offsets, reads["steady"],
                                       crossed["steady"], codes,
                                       mates["steady"])
    E, group_E = n_events[-1] if n_events else (0, [])
    on_tx = reads_on_transcripts(os.path.join(out, "logs", "tophat.log"))
    aligned, disc = align_summary_pairs(os.path.join(out,
                                                     "align_summary.txt"))
    concordant = 100.0 * (aligned - disc) / HUMAN_PAIRS
    cov_bound = any(x >= MAX_COV_EVENTS for x in cov_sizes)
    transfers = clock.calls.get("group loads and swaps (FMIndex.to)", 0)
    transfer_s = clock.seconds.get("group loads and swaps (FMIndex.to)", 0.0)
    log(f"human-scale annotated timed run: {wall:.2f} s, "
        f"{HUMAN_PAIRS / wall:.1f} pairs/s; E={E} (per group {group_E}); "
        f"{on_tx} reads placed on transcripts; {transfers} group loads and "
        f"swaps in {transfer_s:.3f} s; realign launches {launches} (dense, "
        f"sparse); peak device memory {peak / 2**30:.3f} GiB; host peak "
        f"RSS {host.bytes / 2**30:.2f} GiB"
        + (" (the process's lifetime peak)" if host.lifetime else "")
        + f"; concordant {concordant:.2f}% of pairs; coverage search "
        f"events per call {cov_sizes} (MAX_COV_EVENTS {MAX_COV_EVENTS} "
        f"{'bound' if cov_bound else 'not reached'}); genome axis started: "
        f"{any(axis)}")
    for k, v in stages.items():
        log(f"  stage {k}: {v:.3f} s" + calls_note(clock.calls.get(k)))
    log("  realign calls: " + ", ".join(calls))
    held = PathCheck(max_rows=HUMAN_HOLD_ROWS)
    t0 = time.time()
    for kind, args, got in kept:
        held(kind, args, got)
    log(f"human-scale annotated timed run: realign exact in "
        f"{len(held.shapes)} calls ({time.time() - t0:.1f} s)")
    del kept
    for tag, p in (("check", checked), ("timed", placed)):
        log(f"human-scale annotated {tag} run: recall "
            f"{p['recall_annotated_pct']:.2f}% of {p['annotated_mates']} "
            f"annotated-junction mates, {p['recall_unannotated_pct']:.2f}% "
            f"of unannotated-intron mates 1; planted introns crossed "
            f"{p['planted_crossed']}, missing from junctions.bed "
            f"{len(p['missing_planted'])}; annotated introns crossed past "
            f"2^31 {p['annotated_past_2p31_crossed']}, not placed by a "
            f"record {len(p['missing_annotated_past_2p31'])} (their mates "
            f"all placed exactly elsewhere: "
            f"{p['annotated_past_2p31_exact_elsewhere']}); crossed "
            f"annotated introns in junctions.bed {p['annotated_in_bed']}; "
            f"{p['records_past_2p31']} records on contigs past 2^31")
        if min(p["recall_annotated_pct"], p["recall_unannotated_pct"]) < 100:
            fail(f"human-scale annotated {tag} run: recall "
                 f"{p['recall_annotated_pct']:.2f}% (annotated), "
                 f"{p['recall_unannotated_pct']:.2f}% (unannotated) < 100%")
        if p["missing_planted"]:
            fail(f"human-scale annotated {tag} run: planted introns missing "
                 f"from junctions.bed: {p['missing_planted'][:8]}")
        if p["missing_annotated_past_2p31"]:
            fail(f"human-scale annotated {tag} run: annotated introns past "
                 f"2^31 that no record places at their contig-local "
                 f"coordinates: {p['missing_annotated_past_2p31'][:8]}")
        if not p["records_past_2p31"]:
            fail(f"human-scale annotated {tag} run: no mate placed on a "
                 "contig past 2^31")
    if E < human_scaled(HUMAN_MIN_EVENTS):
        fail(f"human-scale annotated run: E = {E} < "
             f"{human_scaled(HUMAN_MIN_EVENTS)} events")
    if launches[0] or not launches[1]:
        fail(f"the human-scale annotated run launched the realign kernel's "
             f"entries {launches} (dense, sparse) times; it must take the "
             "sparse entry only")
    if any(axis):
        fail("the human-scale annotated run started the genome axis on one "
             "card")
    phase_s = time.time() - t_phase
    log(f"human scale, annotated: phase 17 took {phase_s:.1f} s")
    return dict(annotation=built, build_wait_s=wait_s, wall_s=wall,
                pairs_per_s=HUMAN_PAIRS / wall, check_run_s=check_s,
                events=E, group_events=group_E, reads_on_transcripts=on_tx,
                group_transfers=transfers, group_transfer_s=transfer_s,
                peak_device_bytes=peak, host_peak_rss_bytes=host.bytes,
                host_peak_lifetime=host.lifetime,
                genome_axis_started=any(axis), launches=launches,
                realign_calls=calls, path_err=max(check.err, held.err),
                coverage_events=cov_sizes, max_cov_events_bound=cov_bound,
                concordant_pct=concordant, stages=stages,
                stage_calls=dict(clock.calls),
                check={k: v for k, v in checked.items()
                       if not k.startswith("missing")},
                timed={k: v for k, v in placed.items()
                       if not k.startswith("missing")}, phase_s=phase_s)


# --------------------------------------------------------------- phase 18

HUMAN_FUSION_PAIRS = 16384
BREAK_MARGIN = 2000         # phase 10's: partners this far from a contig
#                             end (and here from every planted intron)
BREAKS_PER_GROUP = 12       # 4 ff, 4 fr, 4 rf; 2 of each between contigs
BCR_ABL1 = (8, 21)          # chr9 and chr22: BCR-ABL1's contigs on hg19


def human_break_sep() -> int:
    """Least distance of a break's two partners on one contig: phase 10's
    1 Mb, scaled with the ladder, and past --fusion-min-dist (100,000) so
    the 1/1,000 rehearsal still calls them fusions."""
    return max(human_scaled(1_000_000), 101_000)


def pick_human_breaks(offsets, introns, groups, seed: int = 101):
    """Phase 18's designed breaks on the human ladder, (dir, a, b) at
    global 0-based positions as pick_fusion_breaks gives them. Within each
    contig group (`groups`: contig ranges), BREAKS_PER_GROUP: 4 ff, 4 fr
    and 4 rf, of each direction 2 between two contigs of the group and 2
    within one contig (partners >= human_break_sep() apart); in the last
    group all on contigs that start past 2^31 but an ff between its first
    two contigs (chr12-chr13) and an ff within the contig that straddles
    2^31 (chr13, its partners either side of 2^31; at a smaller
    HUMAN_PER_MBP, of 2^31 scaled with the ladder). Every
    partner lies BREAK_MARGIN or more from a contig end and from every
    planted intron; every other break has its second partner before the
    first. Then 4 breaks across the groups, which the grouped fusion
    search cannot see: chr9-chr22 (BCR-ABL1) and 3 drawn at random.
    Returns (within, cross)."""
    r = np.random.default_rng(seed)
    sep = human_break_sep()
    past = human_scaled(POS_2P31)
    sizes = np.diff(offsets)
    planted = {}
    for c, left, right in introns:
        planted.setdefault(c, []).append((left, right))

    def draw(c, lo=0, hi=None):
        lo = max(lo, BREAK_MARGIN)
        hi = min(int(sizes[c]) if hi is None else hi,
                 int(sizes[c]) - BREAK_MARGIN)
        while True:
            x = int(r.integers(lo, hi))
            if all(not left - BREAK_MARGIN <= x <= right + BREAK_MARGIN
                   for left, right in planted.get(c, ())):
                return int(offsets[c]) + x

    def pair(ca, cb, k: int):
        cut = past - int(offsets[ca])
        straddle = ca == cb and 0 < cut < sizes[ca]
        while True:
            if straddle:
                a, b = draw(ca, hi=cut), draw(ca, lo=cut)
            else:
                a, b = draw(ca), draw(cb)
            if ca != cb or abs(a - b) >= sep:
                break
        return (a, b) if (a < b) == (k % 2 == 0) else (b, a)

    within = []
    for gi, cids in enumerate(groups):
        cids = list(cids)
        last = gi == len(groups) - 1 and gi > 0
        pool = [c for c in cids if not last or offsets[c] >= past]
        roomy = [c for c in pool if sizes[c] - 2 * BREAK_MARGIN > sep]
        for d in ("ff", "fr", "rf"):
            for k in range(BREAKS_PER_GROUP // 3):
                if last and d == "ff" and k == 0:
                    ca, cb = cids[0], cids[1]
                elif last and d == "ff" and k == 2:
                    ca = cb = cids[1]
                elif k < 2:
                    ca, cb = (int(x) for x in r.choice(pool, 2,
                                                       replace=False))
                else:
                    ca = cb = int(r.choice(roomy))
                within.append((d,) + pair(ca, cb, k))
    cross = [("ff",) + pair(*BCR_ABL1, 0)]
    for k, d in enumerate(("fr", "rf", "ff")):
        cross.append((d,) + pair(int(r.choice(list(groups[0]))),
                                 int(r.choice(list(groups[-1]))), k + 1))
    return within, cross


def human_break_groups(offsets, groups, breaks):
    """Per break: (group of its first partner, both partners past 2^31)."""
    group_of = {c: gi for gi, cids in enumerate(groups) for c in cids}
    out = []
    for _, a, b in breaks:
        c = int(np.searchsorted(offsets, a, side="right")) - 1
        out.append((group_of[c], min(a, b) >= POS_2P31))
    return out


def phase_human_fusion(build, hg):
    """TopHat-Fusion on the human-scale genome, both of its entry points
    as its manual gives them: `tophat --fusion-search ...` (FUSION_FLAGS)
    through the CLI on phase 16's genome and FASTA, 2 contig groups (the
    default --max-index-bases), whose group caches the build child wrote
    and which both CLIs find at the FASTA's own prefix (symlinks
    hs<N>.fa.g<i>.tt.npz -> hs<N>.g<i>.tt.npz: no copy, no build), then
    tophat-fusion-post on the card from the sample's parent directory.
    Designed breaks (pick_human_breaks): 12 within each group, 10 of the
    last group's on contigs past 2^31, half between two contigs of a
    group; 4 across the groups (chr9-chr22 among them), which grouped
    fusion search does not see (ROADMAP Queue 3): their count in
    fusions.out is recorded, not held. Pairs as make_fusion_pairs makes
    them (10% mate 1 across a within-group break, 10% around one, 20%
    mate 1 across a planted intron, 2% to the cross-group breaks, the rest
    contiguous within a contig). A timed run of 16,384 pairs records
    pairs/s, stage seconds (map, segments, candidates, chains and
    realign, fusion stats, read_fasta, the group load and each transfer),
    chain seconds per group, group swaps, E per group, every realign call
    (held after the run against its plain version on up to 2,048 of its
    rows), peak device and host memory; fusion-post records its seconds
    by stage. It runs once phase 16 has seen the group indexes, beside
    the build child's phase-17 inputs.
    Fails with other than 2 groups, a group index built by either CLI,
    under 100% break-read or junction-read recall, a within-group
    designed break missing from fusions.out at its contigs and
    contig-local coordinates, no designed break in result.txt, no sparse
    realign launch or any dense one, or the genome axis started."""
    import functools

    import torch

    from tophat_tpu_torch.cli import fusion_post
    from tophat_tpu_torch.cli import main as cli_mod
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.index.fm import FMIndex
    from tophat_tpu_torch.index.grouped import (MAX_GROUP_BASES,
                                                contig_group_ranges)
    from tophat_tpu_torch.ops import events
    from tophat_tpu_torch.parallel import auto
    from tophat_tpu_torch.pipeline import fusion_stats
    from tophat_tpu_torch.pipeline import grouped as grouped_mod
    from tophat_tpu_torch.pipeline import juncs as juncs_mod
    from tophat_tpu_torch.pipeline import paired as paired_mod
    from tophat_tpu_torch.pipeline import run as run_mod

    t_phase = time.time()
    codes, offsets, names, introns = hg
    fa, prefix, logf, _ = human_paths()
    rc = build.poll()
    if rc not in (None, 0):
        fail(f"human-scale build child exited {rc}")
    max_bases = HUMAN_MAX_INDEX_BASES or MAX_GROUP_BASES
    groups = contig_group_ranges(Genome(codes=codes, offsets=offsets,
                                        names=names), max_bases)
    if len(groups) != 2:
        fail(f"human-scale fusion: {len(groups)} contig groups, not 2")
    for i in range(len(groups)):
        link, target = f"{fa}.g{i}.tt.npz", f"{prefix}.g{i}.tt.npz"
        if not os.path.exists(target):
            fail(f"human-scale fusion: the build child left no {target}")
        if os.path.lexists(link):
            os.remove(link)
        os.symlink(os.path.basename(target), link)

    t0 = time.time()
    breaks, cross = pick_human_breaks(offsets, introns, groups)
    where = human_break_groups(offsets, groups, breaks)
    planted = [(int(offsets[c]) + a, int(offsets[c]) + b)
               for c, a, b in introns]
    m1, m2, fused = make_fusion_pairs(codes, planted, breaks, 112,
                                      HUMAN_FUSION_PAIRS, offsets=offsets,
                                      cross=cross)
    fqs = [os.path.join(HUMAN_DIR, f"fusion_steady_{k}.fq") for k in (1, 2)]
    write_fastq(fqs[0], m1, "p")
    write_fastq(fqs[1], m2, "p")
    inside = {i: v for i, v in fused.items() if v[:3] in breaks}
    across = {i: v for i, v in fused.items() if v[:3] in cross}
    n_between = sum(int(np.searchsorted(offsets, a, side="right"))
                    != int(np.searchsorted(offsets, b, side="right"))
                    for _, a, b in breaks)
    log(f"human-scale fusion inputs: {len(breaks)} within-group breaks "
        f"({[sum(g == gi for g, _ in where) for gi in range(2)]} a group, "
        f"{sum(p for _, p in where)} past 2^31, {n_between} between two "
        f"contigs), {len(cross)} across the groups; {HUMAN_FUSION_PAIRS} "
        f"pairs ({time.time() - t0:.1f} s)")
    cap = (["--max-index-bases", str(HUMAN_MAX_INDEX_BASES)]
           if HUMAN_MAX_INDEX_BASES else [])
    argv = lambda out, fqs: ["-o", out] + FUSION_FLAGS + cap + [fa] + fqs

    to = FMIndex.to
    axis, runs, n_events, transfers = [], [], [], []

    def to_seen(self, device):
        axis.append(auto.genome_sharded())
        t = time.perf_counter()
        out = to(self, device)
        if out.device.type == "cuda":
            torch.cuda.synchronize()
            transfers.append(time.perf_counter() - t)
        return out

    build_fm = cli_mod.build_grouped_fm

    def build_seen(*a, **k):
        msgs, say = [], k.get("log")
        k["log"] = lambda m: (msgs.append(m), say and say(m))
        gfm = build_fm(*a, **k)
        runs.append((gfm.n_groups, msgs))
        return gfm

    finalize = grouped_mod.GroupedMapper.finalize_events

    def finalize_counted(self, known_events=None):
        ev = finalize(self, known_events)
        n_events.append((len(ev["left"]),
                         [len(e["left"]) for e in self.group_events]))
        return ev

    sizes = [int(offsets[g.stop] - offsets[g.start]) for g in groups]
    group_now = [0]
    chain_s = [0.0] * len(groups)
    cands = grouped_mod.candidates_for_mate

    def cands_in_group(fm, *a, **k):
        group_now[0] = sizes.index(fm.n)
        return cands(fm, *a, **k)

    chain_fns = {n: getattr(run_mod, n)
                 for n in ("chain_stitch", "cross_strand_chains")}

    def chain_timed(fn):
        def timed(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                chain_s[group_now[0]] += time.perf_counter() - t
        return timed

    def tally(found):
        """Count designed breaks: in all, per group, and with both
        partners past 2^31."""
        got = set(found)
        return dict(n=len(got), per_group=[
            sum(b in got and g == gi for b, (g, _) in zip(breaks, where))
            for gi in range(len(groups))], past_2p31=sum(
            b in got and p for b, (_, p) in zip(breaks, where)))

    def placed(out):
        n = HUMAN_FUSION_PAIRS
        rb, rj, missing = fusion_recall(out, codes, breaks, inside, n,
                                        offsets, names)
        _, _, cross_missing = fusion_recall(out, codes, cross, across, n,
                                            offsets, names)
        found = [b for b in breaks if b not in missing]
        return dict(recall_break_reads_pct=rb, recall_junction_pct=rj,
                    missing=missing, fusions_out=tally(found),
                    cross_found=len(cross) - len(cross_missing),
                    fusions_out_lines=sum(1 for _ in open(os.path.join(
                        out, "fusions.out"))))

    FMIndex.to = to_seen
    cli_mod.build_grouped_fm = build_seen
    grouped_mod.GroupedMapper.finalize_events = finalize_counted
    grouped_mod.candidates_for_mate = cands_in_group
    for n, fn in chain_fns.items():
        setattr(run_mod, n, chain_timed(fn))
    if HUMAN_MAX_INDEX_BASES:   # fusion-post has no --max-index-bases
        build_kmer_map = fusion_post.build_kmer_map
        fusion_post.build_kmer_map = functools.partial(
            build_kmer_map, max_bases=HUMAN_MAX_INDEX_BASES)
    try:
        clock = StageClock()
        clock.wrap(cli_mod, "read_fasta", "read_fasta")
        clock.wrap(cli_mod, "build_grouped_fm",
                   "group index load (2 cached groups)")
        clock.wrap(FMIndex, "to", "group loads and swaps (FMIndex.to)")
        clock.wrap(grouped_mod, "align_reads_adaptive",
                   "full-read align (per group)")
        clock.wrap(grouped_mod, "_spliced_mate",
                   "segments + stitch (per group)")
        clock.wrap(grouped_mod, "discover_events",
                   "discovery (junctions, indels, FF fusions)")
        clock.wrap(juncs_mod, "build_fusion_windows",
                   "  of which FF fusion windows + scan")
        clock.wrap(juncs_mod, "scan_fusion_windows",
                   "  of which FF fusion windows + scan")
        clock.wrap(grouped_mod, "candidates_for_mate",
                   "candidates (per group)")
        clock.wrap(run_mod, "realign_events_sparse",
                   "  of which realign, sparse")
        clock.wrap(run_mod, "find_fr_fusions",
                   "  of which FR/RF scan + realign_fr_events")
        clock.wrap(run_mod, "segment_event_hits",
                   "  of which segment event hits (sparse realign, records)")
        clock.wrap(run_mod, "chain_stitch",
                   "  of which chain stitch + cross-strand chains")
        clock.wrap(run_mod, "cross_strand_chains",
                   "  of which chain stitch + cross-strand chains")
        clock.wrap(paired_mod, "accumulate_event_stats", "stats + filter")
        clock.wrap(paired_mod, "filter_junctions", "stats + filter")
        clock.wrap(paired_mod, "build_fusion_table",
                   "fusion stats (fusions.out)")
        clock.wrap(fusion_stats.FusionTable, "write",
                   "fusion stats (fusions.out)")
        kept, calls = [], []
        keep = keep_calls(kept)

        def on_timed(kind, args, got):
            calls.append(realign_call_shape(kind, args))
            keep(kind, args, got)

        work = os.path.join(HUMAN_DIR, "fusion")
        out = os.path.join(work, "tophat_human")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        realign_launches(reset=True)
        t0 = time.time()
        try:
            with RealignHooks(events, on_timed), HostPeak() as host:
                cli_main_checked(cli_mod.main, argv(out, fqs))
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = realign_launches()
        finally:
            clock.restore()
        peak = torch.cuda.max_memory_allocated()
        run_transfers = list(transfers)
        timed = placed(out)

        post = StageClock()
        post.wrap(fusion_post, "read_fasta", "read_fasta")
        post.wrap(fusion_post, "build_kmer_map", "kmer map")
        post.wrap(cli_mod, "build_grouped_fm",
                  "  of which group index load (2 cached groups)")
        post.wrap(FMIndex, "to", "  of which group transfers (FMIndex.to)")
        post.wrap(fusion_post, "_align_kmers",
                  "  of which kmer alignment (align_reads)")
        post.wrap(fusion_post, "filter_fusions", "filter")
        post.wrap(fusion_post, "read_dist", "read distributions")
        for name in ("score_fusions", "cluster_fusions", "write_report"):
            post.wrap(fusion_post, name, "score, cluster, report")
        del transfers[:]
        torch.cuda.reset_peak_memory_stats()
        try:
            with HostPeak() as post_host:
                post_s = run_fusion_post(work, fa, "cuda")
        finally:
            post.restore()
        post_peak = torch.cuda.max_memory_allocated()
    finally:
        FMIndex.to = to
        cli_mod.build_grouped_fm = build_fm
        grouped_mod.GroupedMapper.finalize_events = finalize
        grouped_mod.candidates_for_mate = cands
        for n, fn in chain_fns.items():
            setattr(run_mod, n, fn)
        if HUMAN_MAX_INDEX_BASES:
            fusion_post.build_kmer_map = build_kmer_map

    for k, (n_groups, msgs) in zip(("timed run", "fusion-post"), runs):
        if n_groups != 2:
            fail(f"human-scale fusion {k}: {n_groups} contig groups, not 2")
        if sum("reusing FM index" in m for m in msgs) != n_groups:
            fail(f"human-scale fusion {k} built a group index instead of "
                 f"reusing the build child's: {msgs}")
    if len(runs) != 2:
        fail(f"human-scale fusion: {len(runs)} group index loads, not 2 "
             "(timed run, fusion-post)")
    stages = dict(clock.seconds)
    top = sum(v for k, v in stages.items() if not k.startswith(" "))
    stages["rest (FASTQ parse, prep, selection, pair grading, output)"] = \
        wall - top
    post_stages = dict(post.seconds)
    post_top = sum(v for k, v in post_stages.items()
                   if not k.startswith(" "))
    post_stages["rest (sample scan, fusions.out parse)"] = post_s - post_top
    E, group_E = n_events[-1] if n_events else (0, [])
    res_found = found_in_result(os.path.join(
        work, "tophatfusion_out", "result.txt"), codes, breaks,
        inside, offsets, names)
    result = tally(res_found)
    log(f"human-scale fusion timed run: {wall:.2f} s, "
        f"{HUMAN_FUSION_PAIRS / wall:.1f} pairs/s; E={E} (per group "
        f"{group_E}); {len(run_transfers)} group transfers "
        f"({', '.join(f'{x:.3f}' for x in run_transfers)} s); realign "
        f"launches {launches} (dense, sparse); peak device memory "
        f"{peak / 2**30:.3f} GiB (reached by the end of "
        f"{clock.peak_stage(peak)!r}); host peak RSS "
        f"{host.bytes / 2**30:.2f} GiB"
        + (" (the process's lifetime peak)" if host.lifetime else "")
        + f"; chain searches per group {[round(x, 3) for x in chain_s]} s; "
        f"genome axis started: {any(axis)}")
    for k, v in stages.items():
        log(f"  stage {k}: {v:.3f} s" + calls_note(clock.calls.get(k)))
    log("  realign calls: " + ", ".join(calls))
    held = PathCheck(max_rows=HUMAN_HOLD_ROWS)
    t0 = time.time()
    for kind, args, got in kept:
        held(kind, args, got)
    log(f"human-scale fusion timed run: realign exact in "
        f"{len(held.shapes)} calls ({time.time() - t0:.1f} s)")
    del kept
    log(f"human-scale fusion-post: {post_s:.1f} s; peak device memory "
        f"{post_peak / 2**30:.3f} GiB (reached by the end of "
        f"{post.peak_stage(post_peak)!r}), host peak RSS "
        f"{post_host.bytes / 2**30:.2f} GiB; {len(transfers)} group "
        f"transfers; designed breaks in result.txt {result['n']} of "
        f"{len(breaks)} (per group {result['per_group']}, "
        f"{result['past_2p31']} past 2^31)")
    for k, v in post_stages.items():
        log(f"  fusion-post stage {k}: {v:.3f} s"
            + calls_note(post.calls.get(k)))
    p = timed
    log(f"human-scale fusion timed run: break-read recall "
        f"{p['recall_break_reads_pct']:.2f}%, junction-read recall "
        f"{p['recall_junction_pct']:.2f}%; designed breaks in "
        f"fusions.out {p['fusions_out']['n']} of {len(breaks)} (per "
        f"group {p['fusions_out']['per_group']}, "
        f"{p['fusions_out']['past_2p31']} past 2^31); cross-group "
        f"breaks found {p['cross_found']} of {len(cross)}; "
        f"{p['fusions_out_lines']} fusions.out lines")
    if min(p["recall_break_reads_pct"], p["recall_junction_pct"]) < 100:
        fail(f"human-scale fusion timed run: recall "
             f"{p['recall_break_reads_pct']:.2f}% (break reads), "
             f"{p['recall_junction_pct']:.2f}% (junction reads) < 100%")
    if p["missing"]:
        fail(f"human-scale fusion timed run: designed breaks missing "
             f"from fusions.out: {p['missing']}")
    if not result["n"]:
        fail("human-scale fusion-post: result.txt holds no designed break")
    if launches[0] or not launches[1]:
        fail(f"the human-scale fusion run launched the realign kernel's "
             f"entries {launches} (dense, sparse) times; it must take the "
             "sparse entry only")
    if any(axis):
        fail("the human-scale fusion run started the genome axis on one "
             "card")
    phase_s = time.time() - t_phase
    log(f"human scale, fusion: phase 18 took {phase_s:.1f} s")
    return dict(
        breaks=len(breaks), breaks_past_2p31=sum(p for _, p in where),
        breaks_between_contigs=n_between, cross_group_breaks=len(cross),
        wall_s=wall, pairs_per_s=HUMAN_FUSION_PAIRS / wall,
        events=E, group_events=group_E,
        group_transfer_s=run_transfers, peak_device_bytes=peak,
        peak_stage=clock.peak_stage(peak),
        host_peak_rss_bytes=host.bytes, host_peak_lifetime=host.lifetime,
        genome_axis_started=any(axis), launches=launches,
        realign_calls=calls, path_err=held.err,
        stages=stages, stage_calls=dict(clock.calls),
        chain_s_per_group=chain_s,
        timed={k: v for k, v in timed.items() if k != "missing"},
        post_s=post_s, post_stages=post_stages,
        post_stage_calls=dict(post.calls),
        post_group_transfers=len(transfers),
        post_peak_device_bytes=post_peak,
        post_host_peak_rss_bytes=post_host.bytes, result=result,
        phase_s=phase_s)


# --------------------------------------------------------------- phase 19

# bench.py's design point: a 1 Gbp genome (2^30 bases, seed 7) with a
# k = 14 seed table and a full SA in one index (2^22 and k = 10 rehearse
# it at 1/256)
BENCH_N = 1 << 30
BENCH_KMER_K = 14
BENCH_SA_RATE = 0
BENCH_SEED = 7
BENCH_ITERS = 24            # timed batches, dispatched back to back
BENCH_CLI_READS = 8192      # (b): the first reads of (c)'s timed set
BENCH_SPLICED_READS = 32768
BENCH_HOLD_ROWS = 2048      # rows of each realign call held
BENCH_DIR = os.path.join(CACHE, "bench")
BENCH_ALIGN = dict(max_mismatches=2, max_alignments=8, narrow_hits=6,
                   wide_hits=32, resolve_cap=1, uniform_len=READ_LEN)


def bench_paths():
    """(FASTA, --tt-index prefix, the index build's log, its record)."""
    tag = f"g{BENCH_N}_s{BENCH_SEED}_k{BENCH_KMER_K}_r{BENCH_SA_RATE}"
    return tuple(os.path.join(BENCH_DIR, tag + x) for x in
                 (".fa", "", ".build.log", ".build.json"))


def bench_genome(n: int = 0):
    """bench.py's genome: n (default BENCH_N) random codes of seed
    BENCH_SEED. Drawn in chunks: the same stream as bench.py's one int64
    draw, without its 8 bytes a base."""
    n = n or BENCH_N
    rng = np.random.default_rng(BENCH_SEED)
    codes = np.empty(n, np.int8)
    step = 1 << 24
    for a in range(0, n, step):
        codes[a:a + step] = rng.integers(0, 4, min(step, n - a))
    return codes


def bench_records(codes, juncs, seed: int, n_reads: int):
    """bench.py's spliced reads (make_reads: 25% across one of `juncs`) as
    the (name, sequence, quality) records batch_reads takes."""
    from tophat_tpu_torch.index.fasta import decode_seq

    return [(f"r{i}", decode_seq(x), b"I" * len(x))
            for i, x in enumerate(make_reads(codes, juncs, seed, n_reads))]


def start_bench_build():
    """Start phase 19's index build (chip_smoke.py --bench-build) in a
    fresh interpreter in this process's group. Returns the Popen."""
    logf = bench_paths()[2]
    os.makedirs(BENCH_DIR, exist_ok=True)
    with open(logf, "w") as f:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--bench-build",
             str(BENCH_N), str(BENCH_KMER_K)],
            stdout=f, stderr=subprocess.STDOUT, cwd=REPO)


def bench_build():
    """Phase 19's index build (chip_smoke.py --bench-build N K): the
    genome's FASTA (one contig, chr1; reused when its size matches), then
    the port's build_fm_index at the design point on the host, saved
    where the CLI's --tt-index finds it (reused when its design matches),
    then bench.py's 64 junctions and (b)'s FASTQ: the first
    BENCH_CLI_READS of (c)'s timed reads. Writes its seconds, the file's
    bytes, the junctions and its peak host memory as JSON (phase 19
    starts on it)."""
    sys.path.insert(0, REPO)
    from tophat_tpu_torch.index.fm import build_fm_index

    fa, prefix, _, rec = bench_paths()
    index = prefix + ".tt.npz"
    with HostPeak() as host:
        t0 = time.time()
        codes = bench_genome()
        synth_s = time.time() - t0
        t0 = time.time()
        fresh_fasta = not (os.path.exists(fa) and os.path.getsize(fa)
                           == fasta_bytes(np.array([0, len(codes)])))
        if fresh_fasta:
            write_fasta(fa + ".tmp", codes)
            os.replace(fa + ".tmp", fa)
        fasta_s = time.time() - t0
        reused = False
        if os.path.exists(index):
            with np.load(index) as z:
                reused = ((int(z["n"]), int(z["kmer_k"]), int(z["sa_rate"]))
                          == (len(codes), BENCH_KMER_K, BENCH_SA_RATE))
        build_s = save_s = 0.0
        if not reused:
            t0 = time.time()
            fm = build_fm_index(codes, kmer_k=BENCH_KMER_K,
                                sa_rate=BENCH_SA_RATE, device="cpu")
            build_s = time.time() - t0
            t0 = time.time()
            fm.save(prefix + ".tt.tmp.npz")
            os.replace(prefix + ".tt.tmp.npz", index)
            save_s = time.time() - t0
            del fm
        t0 = time.time()
        juncs = pick_junctions(codes)
        write_fastq(prefix + ".cli.fq",
                    make_reads(codes, juncs, 6, BENCH_CLI_READS))
        reads_s = time.time() - t0
    with open(rec + ".tmp", "w") as f:
        json.dump(dict(
            synth_s=synth_s, fasta_s=fasta_s, fresh_fasta=fresh_fasta,
            reused=reused, build_s=build_s, save_s=save_s, reads_s=reads_s,
            n=len(codes), kmer_k=BENCH_KMER_K, sa_rate=BENCH_SA_RATE,
            file_bytes=os.path.getsize(index), juncs=juncs,
            peak_rss_bytes=host.bytes, peak_lifetime=host.lifetime), f)
    os.replace(rec + ".tmp", rec)


def bench_unspliced(fm, codes):
    """Phase 19 (a): bench.py's unspliced run on the resident index.
    BENCH_ITERS + 1 batches of BATCH x READ_LEN on the card; one warm
    batch, then the timed ones dispatched back to back under
    torch.cuda.set_sync_debug_mode("error") with one final synchronize
    (the in-program tier, its fixed wide pass included); then, on the
    same batches, the exact call (the truncated rows read back once and
    re-run) and the narrow tier alone with its truncated rows counted on
    the host (which rows passed the wide budget)."""
    import torch

    from tophat_tpu_torch.ops.align import (align_reads, align_reads_adaptive,
                                            kmer_fast_ok)

    dev = fm.device
    fast = kmer_fast_ok(fm, READ_LEN, 2)
    if not fast:
        fail("phase 19: the design point's index does not take the k-mer "
             "seed path at 100 bp")
    offsets = torch.tensor([0, fm.n], device=dev)
    t0 = time.time()
    batches = [tuple(torch.as_tensor(x, device=dev)
                     for x in unspliced_batch(codes, 100 + i))
               for i in range(BENCH_ITERS + 1)]
    gen_s = time.time() - t0
    run = lambda b, defer: align_reads_adaptive(
        fm, *b, offsets, kmer_fast=fast, defer=defer, **BENCH_ALIGN)
    warm = run(batches[0], True)
    aligned = int((warm.n_hits > 0).sum())
    if aligned < 0.99 * BATCH:
        fail(f"phase 19: only {aligned}/{BATCH} reads of the warm batch "
             "aligned")
    run(batches[0], False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        deferred = [run(b, True) for b in batches[1:]]
        dispatch_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    defer_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    exact = [run(b, False) for b in batches[1:]]
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0

    narrow = dict(BENCH_ALIGN, hits_per_seed=BENCH_ALIGN["narrow_hits"])
    for k in ("narrow_hits", "wide_hits"):
        del narrow[k]
    truncated = []
    t0 = time.perf_counter()
    for b in batches[1:]:
        al = align_reads(fm, *b, offsets, kmer_fast=fast, **narrow)
        truncated.append(int(al.truncated.sum()))
    torch.cuda.synchronize()
    narrow_s = time.perf_counter() - t0

    budget = max(BATCH // 8, 8)
    overflow = sum(max(0, t - budget) for t in truncated)
    chk_d = sum(int(o.n_hits.sum()) for o in deferred)
    chk_e = sum(int(o.n_hits.sum()) for o in exact)
    differ = still = 0
    for d, e in zip(deferred, exact):
        same = torch.ones_like(d.truncated)
        for f in ("pos", "strand", "mm", "valid"):
            same &= (getattr(d, f) == getattr(e, f)).all(1)
        same &= (d.n_hits == e.n_hits) & (d.truncated == e.truncated)
        differ += int((~same).sum())
        if bool((~same & ~d.truncated).any()):
            fail("phase 19: a deferred row that is not truncated differs "
                 "from the exact call")
        still += int(d.truncated.sum())
    out = dict(
        batches=BENCH_ITERS, batch=BATCH, warm_aligned=aligned,
        deferred_reads_per_s=BENCH_ITERS * BATCH / defer_s,
        exact_reads_per_s=BENCH_ITERS * BATCH / exact_s,
        narrow_sync_reads_per_s=BENCH_ITERS * BATCH / narrow_s,
        deferred_s=defer_s, deferred_dispatch_s=dispatch_s,
        exact_s=exact_s, narrow_sync_s=narrow_s,
        checksum_deferred=chk_d, checksum_exact=chk_e,
        narrow_truncated_rows=truncated, wide_budget=budget,
        overflow_rows=overflow, rows_differing=differ,
        deferred_truncated_rows=still, batch_gen_s=gen_s)
    log(f"phase 19 (a) unspliced, {BENCH_ITERS} batches of {BATCH} x "
        f"{READ_LEN} bp, no host sync in the deferred loop: deferred "
        f"{out['deferred_reads_per_s']:.1f} reads/s ({defer_s:.4f} s, "
        f"{dispatch_s:.4f} s of it to dispatch), exact "
        f"{out['exact_reads_per_s']:.1f} ({exact_s:.4f} s), the narrow tier "
        f"alone with its count read back {out['narrow_sync_reads_per_s']:.1f} "
        f"({narrow_s:.4f} s); warm batch {aligned}/{BATCH} aligned; "
        f"checksum {chk_d} deferred, {chk_e} exact; narrow-tier truncated "
        f"rows {sum(truncated)} (at most {max(truncated)} a batch, budget "
        f"{budget}), {overflow} past the budget, {differ} rows differing")
    if overflow:
        log(f"phase 19 (a): {overflow} rows overflowed the wide budget; "
            f"{differ} deferred rows differ from the exact call, all "
            "flagged truncated")
    elif chk_d != chk_e or differ:
        fail(f"phase 19: the deferred checksum {chk_d} is not the exact "
             f"call's {chk_e} though no row overflowed the budget")
    return out


def bench_spliced_pipeline(fm, codes, juncs):
    """Phase 19 (c): bench.py's spliced run through run_pipeline on the
    resident index: one warm run, then two timed runs of
    BENCH_SPLICED_READS reads (the faster kept), each with stage seconds,
    E, its realign calls, realign launches and peak device and host
    memory; the first timed run's realign calls are held after it."""
    import tempfile

    import torch

    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.io.fastq import batch_reads
    from tophat_tpu_torch.ops import events
    from tophat_tpu_torch.pipeline import run as run_mod
    from tophat_tpu_torch.pipeline.params import Params

    t0 = time.time()
    genome = Genome(codes=codes, offsets=np.array([0, len(codes)]),
                    names=["chr1"])
    warm_batch = batch_reads(bench_records(codes, juncs, 5,
                                           BENCH_SPLICED_READS))
    steady = batch_reads(bench_records(codes, juncs, 6, BENCH_SPLICED_READS))
    gen_s = time.time() - t0
    params = Params(coverage_search=False)
    quiet = lambda *a: None
    root = tempfile.mkdtemp(prefix="bench_spliced_", dir=BENCH_DIR)
    run_mod.run_pipeline(genome, warm_batch, params,
                         os.path.join(root, "warm"), fm=fm, log=quiet,
                         device=fm.device)
    runs = []
    for trial in range(2):
        clock = StageClock()
        clock.wrap(run_mod, "_align_mate", "full-read align (prep, align, "
                   "transfer)")
        clock.wrap(run_mod, "align_reads_adaptive",
                   "  of which align_reads_adaptive")
        clock.wrap(run_mod, "_spliced_mate", "segments + stitch")
        clock.wrap(run_mod, "discover_events", "discovery")
        clock.wrap(run_mod, "candidates_for_mate",
                   "candidates (realign, collect, chains)")
        clock.wrap(run_mod, "realign_events_sparse",
                   "  of which realign, sparse")
        clock.wrap(run_mod, "default_chains", "  of which default chains")
        clock.wrap(run_mod, "accumulate_event_stats", "stats + filter")
        clock.wrap(run_mod, "filter_junctions", "stats + filter")
        clock.wrap(run_mod, "_select", "selection")
        clock.wrap(run_mod, "write_outputs", "output")
        kept, calls = [], []
        keep = keep_calls(kept)

        def on_call(kind, args, got):
            calls.append(realign_call_shape(kind, args))
            if trial == 0:
                keep(kind, args, got)

        out = os.path.join(root, f"steady{trial}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        realign_launches(reset=True)
        t0 = time.time()
        try:
            with RealignHooks(events, on_call), HostPeak() as host:
                res = run_mod.run_pipeline(genome, steady, params, out,
                                           fm=fm, log=quiet,
                                           device=fm.device)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = realign_launches()
        finally:
            clock.restore()
        peak = torch.cuda.max_memory_allocated()
        stages = dict(clock.seconds)
        top = sum(v for k, v in stages.items() if not k.startswith(" "))
        stages["rest (prep of the batch, merges)"] = wall - top
        recall = junction_recall(os.path.join(out, "accepted_hits.sam"),
                                 BENCH_SPLICED_READS)
        runs.append(dict(
            wall_s=wall, reads_per_s=BENCH_SPLICED_READS / wall,
            recall_pct=recall, events=len(res["events"]["left"]),
            launches=launches, realign_calls=calls, stages=stages,
            stage_calls=dict(clock.calls), peak_device_bytes=peak,
            peak_stage=clock.peak_stage(peak),
            host_peak_rss_bytes=host.bytes,
            host_peak_lifetime=host.lifetime))
        del res
        if trial == 0:
            held = PathCheck(max_rows=BENCH_HOLD_ROWS)
            for kind, args, got in kept:
                held(kind, args, got)
            del kept
    best = min(runs, key=lambda r: r["wall_s"])
    for i, r in enumerate(runs):
        log(f"phase 19 (c) run_pipeline, timed run {i}: {r['wall_s']:.3f} "
            f"s, {r['reads_per_s']:.1f} reads/s; junction-read recall "
            f"{r['recall_pct']:.2f}%; E={r['events']}; realign launches "
            f"{r['launches']} (dense, sparse): " + ", ".join(
                r["realign_calls"])
            + f"; peak device memory {r['peak_device_bytes'] / 2**30:.3f} "
            f"GiB (reached by the end of {r['peak_stage']!r}); host peak "
            f"RSS {r['host_peak_rss_bytes'] / 2**30:.2f} GiB"
            + (" (the process's lifetime peak)" if r["host_peak_lifetime"]
               else ""))
        for k, v in r["stages"].items():
            log(f"  stage {k}: {v:.3f} s"
                + calls_note(r["stage_calls"].get(k)))
        if r["recall_pct"] < 100.0:
            fail(f"phase 19 (c): junction-read recall "
                 f"{r['recall_pct']:.2f}% < 100%")
        if r["launches"][0] or not r["launches"][1]:
            fail(f"phase 19 (c) launched the realign kernel's entries "
                 f"{r['launches']} (dense, sparse) times; it must take the "
                 "sparse entry only")
    log(f"phase 19 (c): realign exact in {len(held.shapes)} calls: "
        + ", ".join(held.shapes))
    return dict(best, runs=runs, read_gen_s=gen_s, path_err=held.err)


def bench_cli():
    """Phase 19 (b): the single-end CLI (--no-coverage-search --tt-index)
    on the design point's FASTA and the index build's index and FASTQ: it must
    reuse the index and build none; every realign call is held against
    its plain version on up to BENCH_HOLD_ROWS of its rows after the run.
    Returns (its record, the index its FMIndex.load put on the card, which
    (a) and (c) then use: one load for the phase)."""
    import torch

    from tophat_tpu_torch.cli import main as cli_mod
    from tophat_tpu_torch.index.fm import FMIndex
    from tophat_tpu_torch.ops import events

    fa, prefix, _, _ = bench_paths()
    fq = prefix + ".cli.fq"
    out = os.path.join(BENCH_DIR, "out_cli")
    builds, loaded = [], []
    build_fm = cli_mod.build_fm_index
    saved_load = FMIndex.__dict__["load"]
    load = FMIndex.load

    def build_seen(*a, **k):
        builds.append(1)
        return build_fm(*a, **k)

    def load_kept(*a, **k):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        fm = load(*a, **k)
        torch.cuda.synchronize()
        loaded.append((fm, time.perf_counter() - t0,
                       torch.cuda.memory_allocated() - before))
        return fm

    clock = StageClock()
    clock.wrap(cli_mod, "read_fasta", "read_fasta")
    kept, calls = [], []
    keep = keep_calls(kept)

    def on_call(kind, args, got):
        calls.append(realign_call_shape(kind, args))
        keep(kind, args, got)

    cli_mod.build_fm_index = build_seen
    FMIndex.load = load_kept
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    realign_launches(reset=True)
    t0 = time.time()
    try:
        with RealignHooks(events, on_call), HostPeak() as host:
            cli_main_checked(cli_mod.main, ["-o", out, "--no-coverage-search",
                                            "--tt-index", prefix, fa, fq])
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = realign_launches()
    finally:
        cli_mod.build_fm_index = build_fm
        FMIndex.load = saved_load
        clock.restore()
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(out, "logs", "tophat.log")) as f:
        reused = "genome FM index: reusing" in f.read()
    if builds or not reused or len(loaded) != 1:
        fail(f"phase 19 (b): the CLI built {len(builds)} index(es), loaded "
             f"{len(loaded)} and {'reused' if reused else 'did not reuse'} "
             f"{prefix}.tt.npz")
    fm, load_s, on_card = loaded[0]
    held = PathCheck(max_rows=BENCH_HOLD_ROWS)
    for kind, args, got in kept:
        held(kind, args, got)
    del kept
    recall = junction_recall(os.path.join(out, "accepted_hits.sam"),
                             BENCH_CLI_READS)
    read_s = clock.seconds.get("read_fasta", 0.0)
    log(f"phase 19 (b) CLI: {wall:.2f} s, {BENCH_CLI_READS / wall:.1f} "
        f"reads/s (read_fasta {read_s:.3f} s, FMIndex.load {load_s:.3f} s); "
        f"index reused, none built; junction-read recall {recall:.2f}%; "
        f"realign launches {launches} (dense, sparse); peak device memory "
        f"{peak / 2**30:.3f} GiB, host peak RSS {host.bytes / 2**30:.2f} GiB"
        + (" (the process's lifetime peak)" if host.lifetime else "")
        + f"; realign exact in {len(held.shapes)} calls: "
        + ", ".join(held.shapes))
    if recall < 100.0:
        fail(f"phase 19 (b): junction-read recall {recall:.2f}% < 100%")
    if launches[0] or not launches[1]:
        fail(f"phase 19 (b) launched the realign kernel's entries "
             f"{launches} (dense, sparse) times; it must take the sparse "
             "entry only")
    return dict(wall_s=wall, reads_per_s=BENCH_CLI_READS / wall,
                recall_pct=recall, read_fasta_s=read_s, load_s=load_s,
                index_bytes_on_card=on_card, launches=launches,
                realign_calls=calls, peak_device_bytes=peak,
                host_peak_rss_bytes=host.bytes,
                host_peak_lifetime=host.lifetime, path_err=held.err), fm


def phase_bench(build):
    """bench.py's design point on the card: one index over a 2^30-base
    genome (seed 7) with a k = 14 seed table and a full SA, built on the
    host by the port's build_fm_index in a process of its own
    (bench_build, started by the human build child once its groups are
    built). (b) the CLI loads it; (a) and (c) then run on that index,
    which is the one copy on the card."""
    import torch

    t_phase = time.time()
    fa, prefix, logf, rec = bench_paths()
    rc = wait_for_record(build, rec)
    wait_s = time.time() - t_phase
    with open(logf) as f:
        tail = f.read()[-3000:]
    if rc not in (None, 0) or not os.path.exists(rec):
        fail(f"phase 19's index build exited {rc}:\n{tail}")
    with open(rec) as f:
        built = json.load(f)
    fasta = "written" if built["fresh_fasta"] else "reused"
    log(f"phase 19 index build: genome {built['synth_s']:.1f} s, FASTA "
        f"{built['fasta_s']:.1f} s ({fasta}), "
        + ("index reused from .smoke_cache/" if built["reused"] else
           f"index built in {built['build_s']:.1f} s and saved in "
           f"{built['save_s']:.1f} s")
        + f" ({built['file_bytes'] / 1e9:.3f} GB on disk), junctions and "
        f"reads {built['reads_s']:.1f} s; peak host memory "
        f"{built['peak_rss_bytes'] / 2**30:.2f} GiB"
        + (" (lifetime)" if built["peak_lifetime"] else "")
        + f"; phase 19 waited {wait_s:.1f} s for it")

    cli, fm = bench_cli()
    tables = fm_table_bytes(fm)
    design = (fm.n, fm.kmer_k, fm.sa_rate, fm.sa.numel())
    log(f"phase 19 index: n={fm.n}, k={fm.kmer_k}, sa_rate={fm.sa_rate}, "
        f"SA of {fm.sa.numel()} rows; {cli['index_bytes_on_card'] / 2**30:.3f}"
        f" GiB on the card (tables {sum(tables.values()) / 2**30:.3f} GiB: "
        + ", ".join(f"{k} {v / 2**30:.3f}" for k, v in tables.items()
                    if v >= 2**26) + ")")
    if design != (BENCH_N, BENCH_KMER_K, BENCH_SA_RATE, BENCH_N + 1):
        fail(f"phase 19: the index is (n, k, sa_rate, SA rows) {design}, not "
             f"the design point {(BENCH_N, BENCH_KMER_K, BENCH_SA_RATE)}")
    codes = fm.genome_host
    juncs = [tuple(j) for j in built["juncs"]]
    unspliced = bench_unspliced(fm, codes)
    spliced = bench_spliced_pipeline(fm, codes, juncs)
    del fm
    phase_s = time.time() - t_phase
    log(f"phase 19 took {phase_s:.1f} s")
    return dict(
        build={k: v for k, v in built.items() if k != "juncs"},
        build_wait_s=wait_s, index_table_bytes=tables,
        junctions=len(juncs), cli=cli, unspliced=unspliced, spliced=spliced,
        launches=tuple(a + b for a, b in zip(spliced["launches"],
                                             cli["launches"])),
        path_err=max(spliced["path_err"], cli["path_err"]), phase_s=phase_s)


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
    t_start = time.time()
    card = card_line()
    log(f"card: {card}")
    human_build_child = start_human_build()

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
    annotated, transcripts = phase_annotated(spliced["codes"],
                                             spliced["juncs"],
                                             spliced["index"])
    bowtie2 = phase_bowtie2(spliced["codes"], spliced["juncs"],
                            spliced["index"])
    small_fusion = phase_small_fusion(spliced["codes"])
    fusion = phase_fusion(spliced["codes"], spliced["juncs"],
                          spliced["index"])
    fusion_gtf = phase_fusion_gtf(spliced["codes"], spliced["juncs"],
                                  spliced["index"])
    grouped = phase_grouped(spliced["codes"], spliced["juncs"],
                            spliced["index"])
    mesh = phase_mesh(spliced["codes"], spliced["juncs"], spliced["index"])
    long_reads = phase_long_reads(spliced["codes"], spliced["juncs"],
                                  spliced["index"], transcripts)
    long_single = phase_long_single(spliced["codes"], spliced["juncs"],
                                    spliced["index"])
    hg = human_genome()
    human = phase_human(human_build_child, hg, grouped)
    fusion_human = phase_human_fusion(human_build_child, hg)
    human_annotated = phase_human_annotated(human_build_child, hg)
    del hg
    bench = phase_bench(human_build_child)
    path_phases = (spliced, paired, annotated, bowtie2, fusion, fusion_gtf,
                   grouped, mesh, long_reads, long_single, human,
                   human_annotated, fusion_human, bench)
    log(f"smoke phases done in {time.time() - t_start:.1f} s")

    print(json.dumps({
        "realign_cases": kernels,
        "spliced_reads_per_s": spliced["reads_per_s"],
        "spliced_steady_s": spliced["steady_s"],
        "spliced_junction_read_recall_pct": spliced["recall_pct"],
        "unspliced_reads_per_s": unspliced_rps,
        "paired": {k: v for k, v in paired.items() if k != "realign_calls"},
        "annotated": annotated, "bowtie2": bowtie2,
        "small_fusion": small_fusion, "fusion": fusion,
        "fusion_gtf": fusion_gtf, "grouped": grouped, "mesh": mesh,
        "long_reads": long_reads, "long_single": long_single,
        "human_scale": human, "human_annotated": human_annotated,
        "fusion_human": fusion_human, "bench_design_point": bench,
        "seconds": time.time() - t_start}),
        flush=True)
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
    if sys.argv[1:2] == ["--human-build"]:
        (HUMAN_PER_MBP, HUMAN_MAX_INDEX_BASES, BENCH_N,
         BENCH_KMER_K) = map(int, sys.argv[2:6])
        human_build()
    elif sys.argv[1:2] == ["--bench-build"]:
        BENCH_N, BENCH_KMER_K = map(int, sys.argv[2:4])
        bench_build()
    else:
        main()
