"""Tests that need a CUDA card (marked gpu; each skips without one).

They import torch and numpy only, so they also run on a machine without
JAX: python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
(conftest.py imports JAX). The realign kernel is held against its plain
torch version, and the whole single-end and paired-end pipelines on the
card against the same pipelines on the CPU, byte for byte."""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _realign_inputs(dev, L, q, R=2000, E=70, seed=11):
    """Reads planted across events (with mismatches and Ns, some over
    genome Ns), random rows, zero-length and short rows; events at both
    genome ends and next to an N run."""
    from tophat_tpu_torch.ops.realign_kernel import prepare_targets

    rng = np.random.default_rng(seed)
    n = 50000
    genome = rng.integers(0, 4, n).astype(np.int8)
    genome[1000:1030] = 4
    lefts = rng.integers(L, n - 2 * L, E)
    if E >= 4:
        lefts[:4] = [0, 3, n - 2, n - 1]
    kinds = np.full(E, 2 if q else 0, np.int8)
    rights = lefts + 1 if q else lefts + rng.integers(2, 3000, E)
    if E > 6:
        lefts[4] = 1015                       # left flank ends in Ns
        if not q:
            rights[5] = 1010                  # right flank starts in Ns
    ins_seq = np.full((E, 8), -1, np.int8)
    ins_seq[:, :q] = rng.integers(0, 5, (E, q))
    reads = rng.integers(0, 5, (R, L)).astype(np.int8)
    lengths = np.full(R, L, np.int32)
    for i in range(R):
        e = 4 + i % 2 if i < 64 and E > 6 else int(rng.integers(0, E))
        t = int(rng.integers(1, max(2, L - 1 - q)))
        st = int(lefts[e]) + 1 if q else int(rights[e])
        if i % 8 == 0 or st + L > n or lefts[e] - t + 1 < 0:
            continue
        reads[i] = np.concatenate([genome[lefts[e] - t + 1: lefts[e] + 1],
                                   ins_seq[e, :q],
                                   genome[st: st + L - t - q]])[:L]
        if i % 3 == 0:
            reads[i, int(rng.integers(0, L))] = 4
    lengths[::16] = 0
    reads[::16] = -1
    lengths[5::16] = L // 2
    reads[5::16, L // 2:] = -1
    t = lambda a: torch.as_tensor(a, device=dev)
    flank_l, comb = prepare_targets(t(genome), t(lefts), t(rights), t(kinds),
                                    t(ins_seq), q, L)
    return t(reads).contiguous(), t(lengths), flank_l, comb


@pytest.mark.gpu
@pytest.mark.parametrize("E", [1, 69, 200])
@pytest.mark.parametrize("L,q", [(25, 0), (25, 3), (100, 0), (100, 3),
                                 (150, 0), (150, 3), (200, 2), (255, 0),
                                 (255, 3), (256, 0), (256, 3), (257, 0),
                                 (300, 0), (300, 3), (1000, 0), (1000, 3)])
def test_realign_kernel_matches_plain(cuda, L, q, E):
    """Every width: the tensor-core path (L <= 256) and the bit-plane
    path above it (257 is the first width that takes it); R = 2,000 is
    no multiple of a row tile, and E = 1, 69, 200 leave ragged event
    tiles."""
    from tophat_tpu_torch.ops.realign_kernel import (realign_group,
                                                     realign_plain)

    args = _realign_inputs(cuda, L, q, E=E)
    before = realign_group.launches
    got = realign_group(*args, q, 8)
    ref = realign_plain(*args, q, 8)
    torch.cuda.synchronize()
    assert realign_group.launches == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int(ref[2].sum()) > (1000 if E > 1 else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("L,q,E,max_mm", [(100, 0, 69, 8), (25, 3, 200, 2),
                                          (256, 0, 1, 8), (300, 3, 69, 8),
                                          (40, 0, 200, 10 ** 4)])
def test_realign_sparse_matches_packed_dense(cuda, L, q, E, max_mm):
    """The sparse entry gives pack_sparse of the dense tables masked by
    `valid`, in the same order; both launch counters move. max_mm 10^4
    makes every pair with a split pass, more records than the first
    buffer holds, so the entry relaunches."""
    from tophat_tpu_torch.ops.realign_kernel import (pack_sparse,
                                                     realign_group,
                                                     realign_group_sparse)

    args = _realign_inputs(cuda, L, q, E=E, R=2000 if max_mm < 100 else 64)
    valid = torch.as_tensor(np.random.default_rng(3).random(E) < 0.8,
                            device=cuda)
    valid[0] = True
    d0, s0 = realign_group.launches, realign_group_sparse.launches
    bt, mm, ok = realign_group(*args, q, max_mm)
    want = pack_sparse(bt, mm, ok & valid[None, :])
    got = realign_group_sparse(*args, q, max_mm, valid)
    torch.cuda.synchronize()
    assert realign_group.launches == d0 + 1
    assert realign_group_sparse.launches == s0 + (2 if max_mm > 100 else 1)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert want.shape[1] > 0


@pytest.mark.gpu
def test_realign_kernel_takes_any_event_count(cuda):
    """More event tiles than a grid's y dimension holds (65,535 x 32
    events): the tiles fold into grid.x, so the launch is not refused."""
    from tophat_tpu_torch.ops.realign_kernel import (realign_group,
                                                     realign_plain)

    E = 65535 * 32 + 33
    reads, lengths, flank_l, comb = _realign_inputs(cuda, 25, 0, R=64)
    reps = -(-E // flank_l.shape[0])
    flank_l = flank_l.repeat(reps, 1)[:E].contiguous()
    comb = comb.repeat(reps, 1)[:E].contiguous()
    reads, lengths = reads[:3].contiguous(), lengths[:3].contiguous()
    got = realign_group(reads, lengths, flank_l, comb, 0, 8)
    ref = realign_plain(reads, lengths, flank_l, comb, 0, 8)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert got[0].shape == (3, E) and int(ref[2].sum()) > 0


@pytest.mark.gpu
def test_realign_wrapper_rejects_bad_inputs(cuda):
    from tophat_tpu_torch.ops.realign_kernel import realign_group

    reads, lengths, flank_l, comb = _realign_inputs(cuda, 25, 0, R=64)
    with pytest.raises(ValueError, match="int32"):
        realign_group(reads, lengths.long(), flank_l, comb, 0, 2)
    with pytest.raises(ValueError, match="contiguous"):
        realign_group(reads.t().contiguous().t(), lengths, flank_l, comb,
                      0, 2)
    with pytest.raises(ValueError, match="CUDA"):
        realign_group(reads, lengths.cpu(), flank_l, comb, 0, 2)


def _workload(n, seed=5, L=76):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.int8)
    codes[n // 3:n // 3 + 20] = 4
    seqs = []
    for k in range(12):
        a = int(rng.integers(2000, n - 3000))
        il = int(rng.integers(100, 800))
        codes[a:a + 2] = [2, 3]
        codes[a + il - 2:a + il] = [0, 2]
        for rep in range(3):
            t = int(rng.integers(20, 56))
            seqs.append(np.concatenate([codes[a - t:a],
                                        codes[a + il:a + il + L - t]]))
    for k in range(4):
        s = int(rng.integers(1000, n - 1000))
        t = int(rng.integers(25, 50))
        seqs.append(np.concatenate([codes[s:s + t],
                                    codes[s + t + 2:s + L + 2]]))
        seqs.append(np.concatenate([codes[s:s + t], np.array([1, 2], np.int8),
                                    codes[s + t:s + L - 2]]))
    for k in range(40):
        s = int(rng.integers(0, n - L))
        seq = codes[s:s + L].copy()
        seq[k % L] = (seq[k % L] + 1) % 4
        seqs.append(seq)
    recs = [(f"r{i}", "".join("ACGTN"[c] for c in s), b"I" * len(s))
            for i, s in enumerate(seqs)]
    return codes, recs


@pytest.mark.gpu
@pytest.mark.parametrize("n", [30000, (1 << 21) + 4096])
def test_pipeline_on_card_matches_cpu(cuda, tmp_path, n):
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.io.fastq import batch_reads
    from tophat_tpu_torch.ops.realign_kernel import realign_group
    from tophat_tpu_torch.pipeline.params import Params
    from tophat_tpu_torch.pipeline.run import run_pipeline

    codes, recs = _workload(n)
    genome = Genome(codes=codes, offsets=np.array([0, n]), names=["chrA"])
    for dev in ("cpu", "cuda"):
        run_pipeline(genome, batch_reads(recs), Params(coverage_search=False),
                     str(tmp_path / dev), log=lambda *a: None, device=dev)
        if dev == "cpu":
            before = realign_group.launches
    assert realign_group.launches > before
    for f in ("accepted_hits.sam", "junctions.bed", "insertions.bed",
              "deletions.bed"):
        assert (tmp_path / "cpu" / f).read_bytes() == \
            (tmp_path / "cuda" / f).read_bytes(), f


@pytest.mark.gpu
def test_paired_default_mode_on_card_matches_cpu(cuda, tmp_path):
    """Paired-end run in TopHat's default mode (coverage search on), in
    three chunk pairs, on the card and on the CPU: every output identical."""
    from test_torch_paired import _pairs  # numpy only at import time
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.io.fastq import batch_reads
    from tophat_tpu_torch.ops.realign_kernel import realign_group
    from tophat_tpu_torch.pipeline.paired import \
        run_pipeline_paired_streaming
    from tophat_tpu_torch.pipeline.params import Params

    n = 30000
    codes, r1, r2 = _pairs(n)
    genome = Genome(codes=codes, offsets=np.array([0, n]), names=["chrP"])
    files = ("accepted_hits.sam", "unmapped.bam", "junctions.bed",
             "insertions.bed", "deletions.bed", "align_summary.txt")
    for dev in ("cpu", "cuda"):
        if dev == "cuda":
            before = realign_group.launches
        chunks = ((batch_reads(r1[s:s + 24]), batch_reads(r2[s:s + 24]))
                  for s in range(0, len(r1), 24))
        run_pipeline_paired_streaming(genome, chunks, Params(),
                                      str(tmp_path / dev),
                                      log=lambda *a: None, device=dev)
    assert realign_group.launches > before
    for f in files:
        assert (tmp_path / "cpu" / f).read_bytes() == \
            (tmp_path / "cuda" / f).read_bytes(), f


@pytest.mark.gpu
def test_gapped_scan_on_card_matches_cpu(cuda):
    """bowtie2 mode's gapped scan (plain torch): all six outputs on the
    card equal the CPU's."""
    from test_torch_gapped import _scan_inputs  # numpy only at import time
    from tophat_tpu_torch.ops.gapped import gapped_scan

    args = _scan_inputs()
    for g in (1, 2, 3):
        want = gapped_scan(*(torch.as_tensor(a) for a in args), max_gap=g)
        got = gapped_scan(*(torch.as_tensor(a, device=cuda) for a in args),
                          max_gap=g)
        for w, x in zip(want, got):
            assert torch.equal(w, x.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["gtf_paired", "b2", "color"])
def test_slice_modes_on_card_match_cpu(cuda, tmp_path, mode):
    """-G paired (transcriptome index on the card), --b2 single-end and -C
    paired through the CLI, on the card and on the CPU: identical files."""
    from test_torch_colorspace import _write_inputs as color_inputs
    from test_torch_transcriptome import _write_inputs
    from tophat_tpu_torch.cli.main import main

    if mode == "color":
        fa, files = color_inputs(tmp_path, "fastq")
        args = ["-C", fa, files[0][0], files[1][0]]
    else:
        fa, gtf, fqs = _write_inputs(tmp_path)
        args = (["-G", gtf, fa] + fqs if mode == "gtf_paired"
                else ["--b2", fa, fqs[0]])
    files = ["accepted_hits.sam", "junctions.bed", "insertions.bed",
             "deletions.bed"] + (["align_summary.txt"]
                                 if mode != "b2" else [])
    for dev in ("cpu", "cuda"):
        assert main(["-o", str(tmp_path / dev), "--device", dev]
                    + args) == 0
    for f in files:
        assert (tmp_path / "cpu" / f).read_bytes() == \
            (tmp_path / "cuda" / f).read_bytes(), f
