"""Tests that need a CUDA card (marked gpu; each skips without one).

They import torch and numpy only, so they also run on a machine without
JAX: python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q
(conftest.py imports JAX). The realign kernel is held against its plain
torch version, and the whole single-end and paired-end pipelines (fusion
search, tophat-fusion-post and the contig-group index included) on the
card against the same pipelines on the CPU, byte for byte; on a mesh of
repeated cuda:0 devices, the sharded stages against the one-device run."""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _launches():
    """(dense, sparse) launches of the realign kernel so far, relaunches
    included, from the port's tracer counters."""
    from tophat_tpu_torch.utils import trace

    c = trace.snapshot()["counters"]
    dense = c.get("realign.dense_launches", 0)
    return dense, c.get("realign.launches", 0) - dense


def _realign_inputs(dev, L, q, R=2000, E=70, seed=11):
    """Reads planted across events (with mismatches and Ns, some over
    genome Ns; a quarter at splits past 4,095 where the row has them),
    random rows, zero-length and short rows; events at both genome ends
    and next to an N run."""
    from tophat_tpu_torch.ops.realign_kernel import prepare_targets

    rng = np.random.default_rng(seed)
    n = max(50000, 3 * L + 4000)
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
        if i % 4 == 3 and L - 1 - q >= 4096:
            t = int(rng.integers(4096, L - q))    # past a 12-bit packing
        else:
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
                                 (300, 0), (300, 3), (512, 3), (1000, 0),
                                 (1000, 3), (1024, 0)])
def test_realign_kernel_matches_plain(cuda, L, q, E):
    """Every width: one-hot operands (L <= 256) and shift codes above
    (257 is the first width that takes them); R = 2,000 is no multiple of
    a row tile, and E = 1, 69, 200 leave ragged event tiles."""
    from tophat_tpu_torch.ops.realign_kernel import (realign_group,
                                                     realign_plain)

    args = _realign_inputs(cuda, L, q, E=E)
    before = _launches()[0]
    got = realign_group(*args, q, 8)
    ref = realign_plain(*args, q, 8)
    torch.cuda.synchronize()
    assert _launches()[0] == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int(ref[2].sum()) > (1000 if E > 1 else 0)


@pytest.mark.gpu
@pytest.mark.parametrize("L,q,E,max_mm", [(100, 0, 69, 8), (25, 3, 200, 2),
                                          (256, 0, 1, 8), (300, 3, 69, 8),
                                          (40, 0, 200, 10 ** 4),
                                          (300, 3, 200, 10 ** 4),
                                          (1000, 0, 200, 10 ** 4)])
def test_realign_sparse_matches_packed_dense(cuda, monkeypatch, L, q, E,
                                             max_mm):
    """The sparse entry gives pack_sparse of the dense tables masked by
    `valid`, in the same order; both launch counters move. max_mm 10^4
    makes every pair with a split pass, more records than the first
    buffer holds, so the entry relaunches (from no earlier call's hint),
    on one-hot and on shift-code operands."""
    from tophat_tpu_torch.ops.realign_kernel import (pack_sparse,
                                                     realign_group,
                                                     realign_group_sparse)

    monkeypatch.setattr(realign_group_sparse, "cap_hint", 0)
    args = _realign_inputs(cuda, L, q, E=E, R=2000 if max_mm < 100 else 64)
    valid = torch.as_tensor(np.random.default_rng(3).random(E) < 0.8,
                            device=cuda)
    valid[0] = True
    from tophat_tpu_torch.utils import trace

    relaunches = lambda: trace.snapshot()["counters"].get(
        "realign.relaunches", 0)
    (d0, s0), r0 = _launches(), relaunches()
    bt, mm, ok = realign_group(*args, q, max_mm)
    want = pack_sparse(bt, mm, ok & valid[None, :])
    got = realign_group_sparse(*args, q, max_mm, valid)
    torch.cuda.synchronize()
    assert _launches() == (d0 + 1, s0 + (2 if max_mm > 100 else 1))
    assert relaunches() == r0 + (1 if max_mm > 100 else 0)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert want.shape[1] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("L,q", [(300, 0), (1000, 3)])
def test_realign_wide_mixed_lengths_match_plain(cuda, L, q):
    """A wide batch whose rows end anywhere, a third of them under 257
    positions (-1 past their end): dense and sparse entries exact, and
    ok pairs whose best split is t >= 256 (past the one-hot path's
    8-bit argmin packing)."""
    from tophat_tpu_torch.ops.realign_kernel import (pack_sparse,
                                                     realign_group,
                                                     realign_group_sparse,
                                                     realign_plain)

    reads, lengths, flank_l, comb = _realign_inputs(cuda, L, q, E=77)
    rng = np.random.default_rng(L + q)
    short = torch.as_tensor(rng.random(reads.shape[0]) < 0.35, device=cuda)
    lengths = torch.where(short, torch.as_tensor(
        rng.integers(q + 1, 257, reads.shape[0]), device=cuda).int(),
        lengths)
    pos = torch.arange(L, device=cuda)[None, :]
    reads = torch.where(pos < lengths[:, None].long(), reads,
                        torch.full_like(reads, -1)).contiguous()
    valid = torch.as_tensor(rng.random(77) < 0.8, device=cuda)
    got = realign_group(reads, lengths, flank_l, comb, q, 8)
    ref = realign_plain(reads, lengths, flank_l, comb, q, 8)
    got_s = realign_group_sparse(reads, lengths, flank_l, comb, q, 8, valid)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert torch.equal(got_s, pack_sparse(ref[0], ref[1],
                                          ref[2] & valid[None, :]))
    assert int((ref[0][ref[2]] >= 256).sum()) > 0
    assert int(ref[2][short].sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("L,q", [(2048, 0), (4096, 3), (4097, 0), (4097, 3),
                                 (8192, 0), (8192, 3), (16384, 0),
                                 (16384, 3), (32768, 0), (32768, 3)])
def test_realign_kernel_widest_rows_match_plain(cuda, L, q):
    """Rows too wide for a 64-row tile (past 1,783 positions), their
    operands streamed through shared memory in K chunks, from 2,048 to
    32,768 positions. Dense and sparse entries exact, with
    best splits past 4,095 (which a 12-bit argmin packing would lose)
    wherever a row has them (all but 4,097 at q = 3)."""
    from tophat_tpu_torch.ops.realign_kernel import (pack_sparse,
                                                     realign_group,
                                                     realign_group_sparse,
                                                     realign_plain)

    args = _realign_inputs(cuda, L, q, R=48, E=21)
    valid = torch.as_tensor(np.random.default_rng(L).random(21) < 0.8,
                            device=cuda)
    got = realign_group(*args, q, 8)
    got_s = realign_group_sparse(*args, q, 8, valid)
    ref = realign_plain(*args, q, 8)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert torch.equal(got_s, pack_sparse(ref[0], ref[1],
                                          ref[2] & valid[None, :]))
    assert int(ref[2].sum()) > 0
    if L - 1 - q >= 4096:
        assert int((ref[0][ref[2]] >= 4096).sum()) > 0


@pytest.mark.gpu
def test_realign_kernel_limits_raise(cuda):
    """Rows wider than MAX_L (the kernel's int32 argmin accumulator) raise
    ValueError naming the limit, through both entries, before a launch;
    the sparse entry's R * E is no limit (only its record count is)."""
    from tophat_tpu_torch.ops.realign_kernel import (MAX_L, realign_group,
                                                     realign_group_sparse)

    wide = _realign_inputs(cuda, MAX_L + 1, 0, R=2, E=2)
    with pytest.raises(ValueError, match=f"{MAX_L}.*accumulator"):
        realign_group(*wide, 0, 8)
    with pytest.raises(ValueError, match=f"{MAX_L}.*accumulator"):
        realign_group_sparse(*wide, 0, 8, torch.ones(2, dtype=torch.bool,
                                                     device=cuda))
    R, E = 1 << 16, 1 << 15          # R * E = 2^31 pairs, no record
    one = lambda n: torch.full((n, 1), -1, dtype=torch.int8, device=cuda)
    rec = realign_group_sparse(one(R), torch.zeros(R, dtype=torch.int32,
                                                   device=cuda),
                               one(E), one(E), 0, 8,
                               torch.ones(E, dtype=torch.bool, device=cuda))
    assert rec.shape == (4, 0)


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
    from tophat_tpu_torch.pipeline.params import Params
    from tophat_tpu_torch.pipeline.run import run_pipeline

    codes, recs = _workload(n)
    genome = Genome(codes=codes, offsets=np.array([0, n]), names=["chrA"])
    for dev in ("cpu", "cuda"):
        run_pipeline(genome, batch_reads(recs), Params(coverage_search=False),
                     str(tmp_path / dev), log=lambda *a: None, device=dev)
        if dev == "cpu":
            before = _launches()[1]
    assert _launches()[1] > before
    for f in ("accepted_hits.sam", "junctions.bed", "insertions.bed",
              "deletions.bed"):
        assert (tmp_path / "cpu" / f).read_bytes() == \
            (tmp_path / "cuda" / f).read_bytes(), f


@pytest.mark.gpu
def test_long_read_pipeline_on_card_matches_cpu(cuda, tmp_path):
    """Reads of 260 and 300 bp in TopHat's default mode: the read rows'
    realign calls are 300 positions wide (the kernel's shift-code
    operands; the chain path's segment rows are 25 wide), and the
    card's files equal the CPU's."""
    from test_torch_pipeline import OUTPUTS  # numpy only at import time
    from test_torch_pipeline import _workload as long_workload
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.io.fastq import batch_reads
    from tophat_tpu_torch.ops import events
    from tophat_tpu_torch.pipeline.params import Params
    from tophat_tpu_torch.pipeline.run import run_pipeline

    n = 30000
    codes, recs = long_workload(n, seed=13, read_lens=(260, 300))
    genome = Genome(codes=codes, offsets=np.array([0, n]), names=["chrL"])
    widths = []
    entry = events.realign_group_sparse
    events.realign_group_sparse = lambda *a: (widths.append(
        (a[0].device.type, a[0].shape[1])), entry(*a))[1]
    try:
        for dev in ("cpu", "cuda"):
            run_pipeline(genome, batch_reads(recs), Params(),
                         str(tmp_path / dev), log=lambda *a: None,
                         device=dev)
    finally:
        events.realign_group_sparse = entry
    assert ("cuda", 300) in widths and ("cpu", 300) in widths
    for f in OUTPUTS:
        assert (tmp_path / "cpu" / f).read_bytes() == \
            (tmp_path / "cuda" / f).read_bytes(), f


@pytest.mark.gpu
def test_long_read_cli_on_card_matches_cpu(cuda, tmp_path):
    """Single-end reads of 4,200 and 5,000 bp through the CLI without the
    coverage search: the read rows' realign calls are 5,000 positions
    wide (the kernel's streamed operands, past the 4,096 its argmin once
    packed), and the card's files equal the CPU's."""
    from test_torch_pipeline import OUTPUTS  # numpy only at import time
    from test_torch_pipeline import _workload as long_workload
    from tophat_tpu_torch.cli.main import main
    from tophat_tpu_torch.ops import events

    n = 30000
    codes, recs = long_workload(n, seed=17, read_lens=(4200, 5000),
                                n_introns=4, n_plain=8)
    fa, fq = tmp_path / "g.fa", tmp_path / "r.fq"
    fa.write_text(">chrL\n" + "".join("ACGTN"[c] for c in codes) + "\n")
    fq.write_text("".join(f"@{nm}\n{sq}\n+\n{q.decode()}\n"
                          for nm, sq, q in recs))
    widths = []
    entry = events.realign_group_sparse
    events.realign_group_sparse = lambda *a: (widths.append(
        (a[0].device.type, a[0].shape[1])), entry(*a))[1]
    try:
        for dev in ("cpu", "cuda"):
            assert main(["-o", str(tmp_path / dev), "--device", dev,
                         "--no-coverage-search", str(fa), str(fq)]) == 0
    finally:
        events.realign_group_sparse = entry
    assert ("cuda", 5000) in widths and ("cpu", 5000) in widths
    for f in OUTPUTS:
        assert (tmp_path / "cpu" / f).read_bytes() == \
            (tmp_path / "cuda" / f).read_bytes(), f
    sam = (tmp_path / "cuda" / "accepted_hits.sam").read_text()
    assert sum(1 for ln in sam.splitlines() if not ln.startswith("@")
               and "N" in ln.split("\t")[5]) >= 4     # one an intron


@pytest.mark.gpu
def test_paired_default_mode_on_card_matches_cpu(cuda, tmp_path):
    """Paired-end run in TopHat's default mode (coverage search on), in
    three chunk pairs, on the card and on the CPU: every output identical."""
    from test_torch_paired import _pairs  # numpy only at import time
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.io.fastq import batch_reads
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
            before = _launches()[1]
        chunks = ((batch_reads(r1[s:s + 24]), batch_reads(r2[s:s + 24]))
                  for s in range(0, len(r1), 24))
        run_pipeline_paired_streaming(genome, chunks, Params(),
                                      str(tmp_path / dev),
                                      log=lambda *a: None, device=dev)
    assert _launches()[1] > before
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


@pytest.mark.gpu
def test_fusion_scans_on_card_match_cpu(cuda):
    """FF fusion windows and their scan, FR/RF anchor pairs, their split
    scan and the per-event realignment: the card's outputs equal the
    CPU's."""
    from test_torch_fusion import map_workload  # numpy only at import time
    from tophat_tpu_torch.ops import fusion_fr, splice

    codes, offs, gs, (pos, _, valid), _ = map_workload()
    R = gs.rows // 2
    sup_max = int(np.max(gs.cuts[:, 1:] - gs.cuts[:, :-1])) + 17
    outs = []
    for dev in ("cpu", cuda):
        t = lambda a: torch.as_tensor(a, device=dev)
        g, rg = t(codes), t(gs.readsg)
        w = splice.build_fusion_windows(t(pos), t(valid), t(gs.cuts).long(),
                                        t(gs.nseg).long(),
                                        t(gs.lengths).long(), offs, 2000)
        w, _ = splice.compact_windows(w, 4096)
        res = list(splice.scan_fusion_windows(g, rg, w, sup_max))
        p, _ = fusion_fr.build_fr_pairs(t(pos), t(valid), t(gs.cuts),
                                        t(gs.lengths), 4096)
        lens = t(gs.lengths[:R])
        for pattern, d in (("prefix", "fr"), ("suffix", "rf")):
            sc = fusion_fr.scan_fr_pairs(g, rg[:R], rg[R:], lens, p,
                                         rg.shape[1], pattern)
            res += list(sc)
            ok = sc[4]
            res += list(fusion_fr.realign_fr_events(
                g, rg[:R], rg[R:], lens, sc[1][ok], sc[2][ok],
                torch.ones(int(ok.sum()), dtype=torch.bool, device=dev), d))
        outs.append([x.cpu() for x in res])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert int(outs[0][3].sum()) > 0 and int(outs[0][8].sum()) > 0


@pytest.mark.gpu
def test_fusion_cli_and_post_on_card_match_cpu(cuda, tmp_path, monkeypatch):
    """A paired --fusion-search CLI run and tophat-fusion-post on it, on
    the card and on the CPU: identical files."""
    from test_torch_fusion import FILES, write_inputs
    from tophat_tpu_torch.cli.fusion_post import main as post
    from tophat_tpu_torch.cli.main import main

    fa, fq1, fq2, _ = write_inputs(tmp_path)
    for dev in ("cpu", "cuda"):
        assert main(["-o", str(tmp_path / dev / "tophat_s1"), "--device",
                     dev, "--fusion-search", "--max-intron-length", "1000",
                     "--fusion-min-dist", "2000", "--fusion-anchor-length",
                     "13", "--no-coverage-search", fa, fq1, fq2]) == 0
        monkeypatch.chdir(tmp_path / dev)
        assert post(["--device", dev, "--no-filter-by-annotation",
                     "--skip-blast", "--num-fusion-reads", "1",
                     "--num-fusion-pairs", "0", fa]) == 0
    for f in FILES:
        assert (tmp_path / "cpu" / "tophat_s1" / f).read_bytes() == \
            (tmp_path / "cuda" / "tophat_s1" / f).read_bytes(), f
    for f in ("fusion_seq.map", "potential_fusion.txt", "result.txt"):
        assert (tmp_path / "cpu" / "tophatfusion_out" / f).read_bytes() == \
            (tmp_path / "cuda" / "tophatfusion_out" / f).read_bytes(), f


@pytest.mark.gpu
def test_grouped_run_on_card_matches_cpu(cuda, tmp_path):
    """The contig-group fixture (two groups, one resident on the card at a
    time), paired in TopHat's default mode, on the card and on the CPU:
    identical files; the sparse realign kernel ran on the card."""
    from test_torch_grouped import OUTPUTS, run_library

    run_library("torch", tmp_path / "cpu", "paired", device="cpu")
    before = _launches()[1]
    run_library("torch", tmp_path / "cuda", "paired", device="cuda")
    assert _launches()[1] > before
    for f in OUTPUTS + ("align_summary.txt", "unmapped.bam"):
        assert (tmp_path / "cpu" / f).read_bytes() == \
            (tmp_path / "cuda" / f).read_bytes(), f


@pytest.mark.gpu
def test_grouped_kmer_map_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """The contig-group fixture's paired fusion run (two groups) and
    tophat-fusion-post over it, whose kmer map runs over the run's group
    indexes one group on the device at a time, on the card and on the
    CPU: identical fusion_seq.map, potential_fusion.txt and result.txt;
    on the card every group's kmers were aligned there."""
    import functools

    from test_torch_grouped import CLI_CASES, MAX_BASES, write_fixture
    from tophat_tpu_torch.cli import fusion_post
    from tophat_tpu_torch.cli.main import main

    fa, fq1, fq2, _ = write_fixture(tmp_path)
    monkeypatch.setattr(fusion_post, "build_kmer_map", functools.partial(
        fusion_post.build_kmer_map, max_bases=MAX_BASES))
    align = fusion_post._align_kmers
    seen = []
    monkeypatch.setattr(fusion_post, "_align_kmers", lambda fm, *a: (
        seen.append(fm.device.type), align(fm, *a))[1])
    for dev in ("cpu", "cuda"):
        assert main(["-o", str(tmp_path / dev / "tophat_s1"), "--device",
                     dev, "--max-index-bases", str(MAX_BASES)]
                    + CLI_CASES["paired_fusion"] + [fa, fq1, fq2]) == 0
        monkeypatch.chdir(tmp_path / dev)
        assert fusion_post.main(["--device", dev, "--no-filter-by-annotation",
                                 "--skip-blast", "--num-fusion-reads", "1",
                                 "--num-fusion-pairs", "0", fa]) == 0
    assert seen == ["cpu", "cpu", "cuda", "cuda"]
    for f in ("fusion_seq.map", "potential_fusion.txt", "result.txt"):
        assert (tmp_path / "cpu" / "tophatfusion_out" / f).read_bytes() == \
            (tmp_path / "cuda" / "tophatfusion_out" / f).read_bytes(), f
    assert (tmp_path / "cuda" / "tophatfusion_out" /
            "fusion_seq.map").read_text().count(":") == 2


@pytest.mark.gpu
def test_chain_segment_hits_on_card_match_dense_plain(cuda):
    """The chain path's segment hits from the realign kernel's sparse entry
    on the card equal the ok entries of the dense plain version's tables
    on the CPU, and so do the chains built from them."""
    from test_torch_grouped import _chain_inputs, dense_segment_hits
    from tophat_tpu_torch.pipeline import chains
    from tophat_tpu_torch.pipeline.params import Params

    fm, gs, tables, events = _chain_inputs(1)
    params = Params()
    card = fm.to(cuda)
    before = _launches()[1]
    got = chains.segment_event_hits(card, gs, events, params)
    assert _launches()[1] > before
    want = dense_segment_hits(fm, gs, events, params)
    for a, b in zip(got[0], want[0]):
        assert np.array_equal(a, b)
    assert len(got[0][1]) > 0
    assert chains.chain_stitch(card, gs, tables, events, params,
                               seg_hits=got) == \
        chains.chain_stitch(fm, gs, tables, events, params, seg_hits=want)


def _event_table(genome, R, L, seed=4, E=48):
    """Junction, deletion and insertion events on `genome` and R rows, every
    other one planted across an event, the last two zero-length."""
    rng = np.random.default_rng(seed)
    n = genome.shape[0]
    kinds = rng.choice([0, 1, 2], E).astype(np.int8)
    lefts = rng.integers(L, n - 2 * L - 400, E).astype(np.int32)
    rights = np.where(kinds == 2, lefts + 1,
                      lefts + rng.integers(5, 300, E)).astype(np.int32)
    ins_len = np.where(kinds == 2, rng.integers(1, 4, E), 0).astype(np.int8)
    ins_seq = np.full((E, 8), -1, np.int8)
    for i in np.nonzero(kinds == 2)[0]:
        ins_seq[i, :ins_len[i]] = rng.integers(0, 4, ins_len[i])
    ev = dict(left=lefts, right=rights, kind=kinds, ins_len=ins_len,
              ins_seq=ins_seq, antisense=np.zeros(E, bool),
              valid=rng.random(E) < 0.9)
    reads = rng.integers(0, 4, (R, L)).astype(np.int8)
    lengths = np.full(R, L, np.int32)
    for i in range(0, R, 2):
        e = int(rng.integers(0, E))
        q = int(ins_len[e])
        t = int(rng.integers(2, L - 2 - q))
        st = lefts[e] + 1 if kinds[e] == 2 else rights[e]
        reads[i] = np.concatenate([genome[lefts[e] - t + 1: lefts[e] + 1],
                                   ins_seq[e, :q],
                                   genome[st: st + L - t - q]])
    lengths[-2:] = 0
    return reads, lengths, ev


@pytest.mark.gpu
def test_mesh_on_card_matches_one_device(cuda, monkeypatch):
    """On a mesh of 4 x cuda:0 (as chip_smoke.py builds it): both tiers of
    the full-read aligner, the beam segment engine and the realign
    kernel's dense and sparse entries (one launch per row shard and
    q-group) equal the one-device run on the card; so do the aligner and
    the beam engine over the range-sharded index on a 2 x 2 mesh."""
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.index.fm import build_fm_index, default_kmer_k
    from tophat_tpu_torch.ops import events
    from tophat_tpu_torch.ops.align import align_reads_adaptive, pad_reads
    from tophat_tpu_torch.ops.beam import beam_align_rows
    from tophat_tpu_torch.parallel import auto
    from tophat_tpu_torch.parallel.mesh import make_mesh

    n = (1 << 21) + 4096
    codes, recs = _workload(n)
    genome = Genome(codes=codes, offsets=np.array([0, n]), names=["chrA"])
    fm = build_fm_index(genome, kmer_k=default_kmer_k(n), device=cuda)
    rf, rr, lens = pad_reads([np.array(["ACGTN".index(c) for c in s],
                                       np.int8) for _, s, _ in recs])
    rows = np.ascontiguousarray(rf[:, 30:55])
    rlens = np.full(len(rows), 25, np.int32)
    reads, lengths, ev = _event_table(codes, 103, 100)
    g = fm.genome
    offs = genome.offsets

    def run():
        al = align_reads_adaptive(fm, rf, rr, lens, offs)
        return ([getattr(al, f).cpu() for f in ("pos", "strand", "mm",
                                                 "valid", "n_hits",
                                                 "truncated")]
                + [x.cpu() for x in beam_align_rows(
                    fm, rows, rlens, offs, max_mismatches=2, max_hits=16)])

    want = run()
    want_r = (events.realign_events(g, reads, lengths, ev, 2),
              events.realign_events_sparse(g, reads, lengths, ev, 2))
    groups = len(np.unique(np.where(ev["kind"] == 2, ev["ins_len"], 0)))
    try:
        auto.activate(make_mesh(4, 1, [cuda] * 4))
        got = run()
        before = _launches()[1]
        got_r = (events.realign_events(g, reads, lengths, ev, 2),
                 events.realign_events_sparse(g, reads, lengths, ev, 2))
        assert _launches()[1] == before + 4 * groups
        monkeypatch.setenv("TOPHAT_TPU_GENOME_SHARDS", "2")
        auto.configure_genome_axis(fm, genome, 100)
        assert auto.genome_sharded(fm)
        got_g = run()
    finally:
        auto.deactivate()
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    # the range-sharded merge fills a table's invalid slots as JAX's
    # make_sharded_align does, so those compare where valid
    keep = lambda al: [torch.where(al[3], x, 0) for x in al[:3]] + al[3:]
    for a, c in zip(keep(want), keep(got_g)):
        assert torch.equal(a, c)
    for a, b in zip(want_r, got_r):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    assert want[3].any(1).float().mean() > 0.4 and len(want_r[1][0]) > 20


def _repeat_problem(n_rep, B=64, L=25, copies=40):
    """A beam genome holding 40 copies of one 60-bp unit, and rows whose
    first n_rep are cut from the unit (each placed at every copy), the
    rest placed once: the repeat rows fill the batch's flat lane cap."""
    from tophat_tpu_torch.pipeline.segment import BEAM_MIN_N

    rng = np.random.default_rng(7)
    N = BEAM_MIN_N + 1024
    codes = rng.integers(0, 4, N).astype(np.int8)
    unit = rng.integers(0, 4, 60).astype(np.int8)
    for p in rng.choice(N // 80 - 1, copies, replace=False) * 80:
        codes[p:p + 60] = unit
    rows = np.zeros((B, L), np.int8)
    for b in range(B):
        if b < n_rep:
            o = int(rng.integers(0, 60 - L))
            rows[b] = unit[o:o + L]
        else:
            p = int(rng.integers(100, N - 100))
            rows[b] = codes[p:p + L]
    return codes, rows


@pytest.mark.gpu
@pytest.mark.parametrize("n_rep", [8, 48])
def test_mesh_beam_keeps_the_batch_lane_cap_on_card(cuda, n_rep):
    """Repeat rows that fill the beam's whole-batch lane cap (a cap sized
    to one shard's rows would cut them differently): on 4 x cuda:0 the
    tables equal the one-device run on the card."""
    from tophat_tpu_torch.index.fm import build_fm_index, default_kmer_k
    from tophat_tpu_torch.ops.beam import beam_align_rows
    from tophat_tpu_torch.parallel import auto
    from tophat_tpu_torch.parallel.mesh import make_mesh

    codes, rows = _repeat_problem(n_rep)
    N = codes.shape[0]
    fm = build_fm_index(codes, kmer_k=default_kmer_k(N), device=cuda)
    offsets = np.array([0, N], np.int32)
    lens = np.full(len(rows), rows.shape[1], np.int32)
    kw = dict(max_mismatches=2, max_hits=16)
    want = beam_align_rows(fm, rows, lens, offsets, **kw)
    try:
        auto.activate(make_mesh(4, 1, [cuda] * 4))
        got = beam_align_rows(fm, rows, lens, offsets, **kw)
    finally:
        auto.deactivate()
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    assert want[4][:n_rep].all() and (want[3][:8] == 16).all()


@pytest.mark.gpu
def test_paired_cli_on_card_mesh_matches_one_device(cuda, tmp_path,
                                                    monkeypatch):
    """The paired CLI in TopHat's default mode on the card, with no mesh
    and on 4 x cuda:0: identical files, and the mesh leaves no state."""
    from test_torch_paired import _pairs  # numpy only at import time
    from tophat_tpu_torch.cli.main import main
    from tophat_tpu_torch.parallel import auto, mesh

    codes, r1, r2 = _pairs(30000, seed=8)
    fa = tmp_path / "g.fa"
    fa.write_text(">chrA\n" + "".join("ACGTN"[c] for c in codes) + "\n")
    fqs = []
    for i, recs in enumerate((r1, r2)):
        fq = tmp_path / f"r{i + 1}.fq"
        fq.write_text("".join(f"@{nm}/{i + 1}\n{s}\n+\n{q.decode()}\n"
                              for nm, s, q in recs))
        fqs.append(str(fq))
    args = ["--batch-size", "40", str(fa)] + fqs
    assert main(["-o", str(tmp_path / "one")] + args) == 0
    monkeypatch.setattr(mesh, "visible_devices", lambda d: [cuda] * 4)
    assert main(["-o", str(tmp_path / "mesh")] + args) == 0
    assert auto.active() is None
    for f in ("accepted_hits.sam", "junctions.bed", "insertions.bed",
              "deletions.bed", "align_summary.txt"):
        assert (tmp_path / "one" / f).read_bytes() == \
            (tmp_path / "mesh" / f).read_bytes(), f


@pytest.mark.gpu
def test_deferred_adaptive_on_card_matches_cpu(cuda):
    """align_reads_adaptive with bench.py's arguments (narrow 6, wide 32,
    resolve_cap 1, uniform_len, defer) on a 2^21-base genome with a k = 10
    seed table and repeat families whose truncated rows overflow the wide
    budget: the deferred call on the card makes no host sync (it runs
    under set_sync_debug_mode("error")) and equals the CPU's deferred
    call field for field; the exact calls agree too."""
    from tophat_tpu_torch.index.fm import build_fm_index
    from tophat_tpu_torch.ops.align import align_reads_adaptive, pad_reads

    rng = np.random.default_rng(41)
    n, L, B = 1 << 21, 100, 4096
    codes = rng.integers(0, 4, n).astype(np.int8)
    for base, copies in ((100_000, 12), (400_000, 40)):
        block = rng.integers(0, 4, 300).astype(np.int8)
        for k in range(copies):
            codes[base + 400 * k:base + 400 * k + 300] = block
    seqs = []
    for b in range(B):
        if b % 4 == 0:              # 1,024 repeat rows: budget 512
            base, copies = ((100_000, 12), (400_000, 40))[b % 8 // 4]
            s = base + 400 * int(rng.integers(0, copies)) + int(
                rng.integers(0, 200))
        else:
            s = int(rng.integers(0, n - L))
        seq = codes[s:s + L].copy()
        for _ in range(2):
            p = int(rng.integers(0, L))
            seq[p] = (seq[p] + int(rng.integers(1, 4))) % 4
        seqs.append(seq if b % 2 else (3 - seq[::-1]).astype(np.int8))
    host = [torch.as_tensor(x) for x in pad_reads(seqs)]
    fm_cpu = build_fm_index(codes, kmer_k=10, device="cpu")
    fm = fm_cpu.to(cuda)
    kw = dict(max_mismatches=2, max_alignments=8, kmer_fast=True,
              narrow_hits=6, wide_hits=32, resolve_cap=1, uniform_len=L)
    offs = torch.tensor([0, n])
    dev_args = [x.to(cuda) for x in host] + [offs.to(cuda)]
    fields = ("pos", "strand", "mm", "valid", "n_hits", "truncated")
    for defer in (True, False):
        want = align_reads_adaptive(fm_cpu, *host, offs, defer=defer, **kw)
        torch.cuda.synchronize()
        if defer:
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = align_reads_adaptive(fm, *dev_args, defer=defer, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        for f in fields:
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
        if defer:
            assert int(got.truncated.sum()) > 0
