"""Half-split + k-mer-variant segment engine parity: beam_plan,
beam_align_rows and map_segments(engine="beam") of the port against the
JAX package, exact equality of every table."""

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", params=[0, 4], ids=["full_sa", "sampled_sa"])
def genome(request):
    from tophat_tpu.index.fm import build_fm_index
    from tophat_tpu_torch.index.fm import FMIndex

    rng = np.random.default_rng(31)
    codes = rng.integers(0, 4, 60000).astype(np.int8)
    codes[20000:20015] = 4
    block = rng.integers(0, 4, 40).astype(np.int8)
    for k in range(30):                         # a repeat family
        codes[30000 + 60 * k: 30040 + 60 * k] = block
    jfm = build_fm_index(codes, kmer_k=7, sa_rate=request.param)
    return codes, jfm, FMIndex.from_numpy(jfm, device="cpu")


def _segments(codes, seed, B=160):
    """25-bp segments (some shorter) with 0-2 mismatches, including
    one-per-half split pairs, N bases, repeats and too-short rows."""
    rng = np.random.default_rng(seed)
    rows = np.full((B, 25), -1, np.int8)
    lens = np.full(B, 25, np.int32)
    for b in range(B):
        ln = 25 if b % 5 else int(rng.integers(8, 25))
        s = 30005 if b % 11 == 0 else int(rng.integers(0, len(codes) - ln))
        seg = codes[s:s + ln].copy()
        if b % 3 == 1:                          # split pair
            i = int(rng.integers(0, ln // 2))
            j = int(rng.integers(ln // 2, ln))
            seg[i] = (seg[i] + 1) % 4
            seg[j] = (seg[j] + 2) % 4
        elif b % 3 == 2:
            seg[int(rng.integers(0, ln))] = 4
        rows[b, :ln] = seg
        lens[b] = ln
    return rows, lens


def test_beam_align_rows_matches(genome):
    from tophat_tpu.ops.beam import beam_align_rows as jbeam
    from tophat_tpu.ops.beam import beam_plan as jplan
    from tophat_tpu_torch.ops.beam import beam_align_rows, beam_plan

    codes, jfm, fm = genome
    rows, lens = _segments(codes, 4)
    offsets = np.array([0, 25000, len(codes)], np.int32)
    assert beam_plan(fm, 25, lens, 2) == jplan(jfm, 25, lens, 2)
    assert beam_plan(fm, 25, lens, 2)["split_pair"]
    want = jbeam(jfm, rows, lens, offsets, max_mismatches=2, max_hits=16)
    got = beam_align_rows(fm, rows, lens, offsets, max_mismatches=2,
                          max_hits=16)
    for name, a, b in zip(("pos", "mm", "valid", "n_hits", "trunc"), got,
                          want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert got[2].any(axis=1).sum() > 120 and got[4].any()


def test_map_segments_beam_matches(genome):
    from tophat_tpu.ops.align import pad_reads
    from tophat_tpu.pipeline.segment import build_genome_space as jbuild
    from tophat_tpu.pipeline.segment import map_segments as jmap
    from tophat_tpu_torch.pipeline.segment import (build_genome_space,
                                                   map_segments)

    codes, jfm, fm = genome
    rng = np.random.default_rng(8)
    seqs = []
    for b in range(40):
        ln = int(rng.integers(60, 101))
        s = int(rng.integers(0, len(codes) - ln))
        seq = codes[s:s + ln].copy()
        seq[int(rng.integers(0, ln))] = int(rng.integers(0, 4))
        seqs.append(seq)
    rf, rr, lens = pad_reads(seqs)
    ium = np.arange(40) % 4 != 3
    gs_j = jbuild(rf, rr, lens, 25, row_mask=ium, pad_rows_pow2=True)
    gs_t = build_genome_space(rf, rr, lens, 25, row_mask=ium,
                              pad_rows_pow2=True)
    for f in ("readsg", "lengths", "cuts", "nseg", "read_idx", "strand"):
        np.testing.assert_array_equal(getattr(gs_t, f), getattr(gs_j, f))
    offsets = np.array([0, len(codes)], np.int32)
    kw = dict(segment_mismatches=2, hits_per_seed=32, max_hits=16,
              engine="beam")
    want = jmap(jfm, offsets, gs_j, **kw)
    got = map_segments(fm, offsets, gs_t, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    fwd = torch.as_tensor((gs_t.read_idx >= 0) & (gs_t.strand == 0))
    assert got[2][fwd, 0].any(dim=1).float().mean() > 0.9   # forward reads
