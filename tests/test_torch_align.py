"""Unspliced aligner parity: the packed mismatch count (dual and plain
genome pack, with and without the N mask), align_reads_adaptive (every
Alignments field, both tiers and the over-budget rows; the in-program
wide tier with wide_budget, defer and uniform_len, and no host sync in
the deferred call), align_forward_rows and the host transfer, against the
JAX package — exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp


def _genome(seed=23, n=20000):
    """Random genome with an N run and a 150-bp block repeated 40 times
    (reads from it overflow both seed-hit tiers)."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, n).astype(np.int8)
    c[5000:5030] = 4
    block = rng.integers(0, 4, 150).astype(np.int8)
    for k in range(40):
        c[8000 + 200 * k: 8150 + 200 * k] = block
    return c


def _reads(codes, seed, B, L, variable):
    from tophat_tpu.ops.align import pad_reads

    rng = np.random.default_rng(seed)
    seqs = []
    for b in range(B):
        ln = int(rng.integers(L - 20, L + 1)) if variable else L
        s = 8010 if b % 16 == 0 else int(rng.integers(0, len(codes) - ln))
        s = 4990 if b % 16 == 1 else s              # spans the N run
        seq = codes[s:s + ln].copy()
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(0, ln))
            seq[p] = (seq[p] + 1) % 4
        if b % 2:
            seq = (3 - seq[::-1]).astype(np.int8)   # reverse strand
            seq[seq == -1] = 4
        seqs.append(seq)
    return pad_reads(seqs, max_len=L)


@pytest.mark.parametrize("L,has_n,dual", [(25, True, True), (25, False, False),
                                          (100, True, False),
                                          (100, False, True)])
def test_count_mismatches_packed_matches(L, has_n, dual):
    from tophat_tpu.index.fm import build_fm_index
    from tophat_tpu.ops.verify import count_mismatches_packed as jcount
    from tophat_tpu.ops.verify import pack_reads as jpack
    from tophat_tpu_torch.index.fm import FMIndex
    from tophat_tpu_torch.ops.verify import (count_mismatches_packed,
                                             pack_reads)

    codes = _genome()
    jfm = build_fm_index(codes)
    fm = FMIndex.from_numpy(jfm, device="cpu")
    rng = np.random.default_rng(L)
    B, C = 24, 40
    reads = rng.integers(0, 5, (B, L)).astype(np.int8)
    lengths = rng.integers(L // 2, L + 1, B).astype(np.int32)
    reads[np.arange(L)[None, :] >= lengths[:, None]] = -1
    pos = rng.integers(0, len(codes) - L, (B, C)).astype(np.int32)
    pos[:, 0] = 4990                                # window over Ns
    pos[:, 1] = len(codes) - L                      # last window
    pos[:, 2:18] = (pos[:, 2:3] // 16) * 16 + np.arange(16)  # every phase
    dn = (jfm.n + 15) // 16 if dual else 0
    jp = jpack(jnp.asarray(reads), jnp.asarray(lengths))
    tp = pack_reads(torch.as_tensor(reads), torch.as_tensor(lengths))
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(
            np.int64))
    want = jcount(jfm.packed_genome, jfm.n_mask, jnp.asarray(pos), *jp, L,
                  has_n=has_n, dual_nwp=dn)
    got = count_mismatches_packed(fm.packed_genome, fm.n_mask,
                                  torch.as_tensor(pos), *tp, L, has_n=has_n,
                                  dual_nwp=dn)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


FIELDS = ("pos", "strand", "mm", "valid", "n_hits", "truncated")


@pytest.mark.parametrize("kmer_k,variable", [(0, False), (6, True)])
def test_align_reads_adaptive_matches(kmer_k, variable):
    from tophat_tpu.index.fm import build_fm_index
    from tophat_tpu.ops.align import align_reads_adaptive as jalign
    from tophat_tpu.ops.align import kmer_fast_ok as jfast
    from tophat_tpu.ops.align import transfer_alignments as jtransfer
    from tophat_tpu_torch.index.fm import FMIndex
    from tophat_tpu_torch.ops.align import (align_reads_adaptive,
                                            kmer_fast_ok,
                                            transfer_alignments)

    codes = _genome()
    jfm = build_fm_index(codes, kmer_k=kmer_k)
    fm = FMIndex.from_numpy(jfm, device="cpu")
    L = 60
    rf, rr, lens = _reads(codes, 3 + kmer_k, 64, L, variable)
    offsets = np.array([0, 12000, len(codes)], np.int32)  # two contigs
    fast = jfast(jfm, int(lens.min()), 2)
    assert fast == kmer_fast_ok(fm, int(lens.min()), 2) == bool(kmer_k)
    kw = dict(max_mismatches=2, max_alignments=64, kmer_fast=fast,
              narrow_hits=8, wide_hits=32)
    want = jalign(jfm, rf, rr, lens, offsets,
                  uniform_len=0 if variable else L, **kw)
    got = align_reads_adaptive(fm, rf, rr, lens, offsets, **kw)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert got.truncated.any() and (got.n_hits > 0).sum() > 40
    assert (got.n_hits == 32).any()            # the repeat block
    # the host boundary rebuilds the same valid slots
    ht = transfer_alignments(got, cap=64)
    if not isinstance(want.pos, np.ndarray):
        want = jtransfer(want, cap=64)
    for f in FIELDS:
        a, b = getattr(ht, f), np.asarray(getattr(want, f))
        if a.ndim == 2:
            a, b = np.where(ht.valid, a, 0), np.where(want.valid, b, 0)
        np.testing.assert_array_equal(a, b, err_msg=f)


def _repeat_genome(seed=29, n=20000):
    """Random genome with an N run, a 150-bp block repeated 12 times (its
    reads truncate the narrow tier and resolve in the wide one) and
    another repeated 40 times (they truncate both)."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, n).astype(np.int8)
    c[5000:5030] = 4
    for base, copies in ((6000, 12), (9000, 40)):
        block = rng.integers(0, 4, 150).astype(np.int8)
        for k in range(copies):
            c[base + 200 * k:base + 200 * k + 150] = block
    return c


def _repeat_batch(codes, B=96, L=60, seed=31):
    """B reads of L bp: a quarter from the 12-copy block, an eighth from
    the 40-copy one (more truncated rows than any wide budget here), the
    rest anywhere; up to 2 substitutions, odd rows reverse-complemented."""
    from tophat_tpu.ops.align import pad_reads

    rng = np.random.default_rng(seed)
    seqs = []
    for b in range(B):
        if b % 4 == 0:
            s = 6000 + 200 * int(rng.integers(0, 12))
        elif b % 8 == 1:
            s = 9000 + 200 * int(rng.integers(0, 40))
        if b % 4 == 0 or b % 8 == 1:
            s += int(rng.integers(0, 90))
        else:
            s = int(rng.integers(0, len(codes) - L))
        seq = codes[s:s + L].copy()
        for _ in range(int(rng.integers(0, 3))):
            p = int(rng.integers(0, L))
            seq[p] = (seq[p] + 1) % 4
        if b % 2:
            seq = seq[::-1]
            seq = np.where(seq < 4, 3 - seq, 4).astype(np.int8)
        seqs.append(seq)
    return pad_reads(seqs, max_len=L)


@pytest.mark.parametrize("wide_budget", [0, 8], ids=["budget-default",
                                                     "budget-8"])
@pytest.mark.parametrize("uniform", [False, True], ids=["any-len",
                                                        "uniform-len"])
@pytest.mark.parametrize("defer", [False, True], ids=["exact", "defer"])
def test_adaptive_in_program_tier_matches(defer, uniform, wide_budget):
    """The in-program wide tier (no mesh, resolve_cap set) against JAX's
    _align_adaptive_jit path: every field equal, truncated included, on a
    batch whose truncated rows overflow the wide budget (default
    max(B // 8, 8) = 12, or 8). Deferred, the overflow rows come back as
    the narrow tier left them, flagged truncated; exact, they are re-run
    and the result equals the exact call's."""
    from tophat_tpu.index.fm import build_fm_index
    from tophat_tpu.ops.align import align_reads_adaptive as jalign
    from tophat_tpu_torch.index.fm import FMIndex
    from tophat_tpu_torch.ops.align import (align_reads_adaptive,
                                            kmer_fast_ok)

    codes = _repeat_genome()
    jfm = build_fm_index(codes, kmer_k=6)
    fm = FMIndex.from_numpy(jfm, device="cpu")
    L = 60
    rf, rr, lens = _repeat_batch(codes, L=L)
    offsets = np.array([0, 12000, len(codes)], np.int32)  # two contigs
    assert kmer_fast_ok(fm, L, 2)
    kw = dict(max_mismatches=2, max_alignments=64, kmer_fast=True,
              narrow_hits=8, wide_hits=32, resolve_cap=1,
              uniform_len=L if uniform else 0, wide_budget=wide_budget)
    want = jalign(jfm, rf, rr, lens, offsets, defer=defer, **kw)
    got = align_reads_adaptive(fm, rf, rr, lens, offsets, defer=defer, **kw)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    exact = align_reads_adaptive(fm, rf, rr, lens, offsets,
                                 **dict(kw, uniform_len=0, wide_budget=0))
    differ = ~(got.n_hits == exact.n_hits) | (got.truncated
                                               != exact.truncated)
    if defer:           # the overflow rows: still truncated, narrow hits
        assert differ.sum() > 0 and bool(got.truncated[differ].all())
    else:
        assert not differ.any()
    assert (exact.n_hits == 12).sum() >= 12     # resolved by the wide tier
    assert ((exact.n_hits > 0) & ~exact.truncated).sum() > 48


def test_deferred_adaptive_makes_no_host_sync(monkeypatch):
    """align_reads_adaptive(defer=True) on device tensors reads nothing
    back: with every host read-back patched to raise (torch.nonzero,
    Tensor.item/.cpu/.tolist/.numpy, bool/int/float of a tensor, and a
    boolean-mask index, which counts its rows on the host) the deferred
    call runs, while the exact call raises at its re-run of the overflow
    rows."""
    import torch

    from tophat_tpu.index.fm import build_fm_index
    from tophat_tpu_torch.index.fm import FMIndex
    from tophat_tpu_torch.ops.align import align_reads_adaptive

    codes = _repeat_genome()
    fm = FMIndex.from_numpy(build_fm_index(codes, kmer_k=6), device="cpu")
    L = 60
    args = [torch.as_tensor(x) for x in _repeat_batch(codes, L=L)]
    offsets = torch.tensor([0, 12000, len(codes)])
    kw = dict(max_mismatches=2, max_alignments=8, kmer_fast=True,
              narrow_hits=6, wide_hits=32, resolve_cap=1, uniform_len=L)
    want = align_reads_adaptive(fm, *args, offsets, defer=True, **kw)

    def sync(*a, **k):
        raise AssertionError("host sync")

    def masked(index):
        items = index if isinstance(index, tuple) else (index,)
        return any(torch.is_tensor(i) and i.dtype == torch.bool
                   for i in items)

    get, put = torch.Tensor.__getitem__, torch.Tensor.__setitem__

    def getitem(self, index):
        if masked(index):
            sync()
        return get(self, index)

    def setitem(self, index, value):
        if masked(index):
            sync()
        return put(self, index, value)

    monkeypatch.setattr(torch, "nonzero", sync)
    for name in ("nonzero", "item", "cpu", "tolist", "numpy", "__bool__",
                 "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, sync)
    monkeypatch.setattr(torch.Tensor, "__getitem__", getitem)
    monkeypatch.setattr(torch.Tensor, "__setitem__", setitem)
    got = align_reads_adaptive(fm, *args, offsets, defer=True, **kw)
    with pytest.raises(AssertionError, match="host sync"):
        align_reads_adaptive(fm, *args, offsets, defer=False, **kw)
    monkeypatch.undo()
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert bool(got.truncated.any())


def test_align_forward_rows_matches():
    from tophat_tpu.index.fm import build_fm_index
    from tophat_tpu.ops.align import align_forward_rows as jrows
    from tophat_tpu_torch.index.fm import FMIndex
    from tophat_tpu_torch.ops.align import align_forward_rows

    codes = _genome()
    jfm = build_fm_index(codes)
    fm = FMIndex.from_numpy(jfm, device="cpu")
    rf, _, lens = _reads(codes, 8, 96, 25, True)
    lens = np.maximum(lens, 1)
    offsets = np.array([0, len(codes)], np.int32)
    kw = dict(max_mismatches=2, hits_per_seed=16, max_hits=16)
    want = jrows(jfm, rf, lens, offsets, **kw)
    got = align_forward_rows(fm, rf, lens, offsets, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[2].any(axis=1).sum() > 32       # the forward-strand rows
