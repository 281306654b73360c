"""FM-index parity: the port's index tables, rank/LF, backward search and
SA resolution (full and sampled SA, with N bases and a k-mer seed table)
against the JAX package, exact integer equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp


@pytest.fixture(scope="module")
def codes():
    rng = np.random.default_rng(17)
    c = rng.integers(0, 4, 6000).astype(np.int8)
    c[700:740] = 4
    c[3001] = 4
    return c


def _indexes(codes, kmer_k, sa_rate):
    from tophat_tpu.index.fm import build_fm_index as jax_build
    from tophat_tpu_torch.index.fm import FMIndex, build_fm_index

    jfm = jax_build(codes, kmer_k=kmer_k, sa_rate=sa_rate)
    return jfm, FMIndex.from_numpy(jfm, device="cpu"), build_fm_index(
        codes, kmer_k=kmer_k, sa_rate=sa_rate, device="cpu")


@pytest.mark.parametrize("kmer_k,sa_rate", [(0, 0), (5, 4)])
def test_index_tables_match(codes, kmer_k, sa_rate, tmp_path):
    from tophat_tpu.index.fm import FMIndex as JaxFM
    from tophat_tpu_torch.index.fm import TABLES, FMIndex

    jfm, carried, built = _indexes(codes, kmer_k, sa_rate)
    for fm in (carried, built):
        assert fm.n == jfm.n and fm.primary == int(jfm.primary)
        assert (fm.kmer_k, fm.sa_rate, fm.has_n, fm.pg_dual) == (
            jfm.kmer_k, jfm.sa_rate, jfm.has_n, jfm.pg_dual)
        for k, dt in TABLES.items():
            np.testing.assert_array_equal(
                getattr(fm, k).numpy().astype(dt), np.asarray(getattr(jfm, k)),
                err_msg=k)
    # .npz files are interchangeable both ways
    built.save(str(tmp_path / "port.npz"))
    back = JaxFM.load(str(tmp_path / "port.npz"))
    jfm.save(str(tmp_path / "jax.npz"))
    fwd = FMIndex.load(str(tmp_path / "jax.npz"), device="cpu")
    for k in TABLES:
        np.testing.assert_array_equal(np.asarray(getattr(back, k)),
                                      np.asarray(getattr(jfm, k)))
        assert torch.equal(getattr(fwd, k), getattr(built, k))


@pytest.mark.parametrize("kmer_k,sa_rate", [(0, 0), (5, 4)])
def test_rank_lf_resolve_match(codes, kmer_k, sa_rate):
    from tophat_tpu.ops.rank import lf as jlf
    from tophat_tpu.ops.rank import rank as jrank
    from tophat_tpu.ops.search import resolve_sa as jresolve
    from tophat_tpu_torch.ops.rank import lf, rank
    from tophat_tpu_torch.ops.search import resolve_sa

    jfm, fm, _ = _indexes(codes, kmer_k, sa_rate)
    rng = np.random.default_rng(1)
    i = np.concatenate([[0, 1, fm.primary, fm.primary + 1, fm.n, fm.n + 1],
                        rng.integers(0, fm.n + 2, 400)]).astype(np.int32)
    c = rng.integers(0, 4, i.shape[0]).astype(np.int32)
    np.testing.assert_array_equal(rank(fm, torch.as_tensor(c),
                                       torch.as_tensor(i)).numpy(),
                                  np.asarray(jrank(jfm, c, i)))
    rows = np.clip(i, 0, fm.n).astype(np.int32)
    np.testing.assert_array_equal(lf(fm, torch.as_tensor(rows)).numpy(),
                                  np.asarray(jlf(jfm, rows)))
    np.testing.assert_array_equal(resolve_sa(fm, torch.as_tensor(rows))
                                  .numpy(), np.asarray(jresolve(jfm, rows)))


@pytest.mark.parametrize("kmer_k,sa_rate", [(0, 0), (5, 4)])
def test_backward_search_and_hits_match(codes, kmer_k, sa_rate):
    from tophat_tpu.ops.search import backward_search as jbs
    from tophat_tpu.ops.search import resolve_hits as jhits
    from tophat_tpu_torch.ops.search import backward_search, resolve_hits

    jfm, fm, _ = _indexes(codes, kmer_k, sa_rate)
    rng = np.random.default_rng(2)
    B, L = 200, 12
    q = np.full((B, L), -1, np.int32)
    for b in range(B):
        ln = int(rng.integers(3, L + 1))
        s = int(rng.integers(0, len(codes) - ln))
        q[b, L - ln:] = codes[s:s + ln]
        if b % 9 == 0:
            q[b, L - ln:] = rng.integers(0, 4, ln)    # mostly absent
        if b % 13 == 0:
            q[b, -2] = 4                               # N in the seed
    q[0, :] = codes[700 - 4:700 + 8]                   # runs into the Ns
    lo, hi = backward_search(fm, torch.as_tensor(q))
    jlo, jhi = jbs(jfm, q)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    assert ((hi - lo) > 0).sum() > B // 2
    pos, valid, trunc = resolve_hits(fm, lo, hi, 4)
    jpos, jvalid, jtrunc = jhits(jfm, jlo, jhi, 4)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc))
