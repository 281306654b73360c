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


def _sa_texts():
    """Texts that take every branch of the port's SA-IS: random ones of
    1 to 4 symbols, long runs (an N gap read as A), periodic and tandem
    repeats (deep recursion), and codes over 126 (two-byte symbols)."""
    rng = np.random.default_rng(23)
    texts = [rng.integers(0, k, n) for n in (1, 2, 3, 17, 1000, 20_000)
             for k in (1, 2, 4)]
    runs = rng.integers(0, 4, 30_000)
    runs[5_000:12_000] = 0
    runs[20_000:26_000] = np.tile(runs[:60], 100)
    texts += [runs, np.tile([0, 1], 4_000), np.tile([2, 1, 0], 3_000),
              np.tile(rng.integers(0, 4, 1_000), 20),
              rng.integers(0, 200, 5_000), rng.integers(120, 255, 3_000)]
    return [np.asarray(t, np.uint8) for t in texts]


def _sais64(text):
    """The port's 64-bit SA-IS entry, which the Python wrapper takes only
    past 2^31 symbols."""
    import ctypes

    from tophat_tpu_torch.native import sais

    out = np.empty(len(text) + 1, np.int64)
    fn = sais.lib.sais_suffix_array
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                   ctypes.POINTER(ctypes.c_int64)]
    assert fn(text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
              ctypes.c_int64(len(text)),
              out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))) == 0
    return out


def _kmer_table_numpy(text, sa, k):
    """SA interval [lo, hi) of every k-mer by counting (0, 0 if absent)."""
    n = len(text)
    lo = np.zeros(4 ** k, np.int32)
    hi = np.zeros(4 ** k, np.int32)
    for row, s in enumerate(sa):
        if s + k <= n:
            v = int(np.dot(text[s:s + k], 4 ** np.arange(k - 1, -1, -1)))
            lo[v] = row if not hi[v] else lo[v]
            hi[v] = row + 1
    return lo, hi


@pytest.mark.parametrize("i", range(len(_sa_texts())))
def test_sais_matches_jax(i):
    """The port's SA-IS (compact, 32-bit indexes below 2^31 symbols, the
    rewrite a 1.95 Gbp group needed) gives the JAX package's suffix array
    and prefix doubling's, on both index widths; the BWT and k-mer passes
    give the same on either width (the k-mer table the same as counting
    its rows with numpy)."""
    from tophat_tpu.index.suffix import suffix_array as jax_sa
    from tophat_tpu.index.suffix import suffix_array_doubling
    from tophat_tpu_torch.native import sais

    text = _sa_texts()[i]
    got = sais.suffix_array(text)
    assert got.dtype == np.int32
    want = np.asarray(jax_sa(text))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_sais64(text), want)
    np.testing.assert_array_equal(suffix_array_doubling(text), want)
    b32, p32 = sais.bwt_from_sa(text, got)
    b64, p64 = sais.bwt_from_sa(text, got.astype(np.int64))
    np.testing.assert_array_equal(b32, b64)
    assert p32 == p64 == int(np.nonzero(want == 0)[0][0])
    if len(text) and text.max() < 4:
        want_k = _kmer_table_numpy(text.astype(np.int64), want, 5)
        for sa in (got, got.astype(np.int64)):
            for a, b in zip(sais.kmer_table(text, sa, 5), want_k):
                np.testing.assert_array_equal(a, b)
