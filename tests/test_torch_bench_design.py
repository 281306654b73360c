"""chip_smoke.py's phase 19, the JAX package's bench.py design point (one
index with a k = 14 seed table and a full SA over a 2^30-base genome),
at 1/256 of its genome on the CPU: 2^22 bases of the same seed and a
k = 10 table (four bases a table entry, as at the design point). Its
generators feed both packages: the unspliced batches through
align_reads_adaptive with bench.py's arguments, deferred and exact, and
the spliced reads through run_pipeline, whose files must be identical,
with every junction read spliced."""

import os
import sys

import numpy as np
import pytest

OUTPUTS = ("accepted_hits.sam", "junctions.bed", "insertions.bed",
           "deletions.bed")
N = 1 << 22
K = 10


def _smoke():
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    return chip_smoke


@pytest.fixture(scope="module")
def design():
    """(chip_smoke, genome codes, JAX index, the port's index) at 2^22."""
    from tophat_tpu.index.fm import build_fm_index as jbuild
    from tophat_tpu_torch.index.fm import build_fm_index

    cs = _smoke()
    codes = cs.bench_genome(N)
    jfm = jbuild(codes, kmer_k=K, sa_rate=0)
    fm = build_fm_index(codes, kmer_k=K, sa_rate=0, device="cpu")
    return cs, codes, jfm, fm


def test_bench_genome_is_bench_py_draw(design):
    """The chunked draw is bench.py's one int64 draw of seed 7, and the
    port's host build at the design (k-mer table, full SA) equals JAX's."""
    cs, codes, jfm, fm = design
    np.testing.assert_array_equal(
        codes, np.random.default_rng(7).integers(0, 4, N).astype(np.int8))
    for k in ("sa", "kmer_lo", "kmer_hi", "occ_ck", "C"):
        np.testing.assert_array_equal(getattr(fm, k).numpy(),
                                      np.asarray(getattr(jfm, k)), err_msg=k)
    assert fm.sa.shape[0] == N + 1 and fm.kmer_lo.shape[0] == 4 ** K


@pytest.mark.parametrize("defer", [True, False], ids=["defer", "exact"])
def test_bench_unspliced_matches_jax(design, defer):
    """bench.py's unspliced call (narrow 6, wide 32, resolve_cap 1,
    uniform_len 100, max_alignments 8) on two of its batches of 16,384
    reads: every field equal to JAX's; at least 99% aligned, and the
    deferred checksum equals the exact one."""
    import torch

    from tophat_tpu.ops.align import align_reads_adaptive as jalign
    from tophat_tpu_torch.ops.align import (align_reads_adaptive,
                                            kmer_fast_ok)

    cs, codes, jfm, fm = design
    assert kmer_fast_ok(fm, cs.READ_LEN, 2)
    offsets = np.array([0, N], np.int32)
    kw = dict(cs.BENCH_ALIGN, kmer_fast=True)
    for seed in (100, 101):
        rf, rr, lens = cs.unspliced_batch(codes, seed)
        want = jalign(jfm, rf, rr, lens, offsets, defer=defer, **kw)
        got = align_reads_adaptive(fm, rf, rr, lens, offsets, defer=defer,
                                   **kw)
        for f in ("pos", "strand", "mm", "valid", "n_hits", "truncated"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
        assert (got.n_hits > 0).sum() >= 0.99 * cs.BATCH
        exact = align_reads_adaptive(fm, rf, rr, lens, offsets, **kw)
        assert torch.equal(got.n_hits.sum(), exact.n_hits.sum())


def test_bench_spliced_pipeline_matches_jax(design, tmp_path):
    """bench.py's spliced reads (25% across one of 64 natural GT..AG
    introns, the rest contiguous with a mismatch; its 32,768) through
    both packages' run_pipeline on the design's index,
    --no-coverage-search: identical files, 100% junction-read recall."""
    from tophat_tpu.index.fasta import Genome as JGenome
    from tophat_tpu.io.fastq import batch_reads as jbatch
    from tophat_tpu.pipeline.params import Params as JParams
    from tophat_tpu.pipeline.run import run_pipeline as jrun
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.io.fastq import batch_reads
    from tophat_tpu_torch.pipeline.params import Params
    from tophat_tpu_torch.pipeline.run import run_pipeline

    cs, codes, jfm, fm = design
    juncs = cs.pick_junctions(codes)
    assert len(juncs) == 64
    n_reads = 32768
    recs = cs.bench_records(codes, juncs, 6, n_reads)
    offsets = np.array([0, N])
    quiet = lambda *a: None
    jrun(JGenome(codes=codes, offsets=offsets, names=["chr1"]),
         jbatch(recs), JParams(coverage_search=False), str(tmp_path / "jax"),
         fm=jfm, log=quiet)
    run_pipeline(Genome(codes=codes, offsets=offsets, names=["chr1"]),
                 batch_reads(recs), Params(coverage_search=False),
                 str(tmp_path / "torch"), fm=fm, log=quiet, device="cpu")
    for f in OUTPUTS:
        assert (tmp_path / "jax" / f).read_bytes() == \
            (tmp_path / "torch" / f).read_bytes(), f
    sam = str(tmp_path / "torch" / "accepted_hits.sam")
    assert cs.junction_recall(sam, n_reads) == 100.0
