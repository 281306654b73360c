"""TopHat-Fusion through the command lines: --fusion-search runs of the
port's CLI (paired and single-end, with --tt-index) against the JAX
package's, then the port's tophat-fusion-post (cli/fusion_post.py, its
kmer map on the CPU) against the JAX package's on the same run layout —
every output file byte-identical."""

import os
import shutil

import pytest

from test_torch_fusion import FILES, break_recall, write_inputs

FLAGS = ["--fusion-search", "--max-intron-length", "1000",
         "--fusion-min-dist", "2000", "--fusion-anchor-length", "13",
         "--no-coverage-search"]
POST_FILES = ("sample_list.txt", "fusion_seq.fa", "fusion_seq.map",
              "potential_fusion.txt", "result.txt", "result.html")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """tophat_<sample>/ layouts of both packages: s1 paired, s2 single-end,
    each run through its package's CLI (the port's with --tt-index, in two
    chunks)."""
    from tophat_tpu.cli.main import main as jax_main
    from tophat_tpu_torch.cli.main import main as torch_main

    root = tmp_path_factory.mktemp("fusion_cli")
    fa, fq1, fq2, truth = write_inputs(root)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TOPHAT_TPU_DEVICES", "1")    # one device, as the port
        for which, main, extra in (
                ("jax", jax_main, []),
                ("torch", torch_main, ["--device", "cpu", "--tt-index",
                                       str(root / "idx" / "g")])):
            for sample, reads in (("s1", [fq1, fq2]), ("s2", [fq1])):
                out = root / which / f"tophat_{sample}"
                assert main(["-o", str(out), "--batch-size", "48"] + FLAGS
                            + extra + [fa] + reads) == 0
    return root, fa, truth


@pytest.mark.parametrize("sample", ["s1", "s2"])
def test_fusion_cli_identical(runs, sample):
    root, _, truth = runs
    a = root / "jax" / f"tophat_{sample}"
    b = root / "torch" / f"tophat_{sample}"
    for f in FILES:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f
    assert len((b / "fusions.out").read_text().splitlines()) == 6
    assert break_recall(b / "accepted_hits.sam", truth) == 1


def test_fusion_post_identical(runs, monkeypatch):
    """tophat-fusion-post over both samples (no blastn, no annotation,
    the read and pair floors lowered to 1 and 0): potential_fusion.txt,
    fusion_seq.map, result.txt and the rest equal the JAX package's, the
    port's kmer map on --device cpu."""
    from tophat_tpu.cli.fusion_post import main as jax_post
    from tophat_tpu_torch.cli.fusion_post import main as torch_post

    root, fa, _ = runs
    args = ["--no-filter-by-annotation", "--skip-blast",
            "--num-fusion-reads", "1", "--num-fusion-pairs", "0", fa]
    for which, post, extra in (("jax", jax_post, []),
                               ("torch", torch_post, ["--device", "cpu"])):
        monkeypatch.chdir(root / which)
        shutil.rmtree("tophatfusion_out", ignore_errors=True)
        assert post(extra + args) == 0
    a = root / "jax" / "tophatfusion_out"
    b = root / "torch" / "tophatfusion_out"
    for f in POST_FILES:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f
    assert sorted(os.listdir(a / "read_alignments")) == \
        sorted(os.listdir(b / "read_alignments"))
    assert (b / "sample_list.txt").read_text().split() == ["s1", "s2"]
    assert len((b / "potential_fusion.txt").read_text().splitlines()) >= 12
    assert [ln for ln in (b / "result.txt").read_text().splitlines()
            if not ln.startswith("#")]


def test_fusion_post_device_defaults_to_cuda(runs, monkeypatch):
    """The kmer map's index goes to the card unless --device says
    otherwise; without CUDA the post-processor raises before mapping."""
    import torch

    from tophat_tpu_torch.cli.fusion_post import build_parser, main

    assert build_parser().parse_args(["g.fa"]).device == "cuda"
    root, fa, _ = runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(root / "torch")
    with pytest.raises(RuntimeError, match="is_available"):
        main(["-o", "post_nocuda", "--no-filter-by-annotation",
              "--skip-blast", fa])


def test_kmer_map_keeps_every_placement(monkeypatch):
    """At 2^22 bases a 23-mer's 7- and 8-base pigeonhole pieces occur
    hundreds of times, past align_reads' default seed budget of 32 (which
    the JAX package's kmer map keeps): the port's kmer map still finds
    every 23-mer at its own position and at a planted copy with two
    mismatches, in one call or in slices."""
    import numpy as np

    from tophat_tpu_torch.cli import fusion_post
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.index.fm import build_fm_index
    from tophat_tpu_torch.ops.align import align_reads, pad_reads

    rng = np.random.default_rng(8)
    n = 1 << 22
    codes = rng.integers(0, 4, n).astype(np.int8)
    starts = rng.integers(0, n // 2, 24)
    for k, s in enumerate(starts[:8]):           # copies with 2 mismatches
        c = n // 2 + 1000 * k
        codes[c:c + 23] = codes[s:s + 23]
        codes[c + 5] = (codes[c + 5] + 1) % 4
        codes[c + 17] = (codes[c + 17] + 2) % 4
    genome = Genome(codes=codes, offsets=np.array([0, n]), names=["chrK"])
    kmers = ["".join("ACGT"[c] for c in codes[s:s + 23]) for s in starts]
    fm = build_fm_index(genome, device="cpu")
    want = [{int(s)} | ({n // 2 + 1000 * k} if k < 8 else set())
            for k, s in enumerate(starts)]
    pos, valid = fusion_post._align_kmers(fm, genome, kmers)
    assert [set(p[v].tolist()) for p, v in zip(pos, valid)] == want
    rf, rr, lens = pad_reads([codes[s:s + 23] for s in starts])
    capped = align_reads(fm, rf, rr, lens, np.array([0, n]),
                         max_mismatches=2, max_alignments=64)
    assert sum(int(s in p[v].tolist()) for s, p, v in zip(
        starts, capped.pos.numpy(), capped.valid.numpy())) < len(starts)
    monkeypatch.setattr(fusion_post, "KMER_LANES", 6 * 4096)
    sliced = fusion_post._align_kmers(fm, genome, kmers)
    np.testing.assert_array_equal(sliced[0], pos)
    np.testing.assert_array_equal(sliced[1], valid)


def test_smoke_slice_design_matches_jax(tmp_path, monkeypatch):
    """chip_smoke.py's fusion slice (phase 7: the first 2^21 + 4096 bases
    of its genome, 24 designed breaks, 2,048 pairs, TopHat-Fusion's flags)
    through both packages' CLIs, paired and single-end, then both
    post-processors: identical files, and the JAX package places every
    break read and junction read and reports every designed break, which
    is what lets the smoke hold the port at 100% recall on the card."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    from tophat_tpu.cli.fusion_post import main as jax_post
    from tophat_tpu.cli.main import main as jax_main
    from tophat_tpu_torch.cli.fusion_post import main as torch_post
    from tophat_tpu_torch.cli.main import main as torch_main

    monkeypatch.setenv("TOPHAT_TPU_DEVICES", "1")   # one device, as the port
    small = cs.make_genome()[:(1 << 21) + 4096]
    breaks = cs.pick_fusion_breaks(small, seed=53)
    m1, m2, fused = cs.make_fusion_pairs(small, cs.pick_junctions(small, 16),
                                         breaks, 55, cs.SMALL_PAIRS)
    fa = str(tmp_path / "genome.fa")
    cs.write_fasta(fa, small)
    fqs = [str(tmp_path / f"p_{k}.fq") for k in (1, 2)]
    cs.write_fastq(fqs[0], m1, "p")
    cs.write_fastq(fqs[1], m2, "p")
    for which, main, post, extra in (
            ("jax", jax_main, jax_post, []),
            ("torch", torch_main, torch_post, ["--device", "cpu"])):
        for sample, reads in (("paired", fqs), ("single", fqs[:1])):
            assert main(["-o", str(tmp_path / which / f"tophat_{sample}")]
                        + extra + cs.FUSION_FLAGS + [fa] + reads) == 0
        monkeypatch.chdir(tmp_path / which)
        assert post(extra + ["--skip-blast", "--no-filter-by-annotation",
                             fa]) == 0
    files = [f"tophat_{s}/{f}" for s in ("paired", "single")
             for f in FILES] + [f"tophatfusion_out/{f}" for f in POST_FILES]
    for f in files:
        assert (tmp_path / "jax" / f).read_bytes() == \
            (tmp_path / "torch" / f).read_bytes(), f
    for sample in ("paired", "single"):
        assert cs.fusion_recall(str(tmp_path / "jax" / f"tophat_{sample}"),
                                small, breaks, fused, cs.SMALL_PAIRS) == \
            (100.0, 100.0, [])
    assert cs.designed_in_result(
        str(tmp_path / "jax" / "tophatfusion_out" / "result.txt"), small,
        breaks, fused) >= 1
