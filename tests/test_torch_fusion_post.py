"""TopHat-Fusion through the command lines: --fusion-search runs of the
port's CLI (paired and single-end, with --tt-index) against the JAX
package's, then the port's tophat-fusion-post (cli/fusion_post.py, its
kmer map on the CPU) against the JAX package's on the same run layout —
every output file byte-identical. On genomes past the group cap (the
contig-group fixture, chip_smoke.py's human ladder at 1/1,000) the
port's kmer map runs over the run's contig-group indexes: against the
JAX package's one index, and against the port's own one index."""

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


def _fusions_out(path, kmers):
    """A tophat_<sample>/fusions.out whose rows carry `kmers` pairwise as
    the 23-mers before and after their breaks (the fields the kmer map
    reads: the left flank's end and the right flank's start)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for a, b in zip(kmers[::2], kmers[1::2]):
            f.write("chr0-chr1\t100\t200\tff\t1\t0\t0\t0\t20\t20\t0.0\t@\t"
                    f"0 \t@\tAC{a} GT\t@\tCA {b}TG\t@\t0 \t@\t0 \t@\t\n")


@pytest.fixture(scope="module")
def grouped_runs(tmp_path_factory):
    """The grouped fixture's paired fusion sample (two contig groups under
    --max-index-bases) through both packages' CLIs, each into its own
    tophat_s1/; the group caches go beside the FASTA, where the JAX run
    writes them and the port's run reuses them."""
    from test_torch_grouped import CLI_CASES, MAX_BASES, write_fixture
    from tophat_tpu.cli.main import main as jax_main
    from tophat_tpu_torch.cli.main import main as torch_main

    root = tmp_path_factory.mktemp("fusion_grouped")
    fa, fq1, fq2, _ = write_fixture(root)
    argv = (["--max-index-bases", str(MAX_BASES)]
            + CLI_CASES["paired_fusion"] + [fa, fq1, fq2])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TOPHAT_TPU_DEVICES", "1")
        assert jax_main(["-o", str(root / "jax" / "tophat_s1")] + argv) == 0
        assert torch_main(["-o", str(root / "torch" / "tophat_s1"),
                           "--device", "cpu"] + argv) == 0
    return root, fa, MAX_BASES


def _grouped_post(monkeypatch, max_bases):
    """The port's fusion-post main with the kmer map's group cap at the
    fixture's --max-index-bases (the CLI has no flag for it)."""
    import functools

    from tophat_tpu_torch.cli import fusion_post

    monkeypatch.setattr(fusion_post, "build_kmer_map", functools.partial(
        fusion_post.build_kmer_map, max_bases=max_bases))
    return fusion_post.main


GROUPED_POST_ARGS = ["--no-filter-by-annotation", "--skip-blast",
                     "--num-fusion-reads", "1", "--num-fusion-pairs", "0"]


def test_grouped_fusion_post_matches_jax(grouped_runs, monkeypatch, capsys):
    """tophat-fusion-post after grouped fusion runs: the JAX package maps
    the kmers with one index over the whole genome, the port over the
    run's two contig-group indexes (reused from beside the FASTA).
    potential_fusion.txt, result.txt and fusion_seq.map are byte-identical
    (no kmer here has placements in both groups, so the group order
    cannot show in fusion_seq.map), and the chr0 -> chr1 fusion passes the
    filters."""
    from tophat_tpu.cli.fusion_post import main as jax_post

    root, fa, max_bases = grouped_runs
    torch_post = _grouped_post(monkeypatch, max_bases)
    for which, post, extra in (("jax", jax_post, []),
                               ("torch", torch_post, ["--device", "cpu"])):
        monkeypatch.chdir(root / which)
        shutil.rmtree("tophatfusion_out", ignore_errors=True)
        capsys.readouterr()
        assert post(extra + GROUPED_POST_ARGS + [fa]) == 0
    err = capsys.readouterr().err
    assert err.count("reusing FM index") == 2, err
    a = root / "jax" / "tophatfusion_out"
    b = root / "torch" / "tophatfusion_out"
    for f in POST_FILES:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f
    assert (b / "potential_fusion.txt").read_text().startswith(
        "s1 chr0-chr1 8000 9000 ff ")
    kmap = (b / "fusion_seq.map").read_text().splitlines()
    assert len(kmap) == 2 and all(":" in ln for ln in kmap)


def test_grouped_kmer_map_reuses_group_caches(grouped_runs, tmp_path,
                                              monkeypatch, capsys):
    """Fusion-post on a genome past the group cap builds the contig-group
    indexes beside the FASTA once (`<FASTA>.g<i>.tt.npz`, the CLI's cache
    prefix); a second call reuses both and builds nothing; a stale group
    cache (a truncated file) is rebuilt alone. Every call writes the same
    files."""
    from tophat_tpu_torch.index import grouped

    root, fa, max_bases = grouped_runs
    post = _grouped_post(monkeypatch, max_bases)
    shutil.copy(fa, tmp_path / "g.fa")
    shutil.copytree(root / "torch" / "tophat_s1", tmp_path / "tophat_s1")
    fa = str(tmp_path / "g.fa")
    caches = [f"{fa}.g{i}.tt.npz" for i in (0, 1)]
    monkeypatch.chdir(tmp_path)
    build = grouped.build_fm_index
    built = []

    def counted(*a, **k):
        built.append(1)
        return build(*a, **k)

    monkeypatch.setattr(grouped, "build_fm_index", counted)
    outs, logs = [], []
    for step in ("fresh", "reuse", "stale"):
        if step == "stale":
            data = open(caches[0], "rb").read()
            with open(caches[0], "wb") as f:
                f.write(data[: len(data) // 2])
        shutil.rmtree("tophatfusion_out", ignore_errors=True)
        capsys.readouterr()
        assert post(["--device", "cpu"] + GROUPED_POST_ARGS + [fa]) == 0
        logs.append(capsys.readouterr().err.count("reusing FM index"))
        outs.append({f: (tmp_path / "tophatfusion_out" / f).read_bytes()
                     for f in POST_FILES})
        assert all(os.path.exists(c) for c in caches)
        if step == "reuse":
            assert not built
        built.clear()
    assert logs == [0, 2, 1]
    assert outs[0] == outs[1] == outs[2]
    assert outs[0]["fusion_seq.map"].count(b":") == 2


def test_kmer_map_keeps_placements_of_both_groups(tmp_path):
    """A kmer placed in both contig groups keeps every placement, group 0's
    first, each group's in its own align_reads order; the same set as one
    index over the whole genome finds. A kmer with 64 placements in each
    group (align_reads' cap a call) keeps 100, the -m 100 cap: all 64 of
    group 0, then the first 36 of group 1."""
    import numpy as np

    from tophat_tpu_torch.cli import fusion_post
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.index.fm import build_fm_index
    from tophat_tpu_torch.index.grouped import build_grouped_fm

    rng = np.random.default_rng(17)
    k, names = 12_000, ["chr0", "chr1", "chr2", "chr3"]
    codes = rng.integers(0, 4, 4 * k).astype(np.int8)
    kmers = [rng.integers(0, 4, 23).astype(np.int8) for _ in range(2)]
    both = [(0, 3000), (1, 11_000), (2, 7000), (3, 11_500)]
    for c, at in both:
        codes[c * k + at: c * k + at + 23] = kmers[0]
    many = [(c, 200 + 150 * j) for c in (1, 3) for j in range(70)]
    for c, at in many:
        codes[c * k + at: c * k + at + 23] = kmers[1]
    genome = Genome(codes=codes, offsets=np.arange(5) * k, names=names)
    fa = tmp_path / "g.fa"
    fa.write_text("".join(f">{n}\n" + "".join(
        "ACGT"[x] for x in codes[i * k:(i + 1) * k]) + "\n"
        for i, n in enumerate(names)))
    seqs = ["".join("ACGT"[x] for x in km) for km in kmers]
    _fusions_out(str(tmp_path / "tophat_s" / "fusions.out"), seqs)
    out = tmp_path / "post"
    out.mkdir()
    kmap = fusion_post.build_kmer_map(genome, ["s"], str(out),
                                      cwd=str(tmp_path), device="cpu",
                                      genome_path=str(fa), max_bases=25_000)

    gfm = build_grouped_fm(genome, max_bases=25_000,
                           cache_prefix=str(fa))
    want = {s: [] for s in seqs}
    for g in range(2):
        pos, valid = fusion_post._align_kmers(gfm.fms[g],
                                              gfm.sub_genomes[g], seqs)
        for i, s in enumerate(seqs):
            for p in pos[i][valid[i]]:
                cid, local = genome.global_to_contig(
                    np.int64(p) + gfm.bases[g])
                want[s].append((names[int(cid)], int(local)))
    assert kmap[seqs[0]] == want[seqs[0]]
    assert sorted(kmap[seqs[0]]) == [(names[c], at) for c, at in both]
    assert [c for c, _ in kmap[seqs[0]]] == names
    assert len(want[seqs[1]]) == 128
    assert kmap[seqs[1]] == want[seqs[1]][:100]
    assert [c for c, _ in kmap[seqs[1]]] == ["chr1"] * 64 + ["chr3"] * 36

    single = fusion_post._align_kmers(build_fm_index(genome, device="cpu"),
                                      genome, seqs[:1])
    assert sorted(genome.global_to_contig(single[0][0][single[1][0]])[1]
                  .tolist()) == sorted(at for _, at in both)
    lines = dict(ln.split("\t") for ln in
                 (out / "fusion_seq.map").read_text().splitlines())
    assert lines == {s: ",".join(f"{c}:{p}" for c, p in kmap[s])
                     for s in seqs}


def test_human_fusion_design_matches_jax(tmp_path, monkeypatch):
    """chip_smoke.py's phase 18 at 1/1,000 of its ladder (3,093,000 bases,
    24 contigs): its designed breaks (12 within each of the 2 groups,
    half between two contigs; 4 across the groups) and 4,096 pairs of its
    design (seed 111) through both packages' CLIs with TopHat-Fusion's
    flags, --max-index-bases cutting at chr12 as the default cuts the full
    ladder: identical files, the phase's checks pass on them, and no
    cross-group break is found (the reference's limit). Then the port's
    fusion-post over the run's 2 group indexes against its fusion-post
    over one index of the whole genome (the JAX package's kmer map keeps
    32 seeds a piece, too few at 3 Mbp: ROADMAP Queue 3): the same
    potential_fusion.txt and result.txt, each kmer's placements equal as
    sets (their order may differ: group order against one index's), and
    designed breaks in result.txt."""
    import functools
    import sys

    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    from tophat_tpu.cli.main import main as jax_main
    from tophat_tpu_torch.cli import fusion_post
    from tophat_tpu_torch.cli.main import main as torch_main
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.index.grouped import contig_group_ranges

    cap = 1_950_000
    monkeypatch.setenv("TOPHAT_TPU_DEVICES", "1")   # one device, as the port
    monkeypatch.setattr(cs, "HUMAN_PER_MBP", 1000)
    codes, offsets, names, introns = cs.human_genome()
    groups = contig_group_ranges(Genome(codes=codes, offsets=offsets,
                                        names=names), cap)
    assert [(r.start, r.stop) for r in groups] == [(0, 11), (11, 24)]
    breaks, cross = cs.pick_human_breaks(offsets, introns, groups)
    planted = [(int(offsets[c]) + a, int(offsets[c]) + b)
               for c, a, b in introns]
    n = 4096
    m1, m2, fused = cs.make_fusion_pairs(codes, planted, breaks, 111, n,
                                         offsets=offsets, cross=cross)
    fa = str(tmp_path / "hs.fa")
    fqs = [str(tmp_path / f"p_{k}.fq") for k in (1, 2)]
    cs.write_fasta(fa, codes, cuts=offsets[:-1])
    cs.write_fastq(fqs[0], m1, "p")
    cs.write_fastq(fqs[1], m2, "p")
    argv = cs.FUSION_FLAGS + ["--max-index-bases", str(cap), fa] + fqs
    assert jax_main(["-o", str(tmp_path / "jax" / "tophat_s1")] + argv) == 0
    assert torch_main(["-o", str(tmp_path / "torch" / "tophat_s1"),
                       "--device", "cpu"] + argv) == 0
    for f in FILES:
        assert (tmp_path / "jax" / "tophat_s1" / f).read_bytes() == \
            (tmp_path / "torch" / "tophat_s1" / f).read_bytes(), f
    out = str(tmp_path / "torch" / "tophat_s1")
    inside = {i: v for i, v in fused.items() if v[:3] in breaks}
    across = {i: v for i, v in fused.items() if v[:3] in cross}
    assert cs.fusion_recall(out, codes, breaks, inside, n, offsets,
                            names) == (100.0, 100.0, [])
    assert cs.fusion_recall(out, codes, cross, across, n, offsets,
                            names)[2] == cross
    between = sum(int(np.searchsorted(offsets, a, side="right"))
                  != int(np.searchsorted(offsets, b, side="right"))
                  for _, a, b in breaks)
    assert len(breaks) == 24 and between == 12

    shutil.copytree(tmp_path / "torch", tmp_path / "single")
    post = fusion_post.build_kmer_map
    for which, max_bases in (("torch", cap), ("single", 1 << 31)):
        monkeypatch.setattr(fusion_post, "build_kmer_map", functools.partial(
            post, max_bases=max_bases))
        monkeypatch.chdir(tmp_path / which)
        assert fusion_post.main(["--device", "cpu", "--skip-blast",
                                 "--no-filter-by-annotation", fa]) == 0
    a = tmp_path / "torch" / "tophatfusion_out"
    b = tmp_path / "single" / "tophatfusion_out"
    for f in ("fusion_seq.fa", "potential_fusion.txt", "result.txt"):
        assert (a / f).read_bytes() == (b / f).read_bytes(), f

    def placements(path):
        return {s: set(h.split(",")) for s, h in (
            ln.split("\t") for ln in path.read_text().splitlines())}
    assert placements(a / "fusion_seq.map") == \
        placements(b / "fusion_seq.map")
    assert cs.found_in_result(str(a / "result.txt"), codes, breaks, inside,
                              offsets, names)
