"""Guards of the port: it never imports JAX or the JAX package, it never
falls back to the CPU on its own, the modes ported last (fusion search,
the grouped index) run, a saved index's load swallows only the errors
of a stale file, and a mesh neither hides a shard's error nor outlives
the CLI run that made it."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import tophat_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tophat_tpu_torch.__path__,
                                               "tophat_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "tophat_tpu" or m.startswith("tophat_tpu."))
print(len(names), ",".join(names), bad)
"""


def test_port_imports_neither_jax_nor_tophat_tpu():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    n, names, bad = out.stdout.strip().split(" ", 2)
    assert int(n) >= 25 and bad == "[]", out.stdout
    for mod in ("ops.fusion_fr", "pipeline.fusion_stats", "cli.fusion_post",
                "index.grouped", "pipeline.grouped", "parallel.mesh",
                "parallel.auto", "parallel.shard_fm", "parallel.dist"):
        assert f"tophat_tpu_torch.{mod}" in names.split(","), mod


def _tiny():
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.io.fastq import batch_reads

    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, 2000).astype(np.int8)
    seq = "".join("ACGT"[c] for c in codes[100:150])
    genome = Genome(codes=codes, offsets=np.array([0, 2000]), names=["c"])
    return genome, batch_reads([("r0", seq, b"I" * 50)])


def test_cuda_request_without_cuda_raises(tmp_path, monkeypatch):
    from tophat_tpu_torch.pipeline.params import Params
    from tophat_tpu_torch.pipeline.run import run_pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    genome, batch = _tiny()
    with pytest.raises(RuntimeError, match="is_available"):
        run_pipeline(genome, batch, Params(coverage_search=False),
                     str(tmp_path / "out"), log=lambda *a: None,
                     device="cuda")
    assert not (tmp_path / "out").exists()


def test_cli_defaults_to_cuda_and_raises_without_it(tmp_path, monkeypatch):
    from tophat_tpu_torch.cli.main import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    genome, batch = _tiny()
    fa = tmp_path / "g.fa"
    fa.write_text(">c\n" + "".join("ACGT"[c] for c in genome.codes) + "\n")
    fq = tmp_path / "r.fq"
    fq.write_text("@r0\n" + "".join("ACGT"[c] for c in genome.codes[100:150])
                  + "\n+\n" + "I" * 50 + "\n")
    with pytest.raises(RuntimeError, match="is_available"):
        main(["-o", str(tmp_path / "out"), "--no-coverage-search", str(fa),
              str(fq)])


@pytest.mark.parametrize("mode", ["single", "paired"])
def test_fusion_run_writes_fusions_out(tmp_path, mode):
    """Fusion search is ported: a --fusion-search run on the tiny genome
    completes on the CPU and writes fusions.out (empty: no fusion reads)."""
    from tophat_tpu_torch.pipeline.paired import run_pipeline_paired
    from tophat_tpu_torch.pipeline.params import Params
    from tophat_tpu_torch.pipeline.run import run_pipeline

    genome, batch = _tiny()
    params = Params(coverage_search=False, fusion_search=True)
    out = tmp_path / "out"
    if mode == "single":
        run_pipeline(genome, batch, params, str(out), log=lambda *a: None,
                     device="cpu")
    else:
        run_pipeline_paired(genome, batch, batch, params, str(out),
                            log=lambda *a: None, device="cpu")
    assert (out / "fusions.out").read_text() == ""
    assert "r0" in (out / "accepted_hits.sam").read_text()


def _two_contigs():
    """_tiny's genome cut into two 1,000-base contigs (two groups under a
    1,000-base index cap) and its read."""
    from tophat_tpu_torch.index.fasta import Genome

    genome, batch = _tiny()
    return Genome(codes=genome.codes, offsets=np.array([0, 1000, 2000]),
                  names=["c", "d"]), batch


@pytest.mark.parametrize("flags,item", [
    (["--max-index-bases", "1000"], "grouped index")])
def test_grouped_cli_mode_runs(tmp_path, flags, item):
    """The CLI modes once left unported now run: a genome over
    --max-index-bases maps through the contig groups (paired here)."""
    from tophat_tpu_torch.cli.main import main

    genome, batch = _two_contigs()
    fa = tmp_path / "g.fa"
    fa.write_text("".join(
        f">{name}\n" + "".join("ACGT"[c] for c in genome.codes[a:b]) + "\n"
        for name, a, b in zip(genome.names, genome.offsets,
                              genome.offsets[1:])))
    fq = tmp_path / "r.fq"
    fq.write_text("@r0\n" + "".join("ACGT"[c] for c in genome.codes[100:150])
                  + "\n+\n" + "I" * 50 + "\n")
    out = tmp_path / "out"
    assert main(["-o", str(out), "--device", "cpu"] + flags
                + [str(fa), str(fq), str(fq)]) == 0
    assert "2 contig groups" in (out / "logs" / "tophat.log").read_text()
    assert os.path.exists(str(fa) + ".g1.tt.npz")
    assert "r0" in (out / "accepted_hits.sam").read_text()


@pytest.mark.parametrize("what", ["gfm"])
def test_paired_grouped_mode_runs(tmp_path, what):
    """The paired pipeline, once refusing the grouped index, maps through
    it: a read on the second group's contig lands there."""
    from tophat_tpu_torch.index.grouped import build_grouped_fm
    from tophat_tpu_torch.pipeline.paired import run_pipeline_paired
    from tophat_tpu_torch.pipeline.params import Params

    genome, batch = _two_contigs()
    gfm = build_grouped_fm(genome, max_bases=1000)
    assert gfm.n_groups == 2 and gfm.fms[1].device.type == "cpu"
    run_pipeline_paired(genome, batch, batch, Params(),
                        str(tmp_path / "out"), log=lambda *a: None,
                        device="cpu", gfm=gfm)
    sam = (tmp_path / "out" / "accepted_hits.sam").read_text()
    assert "\tc\t101\t" in sam


def test_grouped_index_load_propagates_device_errors(tmp_path, monkeypatch):
    """Loading a saved group index swallows only the errors of a stale or
    corrupt file: a truncated .g0.tt.npz is rebuilt, and a CUDA error while
    the tables load (here an out-of-memory) reaches the caller instead of
    a silent rebuild."""
    from tophat_tpu_torch.index import grouped
    from tophat_tpu_torch.index.fm import FMIndex

    genome, _ = _two_contigs()
    prefix = str(tmp_path / "g")
    first = grouped.build_grouped_fm(genome, max_bases=1000,
                                     cache_prefix=prefix)
    path = prefix + ".g0.tt.npz"
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[: len(data) // 2])
    msgs = []
    again = grouped.build_grouped_fm(genome, max_bases=1000,
                                     cache_prefix=prefix, log=msgs.append)
    assert sum("reusing" in m for m in msgs) == 1, msgs
    assert torch.equal(again.fms[0].sa, first.fms[0].sa)
    assert FMIndex.load(path, device="cpu").n == 1000

    def oom(path, device="cuda"):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(FMIndex, "load", staticmethod(oom))
    built = []
    monkeypatch.setattr(grouped, "build_fm_index",
                        lambda *a, **k: built.append(1))
    with pytest.raises(torch.cuda.OutOfMemoryError):
        grouped.build_grouped_fm(genome, max_bases=1000, cache_prefix=prefix)
    assert not built


def test_transcriptome_index_load_propagates_device_errors(tmp_path,
                                                         monkeypatch):
    """Loading a saved transcriptome index swallows only the errors of a
    stale or corrupt file: a CUDA error while the tables upload (here an
    out-of-memory) reaches the caller instead of a silent rebuild."""
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.index.fm import FMIndex
    from tophat_tpu_torch.io.gtf import Transcript
    from tophat_tpu_torch.pipeline import transcriptome

    genome, _ = _tiny()
    trs = {"t": Transcript("t", "c", "+", [(100, 300), (700, 900)])}
    prefix = str(tmp_path / "genes")
    transcriptome.build_transcriptome_index(genome, trs, prefix=prefix,
                                            device="cpu")

    def oom(path, device="cuda"):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(FMIndex, "load", staticmethod(oom))
    built = []
    monkeypatch.setattr(transcriptome, "build_fm_index",
                        lambda *a, **k: built.append(1))
    with pytest.raises(torch.cuda.OutOfMemoryError):
        transcriptome.build_transcriptome_index(genome, trs, prefix=prefix,
                                                device="cpu")
    assert not built


def test_realign_wrapper_takes_plain_only_for_cpu_tensors(monkeypatch):
    """On the CPU the wrapper runs the plain version and counts no launch;
    a CUDA-typed request never reaches the plain version."""
    from tophat_tpu_torch.ops import realign_kernel as rk
    from tophat_tpu_torch.utils import trace

    reads = torch.full((4, 10), 1, dtype=torch.int8)
    lengths = torch.full((4,), 10, dtype=torch.int32)
    flank = torch.full((3, 10), 1, dtype=torch.int8)
    launches = lambda: trace.snapshot()["counters"].get("realign.launches", 0)
    before = launches()
    bt, mm, ok = rk.realign_group(reads, lengths, flank, flank, 0, 2)
    assert launches() == before
    assert ok.all() and (mm == 0).all() and (bt == 1).all()
    monkeypatch.setattr(rk, "realign_plain", None)
    with pytest.raises(ValueError, match="CUDA"):
        rk.realign_group(reads.to("meta"), lengths.to("meta"),
                         flank.to("meta"), flank.to("meta"), 0, 2)


def test_port_builds_only_its_own_sources():
    """Every C/C++/CUDA source the port compiles lies under
    tophat_tpu_torch/, and no module of the port builds a path into the
    JAX package's directory."""
    import re

    from tophat_tpu_torch import native
    from tophat_tpu_torch.ops import realign_kernel

    port = os.path.join(REPO, "tophat_tpu_torch") + os.sep
    srcs = [realign_kernel._SRC] + [
        os.path.join(native._SRC_DIR, f"{n}.cpp")
        for n in ("sais", "bgzf", "bamenc")]
    for src in srcs:
        assert os.path.realpath(src).startswith(port), src
        assert os.path.exists(src), src
    component = re.compile(r"[\"']tophat_tpu[\"'/]")
    for root, _, files in os.walk(port):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    assert not component.search(fh.read()), f


@pytest.mark.parametrize("entry", ["from_numpy", "load", "build_fm_index"])
def test_index_entry_points_default_to_cuda(tmp_path, monkeypatch, entry):
    """FMIndex.from_numpy, FMIndex.load and build_fm_index place the index
    on the card unless given device="cpu"; without CUDA they raise."""
    from tophat_tpu_torch.index.fm import FMIndex, build_fm_index

    codes = np.random.default_rng(1).integers(0, 4, 500).astype(np.int8)
    fm = build_fm_index(codes, device="cpu")
    path = str(tmp_path / "idx.npz")
    fm.save(path)
    call = {"from_numpy": lambda **k: FMIndex.from_numpy(fm, **k),
            "load": lambda **k: FMIndex.load(path, **k),
            "build_fm_index": lambda **k: build_fm_index(codes, **k)}[entry]
    assert call(device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        call()
    with pytest.raises(RuntimeError, match="is_available"):
        call(device="cuda")


def test_auto_activate_cuda_without_cuda_raises(monkeypatch):
    from tophat_tpu_torch.parallel import auto

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        auto.auto_activate("cuda")
    assert auto.active() is None
    auto.auto_activate("cpu")                 # one CPU device: no mesh
    assert auto.active() is None


def test_shard_error_propagates(monkeypatch):
    """An error in one row shard reaches align_reads' caller: no shard is
    rerun on one device, and the mesh's other shards do not mask it."""
    from tophat_tpu_torch.ops import align
    from tophat_tpu_torch.parallel import auto
    from tophat_tpu_torch.parallel.mesh import make_mesh

    genome, batch = _tiny()
    from tophat_tpu_torch.index.fm import build_fm_index

    fm = build_fm_index(genome, device="cpu")
    rf, rr, lens = align.pad_reads([genome.codes[100 + i:150 + i]
                                    for i in range(10)])
    core = align._align_batch_core
    calls = []

    def failing(fm, reads_f, *a, **k):
        calls.append(reads_f.shape[0])
        if len(calls) == 3:
            raise RuntimeError("shard 2 failed")
        return core(fm, reads_f, *a, **k)

    monkeypatch.setattr(align, "_align_batch_core", failing)
    auto.activate(make_mesh(4, 1, [torch.device("cpu")] * 4))
    try:
        with pytest.raises(RuntimeError, match="shard 2 failed"):
            align.align_reads(fm, rf, rr, lens, genome.offsets)
    finally:
        auto.deactivate()
    assert calls == [3, 3, 3]


@pytest.mark.parametrize("outcome", ["returns", "raises"])
def test_cli_leaves_no_mesh_active(tmp_path, monkeypatch, outcome):
    from tophat_tpu_torch.cli import main as cli
    from tophat_tpu_torch.parallel import auto, mesh

    genome, _ = _tiny()
    fa = tmp_path / "g.fa"
    fa.write_text(">c\n" + "".join("ACGT"[c] for c in genome.codes) + "\n")
    fq = tmp_path / "r.fq"
    fq.write_text("@r0\n" + "".join("ACGT"[c] for c in genome.codes[100:150])
                  + "\n+\n" + "I" * 50 + "\n")
    monkeypatch.setattr(mesh, "visible_devices",
                        lambda d: [torch.device("cpu")] * 2)
    seen = []
    real = cli.run_pipeline_streaming

    def run(*a, **k):
        seen.append(auto.n_row_shards())
        if outcome == "raises":
            raise RuntimeError("mapping failed")
        return real(*a, **k)

    monkeypatch.setattr(cli, "run_pipeline_streaming", run)
    argv = ["-o", str(tmp_path / "out"), "--device", "cpu",
            "--no-coverage-search", str(fa), str(fq)]
    if outcome == "raises":
        with pytest.raises(RuntimeError, match="mapping failed"):
            cli.main(argv)
    else:
        assert cli.main(argv) == 0
        assert "r0" in (tmp_path / "out" / "accepted_hits.sam").read_text()
    assert seen == [2] and auto.active() is None


def test_fusion_post_group_load_propagates_device_errors(tmp_path,
                                                         monkeypatch):
    """Fusion-post's kmer map over contig groups loads the CLI's group
    caches beside the FASTA with the same guard: a CUDA error while the
    tables load (here an out-of-memory) reaches the caller instead of a
    silent rebuild."""
    from test_torch_fusion_post import _fusions_out
    from tophat_tpu_torch.cli import fusion_post
    from tophat_tpu_torch.index import grouped
    from tophat_tpu_torch.index.fm import FMIndex

    genome, _ = _two_contigs()
    fa = tmp_path / "g.fa"
    fa.write_text("".join(
        f">{name}\n" + "".join("ACGT"[c] for c in genome.codes[a:b]) + "\n"
        for name, a, b in zip(genome.names, genome.offsets,
                              genome.offsets[1:])))
    seq = "".join("ACGT"[c] for c in genome.codes[1500:1546])
    _fusions_out(str(tmp_path / "tophat_s" / "fusions.out"),
                 [seq[:23], seq[23:]])
    kmap = fusion_post.build_kmer_map(genome, ["s"], str(tmp_path),
                                      cwd=str(tmp_path), device="cpu",
                                      genome_path=str(fa), max_bases=1000)
    assert kmap[seq[:23]] == [("d", 500)]
    assert os.path.exists(f"{fa}.g1.tt.npz")

    def oom(path, device="cuda"):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(FMIndex, "load", staticmethod(oom))
    built = []
    monkeypatch.setattr(grouped, "build_fm_index",
                        lambda *a, **k: built.append(1))
    with pytest.raises(torch.cuda.OutOfMemoryError):
        fusion_post.build_kmer_map(genome, ["s"], str(tmp_path),
                                   cwd=str(tmp_path), device="cpu",
                                   genome_path=str(fa), max_bases=1000)
    assert not built
