"""Guards of the port: it never imports JAX or the JAX package, it never
falls back to the CPU on its own, unported modes refuse to run, and
fusion search (ported) runs."""

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
    for mod in ("ops.fusion_fr", "pipeline.fusion_stats", "cli.fusion_post"):
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


@pytest.mark.parametrize("flags,item", [
    (["--max-index-bases", "1000"], "grouped index")])
def test_unported_cli_modes_raise(tmp_path, flags, item):
    from tophat_tpu_torch.cli.main import main

    genome, _ = _tiny()
    fa = tmp_path / "g.fa"
    fa.write_text(">c\n" + "".join("ACGT"[c] for c in genome.codes) + "\n")
    fq = tmp_path / "r.fq"
    fq.write_text("@r0\n" + "ACGT" * 10 + "\n+\n" + "I" * 40 + "\n")
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
        main(["-o", str(tmp_path / "out"), "--device", "cpu"] + flags
             + [str(fa), str(fq), str(fq)])


@pytest.mark.parametrize("what", ["gfm"])
def test_paired_unported_modes_raise(tmp_path, what):
    """The paired pipeline refuses the grouped index, naming its ROADMAP
    item, before it maps anything."""
    from tophat_tpu_torch.pipeline.paired import run_pipeline_paired
    from tophat_tpu_torch.pipeline.params import Params

    genome, batch = _tiny()
    with pytest.raises(NotImplementedError, match="ROADMAP.*grouped index"):
        run_pipeline_paired(genome, batch, batch, Params(),
                            str(tmp_path / "out"), log=lambda *a: None,
                            device="cpu", gfm=object())
    assert not (tmp_path / "out").exists()


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

    reads = torch.full((4, 10), 1, dtype=torch.int8)
    lengths = torch.full((4,), 10, dtype=torch.int32)
    flank = torch.full((3, 10), 1, dtype=torch.int8)
    before = rk.realign_group.launches
    bt, mm, ok = rk.realign_group(reads, lengths, flank, flank, 0, 2)
    assert rk.realign_group.launches == before
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
