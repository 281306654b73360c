"""Mesh parity, CLI level: the port's CLI on an 8-shard virtual CPU mesh
(parallel/mesh.visible_devices replaced, as chip_smoke.py does on the
card) writes the files of its own one-device run and of the JAX package's
CLI on its 8 virtual devices (TOPHAT_TPU_DEVICES=8), byte for byte:
paired default mode, single-end over the range-sharded index
(TOPHAT_TPU_GENOME_SHARDS=2) and a grouped run (--max-index-bases)."""

import torch

from test_torch_grouped import MAX_BASES, write_fixture
from test_torch_paired import _pairs

FILES = ("accepted_hits.sam", "junctions.bed", "insertions.bed",
         "deletions.bed", "align_summary.txt")


def _write_pairs(tmp_path, n=30000, seed=8):
    codes, r1, r2 = _pairs(n, seed=seed)
    seq = "".join("ACGTN"[c] for c in codes)
    fa = tmp_path / "g.fa"
    fa.write_text(f">chrA\n{seq[:17000]}\n>chrB\n{seq[17000:]}\n")
    fqs = []
    for i, recs in enumerate((r1, r2)):
        fq = tmp_path / f"r{i + 1}.fq"
        fq.write_text("".join(f"@{nm}/{i + 1}\n{s}\n+\n{q.decode()}\n"
                              for nm, s, q in recs))
        fqs.append(str(fq))
    return str(fa), fqs


def _three_runs(tmp_path, monkeypatch, argv, env=(), jax_env=()):
    """JAX's CLI on 8 devices, the port's on one device and on 8 virtual
    CPU shards, with `env` set for the two mesh runs (and `jax_env` for
    JAX's alone); returns the port's mesh-run log."""
    from tophat_tpu.cli.main import main as jax_main
    from tophat_tpu_torch.cli.main import main as torch_main
    from tophat_tpu_torch.parallel import auto, mesh

    assert torch_main(["-o", str(tmp_path / "one"), "--device", "cpu"]
                      + argv) == 0
    for k, v in env:
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("TOPHAT_TPU_DEVICES", "8")
    with monkeypatch.context() as m:
        for k, v in jax_env:
            m.setenv(k, v)
        assert jax_main(["-o", str(tmp_path / "jax")] + argv) == 0
    monkeypatch.setattr(mesh, "visible_devices",
                        lambda device: [torch.device(device)] * 8)
    assert torch_main(["-o", str(tmp_path / "mesh"), "--device", "cpu"]
                      + argv) == 0
    assert auto.active() is None and not auto.genome_sharded()
    for f in FILES:
        one = (tmp_path / "one" / f).read_bytes()
        assert (tmp_path / "mesh" / f).read_bytes() == one, f
        assert (tmp_path / "jax" / f).read_bytes() == one, f
    return (tmp_path / "mesh" / "logs" / "tophat.log").read_text()


def test_paired_default_mode_on_mesh(tmp_path, monkeypatch):
    """Paired, coverage search on, two contigs, chunk pairs of 40."""
    fa, fqs = _write_pairs(tmp_path)
    log = _three_runs(tmp_path, monkeypatch,
                      ["--batch-size", "40", fa] + fqs)
    assert "sharding read batches over 8 devices" in log
    sam = (tmp_path / "mesh" / "accepted_hits.sam").read_text()
    assert sum("N" in ln.split("\t")[5] for ln in sam.splitlines()) >= 16


def test_single_end_range_sharded_index(tmp_path, monkeypatch):
    """Single-end with the index range-sharded over 2 genome shards (a
    4 x 2 mesh); coverage search off."""
    fa, fqs = _write_pairs(tmp_path, seed=12)
    log = _three_runs(tmp_path, monkeypatch,
                      ["--no-coverage-search", fa, fqs[0]],
                      env=[("TOPHAT_TPU_GENOME_SHARDS", "2")])
    assert "index range-sharded over 2 devices" in log
    assert "reads axis 4" in log


def test_single_end_genome_axis_from_budget(tmp_path, monkeypatch):
    """The genome axis picked by the per-device budget, not forced: with
    the budget at 3/4 of the index's bytes, configure_genome_axis takes
    the smallest shard count whose sub-indexes fit (2, a 4 x 2 mesh). The
    files equal the one-device run's and JAX's on a forced 2-shard
    genome axis."""
    from tophat_tpu_torch.index.fasta import read_fasta
    from tophat_tpu_torch.index.fm import build_fm_index
    from tophat_tpu_torch.parallel import auto

    fa, fqs = _write_pairs(tmp_path, seed=12)
    nbytes = build_fm_index(read_fasta(fa), device="cpu").nbytes
    monkeypatch.setattr(auto, "device_budget",
                        lambda devices: nbytes * 3 // 4)
    log = _three_runs(tmp_path, monkeypatch,
                      ["--no-coverage-search", fa, fqs[0]],
                      jax_env=[("TOPHAT_TPU_GENOME_SHARDS", "2")])
    assert "index range-sharded over 2 devices" in log
    assert "reads axis 4" in log


def test_grouped_run_on_mesh(tmp_path, monkeypatch):
    """Paired default mode through two contig groups (--max-index-bases),
    each group's index replicated over the mesh."""
    fa, fq1, fq2, _ = write_fixture(tmp_path)
    log = _three_runs(tmp_path, monkeypatch,
                      ["--max-index-bases", str(MAX_BASES), fa, fq1, fq2])
    assert "2 contig groups" in log
    bed = (tmp_path / "mesh" / "junctions.bed").read_text()
    assert "chr0" in bed and "chr2" in bed
