"""End-to-end parity: the port's run_pipeline and CLI write
accepted_hits.sam, junctions.bed, insertions.bed and deletions.bed
byte-identical to the JAX package's, on a small genome (pigeonhole
segment engine) and on one just above BEAM_MIN_N (half-split engine)."""

import numpy as np
import pytest

OUTPUTS = ("accepted_hits.sam", "junctions.bed", "insertions.bed",
           "deletions.bed")


def _workload(n, seed=5, read_lens=(50, 76, 76, 100), n_introns=12,
              n_plain=40):
    """Genome with an N run and n_introns planted GT-AG introns; reads of
    the given lengths (by default 50, 76 or 100 bp) across the introns (3
    each, some with a mismatch), across 2-bp deletions and insertions,
    n_plain contiguous reads with a mismatch, and one read over the N
    run. Reads over 2,000 bp keep their pieces inside the genome."""
    rng = np.random.default_rng(seed)
    lens = iter(rng.choice(read_lens, 200))
    longest = max(read_lens)
    codes = rng.integers(0, 4, n).astype(np.int8)
    codes[n // 3:n // 3 + 20] = 4
    seqs = []
    for k in range(n_introns):
        a = int(rng.integers(max(2000, longest),
                             n - max(3000, longest + 800)))
        il = int(rng.integers(100, 800))
        codes[a:a + 2] = [2, 3]
        codes[a + il - 2:a + il] = [0, 2]
        for rep in range(3):
            L = int(next(lens))
            t = int(rng.integers(20, L - 20))
            seq = np.concatenate([codes[a - t:a],
                                  codes[a + il:a + il + L - t]])
            if rep == 1:
                p = int(rng.integers(0, L))
                seq[p] = (seq[p] + 1) % 4
            seqs.append(seq)
    for k in range(4):
        L = int(next(lens))
        s = int(rng.integers(1000, n - max(1000, longest + 2)))
        t = int(rng.integers(20, L - 20))
        seqs.append(np.concatenate([codes[s:s + t],
                                    codes[s + t + 2:s + L + 2]]))
        seqs.append(np.concatenate([codes[s:s + t], np.array([1, 2], np.int8),
                                    codes[s + t:s + L - 2]]))
    for k in range(n_plain):
        L = int(next(lens))
        s = int(rng.integers(0, n - L))
        seq = codes[s:s + L].copy()
        p = int(rng.integers(0, L))
        seq[p] = (seq[p] + 1) % 4
        seqs.append(seq)
    seqs.append(codes[n // 3 - 30:n // 3 + 46].copy())
    recs = [(f"r{i}", "".join("ACGTN"[c] for c in s), b"I" * len(s))
            for i, s in enumerate(seqs)]
    return codes, recs


def _compare(dir_a, dir_b):
    for f in OUTPUTS:
        a = (dir_a / f).read_bytes()
        b = (dir_b / f).read_bytes()
        assert a == b, f"{f} differs"
    return (dir_a / "accepted_hits.sam").read_text()


@pytest.mark.parametrize("n", [30000, (1 << 21) + 4096])
def test_run_pipeline_outputs_identical(tmp_path, n):
    _run_pipeline_both(tmp_path, n)


def test_run_pipeline_outputs_identical_without_native(tmp_path,
                                                       monkeypatch):
    """The port's record emitter without its native library (the Python
    fallback) writes the same bytes."""
    from tophat_tpu_torch import native

    monkeypatch.setattr(native.bamenc, "_lib", None)
    monkeypatch.setattr(native.bamenc, "_failed", True)
    _run_pipeline_both(tmp_path, 30000)


def _run_pipeline_both(tmp_path, n):
    from tophat_tpu.index.fasta import Genome as JGenome
    from tophat_tpu.io.fastq import batch_reads as jbatch
    from tophat_tpu.pipeline.params import Params as JParams
    from tophat_tpu.pipeline.run import run_pipeline as jrun
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.io.fastq import batch_reads
    from tophat_tpu_torch.pipeline import segment
    from tophat_tpu_torch.pipeline.params import Params
    from tophat_tpu_torch.pipeline.run import run_pipeline

    codes, recs = _workload(n)
    offsets = np.array([0, n])
    jrun(JGenome(codes=codes, offsets=offsets, names=["chrA"]),
         jbatch(recs), JParams(coverage_search=False), str(tmp_path / "jax"),
         log=lambda *a: None)
    run_pipeline(Genome(codes=codes, offsets=offsets, names=["chrA"]),
                 batch_reads(recs), Params(coverage_search=False),
                 str(tmp_path / "torch"), log=lambda *a: None, device="cpu")
    sam = _compare(tmp_path / "jax", tmp_path / "torch")
    spliced = sum(1 for ln in sam.splitlines()
                  if not ln.startswith("@") and "N" in ln.split("\t")[5])
    assert spliced >= 24
    assert (n >= segment.BEAM_MIN_N) == (n > 1 << 21)


@pytest.mark.parametrize("read_lens,coverage_search", [
    ((150,), True), ((300,), True), ((260, 300), False), ((4200,), False)],
    ids=["150", "300", "260-300", "4200"])
def test_run_pipeline_long_reads_identical(tmp_path, read_lens,
                                           coverage_search):
    """Reads of 150 or 300 bp in TopHat's default mode, of 260 and 300
    bp in one batch without the coverage search (realign rows 300
    positions wide, some ending at 260), and of 4,200 bp without it (rows
    past the 4,096 positions the kernel's argmin once packed; fewer reads,
    as the CPU's realign work grows as L^2): rows wider than 256 positions
    take the realign kernel's shift-code operands on the card; on the CPU
    both packages must still agree byte for byte."""
    from tophat_tpu.index.fasta import Genome as JGenome
    from tophat_tpu.io.fastq import batch_reads as jbatch
    from tophat_tpu.pipeline.params import Params as JParams
    from tophat_tpu.pipeline.run import run_pipeline as jrun
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.io.fastq import batch_reads
    from tophat_tpu_torch.pipeline.params import Params
    from tophat_tpu_torch.pipeline.run import run_pipeline

    n = 30000
    n_introns = 12 if max(read_lens) <= 300 else 4
    codes, recs = _workload(n, seed=13, read_lens=read_lens,
                            n_introns=n_introns,
                            n_plain=40 if max(read_lens) <= 300 else 8)
    offsets = np.array([0, n])
    jrun(JGenome(codes=codes, offsets=offsets, names=["chrL"]),
         jbatch(recs), JParams(coverage_search=coverage_search),
         str(tmp_path / "jax"), log=lambda *a: None)
    run_pipeline(Genome(codes=codes, offsets=offsets, names=["chrL"]),
                 batch_reads(recs), Params(coverage_search=coverage_search),
                 str(tmp_path / "torch"), log=lambda *a: None, device="cpu")
    sam = _compare(tmp_path / "jax", tmp_path / "torch")
    rows = [ln.split("\t") for ln in sam.splitlines()
            if not ln.startswith("@")]
    assert sum(1 for t in rows if "N" in t[5]) >= 2 * n_introns
    assert {len(t[9]) for t in rows} == set(read_lens)


def test_cli_outputs_identical(tmp_path, monkeypatch):
    """Two contigs, reads streamed in three chunks (global event union)."""
    from tophat_tpu.cli.main import main as jax_main
    from tophat_tpu_torch.cli.main import main as torch_main

    monkeypatch.setenv("TOPHAT_TPU_DEVICES", "1")   # one device, as the port
    n = 30000
    codes, recs = _workload(n, seed=9)
    seq = "".join("ACGTN"[c] for c in codes)
    fa = tmp_path / "g.fa"
    fa.write_text(f">chrA\n{seq[:17000]}\n>chrB\n{seq[17000:]}\n")
    fq = tmp_path / "r.fq"
    fq.write_text("".join(f"@{nm}\n{s}\n+\n{q.decode()}\n"
                          for nm, s, q in recs))
    args = ["--no-coverage-search", "--batch-size", "40", str(fa), str(fq)]
    assert jax_main(["-o", str(tmp_path / "jax")] + args) == 0
    assert torch_main(["-o", str(tmp_path / "torch"), "--device", "cpu",
                       "--tt-index", str(tmp_path / "idx")] + args) == 0
    _compare(tmp_path / "jax", tmp_path / "torch")
    # a second run reuses the saved index and writes the same files
    assert torch_main(["-o", str(tmp_path / "again"), "--device", "cpu",
                       "--tt-index", str(tmp_path / "idx")] + args) == 0
    _compare(tmp_path / "jax", tmp_path / "again")


def _resume_roundtrip(tmp_path, flags):
    """Run the CLI with --keep-tmp, drop an output and the journal's
    alldone line, resume with -R; returns the resumed run's log text."""
    import os

    from tophat_tpu_torch.cli.main import main

    codes, recs = _workload(30000, seed=11)
    fa = tmp_path / "g.fa"
    fa.write_text(">chrR\n" + "".join("ACGTN"[c] for c in codes) + "\n")
    fq = tmp_path / "r.fq"
    fq.write_text("".join(f"@{nm}\n{s}\n+\n{q.decode()}\n"
                          for nm, s, q in recs))
    out = tmp_path / "out"
    assert main(["-o", str(out), "--device", "cpu", "--keep-tmp"] + flags
                + ["--batch-size", "40", str(fa), str(fq)]) == 0
    first = {f: (out / f).read_bytes() for f in OUTPUTS}
    assert len([f for f in os.listdir(out / "tmp")
                if f.endswith(".pkl")]) >= 2
    # an interrupted run: outputs gone, the journal lacks alldone
    (out / "accepted_hits.sam").unlink()
    run_log = out / "logs" / "run.log"
    run_log.write_text("".join(ln for ln in run_log.read_text().splitlines(
        keepends=True) if not ln.startswith("#>alldone")))
    (out / "logs" / "tophat.log").write_text("")
    assert main(["-R", str(out)]) == 0
    log_text = (out / "logs" / "tophat.log").read_text()
    assert "reusing mapped tables" in log_text
    assert "Building FM index" not in log_text
    assert {f: (out / f).read_bytes() for f in OUTPUTS} == first
    return log_text


def test_cli_resume_reuses_mapped_chunks(tmp_path):
    """-R on an interrupted run reloads the per-chunk mapped tables, never
    rebuilds the index, and writes the same files."""
    _resume_roundtrip(tmp_path, ["--no-coverage-search"])


@pytest.mark.parametrize("flags", [[], ["--butterfly-search",
                                        "--microexon-search"],
                                   ["--fusion-search"]])
def test_cli_resume_keeps_search_tables(tmp_path, flags):
    """With the coverage search on (the default), with the butterfly and
    microexon searches, and with fusion search, the search tables persist
    with each chunk: a resumed run writes the same files without searching
    again (fusion search then runs on the reloaded host tables)."""
    _resume_roundtrip(tmp_path, flags)
