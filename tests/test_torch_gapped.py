"""Bowtie2-mode parity: the port's gapped_scan returns the JAX scan's six
outputs exactly, and --b2 runs (library and CLI) write accepted_hits.sam
and the three BED tracks byte-identical to the JAX package's, on fixtures
whose indel only the direct gapped aligner can find."""

import numpy as np
import pytest

OUTPUTS = ("accepted_hits.sam", "junctions.bed", "insertions.bed",
           "deletions.bed")


def _scan_inputs(seed=3, B=16, C=8, L=40, n=6000):
    """A 6,000-base genome with an N run; rows planted at candidate anchors
    with a 1-2 bp deletion or insertion (some with a mismatch or an N),
    random rows, short rows; candidates past both genome ends, duplicated
    and invalid lanes; a per-row penalty floor."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, n).astype(np.int8)
    genome[3000:3012] = 4
    reads = np.full((B, L), -1, np.int8)
    lengths = np.full(B, L, np.int32)
    cand = rng.integers(-3, n - L + 3, (B, C)).astype(np.int32)
    for b in range(B):
        s = int(rng.integers(100, n - 200)) if b != 5 else 2990
        gap = (1, 2, -1, -2, 0)[b % 5]
        t = int(rng.integers(5, L - 5))
        if gap >= 0:
            seq = np.concatenate([genome[s:s + t],
                                  genome[s + t + gap:s + L + gap]])
        else:
            seq = np.concatenate([genome[s:s + t],
                                  rng.integers(0, 4, -gap).astype(np.int8),
                                  genome[s + t:s + L + gap]])
        if b % 3 == 1:
            seq[int(rng.integers(0, L))] ^= 1
        if b % 7 == 2:
            seq[int(rng.integers(0, L))] = 4
        if b == 11:
            seq = rng.integers(0, 4, L).astype(np.int8)
        reads[b] = seq[:L]
        if b % 4 == 3:
            lengths[b] = int(rng.integers(20, L))
            reads[b, lengths[b]:] = -1
        cand[b, 0] = s + int(rng.integers(-2, 3))
        cand[b, 1] = s
    cand[0, 2], cand[1, 2] = n - 5, -8                  # off both ends
    cand[2, 3] = cand[2, 1]                             # duplicated lane
    cand_valid = rng.random((B, C)) < 0.8
    cand_valid[:, :2] = True
    floor = np.where(np.arange(B) % 6 == 0, 8, 14).astype(np.int32)
    return genome, reads, lengths, cand, cand_valid, floor


def test_gapped_scan_matches_jax():
    import jax.numpy as jnp
    import torch

    from tophat_tpu.ops.gapped import gapped_scan as jscan
    from tophat_tpu_torch.ops.gapped import gapped_scan

    args = _scan_inputs()
    want = [np.asarray(x) for x in jscan(*(jnp.asarray(a) for a in args),
                                         max_gap=2)]
    got = [x.numpy() for x in gapped_scan(*(torch.as_tensor(a)
                                            for a in args), max_gap=2)]
    names = ("pos", "t", "gap", "mm", "pen", "ok")
    for name, w, g in zip(names, want, got):
        np.testing.assert_array_equal(g, w, err_msg=name)
    ok = want[5]
    assert ok.sum() >= 16 and (want[2][ok] > 0).any() \
        and (want[2][ok] < 0).any()


def _fixture(rng, indel):
    """40-bp reads over a 6,000-base genome, split 20 + 20 at segment
    length 20, with the indel 10 bp into the SECOND segment: only the
    direct gapped aligner recovers it (tests/test_bowtie2.py's fixture)."""
    n = 6000
    codes = rng.integers(0, 4, n).astype(np.int8)
    recs = []
    for i in range(4):
        s = 1000 + 97 * i
        if indel > 0:
            seq = np.concatenate([codes[s:s + 30],
                                  codes[s + 30 + indel:s + 40 + indel]])
        else:
            ins = rng.integers(0, 4, -indel).astype(np.int8)
            seq = np.concatenate([codes[s:s + 30], ins,
                                  codes[s + 30:s + 40 + indel]])
        recs.append((f"r{i}", "".join("ACGT"[c] for c in seq), b"I" * 40))
    return codes, recs


def _run_both(tmp_path, codes, recs, kw):
    from tophat_tpu.index.fasta import Genome as JGenome
    from tophat_tpu.io.fastq import batch_reads as jbatch
    from tophat_tpu.pipeline.params import Params as JParams
    from tophat_tpu.pipeline.run import run_pipeline as jrun
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.io.fastq import batch_reads
    from tophat_tpu_torch.pipeline.params import Params
    from tophat_tpu_torch.pipeline.run import run_pipeline

    offsets = np.array([0, len(codes)])
    kw = dict(segment_length=20, coverage_search=False, bowtie2=True, **kw)
    jrun(JGenome(codes=codes, offsets=offsets, names=["chrT"]), jbatch(recs),
         JParams(**kw), str(tmp_path / "jax"), log=lambda *a: None)
    out = run_pipeline(Genome(codes=codes, offsets=offsets, names=["chrT"]),
                       batch_reads(recs), Params(**kw),
                       str(tmp_path / "torch"), log=lambda *a: None,
                       device="cpu")
    for f in OUTPUTS:
        assert (tmp_path / "jax" / f).read_bytes() == \
            (tmp_path / "torch" / f).read_bytes(), f
    return out, (tmp_path / "torch" / "accepted_hits.sam").read_text()


@pytest.mark.parametrize("indel,kw,n_aligned", [
    (2, {}, 4), (-2, {}, 4), (2, {"read_edit_dist": 0}, 0),
    (1, {"read_gap_length": 3, "b2_rdg": "20,10"}, 0),
    (1, {"read_gap_length": 3, "b2_score_min": "L,0,-0.2"}, 4)])
def test_b2_indel_fixtures_identical(tmp_path, indel, kw, n_aligned):
    """Deletions and insertions, and the score model's knobs (--read-edit-
    dist, --b2-rdg, --b2-score-min) that admit or refuse them."""
    codes, recs = _fixture(np.random.default_rng(7), indel)
    out, sam = _run_both(tmp_path, codes, recs, kw)
    assert sum(len(v) for v in out["selected"].values()) == n_aligned
    if n_aligned:
        assert f"{abs(indel)}{'D' if indel > 0 else 'I'}" in sam


def test_b2_multihit_identical(tmp_path):
    """A gapped read whose placement exists at two genome copies reports
    both (NH:i:2), the bowtie2 -k contract."""
    rng = np.random.default_rng(13)
    codes = rng.integers(0, 4, 8000).astype(np.int8)
    unit = rng.integers(0, 4, 60).astype(np.int8)
    codes[1000:1060] = unit
    codes[5000:5060] = unit
    seq = np.concatenate([unit[:30], unit[32:42]])
    recs = [("m0", "".join("ACGT"[c] for c in seq), b"I" * 40)]
    out, sam = _run_both(tmp_path, codes, recs, {})
    assert sorted(c.pos for c in out["selected"][0]) == [1000, 5000]
    assert sam.count("NH:i:2") == 2


def test_b2_cli_identical(tmp_path, monkeypatch):
    """--b2 through both CLIs, single-end and paired-end, on a two-contig
    genome with planted introns, indels and contiguous reads."""
    from test_torch_paired import _pairs, _compare
    from tophat_tpu.cli.main import main as jax_main
    from tophat_tpu_torch.cli.main import main as torch_main

    monkeypatch.setenv("TOPHAT_TPU_DEVICES", "1")   # one device, as the port
    n = 30000
    codes, r1, r2 = _pairs(n, seed=4)
    seq = "".join("ACGTN"[c] for c in codes)
    fa = tmp_path / "g.fa"
    fa.write_text(f">chrA\n{seq[:17000]}\n>chrB\n{seq[17000:]}\n")
    rng = np.random.default_rng(4)
    for k in range(6):                 # 1-2 bp indels 30-45 bp into mate 1
        s = int(rng.integers(1000, 16000)) + 17000 * (k % 2)
        t, d = int(rng.integers(30, 46)), 1 + k % 2
        if k < 3:
            s1 = np.concatenate([codes[s:s + t], codes[s + t + d:s + 76 + d]])
        else:
            s1 = np.concatenate([codes[s:s + t],
                                 rng.integers(0, 4, d).astype(np.int8),
                                 codes[s + t:s + 76 - d]])
        s2 = np.where(codes[s + 150:s + 226] < 4,
                      3 - codes[s + 150:s + 226], 4)[::-1]
        r1.append((f"i{k}", "".join("ACGTN"[c] for c in s1), b"I" * 76))
        r2.append((f"i{k}", "".join("ACGTN"[c] for c in s2), b"I" * 76))
    fqs = []
    for i, recs in enumerate((r1, r2)):
        fq = tmp_path / f"r{i + 1}.fq"
        fq.write_text("".join(f"@{nm}/{i + 1}\n{s}\n+\n{q.decode()}\n"
                              for nm, s, q in recs))
        fqs.append(str(fq))
    for tag, reads in (("single", fqs[:1]), ("paired", fqs)):
        args = ["--b2", "--no-coverage-search", str(fa)] + reads
        assert jax_main(["-o", str(tmp_path / f"jax_{tag}")] + args) == 0
        assert torch_main(["-o", str(tmp_path / f"torch_{tag}"),
                           "--device", "cpu"] + args) == 0
    for f in OUTPUTS:
        assert (tmp_path / "jax_single" / f).read_bytes() == \
            (tmp_path / "torch_single" / f).read_bytes(), f
    recs = _compare(tmp_path / "jax_paired", tmp_path / "torch_paired")
    assert sum(1 for t in recs if "N" in t[5]) >= 16
    assert any("I" in t[5] or "D" in t[5] for t in recs)
