"""Paired-end parity: the port's run_pipeline_paired,
run_pipeline_paired_streaming and paired CLI write every output file
(accepted_hits.sam/.bam, unmapped.bam, the three BEDs, align_summary.txt,
prep_reads.info) byte-identical to the JAX package's, with the coverage
search on (TopHat's default)."""

import numpy as np
import pytest

OUTPUTS = ("accepted_hits.sam", "accepted_hits.bam", "unmapped.bam",
           "junctions.bed", "insertions.bed", "deletions.bed",
           "align_summary.txt", "prep_reads.info")


def _revcomp(s):
    return np.where(s < 4, 3 - s, s)[::-1].astype(np.int8)


def _pairs(n, seed=21, L=76):
    """Genome with planted GT-AG introns and an N run; mate pairs with an
    inner distance drawn from N(50, 20) clipped at 0, mate 2 the reverse
    complement downstream of mate 1:
      spliced mate 1 (anchors >= 20 bp), some with a mismatch;
      mate 1 with a short 3' anchor (8-11 bp: the pair-only rescue case);
      contiguous pairs with one mismatch in each mate;
      discordant pairs (same strand; far apart); half-mapped pairs (mate 2
      random); one pair with both mates random."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.int8)
    codes[n // 3:n // 3 + 20] = 4
    m1, m2 = [], []

    def mate2(start):
        return _revcomp(codes[start:start + L])

    def inner():
        return max(0, int(round(rng.normal(50, 20))))

    for k in range(8):
        a = int(rng.integers(2000, n - 4000))
        il = int(rng.integers(80, 400))
        codes[a:a + 2] = [2, 3]
        codes[a + il - 2:a + il] = [0, 2]
        for t in [int(rng.integers(20, L - 20)) for _ in range(3)] + \
                [L - int(rng.integers(8, 12))]:
            s1 = np.concatenate([codes[a - t:a], codes[a + il:a + il + L - t]])
            if len(m1) % 3 == 1:
                p = int(rng.integers(0, L))
                s1[p] = (s1[p] + 1) % 4
            m1.append(s1)
            m2.append(mate2(a + il + L - t + inner()))
    for k in range(30):
        s = int(rng.integers(0, n - 3 * L - 200))
        a, b = codes[s:s + L].copy(), mate2(s + L + inner())
        for x in (a, b):
            p = int(rng.integers(0, L))
            x[p] = (x[p] + 1) % 4
        m1.append(a)
        m2.append(b)
    for k in range(4):
        s = int(rng.integers(0, n - 4000))
        m1.append(codes[s:s + L].copy())
        m2.append(codes[s + L + 40:s + 2 * L + 40].copy() if k % 2 == 0
                  else mate2(s + 3000))
    for k in range(4):
        s = int(rng.integers(0, n - 3 * L))
        m1.append(codes[s:s + L].copy())
        m2.append(rng.integers(0, 4, L).astype(np.int8))
    m1.append(rng.integers(0, 4, L).astype(np.int8))
    m2.append(rng.integers(0, 4, L).astype(np.int8))
    rec = lambda i, s: (f"p{i}", "".join("ACGTN"[c] for c in s), b"I" * L)
    return (codes, [rec(i, s) for i, s in enumerate(m1)],
            [rec(i, s) for i, s in enumerate(m2)])


def _compare(a, b):
    for f in OUTPUTS:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f
    sam = (b / "accepted_hits.sam").read_text()
    return [ln.split("\t") for ln in sam.splitlines()]


def _run_both(tmp_path, n, jax_kw, chunk=None):
    from tophat_tpu.index.fasta import Genome as JGenome
    from tophat_tpu.io.fastq import batch_reads as jbatch
    from tophat_tpu.pipeline import paired as jpaired
    from tophat_tpu.pipeline.params import Params as JParams
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.io.fastq import batch_reads
    from tophat_tpu_torch.pipeline import paired
    from tophat_tpu_torch.pipeline.params import Params

    codes, r1, r2 = _pairs(n)
    offsets = np.array([0, n])
    outs = []
    for pk, G, batch, P in ((jpaired, JGenome, jbatch, JParams),
                            (paired, Genome, batch_reads, Params)):
        genome = G(codes=codes, offsets=offsets, names=["chrP"])
        dev = {} if pk is jpaired else {"device": "cpu"}
        out = tmp_path / pk.__name__.split(".")[0]
        if chunk is None:
            pk.run_pipeline_paired(genome, batch(r1), batch(r2),
                                   P(**jax_kw), str(out),
                                   log=lambda *a: None, **dev)
        else:
            pairs = ((batch(r1[s:s + chunk]), batch(r2[s:s + chunk]))
                     for s in range(0, len(r1), chunk))
            pk.run_pipeline_paired_streaming(genome, pairs, P(**jax_kw),
                                             str(out), log=lambda *a: None,
                                             **dev)
        outs.append(out)
    return _compare(*outs)


@pytest.mark.parametrize("mode", ["default", "no_mixed", "no_discordant",
                                  "v2_sam", "no_native"])
def test_run_pipeline_paired_identical(tmp_path, monkeypatch, mode):
    """no_native: the port's record emitter without its native library
    (the Python fallback) writes the same bytes."""
    kw = {"default": {}, "no_mixed": {"no_mixed": True},
          "no_discordant": {"no_discordant": True},
          "v2_sam": {"v2_sam": True, "inner_dist_mean": 60},
          "no_native": {}}[mode]
    if mode == "no_native":
        from tophat_tpu_torch import native

        monkeypatch.setattr(native.bamenc, "_lib", None)
        monkeypatch.setattr(native.bamenc, "_failed", True)
    recs = _run_both(tmp_path, 30000, kw)
    flags = [int(t[1]) for t in recs]
    assert all(f & 0x1 for f in flags)
    assert any(f & 0x40 for f in flags) and any(f & 0x80 for f in flags)
    assert sum(1 for t in recs if "N" in t[5]) >= 16
    if mode == "default":
        assert any(f & 0x8 for f in flags)          # half-mapped pairs
    if mode == "v2_sam":
        assert any(f & 0x2 for f in flags) and any(t[8] != "0" for t in recs)


def test_run_pipeline_paired_beam_engine_identical(tmp_path):
    """A genome above BEAM_MIN_N: segment mapping takes the beam engine."""
    recs = _run_both(tmp_path, (1 << 21) + 4096, {})
    assert sum(1 for t in recs if "N" in t[5]) >= 16


def test_run_pipeline_paired_streaming_identical(tmp_path):
    """Three chunk pairs: a global event union over both mates of every
    chunk, chunk-local pair selection and rescue."""
    recs = _run_both(tmp_path, 30000, {}, chunk=24)
    assert sum(1 for t in recs if "N" in t[5]) >= 16


def test_run_pipeline_paired_every_search_matches_jax(tmp_path):
    """run_pipeline_paired with every search on (coverage, butterfly,
    microexon): the same event table, in the same order, the same
    accepted events and the same selected candidates of both mates."""
    from tophat_tpu.index.fasta import Genome as JGenome
    from tophat_tpu.io.fastq import batch_reads as jbatch
    from tophat_tpu.pipeline.paired import run_pipeline_paired as jrun
    from tophat_tpu.pipeline.params import Params as JParams
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.io.fastq import batch_reads
    from tophat_tpu_torch.pipeline.paired import run_pipeline_paired
    from tophat_tpu_torch.pipeline.params import Params

    n = 30000
    codes, r1, r2 = _pairs(n, seed=5)
    kw = dict(butterfly_search=True, microexon_search=True)
    offsets = np.array([0, n])
    j = jrun(JGenome(codes=codes, offsets=offsets, names=["chrP"]),
             jbatch(r1), jbatch(r2), JParams(**kw), str(tmp_path / "jax"),
             log=lambda *a: None)
    p = run_pipeline_paired(Genome(codes=codes, offsets=offsets,
                                   names=["chrP"]),
                            batch_reads(r1), batch_reads(r2), Params(**kw),
                            str(tmp_path / "torch"), log=lambda *a: None,
                            device="cpu")
    jev, pev = j["events"], p["events"]
    assert sorted(jev) == sorted(pev) and len(pev["left"]) >= 8
    for k in jev:
        np.testing.assert_array_equal(np.asarray(jev[k]), pev[k], err_msg=k)

    def accepted(res):
        return {e for e, st in res["stats"].items() if st.accepted}

    def cands(sel):
        return {r: [(c.pos, c.strand, c.mm, c.kind, c.ev, c.t) for c in cl]
                for r, cl in sel.items()}

    assert accepted(j) == accepted(p) and accepted(p)
    assert len(j["selected"]) == len(p["selected"]) == 2
    for a, b in zip(j["selected"], p["selected"]):
        assert cands(a) == cands(b)


def test_paired_cli_identical(tmp_path, monkeypatch):
    """The paired CLI in TopHat's default mode (coverage search on): two
    contigs, reads streamed in chunk pairs of 40."""
    from tophat_tpu.cli.main import main as jax_main
    from tophat_tpu_torch.cli.main import main as torch_main

    monkeypatch.setenv("TOPHAT_TPU_DEVICES", "1")   # one device, as the port
    n = 30000
    codes, r1, r2 = _pairs(n, seed=8)
    seq = "".join("ACGTN"[c] for c in codes)
    fa = tmp_path / "g.fa"
    fa.write_text(f">chrA\n{seq[:17000]}\n>chrB\n{seq[17000:]}\n")
    fqs = []
    for i, recs in enumerate((r1, r2)):
        fq = tmp_path / f"r{i + 1}.fq"
        fq.write_text("".join(f"@{nm}/{i + 1}\n{s}\n+\n{q.decode()}\n"
                              for nm, s, q in recs))
        fqs.append(str(fq))
    args = ["--batch-size", "40", str(fa)] + fqs
    assert jax_main(["-o", str(tmp_path / "jax")] + args) == 0
    assert torch_main(["-o", str(tmp_path / "torch"), "--device", "cpu"]
                      + args) == 0
    recs = _compare(tmp_path / "jax", tmp_path / "torch")
    assert sum(1 for t in recs if "N" in t[5]) >= 16
    assert {t[2] for t in recs} == {"chrA", "chrB"}
    assert not (tmp_path / "torch" / "tmp").exists()
