"""Colorspace (-C) parity on a synthetic genome: the port's color helpers
equal the JAX package's, and -C runs from csfasta (with a _QV.qual file)
and from colorspace FASTQ, single-end and paired-end, write the same
files as the JAX package's CLI, byte for byte."""

import numpy as np
import pytest

OUTPUTS = ("accepted_hits.sam", "junctions.bed", "insertions.bed",
           "deletions.bed")
L = 50


def _encode_colors(bases, primer=3):
    out, prev = [], primer
    for b in bases:
        out.append(prev ^ int(b))
        prev = int(b)
    return np.array(out, np.int8)


def _revcomp(s):
    return np.where(s < 4, 3 - s, s)[::-1].astype(np.int8)


def color_workload(seed=31, n=30000):
    """Two contigs (n bases in all, an N run in the first); colorspace mate
    pairs (L = 50 colors after the primer T): clean, with an isolated
    color error, with a SNP, from the reverse strand, mate 1 across a
    planted GT..AG intron, and one pair of random colors. Returns (codes,
    split, pairs) with pairs [(name, colors1, colors2)]."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.int8)
    codes[n // 4:n // 4 + 15] = 4
    split = n // 2
    pairs = []
    for i in range(40):
        kind = i % 5
        if kind == 4:
            a = int(rng.integers(1000, split - 2000)) + split * (i % 2)
            il = int(rng.integers(100, 500))
            codes[a:a + 2] = [2, 3]
            codes[a + il - 2:a + il] = [0, 2]
            t = int(rng.integers(20, L - 20))
            b1 = np.concatenate([codes[a - t:a], codes[a + il:a + il + L - t]])
            s2 = a + il + L - t + 40
        else:
            s = int(rng.integers(0, split - 3 * L)) + split * (i % 2)
            b1 = codes[s:s + L].copy()
            if kind == 2:
                b1[L // 2] ^= 1                       # SNP
            s2 = s + L + 40
        b2 = _revcomp(codes[s2:s2 + L])
        if kind == 3:
            b1, b2 = b2, b1
        c1, c2 = _encode_colors(b1), _encode_colors(b2)
        if kind == 1:
            c1[8] ^= 2                                # color error
            c2[30] ^= 1
        pairs.append((f"c{i}", c1, c2))
    pairs.append(("junk", rng.integers(0, 4, L).astype(np.int8),
                  rng.integers(0, 4, L).astype(np.int8)))
    return codes, split, pairs


def test_color_helpers_match_jax():
    from tophat_tpu.index.fasta import Genome as JGenome
    from tophat_tpu.io import color as jcolor
    from tophat_tpu.pipeline.colorspace import color_genome as jcolor_genome
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.io import color
    from tophat_tpu_torch.pipeline.colorspace import color_genome

    codes, split, pairs = color_workload()
    offs = np.array([0, split, len(codes)])
    jg = jcolor_genome(JGenome(codes=codes, offsets=offs, names=["a", "b"]))
    pg = color_genome(Genome(codes=codes, offsets=offs, names=["a", "b"]))
    np.testing.assert_array_equal(pg.codes, jg.codes)
    np.testing.assert_array_equal(pg.offsets, jg.offsets)
    assert pg.codes[split - 1] == 4
    for name, c1, _ in pairs:
        s = ("T" + "".join(str(int(c)) for c in c1)).encode()
        assert color.is_colorspace_read(s) == jcolor.is_colorspace_read(s)
        p, cols = color.encode_color_read(s)
        jp, jcols = jcolor.encode_color_read(s)
        assert p == jp and np.array_equal(cols, jcols)
        np.testing.assert_array_equal(color.decode_chain(p, cols),
                                      jcolor.decode_chain(p, cols))
        for pos in (100, 5000, split - L):
            got = color.decode_alignment(codes, pos, cols[1:])
            want = jcolor.decode_alignment(codes, pos, cols[1:])
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]


def _write_inputs(tmp_path, fmt):
    codes, split, pairs = color_workload()
    seq = "".join("ACGTN"[c] for c in codes)
    fa = tmp_path / "g.fa"
    fa.write_text(f">chrA\n{seq[:split]}\n>chrB\n{seq[split:]}\n")
    rng = np.random.default_rng(5)
    files = []
    for m in (1, 2):
        body = [(nm, "T" + "".join(str(int(c)) for c in (c1, c2)[m - 1]))
                for nm, c1, c2 in pairs]
        quals = [rng.integers(5, 41, L + 1) for _ in body]
        if fmt == "csfasta":
            cs = tmp_path / f"r{m}.csfasta"
            cs.write_text("# SOLiD\n" + "".join(f">{nm}\n{s}\n"
                                                for nm, s in body))
            qv = tmp_path / f"r{m}_QV.qual"
            qv.write_text("".join(f">{nm}\n{' '.join(map(str, q[1:]))}\n"
                                  for (nm, _), q in zip(body, quals)))
            files.append((str(cs), str(qv)))
        else:
            fq = tmp_path / f"r{m}.fq"
            fq.write_text("".join(
                f"@{nm}/{m}\n{s}\n+\n{''.join(chr(33 + v) for v in q)}\n"
                for (nm, s), q in zip(body, quals)))
            files.append((str(fq), None))
    return str(fa), files


@pytest.mark.parametrize("fmt,paired", [("csfasta", False),
                                        ("fastq", False), ("fastq", True)])
def test_color_cli_identical(tmp_path, monkeypatch, fmt, paired):
    from tophat_tpu.cli.main import main as jax_main
    from tophat_tpu_torch.cli.main import main as torch_main

    monkeypatch.setenv("TOPHAT_TPU_DEVICES", "1")   # one device, as the port
    fa, files = _write_inputs(tmp_path, fmt)
    args = ["-C", "--no-coverage-search"]
    if fmt == "csfasta":
        args += ["-Q", files[0][1]]
    args += [fa, files[0][0]]
    if paired:
        args += [files[1][0]]
    assert jax_main(["-o", str(tmp_path / "jax")] + args) == 0
    assert torch_main(["-o", str(tmp_path / "torch"), "--device", "cpu"]
                      + args) == 0
    for f in OUTPUTS + (("align_summary.txt",) if paired else ()):
        assert (tmp_path / "jax" / f).read_bytes() == \
            (tmp_path / "torch" / f).read_bytes(), f
    sam = (tmp_path / "torch" / "accepted_hits.sam").read_text()
    recs = [ln.split("\t") for ln in sam.splitlines()]
    names = {t[0].split("/")[0] for t in recs}
    assert len(names) >= 30 and "junk" not in names
    assert sum(1 for t in recs if "N" in t[5]) >= 4
