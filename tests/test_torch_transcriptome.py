"""GTF / transcriptome parity: the port's -G runs (single-end and paired,
-T, -x, --no-gtf-juncs) and --transcriptome-index (build, reuse,
build-only) write the same files as the JAX package's CLI, byte for byte:
accepted_hits.sam, the three BED tracks, align_summary.txt when paired,
and the transcriptome data files (.fa, .fa.tlst, .gff, .ver)."""

import os
import zipfile

import numpy as np
import pytest
import torch

OUTPUTS = ("accepted_hits.sam", "junctions.bed", "insertions.bed",
           "deletions.bed")
TX_FILES = (".fa", ".fa.tlst", ".gff", ".ver")
CONTIG = 20000
L = 76


def _revcomp(s):
    return np.where(s < 4, 3 - s, s)[::-1].astype(np.int8)


def annotated(seed=17, read_len=L):
    """Two 20,000-base contigs with annotated genes and reads of read_len
    bp (exon lengths below scaled by ceil(read_len / 76)).

    Genes (exons as 0-based [start, end) on their contig):
      gA  chrA +  exons 40/12/12/80: 12-bp middle exons no segment maps,
          and an isoform skipping both;
      gB  chrA -  four exons of 70-130 bp, an isoform skipping exon 2;
      gC  chrB +  three exons, and gC2, an exact copy of gC's locus 8 kb
          downstream (its reads hit two transcripts: -x 1 drops them).
    Reads (76 bp, mate 2 the reverse complement downstream of mate 1,
    inner distance from N(50, 20) clipped at 0; transcript pairs in
    transcript space): pairs from every transcript, some reverse; mate 1
    across three planted unannotated GT..AG introns; contiguous pairs with
    one mismatch in each mate. Returns (codes, gtf_text, r1, r2)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, 2 * CONTIG).astype(np.int8)
    gtf, trs = [], []
    scale = -(-read_len // L)

    def gene(chrom, strand, tid, exons, gid):
        off = 0 if chrom == "chrA" else CONTIG
        for s, e in exons:
            gtf.append(f'{chrom}\ttest\texon\t{s + 1}\t{e}\t.\t{strand}\t.\t'
                       f'gene_id "{gid}"; transcript_id "{tid}";\n')
        trs.append(np.concatenate([codes[off + s:off + e] for s, e in exons]))

    def layout(start, lens, introns):
        ex, p = [], start
        for i, el in enumerate(x * scale for x in lens):
            ex.append((p, p + el))
            p += el + (introns[i] if i < len(introns) else 0)
        return ex

    a = layout(3000, [40, 12, 12, 80], [200, 180, 160])
    gene("chrA", "+", "tA1", a, "gA")
    gene("chrA", "+", "tA2", [a[0], a[3]], "gA")
    b = layout(9000, [120, 90, 70, 130], [300, 900, 450])
    gene("chrA", "-", "tB1", b, "gB")
    gene("chrA", "-", "tB2", [b[0], b[2], b[3]], "gB")
    c = layout(2000, [110, 100, 120], [400, 250])
    span = c[-1][1] - c[0][0]
    codes[CONTIG + 10000:CONTIG + 10000 + span] = \
        codes[CONTIG + 2000:CONTIG + 2000 + span]
    gene("chrB", "+", "tC1", c, "gC")
    gene("chrB", "+", "tC2", [(s + 8000, e + 8000) for s, e in c], "gC2")

    m1, m2 = [], []

    def add(s1, s2):
        m1.append(s1)
        m2.append(s2)

    for k, tseq in enumerate(trs):
        for rep in range(4):
            inner = max(0, int(round(rng.normal(50, 20))))
            frag = min(len(tseq), 2 * read_len + inner)
            s = int(rng.integers(0, len(tseq) - frag + 1))
            f = tseq[s:s + frag]
            a1, a2 = f[:read_len], _revcomp(f[-read_len:])
            add(*((a1, a2) if rep % 2 == 0 else (a2, a1)))
    for k in range(3):                        # unannotated introns, chrB
        left = 14000 + 1500 * k
        il = int(rng.integers(120, 600))
        codes[CONTIG + left:CONTIG + left + 2] = [2, 3]
        codes[CONTIG + left + il - 2:CONTIG + left + il] = [0, 2]
        g = CONTIG + left
        for t in (25, 38, 51):
            s1 = np.concatenate([codes[g - t:g],
                                 codes[g + il:g + il + read_len - t]])
            st = g + il + read_len - t + 40
            add(s1, _revcomp(codes[st:st + read_len]))
    for _ in range(20):
        s = int(rng.integers(0, 2 * CONTIG - 3 * read_len))
        x = codes[s:s + read_len].copy()
        y = codes[s + read_len + 50:s + 2 * read_len + 50].copy()
        for z in (x, y):
            z[int(rng.integers(0, read_len))] ^= 1
        add(x, _revcomp(y))
    rec = lambda i, s: (f"p{i}", "".join("ACGTN"[c] for c in s),
                        b"I" * read_len)
    return (codes, "".join(gtf), [rec(i, s) for i, s in enumerate(m1)],
            [rec(i, s) for i, s in enumerate(m2)])


def _write_inputs(tmp_path, seed=17, read_len=L):
    codes, gtf, r1, r2 = annotated(seed, read_len)
    seq = "".join("ACGTN"[c] for c in codes)
    fa = tmp_path / "g.fa"
    fa.write_text(f">chrA\n{seq[:CONTIG]}\n>chrB\n{seq[CONTIG:]}\n")
    gtf_path = tmp_path / "genes.gtf"
    gtf_path.write_text(gtf)
    fqs = []
    for i, recs in enumerate((r1, r2)):
        fq = tmp_path / f"r{i + 1}.fq"
        fq.write_text("".join(f"@{nm}/{i + 1}\n{s}\n+\n{q.decode()}\n"
                              for nm, s, q in recs))
        fqs.append(str(fq))
    return str(fa), str(gtf_path), fqs


def _both(tmp_path, args, files=OUTPUTS):
    """Run both CLIs with `args` (-o added); assert `files` identical;
    return the port's SAM records."""
    from tophat_tpu.cli.main import main as jax_main
    from tophat_tpu_torch.cli.main import main as torch_main

    assert jax_main(["-o", str(tmp_path / "jax")] + args) == 0
    assert torch_main(["-o", str(tmp_path / "torch"), "--device", "cpu"]
                      + args) == 0
    for f in files:
        assert (tmp_path / "jax" / f).read_bytes() == \
            (tmp_path / "torch" / f).read_bytes(), f
    sam = (tmp_path / "torch" / "accepted_hits.sam").read_text()
    return [ln.split("\t") for ln in sam.splitlines()]


@pytest.mark.parametrize("mode", ["single", "paired", "T", "x",
                                  "no_gtf_juncs"])
def test_cli_gtf_identical(tmp_path, monkeypatch, mode):
    """-G on a two-contig genome: single-end and paired-end runs, -T
    (transcriptome placements only), -x 1 (reads with two transcriptome
    placements dropped) and --no-gtf-juncs (annotated junctions must earn
    their acceptance)."""
    monkeypatch.setenv("TOPHAT_TPU_DEVICES", "1")   # one device, as the port
    fa, gtf, fqs = _write_inputs(tmp_path)
    flags = {"single": [], "paired": [], "T": ["-T"], "x": ["-x", "1"],
             "no_gtf_juncs": ["--no-gtf-juncs"]}[mode]
    reads = fqs if mode in ("paired", "no_gtf_juncs") else fqs[:1]
    files = OUTPUTS + (("align_summary.txt",) if len(reads) == 2 else ())
    recs = _both(tmp_path, ["-G", gtf, "--no-coverage-search"] + flags
                 + [fa] + reads, files)
    multi_n = sum(1 for t in recs if t[5].count("N") >= 3)
    pair = lambda t: int(t[0][1:].split("/")[0])
    if mode == "T":                             # transcript reads only
        assert recs and all(pair(t) < 24 for t in recs)
    elif mode == "x":      # gC/gC2 reads: no transcriptome placement left
        assert not any(16 <= pair(t) < 24 and "N" in t[5] for t in recs)
    if mode != "no_gtf_juncs":
        assert multi_n >= 2                     # gA's 3-junction reads
    assert sum(1 for t in recs if "N" in t[5]) >= 10


def test_cli_gtf_long_pairs_identical(tmp_path, monkeypatch):
    """-G paired at 2 x 300 bp (exons four times as long): every read row
    is 300 positions wide, past the realign kernel's one-hot path on the
    card; both CLIs write the same files, and transcript mates cross
    annotated junctions."""
    monkeypatch.setenv("TOPHAT_TPU_DEVICES", "1")
    fa, gtf, fqs = _write_inputs(tmp_path, read_len=300)
    recs = _both(tmp_path, ["-G", gtf, "--no-coverage-search", fa] + fqs,
                 OUTPUTS + ("align_summary.txt",))
    assert {len(t[9]) for t in recs if not t[0].startswith("@")} == {300}
    assert sum(1 for t in recs if "N" in t[5]) >= 10


def test_transcriptome_index_build_reuse_buildonly(tmp_path, monkeypatch):
    """--transcriptome-index DIR/ -G with no reads builds the data files and
    the transcriptome FM index and stops; a paired run naming the prefix
    alone reuses both; the files match the JAX package's."""
    from tophat_tpu.cli.main import main as jax_main
    from tophat_tpu_torch.cli.main import main as torch_main

    monkeypatch.setenv("TOPHAT_TPU_DEVICES", "1")
    fa, gtf, fqs = _write_inputs(tmp_path, seed=23)
    for tag, main, dev in (("jax", jax_main, []),
                           ("torch", torch_main, ["--device", "cpu"])):
        tix = tmp_path / f"tix_{tag}"
        assert main(["-o", str(tmp_path / f"build_{tag}")] + dev
                    + ["--transcriptome-index", str(tix) + os.sep,
                       "-G", gtf, fa]) == 0
        assert os.path.exists(tix / "genes.tt.npz")
        assert not (tmp_path / f"build_{tag}" / "accepted_hits.sam").exists()
    for ext in TX_FILES:
        assert (tmp_path / "tix_jax" / f"genes{ext}").read_bytes() == \
            (tmp_path / "tix_torch" / f"genes{ext}").read_bytes(), ext
    for tag, main, dev in (("jax", jax_main, []),
                           ("torch", torch_main, ["--device", "cpu"])):
        assert main(["-o", str(tmp_path / tag)] + dev
                    + ["--transcriptome-index",
                       str(tmp_path / f"tix_{tag}" / "genes"),
                       "--no-coverage-search", fa] + fqs) == 0
    log = (tmp_path / "torch" / "logs" / "tophat.log").read_text()
    assert "transcriptome index: reusing" in log
    assert "transcriptome FM index: reusing" in log
    for f in OUTPUTS + ("align_summary.txt",):
        assert (tmp_path / "jax" / f).read_bytes() == \
            (tmp_path / "torch" / f).read_bytes(), f


def test_transcriptome_index_rebuilds_a_corrupt_file(tmp_path):
    """A corrupt saved index (a broken zip archive) or a stale one (built
    for other transcripts) is rebuilt and saved again, not used."""
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.io.gtf import parse_gtf
    from tophat_tpu_torch.pipeline.transcriptome import \
        build_transcriptome_index

    codes, gtf, _, _ = annotated()
    genome = Genome(codes=codes, offsets=np.array([0, CONTIG, 2 * CONTIG]),
                    names=["chrA", "chrB"])
    (tmp_path / "genes.gtf").write_text(gtf)
    transcripts = parse_gtf(str(tmp_path / "genes.gtf"))
    prefix = str(tmp_path / "genes")
    (tmp_path / "genes.tt.npz").write_bytes(b"PK\x03\x04 truncated")
    with pytest.raises(zipfile.BadZipFile):
        np.load(prefix + ".tt.npz")
    msgs = []
    t1 = build_transcriptome_index(genome, transcripts, prefix=prefix,
                                   log=msgs.append, device="cpu")
    assert msgs == [f"transcriptome FM index: saved {prefix}.tt.npz"]
    t2 = build_transcriptome_index(genome, transcripts, prefix=prefix,
                                   log=msgs.append, device="cpu")
    assert msgs[-1].startswith("transcriptome FM index: reusing")
    assert torch.equal(t1.fm.sa, t2.fm.sa)
    assert t2.n == len(t2.tgenome.codes)
    fewer = dict(list(transcripts.items())[:2])
    t3 = build_transcriptome_index(genome, fewer, prefix=prefix,
                                   log=msgs.append, device="cpu")
    assert msgs[-1].startswith("transcriptome FM index: saved")
    assert t3.n < t2.n


@pytest.mark.parametrize("seed", [1, 2])
def test_transcriptome_candidates_match_jax(seed):
    """Transcriptome hits become the JAX package's candidates, in its
    order, against an event table where a (left, right) holds junctions
    of both senses, an indel shares a junction's coordinates, positions
    pass 2^31 and some hits name a junction missing from the table."""
    from tophat_tpu.pipeline.transcriptome import \
        transcriptome_candidates as jcands
    from tophat_tpu_torch.ops.splice import (KIND_DELETION, KIND_INSERTION,
                                             KIND_JUNCTION)
    from tophat_tpu_torch.pipeline.params import Params
    from tophat_tpu_torch.pipeline.transcriptome import \
        transcriptome_candidates

    rng = np.random.default_rng(seed)
    base = np.int64(1 << 31) - 5000 if seed == 2 else np.int64(0)
    left = base + np.sort(rng.choice(4000, 60, replace=False)).astype(
        np.int64)
    right = left + rng.integers(70, 400, 60)
    kind = np.full(60, KIND_JUNCTION, np.int8)
    kind[rng.choice(60, 12, replace=False)] = KIND_DELETION
    kind[:3] = KIND_INSERTION
    anti = rng.random(60) < 0.5
    dup = rng.choice(np.nonzero(kind == KIND_JUNCTION)[0], 8, replace=False)
    events = dict(left=np.concatenate([left, left[dup]]),
                  right=np.concatenate([right, right[dup]]),
                  kind=np.concatenate([kind, kind[dup]]),
                  antisense=np.concatenate([anti, ~anti[dup]]))
    hits = {}
    for r in range(40):
        e = int(rng.integers(0, 60))
        gp = int(left[e]) - 29
        n = int(right[e] - left[e] - 1)
        ops = ([("M", 30), ("N", n), ("M", 46)] if r % 5
               else [("M", 76)] if r % 10 else [("M", 30), ("N", n + 1),
                                                 ("M", 46)])
        hits[r] = [(r % 2, gp, r % 3, ops)]
    got = transcriptome_candidates(hits, events, Params())
    ref = jcands(hits, events, Params())
    assert list(got) == list(ref)
    assert {r: [repr(c) for c in v] for r, v in got.items()} == \
        {r: [repr(c) for c in v] for r, v in ref.items()}
    assert sum(c.kind == -2 for v in got.values() for c in v) >= 10
