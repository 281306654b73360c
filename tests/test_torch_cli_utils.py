"""The port's companion utilities (python -m tophat_tpu_torch.cli.utils)
write the same bytes as the JAX package's for every command."""

import io

import pytest


def _inputs(tmp_path):
    """Genome, GTF, a junctions BED, a transcriptome-space SAM, SOLiD FASTQ
    and an NCBI contig table, made from the annotated two-contig fixture."""
    from test_torch_transcriptome import CONTIG, annotated

    codes, gtf, r1, _ = annotated(seed=41)
    seq = "".join("ACGTN"[c] for c in codes)
    (tmp_path / "g.fa").write_text(f">chrA\n{seq[:CONTIG]}\n"
                                   f">chrB\n{seq[CONTIG:]}\n")
    (tmp_path / "genes.gtf").write_text(gtf)
    (tmp_path / "j.bed").write_text(
        'track name=junctions description="TopHat junctions"\n'
        "chrA\t2990\t3262\tJUNC1\t4\t+\t2990\t3262\t255,0,0\t2\t50,12\t0,"
        "260\nchrB\t100\t400\tJUNC2\t2\t-\t100\t400\t255,0,0\t3\t10,20,30\t"
        "0,100,270\nchrA\t500\t900\tintron\t0\t-\n"
        "chrB\t700\t800\n")
    sam = []
    for i, (name, s, q) in enumerate(r1[:24]):
        cig = ["76M", "30M200N46M", "10M5I61M", "20M3D56M"][i % 4]
        sam.append(f"{name}\t{16 if i % 3 else 256}\t{i % 6}\t{1 + 7 * i}\t"
                   f"255\t{cig}\t*\t0\t0\t{s}\t{q.decode()}\tNM:i:0"
                   + ("\tXS:A:-" if i % 5 == 0 else "") + "\n")
    sam.append("u\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\tIIII\n")
    sam.append("t\t0\ttB2\t5\t255\t40M\t*\t0\t0\t" + "A" * 40 + "\t"
               + "I" * 40 + "\n")
    (tmp_path / "t.sam").write_text("@HD\tVN:1.0\n" + "".join(sam))
    (tmp_path / "solid.fq").write_text(
        "@a\nT0123012301\n+\n!IIIIIIIIII\n@b\nG3210\n+\n#ABCD\n")
    (tmp_path / "seq_contig.md").write_text(
        "#tax_id\tchr\tstart\tstop\tori\tfeature\tid\ttype\tgroup\tw\n"
        "9606\t1\t10000\t50000\t+\tNT_0001\tGI1\tcontig\tref\t1\n"
        "9606\t2|x\t2000\t9000\t+\tNT_0002\tGI2\tcontig\tref\t1\n"
        "9606\t3\t1\t2\t+\tstart\tGI3\tcontig\tref\t1\n")
    (tmp_path / "ctg.bed").write_text(
        "track name=junctions\n"
        "gi|1|ref|NT_0001|\t100\t300\tJ1\t5\t+\t100\t300\t255,0,0\t2\t"
        "10,10\t0,190\n"
        "gi|2|ref|NT_0002|\t50\t80\tJ2\t3\t-\t50\t80\t255,0,0\t2\t5,5\t0,25\n"
        "gi|9|ref|NT_0009|\t1\t2\tJ3\t3\t-\t1\t2\t255,0,0\t2\t1,1\t0,1\n")
    (tmp_path / "ctg.gff").write_text(
        "##gff-version 2\n"
        "gi|1|ref|NT_0001|\tsrc\tisland\t10\t40\t7.5\t+\t.\tgene_x\n"
        "short\tline\n")


def _call(mod, cmd, d, tag):
    """Run one utility of `mod` on the inputs in `d`; returns (stdout text,
    bytes of the files it wrote)."""
    out = io.StringIO()
    p = lambda f: str(d / f)
    if cmd == "bed_to_juncs":
        with open(p("j.bed")) as f:
            mod.bed_to_juncs(f, out)
    elif cmd == "sam_juncs":
        mod.sam_juncs(p("t.sam"), out)
    elif cmd == "gtf_to_fasta":
        mod.gtf_to_fasta(p("genes.gtf"), p("g.fa"), p(f"{tag}_tx.fa"))
        return "", [(d / f"{tag}_tx.fa{x}").read_bytes()
                    for x in ("", ".tlst")]
    elif cmd == "map2gtf":
        mod.map2gtf(p("tx.fa.tlst"), p("t.sam"), p(f"{tag}_m.sam"),
                    p("g.fa"))
        mod.map2gtf(p("tx.fa.tlst"), p("t.sam"), out)
        return out.getvalue(), [(d / f"{tag}_m.sam").read_bytes()]
    elif cmd == "sra_to_solid":
        mod.sra_to_solid(p("solid.fq"), out)
    else:
        kind = cmd[-1]
        mod.contig_to_chr_coords(p("seq_contig.md"),
                                 p("ctg.bed" if kind == "b" else "ctg.gff"),
                                 "bed" if kind == "b" else "gff", out)
    return out.getvalue(), []


@pytest.mark.parametrize("cmd", ["bed_to_juncs", "sam_juncs", "gtf_to_fasta",
                                 "map2gtf", "sra_to_solid",
                                 "contig_to_chr_coords_b",
                                 "contig_to_chr_coords_g"])
def test_utils_identical(tmp_path, cmd):
    from tophat_tpu.cli import utils as jutils
    from tophat_tpu_torch.cli import utils

    _inputs(tmp_path)
    # map2gtf reads the .tlst that gtf_to_fasta writes
    jutils.gtf_to_fasta(str(tmp_path / "genes.gtf"), str(tmp_path / "g.fa"),
                        str(tmp_path / "tx.fa"))
    want = _call(jutils, cmd, tmp_path, "jax")
    got = _call(utils, cmd, tmp_path, "torch")
    assert got == want
    assert got[0].strip() or all(got[1])


def test_utils_main_dispatch(tmp_path, capsys):
    """The port's `main` dispatches like the JAX package's: usage and
    unknown commands return 2; a command returns 0."""
    from tophat_tpu.cli import utils as jutils
    from tophat_tpu_torch.cli import utils

    _inputs(tmp_path)
    for argv in ([], ["nope"], ["contig_to_chr_coords", "x", "y"],
                 ["contig_to_chr_coords", "-b", "-g", "x", "y"],
                 ["gtf_to_fasta", str(tmp_path / "genes.gtf"),
                  str(tmp_path / "g.fa"), str(tmp_path / "o.fa")]):
        assert utils.main(argv) == jutils.main(argv)
        capsys.readouterr()
