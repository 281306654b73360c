# Copy of tophat_tpu/cli/utils.py (host code), imports rewritten.
"""Small companion utilities mirroring the reference's helper tools:
bed_to_juncs (scripts/bed_to_juncs), sam_juncs (src/sam_juncs.cpp),
gtf_to_fasta (src/gtf_to_fasta.cpp) and map2gtf (src/map2gtf.cpp).

Usage:
  python -m tophat_tpu_torch.cli.utils bed_to_juncs < junctions.bed > out.juncs
  python -m tophat_tpu_torch.cli.utils sam_juncs accepted_hits.sam
  python -m tophat_tpu_torch.cli.utils gtf_to_fasta genes.gtf genome.fa out.fa
  python -m tophat_tpu_torch.cli.utils map2gtf out.fa.tlst trans.sam out.sam \\
      [genome.fa]
  python -m tophat_tpu_torch.cli.utils sra_to_solid in.fastq > out.fastq
  python -m tophat_tpu_torch.cli.utils contig_to_chr_coords -b seq_contig.md \\
      junctions.bed  (src/contig_to_chr_coords, src/sra_to_solid)
"""

from __future__ import annotations

import re
import sys


def bed_to_juncs(inp=sys.stdin, out=sys.stdout) -> int:
    """junctions.bed (BED12 or intron BED) -> .juncs lines
    `chrom <left> <right> <strand>` with left = last base of the left exon
    (0-based) and right = first base of the right exon — the format
    -j/--raw-juncs consumes (reference: scripts' bed_to_juncs behavior:
    left = chromStart + blockSize0 - 1, right = chromStart + blockStart1).
    """
    n = 0
    for line in inp:
        if line.startswith(("track", "browser", "#")) or not line.strip():
            continue
        t = line.split("\t")
        if len(t) >= 12:
            start = int(t[1])
            sizes = [int(x) for x in t[10].rstrip(",").split(",")]
            starts = [int(x) for x in t[11].rstrip(",").split(",")]
            strand = t[5]
            for i in range(len(sizes) - 1):
                left = start + starts[i] + sizes[i] - 1
                right = start + starts[i + 1]
                out.write(f"{t[0]}\t{left}\t{right}\t{strand}\n")
                n += 1
        elif len(t) >= 3:
            strand = t[5].strip() if len(t) > 5 else "+"
            out.write(f"{t[0]}\t{int(t[1]) - 1}\t{int(t[2])}\t{strand}\n")
            n += 1
    return n


_CIG = re.compile(r"(\d+)([MIDNSHP=X])")


def sam_juncs(path: str, out=sys.stdout) -> int:
    """Print junctions implied by N cigar ops in a SAM file
    (reference: sam_juncs.cpp:24 get_junctions_from_hitstream)."""
    seen = set()
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            t = line.split("\t")
            if len(t) < 6 or t[5] == "*":
                continue
            pos = int(t[3]) - 1
            xs = "+"
            for fld in t[11:]:
                if fld.startswith("XS:A:"):
                    xs = fld[5:6]
            ref = pos
            for num, op in _CIG.findall(t[5]):
                num = int(num)
                if op == "N":
                    seen.add((t[2], ref - 1, ref + num, xs))
                if op in "MDN=X":
                    ref += num
    for chrom, left, right, strand in sorted(seen):
        out.write(f"{chrom}\t{left}\t{right}\t{strand}\n")
    return len(seen)


def gtf_to_fasta(gtf_path: str, genome_path: str, out_fa: str) -> int:
    """Build the transcriptome FASTA + .tlst model (reference binary:
    src/gtf_to_fasta.cpp main / GTFToFasta.cpp:60 make_transcriptome;
    same positional CLI: <gtf> <genome.fa> <out.fa>)."""
    from tophat_tpu_torch.index.fasta import read_fasta
    from tophat_tpu_torch.io.gtf import parse_gtf, write_transcriptome_files

    genome = read_fasta(genome_path)
    transcripts = parse_gtf(gtf_path)
    prefix = out_fa[:-3] if out_fa.endswith(".fa") else out_fa
    write_transcriptome_files(prefix, genome, transcripts, gtf_path,
                              with_ver=False)
    return len(transcripts)


def map2gtf(tlst_path: str, in_sam: str, out_path, genome_path=None) -> int:
    """Transcriptome→genome coordinate conversion of a SAM file
    (reference binary: src/map2gtf.cpp:432 main / :234
    trans_to_genomic_coords). RNAME must be the numeric transcript index
    (or the transcript_id) from the .tlst. Dedups per-read identical
    placements like Map2GTF does."""
    from tophat_tpu_torch.io.gtf import load_tlst, trans_to_genomic

    transcripts = load_tlst(tlst_path)
    by_tid = {t.tid: t for t in transcripts if t is not None}
    close_out = False
    if isinstance(out_path, str):
        out = open(out_path, "w")
        close_out = True
    else:
        out = out_path
    n = 0
    try:
        if genome_path:
            from tophat_tpu_torch.index.fasta import read_fasta
            from tophat_tpu_torch.io.sam import header_lines

            for line in header_lines(read_fasta(genome_path),
                                     sort_order="unsorted"):
                out.write(line + "\n")
        seen = set()
        with open(in_sam) as f:
            for line in f:
                if line.startswith("@"):
                    continue
                t = line.rstrip("\n").split("\t")
                if len(t) < 11 or t[2] == "*" or t[5] == "*":
                    continue
                tr = (transcripts[int(t[2])] if t[2].isdigit()
                      and int(t[2]) < len(transcripts) else by_tid.get(t[2]))
                if tr is None:
                    continue
                cigar = [(op, int(num)) for num, op in _CIG.findall(t[5])]
                try:
                    gpos, gcigar = trans_to_genomic(
                        tr.exons, int(t[3]) - 1, cigar)
                except ValueError:
                    continue
                cig_str = "".join(f"{ln}{op}" for op, ln in gcigar)
                key = (t[0], tr.chrom, gpos, cig_str)
                if key in seen:
                    continue
                seen.add(key)
                t[2], t[3], t[5] = tr.chrom, str(gpos + 1), cig_str
                # strip SECONDARY like trans_to_genomic_coords does
                t[1] = str(int(t[1]) & ~0x100)
                if any(op == "N" for op, _ in gcigar):
                    t.append(f"XS:A:{tr.strand}")
                out.write("\t".join(t) + "\n")
                n += 1
    finally:
        if close_out:
            out.close()
    return n


def sra_to_solid(path: str, out=None) -> int:
    """Strip the primer quality value from SRA-FTP SOLiD FASTQ qual lines
    (every 4th line loses its first character — reference:
    src/sra_to_solid:20-27)."""
    out = out if out is not None else sys.stdout
    n = 0
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.rstrip("\n")
            if i % 4 == 3:
                line = line[1:]
                n += 1
            out.write(line + "\n")
    return n


def contig_to_chr_coords(md_path: str, feat_path: str, kind: str,
                         out=None) -> int:
    """Map NCBI contig coords to whole-chromosome coords in a BED or
    GFF/GTF file using a seq_contig.md placement table (reference:
    src/contig_to_chr_coords:14-127; kind 'bed' mirrors its -b branch,
    'gff' its -g branch, including the output field layout).

    seq_contig.md columns used: chromosome (col 1), contig start (col 2),
    contig accession (col 5). Feature lines name contigs in the NCBI
    `xx|yy|zz|<accession>|...` form (col 0); the accession keys the table.
    """
    out = out if out is not None else sys.stdout
    contigs = {}
    with open(md_path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            cols = line.strip().split("\t")
            if len(cols) < 9:
                continue
            if cols[5] not in ("start", "end"):
                contigs[cols[5]] = (cols[1], int(cols[2]))
    n = 0
    with open(feat_path) as f:
        lines = f.readlines()
    if lines:
        out.write(lines[0])
    min_cols = 8 if kind == "gff" else 3
    for line in lines[1:]:
        cols = line.strip().split("\t")
        if len(cols) < min_cols:
            continue
        fields = cols[0].split("|")
        if len(fields) < 4:
            continue
        ctg = contigs.get(fields[3])
        if ctg is None:
            continue
        chr_name = ctg[0].split("|")[0]
        if kind == "gff":
            left, right = ctg[1] + int(cols[3]), ctg[1] + int(cols[4])
            out.write(f"chr{chr_name}\tTopHat\tisland\t{left}\t{right}\t"
                      f"{cols[5]}\t.\t.\t{cols[8]}\n")
        else:
            left, right = ctg[1] + int(cols[1]), ctg[1] + int(cols[2])
            out.write(f"chr{chr_name}\t{left}\t{right}\t{cols[3]}\t0\t"
                      f"{cols[5]}\t{left}\t{right}\t255,0,0\t2\t1,1\t"
                      f"{cols[11]}\n")
        n += 1
    return n


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    cmd = argv[0]
    if cmd == "bed_to_juncs":
        bed_to_juncs()
    elif cmd == "sam_juncs":
        sam_juncs(argv[1])
    elif cmd == "gtf_to_fasta":
        gtf_to_fasta(argv[1], argv[2], argv[3])
    elif cmd == "map2gtf":
        genome = argv[4] if len(argv) > 4 else None
        map2gtf(argv[1], argv[2], argv[3], genome)
    elif cmd == "sra_to_solid":
        sra_to_solid(argv[1])
    elif cmd == "contig_to_chr_coords":
        flags = [a for a in argv[1:] if a.startswith("-")]
        rest = [a for a in argv[1:] if not a.startswith("-")]
        if ("-b" in flags) == ("-g" in flags) or len(rest) < 2:
            print("usage: contig_to_chr_coords (-b|-g) <seq_contig.md> "
                  "<features.bed|.gff>", file=sys.stderr)
            return 2
        contig_to_chr_coords(rest[0], rest[1],
                             "bed" if "-b" in flags else "gff")
    else:
        print(f"unknown utility {cmd!r}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
