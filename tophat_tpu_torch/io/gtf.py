# Copy of tophat_tpu/io/gtf.py (host code), imports rewritten; global
# positions past 2^31 kept at int64 (gtf_junctions).
"""GTF/GFF parsing and the transcriptome model.

Covers the roles of gclib's GffReader (reference: src/gclib/gff.cpp),
gtf_juncs (src/gtf_juncs.cpp:43 get_junctions_from_gff — known introns from
successive exon boundaries) and the transcript table behind gtf_to_fasta /
map2gtf (src/GTFToFasta.cpp:60, src/map2gtf.h:41). Instead of building a
transcriptome FASTA + bowtie index and rebasing hits, known junctions enter
the unified event table (auto-accepted, gtf_match) and reads align across
them directly via event realignment — transcriptome mapping without the
coordinate round-trip.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Tuple

import numpy as np

from tophat_tpu_torch.index.fasta import Genome


@dataclasses.dataclass
class Transcript:
    tid: str
    chrom: str
    strand: str
    exons: List[Tuple[int, int]]  # 0-based [start, end) sorted by start


def parse_gtf(path: str) -> Dict[str, Transcript]:
    """Minimal GTF/GFF2 exon parser keyed by transcript_id.

    A transcript_id reused on a different contig becomes a separate entry
    (key suffixed `~<chrom>`), matching the reference GffReader's behavior
    of one GffObj per (id, location) — the tiny_multihit fixture reuses
    `isoformB` on both contigs."""
    out: Dict[str, Transcript] = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            t = line.rstrip("\n").split("\t")
            if len(t) < 9 or t[2].lower() != "exon":
                continue
            chrom, start, end, strand, attrs = t[0], t[3], t[4], t[6], t[8]
            tid = None
            for field in attrs.split(";"):
                field = field.strip()
                if field.startswith("transcript_id"):
                    tid = field.split(None, 1)[1].strip().strip('"')
                    break
            if tid is None:
                continue
            key = tid
            tr = out.get(key)
            if tr is not None and tr.chrom != chrom:
                key = f"{tid}~{chrom}"
                tr = out.get(key)
            if tr is None:
                tr = out[key] = Transcript(tid, chrom, strand, [])
            tr.exons.append((int(start) - 1, int(end)))  # GTF is 1-based incl
    for tr in out.values():
        tr.exons.sort()
    return out


def gtf_junctions(genome: Genome, transcripts: Dict[str, Transcript]):
    """Known introns as a (junction-kind) event table + auto-accept set
    (reference: get_junctions_from_gff, src/gtf_juncs.cpp:43). Global
    positions are int64 on a genome past the int32 range (the JAX
    package's int32 table overflows there)."""
    from tophat_tpu_torch.ops.events import MAX_INS
    from tophat_tpu_torch.ops.splice import KIND_JUNCTION

    name2id = genome.name_to_id()
    lefts, rights, anti = [], [], []
    for tr in transcripts.values():
        if tr.chrom not in name2id:
            continue
        off = int(genome.offsets[name2id[tr.chrom]])
        for (s1, e1), (s2, e2) in zip(tr.exons, tr.exons[1:]):
            if s2 <= e1:
                continue  # overlapping/abutting exons: no intron
            lefts.append(off + e1 - 1)   # last base of left exon
            rights.append(off + s2)      # first base of right exon
            anti.append(tr.strand == "-")
    ev = dict(left=np.array(lefts, genome.pos_dtype),
              right=np.array(rights, genome.pos_dtype),
              kind=np.full(len(lefts), KIND_JUNCTION, np.int8),
              antisense=np.array(anti, bool),
              ins_len=np.zeros(len(lefts), np.int8),
              ins_seq=np.full((len(lefts), MAX_INS), -1, np.int8))
    accept = {(int(l), int(r), bool(a))
              for l, r, a in zip(lefts, rights, anti)}
    return ev, accept


def transcript_sequence(genome: Genome, tr: Transcript) -> np.ndarray:
    """Concatenated exon codes (the gtf_to_fasta record for this
    transcript, reference: GTFToFasta.cpp:9 get_exonic_sequence)."""
    off = int(genome.offsets[genome.name_to_id()[tr.chrom]])
    return np.concatenate([genome.codes[off + s: off + e]
                           for s, e in tr.exons])


# Transcriptome-index data files (the gtf_to_fasta artifact set the driver
# builds/reuses under --transcriptome-index: <prefix>.fa with one record per
# transcript, <prefix>.fa.tlst transcript model, <prefix>.gff annotation
# copy, <prefix>.ver validation stamp — reference: src/GTFToFasta.cpp:60
# make_transcriptome, src/tophat.py:3248 gtf_to_fasta / :3821
# validate_transcriptome / :194 GFF_T_VER).
GFF_T_VER = 209


def _ordered_transcripts(genome: Genome,
                         transcripts: Dict[str, Transcript]):
    """Transcripts grouped by contig in genome order, sorted by start —
    the emission order of make_transcriptome (per-contig FASTA scan over a
    location-sorted GffReader list, GTFToFasta.cpp:70-108)."""
    name2id = genome.name_to_id()
    rows = [tr for tr in transcripts.values()
            if tr.chrom in name2id and tr.exons]
    rows.sort(key=lambda tr: (name2id[tr.chrom], tr.exons[0][0],
                              tr.exons[-1][1], tr.tid))
    return rows


def write_transcriptome_files(prefix: str, genome: Genome,
                              transcripts: Dict[str, Transcript],
                              gtf_path: str, with_ver: bool = True) -> str:
    """Write <prefix>.fa / .fa.tlst / .gff / .ver; returns the FASTA path.

    FASTA record: `><numID> <tid> <chrom><strand> <s1-e1,...>` with exon
    coordinates 1-based inclusive; sequence = exons concatenated in genomic
    order (no reverse complement — matching get_exonic_sequence,
    GTFToFasta.cpp:9). The .tlst line repeats the header fields
    (GTFToFasta.cpp:103), which map2gtf's GffTranscript parses back.
    """
    import shutil

    fa_path = prefix + ".fa"
    rows = _ordered_transcripts(genome, transcripts)
    with open(fa_path, "w") as fa, open(fa_path + ".tlst", "w") as tlst:
        for idx, tr in enumerate(rows):
            coordstr = ",".join(f"{s + 1}-{e}" for s, e in tr.exons)
            desc = f"{tr.tid} {tr.chrom}{tr.strand} {coordstr}"
            seq = decode_transcript(genome, tr)
            fa.write(f">{idx} {desc}\n")
            for i in range(0, len(seq), 60):
                fa.write(seq[i:i + 60] + "\n")
            tlst.write(f"{idx} {desc}\n")
    if with_ver:
        gff_copy = prefix + ".gff"
        if os.path.abspath(gtf_path) != os.path.abspath(gff_copy):
            shutil.copyfile(gtf_path, gff_copy)
        with open(prefix + ".ver", "w") as f:
            f.write("%d %d %d\n" % (GFF_T_VER, os.path.getsize(gff_copy),
                                    os.path.getsize(fa_path)))
    return fa_path


def validate_transcriptome(prefix: str) -> bool:
    """True if the <prefix>.{fa,fa.tlst,gff,ver} set is present and
    consistent (reference: validate_transcriptome, src/tophat.py:3821)."""
    tgff, tfa = prefix + ".gff", prefix + ".fa"
    tverf, tlst = prefix + ".ver", prefix + ".fa.tlst"
    if not os.path.exists(tgff) or not os.path.exists(tverf):
        return False
    try:
        parts = open(tverf).readline().split()
        tver, tgff_size, tfa_size = (int(x) for x in parts[:3])
    except (ValueError, IndexError):
        return False
    return (os.path.exists(tlst) and os.path.getsize(tlst) > 0
            and os.path.exists(tfa) and os.path.getsize(tfa) == tfa_size
            and os.path.getsize(tgff) == tgff_size and tver >= GFF_T_VER)


def load_tlst(path: str) -> List[Transcript]:
    """Parse a .tlst transcript model back into Transcripts, indexed by
    numeric ID (reference: GffTranscript(tline), src/map2gtf.h:41)."""
    out: List[Transcript] = []
    with open(path) as f:
        for line in f:
            t = line.split()
            if len(t) < 4:
                continue
            num, tid, refstrand, coordstr = int(t[0]), t[1], t[2], t[3]
            chrom, strand = refstrand[:-1], refstrand[-1]
            exons = []
            for seg in coordstr.split(","):
                s, e = seg.split("-")
                exons.append((int(s) - 1, int(e)))
            while len(out) <= num:
                out.append(None)  # type: ignore[arg-type]
            out[num] = Transcript(tid, chrom, strand, exons)
    return out


def decode_transcript(genome: Genome, tr: Transcript) -> str:
    from tophat_tpu_torch.index.fasta import decode_seq

    return decode_seq(transcript_sequence(genome, tr))


def trans_to_genomic(exons: List[Tuple[int, int]], pos0: int,
                     cigar: List[Tuple[str, int]]
                     ) -> Tuple[int, List[Tuple[str, int]]]:
    """Rewrite a transcript-space alignment into genomic coordinates with
    N-CIGAR introns (reference: trans_to_genomic_coords,
    src/map2gtf.cpp:234). `exons` are 0-based [start, end) in genomic
    coords; `pos0` is the 0-based transcript-space start. Returns
    (genomic_pos0, new_cigar). Raises ValueError if the alignment runs off
    the transcript."""
    # transcript offset -> (exon index, genomic position)
    cum = 0
    ei, gpos = -1, -1
    for i, (s, e) in enumerate(exons):
        if pos0 < cum + (e - s):
            ei, gpos = i, s + (pos0 - cum)
            break
        cum += e - s
    if ei < 0:
        raise ValueError("alignment start beyond transcript end")
    out: List[Tuple[str, int]] = []

    def emit(op, n):
        if n <= 0:
            return
        if out and out[-1][0] == op:
            out[-1] = (op, out[-1][1] + n)
        else:
            out.append((op, n))

    start_g = gpos
    for op, length in cigar:
        if op in ("I", "S", "H", "P"):
            emit(op, length)
            continue
        if op not in ("M", "D", "=", "X"):
            raise ValueError(f"unsupported op {op!r} in transcript space")
        rem = length
        while rem > 0:
            s, e = exons[ei]
            room = e - gpos
            take = min(rem, room)
            emit("M" if op in ("=", "X") else op, take)
            gpos += take
            rem -= take
            if gpos == e and rem > 0:
                if ei + 1 >= len(exons):
                    raise ValueError("alignment runs off transcript")
                nxt = exons[ei + 1]
                emit("N", nxt[0] - e)
                ei += 1
                gpos = nxt[0]
    return start_g, out


def write_juncs_file(path: str, genome: Genome, transcripts) -> int:
    """Emit the .juncs text format (reference: gtf_juncs.cpp:94 output)."""
    ev, _ = gtf_junctions(genome, transcripts)
    n = 0
    with open(path, "w") as f:
        for l, r, a in zip(ev["left"], ev["right"], ev["antisense"]):
            cid, ll = genome.global_to_contig(np.int64(l))
            _, rl = genome.global_to_contig(np.int64(r))
            f.write(f"{genome.names[int(cid)]}\t{int(ll)}\t{int(rl)}\t"
                    f"{'-' if a else '+'}\n")
            n += 1
    return n
