"""Colorspace (SOLiD) pipeline driver.

Port of tophat_tpu/pipeline/colorspace.py. Composition (reference: the
-C/--color driver path, src/tophat.py:2896-2928):

1. COLOR-NATIVE genome alignment: reads align as colors against the
   color-transformed FM index (io/color.genome_to_color), built on the
   run's device — a sequencing error costs one color mismatch instead of
   corrupting every downstream base.
2. Placed reads decode reference-guided on the host
   (io/color.decode_alignment): isolated color mismatches become
   sequencing errors (reference base), adjacent consistent pairs become
   real SNPs.
3. The decoded base-space batch then runs the STANDARD pipeline —
   color-unplaced reads fall back to the primer-chain decode, so
   junction-spanning colorspace reads reach the split-segment search in
   base space. The color index is released before that pipeline starts,
   so one index at a time holds device memory.
"""

from __future__ import annotations

import numpy as np

from tophat_tpu_torch.index.fasta import Genome, decode_seq, revcomp
from tophat_tpu_torch.index.fm import build_fm_index
from tophat_tpu_torch.io.color import (decode_alignment, decode_chain,
                                       genome_to_color)
from tophat_tpu_torch.io.fastq import batch_reads
from tophat_tpu_torch.ops.align import align_reads
from tophat_tpu_torch.parallel import auto
from tophat_tpu_torch.pipeline.paired import run_pipeline_paired
from tophat_tpu_torch.pipeline.run import run_pipeline
from tophat_tpu_torch.utils.device import resolve_device


def color_genome(genome: Genome) -> Genome:
    """Color-space view of the concatenated genome: n-1 transition codes,
    contig-boundary transitions masked to N.

    Each interior boundary transition becomes its own singleton interval in
    the offsets table: contig k owns colors [off[k], off[k+1]-1) only, so a
    color alignment whose first/last color is the masked boundary
    transition fails same_contig instead of decoding one base into the
    neighboring contig. `names` keeps the base-space contig list: these
    offsets feed only the same_contig filter, never contig naming."""
    ccodes = genome_to_color(np.asarray(genome.codes), genome.offsets)
    nc = len(ccodes)
    interior = np.asarray(genome.offsets)[1:-1]
    offs = np.unique(np.concatenate(
        [[0], np.clip(interior - 1, 0, nc), np.clip(interior, 0, nc),
         [nc]])).astype(genome.offsets.dtype)
    return Genome(codes=ccodes, offsets=offs, names=list(genome.names))


def align_colors(cfm, coffsets, gbase, records, params, log=print):
    """Color-native ungapped alignment of (name, primer, colors, qual)
    records against the color index (on its device); `gbase` is the BASE
    genome for the reference-guided decode. Returns (decoded_records,
    n_placed): base-space (name, seq, qual) tuples — reference-guided
    decode for placed reads, primer-chain decode for the rest."""
    names = [r[0] for r in records]
    primers = [r[1] for r in records]
    colors_all = [np.asarray(r[2], np.int8) for r in records]
    quals = [r[3] for r in records]
    B = len(records)
    if B == 0:
        return [], 0
    # alignment colors: drop the primer transition (bowtie -C trims the
    # primer base and first color)
    acolors = [c[1:] for c in colors_all]
    L = max((len(c) for c in acolors), default=1)
    cf = np.full((B, L), -1, np.int8)
    cr = np.full((B, L), -1, np.int8)
    lens = np.zeros(B, np.int32)
    for i, c in enumerate(acolors):
        cf[i, : len(c)] = c
        cr[i, : len(c)] = c[::-1]   # colors are complement-invariant
        lens[i] = len(c)
    al = align_reads(cfm, cf, cr, lens, coffsets,
                     max_mismatches=params.read_mismatches,
                     max_alignments=4)
    pos = al.pos.cpu().numpy()
    strand = al.strand.cpu().numpy()
    valid = al.valid.cpu().numpy()

    decoded = []
    n_placed = 0
    for i in range(B):
        c = acolors[i]
        hit = np.nonzero(valid[i])[0]
        if len(hit):
            h = hit[0]
            p = int(pos[i, h])
            cc = c if strand[i, h] == 0 else c[::-1]
            bases, cmm, _ = decode_alignment(gbase, p, cc)
            if strand[i, h] != 0:
                bases = revcomp(bases)  # back to as-sequenced orientation
            seq = decode_seq(bases)
            n_placed += 1
        else:
            # chain decode covers every color incl. the primer transition:
            # L colors -> L bases (base1..baseL)
            seq = decode_seq(decode_chain(primers[i], colors_all[i]))
        q = quals[i]
        if len(q) < len(seq):
            q = q + b"I" * (len(seq) - len(q))
        decoded.append((names[i], seq.encode(), q[: len(seq)]))
    if log:
        log(f"colorspace: {n_placed}/{B} reads placed color-natively, "
            f"{B - n_placed} primer-chain decoded")
    return decoded, n_placed


def decode_color_reads(genome: Genome, record_sets, params, log=print,
                       device="cuda"):
    """Build the color FM index on `device`, align and decode every record
    set in `record_sets`; returns the decoded record lists. The color
    index lives only inside this call (and leaves the mesh's replication
    cache with it)."""
    dev = resolve_device(device)
    cgen = color_genome(genome)
    log(f"building colorspace FM index ({len(cgen.codes)} transitions)")
    big = len(cgen.codes) > (1 << 28)
    cfm = build_fm_index(cgen, kmer_k=13 if big else 0,
                         sa_rate=4 if big else 0, device=dev)
    coff = cgen.offsets.astype(np.int32)
    gbase = np.asarray(genome.codes)
    decoded = [align_colors(cfm, coff, gbase, recs, params, log=log)[0]
               for recs in record_sets]
    auto.release(cfm)
    return decoded


def run_pipeline_color(genome: Genome, records, params, out_dir,
                       records2=None, fm=None, known_events=None,
                       gtf_accept=None, log=print, device="cuda"):
    """Full colorspace run: color-native decode stage + standard base-space
    pipeline on the decoded batch(es). `records`/`records2`: iterables of
    (name, primer_code, colors int8, qual) from io/color.read_csfasta or
    the colorspace-FASTQ parser; records2 enables the paired path."""
    sets = [list(records)] + ([list(records2)] if records2 is not None
                              else [])
    decoded = decode_color_reads(genome, sets, params, log=log,
                                 device=device)
    if len(decoded) == 2:
        return run_pipeline_paired(genome, batch_reads(decoded[0]),
                                   batch_reads(decoded[1]), params, out_dir,
                                   fm=fm, known_events=known_events,
                                   gtf_accept=gtf_accept, log=log,
                                   device=device)
    return run_pipeline(genome, batch_reads(decoded[0]), params, out_dir,
                        fm=fm, known_events=known_events,
                        gtf_accept=gtf_accept, log=log, device=device)
