"""tophat-compatible command line for the PyTorch port.

Port of tophat_tpu/cli/main.py: the same parser (plus --device) and the
same main — FASTA index build or --tt-index reuse, known events, GTF
junctions and the transcriptome index (-G, --transcriptome-index with its
build-only call, -T, -x, --no-gtf-juncs), colorspace input (-C) and the
chunked single-end and paired-end pipelines, with the coverage search on
by default, the butterfly and microexon searches, bowtie2 mode (--b2) and
fusion search (--fusion-search: FF/FR/RF fusions, XF:Z tags, fusions.out;
tophat-fusion-post is cli/fusion_post.py) on request. A genome longer
than --max-index-bases (by default the int32-safe MAX_GROUP_BASES) is
partitioned into contig groups, one FM index each (index/grouped.py,
cached as <prefix>.g<i>.tt.npz), and maps through pipeline/grouped.py.

Usage:
  python -m tophat_tpu_torch.cli.main -o out [--tt-index P] [-G genes.gtf] \
      genome.fa reads_1.fq [reads_2.fq]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import shutil
import sys

import numpy as np

from tophat_tpu_torch.index.fasta import encode_seq, read_fasta
from tophat_tpu_torch.index.fm import FMIndex, build_fm_index
from tophat_tpu_torch.index.grouped import MAX_GROUP_BASES, build_grouped_fm
from tophat_tpu_torch.io.color import encode_color_read, read_csfasta
from tophat_tpu_torch.io.fastq import read_all
from tophat_tpu_torch.io.gtf import (gtf_junctions, parse_gtf,
                                     validate_transcriptome,
                                     write_transcriptome_files)
from tophat_tpu_torch.ops.events import MAX_INS
from tophat_tpu_torch.ops.splice import (KIND_DELETION, KIND_INSERTION,
                                         KIND_JUNCTION)
from tophat_tpu_torch.parallel import auto
from tophat_tpu_torch.pipeline.colorspace import run_pipeline_color
from tophat_tpu_torch.pipeline.juncs import empty_events, merge_events
from tophat_tpu_torch.pipeline.paired import run_pipeline_paired_streaming
from tophat_tpu_torch.pipeline.params import Params
from tophat_tpu_torch.pipeline.run import (iter_read_batches, load_reads,
                                           resolve_device,
                                           run_pipeline_streaming)
from tophat_tpu_torch.pipeline.transcriptome import build_transcriptome_index
from tophat_tpu_torch.utils import trace
from tophat_tpu_torch.utils.log import StageLogger, get_resume_stage


def resolve_genome_path(prefix: str) -> str:
    for cand in (prefix, prefix + ".fa", prefix + ".fasta"):
        if os.path.isfile(cand):
            return cand
    raise SystemExit(f"Error: cannot find genome FASTA for '{prefix}' "
                     f"(tried {prefix}[.fa|.fasta])")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tophat_tpu_torch",
        description="GPU (PyTorch/CUDA) spliced read mapper "
                    "(TopHat-compatible)")
    p.add_argument("index", help="genome FASTA (or prefix with .fa)")
    p.add_argument("reads1", nargs="?", default=None,
                   help="comma-separated reads files (mate 1); may be "
                        "omitted with --transcriptome-index -G to only "
                        "build the transcriptome files")
    p.add_argument("reads2", nargs="?", default=None,
                   help="comma-separated reads files (mate 2)")
    p.add_argument("-o", "--output-dir", default="./tophat_out")
    p.add_argument("-N", "--read-mismatches", type=int, default=2)
    p.add_argument("--read-gap-length", type=int, default=2)
    p.add_argument("--read-edit-dist", type=int, default=2)
    p.add_argument("-g", "--max-multihits", type=int, default=20)
    p.add_argument("-M", "--prefilter-multihits", action="store_true",
                   help="discard reads with more than max-multihits "
                        "genomic placements before the spliced stages "
                        "(reference: prep_reads flt_reads, tophat.py:3995)")
    p.add_argument("--segment-length", type=int, default=25)
    p.add_argument("--segment-mismatches", type=int, default=2)
    p.add_argument("-a", "--min-anchor", type=int, default=8)
    p.add_argument("-m", "--splice-mismatches", type=int, default=0)
    p.add_argument("-i", "--min-intron-length", type=int, default=70)
    p.add_argument("-I", "--max-intron-length", type=int, default=500000)
    p.add_argument("--min-segment-intron", type=int, default=50)
    p.add_argument("--max-segment-intron", type=int, default=500000)
    p.add_argument("--max-insertion-length", type=int, default=3)
    p.add_argument("--max-deletion-length", type=int, default=3)
    p.add_argument("-r", "--mate-inner-dist", type=int, default=50)
    p.add_argument("--mate-std-dev", type=int, default=20)
    p.add_argument("-C", "--color", action="store_true",
                   help="SOLiD colorspace input (csfasta or "
                        "primer+digit FASTQ)")
    p.add_argument("-Q", "--quals", default=None,
                   help="colorspace quality (_QV.qual) files, "
                        "comma-separated, mate 1")
    p.add_argument("--quals2", default=None,
                   help="colorspace quality files, mate 2")
    p.add_argument("--solexa-quals", action="store_true")
    p.add_argument("--solexa1.3-quals", "--phred64-quals",
                   dest="phred64_quals", action="store_true")
    p.add_argument("--allow-indels", action="store_true",
                   help="legacy flag (indels are on by default)")
    p.add_argument("--no-novel-indels", action="store_true")
    p.add_argument("--v114-defaults", action="store_true",
                   help="emulate the TopHat 1.1.4 driver defaults the "
                        "regression golds were produced with: novel indel "
                        "discovery requires --allow-indels (the 1.1.4 "
                        "driver passed /dev/null for segment.insertions/"
                        ".deletions to juncs_db and long_spanning_reads "
                        "unless --allow-indels was given; see the "
                        "test_3Segment gold run.log vs test_SimpleIndel's)")
    p.add_argument("--insertions", default=None,
                   help="known insertions BED to include")
    p.add_argument("--deletions", default=None,
                   help="known deletions BED to include")
    p.add_argument("-j", "--raw-juncs", default=None,
                   help="known junctions (.juncs) to include")
    p.add_argument("-G", "--GTF", dest="gtf", default=None,
                   help="gene model annotations (GTF/GFF2) — known "
                        "junctions auto-accepted")
    p.add_argument("--transcriptome-index", default=None,
                   help="dir/prefix of transcriptome data files (.fa, "
                        ".fa.tlst, .gff, .ver) to build or reuse; known "
                        "junctions feed the event table directly — no "
                        "separate aligner index round-trip is needed")
    p.add_argument("--no-novel-juncs", action="store_true")
    p.add_argument("--no-coverage-search", action="store_true")
    p.add_argument("--coverage-search", action="store_true")
    p.add_argument("--microexon-search", action="store_true",
                   help="window search for junctions flanking microexons "
                        "(reference: align_microexon_segs)")
    p.add_argument("--butterfly-search", action="store_true",
                   help="mer-extendable GT-AG pairing across coverage "
                        "islands (reference: pair_covered_sites)")
    p.add_argument("--min-coverage-intron", type=int, default=50)
    p.add_argument("--max-coverage-intron", type=int, default=20000)
    p.add_argument("--bowtie1", action="store_true",
                   help="accepted for compatibility; no external aligner")
    p.add_argument("--b2", "--bowtie2", dest="bowtie2", action="store_true",
                   help="bowtie2-mode initial alignment: direct gapped "
                        "alignment of unmapped reads under the driver "
                        "score floor 6*mm+5+3*gap <= 6*read-edit-dist+2 "
                        "(reference: tophat.py:2253-2337); finds small "
                        "indels without segment search")
    p.add_argument("--b2-mp", default="6,2",
                   help="bowtie2-mode max,min mismatch penalties "
                        "(scoring + admission)")
    p.add_argument("--b2-rdg", default="5,3",
                   help="bowtie2-mode read-gap open,extend penalties")
    p.add_argument("--b2-rfg", default="5,3",
                   help="bowtie2-mode reference-gap open,extend penalties")
    p.add_argument("--b2-score-min", default="",
                   help="bowtie2-mode minimum score function "
                        "(C,a[,b] or L,a,b in read length)")
    for _pre in ("very-fast", "fast", "sensitive", "very-sensitive"):
        p.add_argument(f"--b2-{_pre}", dest=f"b2_{_pre.replace('-', '_')}",
                       action="store_true",
                       help="bowtie2 seeding preset (accepted for "
                            "compatibility: seeding here is exact)")
    for _flg, _d in (("N", 0), ("L", 20), ("D", 15), ("R", 2),
                     ("gbar", 4), ("np", 1)):
        p.add_argument(f"--b2-{_flg}", type=int, default=_d,
                       help="bowtie2 seeding/penalty knob (accepted for "
                            "compatibility)")
    p.add_argument("--b2-i", default="S,1,1.25",
                   help="bowtie2 seed interval function (accepted for "
                        "compatibility)")
    p.add_argument("--fusion-search", action="store_true")
    p.add_argument("--fusion-anchor-length", type=int, default=20)
    p.add_argument("--fusion-min-dist", type=int, default=10000000)
    p.add_argument("--fusion-read-mismatches", type=int, default=2)
    p.add_argument("--fusion-do-not-resolve-conflicts", action="store_true",
                   help="accepted for compatibility")
    p.add_argument("--keep-tmp", action="store_true",
                   help="accepted for compatibility")
    p.add_argument("--keep-fasta-order", action="store_true",
                   help="accepted for compatibility (contig order always "
                        "follows the FASTA)")
    p.add_argument("--no-sort-bam", action="store_true",
                   help="emit alignments in read order instead of "
                        "coordinate order")
    p.add_argument("--no-convert-bam", action="store_true",
                   help="skip BAM emission (accepted_hits.sam only)")
    p.add_argument("--no-mixed", action="store_true",
                   help="paired runs: suppress half-mapped pairs")
    p.add_argument("--no-discordant", action="store_true",
                   help="paired runs: report only concordant pairs")
    p.add_argument("--report-secondary-alignments", action="store_true",
                   help="also report alignments scoring below the best "
                        "tier (up to max-multihits)")
    p.add_argument("--rg-id", default="", help="read group ID (emits the "
                   "@RG header line and RG:Z tags; requires --rg-sample)")
    p.add_argument("--rg-sample", default="", help="read group sample (SM)")
    p.add_argument("--rg-library", default="", help="read group library (LB)")
    p.add_argument("--rg-description", default="",
                   help="read group description (DS)")
    p.add_argument("--rg-platform-unit", default="",
                   help="read group platform unit (PU)")
    p.add_argument("--rg-platform", default="",
                   help="read group sequencing platform (PL)")
    p.add_argument("--rg-center", default="",
                   help="read group sequencing center (CN)")
    p.add_argument("--rg-date", default="", help="read group run date (DT)")
    p.add_argument("--no-gtf-juncs", action="store_true",
                   help="do not auto-accept junctions from -G/--GTF: "
                        "annotated junctions must pass the same support "
                        "filter as novel ones (reference: tophat.py:94 — "
                        "skips the gtf_juncs known-junction stage)")
    p.add_argument("-T", "--transcriptome-only", action="store_true",
                   help="map reads only to the -G transcriptome; no "
                        "genomic mapping or novel junction discovery")
    p.add_argument("-x", "--transcriptome-max-hits", type=int, default=60,
                   help="reads with more transcriptome mappings than this "
                        "are discarded")
    p.add_argument("--integer-quals", action="store_true",
                   help="qualities are space-delimited integers "
                        "(phred values), not ASCII")
    p.add_argument("--fusion-ignore-chromosomes", default="",
                   help="comma-separated contig names to exclude from "
                        "fusion break point detection (e.g. chrM)")
    p.add_argument("--fusion-multireads", type=int, default=2,
                   help="reads mapping to more than this many places do "
                        "not count as fusion support")
    p.add_argument("--fusion-multipairs", type=int, default=2,
                   help="pairs mapping to more than this many places do "
                        "not count as fusion pair support")
    p.add_argument("--read-realign-edit-dist", type=int, default=None,
                   help="realign reads whose best contiguous alignment "
                        "has at least this edit distance through the "
                        "spliced stages too (default: read-edit-dist + 1, "
                        "i.e. never)")
    p.add_argument("--library-type", default="fr-unstranded",
                   choices=["fr-unstranded", "fr-firststrand",
                            "fr-secondstrand"],
                   help="strand-specific protocols restrict which splice "
                        "directions each read may support "
                        "(reference: segment_juncs.cpp:2110)")
    p.add_argument("--v2-sam", action="store_true",
                   help="TopHat 2.1.2 SAM conventions (proper-pair flag, "
                        "TLEN, MAPQ 50/3/1/0) instead of the gold v1.1.4 "
                        "regression conventions")
    p.add_argument("-p", "--num-threads", type=int, default=1,
                   help="accepted for compatibility (the port runs on one "
                        "device)")
    p.add_argument("--device", default="cuda",
                   help="torch device for the device stages (default cuda; "
                        "raises when CUDA is absent — pass cpu explicitly)")
    p.add_argument("--batch-size", type=int, default=16384,
                   help="reads per device batch (larger inputs stream "
                        "through the chunked pipeline)")
    p.add_argument("--tt-index", default=None,
                   help="path (or prefix) for the genome FM index: loaded "
                        "if present, else built and saved — the durable "
                        "index artifact role of bowtie-build "
                        "(reference: tophat.py:2600)")
    p.add_argument("--max-index-bases", type=int, default=None,
                   help="per-index base cap; genomes larger than this "
                        "split into contig groups with one FM index each "
                        "(default: the int32-safe ~2.0 Gbp limit)")
    p.add_argument("--trace", action="store_true",
                   help="time the pipeline's stages (wall, self and CPU "
                        "seconds) and count its host syncs, realign "
                        "launches, events, rows and records into "
                        "logs/trace.json")
    return p


def load_known_events(genome, ins_path, del_path, juncs_path):
    """-j / --insertions / --deletions files as one known-event table at
    global positions (int64 on a genome past the int32 range), or None."""
    name2id = genome.name_to_id()
    dtype = genome.pos_dtype
    tables = [empty_events()]

    def to_global(name, pos):
        return int(genome.offsets[name2id[name]]) + int(pos)

    if ins_path:
        lefts, seqs = [], []
        with open(ins_path) as f:
            for line in f:
                if line.startswith("track") or not line.strip():
                    continue
                t = line.split("\t")
                # insertions.bed stores `left` raw (last base before the
                # insert, 0-based) — see insertions.cpp print_insertions
                lefts.append(to_global(t[0], int(t[1])))
                seqs.append(t[3].strip())
        ins_seq = np.full((len(lefts), MAX_INS), -1, np.int8)
        for i, s in enumerate(seqs):
            c = encode_seq(s)[:MAX_INS]
            ins_seq[i, : len(c)] = c
        tables.append(dict(
            left=np.array(lefts, dtype),
            right=np.array(lefts, dtype) + 1,
            kind=np.full(len(lefts), KIND_INSERTION, np.int8),
            antisense=np.zeros(len(lefts), bool),
            ins_len=np.array([min(len(s), MAX_INS) for s in seqs], np.int8),
            ins_seq=ins_seq))
    if del_path:
        lefts, rights = [], []
        with open(del_path) as f:
            for line in f:
                if line.startswith("track") or not line.strip():
                    continue
                t = line.split("\t")
                lefts.append(to_global(t[0], int(t[1]) - 1))
                rights.append(to_global(t[0], int(t[2])))
        tables.append(dict(
            left=np.array(lefts, dtype), right=np.array(rights, dtype),
            kind=np.full(len(lefts), KIND_DELETION, np.int8),
            antisense=np.zeros(len(lefts), bool),
            ins_len=np.zeros(len(lefts), np.int8),
            ins_seq=np.full((len(lefts), MAX_INS), -1, np.int8)))
    if juncs_path:
        lefts, rights, anti = [], [], []
        with open(juncs_path) as f:
            for line in f:
                if not line.strip():
                    continue
                t = line.split("\t")
                lefts.append(to_global(t[0], int(t[1])))
                rights.append(to_global(t[0], int(t[2])))
                anti.append(t[3].strip() == "-")
        tables.append(dict(
            left=np.array(lefts, dtype), right=np.array(rights, dtype),
            kind=np.full(len(lefts), KIND_JUNCTION, np.int8),
            antisense=np.array(anti, bool),
            ins_len=np.zeros(len(lefts), np.int8),
            ins_seq=np.full((len(lefts), MAX_INS), -1, np.int8)))
    ev = merge_events(*tables)
    return ev if len(ev["left"]) else None


def _index_design_point(big: bool):
    """(kmer_k, sa_rate) for in-process index builds. Defaults: k=13
    seed table + 1/4-sampled SA beyond 256 Mbp (conservative HBM
    footprint; PERF.md's sweep shows k=14/sa_rate=2 is ~26% faster at
    1 Gbp when the extra ~2.5 GiB HBM is available). Overridable with
    $TOPHAT_TPU_KMER_K / $TOPHAT_TPU_SA_RATE (the JAX package's names, so
    both packages build the same index)."""
    kk = int(os.environ.get("TOPHAT_TPU_KMER_K", 13 if big else 0))
    sr = int(os.environ.get("TOPHAT_TPU_SA_RATE", 4 if big else 0))
    return kk, sr


def group_indexes(genome, index: str, max_bases: int, tt_index=None,
                  log=None):
    """The contig-group FM indexes of a genome past `max_bases`, as both
    CLIs take them: cached under `tt_index`, else beside the genome FASTA
    where its directory is writable (so tophat-fusion-post, which takes
    the run's genome argument, reuses the caches a run left), built at
    the index design point."""
    cache_prefix = tt_index
    if cache_prefix is None:
        cand = resolve_genome_path(index)
        cache_prefix = cand if os.access(os.path.dirname(cand) or ".",
                                         os.W_OK) else None
    kk, sr = _index_design_point(genome.n > (1 << 28))
    return build_grouped_fm(genome, max_bases=max_bases, kmer_k=kk,
                            sa_rate=sr, cache_prefix=cache_prefix, log=log)


def _color_records(files, qual_csv, params):
    """(name, primer, colors, qual) records of colorspace reads files:
    .csfasta (with an optional _QV.qual file each) or colorspace FASTQ."""
    quals = qual_csv.split(",") if qual_csv else []
    recs = []
    for i, path in enumerate(files):
        qp = quals[i] if i < len(quals) else None
        if ".csfasta" in os.path.basename(path):
            recs.extend(read_csfasta(path, qp))
        else:
            for name, seq, qual in read_all(path, params.quals_scale):
                primer, colors = encode_color_read(seq)
                q = qual[1:] if len(qual) == len(seq) else qual
                recs.append((name, primer, colors, q))
    return recs


def params_from_args(args) -> Params:
    return Params(
        read_mismatches=args.read_mismatches,
        read_gap_length=args.read_gap_length,
        read_edit_dist=args.read_edit_dist,
        bowtie2=args.bowtie2,
        max_multihits=args.max_multihits,
        segment_length=args.segment_length,
        segment_mismatches=args.segment_mismatches,
        min_anchor_len=args.min_anchor,
        splice_mismatches=args.splice_mismatches,
        min_intron_length=args.min_intron_length,
        max_intron_length=args.max_intron_length,
        min_segment_intron=args.min_segment_intron,
        max_segment_intron=args.max_segment_intron,
        max_insertion_length=args.max_insertion_length,
        max_deletion_length=args.max_deletion_length,
        allow_indels=(not args.no_novel_indels
                      and (args.allow_indels or not args.v114_defaults)),
        inner_dist_mean=args.mate_inner_dist,
        inner_dist_std_dev=args.mate_std_dev,
        quals_scale=("phred64" if args.phred64_quals
                     else "solexa" if args.solexa_quals else "phred33"),
        coverage_search=args.coverage_search or not args.no_coverage_search,
        microexon_search=args.microexon_search,
        butterfly_search=args.butterfly_search,
        min_coverage_intron=args.min_coverage_intron,
        max_coverage_intron=args.max_coverage_intron,
        fusion_search=args.fusion_search,
        fusion_anchor_length=args.fusion_anchor_length,
        fusion_min_dist=args.fusion_min_dist,
        fusion_read_mismatches=args.fusion_read_mismatches,
        batch_size=args.batch_size,
        prefilter_multihits=args.prefilter_multihits,
        no_mixed=args.no_mixed,
        no_discordant=args.no_discordant,
        report_secondary=args.report_secondary_alignments,
        library_type=args.library_type,
        v2_sam=args.v2_sam,
        no_sort_bam=args.no_sort_bam,
        no_convert_bam=args.no_convert_bam,
        b2_mp=args.b2_mp, b2_rdg=args.b2_rdg, b2_rfg=args.b2_rfg,
        b2_score_min=args.b2_score_min,
        b2_preset=next((x for x in ("very-fast", "fast", "sensitive",
                                    "very-sensitive")
                        if getattr(args, "b2_" + x.replace("-", "_"))),
                       ""),
        rg_id=args.rg_id, rg_sample=args.rg_sample,
        rg_library=args.rg_library, rg_description=args.rg_description,
        rg_platform_unit=args.rg_platform_unit,
        rg_platform=args.rg_platform, rg_center=args.rg_center,
        rg_date=args.rg_date,
        transcriptome_only=args.transcriptome_only,
        transcriptome_max_hits=args.transcriptome_max_hits,
        integer_quals=args.integer_quals,
        fusion_ignore_chromosomes=args.fusion_ignore_chromosomes,
        fusion_multireads=args.fusion_multireads,
        fusion_multipairs=args.fusion_multipairs,
        read_realign_edit_dist=(args.read_realign_edit_dist
                                if args.read_realign_edit_dist is not None
                                else -1),
    )


def main(argv=None, resume=False):
    argv = list(argv) if argv is not None else sys.argv[1:]
    # -R/--resume <dir>: replay the original invocation recorded in the
    # stage journal, reusing completed mapping chunks
    if argv and argv[0] in ("-R", "--resume"):
        if len(argv) < 2:
            raise SystemExit("Error: -R/--resume requires the output dir")
        out_dir = argv[1]
        run_log = os.path.join(out_dir, "logs", "run.log")
        if not os.path.exists(run_log):
            raise SystemExit(f"Error: no run.log under {out_dir!r} to resume")
        orig = None
        last = get_resume_stage(out_dir)
        with open(run_log) as f:
            for line in f:
                if line.startswith("#>start: tophat_tpu "):
                    orig = line[len("#>start: tophat_tpu "):].strip().split()
        if last == "alldone":
            print(f"[resume] {out_dir}: run already complete", file=sys.stderr)
            return 0
        print(f"[resume] re-running from stage {last!r}; completed "
              f"mapping chunks will be reused", file=sys.stderr)
        return main(orig, resume=True)

    args = build_parser().parse_args(argv)
    if bool(args.rg_id) != bool(args.rg_sample):
        raise SystemExit("Error: --rg-id and --rg-sample must be "
                         "specified or omitted together")
    params = params_from_args(args)
    if args.transcriptome_only and not (args.gtf
                                        or args.transcriptome_index):
        raise SystemExit("Error: -T/--transcriptome-only requires "
                         "-G/--GTF or --transcriptome-index")
    device = resolve_device(args.device)

    out_dir = args.output_dir
    os.makedirs(out_dir, exist_ok=True)
    logger = StageLogger(out_dir, argv=argv or sys.argv[1:])
    # a mesh over every visible card (parallel/auto.py); it must not leak
    # into the next in-process run
    auto.auto_activate(device, log=logger.log)
    if args.trace:
        trace.reset()
        trace.enable()
    try:
        return _run(args, params, device, resume, logger)
    finally:
        auto.deactivate()
        if args.trace:
            trace.disable()
            snap = trace.snapshot()
            del snap["records"]
            with open(os.path.join(logger.logs_dir, "trace.json"), "w") as f:
                json.dump(snap, f, indent=1)


def _run(args, params, device, resume, logger):
    out_dir = args.output_dir
    genome = read_fasta(resolve_genome_path(args.index))

    # whole-genome scale: beyond the int32-safe cap the genome partitions
    # into contig groups, one FM index per group (index/grouped.py); the
    # pipeline merges at int64 global coordinates (pipeline/grouped.py)
    max_index_bases = args.max_index_bases or MAX_GROUP_BASES
    gfm = None
    fm = None
    if genome.n > max_index_bases:
        gfm = group_indexes(genome, args.index, max_index_bases,
                            tt_index=args.tt_index, log=logger.log)
        logger.log(f"genome partitioned into {gfm.n_groups} contig groups")
    elif args.tt_index:
        path = args.tt_index if args.tt_index.endswith(".npz") \
            else args.tt_index + ".tt.npz"
        if os.path.exists(path):
            fm = FMIndex.load(path, device=device)
            if fm.n != genome.n:
                raise SystemExit(f"Error: {path} was built for a different "
                                 "genome")
            logger.log(f"genome FM index: reusing {path}")
        else:
            kk, sr = _index_design_point(genome.n > (1 << 28))
            fm = build_fm_index(genome, kmer_k=kk, sa_rate=sr, device=device)
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            fm.save(path)
            logger.log(f"genome FM index: saved {path}")

    known = load_known_events(genome, args.insertions, args.deletions,
                              args.raw_juncs)
    gtf_accept = None
    transcripts = None
    gtf_path = args.gtf
    tprefix = None
    if args.transcriptome_index:
        # --transcriptome-index semantics (reference: src/tophat.py:3915-
        # 3947): a dir gets the GTF basename appended; a valid prebuilt set
        # is reused (its .gff becomes the annotation), otherwise the data
        # files are (re)built from -G.
        tprefix = args.transcriptome_index
        if os.path.isdir(tprefix) or tprefix.endswith(os.sep):
            if not gtf_path:
                raise SystemExit("Error: --transcriptome-index names a "
                                 "directory but no -G/--GTF was given")
            base = os.path.basename(gtf_path)
            base = base[: base.rfind(".")] if "." in base else base
            os.makedirs(tprefix, exist_ok=True)
            tprefix = os.path.join(tprefix, base)
        if validate_transcriptome(tprefix):
            logger.log(f"transcriptome index: reusing {tprefix}.*")
            gtf_path = tprefix + ".gff"
        elif gtf_path:
            d = os.path.dirname(tprefix)
            if d:
                os.makedirs(d, exist_ok=True)
            transcripts = parse_gtf(gtf_path)
            write_transcriptome_files(tprefix, genome, transcripts, gtf_path)
            logger.log(f"transcriptome index: built {tprefix}.*")
        else:
            raise SystemExit(f"Error: transcriptome files at {tprefix!r} "
                             "are missing/invalid and no -G/--GTF given")
    trans = None
    if gtf_path:
        if transcripts is None:
            transcripts = parse_gtf(gtf_path)
        gtf_ev, gtf_accept = gtf_junctions(genome, transcripts)
        if args.no_gtf_juncs:
            # --no-gtf-juncs: annotated junctions stay in the event table
            # (transcriptome hits still rebase through them) but get no
            # automatic acceptance in filter_junctions
            gtf_accept = None
        logger.log(f"GTF: {len(transcripts)} transcripts, "
                   f"{len(gtf_ev['left'])} known junctions")
        known = merge_events(known, gtf_ev) if known is not None else gtf_ev
        # _reads_vs_T: transcriptome FM index on the run's device (persisted
        # beside the --transcriptome-index data files when given)
        trans = build_transcriptome_index(genome, transcripts,
                                          prefix=tprefix, log=logger.log,
                                          device=device)

    if args.reads1 is None:
        # transcriptome build-only invocation (reference:
        # transcriptome_buildonly, src/tophat.py:3948-3952)
        if not args.transcriptome_index:
            raise SystemExit("Error: reads files required (or "
                             "--transcriptome-index -G to build only)")
        logger.log("Transcriptome files prepared. This was the only task "
                   "requested.")
        logger.stage("alldone")
        return 0

    files1 = args.reads1.split(",")
    logger.stage("prep_reads")
    if args.color:
        # SOLiD colorspace path (-C): color-native genome alignment +
        # reference-guided decode, then the standard base-space pipeline
        recs1 = _color_records(files1, args.quals, params)
        recs2 = (_color_records(args.reads2.split(","), args.quals2, params)
                 if args.reads2 else None)
        run_pipeline_color(genome, recs1, params, out_dir, records2=recs2,
                           fm=fm, known_events=known, gtf_accept=gtf_accept,
                           log=logger.log, device=device)
        logger.stage("alldone")
        return 0
    if gfm is not None and not args.reads2:
        # contig groups: the whole read set as one chunk, no artifacts
        batch = load_reads(files1, params.quals_scale,
                           integer_quals=params.integer_quals)
        run_pipeline_streaming(genome, [batch], params, out_dir, gfm=gfm,
                               known_events=known, gtf_accept=gtf_accept,
                               trans=trans, log=logger.log, device=device)
        logger.stage("alldone")
        return 0
    batches = iter_read_batches(files1, params.quals_scale,
                                params.batch_size,
                                integer_quals=params.integer_quals)
    if args.reads2:
        batches2 = iter_read_batches(args.reads2.split(","),
                                     params.quals_scale, params.batch_size,
                                     integer_quals=params.integer_quals)
        run_pipeline_paired_streaming(
            genome, zip(batches, batches2), params, out_dir, fm=fm, gfm=gfm,
            known_events=known, gtf_accept=gtf_accept, trans=trans,
            log=logger.log, device=device)
    else:
        first = next(batches, None)
        if first is None:
            raise SystemExit("Error: no reads in input")
        run_pipeline_streaming(
            genome, itertools.chain([first], batches), params, out_dir,
            fm=fm, known_events=known, gtf_accept=gtf_accept, trans=trans,
            tmp_dir=os.path.join(out_dir, "tmp"), resume=resume,
            log=logger.log, device=device)
    logger.stage("alldone")
    if not args.keep_tmp:
        shutil.rmtree(os.path.join(out_dir, "tmp"), ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
