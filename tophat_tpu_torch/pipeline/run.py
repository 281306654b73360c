"""End-to-end pipeline on one device (single-end here; paired-end runs
drive these stages from pipeline/paired.py).

Port of tophat_tpu/pipeline/run.py (the spliced_alignment +
compile_reports flow of the reference driver, src/tophat.py:3428, :2665):
  prep -> transcriptome mapping (-G) -> full-read genome alignment -> IUM
  segmentation -> segment mapping -> contiguous stitch (+ bowtie2-mode
  gapped alignment) -> junction/indel discovery (+ the coverage,
  butterfly and microexon searches) -> event realignment -> default-mode
  chains -> pass-1 stats + filter -> pass-2 selection -> outputs
With fusion search, discovery adds FF fusion events, and each mate's
candidates add FR/RF fusions (ops/fusion_fr.py) and chains over every row,
cross-strand ones included (pipeline/chains.py).
Device stages take torch tensors on `device`; every crossing back to the
host is an explicit, counted read (utils/trace.to_host; np.asarray of a
CUDA tensor raises).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
import types
from typing import Dict, List, Optional

import numpy as np
import torch

from tophat_tpu_torch.index.fasta import Genome
from tophat_tpu_torch.index.fm import (FMIndex, build_fm_index,
                                       default_kmer_k, host_codes)
from tophat_tpu_torch.io.fastq import ReadBatch, batch_reads, read_all
from tophat_tpu_torch.ops.align import (Alignments, align_reads_adaptive,
                                        kmer_fast_ok, transfer_alignments)
from tophat_tpu_torch.ops.events import realign_events_sparse
from tophat_tpu_torch.ops.fusion_fr import find_fr_fusions
from tophat_tpu_torch.ops.gapped import gapped_from_segments
from tophat_tpu_torch.ops.splice import KIND_FUSION
from tophat_tpu_torch.ops.stitch import stitch_contiguous
from tophat_tpu_torch.parallel import auto
from tophat_tpu_torch.pipeline.butterfly import (butterfly_search_events,
                                                 microexon_events)
from tophat_tpu_torch.pipeline.chains import (chain_stitch,
                                              cross_strand_chains,
                                              segment_event_hits, subset_rows)
from tophat_tpu_torch.pipeline.coverage import coverage_search_events
from tophat_tpu_torch.pipeline.juncs import discover_events, merge_events
from tophat_tpu_torch.pipeline.params import Params
from tophat_tpu_torch.pipeline.prep import PrepStats, prep_filter
from tophat_tpu_torch.pipeline.report import (Candidate,
                                              accumulate_event_stats,
                                              collect_candidates,
                                              filter_junctions, select_best,
                                              write_outputs,
                                              write_outputs_multi)
from tophat_tpu_torch.pipeline.segment import (build_genome_space,
                                               map_segments)
from tophat_tpu_torch.pipeline.transcriptome import (
    map_reads_transcriptome, transcriptome_candidates)
from tophat_tpu_torch.utils import trace
from tophat_tpu_torch.utils.device import resolve_device


def revcomp_rows(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """(B, L) left-aligned codes -> revcomp rows, still left-aligned."""
    B, L = codes.shape
    if B == 0:
        return codes.copy()
    lengths = np.asarray(lengths)
    src = lengths[:, None] - 1 - np.arange(L)[None, :]
    ok = src >= 0
    g = np.take_along_axis(codes, np.clip(src, 0, L - 1), axis=1)
    comp = np.where((g >= 0) & (g < 4), 3 - g, g)  # N/pad codes pass through
    return np.where(ok, comp, np.int8(-1)).astype(np.int8)


def load_reads(files: List[str], quals_scale: str,
               integer_quals: bool = False) -> ReadBatch:
    """Every record of the reads files as one ReadBatch."""
    records = []
    for path in files:
        records.extend(read_all(path, quals_scale,
                                integer_quals=integer_quals))
    return batch_reads(records)


def iter_read_batches(files: List[str], quals_scale: str, batch_size: int,
                      integer_quals: bool = False):
    """Stream (name, seq, qual) records into fixed-size ReadBatches. The
    parse of each batch is one `fastq.parse` span, closed before the batch
    is handed on."""
    records = itertools.chain.from_iterable(
        read_all(path, quals_scale, integer_quals=integer_quals)
        for path in files)
    while True:
        with trace.span("fastq.parse"):
            buf = list(itertools.islice(records, max(batch_size, 1)))
            batch = batch_reads(buf) if buf else None
        if batch is None:
            return
        yield batch


@dataclasses.dataclass
class MateState:
    """Per-batch intermediate state flowing between stages."""

    batch: ReadBatch
    keep: np.ndarray
    aln: Alignments
    gs: object
    prep_stats: object
    seg_tables: tuple = None   # (pos, mm, valid) (rows, S, H) tensors
    stitched: tuple = None     # (pos, mm, ok) (rows, H) contiguous chains
    cands: Optional[Dict[int, list]] = None
    gapped: list = None        # bowtie2-mode direct gapped results
    gapped_events: Optional[dict] = None
    trans_hits: Optional[dict] = None  # rebased transcriptome hits


def _align_mate(fm, offsets, batch: ReadBatch, params: Params, log,
                genome=None, trans=None):
    """Prep + transcriptome mapping + full-read genome alignment. Returns
    (MateState without spliced stages, ium mask, reads_f, reads_r,
    lengths)."""
    keep, prep_stats = prep_filter(batch)
    reads_f = batch.codes
    reads_r = revcomp_rows(batch.codes, batch.lengths)
    lengths = batch.lengths.astype(np.int32)

    # over-budget index + active mesh: range-shard the FM index over the
    # genome axis before the first device stage (parallel/auto.py)
    if auto.active() is not None and genome is not None and batch.size:
        auto.configure_genome_axis(fm, genome, int(lengths.max()), log=log)

    # transcriptome mapping first (_reads_vs_T): reads placed on annotated
    # transcripts skip the genome/segment path entirely, like the reference
    # feeding only m2g_unmapped into _reads_vs_G (tophat.py:3326, 3538)
    trans_hits = None
    has_t = np.zeros(batch.size, bool)
    if trans is not None and genome is not None and trans.n:
        trans_hits = map_reads_transcriptome(trans, genome, reads_f,
                                             reads_r, lengths, params)
        # -x/--transcriptome-max-hits: reads with more transcriptome
        # placements are discarded — they neither report nor continue to
        # the genome stages
        tmax = getattr(params, "transcriptome_max_hits", 0)
        if tmax:
            over = [r for r, h in trans_hits.items() if len(h) > tmax]
            for r in over:
                del trans_hits[r]
                has_t[r] = True      # discarded, not IUM
            if over:
                log(f"transcriptome map: {len(over)} reads discarded "
                    f"(> {tmax} transcriptome hits)")
        for r in trans_hits:
            has_t[r] = True
        log(f"transcriptome map: {int(has_t.sum())} reads placed on "
            f"annotated transcripts")

    if getattr(params, "transcriptome_only", False):
        # -T/--transcriptome-only: report only transcriptome placements;
        # nothing maps to the genome and no spliced discovery runs
        B, M = batch.size, 1
        aln = Alignments(pos=np.zeros((B, M), np.int32),
                         strand=np.zeros((B, M), np.int8),
                         mm=np.zeros((B, M), np.int8),
                         valid=np.zeros((B, M), bool),
                         n_hits=np.zeros(B, np.int32),
                         truncated=np.zeros(B, bool))
        m = MateState(batch=batch, keep=keep, aln=aln, gs=None,
                      prep_stats=prep_stats, trans_hits=trans_hits)
        return m, np.zeros(B, bool), reads_f, reads_r, lengths

    min_len = int(lengths.min()) if len(lengths) else 0
    max_len = int(lengths.max()) if len(lengths) else 0
    aln = align_reads_adaptive(
        fm, reads_f, reads_r, lengths, offsets,
        max_mismatches=params.read_mismatches,
        max_alignments=params.max_alignments,
        kmer_fast=kmer_fast_ok(fm, min_len, params.read_mismatches),
        narrow_hits=min(8, params.hits_per_seed),
        wide_hits=params.hits_per_seed,
        uniform_len=min_len if min_len == max_len else 0)
    aln = transfer_alignments(aln)          # device -> host boundary
    if params.prefilter_multihits:
        # -M/--prefilter-multihits: reads with more than max_multihits
        # genomic placements are dropped before any spliced stage
        keep = keep & ~(aln.n_hits > params.max_multihits)
    valid = aln.valid & keep[:, None]
    n_hits = np.where(keep, aln.n_hits, 0)
    aln = dataclasses.replace(aln, valid=valid, n_hits=n_hits)
    ium = keep & (n_hits == 0) & ~has_t
    # --read-realign-edit-dist: mapped reads whose best contiguous
    # alignment has at least this edit distance also enter the spliced
    # stages. Default (read_edit_dist + 1) realigns none.
    rre = getattr(params, "read_realign_edit_dist", -1)
    if rre < 0:
        rre = params.read_edit_dist + 1
    if rre <= params.read_edit_dist:
        mm_t = np.where(valid, aln.mm.astype(np.int32), 127)
        best_mm = mm_t.min(axis=1, initial=127)
        ium |= keep & ~has_t & (n_hits > 0) & (best_mm >= rre)
    log(f"genome map: {int((n_hits > 0).sum())} mapped, {int(ium.sum())} IUM")
    m = MateState(batch=batch, keep=keep, aln=aln, gs=None,
                  prep_stats=prep_stats, trans_hits=trans_hits)
    return m, ium, reads_f, reads_r, lengths


@trace.span("map.segments", sync=True)
def _spliced_mate(fm, offsets, m: MateState, params: Params,
                  ium, reads_f, reads_r, lengths, log=print) -> None:
    """Segment split + mapping + contiguous stitch (+ bowtie2-mode gapped
    alignment) for the IUM reads; fills gs/seg_tables/stitched/gapped on
    `m`."""
    gs = build_genome_space(reads_f, reads_r, lengths,
                            params.segment_length, row_mask=ium,
                            pad_rows_pow2=True)
    m.gs = gs
    trace.count("segments", int(gs.nseg[gs.read_idx >= 0].sum()))
    if gs.rows:
        m.seg_tables = map_segments(
            fm, offsets, gs, segment_mismatches=params.segment_mismatches,
            hits_per_seed=params.hits_per_seed, max_hits=16)
        st = stitch_contiguous(*m.seg_tables, gs.cuts, gs.nseg)
        m.stitched = tuple(trace.to_host(x) for x in st)
    if params.bowtie2 and m.seg_tables is not None:
        # bowtie2-mode direct gapped alignment of the IUM reads (no
        # segment-pair discovery needed; reference tophat.py:2253-2337)
        m.gapped_events, m.gapped = gapped_from_segments(
            fm.genome, gs, m.seg_tables, params, offsets=offsets)
        if m.gapped:
            log(f"bowtie2 gapped: {len(m.gapped)} direct indel alignments")


@trace.span("map", sync=True)
def _map_mate(fm, offsets, batch: ReadBatch, params: Params, log,
              genome=None, trans=None) -> MateState:
    m, ium, reads_f, reads_r, lengths = _align_mate(
        fm, offsets, batch, params, log, genome=genome, trans=trans)
    _spliced_mate(fm, offsets, m, params, ium, reads_f, reads_r, lengths,
                  log=log)
    return m


def _index_for(genome: Genome, fm: Optional[FMIndex], dev: torch.device,
               log) -> FMIndex:
    if fm is None:
        log("Building FM index...")
        return build_fm_index(genome, kmer_k=default_kmer_k(genome.n),
                              device=dev)
    return fm if fm.device == dev else fm.to(dev)


def _trans_for(trans, dev: torch.device):
    """The transcriptome index with its FM tables on `dev`."""
    if trans is None or trans.fm.device == dev:
        return trans
    return dataclasses.replace(trans, fm=trans.fm.to(dev))


def search_tables(fm, genome: Genome, m: MateState, params: Params,
                  log=None, coverage=True, extend=True) -> list:
    """Event tables of the searches switched on in `params` over one
    mate's segment hits, in the order coverage, butterfly, microexon
    (`coverage`/`extend` select the first or the other two)."""
    if m.seg_tables is None:
        return []
    out = []

    def add(ev, what):
        if log is not None and len(ev["left"]):
            log(what.format(len(ev["left"])))
        out.append(ev)

    if coverage and params.coverage_search:
        add(coverage_search_events(fm, genome, m.gs, m.seg_tables, params),
            "coverage search: {} island-end pairing candidates")
    if extend and params.butterfly_search:
        add(butterfly_search_events(fm, genome, m.gs, m.seg_tables, params),
            "butterfly search: {} extendable candidates")
    if extend and params.microexon_search:
        add(microexon_events(fm, genome, m.gs, m.seg_tables, params),
            "microexon search: {} window candidates")
    return out


def pipeline_core(genome: Genome, batches: List[ReadBatch], params: Params,
                  fm: Optional[FMIndex] = None,
                  known_events: Optional[Dict[str, np.ndarray]] = None,
                  gtf_accept=None, trans=None, log=print, device="cuda"):
    """Run prep/map/discover/realign/filter for 1 (single) or 2 (paired)
    read batches. Returns (mates, events, stats, accepted, fm)."""
    dev = resolve_device(device)
    fm = _index_for(genome, fm, dev, log)
    trans = _trans_for(trans, dev)
    offsets = genome.offsets.astype(np.int32)

    mates = [_map_mate(fm, offsets, b, params, log, genome=genome,
                       trans=trans) for b in batches]
    # joint discovery over every mate's IUM reads
    tables = [discover_events(fm, offsets, m.gs, params,
                              seg_tables=m.seg_tables, log=log,
                              read_side=mi)
              for mi, m in enumerate(mates)]
    for m in mates:
        tables += search_tables(fm, genome, m, params, log, extend=False)
    for m in mates:
        tables += search_tables(fm, genome, m, params, log, coverage=False)
    tables += [m.gapped_events for m in mates
               if m.gapped_events is not None]
    if known_events is not None:
        tables.append(known_events)
    events = merge_events(*tables)

    for m in mates:
        candidates_for_mate(fm, m, events, params, log,
                            paired=len(mates) > 1)

    # pass 1: stats + acceptance over all candidates
    stats, accepted = junction_stats(mates, events, params, gtf_accept)
    return mates, events, stats, accepted, fm


def _v2_score_of(params, mates, events, stats):
    """--v2-sam selection key: the AlignStatus coverage-scaled alignment
    score (pipeline/align_status.py); None keeps the gold v1 ranking."""
    if not getattr(params, "v2_sam", False):
        return None
    from tophat_tpu_torch.pipeline.align_status import v2_score_map

    smap = v2_score_map([m.cands for m in mates],
                        [m.batch.lengths for m in mates], events, stats)
    return lambda c: smap[id(c)]


@trace.span("junctions.filter")
def junction_stats(mates, events, params, gtf_accept):
    """Pass 1 over the mates' candidates: each event's stats, then
    filter_junctions; (stats, the accepted events)."""
    stats: Dict[int, object] = {}
    for m in mates:
        merge_stats(stats, accumulate_event_stats(
            m.cands, events, m.batch.lengths.astype(np.int32)))
    filter_junctions(events, stats, params, gtf_accept=gtf_accept)
    return stats, {e for e, st in stats.items() if st.accepted}


def merge_stats(into: Dict[int, object], other: Dict[int, object]) -> None:
    for e, st in other.items():
        if e in into:
            prev = into[e]
            prev.supporting += st.supporting
            prev.left_extent = max(prev.left_extent, st.left_extent)
            prev.right_extent = max(prev.right_extent, st.right_extent)
            prev.min_mm = min(prev.min_mm, st.min_mm)
        else:
            into[e] = st


@trace.span("candidates", sync=True)
def candidates_for_mate(fm, m: MateState, events, params, log,
                        paired=False, chain_default=True) -> None:
    """Realign one chunk/mate against the (global) event table and build
    its candidate lists, in the JAX package's order (candidate order feeds
    selection): collected candidates (with fusion search: chains over
    every row, cross-strand ones included), then the transcriptome
    placements (which replace a read's list), then the bowtie2-mode direct
    gapped candidates, then the FR/RF fusion candidates (fusion search) or
    default-mode chains for the reads still unresolved (otherwise).
    `paired` admits the pair-only short-anchor candidates;
    chain_default=False leaves the default-mode chains to the caller (the
    grouped pipeline, which knows the global resolved-read set)."""
    max_nseg = int(m.gs.nseg.max()) if m.gs.rows else 1
    realign_mm = params.segment_mismatches * max_nseg
    if m.gs.rows and len(events["left"]):
        ev = dict(events)
        ev["valid"] = np.ones(len(ev["left"]), bool)
        spl = realign_events_sparse(fm.genome, m.gs.readsg, m.gs.lengths,
                                    ev, max_mm=realign_mm)
    else:
        z = np.zeros(0, np.int32)
        spl = (z, z.copy(), z.copy(), z.copy())
    fusion = params.fusion_search and m.gs.rows
    fr_results = []
    fr_event_pairs = {"fr": (), "rf": ()}
    if fusion:
        fr_results = find_fr_fusions(fm, m.gs, m.seg_tables, params)
        for res in fr_results:
            pairs = sorted({(int(a), int(b)) for a, b in
                            zip(res["posA"], res["posB"])}
                           | {(int(b), int(a)) for a, b in
                              zip(res["posA"], res["posB"])})
            fr_event_pairs[res["pattern"]] = tuple(pairs)[:64]
    chain_cands = None
    if fusion and len(events["left"]):
        # one dense realign of the segments serves both chain searches
        seg_hits = segment_event_hits(fm, m.gs, events, params)
        chain_cands = chain_stitch(fm, m.gs, m.seg_tables, events, params,
                                   seg_hits=seg_hits)
        chain_cands += cross_strand_chains(fm, m.gs, m.seg_tables, events,
                                           params, fr_events=fr_event_pairs,
                                           seg_hits=seg_hits)
        if chain_cands:
            log(f"chain stitch: {len(chain_cands)} multi-event chains")
    m.cands = collect_candidates(m.aln, m.gs, events, *spl, params,
                                 stitched=m.stitched,
                                 genome_codes=host_codes(fm),
                                 chain_cands=chain_cands, paired=paired)

    # transcriptome-mapped reads report ONLY their rebased transcript hits
    # (the reference never genome-maps them: only m2g_unmapped feeds
    # _reads_vs_G, tophat.py:3326)
    if m.trans_hits:
        for r, lst in transcriptome_candidates(m.trans_hits, events,
                                               params).items():
            m.cands[r] = lst
    if m.gapped:
        _gapped_candidates(m, events, log)
    if fusion:
        _fr_candidates(m, fr_results, log)
    if chain_default and not params.fusion_search:
        default_chains(fm, m, events, params, log)


def _fr_candidates(m: MateState, fr_results, log) -> None:
    """Cross-strand (FR/RF) fusion candidates, appended after the others."""
    nfr = 0
    for res in fr_results:
        for rr, t, pa, pb, mm2 in zip(res["read"], res["t"], res["posA"],
                                      res["posB"], res["mm"]):
            read = int(m.gs.read_idx[int(rr)])
            if read < 0:  # pow2 padding row
                continue
            rl = int(m.gs.lengths[int(rr)])
            t = int(t)
            if t < 3 or rl - t < 3:  # record-geometry floor; the 20bp
                continue             # rule gates counting, not reporting
            pos = int(pa) - t + 1 if res["pattern"] == "fr" else int(pa)
            c = Candidate(read=read, pos=pos, strand=0, mm=int(mm2),
                          kind=KIND_FUSION, ev=-1, t=t,
                          fdir=res["pattern"], fpos2=int(pb))
            lst = m.cands.setdefault(read, [])
            if not any(x.kind == KIND_FUSION and x.pos == c.pos
                       and x.t == c.t and x.fdir == c.fdir for x in lst):
                lst.append(c)
                nfr += 1
    if nfr:
        log(f"cross-strand fusion candidates: {nfr}")


def _gapped_candidates(m: MateState, events, log) -> None:
    """Bowtie2-mode direct gapped candidates: they bypass the segment-path
    indel admission (they come straight from the initial aligner)."""
    ev_index = {}
    for i in range(len(events["left"])):
        ev_index[(int(events["kind"][i]), int(events["left"][i]),
                  int(events["right"][i]))] = i
    nb2 = 0
    for row, pos, t, gap, mm2, key in m.gapped:
        read = int(m.gs.read_idx[row])
        if read < 0:
            continue
        ev = ev_index.get(key, -1)
        if ev < 0:
            continue
        c = Candidate(read=read, pos=pos, strand=int(m.gs.strand[row]),
                      mm=mm2, kind=int(events["kind"][ev]), ev=ev, t=t,
                      gap=abs(gap), record_ok=True)
        lst = m.cands.setdefault(read, [])
        if not any(x.kind == c.kind and x.ev == ev and x.t == t
                   and x.pos == pos for x in lst):
            lst.append(c)
            nb2 += 1
    if nb2:
        log(f"bowtie2 direct candidates: {nb2}")


@trace.span("candidates.chains", sync=True)
def default_chains(fm, m: MateState, events, params, log,
                   resolved=None) -> None:
    """Multi-event chains for the default (non-fusion) mode: a read crossing
    >= 2 events has no contiguous or single-event placement, so it is still
    unresolved after collect_candidates. Chains are stitched for exactly
    those reads' genome-space rows (resolved reads would only get chains
    that lose selection). `resolved` overrides the resolved-read set (the
    grouped pipeline passes the global one)."""
    if not (m.gs is not None and m.gs.rows and len(events["left"])
            and m.seg_tables is not None):
        return
    if resolved is None:
        resolved = [r for r, cl in m.cands.items() if cl]
    unresolved = ~np.isin(m.gs.read_idx, list(resolved))
    rows_sel = np.nonzero(unresolved & (m.gs.read_idx >= 0)
                          & (m.gs.nseg >= 2))[0]
    if not len(rows_sel):
        return
    sub_gs, sub_tables = subset_rows(m.gs, m.seg_tables, rows_sel)
    nchain = 0
    for cc in chain_stitch(fm, sub_gs, sub_tables, events, params):
        m.cands.setdefault(cc.read, []).append(Candidate(
            read=cc.read, pos=cc.pos, strand=cc.strand, mm=cc.mm,
            kind=-2, ev=-1, t=0, chain_ops=tuple(cc.ops),
            chain_events=tuple(cc.events)))
        nchain += 1
    if nchain:
        log(f"default chain stitch: {nchain} multi-event chains "
            f"over {len(rows_sel)} unresolved rows")


def _select(m: MateState, params, accepted, rng, score_of):
    selected = {}
    for r, clist in m.cands.items():
        usable = [c for c in clist
                  if (all(e in accepted for e in c.chain_events)
                      if c.kind == -2 else (c.ev < 0 or c.ev in accepted))]
        selected[r] = select_best(usable, params.max_multihits, rng,
                                  params.report_secondary,
                                  score_of=score_of)
    return selected


def run_pipeline(genome: Genome, batch: ReadBatch, params: Params,
                 out_dir: str, fm: Optional[FMIndex] = None,
                 known_events: Optional[Dict[str, np.ndarray]] = None,
                 gtf_accept=None, trans=None, log=print, device="cuda"):
    """One batch through every stage, outputs written to `out_dir`."""
    t0 = time.time()
    mates, events, stats, accepted, fm = pipeline_core(
        genome, [batch], params, fm=fm, known_events=known_events,
        gtf_accept=gtf_accept, trans=trans, log=log, device=device)
    os.makedirs(out_dir, exist_ok=True)
    m = mates[0]
    with open(os.path.join(out_dir, "prep_reads.info"), "w") as f:
        f.write(m.prep_stats.info_text())

    rng = np.random.default_rng(1)
    score_of = _v2_score_of(params, [m], events, stats)
    selected = _select(m, params, accepted, rng, score_of)
    records = write_outputs(out_dir, genome, params, batch, selected, events)
    log(f"done in {time.time() - t0:.1f}s; {len(records)} alignments "
        f"reported")
    return dict(mates=mates, events=events, stats=stats, selected=selected,
                fm=fm)


@trace.span(trace.ROOT)
def run_pipeline_streaming(genome: Genome, batch_iter, params: Params,
                           out_dir: str, fm: Optional[FMIndex] = None,
                           known_events=None, gtf_accept=None, trans=None,
                           tmp_dir=None, resume=False, log=print,
                           device="cuda"):
    """Chunked single-end pipeline for read sets larger than one device
    batch: per-chunk map + discovery, a global event union, per-chunk
    realignment, global junction filtering, and merged output."""
    t0 = time.time()
    dev = resolve_device(device)
    trans = _trans_for(trans, dev)
    os.makedirs(out_dir, exist_ok=True)
    offsets = genome.offsets.astype(np.int32)

    # lazy index: a fully-resumed run never needs the FM index for mapping
    fm_holder = [fm]

    def fm_get():
        fm_holder[0] = _index_for(genome, fm_holder[0], dev, log)
        return fm_holder[0]

    chunks: List[MateState] = []
    tables = []
    prep_all = PrepStats()
    for bi, batch in enumerate(batch_iter):
        m, chunk_tables = _mapped_chunk(fm_get, genome, offsets, batch,
                                        params, log, trans=trans,
                                        tmp_dir=tmp_dir, resume=resume,
                                        tag=f"chunk{bi:05d}")
        tables.extend(chunk_tables)
        prep_all.merge(m.prep_stats)
        chunks.append(m)
        log(f"chunk {bi}: {batch.size} reads")
    fm = fm_holder[0]
    if fm is None:   # every chunk resumed: realignment needs the codes only
        fm = types.SimpleNamespace(
            genome=torch.as_tensor(genome.codes, device=dev),
            genome_host=genome.codes)
    with trace.span("events.union"):
        if known_events is not None:
            tables.append(known_events)
        events = merge_events(*tables)
        trace.count("events", len(events["left"]))
    log(f"{len(events['left'])} candidate events across "
        f"{len(chunks)} chunks")

    for m in chunks:
        candidates_for_mate(fm, m, events, params, log)
    stats, accepted = junction_stats(chunks, events, params, gtf_accept)

    with trace.span("pairs.select"):
        rng = np.random.default_rng(1)
        score_of = _v2_score_of(params, chunks, events, stats)
        parts = [(m.batch, _select(m, params, accepted, rng, score_of))
                 for m in chunks]

    with trace.span("output"):
        records = write_outputs_multi(out_dir, genome, params, parts, events)
        with trace.span("output.summary"):
            with open(os.path.join(out_dir, "prep_reads.info"), "w") as f:
                f.write(prep_all.info_text())
    log(f"streaming done in {time.time() - t0:.1f}s; {len(records)} "
        f"alignments over {len(chunks)} chunks")
    return dict(events=events, stats=stats, parts=parts, fm=fm)


def _mapped_chunk(fm_get, genome, offsets, batch, params, log, trans=None,
                  tmp_dir=None, resume=False, tag="chunk"):
    """Map + discover (+ search) one chunk, with optional artifact reuse:
    when `tmp_dir` is set the mapped state + event tables persist as
    <tmp_dir>/<tag>.pkl (segment tables as host numpy), and `resume=True`
    reloads them instead of redoing the mapping. The artifact is keyed by
    the reads' content and the parameters."""
    import pickle

    art = os.path.join(tmp_dir, f"{tag}.pkl") if tmp_dir else None
    key = None
    if art:
        with trace.span("chunk.artifact"):
            key = _chunk_key(batch, params)
    if resume and art and os.path.exists(art):
        try:
            with open(art, "rb") as f:
                m, chunk_tables, stored_key = pickle.load(f)
            if stored_key == key:
                m.batch = batch     # reads reload from the input files
                log(f"[resume] {tag}: reusing mapped tables")
                return m, chunk_tables
            log(f"[resume] {tag}: input/params changed, remapping")
        except Exception:
            pass  # corrupt/stale artifact: redo the stage
    fm = fm_get()
    m = _map_mate(fm, offsets, batch, params, log, genome=genome,
                  trans=trans)
    chunk_tables = [discover_events(fm, offsets, m.gs, params,
                                    seg_tables=m.seg_tables, log=None)]
    chunk_tables += search_tables(fm, genome, m, params)
    if m.gapped_events is not None:
        chunk_tables.append(m.gapped_events)
    if art:
        with trace.span("chunk.artifact"):
            _save_chunk(art, m, chunk_tables, key)
    return m, chunk_tables


def _save_chunk(art, m, chunk_tables, key) -> None:
    """Persist one mapped chunk (segment tables as host numpy) for
    _mapped_chunk's resume; best-effort."""
    import pickle

    batch_ref = m.batch
    seg_ref = m.seg_tables
    try:
        os.makedirs(os.path.dirname(art), exist_ok=True)
        if seg_ref is not None:   # host copies: loadable on any device
            m.seg_tables = tuple(trace.to_host(a) for a in seg_ref)
        m.batch = None          # reads live in the input files
        with open(art, "wb") as f:
            pickle.dump((m, chunk_tables, key), f,
                        protocol=pickle.HIGHEST_PROTOCOL)
    except OSError:
        pass                    # artifact write is best-effort
    finally:
        m.batch = batch_ref
        m.seg_tables = seg_ref


def _chunk_key(batch, params) -> str:
    """Content identity of a chunk's mapped artifact: a digest of the reads
    (names + codes + lengths) and of every mapping-relevant parameter."""
    import hashlib

    h = hashlib.sha1()
    h.update(repr(sorted(dataclasses.asdict(params).items())).encode())
    h.update(np.ascontiguousarray(batch.codes).tobytes())
    h.update(np.ascontiguousarray(batch.lengths).tobytes())
    for n in batch.names:
        h.update(n.encode() if isinstance(n, str) else bytes(n))
        h.update(b"\0")
    return h.hexdigest()
