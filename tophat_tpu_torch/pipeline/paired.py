# Port of tophat_tpu/pipeline/paired.py; device stages run via run.py.
"""Paired-end reporting.

Pair grading mirrors InsertAlignmentGrade's intent (reference:
src/inserts.h:33, used by pair_best_alignments tophat_reports.cpp:358):
pairs where both mates align beat half-mapped reads; among full pairs the
per-mate scores add and (when multiple combinations tie) the pair whose
inner distance best matches inner_dist_mean wins.

Output flag conventions copied from the gold regression outputs (v1.1.4
era): PAIRED | READ1/READ2 | (MATE_UNMAPPED) | strand bits, RNEXT '=' and
PNEXT = mate position when the mate mapped, RNEXT '*' otherwise, TLEN 0.
With fusion search, fusions.out also counts mate-pair support. A
contig-group index (whole genomes past the int32 range) maps through
pipeline/grouped.GroupedMapper.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Dict, List

import numpy as np

from tophat_tpu_torch.index.fasta import Genome, decode_seq
from tophat_tpu_torch.io import sam as samio
from tophat_tpu_torch.io.bam import BamRecord, BamWriter
from tophat_tpu_torch.ops.splice import KIND_INSERTION, KIND_JUNCTION
from tophat_tpu_torch.pipeline.fusion_stats import build_fusion_table
from tophat_tpu_torch.pipeline.grouped import GroupedMapper
from tophat_tpu_torch.pipeline.juncs import discover_events, merge_events
from tophat_tpu_torch.pipeline.prep import PrepStats
from tophat_tpu_torch.pipeline.report import (Candidate, EventStats,
                                              _write_beds,
                                              accumulate_event_stats,
                                              filter_junctions, select_best,
                                              write_align_summary)
from tophat_tpu_torch.pipeline.run import (_index_for, _map_mate,
                                           _trans_for, _v2_score_of,
                                           candidates_for_mate,
                                           merge_stats, resolve_device,
                                           search_tables)
from tophat_tpu_torch.utils import trace


@dataclasses.dataclass
class InsertGrade:
    """InsertAlignmentGrade (reference: src/inserts.h:33): grades one
    combination of mate alignments."""

    num_mapped: int
    edit_dist: int
    inner_dist: int = 99999999
    too_close: bool = False
    too_far: bool = False
    opposite_strands: bool = False
    longest_skip: int = 0
    num_spliced: int = 0

    @property
    def concordant(self) -> bool:
        return (self.num_mapped == 2 and self.opposite_strands
                and not self.too_close and not self.too_far)


def _ref_skip(c: Candidate, rl: int) -> int:
    return max((n for op, n in c.cigar(rl) if op == "N"), default=0)


def _grade(c1, c2, rl1, rl2, params) -> InsertGrade:
    """Grade a mate-pair combination (inserts.h:72: inner distance vs
    [mean - std_dev, mean + std_dev], strand opposition, summed edit
    distance, longest intron)."""
    span1 = samio.ref_span(c1.cigar(rl1))
    span2 = samio.ref_span(c2.cigar(rl2))
    if c1.pos <= c2.pos:
        inner = c2.pos - (c1.pos + span1)
    else:
        inner = c1.pos - (c2.pos + span2)
    mean, std = params.inner_dist_mean, params.inner_dist_std_dev
    return InsertGrade(
        num_mapped=2, edit_dist=c1.edit_dist + c2.edit_dist,
        inner_dist=inner, too_close=inner < mean - std,
        too_far=inner > mean + std,
        opposite_strands=c1.strand != c2.strand,
        longest_skip=max(_ref_skip(c1, rl1), _ref_skip(c2, rl2)) // 100,
        num_spliced=int(c1.kind >= 0) + int(c2.kind >= 0))


def _grade_less(a: InsertGrade, b: InsertGrade) -> bool:
    """True when b is the "happier" grade (reference comparator's pre-
    bowtie2 branch, inserts.cpp:22: prefer both-mapped, then — when inner
    distances differ significantly — not-too-far > too-far, perfect >
    too-close, closer mates; then lower edit distance, shorter introns)."""
    if a.num_mapped != b.num_mapped:
        return a.num_mapped < b.num_mapped
    if abs(b.inner_dist - a.inner_dist) >= 30:
        if a.too_far != b.too_far:
            return a.too_far
        if a.too_close and not (b.too_close or b.too_far):
            return True
        if b.too_close and not (a.too_close or a.too_far):
            return False
        if a.inner_dist != b.inner_dist:
            return b.inner_dist < a.inner_dist
    if a.edit_dist != b.edit_dist:
        return b.edit_dist < a.edit_dist
    if a.longest_skip != b.longest_skip:
        return b.longest_skip < a.longest_skip
    return False


def _grade_key():
    return functools.cmp_to_key(
        lambda x, y: -1 if _grade_less(x[0], y[0])
        else (1 if _grade_less(y[0], x[0]) else 0))


class SingleIndexMapper:
    """Chunk mapping engine for the single-index paired pipeline; protocol
    shared with pipeline/grouped.GroupedMapper, so the paired pipeline runs
    unchanged over a whole-genome index or a contig-group index."""

    def __init__(self, fm, genome, params, trans=None, log=print):
        self.fm = fm
        self.genome = genome
        self.params = params
        self.trans = trans
        self.log = log
        self.tables = []

    def map_chunk_mate(self, batch, side: int):
        fm, params, genome = self.fm, self.params, self.genome
        offsets = genome.offsets.astype(np.int32)
        m = _map_mate(fm, offsets, batch, params, self.log, genome=genome,
                      trans=self.trans)
        self.tables.append(discover_events(fm, offsets, m.gs, params,
                                           seg_tables=m.seg_tables,
                                           log=None, read_side=side))
        self.tables += search_tables(fm, genome, m, params)
        if m.gapped_events is not None:
            self.tables.append(m.gapped_events)
        return m

    def finalize_events(self, known_events=None):
        tables = list(self.tables)
        if known_events is not None:
            tables.append(known_events)
        return merge_events(*tables)

    def fill_candidates(self, m, events, paired: bool = True) -> None:
        candidates_for_mate(self.fm, m, events, self.params, self.log,
                            paired=paired)


def run_pipeline_paired(genome: Genome, batch1, batch2, params, out_dir,
                        fm=None, known_events=None, gtf_accept=None,
                        trans=None, log=print, gfm=None, device="cuda"):
    """Single-chunk paired run (both mates fit one device batch)."""
    return run_pipeline_paired_streaming(
        genome, iter([(batch1, batch2)]), params, out_dir, fm=fm,
        known_events=known_events, gtf_accept=gtf_accept, trans=trans,
        log=log, gfm=gfm, device=device)


@trace.span(trace.ROOT)
def run_pipeline_paired_streaming(genome: Genome, pair_iter, params,
                                  out_dir, fm=None, known_events=None,
                                  gtf_accept=None, trans=None, log=print,
                                  gfm=None, device="cuda"):
    """Chunked paired-end pipeline: mate pairs stream through fixed-size
    chunk pairs (same read count per mate — reads pair by line number), a
    global event union feeds per-chunk realignment, and pair selection /
    rescue runs chunk-locally since mates share indices within a chunk.
    One chunk reproduces the single-batch output byte-for-byte.

    Device stages run on `device` (default cuda; raises without it).
    gfm: a contig-group index (index/grouped.GroupedFM) routes mapping and
    candidate assembly through pipeline/grouped.GroupedMapper."""
    dev = resolve_device(device)
    t0 = time.time()
    os.makedirs(out_dir, exist_ok=True)
    if gfm is not None:
        mapper = GroupedMapper(gfm, genome, params, trans=trans, log=log,
                               device=dev)
        fm = gfm
    else:
        fm = _index_for(genome, fm, dev, log)
        mapper = SingleIndexMapper(fm, genome, params,
                                   trans=_trans_for(trans, dev), log=log)

    chunks = []
    prep_all = [PrepStats(), PrepStats()]
    for b1, b2 in pair_iter:
        if b1.size != b2.size:
            raise SystemExit("Error: mate files have different read counts")
        ms = []
        for side, b in enumerate((b1, b2)):
            m = mapper.map_chunk_mate(b, side)
            prep_all[side].merge(m.prep_stats)
            ms.append(m)
        chunks.append((b1, b2, ms[0], ms[1]))
        log(f"pair chunk {len(chunks) - 1}: {b1.size} read pairs")
    if not chunks:
        raise SystemExit("Error: no reads in input")
    with trace.span("events.union"):
        events = mapper.finalize_events(known_events)
        trace.count("events", len(events["left"]))

    all_mates = [m for (_, _, m1, m2) in chunks for m in (m1, m2)]
    for m in all_mates:
        mapper.fill_candidates(m, events, paired=True)
    with trace.span("junctions.filter"):
        stats: Dict[int, EventStats] = {}
        for m in all_mates:
            merge_stats(stats, accumulate_event_stats(
                m.cands, events, m.batch.lengths.astype(np.int32)))
        filter_junctions(events, stats, params, gtf_accept=gtf_accept)
        accepted = {e for e, st in stats.items() if st.accepted}

    with trace.span("pairs.select"):
        records, chunk_selected, final_stats, tally = _select_pairs(
            chunks, all_mates, events, stats, accepted, params)
    with trace.span("output"):
        _write_paired(out_dir, genome, params, events, records,
                      chunk_selected, final_stats, tally, prep_all)
    log(f"paired done in {time.time() - t0:.1f}s; "
        f"{len(records)} records, {tally[0]} pairs over "
        f"{len(chunk_selected)} chunks")
    sel_pairs = [(s0, s1) for (_, _, s0, s1) in chunk_selected]
    return dict(events=events, stats=stats, selected=sel_pairs[0],
                selected_chunks=sel_pairs, fm=fm)


def _select_pairs(chunks, all_mates, events, stats, accepted, params):
    """Selection, mate rescue and pair grading, chunk by chunk; (records
    to write, [(batch1, batch2, selected1, selected2)] per chunk, the
    events' final stats, (pairs, single, discordant, reads 1, reads 2,
    mapped 1, mapped 2, multi 1, multi 2))."""
    rng = np.random.default_rng(1)
    final_stats: Dict[int, EventStats] = {}
    records = []
    chunk_selected = []          # [(batch1, batch2, sel0, sel1)]
    n_pairs = n_single = n_disc = 0
    total1 = total2 = mapped1 = mapped2 = multi1 = multi2 = 0
    score_of = _v2_score_of(params, all_mates, events, stats)
    for ci, (batch1, batch2, m1, m2) in enumerate(chunks):
        selected: List[Dict[int, List[Candidate]]] = []
        rescue: List[Dict[int, List[Candidate]]] = []
        for mi, m in enumerate((m1, m2)):
            sel = {}
            res = {}
            for r, clist in m.cands.items():
                usable = [c for c in clist
                          if (all(e in accepted for e in c.chain_events)
                              if c.kind == -2
                              else (c.ev < 0 or c.ev in accepted))]
                strict = [c for c in usable if not c.pair_only]
                sel[r] = select_best(strict, params.max_multihits, rng,
                                     params.report_secondary,
                                     score_of=score_of)
                res[r] = [c for c in usable if c.pair_only]
            selected.append(sel)
            rescue.append(res)

        # mate-pair rescue: a mate whose only alignment is a short-3'-
        # anchor spliced candidate keeps it when the other mate maps and
        # anchors the pair (gold test_Paired 21M157N3M records; the
        # pair_best_alignments role for half-mapped pairs,
        # reference tophat_reports.cpp:358)
        n = max(batch1.size, batch2.size)
        for r in range(n):
            for mi, other_mi in ((0, 1), (1, 0)):
                if selected[mi].get(r) or not selected[other_mi].get(r):
                    continue
                pool = rescue[mi].get(r, [])
                if not pool:
                    continue
                mate_c = selected[other_mi][r][0]
                rl_own = int((batch1 if mi == 0 else batch2).lengths[r])
                rl_oth = int((batch2 if mi == 0 else batch1).lengths[r])
                graded = [(_grade(c, mate_c, rl_own, rl_oth, params), c)
                          for c in pool]
                best = max(graded, key=_grade_key())[1]
                selected[mi][r] = [best]

        for r in range(n):
            s1 = selected[0].get(r, []) if r < batch1.size else []
            s2 = selected[1].get(r, []) if r < batch2.size else []
            pair_grade = None
            if s1 and s2:
                rl1 = int(batch1.lengths[r])
                rl2 = int(batch2.lengths[r])
                # pair grading (InsertAlignmentGrade, pair_best_alignments
                # tophat_reports.cpp:358): keep the happiest combination
                graded = [(_grade(a, b, rl1, rl2, params), (a, b))
                          for a in s1 for b in s2]
                pair_grade, (c1, c2) = max(graded, key=_grade_key())
                if len(s1) > 1 or len(s2) > 1:
                    s1, s2 = [c1], [c2]
                if params.no_discordant and not pair_grade.concordant:
                    s1, s2 = [], []
                    pair_grade = None
                else:
                    n_pairs += 1
                    if not pair_grade.concordant:
                        n_disc += 1
            elif s1 or s2:
                if params.no_mixed:
                    s1, s2 = [], []
                else:
                    n_single += 1
            selected[0][r] = s1
            selected[1][r] = s2
            for mi, (own, other, batch) in enumerate(
                    ((s1, s2, batch1), (s2, s1, batch2))):
                mate_bit = samio.FLAG_READ1 if mi == 0 else samio.FLAG_READ2
                for c in own:
                    nh = len(own)
                    flag = samio.FLAG_PAIRED | mate_bit
                    if c.strand:
                        flag |= samio.FLAG_REVERSE
                    tlen = 0
                    if other:
                        mate = other[0]
                        rnext, pnext = "=", mate.pos
                        if mate.strand:
                            flag |= samio.FLAG_MATE_REVERSE
                        if params.v2_sam:
                            # proper-pair flag + TLEN (2.1.2 SAM
                            # conventions; the gold v1.1.4 outputs carry
                            # neither)
                            if (pair_grade is not None
                                    and pair_grade.concordant):
                                flag |= samio.FLAG_PROPER
                            rl_own = int(batch.lengths[c.read])
                            span_own = samio.ref_span(c.cigar(rl_own))
                            rl_oth = int((batch2 if mi == 0
                                          else batch1).lengths[mate.read])
                            span_oth = samio.ref_span(mate.cigar(rl_oth))
                            lo = min(c.pos, mate.pos)
                            hi = max(c.pos + span_own,
                                     mate.pos + span_oth)
                            tlen = hi - lo
                            if c.pos > mate.pos or (c.pos == mate.pos
                                                    and mi == 1):
                                tlen = -tlen
                    else:
                        flag |= samio.FLAG_MATE_UNMAPPED
                        rnext, pnext = "*", -1
                    rl = int(batch.lengths[c.read])
                    if c.ev >= 0:
                        st = final_stats.setdefault(c.ev, EventStats())
                        ra = rl - c.t - (c.gap if events["kind"][c.ev] ==
                                         KIND_INSERTION else 0)
                        st.add(c.t, ra, c.mm)
                    records.append((c, nh, rl, flag, rnext, pnext, batch,
                                    tlen, ci))
        chunk_selected.append((batch1, batch2, selected[0], selected[1]))
        total1 += batch1.size
        total2 += batch2.size
        mapped1 += sum(1 for v in selected[0].values() if v)
        mapped2 += sum(1 for v in selected[1].values() if v)
        multi1 += sum(1 for v in selected[0].values() if len(v) > 1)
        multi2 += sum(1 for v in selected[1].values() if len(v) > 1)

    return records, chunk_selected, final_stats, (
        n_pairs, n_single, n_disc, total1, total2, mapped1, mapped2, multi1,
        multi2)


def _write_paired(out_dir, genome, params, events, records, chunk_selected,
                  final_stats, tally, prep_all):
    """Every output file of a paired run."""
    n_pairs, _, n_disc, total1, total2, mapped1, mapped2, multi1, multi2 = \
        tally
    bam_recs = _write_paired_sam(out_dir, genome, params, events, records)

    header = "\n".join(samio.header_lines(genome, params=params)) + "\n"
    lens = [int(x) for x in genome.contig_lengths()]
    with trace.span("output.bam"):
        w = BamWriter(os.path.join(out_dir, "accepted_hits.bam"), header,
                      genome.names, lens)
        for r in bam_recs:
            w.write(r)
        w.close()

    with trace.span("output.unmapped"):
        w = BamWriter(os.path.join(out_dir, "unmapped.bam"),
                      "\n".join(samio.header_lines(genome, "unsorted",
                                                    params=params)) + "\n",
                      genome.names, lens)
        for (batch1, batch2, sel0, sel1) in chunk_selected:
            for mi, (batch, sel) in enumerate(((batch1, sel0),
                                               (batch2, sel1))):
                mate_bit = (samio.FLAG_READ1 if mi == 0
                            else samio.FLAG_READ2)
                for r in range(batch.size):
                    if sel.get(r):
                        continue
                    rl = int(batch.lengths[r])
                    w.write(BamRecord(
                        batch.names[r],
                        samio.FLAG_PAIRED | mate_bit | samio.FLAG_UNMAPPED,
                        -1, -1, 0, [], -1, -1, 0,
                        decode_seq(batch.codes[r][:rl]).encode(),
                        batch.quals[r][:rl] or b"*", []))
        w.close()

    with trace.span("output.beds"):
        _write_beds(out_dir, genome, events, final_stats)
    if params.fusion_search:
        parts = []
        for (batch1, batch2, sel0, sel1) in chunk_selected:
            parts += [(batch1, sel0), (batch2, sel1)]
        ft = build_fusion_table(genome, events, params, parts)
        # mate-pair evidence (pair_support, fusions.cpp:497)
        for (batch1, batch2, sel0, sel1) in chunk_selected:
            for r in range(max(batch1.size, batch2.size)):
                s1 = sel0.get(r, []) if r < batch1.size else []
                s2 = sel1.get(r, []) if r < batch2.size else []
                if (s1 and s2 and len(s1) <= params.fusion_multipairs
                        and len(s2) <= params.fusion_multipairs):
                    ft.add_pair(s1[0], s2[0], int(batch1.lengths[r]),
                                int(batch2.lengths[r]))
        ft.write(os.path.join(out_dir, "fusions.out"))

    with trace.span("output.summary"):
        with open(os.path.join(out_dir, "prep_reads.info"), "w") as f:
            f.write("left reads:\n" + prep_all[0].info_text())
            f.write("right reads:\n" + prep_all[1].info_text())
        write_align_summary(
            out_dir, ("Left reads", total1, mapped1, multi1, 0),
            ("Right reads", total2, mapped2, multi2, 0), None,
            (n_pairs, 0, n_disc), params.max_multihits)


@trace.span("output.sam")
def _write_paired_sam(out_dir, genome, params, events, records):
    """accepted_hits.sam, coordinate-sorted; the same records as
    BamRecords, in the same order."""
    records.sort(key=lambda rec: (rec[0].pos, rec[8], rec[0].read,
                                  rec[3] & 0xC0))
    lines = []
    bam_recs = []
    for c, nh, rl, flag, rnext, pnext, batch, tlen, ci in records:
        cid, local = genome.global_to_contig(np.int64(c.pos))
        mate_ref = -1
        if rnext == "=":
            mcid, pnext_local = genome.global_to_contig(np.int64(pnext))
            pnext = int(pnext_local)
            mate_ref = int(mcid)
            if mate_ref != int(cid):  # cross-contig mate: name explicitly
                rnext = genome.names[mate_ref]
        xs = None
        if c.kind == KIND_JUNCTION:
            xs = "-" if events["antisense"][c.ev] else "+"
        seq = decode_seq(batch.codes[c.read][:rl]).encode()
        qual = batch.quals[c.read][:rl] or b"*"
        rg_extra = ([f"RG:Z:{params.rg_id}"]
                    if getattr(params, "rg_id", "") else None)
        lines.append(samio.format_record(
            name=batch.names[c.read], flag=flag,
            ref=genome.names[int(cid)], pos0=int(local),
            mapq=samio.mapq_for_nh(nh, params.v2_sam), cigar=c.cigar(rl),
            seq=seq, qual=qual, nm=c.nm(), nh=nh,
            xs_strand=xs, rnext=rnext, pnext0=pnext, tlen=tlen,
            extra=rg_extra))
        tags = [("NM", "i", c.nm())]
        if xs is not None:
            tags.append(("XS", "A", xs))
        tags.append(("NH", "i", nh))
        if getattr(params, "rg_id", ""):
            tags.append(("RG", "Z", params.rg_id))
        out_seq = (samio.revcomp_ascii(seq)
                   if flag & samio.FLAG_REVERSE else seq)
        out_qual = qual[::-1] if flag & samio.FLAG_REVERSE else qual
        bam_recs.append(BamRecord(
            batch.names[c.read], flag, int(cid), int(local),
            samio.mapq_for_nh(nh, params.v2_sam), c.cigar(rl), mate_ref,
            pnext if rnext == "=" else -1, tlen, out_seq, out_qual, tags))
    with open(os.path.join(out_dir, "accepted_hits.sam"), "w") as f:
        for ln in lines:
            f.write(ln + "\n")
    trace.count("records", len(records))
    return bam_recs
