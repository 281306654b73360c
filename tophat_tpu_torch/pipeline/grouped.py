# Port of tophat_tpu/pipeline/grouped.py; one group's index resident on the card.
"""Whole-genome pipeline over contig-group FM indexes (int64-safe merge).

Device stages (alignment, segment mapping, discovery, realignment, chains)
run per contig group in group-LOCAL int32 coordinates; candidates and event
tables rebase to int64 GLOBAL coordinates on the host and merge for the
global phases (junction filtering, best-alignment selection, output). This
is how a 3.1 Gbp human genome runs on int32 device arithmetic.

Semantics kept from the single-index pipeline:
  - IUM is GLOBAL: a read with a full-length hit in any group skips the
    spliced path everywhere (like bowtie searching one whole-genome index).
  - -M prefilter counts hits across all groups.
  - default-mode chains run only for globally-unresolved reads.
Limits kept from the JAX package, for byte parity: the grouped mapper runs
the coverage search but not the butterfly or microexon searches, and
fusion search sees only pairs within one group (cross-group fusions need
the index sharding of the multi-device path).
"""

from __future__ import annotations

import dataclasses
import types
from typing import Dict, List, Optional

import numpy as np
import torch

from tophat_tpu_torch.index.fasta import Genome
from tophat_tpu_torch.index.grouped import GroupedFM
from tophat_tpu_torch.ops.align import (align_reads_adaptive, kmer_fast_ok,
                                        transfer_alignments)
from tophat_tpu_torch.parallel import auto
from tophat_tpu_torch.pipeline.coverage import coverage_search_events
from tophat_tpu_torch.pipeline.juncs import (discover_events, empty_events,
                                             merge_events)
from tophat_tpu_torch.pipeline.params import Params
from tophat_tpu_torch.pipeline.prep import prep_filter
from tophat_tpu_torch.pipeline.run import (MateState, _spliced_mate,
                                           _trans_for, candidates_for_mate,
                                           default_chains, revcomp_rows)
from tophat_tpu_torch.pipeline.transcriptome import (
    map_reads_transcriptome, transcriptome_candidates)
from tophat_tpu_torch.utils.device import resolve_device


def _slice_known_events(known, base: int, length: int):
    """Global known-event table -> group-local slice (left/right rebased).
    Events spanning outside the group are dropped (junctions/deletions
    cannot cross contig—and hence group—boundaries)."""
    if known is None or not len(known["left"]):
        return None
    left = known["left"].astype(np.int64)
    right = known["right"].astype(np.int64)
    sel = (left >= base) & (right < base + length)
    if not sel.any():
        return None
    out = {k: v[sel].copy() for k, v in known.items()}
    out["left"] = (out["left"].astype(np.int64) - base).astype(np.int32)
    out["right"] = (out["right"].astype(np.int64) - base).astype(np.int32)
    return out


def _rebase_candidates(cands: Dict[int, list], base: int,
                       eoff: int) -> None:
    """Shift one group's candidates to global coordinates / global event
    indices, in place (Python ints: no int32 wrap past 2^31)."""
    for clist in cands.values():
        for c in clist:
            c.pos += base
            if c.ev >= 0:
                c.ev += eoff
            if c.fpos2 >= 0:
                c.fpos2 += base
            if c.chain_events:
                c.chain_events = tuple(e + eoff for e in c.chain_events)
            if c.chain_ops:
                c.chain_ops = tuple(
                    ("EV", op[1] + eoff, op[2], op[3]) if op[0] == "EV"
                    else (("FUS", op[1] + base, op[2]) if op[0] == "FUS"
                          else op)
                    for op in c.chain_ops)


def _merge_event_tables(group_events: List[dict], bases) -> dict:
    """Concatenate per-group event tables at global int64 coordinates."""
    out = {}
    for k in empty_events():
        parts = []
        for ev, base in zip(group_events, bases):
            v = ev[k]
            if k in ("left", "right"):
                v = v.astype(np.int64) + int(base)
            parts.append(v)
        out[k] = (np.concatenate(parts) if parts
                  else empty_events()[k])
    return out


class GroupedMapper:
    """Chunk-capable grouped mapping engine of both streaming pipelines
    (run.run_pipeline_streaming and paired.run_pipeline_paired_streaming
    with a contig-group index).

    Protocol (mirrored by run.SingleEndMapper and paired.SingleIndexMapper):
      map_chunk_mate(batch, side)         -> MateState (global coords pending)
      finalize_events(known)              -> global int64 event table
      fill_candidates(m, events, paired)  -> sets m.cands in global coords
    """

    def __init__(self, gfm: GroupedFM, genome: Genome, params: Params,
                 trans=None, log=print, device="cuda"):
        self.dev = resolve_device(device)
        self.gfm = gfm
        self.genome = genome
        self.params = params
        self.trans = _trans_for(trans, self.dev)
        self.log = log
        self.group_tables: List[List[dict]] = [[] for _ in
                                               range(gfm.n_groups)]
        self.group_events: Optional[List[dict]] = None
        self.group_eoff = None
        self._dev_g = -1
        self._dev_fm_cache = None
        self._dev_codes: Dict[int, torch.Tensor] = {}

    def _dev_fm(self, g: int):
        """Group g's full index on the device, one group resident at a
        time: a group stays resident across all its stages, and the old
        group's tables are freed before the next group's arrive. Under a
        mesh the stages replicate the resident group to the other devices
        (parallel/auto.replicated); the swap drops those copies too."""
        if self._dev_g != g:
            if self._dev_fm_cache is not None:
                auto.release(self._dev_fm_cache)
                auto.release(self._dev_fm_cache.genome)
            self._dev_fm_cache = None
            self._dev_g = -1
            if self.dev.type == "cuda":
                torch.cuda.empty_cache()
            self._dev_fm_cache = self.gfm.fms[g].to(self.dev)
            self._dev_g = g
        return self._dev_fm_cache

    def _light_fm(self, g: int):
        """Lightweight index view for the post-segment-mapping stages.

        Discovery scans, event realignment, chains, the coverage search
        and fusion pieces touch only `fm.genome` / `fm.n` / `fm.device` —
        never the FM search tables — so they run against a per-group
        device copy of the genome CODES (int8, ~1 B/base, all groups
        resident at once) plus a `genome_host` handle for the host-side
        consumers (index/fm.host_codes). Only full-read alignment and
        segment mapping swap the big tables through _dev_fm."""
        fm = self.gfm.fms[g]
        dev = self._dev_codes.get(g)
        if dev is None:
            # reuse the resident full index's genome when it is current
            if self._dev_g == g and self._dev_fm_cache is not None:
                dev = self._dev_fm_cache.genome
            else:
                dev = fm.genome.to(self.dev)
            self._dev_codes[g] = dev
        return types.SimpleNamespace(genome=dev, genome_host=fm.genome_host,
                                     n=fm.n, device=dev.device)

    def map_chunk_mate(self, batch, side: int) -> MateState:
        gfm, params, log = self.gfm, self.params, self.log
        G = gfm.n_groups

        keep, prep_stats = prep_filter(batch)
        reads_f = batch.codes
        reads_r = revcomp_rows(batch.codes, batch.lengths)
        lengths = batch.lengths.astype(np.int32)

        trans_hits = None
        has_t = np.zeros(batch.size, bool)
        if self.trans is not None and self.trans.n:
            trans_hits = map_reads_transcriptome(
                self.trans, self.genome, reads_f, reads_r, lengths, params)
            for r in trans_hits:
                has_t[r] = True
            log(f"transcriptome map: {int(has_t.sum())} reads placed")

        min_len = int(lengths.min()) if len(lengths) else 0
        max_len = int(lengths.max()) if len(lengths) else 0
        alns = []
        total = np.zeros(batch.size, np.int64)
        for g in range(G):
            fm = self._dev_fm(g)
            al = transfer_alignments(align_reads_adaptive(
                fm, reads_f, reads_r, lengths,
                gfm.sub_genomes[g].offsets.astype(np.int32),
                max_mismatches=params.read_mismatches,
                max_alignments=params.max_alignments,
                kmer_fast=kmer_fast_ok(fm, min_len,
                                       params.read_mismatches),
                narrow_hits=min(8, params.hits_per_seed),
                wide_hits=params.hits_per_seed,
                uniform_len=min_len if min_len == max_len else 0))
            del fm      # the next group arrives only once this one is gone
            alns.append(al)
            total += al.n_hits
        if params.prefilter_multihits:
            keep = keep & ~(total > params.max_multihits)
        ium = keep & (total == 0) & ~has_t
        log(f"genome map ({G} groups): {int(((total > 0) & keep).sum())} "
            f"mapped, {int(ium.sum())} IUM")

        gmates = [None] * G
        # reversed order: the LAST group aligned is still device-resident,
        # so the spliced phase starts with no index transfer (and the next
        # chunk's alignment phase starts at group 0 again, which this loop
        # ends on: steady-state chunks pay G-1 swaps per phase, not G)
        for g in reversed(range(G)):
            al = alns[g]
            m = MateState(
                batch=batch, keep=keep,
                aln=dataclasses.replace(
                    al, valid=al.valid & keep[:, None],
                    n_hits=np.where(keep, al.n_hits, 0)),
                gs=None, prep_stats=prep_stats, trans_hits=None)
            offsets = gfm.sub_genomes[g].offsets.astype(np.int32)
            _spliced_mate(self._dev_fm(g), offsets, m, params, ium, reads_f,
                          reads_r, lengths, log=log)
            gmates[g] = m
            fm_l = self._light_fm(g)
            self.group_tables[g].append(discover_events(
                fm_l, offsets, m.gs, params, seg_tables=m.seg_tables,
                log=None, read_side=side))
            if params.coverage_search and m.seg_tables is not None:
                self.group_tables[g].append(coverage_search_events(
                    fm_l, gfm.sub_genomes[g], m.gs, m.seg_tables, params))
            if m.gapped_events is not None:
                self.group_tables[g].append(m.gapped_events)

        mate = MateState(batch=batch, keep=keep, aln=gmates[0].aln,
                         gs=gmates[0].gs, prep_stats=prep_stats,
                         trans_hits=trans_hits)
        mate.gmates = gmates
        return mate

    def finalize_events(self, known_events=None) -> dict:
        gfm = self.gfm
        group_events: List[dict] = []
        for g in range(gfm.n_groups):
            tables = list(self.group_tables[g])
            sliced = _slice_known_events(known_events, int(gfm.bases[g]),
                                         gfm.sub_genomes[g].n)
            if sliced is not None:
                tables.append(sliced)
            group_events.append(merge_events(*tables) if tables
                                else empty_events())
        self.group_events = group_events
        self.group_eoff = np.concatenate(
            [[0], np.cumsum([len(e["left"]) for e in group_events])])
        return _merge_event_tables(group_events,
                                   [int(b) for b in gfm.bases])

    def fill_candidates(self, mate: MateState, events,
                        paired: bool = False) -> None:
        gfm, params, log = self.gfm, self.params, self.log
        merged: Dict[int, list] = {}
        for g, m in enumerate(mate.gmates):
            candidates_for_mate(self._light_fm(g), m,
                                self.group_events[g],
                                params, log, paired=paired,
                                chain_default=False)
            _rebase_candidates(m.cands, int(gfm.bases[g]),
                               int(self.group_eoff[g]))
            for r, lst in m.cands.items():
                merged.setdefault(r, []).extend(lst)
        mate.cands = merged

        if mate.trans_hits:
            for r, lst in transcriptome_candidates(mate.trans_hits, events,
                                                   params).items():
                mate.cands[r] = lst

        if not params.fusion_search:
            resolved = {r for r, cl in mate.cands.items() if cl}
            for g, m in enumerate(mate.gmates):
                n0 = {r: len(cl) for r, cl in m.cands.items()}
                default_chains(self._light_fm(g), m, self.group_events[g],
                               params, log, resolved=resolved)
                new: Dict[int, list] = {}
                for r, cl in m.cands.items():
                    fresh = cl[n0.get(r, 0):]
                    if fresh:
                        new[r] = fresh
                _rebase_candidates(new, int(gfm.bases[g]),
                                   int(self.group_eoff[g]))
                for r, lst in new.items():
                    mate.cands.setdefault(r, []).extend(lst)
