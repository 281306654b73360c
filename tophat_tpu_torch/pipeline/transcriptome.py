"""Transcriptome mapping stage (_reads_vs_T + map2gtf).

Port of tophat_tpu/pipeline/transcriptome.py. The reference aligns reads
against spliced transcript sequences first and rewrites the hits into
genomic coordinates with N-CIGAR introns; only the transcriptome-unmapped
reads continue to the genome/segment stages (reference: src/tophat.py:
3286-3326 map2gtf, :2400-2419 the _reads_vs_T pipe ending in map2gtf;
src/map2gtf.cpp:234 trans_to_genomic_coords).

The transcriptome is itself a concatenated "genome" whose contigs are
transcripts (exons joined, genome orientation — the gtf_to_fasta record
layout, src/GTFToFasta.cpp:60), indexed with the same FM machinery as the
genome on the same device, so reads spanning any number of ANNOTATED
junctions align contiguously in one batched device call. Hits cross to the
host once (ops/align.transfer_alignments) and are rebased there through
the transcript exon model into genomic multi-N chains.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Tuple

import numpy as np

from tophat_tpu_torch.index.fasta import Genome
from tophat_tpu_torch.index.fm import STALE_INDEX, FMIndex, build_fm_index
from tophat_tpu_torch.io.gtf import (Transcript, _ordered_transcripts,
                                     trans_to_genomic, transcript_sequence)
from tophat_tpu_torch.ops.align import (align_reads_adaptive, kmer_fast_ok,
                                        transfer_alignments)
from tophat_tpu_torch.ops.splice import KIND_JUNCTION
from tophat_tpu_torch.pipeline.report import Candidate
from tophat_tpu_torch.utils import trace
from tophat_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TranscriptomeIndex:
    fm: FMIndex                    # over the concatenated transcript codes
    tgenome: Genome                # contigs = transcripts (numeric names)
    transcripts: List[Transcript]  # row i = transcript with numeric id i

    @property
    def n(self) -> int:
        return self.fm.n


def build_transcriptome_index(genome: Genome, transcripts, prefix=None,
                              log=None, device="cuda"
                              ) -> TranscriptomeIndex:
    """Build (or reuse, when `prefix` names a saved one) the transcriptome
    FM index on `device` (default cuda; raises without it). `prefix` is
    the --transcriptome-index data-file prefix; the FM index persists as
    <prefix>.tt.npz beside the .fa/.tlst set (the role of the bowtie2
    index the reference builds at src/tophat.py:2600 build_idx_from_fa)."""
    dev = resolve_device(device)
    rows = _ordered_transcripts(genome, transcripts)
    seqs = [transcript_sequence(genome, tr) for tr in rows]
    offsets = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    if offsets[-1] >= np.iinfo(np.int32).max:
        raise SystemExit("Error: transcriptome exceeds 2^31 bases")
    tgenome = Genome(codes=(np.concatenate(seqs).astype(np.int8)
                            if seqs else np.zeros(0, np.int8)),
                     offsets=offsets.astype(np.int64),
                     names=[str(i) for i in range(len(rows))])

    path = (prefix + ".tt.npz") if prefix else None
    if path and os.path.exists(path):
        try:
            fm = FMIndex.load(path, device=dev)
        except STALE_INDEX:
            fm = None               # stale/corrupt file: rebuild below
        if fm is not None and fm.n == len(tgenome.codes):
            if log:
                log(f"transcriptome FM index: reusing {path}")
            return TranscriptomeIndex(fm, tgenome, rows)
    fm = build_fm_index(tgenome, device=dev)
    if path:
        try:
            fm.save(path)
            if log:
                log(f"transcriptome FM index: saved {path}")
        except OSError:
            pass  # read-only location: keep the in-memory index
    return TranscriptomeIndex(fm, tgenome, rows)


@trace.span("map.transcriptome", sync=True)
def map_reads_transcriptome(tix: TranscriptomeIndex, genome: Genome,
                            reads_f, reads_r, lengths, params
                            ) -> Dict[int, List[Tuple]]:
    """Align a read batch against the transcriptome (on the index's device)
    and rebase hits to genomic coordinates on the host.

    Returns {read_index: [(strand, gpos_global, mm, cigar_ops)]} with
    cigar_ops = [("M", n) | ("N", gap)] in genomic order; duplicate genomic
    placements from different isoforms are collapsed (reference: map2gtf
    dedup, src/map2gtf.cpp:169)."""
    if tix.n == 0 or len(lengths) == 0:
        return {}
    min_len = int(np.min(lengths))
    max_len = int(np.max(lengths))
    al = transfer_alignments(align_reads_adaptive(
        tix.fm, reads_f, reads_r, np.asarray(lengths, np.int32),
        tix.tgenome.offsets.astype(np.int32),
        max_mismatches=params.read_mismatches,
        max_alignments=params.max_alignments,
        kmer_fast=kmer_fast_ok(tix.fm, min_len, params.read_mismatches),
        narrow_hits=min(8, params.hits_per_seed),
        wide_hits=params.hits_per_seed,
        uniform_len=min_len if min_len == max_len else 0))
    name2id = genome.name_to_id()
    toffs = tix.tgenome.offsets

    out: Dict[int, List[Tuple]] = {}
    seen: set = set()
    for r, c in zip(*np.nonzero(al.valid)):
        tp = int(al.pos[r, c])
        tnum = int(np.searchsorted(toffs, tp, side="right")) - 1
        tr = tix.transcripts[tnum]
        if tr.chrom not in name2id:
            continue
        local = tp - int(toffs[tnum])
        rl = int(lengths[r])
        try:
            gpos, ops = trans_to_genomic(tr.exons, local, [("M", rl)])
        except ValueError:
            continue  # read runs off the transcript end
        goff = int(genome.offsets[name2id[tr.chrom]])
        strand = int(al.strand[r, c])
        key = (int(r), strand, goff + gpos, tuple(ops))
        if key in seen:
            continue  # same genomic placement via another isoform
        seen.add(key)
        out.setdefault(int(r), []).append(
            (strand, goff + gpos, int(al.mm[r, c]), ops))
    return out


def transcriptome_candidates(trans_hits: Dict[int, List[Tuple]], events,
                             params) -> Dict[int, list]:
    """Turn rebased transcriptome hits into report Candidates, linking each
    N gap to its (known, auto-accepted) junction event. Pure-M hits become
    contiguous candidates; spliced hits become chain candidates whose
    chain_events all exist in the merged event table (GTF junctions are
    injected as known events by the driver)."""
    # (left, right) -> the last junction event there, built without a
    # Python pass over an annotation's hundreds of thousands of events
    jx = np.nonzero(np.asarray(events["kind"]) == KIND_JUNCTION)[0]
    ev_index = dict(zip(zip(np.asarray(events["left"])[jx].tolist(),
                            np.asarray(events["right"])[jx].tolist()),
                        jx.tolist()))

    out: Dict[int, list] = {}
    for r, hits in trans_hits.items():
        for s, gpos, hmm, ops in hits:
            if len(ops) == 1:
                out.setdefault(r, []).append(Candidate(
                    read=r, pos=gpos, strand=s, mm=hmm, kind=-1, ev=-1, t=0))
                continue
            chain_ops: List[Tuple] = []
            chain_events = []
            gp = gpos
            ok = True
            for op, n in ops:
                if op == "M":
                    chain_ops.append(("M", n))
                    gp += n
                elif op == "N":
                    e = ev_index.get((gp - 1, gp + n))
                    if e is None:
                        ok = False  # junction missing from the event table
                        break
                    chain_ops.append(("EV", e, KIND_JUNCTION, n))
                    chain_events.append(e)
                    gp += n
                else:
                    ok = False
                    break
            if not ok:
                continue
            out.setdefault(r, []).append(Candidate(
                read=r, pos=gpos, strand=s, mm=hmm, kind=-2, ev=-1, t=0,
                chain_ops=tuple(chain_ops),
                chain_events=tuple(chain_events)))
    return out
