"""Sharded pipeline step: the align -> segment -> discover -> realign flow
over a ("reads", "genome") mesh, in one process.

Port of tophat_tpu/parallel/dist.py. Layout (the generalization of the
reference's thread model, see parallel/mesh.py):
  - the read batch splits over the "reads" axis; every reads shard sees the
    whole FM index, like each boost::thread seeing the whole genome
    (reference: segment_juncs.cpp:4763 SegmentSearchWorker fan-out)
  - each reads shard's candidate events are gathered in shard order and
    merged once — the analog of the reference's single-threaded
    JunctionSet merge (tophat_reports.cpp:2790 merge_with)
  - the merged event table is cut into ranges over the "genome" axis for
    realignment (each genome shard owns E/ng events), and the results
    re-join along the event axis

Realignment runs the realign kernel (ops/realign_kernel.realign_group) on
each (reads shard, genome shard) pair, not the JAX step's conv
formulation; the two agree on genomes without N. No production path calls
this step: the pipeline shards each stage itself (parallel/auto.py).
"""

from __future__ import annotations

import torch

from tophat_tpu_torch.ops import realign_kernel
from tophat_tpu_torch.ops.align import _align_one_strand
from tophat_tpu_torch.ops.splice import (_scan_windows, build_pair_windows,
                                         compact_windows)
from tophat_tpu_torch.ops.verify import same_contig
from tophat_tpu_torch.parallel import auto
from tophat_tpu_torch.parallel.mesh import GENOME_AXIS, READS_AXIS, split_rows
from tophat_tpu_torch.pipeline.prep import segment_offsets

H = 8   # segment hits kept per segment


def make_sharded_pipeline_step(mesh, *, read_len: int, segment_length: int,
                               max_mismatches: int = 2,
                               hits_per_seed: int = 16,
                               max_alignments: int = 16,
                               max_windows: int = 1024,
                               max_events: int = 256,
                               min_seg_intron: int = 50,
                               max_seg_intron: int = 500000):
    """The step as a function fn(fm, offsets, reads_f, reads_r, lengths) ->
    (aln_pos, aln_valid, aln_mm, n_hits, spl_mm, spl_t, spl_ok, n_events).

    The batch's rows split evenly over the reads axis (B must be a
    multiple of it). Read-axis outputs are gathered onto the mesh's first
    device in shard order; the realign tables' rows are each shard's
    forward rows, then its reverse-complement rows."""
    cuts_host = segment_offsets(read_len, segment_length)
    S = len(cuts_host) - 1
    max_seg_len = max(b - a for a, b in zip(cuts_host, cuts_host[1:]))
    nr = mesh.shape[READS_AXIS]
    ng = mesh.shape[GENOME_AXIS]
    ev_per_shard = max_events // ng
    if ev_per_shard * ng != max_events:
        raise ValueError(f"max_events {max_events} is no multiple of the "
                         f"genome axis ({ng})")

    def discover(fm, offsets, reads_f, reads_r, lengths):
        """Alignment, segments, windows and compacted candidates of one
        reads shard, on its device."""
        B, L = reads_f.shape
        dev = reads_f.device
        pf, mf, vf, _ = _align_one_strand(fm, reads_f, lengths,
                                          max_mismatches, hits_per_seed)
        pr, mr, vr, _ = _align_one_strand(fm, reads_r, lengths,
                                          max_mismatches, hits_per_seed)
        pos = torch.cat([pf, pr], dim=1)
        mm = torch.cat([mf, mr], dim=1)
        valid = torch.cat([vf, vr], dim=1)
        valid &= same_contig(offsets, pos, lengths[:, None])
        n_hits = valid.sum(dim=1).int()
        ium = n_hits == 0

        # segment mapping in genome space (fixed cuts)
        cuts_f = torch.tensor(cuts_host, dtype=torch.long, device=dev)
        cuts_r = read_len - cuts_f.flip(0)
        rowsg = torch.cat([reads_f, reads_r])
        cuts2 = torch.cat([cuts_f.expand(B, -1), cuts_r.expand(B, -1)])
        seg_len = cuts2[:, 1:] - cuts2[:, :-1]
        t = torch.arange(max_seg_len, device=dev)
        src = cuts2[:, :-1, None] + t
        ok = t < seg_len[:, :, None]
        rows = torch.arange(2 * B, device=dev)[:, None, None]
        segs = torch.where(ok, rowsg[rows, src.clamp(0, L - 1)],
                           torch.tensor(-1, dtype=rowsg.dtype, device=dev))
        sp, sm, sv, _ = _align_one_strand(
            fm, segs.reshape(2 * B * S, max_seg_len),
            seg_len.reshape(-1).clamp(min=1), max_mismatches, hits_per_seed)
        order = torch.sort((~sv).int(), dim=1, stable=True).indices[:, :H]
        take = lambda a: torch.gather(a, 1, order).reshape(2 * B, S, H)
        seg_pos, seg_valid = take(sp), take(sv)
        seg_valid &= torch.cat([ium, ium])[:, None, None]

        # junction discovery windows
        len2 = torch.cat([lengths, lengths])
        win = build_pair_windows(
            seg_pos, seg_valid, cuts2,
            torch.full((2 * B,), S, dtype=torch.long, device=dev), len2,
            min_seg_intron, max_seg_intron, segment_length)
        win, _ = compact_windows(win, max_windows)
        jl, jr, _, jvalid = _scan_windows(fm.genome, rowsg, win,
                                          max_seg_len + 17)

        # this shard's candidates, valid first, in fixed slots
        flat_v = jvalid.reshape(-1)
        order = torch.sort((~flat_v).int(), stable=True).indices[
            :ev_per_shard * ng]
        cand = (jl.reshape(-1)[order], jr.reshape(-1)[order], flat_v[order])
        sl = slice(0, max_alignments)
        return ((pos[:, sl], valid[:, sl], mm[:, sl], n_hits),
                (rowsg, len2.int()), cand)

    def realign(genome, rowsg, len2, left, right, valid):
        """The realign kernel on one (reads shard, genome shard) pair."""
        E = left.shape[0]
        dev = rowsg.device
        flank_l, comb = realign_kernel.prepare_targets(
            genome, left, right, torch.zeros(E, dtype=torch.int8, device=dev),
            torch.full((E, 8), -1, dtype=torch.int8, device=dev), 0,
            rowsg.shape[1])
        bt, mm, ok = realign_kernel.realign_group(
            rowsg.to(torch.int8).contiguous(), len2, flank_l, comb, 0,
            max_mismatches)
        ok = ok & valid[None, :]
        return bt, torch.where(ok, mm, realign_kernel.BIG), ok

    def step(fm, offsets, reads_f, reads_r, lengths):
        B = reads_f.shape[0]
        if B % nr:
            raise ValueError(f"batch of {B} rows does not split over "
                             f"{nr} reads shards")
        shards, _ = split_rows(mesh, reads_f, reads_r, lengths)
        per_shard = []
        for row, (rf, rr, ln) in zip(mesh.devices, shards):
            home = row[0]
            per_shard.append(discover(auto.replicated(fm, home),
                                      torch.as_tensor(offsets).to(home),
                                      rf, rr, ln.long()))

        # merge the candidates across reads shards, in shard order
        first = mesh.first
        gl, gr, gv = (torch.cat([p[2][k].to(first) for p in per_shard])[
            :max_events * 4] for k in range(3))
        order = torch.sort((~gv).int(), stable=True).indices[:max_events]
        ev_left, ev_right, ev_valid = gl[order], gr[order], gv[order]
        n_events = sum(int(p[2][2].sum()) for p in per_shard)

        # realignment, events range-cut over the genome axis
        outs = []
        for row, p in zip(mesh.devices, per_shard):
            rowsg, len2 = p[1]
            parts = []
            for g, dev in enumerate(row):
                ev = slice(g * ev_per_shard, (g + 1) * ev_per_shard)
                parts.append([x.to(row[0]) for x in realign(
                    auto.replicated(fm.genome, dev), rowsg.to(dev),
                    len2.to(dev), ev_left[ev].to(dev), ev_right[ev].to(dev),
                    ev_valid[ev].to(dev))])
            bt, mm, ok = (torch.cat([x[k] for x in parts], dim=1)
                          for k in range(3))
            outs.append(p[0] + (mm, bt, ok))
        return tuple(torch.cat([o[k].to(first) for o in outs])
                     for k in range(7)) + (n_events,)

    return step
