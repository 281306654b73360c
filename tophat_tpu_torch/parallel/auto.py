"""Automatic multi-device execution of the production pipeline.

Port of tophat_tpu/parallel/auto.py. The reference parallelizes every
heavy per-read loop by read-range sharding across boost::threads with
private result sets merged single-threaded (reference: src/utils.cpp:22
calculate_offsets; worker fan-outs at segment_juncs.cpp:4763,
long_spanning_reads.cpp:3052, tophat_reports.cpp:2742-2815). Here, when a
mesh is active, every device stage of the pipeline — full-read alignment,
segment mapping, junction/indel/fusion window scans and event
realignment (the realign kernel, once per row shard) — splits its rows
into contiguous shards over the mesh's "reads" axis, launches each shard
on its device with the FM index and genome placed there, and gathers the
results onto the mesh's first device in row order; the stages after it
are the one-device code. Rows are padded by edge replication and cut
back. Each sharded stage computes a row from that row alone, except the
segment search's flat lane cap, which spans the batch: its shards return
their lanes flat and the cap applies once over them in row order
(ops/beam.beam_align_rows). So the outputs equal the one-device run's;
tests/test_torch_multidevice.py and chip_smoke.py phase 13 hold them byte
for byte. The genome axis (parallel/shard_fm.py) keeps JAX's per-shard
caps, and equals the one-index run where none of them binds.

One process drives all devices (JAX's single-controller shape), not
torch.distributed: NCCL cannot put two ranks on one card, and a mesh
whose device list repeats one card is how the sharded path runs on a
machine with one card.

Activation: the CLI calls auto_activate(device) with its resolved device:
a reads-axis mesh over every visible card (parallel/mesh.visible_devices;
TOPHAT_TPU_DEVICES=<n> caps the count, 1 disables), and deactivate()
when the run ends.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from tophat_tpu_torch.parallel import mesh as mesh_mod
from tophat_tpu_torch.parallel.mesh import (READS_AXIS, gather_rows,
                                            make_mesh, split_rows)
from tophat_tpu_torch.utils.device import resolve_device

_MESH = None
_REPL: List[Tuple[Any, Dict[torch.device, Any]]] = []  # (host, replicas)
_GSHARD = None  # range-sharded FM state (see configure_genome_axis)

# Share of a device's memory a replicated FM index may take before the
# genome axis activates: the rest is left for read batches, hit tables
# and scratch (JAX's 10 GiB of a 16 GiB chip)
HBM_SHARE = 10 / 16


def active():
    return _MESH


def activate(mesh) -> None:
    global _MESH
    _MESH = mesh
    _REPL.clear()


def deactivate() -> None:
    global _MESH, _GSHARD
    _MESH = None
    _GSHARD = None
    _REPL.clear()


def auto_activate(device, log=None) -> None:
    """Build a reads-axis mesh over the devices visible to a run on
    `device` (every card for CUDA, one device for the CPU), if more than
    one. TOPHAT_TPU_DEVICES=<n> caps the count; 1 disables sharding. A
    CUDA device without CUDA raises."""
    devices = mesh_mod.visible_devices(resolve_device(device))
    n = len(devices)
    cap = os.environ.get("TOPHAT_TPU_DEVICES")
    if cap is not None:
        n = min(n, max(1, int(cap)))
    if n <= 1:
        deactivate()
        return
    activate(make_mesh(n_reads_shards=n, n_genome_shards=1,
                       devices=devices[:n]))
    if log:
        log(f"multi-device: sharding read batches over {n} devices")


def n_row_shards() -> int:
    return 1 if _MESH is None else _MESH.shape[READS_AXIS]


def shard_rows(*arrays):
    """The arrays' rows cut into the active mesh's reads shards, padded by
    edge replication (mesh.split_rows). Returns (shards, B)."""
    return split_rows(_MESH, *arrays)


def _leaves(tree):
    """(leaves, rebuild) of a dataclass or dict of arrays."""
    if dataclasses.is_dataclass(tree):
        names = [f.name for f in dataclasses.fields(tree)]
        return ([getattr(tree, k) for k in names],
                lambda xs: dataclasses.replace(tree, **dict(zip(names, xs))))
    names = list(tree)
    return [tree[k] for k in names], lambda xs: dict(zip(names, xs))


def shard_pytree_rows(tree):
    """shard_rows for a dataclass or dict whose every field has the same
    leading dim. Returns (shards, B), each shard of the tree's type."""
    leaves, rebuild = _leaves(tree)
    shards, B = shard_rows(*leaves)
    return [rebuild(s) for s in shards], B


def by_rows(local, *rows, fm=None, sharded=None, merge=None):
    """A row-wise device stage under the active mesh — the one place that
    decides how a stage splits:

      no mesh, or no rows      local(None, *rows): the one-device run;
      fm range-sharded         sharded(): the genome-axis search;
      otherwise                `rows` (arrays, or one dataclass/dict of
                               row arrays) cut into the reads shards,
                               local(device, *shard) on each reads device,
                               gathered in row order — or merge(outs, per,
                               B) where the stage merges its own shards
                               (per rows a shard, B true rows).

    `local` places what it needs with replicated(x, device), or x.to(device)
    for per-call tensors; both keep x as it is for device None. The shards
    run in order and nothing is caught: an error in one propagates."""
    tree = len(rows) == 1 and not hasattr(rows[0], "shape")
    lead = _leaves(rows[0])[0][0] if tree else rows[0]
    if _MESH is None or lead.shape[0] == 0:
        return local(None, *rows)
    if sharded is not None and genome_sharded(fm):
        return sharded()
    if tree:
        shards, B = shard_pytree_rows(rows[0])
        shards = [(s,) for s in shards]
    else:
        shards, B = shard_rows(*rows)
    outs = [local(d, *s) for d, s in zip(_MESH.reads_devices, shards)]
    if merge is not None:
        return merge(outs, -(-B // len(shards)), B)
    return gather_rows(_MESH, outs, B)


def replicated(obj, device):
    """`obj` (a tensor or an FMIndex) on `device`: obj itself where it
    already lives there (so shards of a virtual mesh on one card share one
    copy) or device is None, else a copy, identity-cached so the FM index
    and genome are placed once per pipeline. The cache holds 16 objects
    (bounding the device memory it pins)."""
    if device is None or obj.device == device:
        return obj
    for host, reps in _REPL:
        if host is obj:
            if device not in reps:
                reps[device] = obj.to(device)
            return reps[device]
    _REPL.append((obj, {device: obj.to(device)}))
    if len(_REPL) > 16:
        _REPL.pop(0)
    return _REPL[-1][1][device]


def release(obj) -> None:
    """Evict `obj` from the replication cache, so its copies free once
    callers drop theirs (throwaway indexes — the colorspace transition
    index, a swapped-out contig group — must not stay pinned)."""
    _REPL[:] = [(h, r) for h, r in _REPL if h is not obj]


def device_budget(devices) -> int:
    """Bytes a replicated FM index may take per device: HBM_SHARE of the
    smallest mesh device's memory (a card's total memory; the host's RAM
    for the CPU)."""
    def total(d):
        if d.type == "cuda":
            return torch.cuda.get_device_properties(d).total_memory
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return int(min(total(d) for d in set(devices)) * HBM_SHARE)


def genome_sharded(fm=None) -> bool:
    """True when the FM index is range-sharded over the mesh's genome axis
    (the FM-search stages route through parallel/shard_fm then).

    fm: when given, additionally require that it is the index the shards
    were built from — auxiliary indexes (colorspace, transcriptome) fall
    through to the replicated path, not search the base-genome shards."""
    if _GSHARD is None:
        return False
    return fm is None or _GSHARD["src"] is fm


def configure_genome_axis(fm, genome, max_read_len: int, log=None) -> None:
    """Range-shard the FM index over a genome mesh axis when replicating it
    would exceed the per-device budget (the reference has no analog —
    bowtie replicates its whole-genome index into every process,
    src/tophat.py:2286).

    Idempotent per (fm, mesh). Budget: $TOPHAT_TPU_HBM_BYTES, else
    device_budget of the mesh's devices; $TOPHAT_TPU_GENOME_SHARDS forces
    a shard count. The mesh factors n_devices into (reads=n/g, genome=g)
    with g the smallest divisor of n that brings every sub-index under
    budget. Sub-indexes are built on the host from the genome codes and
    placed on genome shard j's device of the first reads row."""
    global _GSHARD
    if _MESH is None or fm is None or genome is None:
        return
    if _GSHARD is not None and _GSHARD["src"] is fm:
        if max_read_len <= _GSHARD["overlap"] + 1:
            return
    devices = _MESH.flat()
    n_dev = len(devices)
    forced = os.environ.get("TOPHAT_TPU_GENOME_SHARDS")
    budget = os.environ.get("TOPHAT_TPU_HBM_BYTES")
    budget = int(budget) if budget is not None else device_budget(devices)
    nbytes = fm.nbytes
    if forced is not None:
        g = max(1, int(forced))
    else:
        g = next((d for d in range(1, n_dev + 1)
                  if n_dev % d == 0 and nbytes / d <= budget), n_dev)
    if g <= 1 or n_dev % g:
        return
    from tophat_tpu_torch.parallel import shard_fm

    overlap = max(2 * int(max_read_len), 256)
    activate(make_mesh(n_reads_shards=n_dev // g, n_genome_shards=g,
                       devices=devices))
    t0 = time.perf_counter()
    subs, starts = shard_fm.build_sharded_fm(
        genome, g, overlap, kmer_k=fm.kmer_k, sa_rate=fm.sa_rate,
        devices=_MESH.devices[0])
    n_bases = int(np.asarray(genome.codes).shape[0])
    _GSHARD = dict(src=fm, subs=subs, starts=starts,
                   owned_width=(n_bases + g - 1) // g, overlap=overlap, g=g)
    if log:
        log(f"index range-sharded over {g} devices "
            f"({nbytes / (1 << 30):.2f} GiB total, "
            f"{subs[0].nbytes / (1 << 30):.2f} GiB/device, built in "
            f"{time.perf_counter() - t0:.1f} s; reads axis {n_dev // g})")


def _gshard_args():
    gs = _GSHARD
    return _MESH, gs["subs"], gs["starts"], gs["owned_width"]


def sharded_align(reads_f, reads_r, lengths, offsets, **kw):
    """Full-read alignment against the range-sharded index (both strands;
    shard_fm.sharded_align). Only call when genome_sharded()."""
    from tophat_tpu_torch.parallel import shard_fm

    return shard_fm.sharded_align(*_gshard_args(), offsets, reads_f,
                                  reads_r, lengths, **kw)


def sharded_align_rows(reads, lengths, offsets, **kw):
    """Forward-rows (segment) alignment against the range-sharded index
    (shard_fm.sharded_align_rows)."""
    from tophat_tpu_torch.parallel import shard_fm

    return shard_fm.sharded_align_rows(*_gshard_args(), offsets, reads,
                                       lengths, **kw)


def sharded_beam_rows(reads, lengths, offsets, *, max_hits, plan):
    """Half-split + variant segment search against the range-sharded index
    (shard_fm.sharded_beam_rows)."""
    from tophat_tpu_torch.parallel import shard_fm

    return shard_fm.sharded_beam_rows(*_gshard_args(), offsets, reads,
                                      lengths, max_hits=max_hits, plan=plan)
