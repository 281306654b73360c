"""Device mesh and sharding layout.

Port of tophat_tpu/parallel/mesh.py. The reference's only parallelism is
read-range sharding across boost::threads with a single-threaded merge
(reference: src/utils.cpp:22 calculate_offsets; worker fan-outs at
segment_juncs.cpp:4763, long_spanning_reads.cpp:3052,
tophat_reports.cpp:2742). The layout generalizes it:

  axis "reads"  — data parallelism over the read batch (the analog of the
                  reference's per-thread read-ID ranges)
  axis "genome" — optional range sharding of the FM index over the genome
                  (for indexes larger than one card's memory)

One process drives every device: a stage splits its rows into contiguous
shards, launches each shard on its mesh device and gathers the results
onto the mesh's first device in row order (parallel/auto.py). A mesh's
device list may repeat a device, so a virtual mesh of shards on one card
(or on the CPU) runs the sharded path without a second device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

READS_AXIS = "reads"
GENOME_AXIS = "genome"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (reads, genome) grid of devices: devices[r][g] holds reads shard r
    of genome shard g."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {READS_AXIS: len(self.devices),
                GENOME_AXIS: len(self.devices[0])}

    @property
    def first(self) -> torch.device:
        """Where gathered results land: the device of the one-device run."""
        return self.devices[0][0]

    @property
    def reads_devices(self) -> List[torch.device]:
        """The device of each reads shard (genome shard 0)."""
        return [row[0] for row in self.devices]

    def flat(self) -> List[torch.device]:
        return [d for row in self.devices for d in row]


def _indexed(d: torch.device) -> torch.device:
    """A CUDA device with its index (tensors report cuda:<i>)."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_reads_shards: int | None = None, n_genome_shards: int = 1,
              devices=None) -> Mesh:
    """Mesh of `devices` (row-major: reads shard r, genome shard g is
    devices[r * n_genome_shards + g]); the list may repeat a device."""
    devices = [_indexed(torch.device(d)) for d in devices]
    n = len(devices)
    if n_reads_shards is None:
        n_reads_shards = n // n_genome_shards
    if n_reads_shards * n_genome_shards != n or n == 0:
        raise ValueError(f"{n_reads_shards}x{n_genome_shards} != {n} devices")
    return Mesh(tuple(tuple(devices[r * n_genome_shards:
                                    (r + 1) * n_genome_shards])
                      for r in range(n_reads_shards)))


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def split_rows(mesh: Mesh, *arrays):
    """Pad each array's leading dim (all equal) up to a multiple of the
    reads-axis size by edge replication and cut it into contiguous
    shards, shard i on reads device i. Returns (shards, B): shards[i] is a
    tuple of the arrays' i-th row shards, B the true row count. Pad rows
    compute duplicate results that gather_rows drops. B == 0: one shard,
    on the mesh's first device."""
    B = int(arrays[0].shape[0])
    tens = [_tensor(a) for a in arrays]
    if B == 0:
        return [tuple(t.to(mesh.first) for t in tens)], 0
    devs = mesh.reads_devices
    per = -(-B // len(devs))
    pad = per * len(devs) - B
    if pad:
        tens = [torch.cat([t, t[-1:].expand(pad, *t.shape[1:])]) for t in tens]
    return [tuple(t[i * per:(i + 1) * per].to(d) for t in tens)
            for i, d in enumerate(devs)], B


def gather_rows(mesh: Mesh, outs, B: int):
    """The row shards' outputs concatenated in shard order onto the mesh's
    first device and cut back to B rows. Each output is a tensor, or a
    tuple or dataclass of tensors with rows on dim 0."""
    dev = mesh.first

    def cat(parts):
        return torch.cat([p.to(dev) for p in parts])[:B]

    head = outs[0]
    if dataclasses.is_dataclass(head):
        return dataclasses.replace(head, **{
            f.name: cat([getattr(o, f.name) for o in outs])
            for f in dataclasses.fields(head)})
    if isinstance(head, tuple):
        return tuple(cat(list(p)) for p in zip(*outs))
    return cat(outs)


def visible_devices(device) -> List[torch.device]:
    """The devices a run on `device` may shard over: every visible card
    for a CUDA device (that device first), one CPU device for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device]
    first = device.index if device.index is not None \
        else torch.cuda.current_device()
    return [torch.device("cuda", i) for i in
            [first] + [i for i in range(torch.cuda.device_count())
                       if i != first]]
