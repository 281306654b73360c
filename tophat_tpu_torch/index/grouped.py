# Port of tophat_tpu/index/grouped.py; groups build on the host as CPU tensors.
"""Contig-group partitioned FM indexes: whole-genome scale on int32 device
coordinates.

Every device-side coordinate in the pipeline is int32 (positions, events,
suffix arrays), which caps one index at ~2.1 Gbp. A genome beyond that
(human: 3.1 Gbp, TopHat's main use) is partitioned into groups of whole
contigs, each small enough for int32-local coordinates. Each group gets
its own FM index, built on the host and held as CPU tensors; the pipeline
moves one group at a time to the card (FMIndex.to), runs its device stages
per group, and merges the results at int64 global coordinates on the host
(pipeline/grouped.py).

Group indexes persist as <prefix>.g<i>.tt.npz, the JAX package's names and
layout, so either package reuses a cache the other wrote. A cache file
that is stale or corrupt is rebuilt; any other error while it loads
propagates.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

from tophat_tpu_torch.index.fasta import Genome
from tophat_tpu_torch.index.fm import STALE_INDEX, FMIndex, build_fm_index

# int32-safe group capacity, with margin for rebased arithmetic
MAX_GROUP_BASES = (1 << 31) - (1 << 27)


def contig_group_ranges(genome: Genome,
                        max_bases: int = MAX_GROUP_BASES) -> List[range]:
    """Greedy split of contigs (in FASTA order) into groups whose total
    length fits max_bases. A single contig longer than max_bases is an
    error — no real chromosome approaches 2.1 Gbp."""
    lens = genome.contig_lengths()
    groups: List[range] = []
    start = 0
    acc = 0
    for i, ln in enumerate(lens):
        ln = int(ln)
        if ln > max_bases:
            raise SystemExit(
                f"Error: contig {genome.names[i]!r} is {ln} bases, larger "
                f"than the per-group limit {max_bases}")
        if acc + ln > max_bases and acc:
            groups.append(range(start, i))
            start, acc = i, 0
        acc += ln
    groups.append(range(start, len(lens)))
    return groups


@dataclasses.dataclass
class GroupedFM:
    """FM indexes (CPU tensors) over contig groups plus their sub-genomes
    and global base offsets (int64)."""

    fms: List[FMIndex]
    sub_genomes: List[Genome]
    bases: np.ndarray            # (G,) int64 global start of each group

    @property
    def n_groups(self) -> int:
        return len(self.fms)


def sub_genome(genome: Genome, cids: range) -> Genome:
    """Sub-Genome over a contig range, local coordinates (views, no copy)."""
    s = int(genome.offsets[cids.start])
    e = int(genome.offsets[cids.stop])
    return Genome(codes=genome.codes[s:e],
                  offsets=(genome.offsets[cids.start: cids.stop + 1]
                           - s).astype(np.int64),
                  names=[genome.names[i] for i in cids])


def _save(fm: FMIndex, path: str, tmp: str) -> None:
    """Write `fm` to `tmp`, then rename it to `path` (readers never see a
    half-written file)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    fm.save(tmp)
    os.replace(tmp if os.path.exists(tmp) else tmp + ".npz", path)


def build_grouped_fm(genome: Genome, max_bases: int = MAX_GROUP_BASES,
                     kmer_k: int = 0, sa_rate: int = 0,
                     cache_prefix: Optional[str] = None,
                     log=None) -> GroupedFM:
    """Build (or load from <cache_prefix>.g<i>.tt.npz) one FM index per
    contig group, on the host. Missing groups build concurrently in worker
    processes when host memory allows (the builds are independent, and the
    SA-IS and gather passes are single-threaded per group, so m groups on
    m cores overlap to about the slowest group's wall time). Workers are
    forked, sharing the parent's genome pages copy-on-write (spawn would
    pickle each group's codes and re-run the caller's main module in every
    worker). A worker builds on the host only, with numpy and the native
    SA-IS: it never touches torch.cuda, which a child forked after the
    parent initialised CUDA cannot use. Results come back through the .npz
    files (in a temporary dir when uncached); a group whose worker failed
    is rebuilt in this process."""
    import tempfile

    ranges = contig_group_ranges(genome, max_bases)
    subs: List[Genome] = [sub_genome(genome, cids) for cids in ranges]
    bases = np.array([int(genome.offsets[cids.start]) for cids in ranges],
                     np.int64)
    tmpdir = None
    if cache_prefix:
        paths = [f"{cache_prefix}.g{i}.tt.npz" for i in range(len(ranges))]
    else:
        tmpdir = tempfile.mkdtemp(prefix="ttfm_groups_")
        paths = [os.path.join(tmpdir, f"g{i}.tt.npz")
                 for i in range(len(ranges))]

    fms: List[Optional[FMIndex]] = [None] * len(ranges)
    todo = []
    for i, sg in enumerate(subs):
        if cache_prefix and os.path.exists(paths[i]):
            try:
                fm = FMIndex.load(paths[i], device="cpu")
            except STALE_INDEX:
                fm = None               # stale/corrupt file: rebuild below
            if fm is not None and fm.n == sg.n:
                fms[i] = fm
                if log:
                    log(f"group {i}: reusing FM index {paths[i]}")
                continue
        todo.append(i)

    def build_one(i, save_path):
        fm = build_fm_index(subs[i], kmer_k=kmer_k, sa_rate=sa_rate,
                            device="cpu")
        if save_path:
            try:
                _save(fm, save_path, save_path + ".tmp")
            except OSError:
                pass            # read-only location: keep in-memory only
        return fm

    n_workers = _build_workers(subs, todo)
    if len(todo) >= 2 and n_workers >= 2:
        import multiprocessing as mp

        ctx = mp.get_context("fork")
        if log:
            log(f"building {len(todo)} group indexes with "
                f"{min(n_workers, len(todo))} concurrent workers")
        # largest groups first so the tail isn't a big straggler
        order = sorted(todo, key=lambda i: -subs[i].n)
        running: List = []
        failed = []
        for i in order:
            while len(running) >= n_workers:
                j, pr = running.pop(0)
                pr.join()
                if pr.exitcode != 0:
                    failed.append(j)
            pr = ctx.Process(target=_group_build_child,
                             args=(subs[i], kmer_k, sa_rate, paths[i]))
            pr.start()
            running.append((i, pr))
        for j, pr in running:
            pr.join()
            if pr.exitcode != 0:
                failed.append(j)
        for i in todo:
            if i in failed or not os.path.exists(paths[i]):
                if log:
                    log(f"group {i}: worker failed, rebuilding in-process")
                fms[i] = build_one(i, paths[i] if cache_prefix else None)
            else:
                fms[i] = FMIndex.load(paths[i], device="cpu")
    else:
        for i in todo:
            if log:
                log(f"group {i}: building FM index over {subs[i].n} "
                    f"bases ({len(subs[i].names)} contigs)")
            fms[i] = build_one(i, paths[i] if cache_prefix else None)

    if tmpdir is not None:
        import shutil

        shutil.rmtree(tmpdir, ignore_errors=True)
    return GroupedFM(fms=fms, sub_genomes=subs, bases=bases)


def _group_build_child(sg: Genome, kmer_k: int, sa_rate: int,
                       path: str) -> None:
    """Worker: build one group's index on the host and persist it for the
    parent (results return via the filesystem, not pickling)."""
    fm = build_fm_index(sg, kmer_k=kmer_k, sa_rate=sa_rate, device="cpu")
    _save(fm, path, path + f".tmp{os.getpid()}")


# host scratch of one group's build, bytes per base at k = 13, sa_rate 4:
# a 1.95 Gbp group's forked worker peaked at 31.3 GiB resident on an H100
# host, ~3.5 GiB of it pages shared with its parent
BUILD_BYTES_PER_BASE = 16


def _mem_available() -> Optional[int]:
    """MemAvailable of /proc/meminfo in bytes, None where unreadable."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def _build_workers(subs, todo, avail: Optional[int] = None) -> int:
    """Concurrent group-build budget: one worker per core, bounded so the
    summed construction scratch of the builds that can run at once (the
    largest ones: workers take groups largest first) stays inside 70% of
    available host memory. A human genome's two groups (1.95 and 1.143
    Gbp, ~49 GB together) build at once on a host with ~71 GB free."""
    if len(todo) < 2:
        return 1
    avail = _mem_available() if avail is None else avail
    if avail is None:
        return 1
    sizes = sorted((subs[i].n for i in todo), reverse=True)
    w, need = 0, 0
    for n in sizes[:os.cpu_count() or 1]:
        need += n * BUILD_BYTES_PER_BASE
        if w and need > avail * 0.7:
            break
        w += 1
    return w
