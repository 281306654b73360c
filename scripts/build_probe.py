#!/usr/bin/env python3
"""Time the port's host FM-index build at the size of a human genome's
contig groups, stage by stage, and the index's save, load and transfer to
the card.

Two processes build at once, as `index/grouped.build_grouped_fm` builds a
3.1 Gbp genome's two groups: random codes of 1,950,000,000 and
1,143,000,000 bases at the grouped design point (k = 13, sa_rate 4).
Each prints one JSON line: seconds per build stage (the wrapped functions
of `index/fm.py`; nested ones overlap), the build's total, its peak
resident set, the .npz's bytes and save/load seconds, and, where CUDA is
present, `FMIndex.to("cuda")`'s seconds and bytes. The parent then prints
the wall time and the host's peak used memory (MemTotal - MemAvailable,
sampled every 2 s). Scratch files go to .bench_cache/probe/ (gitignored).

Run from the root of a checkout:   python3 scripts/build_probe.py
(one process of size N:            python3 scripts/build_probe.py N TAG)
"""

import json
import os
import resource
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRATCH = os.path.join(REPO, ".bench_cache", "probe")
GROUPS = ((1_950_000_000, "g0"), (1_143_000_000, "g1"))
STAGES = ("suffix_array", "bwt_from_sa", "_build_kmer_table", "_occ_tables",
          "pack_2bit", "pack_1bit", "_sub_block_counts")


def build_one(n: int, tag: str) -> None:
    sys.path.insert(0, REPO)
    from tophat_tpu_torch.index import fm as fmm

    times = {}

    def timed(name):
        fn = getattr(fmm, name)

        def call(*a, **k):
            t0 = time.time()
            try:
                return fn(*a, **k)
            finally:
                times[name] = times.get(name, 0.0) + time.time() - t0
        setattr(fmm, name, call)

    for name in STAGES:
        timed(name)
    t0 = time.time()
    codes = np.random.default_rng(n).integers(0, 4, n, dtype=np.int8)
    times["synth"] = time.time() - t0
    t0 = time.time()
    fm = fmm.build_fm_index(codes, kmer_k=13, sa_rate=4, device="cpu")
    times["build_total"] = time.time() - t0
    times["peak_rss_build"] = 1024 * resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss
    os.makedirs(SCRATCH, exist_ok=True)
    path = os.path.join(SCRATCH, f"{tag}.npz")
    try:
        t0 = time.time()
        fm.save(path)
        times["save"] = time.time() - t0
        times["file_bytes"] = os.path.getsize(path)
        del fm
        t0 = time.time()
        fm = fmm.FMIndex.load(path, device="cpu")
        times["load_cpu"] = time.time() - t0
    finally:
        if os.path.exists(path):
            os.remove(path)
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
        t0 = time.time()
        dev = fm.to("cuda")
        torch.cuda.synchronize()
        times["to_cuda"] = time.time() - t0
        times["dev_bytes"] = torch.cuda.memory_allocated()
        times["nbytes"] = dev.nbytes
    times["peak_rss"] = 1024 * resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss
    print(json.dumps(dict(tag=tag, n=n, **times)), flush=True)


def used_bytes() -> int:
    with open("/proc/meminfo") as f:
        m = dict(line.split(":", 1) for line in f)
    kb = int(m["MemTotal"].split()[0]) - int(m["MemAvailable"].split()[0])
    return kb * 1024


def main() -> int:
    for cmd in (["nproc"], ["free", "-g"], ["df", "-h", REPO],
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]):
        try:
            print(subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=60).stdout.strip(), flush=True)
        except OSError as e:
            print(f"{cmd[0]}: {e}", flush=True)
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               str(n), tag]) for n, tag in GROUPS]
    peak = 0
    try:
        while any(p.poll() is None for p in procs):
            peak = max(peak, used_bytes())
            time.sleep(2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(json.dumps(dict(wall_s=time.time() - t0, peak_host_used=peak,
                          rcs=[p.returncode for p in procs])), flush=True)
    return max(abs(p.returncode) for p in procs)


if __name__ == "__main__":
    if len(sys.argv) == 3:
        build_one(int(sys.argv[1]), sys.argv[2])
    else:
        sys.exit(main())
