#!/usr/bin/env python3
"""Readings for a cell's limits: the program's numbers on many seeds and
the control's on a few, in one process.

    python3 benchmarks/readings.py --workload <cell> --seeds 11,12,... \
        --control 3 [--out readings.json]

Set-up once (as a run of the cell), then per seed one whole sample of the
cell's mix, sample 0 of a run with that seed, mapped as the window maps
it and checked as a run checks it. For the first `--control` seeds the
same outputs are checked again with the control in the program's place
(reference/control.py). Prints one JSON object: per seed the program's
numbers, per control seed the control's, and for each number the largest
program reading and the smallest control reading. The benchmark's own
runs do not run this.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(root, name, seeds, n_control, device="cuda", bench_path=None,
             data_dirs=(), cache=None, log=print):
    import torch

    from benchmarks.harness import clock as clockmod
    from benchmarks.harness import core, spec
    from benchmarks.harness import world as worldmod
    from benchmarks.reference import check as checkmod
    from benchmarks.reference import control

    cell = spec.load_cell(root, name, bench_path, data_dirs)
    cuda = device.startswith("cuda")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    world = worldmod.make(cell.config, cache or os.path.join(spec.HERE,
                                                             ".cache"),
                          device)
    anchor = int(cell.traffic["anchor"])
    out = {"cell": name, "program": {}, "control": {}}
    tmp = tempfile.mkdtemp(prefix="bench_readings_")
    try:
        for k, seed in enumerate(seeds):
            hooks = clockmod.Hooks()
            run = core.Runner(cell, world, seed, os.path.join(tmp, str(k)),
                              sync, log)
            os.makedirs(run.tmp)
            run.capture_realign(hooks)
            t0 = time.perf_counter()
            try:
                dt = run.sample(core.WINDOW, 0, run.n_pairs, keep=True)
            finally:
                hooks.restore()
            nums = {n: v["value"] for n, v in run.check(device).items()}
            nums["sample_s"] = dt
            out["program"][seed] = nums
            log(f"seed {seed}: {nums} ({time.perf_counter() - t0:.1f} s)")
            if k < n_control and run.done:
                d = run.done[0]
                bits = control.significand_bits(len(world.codes))
                sam, bed = d.sam + ".f32", d.bed + ".f32"
                control.round_sam(d.sam, sam, world.layout, bits)
                control.round_bed(d.bed, bed, world.layout, bits)
                tally = checkmod.check_sample(
                    world.codes, world.layout, d.truth, d.pairs, sam, bed,
                    anchor, run.min_intron, world.given,
                    world.true_introns)
                cn = tally.numbers()
                events = run.pick_realign()[0][2]
                cn.update(run.check_realign(
                    device, *control.rounded_events(events, bits)))
                out["control"][seed] = cn
                log(f"control, seed {seed}: {cn}")
            shutil.rmtree(run.tmp, ignore_errors=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    names = ("unspliced_missed_pct", "spliced_missed_pct", "records_wrong",
             "bed_spurious_pct", "realign_wrong", "events_missed")
    out["lower"] = {n: max(v[n] for v in out["program"].values())
                    for n in names}
    out["upper"] = {n: min(v[n] for v in out["control"].values())
                    for n in names} if out["control"] else {}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    log = lambda m: print(m, file=sys.stderr, flush=True)
    res = readings(ROOT, args.workload,
                   [int(s) for s in args.seeds.split(",")], args.control,
                   log=log)
    text = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
