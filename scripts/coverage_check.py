#!/usr/bin/env python3
"""Every coverage search of one traced window against the plain reference.

    python3 scripts/coverage_check.py --workload fly_default.pe100 \
        --seed N [--seconds 51] [--batch-size B] [--out FILE.json]

Runs the cell as `benchmarks/run.py --trace 1` does (core.run_cell) with a
hook on tophat_tpu_torch.pipeline.run:coverage_search_events that keeps
each call's segment hits, IUM forward rows and events; after the run it
works every call out again with benchmarks/reference/coverage.py and
holds the two equal as sets and in order. Per call it reports the rows
and hits it took, the program's counters (coverage.sites, .mers, .pairs,
.extendable, .events, .dropped) and the seconds of its three phase spans
(coverage_search.islands, .mers, .pairs). --batch-size B runs a copy of
the cell's configuration with `--batch-size B` added to its flags (a
temporary file, so a call's input is B reads of one mate). Prints one
JSON object last; --out writes it too. Needs a CUDA card.
"""

import argparse
import json
import os
import sys
import tempfile
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = "tophat_tpu_torch.pipeline.run:coverage_search_events"


def variant(name: str, batch_size: int, tmp: str):
    """The path of a BENCHMARK.json whose copy of the cell's configuration
    adds --batch-size to its flags."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    w = next(w for w in bench["workloads"] if w["name"] == name)
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(os.path.join(ROOT, c["file"])) as f:
        cfg = json.load(f)
    cfg["tophat_flags"] = cfg["tophat_flags"] + ["--batch-size",
                                                 str(batch_size)]
    c["file"] = os.path.join(tmp, "config.json")
    with open(c["file"], "w") as f:
        json.dump(cfg, f)
    path = os.path.join(tmp, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f)
    return path


def per_call(records) -> list:
    """Each coverage_search call's span seconds and counters, in order,
    from the tracer's records (children close before their parent)."""
    calls, pending = [], []
    for r in records:
        if r.name.startswith("coverage_search."):
            pending.append(r)
        elif r.name == "coverage_search":
            c = {"wall_s": r.wall_s, "self_s": r.self_s,
                 "counts": dict(r.counts)}
            for p in pending:
                c[p.name.split(".", 1)[1] + "_s"] = p.wall_s
                c["counts"].update(p.counts)
            calls.append(c)
            pending = []
    return calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--batch-size", type=int)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    import numpy as np
    import torch

    from benchmarks.harness import clock, core
    from benchmarks.reference import coverage as ref
    from tophat_tpu_torch.utils import trace

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    log = lambda m: print(m, file=sys.stderr, flush=True)  # noqa: E731
    calls, genome = [], {}

    def make(fn):
        def call(fm, g, gs, seg_tables, params):
            out = fn(fm, g, gs, seg_tables, params)
            genome.setdefault("codes", g.codes)
            genome.setdefault("offsets", np.asarray(g.offsets))
            pos, _mm, valid = (t.cpu().numpy() if hasattr(t, "cpu")
                               else np.asarray(t) for t in seg_tables)
            hs, hl, rows = ref.call_inputs(gs.readsg, gs.lengths, gs.strand,
                                           gs.cuts, pos, valid)
            calls.append({"hits": (hs.copy(), hl.copy()),
                          "rows": [r.copy() for r in rows],
                          "gs_rows": int(gs.rows),
                          "range": (params.min_coverage_intron,
                                    params.max_coverage_intron),
                          "out": (out["left"].copy(), out["right"].copy(),
                                  out["antisense"].copy())})
            return out
        return call

    hooks = clock.Hooks()
    if not hooks.replace(TARGET, make):
        raise SystemExit(f"{TARGET} is not there")
    with tempfile.TemporaryDirectory(prefix="coverage_check_") as tmp:
        bench = variant(args.workload, args.batch_size, tmp) \
            if args.batch_size else None
        try:
            result = core.run_cell(ROOT, args.workload, args.seed,
                                   args.seconds, True, T_START,
                                   bench_path=bench, log=log)
        finally:
            hooks.restore()
    traced = per_call(trace.snapshot()["records"])
    # the warm sample's calls come first, with the tracer off
    calls = calls[len(calls) - len(traced):]
    if not traced or len(calls) != len(traced):
        raise SystemExit(f"{len(calls)} calls hooked, {len(traced)} traced")

    report = []
    t0 = time.perf_counter()
    for k, (c, t) in enumerate(zip(calls, traced)):
        want = ref.coverage_events(genome["codes"], genome["offsets"],
                                   *c["hits"], c["rows"], *c["range"])
        got = c["out"]
        pairs = lambda x: list(zip(x[0].tolist(), x[1].tolist(),  # noqa
                                   x[2].tolist()))
        equal = all(np.array_equal(np.asarray(a, np.int64),
                                   np.asarray(b, np.int64))
                    for a, b in zip(got, want))
        report.append(dict(
            t, call=k, gs_rows=c["gs_rows"], forward_rows=len(c["rows"]),
            hits=int(len(c["hits"][0])), events=int(len(got[0])),
            reference_events=int(len(want[0])), equal_in_order=equal,
            equal_as_sets=set(pairs(got)) == set(pairs(want))))
        log(f"call {k}: {report[-1]}")
    out = {"workload": args.workload, "seed": args.seed,
           "batch_size": args.batch_size,
           "card": torch.cuda.get_device_name(0),
           "correct": result["correct"], "metrics": result["metrics"],
           "checks": result["checks"], "device": result["device"],
           "calls": report, "reference_s": time.perf_counter() - t0,
           "all_equal": all(r["equal_in_order"] and r["equal_as_sets"]
                            for r in report),
           "events": sum(r["events"] for r in report)}
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
