#!/usr/bin/env python3
"""The benchmark of tophat_tpu_torch on one NVIDIA card: one run of a cell.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic mix,
per-layer metric readers and limits are found by name from BENCHMARK.json
(benchmarks/harness/spec.py). Set-up makes the genome and annotation from
the configuration's seeds and loads (on a checkout's first run: builds)
the port's indexes under benchmarks/.cache/; the window maps whole samples
through tophat_tpu_torch's streaming paired pipeline
(benchmarks/harness/core.py). The last line of standard output is the
result as one JSON object; the numbers compared for `correct`, each with
its limit, are the last lines of standard error. With no CUDA card, or
fewer cards than the cell asks for, it exits 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    import torch

    from benchmarks.harness import core, spec

    cell = spec.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = core.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), T_START)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    for k, v in result["checks"].items():
        print(f"{k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
