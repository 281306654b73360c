#!/usr/bin/env python3
"""Time this checkout's realign kernel against another checkout's, on the
same inputs and the same card, in turns (other, this, this, other).

Run from the root of a checkout, on a machine with a CUDA card:
  python3 scripts/realign_ab.py --other DIR

DIR is the root of another checkout (for example the parent commit,
unpacked with `git archive`). Each side's tophat_tpu_torch/ops/
realign_kernel.py is loaded from its own file and builds its own
csrc/realign.cu into its own build/cuda. The inputs are chip_smoke.py's
phase-3 cases: one-hot operands (L <= 256, the annotated event count
included), then shift codes (257 to 16,384 positions). Both sides must
give equal (best_t, mm, ok); a case one side refuses (a width past its
limit raises ValueError) is timed on the other side alone. Prints one
JSON line: per case, the two runs of each side (ms, CUDA events, mean
over `--iters` launches, 3 above L = 300 or at the annotated event
count; an empty list for a side that refused it) and the card.
"""

import argparse
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_kernel(root: str, name: str):
    path = os.path.join(root, "tophat_tpu_torch", "ops", "realign_kernel.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build()
    return mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True)
    ap.add_argument("--iters", type=int, default=20)
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("realign_ab: needs a CUDA card")
    sys.path.insert(0, REPO)
    import chip_smoke

    sides = {"other": load_kernel(os.path.abspath(a.other), "rk_other"),
             "this": load_kernel(REPO, "rk_this")}
    out = []
    for ci, (R, E, L, q) in enumerate(chip_smoke.REALIGN_CASES):
        args = chip_smoke.realign_case(R, E, L, q, seed=11 + ci)
        got = {}
        for k, m in sides.items():
            try:
                got[k] = m.realign_group(*args, q, 8)
            except ValueError as e:
                print(f"R={R} E={E} L={L} q={q}: {k} refuses it ({e})",
                      file=sys.stderr, flush=True)
        torch.cuda.synchronize()
        if not got or len(got) == 2 and not all(
                torch.equal(x, y) for x, y in zip(got["other"],
                                                  got["this"])):
            sys.exit(f"realign_ab: the two kernels disagree (or both refuse)"
                     f" at R={R} E={E} L={L} q={q}")
        row = {"R": R, "E": E, "L": L, "q": q, "other_ms": [], "this_ms": []}
        for k in ("other", "this", "this", "other"):
            if k not in got:
                continue
            fn = sides[k].realign_group
            row[f"{k}_ms"].append(chip_smoke.cuda_ms(
                lambda: fn(*args, q, 8),
                a.iters if L <= 300 and R * E * L < 1e10 else 3))
        print(f"R={R} E={E} L={L} q={q}: other {row['other_ms']} ms, "
              f"this {row['this_ms']} ms", file=sys.stderr, flush=True)
        out.append(row)
    print(json.dumps({"card": chip_smoke.card_line(), "cases": out}),
          flush=True)


if __name__ == "__main__":
    main()
