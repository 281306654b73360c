#!/usr/bin/env python3
"""Time this checkout's coverage search against another checkout's on the
same inputs, in turns (other, this, this, other), and hold their event
tables equal.

Run from the root of a checkout, on a machine with a CUDA card:
  python3 scripts/coverage_ab.py --other DIR

DIR is the root of another checkout (for example the parent commit,
unpacked with `git archive`). Each side's
tophat_tpu_torch/pipeline/coverage.py and butterfly.py (the mer-extension
table and its check) are loaded from its own files: while a side loads
and runs, its butterfly module stands in for
tophat_tpu_torch.pipeline.butterfly; every other import resolves to this
checkout's package. The inputs are those of every
coverage_search_events call in three CLI runs on the card, made with
chip_smoke.py's generators and flags: phase 6's timed run (TopHat's
paired default mode, 32,768 pairs of 2 x 100 bp on the 2^27-base genome,
two chunk pairs), phase 8's (the same mode with -G, phase 8's annotation
and pairs) and phase 11's (phase 6's genome as 8 contigs,
--max-index-bases 2^25: 4 groups). Prints one JSON line: per phase, the
calls' genome bases, hits and events, each side's two runs (seconds on
the host clock, a synchronize around each call: per call, and summed over
the phase's calls), the coverage.* counters of each call on this side
(none where a side counts none) and the card.
"""

import argparse
import contextlib
import importlib.util
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUTTERFLY = "tophat_tpu_torch.pipeline.butterfly"
COUNTERS = ("coverage.mers", "coverage.pairs", "coverage.extendable")


@contextlib.contextmanager
def standing_in(butterfly):
    """sys.modules[BUTTERFLY] is `butterfly` inside the block (a module
    imported at load or at call time resolves to it)."""
    saved = sys.modules.get(BUTTERFLY)
    sys.modules[BUTTERFLY] = butterfly
    try:
        yield
    finally:
        if saved is None:
            sys.modules.pop(BUTTERFLY, None)
        else:
            sys.modules[BUTTERFLY] = saved


def load_module(root: str, stem: str, name: str):
    path = os.path.join(root, "tophat_tpu_torch", "pipeline", stem + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_side(root: str, tag: str):
    """(coverage module, butterfly module) of the checkout at root."""
    butterfly = load_module(root, "butterfly", f"bf_{tag}")
    with standing_in(butterfly):
        return load_module(root, "coverage", f"cov_{tag}"), butterfly


def keeping(fn, calls: list):
    """fn, appending each call's arguments to `calls`."""
    def kept(*args):
        calls.append(args)
        return fn(*args)
    return kept


def capture_runs(cs):
    """{phase: [coverage_search_events args, ...]} of the three runs."""
    from tophat_tpu_torch.cli import main as cli_mod
    from tophat_tpu_torch.pipeline import grouped as grouped_mod
    from tophat_tpu_torch.pipeline import run as run_mod

    os.makedirs(cs.CACHE, exist_ok=True)
    codes = cs.make_genome()
    juncs = cs.pick_junctions(codes)
    fa = os.path.join(cs.CACHE, "genome_2p27.fa")
    if not os.path.exists(fa):
        cs.write_fasta(fa, codes)
    index = os.path.join(cs.CACHE, "fm_2p27")

    def pairs(tag, m1, m2):
        fqs = [os.path.join(cs.CACHE, f"ab_{tag}_{k}.fq") for k in (1, 2)]
        cs.write_fastq(fqs[0], m1, "p")
        cs.write_fastq(fqs[1], m2, "p")
        return fqs

    gtf = os.path.join(cs.CACHE, "genes.gtf")
    gtf_text, transcripts, _ = cs.make_annotation(codes, juncs, cs.N_GENES)
    with open(gtf, "w") as f:
        f.write(gtf_text)
    m1, m2, _, _ = cs.make_annotated_pairs(codes, transcripts, juncs, 42,
                                           cs.N_PAIRS)
    annotated = pairs("annotated", m1, m2)
    cut = len(codes) // cs.GROUP_CONTIGS
    gfa = os.path.join(cs.CACHE, "genome_8x2p24.fa")
    if not os.path.exists(gfa):
        cs.write_fasta(gfa, codes, cuts=tuple(range(0, len(codes), cut)))
    gjuncs = [(a, b) for a, b in juncs if (a - cs.READ_LEN) // cut
              == (b + 3 * cs.READ_LEN + 400) // cut]
    runs = {
        "paired default (6)": ([], ["--tt-index", index, fa] + pairs(
            "paired", *cs.make_pairs(codes, juncs, 16, cs.N_PAIRS))),
        "annotated -G (8)": ([], [
            "-G", gtf, "--transcriptome-index",
            os.path.join(cs.CACHE, "tx", "genes"), "--tt-index", index,
            fa] + annotated),
        "grouped (11)": ([], [
            "--tt-index", os.path.join(cs.CACHE, "grp_2p27"),
            "--max-index-bases", str(cs.GROUP_MAX_BASES), gfa] + pairs(
                "grouped", *cs.make_pairs(codes, gjuncs, 72, cs.N_PAIRS,
                                          cut=cut))),
    }
    del codes
    saved = (run_mod.coverage_search_events,
             grouped_mod.coverage_search_events)
    env = {k: os.environ.get(k) for k in cs.GROUP_ENV}
    os.environ.update(cs.GROUP_ENV)
    try:
        for phase, (calls, argv) in runs.items():
            run_mod.coverage_search_events = keeping(saved[0], calls)
            grouped_mod.coverage_search_events = keeping(saved[1], calls)
            out = os.path.join(cs.CACHE, "ab_out_" + phase.split()[0])
            t0 = time.time()
            if cli_mod.main(["-o", out] + argv) != 0:
                sys.exit(f"coverage_ab: the {phase} run failed")
            print(f"{phase}: {time.time() - t0:.1f} s, {len(calls)} "
                  "coverage calls", file=sys.stderr, flush=True)
    finally:
        run_mod.coverage_search_events, \
            grouped_mod.coverage_search_events = saved
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {phase: calls for phase, (calls, _) in runs.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True)
    a = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("coverage_ab: needs a CUDA card")
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    from tophat_tpu_torch.utils import trace

    card = cs.card_line()
    sides = {"other": load_side(os.path.abspath(a.other), "other"),
             "this": load_side(REPO, "this")}
    captured = capture_runs(cs)
    result = {"card": card, "phases": {}}
    for phase, calls in captured.items():
        secs = {"other": [], "this": []}
        per_call = {"other": [], "this": []}
        outs, counted = {}, []
        for side in ("other", "this", "this", "other"):
            coverage, butterfly = sides[side]
            times, got = [], []
            with standing_in(butterfly):
                for args in calls:
                    before = trace.snapshot()["counters"]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got.append(coverage.coverage_search_events(*args))
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    after = trace.snapshot()["counters"]
                    if side == "this" and len(counted) < len(calls):
                        counted.append({k: after.get(k, 0)
                                        - before.get(k, 0)
                                        for k in COUNTERS if k in after})
            secs[side].append(sum(times))
            per_call[side].append(times)
            outs[side] = got
        for i, (x, y) in enumerate(zip(outs["other"], outs["this"])):
            for k in x:
                if not (np.array_equal(x[k], y[k])
                        and x[k].dtype == y[k].dtype):
                    sys.exit(f"coverage_ab: {phase} call {i}: '{k}' differs")
        result["phases"][phase] = dict(
            calls=len(calls),
            genome_bases=[int(args[0].n) for args in calls],
            hits=[int(args[3][2].sum()) for args in calls],
            events=[len(x["left"]) for x in outs["this"]],
            seconds=secs, per_call_seconds=per_call, counters=counted,
            equal=True)
        print(f"{phase}: other {secs['other']} s, this {secs['this']} s",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
