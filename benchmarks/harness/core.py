"""One run of one cell: set-up, the measured window, the check, the result.

The window is a closed loop with one client: samples of the mix's size,
each drawn from (seed, sample index), go one after another through the
call the port's CLI makes once the index and annotation are loaded (the
configuration's entry point, entries/: by default the paired or
single-end streaming pipeline), with the sample's FASTQ files parsed and
every output file written inside the clock. Writing the FASTQ files and
deleting the outputs happen with the clock stopped. New samples start until the timed seconds reach
`seconds`; the last one runs to its end.

With trace=1 the window runs under the stage clock (a synchronize around
each clocked stage), then one more sample runs under torch.profiler; the
result holds the per-layer metrics, read by the readers under metrics/.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np

from benchmarks.gen.pairs import make_pairs, revcomp, sample_rng, write_fastq
from benchmarks.harness import clock as clockmod
from benchmarks.harness import profile as profmod
from benchmarks.harness import spec as specmod
from benchmarks.harness import world as worldmod
from benchmarks.reference import check as checkmod
from benchmarks.reference import control as controlmod
from benchmarks.reference import realign as realignref

FORBIDDEN = ("jax", "jaxlib", "flax", "tophat_tpu")
WINDOW, WARM, CHECK = 0, 1, 2   # seed streams (gen.pairs)
REALIGN_ENTRY = "tophat_tpu_torch.pipeline.run:realign_events_sparse"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.partition(".")[0] in FORBIDDEN})


def host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class Done:
    """One sample that ran: its reads, its checked pairs and their truth,
    and where its kept outputs are."""

    index: int
    reads: tuple             # (mate 1[, mate 2]) code rows
    truth: object
    pairs: np.ndarray
    sam: str
    bed: str
    crossed: set             # introns its mates cross (reference.check)


class Probe:
    """What a per-layer metric's reader may install and read."""

    def __init__(self, hooks, clock):
        self.hooks = hooks
        self.clock = clock
        self.samples = 0
        self.sample_seconds = 0.0
        self.trace = None
        self.state = {}

    def per_sample(self, label: str):
        """Self seconds a sample of a clocked stage; None if it never
        ran."""
        if not self.clock.calls.get(label) or not self.samples:
            return None
        return self.clock.seconds[label] / self.samples


class Runner:
    def __init__(self, cell, world, seed: int, tmp: str, sync, log):
        self.cell, self.w, self.seed, self.tmp = cell, world, seed, tmp
        self.sync, self.log = sync, log
        self.done = []
        self.started = 0
        self.current = None         # the sample being mapped
        self.failed = 0
        self.realign_calls = []
        t = cell.traffic
        self.n_pairs = int(t["pairs"])
        self.mates = int(t.get("mates", 2))
        self.entry = specmod.load_entry(cell.config.get("entry",
                                                        "streaming"),
                                        cell.entry_file)
        p = world.params
        self.min_intron = min(p.min_intron_length, p.min_segment_intron)

    def draw(self, tag: int, k: int, n: int):
        """Sample k of stream `tag`."""
        return make_pairs(self.w.codes, self.w.layout.offsets, self.w.tx,
                          self.w.introns, self.cell.traffic,
                          sample_rng(self.seed, tag, k), n)

    def sample(self, tag: int, k: int, n: int, keep: bool, around=None):
        """Draw, write and map one sample; the timed seconds, or None if
        the program raised."""
        self.started += keep
        self.current = k
        s = self.draw(tag, k, n)
        d = os.path.join(self.tmp, f"s{tag}_{k}")
        os.makedirs(d)
        fq = [os.path.join(d, f"reads_{m + 1}.fq")
              for m in range(len(s.mates))]
        for f, m in zip(fq, s.mates):
            write_fastq(f, m)
        out = os.path.join(d, "out")
        ctx = around() if around else contextlib.nullcontext()
        self.sync()
        t0 = time.perf_counter()
        try:
            with ctx:
                self.entry.run(self.w, fq, out, _quiet)
                self.sync()
            dt = time.perf_counter() - t0
        except Exception:
            traceback.print_exc()
            self.failed += 1
            shutil.rmtree(d, ignore_errors=True)
            return None
        if keep:
            t = self.cell.traffic
            rng = sample_rng(self.seed, CHECK, k)
            pairs = checkmod.checked_pairs(rng, s.pairs,
                                           int(t["check_pairs"]))
            kept = os.path.join(self.tmp, f"kept_{k}")
            os.makedirs(kept)
            outs = []
            for f in ("accepted_hits.sam", "junctions.bed"):
                src = os.path.join(out, f)
                if os.path.exists(src):
                    shutil.move(src, os.path.join(kept, f))
                outs.append(os.path.join(kept, f))
            crossed = checkmod.expected_introns(s, int(t["anchor"]),
                                                self.min_intron)
            self.done.append(Done(k, s.mates, s.take(pairs), pairs, *outs,
                                  crossed))
        shutil.rmtree(d, ignore_errors=True)
        return dt

    def window(self, seconds: float, first: int = 0):
        """Samples first, first + 1, ... until `seconds` of timed seconds
        (or, for a program that returns at once, 2 x seconds + 30 of
        wall); (samples that ran, their timed seconds)."""
        k, timed, ran = first, 0.0, 0
        stop = time.perf_counter() + 2 * seconds + 30
        while timed < seconds and time.perf_counter() < stop:
            # the previous sample's garbage, collected with the clock
            # stopped: a CLI run maps one sample in a fresh process
            gc.collect()
            cpu = time.process_time()
            dt = self.sample(WINDOW, k, self.n_pairs, keep=True)
            k += 1
            if dt is None:
                break
            # wall, this process's CPU seconds (drawing and checking
            # included) and the host's load: more work, or a busier host
            self.log(f"sample {k - 1}: {dt:.3f} s, process CPU "
                     f"{time.process_time() - cpu:.3f} s, load "
                     f"{os.getloadavg()[0]:.2f}")
            timed += dt
            ran += 1
        return ran, timed

    def capture_realign(self, hooks):
        """Keep every call of the realignment entry: its inputs, its
        records (host arrays, or references to the port's tensors) and the
        sample it came from."""
        calls = self.realign_calls

        def make(fn):
            def call(genome, readsg, lengths, events, max_mm):
                out = fn(genome, readsg, lengths, events, max_mm)
                calls.append((readsg, lengths, events, max_mm, out,
                              self.current))
                return out
            return call
        return hooks.replace(REALIGN_ENTRY, make)

    def check(self, device) -> dict:
        """Each compared number, its limit and whether it holds."""
        lim = self.cell.limits["limits"]
        tally = checkmod.Tally()
        anchor = int(self.cell.traffic["anchor"])
        w = self.w
        for d in self.done:
            tally.add(checkmod.check_sample(
                w.codes, w.layout, d.truth, d.pairs, d.sam, d.bed, anchor,
                self.min_intron, w.given, w.true_introns))
        nums = tally.numbers()
        nums.update(self.check_realign(device))
        out = {}
        for name, value in nums.items():
            limit = lim[name]
            ok = value is not None and value <= limit
            out[name] = {"value": value, "limit": limit, "ok": ok}
        return out

    def pick_realign(self):
        """The realignment call that the check reads (drawn from the
        seed), the sample it came from, and the generator of its rows."""
        rng = sample_rng(self.seed, CHECK, 1 << 20)
        call = self.realign_calls[int(rng.integers(len(
            self.realign_calls)))]
        return call, next(d for d in self.done if d.index == call[5]), rng

    def where(self, left: int, right: int) -> str:
        """An intron as contig:left-right (contig-local), annotated or
        not."""
        lay = self.w.layout
        c = int(lay.contig_of(left))
        tag = "" if (left, right) in self.w.given else " (unannotated)"
        return (f"{lay.names[c]}:{left - lay.offsets[c]}-"
                f"{right - lay.offsets[c]}{tag}")

    def check_realign(self, device, left=None, right=None) -> dict:
        """On one realignment call: `realign_wrong`, its records that
        differ from the reference on `check_rows` of its rows plus those
        rows that are not a read of the call's sample (forward or reverse
        complement; rows of length 0 pad the call); `events_missed`, the
        true introns that its event table lacks: every intron of the
        annotation the program was given and every one that the sample's
        mates cross (reference.check.expected_introns). `left`/`right`
        put other event coordinates in the program's place (the
        control)."""
        if not self.realign_calls:
            return {"realign_wrong": None, "events_missed": None}
        (readsg, lengths, events, max_mm, out, _), done, rng = \
            self.pick_realign()
        readsg, lengths = host(readsg), host(lengths)
        R = len(readsg)
        n = min(R, int(self.cell.traffic["check_rows"]))
        rows = np.sort(rng.choice(R, n, replace=False))
        reads = {r.tobytes() for m in done.reads
                 for r in np.concatenate([m, revcomp(m)])}
        strangers = sum(readsg[i, :lengths[i]].tobytes() not in reads
                        for i in rows if lengths[i] > 0)
        table = dict(events)
        if left is not None:
            table.update(left=left, right=right)
            wrong = controlmod.realign_wrong(
                (readsg, lengths, events, max_mm), self.w.codes, rows,
                left, right, device=device)
        else:
            wrong = realignref.compare(
                (readsg, lengths, events, max_mm,
                 tuple(host(x) for x in out)), self.w.codes, rows,
                device=device)
        missed = checkmod.events_missed(table, self.w.given | done.crossed)
        if missed and left is None:
            self.log("true introns not in the realignment call's events: "
                     + ", ".join(self.where(lt, rt)
                                 for lt, rt in sorted(missed)[:20]))
        return {"realign_wrong": strangers + wrong,
                "events_missed": len(missed)}


def _quiet(*a, **k):
    pass


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", bench_path=None,
             data_dirs=(), cache=None, log=None) -> dict:
    """One run; returns the result's object (the last line's JSON)."""
    import torch

    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    cell = specmod.load_cell(root, name, bench_path, data_dirs)
    cuda = device.startswith("cuda")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cache = cache or os.path.join(specmod.HERE, ".cache")
    world = worldmod.make(cell.config, cache, device, log)
    tmp = tempfile.mkdtemp(prefix="bench_")
    hooks = clockmod.Hooks()
    try:
        runner = Runner(cell, world, seed, tmp, sync, log)
        warm = runner.sample(WARM, 0, int(cell.traffic["warm_pairs"]),
                             keep=False)
        if warm is None:
            raise RuntimeError("the warm sample failed (traceback above)")
        log(f"set-up: warm sample {warm:.3f} s (timed part); window "
            f"starts {time.perf_counter() - t_start:.3f} s after start")
        if cuda:
            sync()
            torch.cuda.reset_peak_memory_stats()
        runner.capture_realign(hooks)
        readers = {m: specmod.load_reader(m, f)
                   for m, f in cell.metric_files.items()} if trace else {}
        probe = Probe(hooks, clockmod.StageClock(hooks, sync=sync))
        installed = {}
        if trace:
            for m, r in readers.items():
                if r.PHASE == "window":
                    installed[m] = _install(r, probe)
        t_window = time.perf_counter()
        ran, timed = runner.window(seconds)
        probe.samples, probe.sample_seconds = ran, timed
        metrics, dev = {}, {}
        breakdown = None
        if trace:
            metrics, dev, breakdown = traced_sample(
                runner, readers, installed, probe, hooks, ran)
        hooks.restore()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        world.fm = world.trans = None          # the program's state
        if cuda:
            torch.cuda.empty_cache()
        if not trace:
            reads = runner.mates * runner.n_pairs * ran
            e2e = {"reads_per_s": reads / timed if ran else None,
                   "device_peak_gib": peak / 2 ** 30,
                   "setup_s": t_window - t_start}
            metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                       for m in cell.end_to_end
                       if e2e.get(m["name"]) is not None}
        checks = runner.check(device)
        bad = forbidden_modules()
        if bad:
            raise SystemExit("modules of JAX or the JAX package are loaded: "
                             + ", ".join(bad))
        correct = (ran > 0 and runner.failed == 0
                   and all(c["ok"] for c in checks.values()))
        result = {
            "correct": correct,
            "attempted": runner.started,
            "failed": runner.failed,
            "metrics": metrics,
            "device": dict(device_info(cuda, peak), **dev),
        }
        if breakdown:
            result["breakdown"] = breakdown
        result["first_build"] = world.first_build
        result["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                            for k, v in checks.items()}
        return result
    finally:
        hooks.restore()
        shutil.rmtree(tmp, ignore_errors=True)


def _install(reader, probe) -> bool:
    """A reader's hooks, if it has any; False when its targets are gone."""
    return reader.install(probe) if hasattr(reader, "install") else True


def traced_sample(runner, readers, installed, probe, hooks, ran):
    """One more sample under torch.profiler, with the stage ranges named
    for the idle gaps; (per-layer metrics, device, breakdown)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    window_clock = probe.clock
    hooks.restore()
    runner.capture_realign(hooks)
    probe.clock = clockmod.StageClock(hooks, label_ranges=True)
    for m, r in readers.items():
        if r.PHASE == "window":
            _install(r, probe)
        else:
            installed[m] = _install(r, probe)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        dt = runner.sample(
            WINDOW, ran, runner.n_pairs, keep=True,
            around=lambda: torch.profiler.record_function(
                profmod.SAMPLE_RANGE))
    probe.trace = profmod.from_profiler(prof) if dt is not None else None
    probe.clock = window_clock
    metrics = {}
    for m, r in readers.items():
        if not installed.get(m) or (probe.trace is None
                                    and r.PHASE == "profile"):
            continue
        v = r.read(probe)
        if v is not None:
            unit = next(x["unit"] for x in runner.cell.per_layer
                        if x["name"] == m)
            metrics[m] = {"value": v, "unit": unit}
    dev, breakdown = {}, None
    if probe.trace is not None:
        t = probe.trace
        dev = {"busy_s": t.busy_s(), "window_s": t.window_s}
        breakdown = {"device_ops": [[n[:120], s] for n, s in t.top_ops()],
                     "idle_gaps": [[n, s] for n, s in t.idle_gaps()]}
    return metrics, dev, breakdown


def device_info(cuda: bool, peak: int) -> dict:
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(peak)}
