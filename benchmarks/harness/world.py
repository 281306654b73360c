"""Set-up: the configuration's genome, annotation and the port's state.

The genome (its contigs, repeats and unannotated introns) and the
annotation are made from the configuration's seeds on every run. What
the port derives from them, as its CLI derives it
(tophat_tpu_torch/cli/main._run): the genome FM index (`--tt-index`:
loaded, or built at the CLI's design point and saved on a checkout's
first run), the known events, and with `-G` the transcriptome files and
index (`--transcriptome-index`: reused, or built and saved).
Those caches live under a fixed directory of the checkout, keyed by the
configuration's genome and annotation; a directory without its `done`
marker is from a run that did not finish and is rebuilt.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import time

import numpy as np

from benchmarks.gen import genome as gen_genome
from benchmarks.gen.pairs import TranscriptTable


def key(*parts) -> str:
    return hashlib.sha1(json.dumps(parts, sort_keys=True).encode()
                        ).hexdigest()[:12]


def cache_dir(base: str, name: str, build) -> str:
    """base/name, made by build(path) unless a finished one is there."""
    path = os.path.join(base, name)
    if not os.path.exists(os.path.join(path, "done")):
        shutil.rmtree(path, ignore_errors=True)
        os.makedirs(path)
        build(path)
        open(os.path.join(path, "done"), "w").close()
    return path


@dataclasses.dataclass
class World:
    codes: np.ndarray        # the genome, int8 codes, contigs concatenated
    layout: object           # gen.genome.Layout: contig names and spans
    introns: list            # unannotated (left, right), global
    tx: TranscriptTable      # transcripts the reads are drawn from
    genome: object           # the port's Genome
    params: object
    fm: object
    known: object
    gtf_accept: object
    trans: object
    device: object
    given: frozenset         # introns of the annotation the program gets
    true_introns: frozenset  # every intron of the genome: annotated and not
    first_build: dict        # seconds of what this run built, if anything


def make(config: dict, base: str, device, log=lambda m: None) -> World:
    from tophat_tpu_torch.cli import main as cli
    from tophat_tpu_torch.index.fasta import Genome
    from tophat_tpu_torch.index.fm import FMIndex, build_fm_index
    from tophat_tpu_torch.io import gtf as gtfio
    from tophat_tpu_torch.pipeline.juncs import merge_events
    from tophat_tpu_torch.pipeline.transcriptome import (
        build_transcriptome_index)
    from tophat_tpu_torch.utils.device import resolve_device

    times = {}
    clock = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        times[what] = now - clock[0]
        clock[0] = now

    g = config["genome"]
    codes, layout = gen_genome.make_genome(g["contigs"], int(g["seed"]))
    if g.get("repeats"):
        gen_genome.plant_repeats(codes, layout, g["repeats"])
    sites = gen_genome.splice_sites(codes)
    introns = gen_genome.pick_introns(codes, layout,
                                      int(g["introns"]["count"]),
                                      int(g["introns"]["seed"]), sites)
    a = config["annotation"]
    gtf_text, transcripts, tx_introns = gen_genome.make_annotation(
        codes, layout, introns, a, sites)
    del sites
    genome = Genome(codes=codes, offsets=layout.offsets,
                    names=list(layout.names))
    lap("genome and annotation made")
    dev = resolve_device(device)
    built = {}

    kk, sr = cli._index_design_point(genome.n > (1 << 28))

    def build_index(path):
        t0 = time.perf_counter()
        fm = build_fm_index(genome, kmer_k=kk, sa_rate=sr, device="cpu")
        tmp = os.path.join(path, "genome.tmp.npz")
        fm.save(tmp)
        os.replace(tmp, os.path.join(path, "genome.tt.npz"))
        built["genome index build + save s"] = time.perf_counter() - t0

    gdir = cache_dir(base, f"genome-{key(g, kk, sr)}", build_index)

    def write_gtf(path):
        with open(os.path.join(path, "genes.gtf"), "w") as f:
            f.write(gtf_text)

    adir = cache_dir(base, f"annotation-{key(g, a)}", write_gtf)
    paths = {"genome_index": os.path.join(gdir, "genome"),
             "gtf": os.path.join(adir, "genes.gtf"),
             "transcriptome_index": os.path.join(adir, "tx", "genes")}
    argv = [f.format(**paths) for f in config["tophat_flags"]]
    args = cli.build_parser().parse_args(
        argv + ["-o", "out", "genome", "reads_1.fq", "reads_2.fq"])
    params = cli.params_from_args(args)

    # cli/main._run's steps between read_fasta and the pipeline
    if not args.tt_index:
        raise ValueError("a configuration's flags give --tt-index "
                         "{genome_index}")
    lap("caches checked (first run: built)")
    fm = FMIndex.load(args.tt_index + ".tt.npz", device=dev)
    if fm.n != genome.n:
        raise RuntimeError("the cached index was built for another genome")
    lap("genome FMIndex.load")
    known = cli.load_known_events(genome, args.insertions, args.deletions,
                                  args.raw_juncs)
    gtf_accept = transcripts_p = trans = None
    gtf_path = args.gtf
    tprefix = args.transcriptome_index
    if tprefix:
        if gtfio.validate_transcriptome(tprefix):
            gtf_path = tprefix + ".gff"
        else:
            t0 = time.perf_counter()
            os.makedirs(os.path.dirname(tprefix), exist_ok=True)
            transcripts_p = gtfio.parse_gtf(gtf_path)
            gtfio.write_transcriptome_files(tprefix, genome, transcripts_p,
                                            gtf_path)
            built["transcriptome files s"] = time.perf_counter() - t0
    if gtf_path:
        if transcripts_p is None:
            transcripts_p = gtfio.parse_gtf(gtf_path)
        gtf_ev, gtf_accept = gtfio.gtf_junctions(genome, transcripts_p)
        if args.no_gtf_juncs:
            gtf_accept = None
        known = merge_events(known, gtf_ev) if known is not None else gtf_ev
        t0 = time.perf_counter()
        fresh = tprefix and not os.path.exists(tprefix + ".tt.npz")
        trans = build_transcriptome_index(genome, transcripts_p,
                                          prefix=tprefix, device=dev)
        if fresh:
            built["transcriptome index build s"] = time.perf_counter() - t0
        lap("GTF parse, junctions, transcriptome index")
    log("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in times.items()))
    return World(codes=codes, layout=layout, introns=introns,
                 tx=TranscriptTable.of(transcripts), genome=genome,
                 params=params, fm=fm, known=known, gtf_accept=gtf_accept,
                 trans=trans, device=dev,
                 given=frozenset(tx_introns if gtf_path else ()),
                 true_introns=frozenset(tx_introns) | frozenset(introns),
                 first_build=built)
