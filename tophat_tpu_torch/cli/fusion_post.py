# Copy of tophat_tpu/cli/fusion_post.py (host code), imports rewritten;
# the kmer map runs on a torch device with a seed budget that keeps every
# placement (_align_kmers), over the CLI's contig-group indexes on a
# genome past the int32 cap (build_kmer_map).
"""tophat-fusion-post equivalent: filter, annotate, score and report the
fusion candidates of one or more fusion-search runs.

Re-implements the reference post-processor (src/tophat-fusion-post, 2924
LoC). Same run layout: invoked in a directory containing
`tophat_<sample>/` output dirs (each with fusions.out / junctions.bed /
accepted_hits.sam|bam); writes `tophatfusion_out/` with

  sample_list.txt        sample scan journal (check_samples :249)
  fusion_seq.fa/.map     23-mers around breakpoints + their genomic
                         multi-placements (map_fusion_kmer :279) — mapped
                         with the in-process FM aligner instead of bowtie,
                         on --device (default cuda)
  potential_fusion.txt   filtered candidates, 6 lines each (filter_fusion
                         :345-1005)
  read_alignments/       per-fusion read-evidence panels (read_dist :1126)
  result.txt result.html final clustered, scored report (generate_html
                         :1498-2807)

Differences from the reference, by design:
  * kmer mapping uses the repo's FM index (no bowtie subprocess), with
    every placement kept at any genome size (_align_kmers); past
    MAX_GROUP_BASES (a human genome) over the run's contig-group indexes,
    where one index over the whole genome would overflow int32
    (build_kmer_map).
  * the blastn re-check stage (do_blast :1037) runs only when both
    `blastn` is on PATH and the reference's `blast/` database directory
    exists next to the run (same probe the stage implicitly requires);
    otherwise it is skipped with a log line, and equivalent repeat
    filtering comes from the kmer map's multi-placement check.
  * --num-fusion-both defaults to 0: the reference's usage text says 5
    (tophat-fusion-post:32) but its code default is 0 (:70); behavior
    parity follows the code.
  * reads panels are reconstructed from this pipeline's single-record
    fused alignments (XF:Z:<chr1>-<chr2> <p1> <p2> <dir> summary tags).

Usage:
  python -m tophat_tpu_torch.cli.fusion_post [--device cpu] [options] \
      <genome.fa>
"""

from __future__ import annotations

import argparse
import math
import os
import re
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tophat_tpu_torch.cli.main import group_indexes
from tophat_tpu_torch.index.fasta import encode_seq, read_fasta
from tophat_tpu_torch.index.fm import build_fm_index
from tophat_tpu_torch.index.grouped import MAX_GROUP_BASES
from tophat_tpu_torch.io.bam import read_bam
from tophat_tpu_torch.ops.align import align_reads, pad_reads, seed_widths
from tophat_tpu_torch.utils.device import resolve_device

KMER_LEN = 23            # tophat-fusion-post:293 (23-mer flank probes)
PANEL_WITHIN = 300       # read_dist :1219 `within`
COLOR_LEN = 300          # html scoring coverage window :1802
CLUSTER_DIST = 500_000   # cluster_fusion :2057


# ---------------------------------------------------------------------------
# params / CLI (reference :63-174)
# ---------------------------------------------------------------------------

def build_parser():
    p = argparse.ArgumentParser(
        prog="tophat_tpu_torch-fusion-post",
        description="filter/annotate/report fusions from fusion-search "
                    "runs (tophat-fusion-post equivalent)")
    p.add_argument("genome", help="genome FASTA (reference takes a bowtie "
                                  "index prefix)")
    p.add_argument("-o", "--output-dir", default="./tophatfusion_out")
    p.add_argument("--num-fusion-reads", type=int, default=3)
    p.add_argument("--num-fusion-pairs", type=int, default=2)
    p.add_argument("--num-fusion-both", type=int, default=0)
    p.add_argument("--max-num-fusions", type=int, default=500)
    p.add_argument("--fusion-read-mismatches", type=int, default=2)
    p.add_argument("--fusion-multireads", type=int, default=2)
    p.add_argument("--non-human", action="store_true")
    p.add_argument("-p", "--num-threads", type=int, default=1)
    p.add_argument("--no-filter-by-annotation", action="store_true")
    p.add_argument("--skip-fusion-kmer", action="store_true")
    p.add_argument("--skip-filter-fusion", action="store_true")
    p.add_argument("--skip-blast", action="store_true",
                   help="skip the blastn re-check stage (it also "
                        "auto-skips when blastn or the blast/ database "
                        "directory is absent; see module docstring)")
    p.add_argument("--skip-read-dist", action="store_true")
    p.add_argument("--skip-html", action="store_true")
    p.add_argument("--fusion-pair-dist", type=int, default=250)
    p.add_argument("--device", default="cuda",
                   help="torch device of the kmer map's FM index and "
                        "aligner (cuda by default; cpu on request)")
    return p


def find_samples(cwd=".") -> List[str]:
    """Sample names from tophat_<sample>/fusions.out dirs (:249)."""
    out = []
    for d in sorted(os.listdir(cwd)):
        if d.startswith("tophat_") and os.path.exists(
                os.path.join(cwd, d, "fusions.out")):
            out.append(d[len("tophat_"):])
    return out


def _read_fusions_out(path):
    """Yield parsed fusions.out entries: (info_fields, diffs, flank1,
    flank2, left_hist, right_hist, pairs_str)."""
    with open(path) as f:
        for line in f:
            if line.startswith("track"):
                continue
            sec = line.rstrip("\n").split("\t@\t")
            if len(sec) < 7:
                continue
            yield (sec[0].split("\t"), sec[1].strip(), sec[2], sec[3],
                   sec[4].strip(), sec[5].strip(), sec[6].strip())


# ---------------------------------------------------------------------------
# kmer map (map_fusion_kmer :279-343): 23-mers flanking each breakpoint,
# mapped genome-wide to detect repeat-mediated artifacts
# ---------------------------------------------------------------------------

KMER_LANES = 1 << 24      # seed lanes (kmers x strands x pieces x hits)
#                           per align_reads call of the kmer map


def _align_kmers(fm, genome, kmers):
    """(pos, valid) (len(kmers), 64) host tables of every placement of each
    23-mer with <= 2 mismatches (bowtie -v 2 in the reference). The seed
    budget of each align_reads call covers the widest SA interval of its
    kmers' pieces: the aligner's default of 32 drops placements once a
    piece occurs more often, past ~2^21 bases (the JAX package keeps 32,
    and so maps no kmer of a 2^27-base genome). Kmers run in slices of at
    most KMER_LANES seed lanes; where no piece is wider than 32 this is
    the JAX package's one call."""
    rf, rr, lens = pad_reads([encode_seq(s) for s in kmers])
    widths = torch.maximum(seed_widths(fm, rf, lens, 2),
                           seed_widths(fm, rr, lens, 2)).cpu().numpy()
    offsets = np.asarray(genome.offsets)
    pos, valid = [], []
    i = 0
    while i < len(kmers):
        j, hits = i + 1, max(32, int(widths[i]))
        while j < len(kmers) and (j + 1 - i) * 6 * max(
                hits, int(widths[j])) <= KMER_LANES:
            hits = max(hits, int(widths[j]))
            j += 1
        al = align_reads(fm, rf[i:j], rr[i:j], lens[i:j], offsets,
                         max_mismatches=2, max_alignments=64,
                         hits_per_seed=hits)
        pos.append(al.pos.cpu().numpy())
        valid.append(al.valid.cpu().numpy())
        i = j
    return np.concatenate(pos), np.concatenate(valid)


def _group_placements(gfm, kmers, device):
    """(pos, valid) of every placement of each 23-mer over contig-group
    indexes, one group's index on the device at a time: each group's
    columns in turn, in group order, its positions rebased by the group's
    base to int64 global coordinates."""
    device = torch.device(device)
    pos, valid = [], []
    for g in range(gfm.n_groups):
        fm = gfm.fms[g].to(device)
        p, v = _align_kmers(fm, gfm.sub_genomes[g], kmers)
        del fm      # the next group arrives only once this one is gone
        if device.type == "cuda":
            torch.cuda.empty_cache()
        pos.append(p.astype(np.int64) + int(gfm.bases[g]))
        valid.append(v)
    return np.concatenate(pos, axis=1), np.concatenate(valid, axis=1)


def build_kmer_map(genome, samples, out_dir, cwd=".", device="cuda",
                   genome_path=None, max_bases=MAX_GROUP_BASES,
                   log=None) -> Dict[str, list]:
    """fusion_seq.fa / fusion_seq.map: the 23-mers flanking each fusion of
    the samples and their placements with <= 2 mismatches, at most 100 a
    kmer (bowtie -v 2 -m 100 over the run's genome index, :279-343).

    A genome of at most `max_bases` is mapped with one FM index over the
    whole genome, a kmer's placements in align_reads' order (the JAX
    package's call). A longer one, which no int32 index can hold, is
    mapped over the contig-group indexes the CLI uses (cli.main's
    group_indexes with the genome argument `genome_path`: the caches a
    run left beside the FASTA are reused). A kmer's placements are then
    kept in group order, and within a group in that group's align_reads
    order, up to the 100-placement cap."""
    seqs = {}
    for s in samples:
        path = os.path.join(cwd, f"tophat_{s}", "fusions.out")
        for info, _d, f1, f2, _lh, _rh, _p in _read_fusions_out(path):
            left_seq = f1.split(" ")[0]
            right_seq = f2.split(" ")[1] if " " in f2 else ""
            if len(left_seq) >= KMER_LEN:
                seqs[left_seq[-KMER_LEN:]] = None
            if len(right_seq) >= KMER_LEN:
                seqs[right_seq[:KMER_LEN]] = None
    kmers = sorted(seqs)
    with open(os.path.join(out_dir, "fusion_seq.fa"), "w") as f:
        for s in kmers:
            f.write(f">{s}\n{s}\n")

    kmap: Dict[str, list] = {}
    if kmers:
        if genome.n > max_bases:
            gfm = group_indexes(genome, genome_path, max_bases, log=log)
            pos, valid = _group_placements(gfm, kmers, device)
        else:
            fm = build_fm_index(genome, device=device)
            pos, valid = _align_kmers(fm, genome, kmers)
        for i, s in enumerate(kmers):
            hits = []
            for c in np.nonzero(valid[i])[0]:
                cid, local = genome.global_to_contig(np.int64(pos[i, c]))
                hits.append((genome.names[int(cid)], int(local)))
                if len(hits) >= 100:  # bowtie -m 100 cap (:338)
                    break
            if hits:
                kmap[s] = hits
    with open(os.path.join(out_dir, "fusion_seq.map"), "w") as f:
        for s, hits in kmap.items():
            f.write("%s\t%s\n" % (s, ",".join("%s:%d" % h for h in hits)))
    return kmap


# ---------------------------------------------------------------------------
# gene models (read_genes :905-960, gene_exists :604-652)
# ---------------------------------------------------------------------------

_MIR = re.compile(r"^MIR")


def load_gene_list(path, chr_order, name2_idx=-4):
    """UCSC refGene/ensGene table -> sorted, overlap-pruned gene rows
    [name, chrom, txStart, txEnd, name2, exonStarts, exonEnds, strand]."""
    rows = []
    if not os.path.exists(path):
        return rows
    with open(path) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")[1:]
            if len(t) < 10:
                continue
            n_ex = int(t[7])
            if t[1] not in chr_order or _MIR.findall(t[name2_idx]):
                continue
            rows.append([t[0], t[1], int(t[3]), int(t[4]), t[name2_idx],
                         t[8].split(",")[:n_ex], t[9].split(",")[:n_ex],
                         t[2]])
    rows.sort(key=lambda g: (chr_order[g[1]], g[2], -g[3]))
    pruned = rows[:1]
    for g in rows[1:]:
        prev = pruned[-1]
        if prev[1] == g[1] and prev[3] >= g[3]:
            continue  # contained in a longer gene: keep the longest (:955)
        pruned.append(g)
    return pruned


def gene_at(gene_list, chr_order, chrom, coord, direction, is_left):
    """Binary-search the gene covering (chrom, coord); classify the
    position exon/intron and whether the breakpoint matches an exon
    boundary in the fusion direction (gene_exists :604)."""
    lo, hi = 0, len(gene_list) - 1
    while hi >= lo:
        mid = (lo + hi) // 2
        g = gene_list[mid]
        if chrom != g[1]:
            if chr_order[chrom] < chr_order[g[1]]:
                hi = mid - 1
            else:
                lo = mid + 1
            continue
        if g[2] <= coord <= g[3]:
            where, belong = "outside", False
            starts, ends = g[5], g[6]
            for i in range(len(starts)):
                relax = 3
                left = int(starts[i]) - 1
                right = int(ends[i]) - 1
                if coord <= right + relax:
                    if coord < left - relax:
                        where = "intron%d(%d-%d)" % (i, int(ends[i - 1]),
                                                     left - 1)
                    else:
                        if ((is_left and direction == "f")
                                or (not is_left and direction == "r")) \
                                and abs(coord - right) <= relax:
                            belong = True
                        if ((is_left and direction == "r")
                                or (not is_left and direction == "f")) \
                                and abs(coord - left) <= relax:
                            belong = True
                        where = "exon%d(%d-%d)" % (i + 1, left, right)
                    break
            return [g[0], g[4], where, belong, g[7]]
        if coord < g[2]:
            hi = mid - 1
        else:
            lo = mid + 1
    return ["N/A", "N/A", "N/A", False, "N/A"]


# ---------------------------------------------------------------------------
# transcript-coordinate pair distances (TransMaps :414-556)
# ---------------------------------------------------------------------------

def load_junction_index(gene_files, juncs_bed) -> Dict[str, list]:
    """Introns per chromosome as sorted (start, stop, strand) lists, from
    gene tables and/or a junctions.bed (load_junctions :489-521)."""
    idx: Dict[str, list] = defaultdict(list)
    for path in gene_files:
        if not path or not os.path.exists(path):
            continue
        with open(path) as f:
            for line in f:
                t = line.rstrip("\n").split("\t")[1:]
                if len(t) < 10:
                    continue
                n_ex = int(t[7])
                starts = [int(x) for x in t[8].split(",")[:n_ex]]
                ends = [int(x) for x in t[9].split(",")[:n_ex]]
                for s, e in zip(ends[:-1], starts[1:]):
                    idx[t[1]].append((s, e + 1, t[2]))
    if juncs_bed and os.path.exists(juncs_bed):
        with open(juncs_bed) as f:
            for line in f:
                if line.startswith("track"):
                    continue
                t = line.split("\t")
                if len(t) < 12:
                    continue
                a, b = t[10].split(",")[:2]
                idx[t[0]].append((int(t[1]) + int(a),
                                  int(t[2]) - int(b) + 2, t[5]))
    for ch in idx:
        idx[ch].sort()
    return idx


def _transcript_map(juncs, chrom, start, stop, strand, fusion_pos):
    """Distance-to-breakpoint along the *transcript*: junctions fully
    inside [start, stop] act as length-1 shortcuts (compute_transcript_map
    :439-487). Returns signed distances (negative upstream of the break).
    """
    w = stop - start + 1
    shortcuts = defaultdict(set)
    for (js, je, jst) in juncs.get(chrom, ()):
        if js >= start and je <= stop and jst == strand:
            shortcuts[je - start].add(js - start)
            shortcuts[js - start].add(je - start)
    fus = fusion_pos - start
    dist = [abs(i + start - fusion_pos) for i in range(w)]
    order = [fus]
    up = down = 1
    while len(order) < w:
        if fus - down >= 0:
            order.append(fus - down)
            down += 1
        if fus + up < w:
            order.append(fus + up)
            up += 1
    for i in order[1:]:
        inner = i + (1 if fus - i >= 0 else -1)
        if i in shortcuts:
            cands = [dist[inner]] + [dist[j] for j in shortcuts[i]
                                     if abs(j - fus) < abs(i - fus)]
            dist[i] = min(cands) + 1
        else:
            dist[i] = dist[inner] + 1
    for i in range(fus):
        dist[i] = -dist[i]
    return dist


class _TMap:
    def __init__(self, juncs, chrom, start, stop, strand, fusion_pos):
        self.start = start
        self.map = _transcript_map(juncs, chrom, start, stop, strand,
                                   fusion_pos)

    def at(self, pos):
        i = pos - self.start
        if i < 0:
            return self.map[0] - i
        if i >= len(self.map):
            return self.map[-1] + (i - len(self.map) + 1)
        return self.map[i]


def _sign(strand_char, is_right):
    if strand_char == "r":
        return 1 if is_right else -1
    return -1 if is_right else 1


def valid_pairs(info, pairs_str, juncs, max_pair_dist):
    """Re-measure spanning-pair inner distances in transcript coordinates
    and keep those within --fusion-pair-dist (get_valid_pairs :583-600)."""
    chrL, chrR = info[0].split("-")
    posL, posR = int(info[1]), int(info[2])
    strandL, strandR = info[3][0], info[3][1]
    pairs = []
    for p in pairs_str.split():
        a, b = p.split(":")
        pairs.append((int(a), int(b)))
    if not pairs:
        return []
    sL, sR = _sign(strandL, False), _sign(strandR, True)
    p1s = [p for p, _ in pairs]
    p2s = [q for _, q in pairs]
    lo_l, hi_l = sorted((posL - sL * max(0, max(p1s)),
                         posL - sL * min(0, min(p1s))))
    lo_r, hi_r = sorted((posR - sR * max(0, max(p2s)),
                         posR - sR * min(0, min(p2s))))
    maps = {}
    for key, (ch, lo, hi, fp) in {
            ("L", "-"): (chrL, lo_l, hi_l, posL),
            ("L", "+"): (chrL, lo_l, hi_l, posL),
            ("R", "-"): (chrR, lo_r, hi_r, posR),
            ("R", "+"): (chrR, lo_r, hi_r, posR)}.items():
        maps[key] = _TMap(juncs, ch, lo, hi, key[1], fp)
    out = []
    for (p1, p2) in pairs:
        a = sL * min(
            (maps[("L", st)].at(posL) - maps[("L", st)].at(posL - p1 * sL)
             for st in "-+"), key=abs)
        b = sR * min(
            (maps[("R", st)].at(posR) - maps[("R", st)].at(posR - p2 * sR)
             for st in "-+"), key=abs)
        if abs(a) + abs(b) <= max_pair_dist:
            out.append((a, b))
    return out


# ---------------------------------------------------------------------------
# breakpoint-flank divergence (how_diff :654-700): min-cost alignment of
# the two 20-mers, gap cost 2, mismatch 1, free end on either last row/col
# ---------------------------------------------------------------------------

def seq_divergence(a: str, b: str) -> int:
    n = len(a)
    if n == 0:
        return 0
    best = 10000
    prev = [0] * n
    cur = [0] * n
    for j in range(n):
        for i in range(n):
            m = 0 if a[i] == b[j] else 1
            v = 10000
            if i == 0:
                v = j * 2 + m
            elif j > 0:
                v = prev[i] + 2
            if j == 0:
                v = min(v, i * 2 + m)
            elif i > 0:
                v = min(v, cur[i - 1] + 2)
            if i > 0 and j > 0:
                v = min(v, prev[i - 1] + m)
            cur[i] = v
            if (i == n - 1 or j == n - 1) and v < best:
                best = v
        prev, cur = cur, prev
    return best


# ---------------------------------------------------------------------------
# the filter (filter_fusion :345-1005) -> potential_fusion.txt
# ---------------------------------------------------------------------------

def filter_fusions(genome, samples, params, kmap, out_dir, cwd="."):
    chr_order = {name: i for i, name in enumerate(genome.names)}
    ref_genes = load_gene_list(os.path.join(cwd, "refGene.txt"), chr_order)
    ens_genes = load_gene_list(os.path.join(cwd, "ensGene.txt"), chr_order)

    def find_gene(chrom, coord, one_dir, is_left):
        r1 = gene_at(ref_genes, chr_order, chrom, coord, one_dir, is_left)
        r2 = gene_at(ens_genes, chr_order, chrom, coord, one_dir, is_left)
        return (r2 + r2[:2]) if r1[0] == "N/A" else (r1 + r2[:2])

    results = []
    for sample in samples:
        sdir = os.path.join(cwd, f"tophat_{sample}")
        juncs = load_junction_index(
            [os.path.join(cwd, "refGene.txt"),
             os.path.join(cwd, "ensGene.txt")],
            os.path.join(sdir, "junctions.bed"))
        for entry in _read_fusions_out(os.path.join(sdir, "fusions.out")):
            info, diffs, f1, f2, lh, rh, pairs_str = entry
            if not diffs:
                continue
            diffs = diffs.split(" ")
            left_seq = f1.replace(" ", "")
            right_seq = f2.replace(" ", "")
            half = len(left_seq) // 2
            num_reads = int(info[4])
            tpairs = valid_pairs(info[:4], pairs_str, juncs,
                                 params.fusion_pair_dist)
            num_pairs = len(tpairs)
            num_pairs_fusion = int(info[6])
            both = num_reads + int(num_pairs + num_pairs_fusion * 0.5)
            num_contra = int(info[7])
            left_ext, right_ext = int(info[8]), int(info[9])
            sym = float(info[10])
            chr1, chr2 = info[0].split("-")[:2]
            coord1, coord2 = int(info[1]), int(info[2])
            fdir = info[3]

            # support thresholds (:745-756)
            if left_ext < 16 or right_ext < 16:
                continue
            if num_pairs > num_reads * 50:
                continue
            if num_reads < params.num_fusion_reads \
                    or num_pairs < params.num_fusion_pairs \
                    or both < params.num_fusion_both:
                continue
            # breakpoint flank similarity (:764-766)
            if int(diffs[0]) < 8:
                continue
            # read distribution symmetry (:768-770)
            if sym >= 22 + max(0, 6 - num_reads):
                continue
            # read-through transcription (:772-776)
            max_intron = 100_000
            if chr1 == chr2 and fdir == "ff" and 0 < coord2 - coord1 \
                    < max_intron:
                continue
            # kmer multi-placement repeat check (:778-808)
            lk = left_seq[half - KMER_LEN:half]
            rk = right_seq[half:half + KMER_LEN]
            if lk not in kmap or rk not in kmap:
                continue
            if chr1 == chr2:
                max_intron = min(max_intron,
                                 abs(coord1 - coord2) * 9 // 10)
            if any(ch == chr2 and abs(co - coord2) < max_intron
                   for ch, co in kmap[lk]):
                continue
            if any(ch == chr1 and abs(co - coord1) < max_intron
                   for ch, co in kmap[rk]):
                continue

            g1 = find_gene(chr1, coord1, fdir[0], True)
            g2 = find_gene(chr2, coord2, fdir[1], False)
            (gene1, gene1_name, gene1_where, _b1, gene1_sense,
             ens1, ens1_name) = g1
            (gene2, gene2_name, gene2_where, _b2, gene2_sense,
             ens2, ens2_name) = g2
            if params.filter_by_annotation:
                if gene1_name == gene2_name or ens1_name == ens2_name \
                        or ens1 == ens2:
                    continue
                if gene1 == "N/A" or gene2 == "N/A" or (
                        gene1.startswith("ENS")
                        and gene2.startswith("ENS")):
                    continue
            # 20-mer divergence across the break (:830-840)
            ld = seq_divergence(left_seq[half - 20:half],
                                right_seq[half - 20:half])
            if ld <= 8:
                continue
            rd = seq_divergence(left_seq[half:half + 20],
                                right_seq[half:half + 20])
            if rd <= 8 or ld + rd < 20:
                continue

            ldist = ["%d" % min(9, int(x)) for x in lh.split()]
            rdist = ["%d" % min(9, int(x)) for x in rh.split()]
            pairs_fmt = ["%d:%d" % p for p in tpairs]
            f1_out, f2_out = f1, f2

            # orient by gene strand (:848-874)
            if (fdir == "ff" and gene1_sense == "-" and gene2_sense == "-")\
                    or (fdir == "rr" and gene1_sense == "+"
                        and gene2_sense == "+") \
                    or (fdir == "fr" and gene1_sense == "-"
                        and gene2_sense == "+") \
                    or (fdir == "rf" and gene1_sense == "+"
                        and gene2_sense == "-"):
                fdir = {"ff": "rr", "rr": "ff"}.get(fdir, fdir)
                chr1, chr2 = chr2, chr1
                coord1, coord2 = coord2, coord1
                left_ext, right_ext = right_ext, left_ext
                f1_out, f2_out = (_revcomp_flank(f2), _revcomp_flank(f1))
                ldist, rdist = rdist, ldist
                gene1_name, gene2_name = gene2_name, gene1_name
                gene1_where, gene2_where = gene2_where, gene1_where
                pairs_fmt = [":".join(p.split(":")[::-1])
                             for p in pairs_fmt]

            head = "%s %s-%s %d %d %s %d %d %d %d %d %d" % (
                sample, chr1, chr2, coord1, coord2, fdir, num_reads,
                num_pairs, num_pairs_fusion, num_contra, left_ext,
                right_ext)
            results.append([head, f1_out, f2_out,
                            "%s %s" % ("".join(ldist[::-1]),
                                       "".join(rdist)),
                            "%s %s %s %s" % (gene1_name, gene1_where,
                                             gene2_name, gene2_where),
                            " ".join(pairs_fmt)])
    path = os.path.join(out_dir, "potential_fusion.txt")
    with open(path, "w") as f:
        for block in results:
            f.write("\n".join(block) + "\n")
    print(f"\t{len(results)} fusions are output in {path}",
          file=sys.stderr)
    return results


def _revcomp_flank(s: str) -> str:
    a, b = s.split(" ")
    rc = str.maketrans("ACGTacgt", "TGCAtgca")
    return (b.translate(rc)[::-1] + " " + a.translate(rc)[::-1])


# ---------------------------------------------------------------------------
# read-evidence panels (read_dist :1126-1496): for each potential fusion,
# the supporting and nearby reads rendered around the breakpoint
# ---------------------------------------------------------------------------

def _iter_sam(sdir):
    sam = os.path.join(sdir, "accepted_hits.sam")
    if os.path.exists(sam):
        with open(sam) as f:
            for line in f:
                if not line.startswith("@"):
                    yield line.rstrip("\n").split("\t")
        return
    bam = os.path.join(sdir, "accepted_hits.bam")
    if os.path.exists(bam):
        _text, names, _lens, records = read_bam(bam)
        for r in records:
            ref = names[r.ref_id] if r.ref_id >= 0 else "*"
            cig = "".join(f"{ln}{op}" for op, ln in r.cigar) or "*"
            fields = [r.name, str(r.flag), ref, str(r.pos + 1),
                      str(r.mapq), cig, "*", "0", "0",
                      r.seq.decode(), r.qual.decode()]
            for tag, ty, val in r.tags:
                fields.append(f"{tag}:{ty}:{val}")
            yield fields


_CIG_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def read_dist(samples, potential, params, out_dir, cwd="."):
    adir = os.path.join(out_dir, "read_alignments")
    os.makedirs(adir, exist_ok=True)
    # group wanted fusions per sample
    wanted = defaultdict(list)
    for block in potential:
        t = block[0].split(" ")
        wanted[t[0]].append((t[1], int(t[2]), int(t[3]), t[4]))

    panels = {}
    for sample in samples:
        if sample not in wanted:
            continue
        fusions = wanted[sample]
        rows = {k: [] for k in fusions}
        for t in _iter_sam(os.path.join(cwd, f"tophat_{sample}")):
            flag = int(t[1])
            if flag & 0x4:
                continue
            chrom, pos0 = t[2], int(t[3]) - 1
            cigar = _CIG_RE.findall(t[5])
            ref_len = sum(int(n) for n, op in cigar if op in "MDN=X")
            nm = nh = 0
            xf = None
            for fld in t[11:]:
                if fld.startswith("NM:i:"):
                    nm = int(fld[5:])
                elif fld.startswith("NH:i:"):
                    nh = int(fld[5:])
                elif fld.startswith("XF:Z:"):
                    xf = fld[5:].split(" ")
            if nh > params.fusion_multireads \
                    or nm > params.fusion_read_mismatches:
                continue
            for key in fusions:
                chrpair, p1, p2, fdir = key
                c1, c2 = chrpair.split("-")
                if xf is not None and len(xf) >= 4:
                    xc = xf[0].split("-")
                    if (xc[0] == c1 and xc[1] == c2
                            and int(xf[1]) - 1 == p1
                            and int(xf[2]) - 1 == p2 and xf[3] == fdir):
                        rows[key].append((True, t[0], chrom, pos0,
                                          pos0 + ref_len, t[5], t[9]))
                    continue
                near1 = chrom == c1 and (abs(pos0 - p1) <= PANEL_WITHIN
                                         or abs(pos0 + ref_len - p1)
                                         <= PANEL_WITHIN)
                near2 = chrom == c2 and (abs(pos0 - p2) <= PANEL_WITHIN
                                         or abs(pos0 + ref_len - p2)
                                         <= PANEL_WITHIN)
                if near1 or near2:
                    rows[key].append((False, t[0], chrom, pos0,
                                      pos0 + ref_len, t[5], t[9]))
        for key, reads in rows.items():
            chrpair, p1, p2, fdir = key
            c1, c2 = chrpair.split("-")
            fname = os.path.join(
                adir, "%s_%s_%d_%d_%s" % (sample, chrpair, p1, p2, fdir))
            with open(fname, "w") as f:
                for fused, rid, chrom, s, e, cig, seq in sorted(
                        reads, key=lambda r: (not r[0], r[3])):
                    prefix = "%s %s %d %d %s" % (
                        c1 if fused else chrom,
                        c2 if fused else chrom, s, e,
                        cig + ("F" if fused else ""))
                    f.write("%s%s %s\n" % (prefix,
                                           " " * max(1, 60 - len(prefix)),
                                           seq))
            panels[(sample,) + key] = reads
    return panels


# ---------------------------------------------------------------------------
# scoring + clustering + report (generate_html :1498-2807)
# ---------------------------------------------------------------------------

def _coverage_arrays(reads, p1, p2, fdir):
    """lcolor/rcolor: per-base read coverage moving away from each
    breakpoint (:1801-1832)."""
    lcolor = np.zeros(COLOR_LEN, np.int64)
    rcolor = np.zeros(COLOR_LEN, np.int64)

    def color(arr, a, b):
        a, b = max(0, a), min(COLOR_LEN, b)
        if b > a:
            arr[a:b] += 1

    for fused, _rid, chrom, s, e, cig, seq in reads:
        if fused:
            # matched prefix covers the left side; the clip covers the
            # partner side
            m = sum(int(n) for n, op in _CIG_RE.findall(cig)
                    if op in "M=X")
            sl = sum(int(n) for n, op in _CIG_RE.findall(cig) if op == "S")
            color(lcolor, 0, m)
            color(rcolor, 0, sl)
        else:
            d1, d2 = abs(s - p1), abs(e - p1)
            if min(d1, d2) < COLOR_LEN:
                color(lcolor, min(d1, d2), max(d1, d2))
            else:
                d1, d2 = abs(s - p2), abs(e - p2)
                if min(d1, d2) < COLOR_LEN:
                    color(rcolor, min(d1, d2), max(d1, d2))
    return lcolor, rcolor


def _coverage_stats(lcolor, rcolor):
    """(count, avg, gap) per side (:1866-1899)."""
    def one(arr):
        count, total = 1, 0
        gap, passed = 0, False
        for v in arr:
            if v > 0:
                count += 1
                total += int(v)
                if gap > 0:
                    passed = True
            elif not passed:
                gap += 1
        if not passed:
            gap = 0
        return count, total // count, gap
    lc, lavg, lgap = one(lcolor)
    rc, ravg, rgap = one(rcolor)
    return lc, lavg, lgap, rc, ravg, rgap


def _derivation(color, length, avg):
    der = 0.0
    for i in range(min(length, len(color))):
        diff = 1.0 - float(color[i]) / float(max(1, avg))
        der += diff * diff
    return math.sqrt(der / max(1, length))


_EXON_RE = re.compile(r"exon\d+\((\d+)-(\d+)\)")


def score_fusions(potential, panels, params):
    """Score every potential fusion from its read-coverage distribution
    (:1862-2030); returns the surviving fusion dicts."""
    out = []
    for block in potential:
        t = block[0].split(" ")
        sample, chrpair = t[0], t[1]
        p1, p2, fdir = int(t[2]), int(t[3]), t[4]
        stats = [int(x) for x in t[5:]]
        chr1, chr2 = chrpair.split("-")
        gene_fields = block[4].split()
        reads = panels.get((sample, chrpair, p1, p2, fdir), [])
        lcolor, rcolor = _coverage_arrays(reads, p1, p2, fdir)
        lcount, lavg, lgap, rcount, ravg, rgap = _coverage_stats(
            lcolor, rcolor)

        # exon-bounded expectations (:1903-1925)
        lcount_min, rcount_min, diff_max = 150, 150, 120

        def exon_len(loc, coord, d, is_left):
            m = _EXON_RE.search(loc)
            if not m:
                return 1_000_000
            a, b = int(m.group(1)), int(m.group(2))
            if (is_left and d == "f") or (not is_left and d == "r"):
                return coord - a + 1
            return b - coord + 1

        le = exon_len(gene_fields[1], p1, fdir[0], True)
        re_ = exon_len(gene_fields[3], p2, fdir[1], False)
        lcount_min = min(lcount_min, le - 20)
        rcount_min = min(rcount_min, re_ - 20)
        diff_max = min(diff_max, abs(lcount_min - rcount_min) + 20)
        if le < 1000 and re_ < 1000:
            diff_max = max(diff_max, abs(le - re_) + 20)
        drop = False
        if lcount <= lcount_min or rcount <= rcount_min \
                or lgap / lcount > 0.1 or rgap / rcount > 0.1:
            if abs(min(lcount, le) - min(rcount, re_)) > diff_max \
                    or lcount < 60 or rcount < 60:
                drop = True
        if drop and reads:
            continue

        lder = _derivation(lcolor, lcount_min, lavg)
        rder = _derivation(rcolor, rcount_min, ravg)
        pair_coords = block[5].split() if block[5].strip() else []
        num_read, pair, pair_fusion = stats[0], stats[1], stats[2]
        anti = stats[3] + 0.5
        dist = 1_000_000
        if pair_coords:
            pair = 0
            for pc in pair_coords:
                a, b = pc.split(":")
                d = abs(int(a)) + abs(int(b))
                dist = min(dist, d)
                if d < 2000:
                    pair += 1
        rate = (num_read / anti) if pair == 0 else (pair / anti)
        max_avg = 300
        score = (lcount + rcount + min(max_avg, lavg) + min(max_avg, ravg)
                 - abs(lcount - rcount) - min(max_avg, abs(lavg - ravg))
                 - (lgap + rgap) - (lder + rder) * max_avg
                 - min(dist, 1000) + rate)
        out.append(dict(sample_name=sample, chr=chrpair, chr1=chr1,
                        chr2=chr2, left_coord=p1, right_coord=p2,
                        dir=fdir, stats=stats, score=score,
                        gene1=gene_fields[0], gene2=gene_fields[2],
                        left_seq=block[1].split(" ")[0],
                        right_seq=block[2].split(" ")[1]
                        if " " in block[2] else "",
                        depth=block[3], pair_coords=pair_coords,
                        n_panel_reads=len(reads)))
    return out


def cluster_fusions(fusion_list, max_num):
    """Union-find clustering of breakpoint neighborhoods (:2053-2194)."""
    n = len(fusion_list)
    parent = list(range(n))
    box = [dict(idx=[i], chr=f["chr"], dir=f["dir"],
                l1=f["left_coord"], l2=f["left_coord"],
                r1=f["right_coord"], r2=f["right_coord"])
           for i, f in enumerate(fusion_list)]

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in range(n - 1):
        pi = find(i)
        for j in range(i + 1, n):
            pj = find(j)
            if pi == pj:
                continue
            a, b = box[pi], box[pj]
            if a["chr"] != b["chr"] or a["dir"] != b["dir"]:
                continue
            if max(abs(a["l1"] - b["l1"]), abs(a["l2"] - b["l2"]),
                   abs(a["l1"] - b["l2"]), abs(a["l2"] - b["l1"])) \
                    > CLUSTER_DIST:
                continue
            if max(abs(a["r1"] - b["r1"]), abs(a["r2"] - b["r2"]),
                   abs(a["r1"] - b["r2"]), abs(a["r2"] - b["r1"])) \
                    > CLUSTER_DIST:
                continue
            a["l1"], a["l2"] = min(a["l1"], b["l1"]), max(a["l2"], b["l2"])
            a["r1"], a["r2"] = min(a["r1"], b["r1"]), max(a["r2"], b["r2"])
            a["idx"].extend(b["idx"])
            parent[pj] = pi
    clusters = [box[i] for i in range(n) if find(i) == i]

    def known_genes(c):
        best = 0
        for i in c["idx"]:
            f = fusion_list[i]
            best = max(best, (f["gene1"] != "N/A") + (f["gene2"] != "N/A"))
        return best

    def best_score(c):
        return max(fusion_list[i]["score"] for i in c["idx"])

    clusters.sort(key=lambda c: (-known_genes(c), -best_score(c)))
    for c in clusters:
        c["idx"].sort(key=lambda i: -fusion_list[i]["score"])
    return clusters[:max_num]


def write_report(fusion_list, clusters, out_dir, blast_ran=True):
    """result.txt (tab table) + result.html (:2195-2360). When the blastn
    re-check stage did not run (no blastn on PATH / no blast/ databases),
    the skip is asserted loudly as a leading comment in result.txt — not
    only in a log line — so downstream consumers see that fusions were NOT
    repeat-filtered by blast."""
    txt_path = os.path.join(out_dir, "result.txt")
    html_path = os.path.join(out_dir, "result.html")
    with open(txt_path, "w") as txt, open(html_path, "w") as html:
        if not blast_ran:
            txt.write("# WARNING: blastn re-check stage SKIPPED; "
                      "candidates were not blast-filtered against "
                      "genomic/nt repeats\n")
        html.write("<HTML>\n<HEAD>\n<TITLE>result</TITLE>\n"
                   "<style type=\"text/css\">\nH1 { margin: 0 0 0 0; }\n"
                   "</style>\n</HEAD>\n<BODY>\n")
        html.write("<H1><BR>Candidate fusion list</H1>\n")
        html.write("Fusion candidates grouped by genomic location.<BR>\n")
        for ci, c in enumerate(clusters):
            html.write("<P><P><P><BR>\n%d. %s %s\n"
                       % (ci + 1, c["chr"], c["dir"]))
            html.write("<TABLE CELLPADDING=3 BORDER=\"1\">\n")
            for i in sorted(c["idx"],
                            key=lambda i: fusion_list[i]["left_coord"]):
                f = fusion_list[i]
                st = f["stats"]
                txt.write("%s\t%s\t%s\t%d\t%s\t%s\t%d\t%d\t%d\t%d\t%.2f\n"
                          % (f["sample_name"], f["gene1"], f["chr1"],
                             f["left_coord"], f["gene2"], f["chr2"],
                             f["right_coord"], st[0], st[1], st[2],
                             f["score"]))
                html.write("<TR><TD ALIGN=\"LEFT\">%s</TD>"
                           "<TD ALIGN=\"LEFT\">%s</TD>"
                           "<TD ALIGN=\"LEFT\">%s</TD>"
                           "<TD ALIGN=\"RIGHT\">%d</TD>"
                           "<TD ALIGN=\"LEFT\">%s</TD>"
                           "<TD ALIGN=\"LEFT\">%s</TD>"
                           "<TD ALIGN=\"RIGHT\">%d</TD>"
                           "<TD ALIGN=\"RIGHT\">%d</TD>"
                           "<TD ALIGN=\"RIGHT\">%d</TD>"
                           "<TD ALIGN=\"RIGHT\">%d</TD></TR>\n"
                           % (f["sample_name"], f["gene1"], f["chr1"],
                              f["left_coord"], f["gene2"], f["chr2"],
                              f["right_coord"], st[0], st[1], st[2]))
            html.write("</TABLE>\n")
        html.write("</BODY>\n</HTML>\n")
    n = sum(len(c["idx"]) for c in clusters)
    print(f"\tnum of fusions: {n}", file=sys.stderr)


# ---------------------------------------------------------------------------

def do_blast(potential, params, out_dir, cwd="."):
    """Blast 50-mers around fusion breakpoints against the genomic and nt
    databases (reference: do_blast, tophat-fusion-post:1037). Runs only
    when `blastn` is on PATH and the reference's `blast/` database layout
    (blast/human_genomic or blast/other_genomic, blast/nt) exists under
    the working directory — the same implicit requirements the reference
    stage has; otherwise logs and returns. Artifacts land in
    blast_genomic/ and blast_nt/, one file per query sequence, the layout
    the reference's report stage consumes."""
    import shutil
    import subprocess

    blast_dir = os.path.join(cwd, "blast")
    genomic_db = os.path.join(
        blast_dir, "human_genomic" if not params.non_human
        else "other_genomic")
    nt_db = os.path.join(blast_dir, "nt")
    if shutil.which("blastn") is None or not os.path.isdir(blast_dir):
        print("[fusion-post] blastn or blast/ databases unavailable — "
              "skipping the blast re-check stage", file=sys.stderr)
        return False
    print("[fusion-post] blasting 50-mers around fusions", file=sys.stderr)
    g_out = os.path.join(out_dir, "blast_genomic")
    nt_out = os.path.join(out_dir, "blast_nt")
    os.makedirs(g_out, exist_ok=True)
    os.makedirs(nt_out, exist_ok=True)

    def blast(database, seq, outdir):
        path = os.path.join(outdir, seq)
        if os.path.exists(path):
            return
        def run(extra):
            r = subprocess.run(
                ["blastn", "-db", database] + extra,
                input=seq.encode(), capture_output=True)
            return r.stdout.decode(errors="replace")
        out = run(["-evalue", "1e-10", "-word_size", "28"])
        if "No hits found" in out:
            out = run(["-evalue", "1e-5"])
        p1 = out.find(">ref|")
        p2 = out.find("Database: ", max(p1, 0))
        out = out[p1:p2].rstrip() if (p1 != -1 and p1 < p2) else ""
        with open(path, "w") as f:
            f.write(out)

    for block in potential:
        if len(block) < 5:
            continue
        left_seq = block[1].split(" ")[0]
        right_seq = block[2].split(" ")[1]
        both = left_seq + right_seq
        for s in (left_seq, right_seq, both):
            blast(genomic_db, s, g_out)
            blast(nt_db, s, nt_out)
    return True


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.filter_by_annotation = not args.no_filter_by_annotation
    device = resolve_device(args.device)
    out_dir = args.output_dir.rstrip("/") + "/"
    os.makedirs(out_dir, exist_ok=True)
    os.makedirs(os.path.join(out_dir, "logs"), exist_ok=True)

    genome = read_fasta(args.genome)

    samples = find_samples()
    with open(os.path.join(out_dir, "sample_list.txt"), "w") as f:
        for s in samples:
            f.write(s + "\n")
    if not samples:
        print("Error: no tophat_<sample>/fusions.out found in the current "
              "directory", file=sys.stderr)
        return 1
    print(f"[fusion-post] samples: {', '.join(samples)}", file=sys.stderr)

    if not args.skip_fusion_kmer:
        print("[fusion-post] mapping 23-mers around fusion breakpoints",
              file=sys.stderr)
        kmap = build_kmer_map(
            genome, samples, out_dir, device=device, genome_path=args.genome,
            log=lambda m: print(f"[fusion-post] {m}", file=sys.stderr))
    else:
        kmap = {}
        mpath = os.path.join(out_dir, "fusion_seq.map")
        if os.path.exists(mpath):
            for line in open(mpath):
                s, hits = line.rstrip("\n").split("\t")
                kmap[s] = [(h.rsplit(":", 1)[0], int(h.rsplit(":", 1)[1]))
                           for h in hits.split(",")]

    if not args.skip_filter_fusion:
        print("[fusion-post] filtering fusions", file=sys.stderr)
        potential = filter_fusions(genome, samples, args, kmap, out_dir)
    else:
        potential = []
        path = os.path.join(out_dir, "potential_fusion.txt")
        if os.path.exists(path):
            lines = open(path).read().splitlines()
            potential = [lines[i:i + 6] for i in range(0, len(lines), 6)]

    blast_ran = False
    if not args.skip_blast:
        blast_ran = bool(do_blast(potential, args, out_dir))

    panels = {}
    if not args.skip_read_dist:
        print("[fusion-post] generating read distributions",
              file=sys.stderr)
        panels = read_dist(samples, potential, args, out_dir)

    if not args.skip_html:
        print("[fusion-post] reporting", file=sys.stderr)
        fusion_list = score_fusions(potential, panels, args)
        clusters = cluster_fusions(fusion_list, args.max_num_fusions)
        write_report(fusion_list, clusters, out_dir, blast_ran=blast_ran)
    return 0


if __name__ == "__main__":
    sys.exit(main())
