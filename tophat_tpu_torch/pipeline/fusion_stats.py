# Copy of tophat_tpu/pipeline/fusion_stats.py (host code), imports rewritten.
"""Full fusion statistics + fusions.out emission.

Re-implements the reference's FusionStat model (src/fusions.h:118) and its
exact output format (print_fusions, src/fusions.cpp:347-431):

  chr1-chr2  left  right  dir  count  pair_count  pair_count_fusion
  unsupport_count  left_ext  right_ext  symm  \t@\t diffs \t@\t
  chr1_seqL chr1_seqR \t@\t chr2_seqL chr2_seqR \t@\t left_bases(50)
  \t@\t right_bases(50) \t@\t ldist:rdist...

Stat semantics (fusions.cpp):
  count            — reads spanning the fusion with >= fusion_anchor_length
                     reference bases on both sides (:192-196)
  left/right_bases — per-offset coverage histograms next to the break
                     (:273-282, NUM_BASES=50)
  left/right_ext   — max anchor on each side (:271-272)
  chr1/2_seq       — 100 bp of reference around each breakpoint, reverse-
                     complemented for the R sides (:235-256)
  diffs            — similarity profile between the two flanks at 5 window
                     sizes (:258-265), used by tophat-fusion-post filters
  unsupport_count  — non-fused reads >= 40 bp straddling a breakpoint by
                     >= 20 bp on both sides (unsupport_fusions :288-343)
  pair_count / pair_count_fusion / unsupport_count_pair / vPairSupport —
                     mate-pair evidence (pair_support :497-980)
  symm             — sum of ((left_bases[i]-right_bases[i])/count)^2,
                     computed at print time (:375-381)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from tophat_tpu_torch.index.fasta import Genome, decode_seq
from tophat_tpu_torch.ops.splice import (KIND_DELETION, KIND_FUSION,
                                         KIND_INSERTION, KIND_JUNCTION)

NUM_BASES = 50          # fusions.h:130
FLANK_LEN = 100         # fusions.cpp:229 (len=100, half=50)
DIFF_INCREASE = 20      # fusions.cpp:232
UNSUPPORT_MARGIN = 20   # fusions.cpp:295-296
UNSUPPORT_MIN_LEN = 40  # fusions.cpp:290


@dataclasses.dataclass
class FusionStat:
    count: int = 0
    pair_count: int = 0
    pair_count_fusion: int = 0
    unsupport_count: int = 0
    unsupport_count_pair: int = 0
    left_ext: int = 0
    right_ext: int = 0
    left_bases: Optional[np.ndarray] = None
    right_bases: Optional[np.ndarray] = None
    chr1_seq: str = ""
    chr2_seq: str = ""
    diffs: Tuple[int, ...] = ()
    pair_support: Optional[List[Tuple[int, int]]] = None

    def __post_init__(self):
        if self.left_bases is None:
            self.left_bases = np.zeros(NUM_BASES, np.int64)
        if self.right_bases is None:
            self.right_bases = np.zeros(NUM_BASES, np.int64)
        if self.pair_support is None:
            self.pair_support = []


def _revcomp(s: str) -> str:
    return s.translate(str.maketrans("ACGTN", "TGCAN"))[::-1]


def fusion_break(events, c) -> Optional[Tuple[int, int, str, int, int]]:
    """Breakpoint of a fusion-crossing Candidate: (gpos1, gpos2, dir,
    left_len, right_len) in global 0-based coords, read order (left piece
    first). left_len/right_len are the reference bases consumed on each
    side of the break (fusions.cpp:154-196 left_pos/right_pos: M + N + D,
    not I). Returns None for non-fusion candidates."""
    if c.kind == KIND_FUSION:
        rl_like = None  # single-event: caller passes read length via c
        if c.ev >= 0:
            gpos1 = int(events["left"][c.ev])
            gpos2 = int(events["right"][c.ev])
            fdir = "ff"
        else:
            if c.fpos2 < 0:
                return None
            fdir = c.fdir
            gpos1 = c.pos + (c.t - 1 if fdir != "rf" else 0)
            gpos2 = c.fpos2
        return gpos1, gpos2, fdir, c.t, -1  # right_len filled by caller
    if c.kind == -2:
        ref1 = 0
        fdir = None
        gpos1 = gpos2 = -1
        # leading FUS (rf): piece 2 described by ops after it; breakpoint
        # on side 1 is the partner pos, side 2 starts at c.pos
        ops = list(c.chain_ops)
        if ops and ops[0][0] == "FUS":
            _, pb, fdir = ops[0]
            gpos1 = c.pos
            gpos2 = pb
            left_len = 0
            right_len = 0
            for op in ops[1:]:
                if op[0] == "M":
                    right_len += op[1]
                elif op[0] == "EV" and op[2] in (KIND_JUNCTION,
                                                 KIND_DELETION):
                    right_len += op[3]
            # side-1 length isn't recoverable from the clipped ops; the
            # caller supplies it from the read length
            return gpos1, gpos2, fdir, -1, right_len
        for op in ops:
            if op[0] == "M":
                ref1 += op[1]
            elif op[0] == "FUS":
                _, pb, fdir = op
                gpos1 = c.pos + ref1 - 1
                gpos2 = pb
                break
            elif op[0] == "EV":
                if op[2] == KIND_FUSION:
                    gpos1 = c.pos + ref1 - 1
                    gpos2 = int(events["right"][op[1]])
                    fdir = "ff"
                    break
                if op[2] in (KIND_JUNCTION, KIND_DELETION):
                    ref1 += op[3]
        if fdir is None:
            return None
        left_len = ref1
        right_len = 0
        seen = False
        for op in ops:
            if not seen:
                if op[0] in ("FUS",) or (op[0] == "EV"
                                         and op[2] == KIND_FUSION):
                    seen = True
                continue
            if op[0] == "M":
                right_len += op[1]
            elif op[0] == "EV" and op[2] in (KIND_JUNCTION, KIND_DELETION):
                right_len += op[3]
        return gpos1, gpos2, fdir, left_len, right_len
    return None


class FusionTable:
    """Accumulates fusion evidence across all selected alignments and
    writes the reference-format fusions.out."""

    def __init__(self, genome: Genome, events, params):
        self.genome = genome
        self.events = events
        self.params = params
        self.stats: Dict[Tuple[int, int, str], FusionStat] = {}
        self._codes = np.asarray(genome.codes)

    # -- canonical key ----------------------------------------------------
    def _canon(self, gpos1, gpos2, fdir, left_len, right_len):
        """Order the two breakpoints like fusions_from_spliced_hit
        (fusions.cpp:470-488): refid1 < refid2, same-contig by coord."""
        c1, _ = self.genome.global_to_contig(np.int64(gpos1))
        c2, _ = self.genome.global_to_contig(np.int64(gpos2))
        if (int(c1), gpos1) > (int(c2), gpos2):
            gpos1, gpos2 = gpos2, gpos1
            left_len, right_len = right_len, left_len
        return gpos1, gpos2, fdir, left_len, right_len

    def _seq(self, g0: int, g1: int) -> str:
        n = self._codes.shape[0]
        if g0 < 0 or g1 > n:
            return ""
        return decode_seq(self._codes[g0:g1])

    def _flanks(self, gpos1, gpos2, fdir):
        half = FLANK_LEN // 2
        if fdir in ("rf", "rr"):
            s1 = _revcomp(self._seq(gpos1 - half, gpos1 + half))
        else:
            s1 = self._seq(gpos1 - half + 1, gpos1 + half + 1)
        if fdir in ("fr", "rr"):
            s2 = _revcomp(self._seq(gpos2 - half + 1, gpos2 + half + 1))
        else:
            s2 = self._seq(gpos2 - half, gpos2 + half)
        return s1, s2

    @staticmethod
    def _diffs(s1: str, s2: str) -> Tuple[int, ...]:
        if len(s1) < FLANK_LEN or len(s2) < FLANK_LEN:
            return ()
        out = []
        for j in range(5):
            pos = (5 - j - 1) * DIFF_INCREASE // 2
            ln = (j + 1) * DIFF_INCREASE
            a, b = s1[pos:pos + ln], s2[pos:pos + ln]
            out.append(sum(1 for x, y in zip(a, b) if x != y))
        return tuple(out)

    # -- evidence ---------------------------------------------------------
    def add_alignment(self, c, rl: int):
        """One fusion-spanning read alignment (fusions_from_alignment)."""
        br = fusion_break(self.events, c)
        if br is None:
            return
        gpos1, gpos2, fdir, left_len, right_len = br
        if c.kind == KIND_FUSION:
            left_len, right_len = c.t, rl - c.t
        elif left_len < 0:
            left_len = rl - right_len
        fa = self.params.fusion_anchor_length
        if left_len < fa or right_len < fa:
            return
        gpos1, gpos2, fdir, left_len, right_len = self._canon(
            gpos1, gpos2, fdir, left_len, right_len)
        key = (gpos1, gpos2, fdir)
        st = self.stats.get(key)
        if st is None:
            st = self.stats[key] = FusionStat()
            st.chr1_seq, st.chr2_seq = self._flanks(gpos1, gpos2, fdir)
            st.diffs = self._diffs(st.chr1_seq, st.chr2_seq)
        st.count += 1
        st.left_ext = max(st.left_ext, left_len)
        st.right_ext = max(st.right_ext, right_len)
        st.left_bases[:min(left_len, NUM_BASES)] += 1
        st.right_bases[:min(right_len, NUM_BASES)] += 1

    def add_unsupport(self, c, rl: int):
        """A contiguous >=40bp read straddling a breakpoint with 20 bp
        margin contradicts the fusion (unsupport_fusions)."""
        if c.kind != -1 or rl < UNSUPPORT_MIN_LEN or not self.stats:
            return
        lo = c.pos + UNSUPPORT_MARGIN
        hi = c.pos + rl - UNSUPPORT_MARGIN
        for (g1, g2, _d), st in self.stats.items():
            if lo <= g1 <= hi or lo <= g2 <= hi:
                st.unsupport_count += 1

    def add_pair(self, c1, c2, rl1: int, rl2: int):
        """Mate-pair evidence (pair_support, fusions.cpp:497): a pair where
        one mate spans the fusion adds pair_count_fusion; a non-spanning
        pair whose mates bracket the two breakpoints within the distance
        window adds pair_count + an ldist:rdist sample."""
        br1 = fusion_break(self.events, c1)
        br2 = fusion_break(self.events, c2)
        if br1 is not None and br2 is not None:
            return  # both mates fused: ignored (fusions.cpp:508-510)
        rng = min(int(self.params.fusion_min_dist), 1 << 16)
        max_dist = rng * 2
        if br1 is not None or br2 is not None:
            br = br1 if br1 is not None else br2
            cf, rlf = (c1, rl1) if br1 is not None else (c2, rl2)
            co = c2 if br1 is not None else c1
            gpos1, gpos2, fdir, ll, rr = br
            if cf.kind == KIND_FUSION:
                ll, rr = cf.t, rlf - cf.t
            elif ll < 0:
                ll = rlf - rr
            fa = self.params.fusion_anchor_length
            if ll < fa or rr < fa:
                return
            gpos1, gpos2, fdir, ll, rr = self._canon(gpos1, gpos2, fdir,
                                                     ll, rr)
            st = self.stats.get((gpos1, gpos2, fdir))
            if st is None:
                return
            # the other mate must land near one of the breakpoints
            od = min(abs(co.pos - gpos1), abs(co.pos - gpos2))
            if od <= max_dist:
                st.pair_count_fusion += 1
            else:
                st.unsupport_count_pair += 1
            return
        # neither mate spans: bracket test around each known fusion
        for (g1, g2, _d), st in self.stats.items():
            lo1, hi1 = sorted((c1.pos, c2.pos))
            ldist = g1 - (lo1 + rl1)
            rdist = hi1 - g2
            if -rng <= ldist <= max_dist and -rng <= rdist <= max_dist \
                    and abs(ldist) + abs(rdist) < max_dist:
                st.pair_count += 1
                st.pair_support.append((int(ldist), int(rdist)))
                if len(st.pair_support) >= 300:  # fusions.cpp:942-946
                    st.pair_support.sort()
                    del st.pair_support[200:]

    # -- emission ---------------------------------------------------------
    def write(self, path: str):
        gnames = self.genome.names
        rows = sorted(self.stats.items())
        ignore = {c for c in getattr(self.params,
                                     "fusion_ignore_chromosomes",
                                     "").split(",") if c}
        with open(path, "w") as f:
            for (g1, g2, fdir), st in rows:
                if st.count <= 0:
                    continue
                c1, l1 = self.genome.global_to_contig(np.int64(g1))
                c2, l2 = self.genome.global_to_contig(np.int64(g2))
                if (gnames[int(c1)] in ignore
                        or gnames[int(c2)] in ignore):
                    # --fusion-ignore-chromosomes (reference usage
                    # tophat.py:124: e.g. chrM break points are noise)
                    continue
                symm = float(np.sum(((st.left_bases - st.right_bases)
                                     / float(st.count)) ** 2))
                f.write("%s-%s\t%d\t%d\t%s\t%d\t%d\t%d\t%d\t%d\t%d\t%.6f"
                        % (gnames[int(c1)], gnames[int(c2)], int(l1),
                           int(l2), fdir, st.count, st.pair_count,
                           st.pair_count_fusion, st.unsupport_count,
                           st.left_ext, st.right_ext, symm))
                f.write("\t@\t")
                f.write("".join("%d " % d for d in st.diffs))
                f.write("\t@\t")
                half = len(st.chr1_seq) // 2
                f.write("%s %s\t@\t" % (st.chr1_seq[:half],
                                        st.chr1_seq[half:]))
                f.write("%s %s\t@\t" % (st.chr2_seq[:half],
                                        st.chr2_seq[half:]))
                f.write("".join("%d " % v for v in st.left_bases))
                f.write("\t@\t")
                f.write("".join("%d " % v for v in st.right_bases))
                f.write("\t@\t")
                for ld, rd in sorted(st.pair_support)[:200]:
                    f.write("%d:%d " % (ld, rd))
                f.write("\n")


def build_fusion_table(genome, events, params, parts) -> FusionTable:
    """Accumulate all fusion stats from selected alignments.

    parts: [(batch, selected)] as in write_outputs_multi; selected maps
    read -> [Candidate]."""
    ft = FusionTable(genome, events, params)
    multireads = getattr(params, "fusion_multireads", 0)
    for batch, selected in parts:
        for r, clist in selected.items():
            if multireads and len(clist) > multireads:
                # --fusion-multireads (reference usage tophat.py:126):
                # reads mapping to more than this many places do not
                # count as fusion support
                continue
            for c in clist:
                ft.add_alignment(c, int(batch.lengths[r]))
    for batch, selected in parts:
        for r, clist in selected.items():
            for c in clist:
                ft.add_unsupport(c, int(batch.lengths[r]))
    return ft
