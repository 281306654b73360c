# Copy of tophat_tpu/io/sam.py (host code), imports rewritten; records are
# formatted by io/emit.py.
"""SAM header generation and field conventions (host side).

Field conventions copied from the reference's final rewrite
(src/tophat_reports.cpp:656-1050 rewrite_sam_record/print_sam_for_single):
  - MAPQ: 255 for unique placements, else int(-10*log10(1 - 1/NH))
    (matches the gold regression outputs: 255 / 3 / 1 / 0)
  - aux order: NM:i, [XS:A:strand for spliced], NH:i
  - paired records: RNEXT '=', PNEXT mate pos, TLEN 0
  - reverse-strand records store the reverse-complemented sequence and
    reversed qualities
The @SQ dictionary order follows the genome's contig order, mirroring
get_index_sam_header (src/tophat.py:1415).
"""

from __future__ import annotations

import math
from typing import List, Optional

from tophat_tpu_torch.index.fasta import Genome

FLAG_PAIRED = 0x1
FLAG_PROPER = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80
FLAG_SECONDARY = 0x100

_RC = bytes.maketrans(b"ACGTNacgtn", b"TGCANtgcan")


def revcomp_ascii(seq: bytes) -> bytes:
    return seq.translate(_RC)[::-1]


def mapq_for_nh(nh: int, v2: bool = False) -> int:
    """MAPQ from the number of placements. Default = the gold-era
    255-for-unique rule; v2 = the TopHat 2.1.2 rule (50/3/1/0,
    reference: tophat_reports.cpp:734)."""
    if v2:
        if nh <= 1:
            return 50
        if nh == 2:
            return 3
        if nh <= 4:
            return 1
        return 0
    if nh <= 1:
        return 255
    return int(-10.0 * math.log10(1.0 - 1.0 / nh))


def ref_span(ops) -> int:
    """Reference bases consumed by a CIGAR (M/D/N)."""
    return sum(n for op, n in ops if op in ("M", "D", "N"))


def rg_header_line(params) -> Optional[str]:
    """@RG line when --rg-id/--rg-sample are set (reference builds it the
    same way in get_index_sam_header, src/tophat.py:1476-1491: ID/SM
    required together, then LB/DS/PU/CN/PI/DT/PL in that order)."""
    rg_id = getattr(params, "rg_id", "") if params is not None else ""
    if not rg_id:
        return None
    s = f"@RG\tID:{rg_id}\tSM:{params.rg_sample}"
    if params.rg_library:
        s += f"\tLB:{params.rg_library}"
    if params.rg_description:
        s += f"\tDS:{params.rg_description}"
    if params.rg_platform_unit:
        s += f"\tPU:{params.rg_platform_unit}"
    if params.rg_center:
        s += f"\tCN:{params.rg_center}"
    if getattr(params, "inner_dist_mean", 0):
        s += f"\tPI:{params.inner_dist_mean}"
    if params.rg_date:
        s += f"\tDT:{params.rg_date}"
    if params.rg_platform:
        s += f"\tPL:{params.rg_platform}"
    return s


def header_lines(genome: Genome, sort_order: str = "coordinate",
                 program_version: str = "0.1.0",
                 params=None) -> List[str]:
    lines = [f"@HD\tVN:1.0\tSO:{sort_order}"]
    rg = rg_header_line(params)
    if rg is not None:
        lines.append(rg)
    lens = genome.contig_lengths()
    for name, ln in zip(genome.names, lens):
        lines.append(f"@SQ\tSN:{name}\tLN:{int(ln)}")
    lines.append(f"@PG\tID:TopHat\tVN:{program_version}\tCL:tophat_tpu")
    return lines
