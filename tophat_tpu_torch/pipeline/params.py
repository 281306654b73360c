# Copy of tophat_tpu/pipeline/params.py (host code), imports rewritten.
"""Run parameters: the TopHatParams equivalent.

One flat dataclass replaces the reference's two-level flag system (nested
TopHatParams classes, src/tophat.py:309-560, plus the C++ getopt_long table
shared by every binary, src/common.cpp:347-420) — there are no child
processes to re-serialize flags for. Defaults mirror the reference usage text
(src/tophat.py:30-152).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Params:
    # read mapping
    read_mismatches: int = 2            # -N/--read-mismatches
    read_gap_length: int = 2            # --read-gap-length
    read_edit_dist: int = 2             # --read-edit-dist
    max_multihits: int = 20             # -g/--max-multihits
    # segments
    segment_length: int = 25            # --segment-length
    segment_mismatches: int = 2         # --segment-mismatches
    # splice model
    min_anchor_len: int = 8             # -a/--min-anchor (3..20)
    splice_mismatches: int = 0          # -m/--splice-mismatches (0..2)
    min_intron_length: int = 70         # -i/--min-intron-length
    max_intron_length: int = 500000     # -I/--max-intron-length
    min_segment_intron: int = 50        # --min-segment-intron
    max_segment_intron: int = 500000    # --max-segment-intron
    min_coverage_intron: int = 50       # --min-coverage-intron
    max_coverage_intron: int = 20000    # --max-coverage-intron
    # indels
    max_insertion_length: int = 3       # --max-insertion-length
    max_deletion_length: int = 3        # --max-deletion-length
    allow_indels: bool = True           # --no-novel-indels disables
    # pairing
    inner_dist_mean: int = 50           # -r/--mate-inner-dist
    inner_dist_std_dev: int = 20        # --mate-std-dev
    # aligner mode
    bowtie2: bool = False               # --b2/--bowtie2: direct gapped
    #                                     initial alignment with the
    #                                     driver's score floor
    #                                     (reference tophat.py:2253-2259);
    #                                     off = bowtie1 -v semantics (the
    #                                     regression gold's era)
    # bowtie2 tuning surface (--b2-*; reference src/tophat.py:2250-2337.
    # mp/rdg/rfg/score-min change scoring + admission; the seeding knobs
    # N/L/i/D/R and the presets are accepted for compatibility — this
    # aligner's seeding is exact, so they cannot reduce sensitivity)
    b2_mp: str = "6,2"                  # --b2-mp MX,MN
    b2_rdg: str = "5,3"                 # --b2-rdg open,extend (read gap)
    b2_rfg: str = "5,3"                 # --b2-rfg open,extend (ref gap)
    b2_score_min: str = ""              # --b2-score-min e.g. C,-14,0
    b2_preset: str = ""                 # --b2-{very-fast,...} (no-op)
    # reads
    quals_scale: str = "phred33"        # phred33|phred64|solexa
    library_type: str = "fr-unstranded"  # --library-type
    prefilter_multihits: bool = False   # -M/--prefilter-multihits
    # search toggles
    coverage_search: bool = True
    microexon_search: bool = False
    butterfly_search: bool = False
    fusion_search: bool = False
    # fusion params (reference: src/tophat.py:118-127)
    fusion_anchor_length: int = 20
    fusion_min_dist: int = 10000000
    fusion_read_mismatches: int = 2
    fusion_multireads: int = 2
    fusion_multipairs: int = 2
    # transcriptome / annotation modes
    transcriptome_only: bool = False    # -T/--transcriptome-only
    transcriptome_max_hits: int = 60    # -x/--transcriptome-max-hits
    no_gtf_juncs: bool = False          # --no-gtf-juncs
    integer_quals: bool = False         # --integer-quals
    fusion_ignore_chromosomes: str = ""  # --fusion-ignore-chromosomes CSV
    read_realign_edit_dist: int = -1    # --read-realign-edit-dist
    #                                     (-1 = read_edit_dist + 1: never)
    # read group (@RG header + RG:Z record tags; reference:
    # src/tophat.py:116-124 usage, :1476 rg_str, tophat_reports.cpp:744)
    rg_id: str = ""                     # --rg-id
    rg_sample: str = ""                 # --rg-sample (SM)
    rg_library: str = ""                # --rg-library (LB)
    rg_description: str = ""            # --rg-description (DS)
    rg_platform_unit: str = ""          # --rg-platform-unit (PU)
    rg_platform: str = ""               # --rg-platform (PL)
    rg_center: str = ""                 # --rg-center (CN)
    rg_date: str = ""                   # --rg-date (DT)
    # reporting
    report_secondary: bool = False      # --report-secondary-alignments
    no_discordant: bool = False         # --no-discordant: report only
    #                                     concordant pairs
    no_mixed: bool = False              # --no-mixed: drop half-mapped pairs
    v2_sam: bool = False                # --v2-sam: TopHat 2.1.2 SAM fields
    #                                     (proper-pair flag, TLEN, MAPQ
    #                                     50/3/1/0) instead of the gold
    #                                     v1.1.4 conventions
    no_sort_bam: bool = False           # --no-sort-bam: read-order output
    no_convert_bam: bool = False        # --no-convert-bam: SAM only
    # engine tuning (TPU-side; no reference analog)
    batch_size: int = 16384             # reads per device batch
    hits_per_seed: int = 32             # SA-interval truncation per seed
    max_alignments: int = 64            # per-read alignment slots
    max_juncs: int = 4096               # candidate junction slots

    def segment_count(self, read_len: int) -> int:
        """Number of segments a read of this length splits into — delegates
        to the single source of truth (pipeline.prep.segment_offsets)."""
        from tophat_tpu_torch.pipeline.prep import segment_offsets

        return len(segment_offsets(read_len, self.segment_length)) - 1
