"""transcriptome_map_s: the annotation layer's transcriptome map (align to the
transcripts, rebase to the genome), self seconds a sample.

Stage clock (a synchronize before and after each call) around
tophat_tpu_torch.pipeline.run:map_reads_transcriptome; stages clocked inside
it are not counted here.
"""

PHASE = "window"
TARGET = "tophat_tpu_torch.pipeline.run:map_reads_transcriptome"


def install(probe):
    return probe.clock.wrap(TARGET, "transcriptome_map_s")


def read(probe):
    return probe.per_sample("transcriptome_map_s")
