"""tophat_tpu_torch — the PyTorch/CUDA port of tophat_tpu for one NVIDIA GPU.

The JAX package tophat_tpu is the reference: every ported function is held
against it (same inputs, equal integer outputs; identical output files).
This package imports torch and numpy only — never jax or tophat_tpu — and
carries its own copies of the host modules it needs.

Layer map:
  index/     genome packing + FM-index build (host numpy) -> torch tensors
  ops/       device compute: rank/backward search, aligners, splice scans,
             event realignment (hand-written CUDA kernel in csrc/)
  pipeline/  the TopHat stages over read batches (single-end slice)
  io/        host-side FASTQ/FASTA/SAM/BAM/BED
  cli/       tophat-compatible command line
"""

__version__ = "0.1.0"
