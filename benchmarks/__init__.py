"""The benchmark of tophat_tpu_torch, the PyTorch and CUDA port.

Run one cell from the root of a checkout:
    python3 benchmarks/run.py --workload fly_annotated.pe100 --seed 1 \
        --seconds 40 --trace 0
"""
