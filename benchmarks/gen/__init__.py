"""Part of the port's benchmark (see benchmarks/run.py)."""
