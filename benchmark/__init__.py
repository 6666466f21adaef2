"""The benchmark of stylex_tpu_torch: ``python3 benchmark/run.py``."""
