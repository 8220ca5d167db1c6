"""Benchmark of the PyTorch/CUDA port on the H100 (see run.py)."""
