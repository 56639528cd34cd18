"""Ops of the PyTorch port: plain versions and hand-written CUDA kernels."""
