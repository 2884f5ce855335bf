"""Tensor ops of the port: masks, sampling, attention routing and the CUDA kernels."""
