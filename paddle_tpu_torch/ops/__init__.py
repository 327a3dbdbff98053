"""Ops of the port: attention, paged KV cache, sampling, and the CUDA
kernels under ``ops/kernels``."""
