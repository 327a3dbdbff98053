"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch
version beside it. Sources live in ``paddle_tpu_torch/csrc``; ``_build``
compiles them with ``nvcc`` at first use and loads them with ctypes."""
