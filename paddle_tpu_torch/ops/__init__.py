"""Tensor ops of the port: plain PyTorch functions, plus the wrappers of
the hand-written CUDA kernels (``flash_attention``)."""
