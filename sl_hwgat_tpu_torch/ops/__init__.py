"""Attention ops of the port: the CUDA window-attention kernel, its plain
PyTorch version, and the token-major window layout maps."""
