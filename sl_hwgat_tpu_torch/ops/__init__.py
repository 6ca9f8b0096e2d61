"""Attention ops of the port: the CUDA window-attention and banded-attention
kernels, their plain PyTorch versions, and the token-major window layout
maps."""
