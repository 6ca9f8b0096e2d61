"""Building blocks of the attention models, in PyTorch.

Numerics follow ``sl_hwgat_tpu/models/common.py`` (and through it the
reference's torch defaults):

- LayerNorm epsilon 1e-5; statistics are always float32;
- GELU is the exact erf form;
- Linear weights init trunc-normal(std 0.02), biases zero;
- the Fourier matrix ``B`` and the sinusoid table are fixed buffers.

Mixed precision is written out, with no autocast: ``Dense`` with a
``compute_dtype`` casts its input, weight and bias to it (flax
``nn.Dense(dtype=...)``), while parameters stay float32.

Train-time randomness (dropout here, attention pruning in the models) draws
from a ``torch.Generator`` that the caller passes down, so a train step is
reproducible from its seed. ``remat`` recomputes a block in the backward
pass on a replay of that generator, so the recomputed masks are the
forward's.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

LN_EPS = 1e-5
INIT_STD = 0.02
# the models' ``compute_dtype`` names
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def trunc_normal_(w: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """The JAX package's ``DENSE_INIT``: a normal cut at ±2σ, with σ chosen so
    the cut draw has std 0.02 (0.8796 is the std of a unit normal cut at ±2)."""
    sigma = INIT_STD / 0.87962566103423978
    return nn.init.trunc_normal_(w, std=sigma, a=-2 * sigma, b=2 * sigma, generator=generator)


def variance_scaling_(w: torch.Tensor, scale: float, mode: str, distribution: str,
                      generator: torch.Generator | None = None) -> torch.Tensor:
    """flax's ``variance_scaling`` initialiser on a torch weight (out, in,
    *kernel): the fans count the kernel's taps, as flax's (*kernel, in, out)
    does. ``distribution``: "normal", "truncated_normal" (cut at ±2σ, σ
    corrected as flax does) or "uniform"."""
    receptive = math.prod(w.shape[2:])
    fan_in, fan_out = w.shape[1] * receptive, w.shape[0] * receptive
    fan = {"fan_in": fan_in, "fan_out": fan_out, "fan_avg": (fan_in + fan_out) / 2}[mode]
    var = scale / fan
    with torch.no_grad():
        if distribution == "uniform":
            lim = math.sqrt(3 * var)
            return w.uniform_(-lim, lim, generator=generator)
        if distribution == "normal":
            return w.normal_(0.0, math.sqrt(var), generator=generator)
        sigma = math.sqrt(var) / 0.87962566103423978
        return nn.init.trunc_normal_(w, std=sigma, a=-2 * sigma, b=2 * sigma,
                                     generator=generator)


def lecun_normal_(w: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """flax's default kernel initialiser (``nn.Conv``, ``nn.Dense``)."""
    return variance_scaling_(w, 1.0, "fan_in", "truncated_normal", generator)


class Dense(nn.Linear):
    """``nn.Linear`` that computes in ``compute_dtype`` (float32 parameters)."""

    def __init__(self, din: int, dout: int, compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__(din, dout)
        self.compute_dtype = compute_dtype
        with torch.no_grad():
            trunc_normal_(self.weight, generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Inverted dropout (exact ``nn.Dropout`` semantics) with its mask drawn
    from ``generator`` (a generator on x's device; None = torch's default)."""
    if not training or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm with float32 statistics and a float32 result, whatever the
    stream's dtype (bf16 → f32 is exact)."""
    return norm(x.float())


def sinusoid_table(max_len: int, d_model: int) -> np.ndarray:
    """(max_len, d_model) sin/cos table. ≡ `HWGATE.py:16-21`."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * -(math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


def fourier_matrix(embed_dim: int, kp_dim: int, generator: torch.Generator | None = None,
                   scale: float = 10.0) -> torch.Tensor:
    """The fixed Gaussian Fourier matrix ``B`` (embed_dim/2, kp_dim) ~ N(0, 1)·scale."""
    return torch.randn(embed_dim // 2, kp_dim, generator=generator) * scale


def fourier_embed(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (..., kp_dim) → [sin(2πxBᵀ), cos(2πxBᵀ)]: the JAX package's
    ``FourierEmbed``, with ``B`` held by the model as the reference's top-level
    ``B`` buffer. ≡ `HWGATE.py:296-299, 343-345`."""
    proj = (2.0 * math.pi * x) @ b.T
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class PositionalEncoding(nn.Module):
    """Temporal sinusoid PE broadcast over joints, then dropout.
    Buffer ``pe`` is (1, T, 1, D), the reference's layout (`HWGATE.py:8-28`)."""

    def __init__(self, d_model: int, max_len: int, drop_rate: float = 0.0):
        super().__init__()
        self.register_buffer("pe", torch.from_numpy(sinusoid_table(max_len, d_model))[None, :, None])
        self.drop_rate = drop_rate

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        return dropout(x + self.pe[:, : x.shape[1]], self.drop_rate, self.training, generator)


class FeedForward(nn.Module):
    """fc1 → GELU → drop → fc2 → drop. ≡ `HWGATE.py:120-136`."""

    def __init__(self, dim: int, hidden: int, drop_rate: float = 0.0,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.fc1 = Dense(dim, hidden, compute_dtype, generator)
        self.fc2 = Dense(hidden, dim, compute_dtype, generator)
        self.drop_rate = drop_rate

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        x = dropout(gelu_exact(self.fc1(x)), self.drop_rate, self.training, generator)
        return dropout(self.fc2(x), self.drop_rate, self.training, generator)


def remat(block: nn.Module, x: torch.Tensor,
          generator: torch.Generator | None = None) -> torch.Tensor:
    """``block(x, generator)`` with its activations recomputed in the
    backward pass instead of kept (the JAX models' ``nn.remat``).

    ``torch.utils.checkpoint`` restores only torch's default generators, so
    the recompute would draw other dropout masks and prune scalars from an
    explicit ``generator``, and the gradients would be those of a forward
    that never ran. The first pass therefore runs on ``generator`` itself
    (which advances exactly as without remat), and the recompute on a fresh
    generator set to the state ``generator`` had before the block.
    """
    if not torch.is_grad_enabled():
        return block(x, generator)
    if generator is None:
        return checkpoint(block, x, None, use_reentrant=False)
    start = generator.get_state()
    passes = []

    def run(inp):
        g = generator
        if passes:  # the recompute: replay the generator from the start
            g = torch.Generator(device=generator.device)
            g.set_state(start)
        passes.append(g)
        return block(inp, g)

    return checkpoint(run, x, use_reentrant=False)
