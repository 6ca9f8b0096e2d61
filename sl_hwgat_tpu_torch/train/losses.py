"""Losses, ≡ ``sl_hwgat_tpu/train/losses.py``.

Label-smoothed cross-entropy (reference `hwgat/losses/SmoothCrossEntropy.py:8-39`):
loss = (1 - s)·NLL(target) + s·mean(-log p), s = 0.01 by default.
"""

from __future__ import annotations

import torch


def smoothed_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                           smooth_factor: float = 0.01) -> torch.Tensor:
    """logits (N, C), integer targets (N,) → scalar mean loss."""
    log_probs = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(log_probs, -1, targets[:, None].long())[:, 0]
    smooth = -log_probs.mean(dim=-1)
    return ((1.0 - smooth_factor) * nll + smooth_factor * smooth).mean()


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    log_probs = torch.log_softmax(logits, dim=-1)
    return -torch.gather(log_probs, -1, targets[:, None].long()).mean()


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


CRITERIA = {
    "smooth_cross_entropy": smoothed_cross_entropy,
    "cross_entropy": cross_entropy,
    "mse": mse,
}


def per_sample(criterion, logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """(N,) losses, ``criterion`` applied to each row on its own (the JAX
    package's ``vmap(lambda lg, lb: criterion(lg[None], lb[None]))``)."""
    return torch.func.vmap(lambda lg, lb: criterion(lg[None], lb[None]))(logits, targets)
