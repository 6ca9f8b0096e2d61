"""Optimizer, schedule and train state, ≡ ``sl_hwgat_tpu/train/state.py``.

Reference `hwgat/utils.py:62-91`: AdamW/Adam/NAdam/SGD with torch-default
hyperparameters, cosine-annealing LR with T_max = 20 stepped once per epoch,
in closed form (that of ``torch.optim.lr_scheduler.CosineAnnealingLR``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch


def cosine_annealing_lr(epoch: int, base_lr: float, t_max: int = 20,
                        eta_min: float = 0.0) -> float:
    """lr(e) = η_min + (lr₀ − η_min)·(1 + cos(π·e/T_max))/2 — the closed form
    of torch CosineAnnealingLR (periodic beyond T_max)."""
    return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * epoch / t_max)) / 2


def make_optimizer(optimizer_type: str, lr: float, params) -> torch.optim.Optimizer:
    """The JAX package's hyperparameters (`utils.py:73-84`). optax ``adamw``
    and torch ``AdamW`` both decay the pre-update weights by lr·wd."""
    params = list(params)
    if optimizer_type == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=0.01)
    if optimizer_type == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if optimizer_type == "sgd":
        return torch.optim.SGD(params, lr=lr)
    if optimizer_type == "nadam":
        return OptaxNAdam(params, lr=lr)
    raise ValueError(f"unknown optimizer: {optimizer_type}")


class OptaxNAdam(torch.optim.Optimizer):
    """``optax.nadam`` with its defaults (``scale_by_adam(nesterov=True)``,
    Dozat 2016 without the extra b2 factor), the JAX package's
    ``make_optimizer("nadam")``.
    At step t (from 1), with μ, ν the moments after g:

        μ̂ = b1·μ / (1 − b1^(t+1)) + (1 − b1)·g / (1 − b1^t)
        ν̂ = ν / (1 − b2^t)
        p ← p − lr·μ̂ / (√ν̂ + eps)

    ``torch.optim.NAdam`` is another function (its momentum decay
    schedule ψ), so it is not used. State per parameter: ``step`` (a float
    tensor, as torch's Adam keeps it), ``exp_avg``, ``exp_avg_sq``.
    """

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.float32)
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                g = p.grad
                state["step"] += 1
                t = int(state["step"].item())
                mu, nu = state["exp_avg"], state["exp_avg_sq"]
                mu.mul_(b1).add_(g, alpha=1 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1 - b2)
                mu_hat = mu * (b1 / (1 - b1 ** (t + 1))) + g * ((1 - b1) / (1 - b1 ** t))
                denom = (nu / (1 - b2 ** t)).sqrt_().add_(group["eps"])
                p.addcdiv_(mu_hat, denom, value=-group["lr"])
        return loss


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Set the learning rate of every parameter group (scheduler step)."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer


@dataclass
class TrainState:
    """The model and its optimizer, plus host-side bookkeeping.

    ``history``: the four curves the reference checkpoints (`utils.py:164-176`).
    """

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    epoch: int = 0
    base_lr: float = 5e-4
    history: dict = field(
        default_factory=lambda: {
            "train_loss": [], "val_loss": [], "train_acc": [], "val_acc": [],
        }
    )
