"""Optimizer, schedule and train state, ≡ ``sl_hwgat_tpu/train/state.py``.

Reference `hwgat/utils.py:62-91`: AdamW/Adam/SGD with torch-default
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
        # optax's nadam has no counterpart in torch.optim (NAdam's momentum
        # decay schedule differs): see ROADMAP.md
        raise NotImplementedError("nadam is not ported (see ROADMAP.md)")
    raise ValueError(f"unknown optimizer: {optimizer_type}")


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
