"""Train and eval steps, the epoch loops and the epoch driver,
≡ ``sl_hwgat_tpu/train/loop.py``.

Reference `hwgat/utils.py:93-142` (per-batch loop, top-k eval) and
`:240-290` (the epoch driver: best-loss, best-acc and every-N checkpoints,
curve plots, early stopping). Batches carry
a {0,1} validity mask, so padded rows count for nothing and every batch has
one shape. A step runs eagerly: forward, backward (on a card, through the
window-attention backward kernel) and the optimizer's update, in place on
the model's parameters.

Train-time randomness (attention pruning, dropout) draws from a
``torch.Generator`` on the model's device, seeded per step from
(seed, epoch, step), so the same step gives the same loss twice.
"""

from __future__ import annotations

from collections import deque
from typing import Callable

import numpy as np
import torch

from sl_hwgat_tpu_torch.train import checkpoint as ckpt_lib
from sl_hwgat_tpu_torch.train.losses import CRITERIA, per_sample
from sl_hwgat_tpu_torch.train.state import (
    TrainState,
    cosine_annealing_lr,
    make_optimizer,
    set_lr,
)

_PIPELINE_DEPTH = 2  # steps the host may run ahead of metric readback


def step_seed(seed: int, epoch: int, step: int, micro: int | None = None) -> int:
    """The generator seed of one step (and microbatch), folded from
    (seed, epoch, step[, micro]) as the JAX package folds its key."""
    entropy = [seed, epoch, step] + ([] if micro is None else [micro])
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0])


def make_steps(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               criterion_type: str = "smooth_cross_entropy", grad_accum: int = 1):
    """(train_step, eval_step) for ``model`` and its ``optimizer``.

    ``train_step(x, y, valid, seed, epoch, step)`` makes one optimizer update
    and returns (loss, correct, seen) as 0-d tensors on the device, which the
    caller reads when it needs them. ``grad_accum > 1`` splits the batch into
    that many microbatches, each with its own generator; their unnormalised
    (valid-weighted) loss sums are backpropagated one after the other, and the
    summed gradients are divided once by the global valid count before the
    update, which is exactly the full batch's weighted loss, however the
    padding falls.

    ``eval_step(x, y, valid, k)`` returns (loss, top-k correct, seen, argmax).
    """
    criterion = CRITERIA[criterion_type]
    device = next(model.parameters()).device

    def generator(seed, epoch, step, micro=None) -> torch.Generator:
        g = torch.Generator(device=device)
        g.manual_seed(step_seed(seed, epoch, step, micro))
        return g

    def loss_sum(logits, labels, valid):
        return torch.sum(per_sample(criterion, logits, labels) * valid)

    def weighted_loss(logits, labels, valid):
        return loss_sum(logits, labels, valid) / torch.clamp(valid.sum(), min=1.0)

    def n_correct(logits, labels, valid):
        return torch.sum((logits.argmax(-1) == labels).float() * valid)

    def train_step(x, y, valid, seed: int, epoch: int, step: int):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        if grad_accum > 1:
            b = x.shape[0]
            if b % grad_accum:
                raise ValueError(f"batch {b} not divisible by grad_accum {grad_accum}")
            total, correct = 0.0, 0.0
            for i, (xm, ym, vm) in enumerate(zip(x.chunk(grad_accum), y.chunk(grad_accum),
                                                 valid.chunk(grad_accum))):
                logits = model(xm, generator(seed, epoch, step, i))
                loss = loss_sum(logits, ym, vm)
                loss.backward()
                total = total + loss.detach()
                correct = correct + n_correct(logits.detach(), ym, vm)
            seen = valid.sum()
            denom = torch.clamp(seen, min=1.0)
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(denom)
            loss = total / denom
        else:
            logits = model(x, generator(seed, epoch, step))
            loss = weighted_loss(logits, y, valid)
            loss.backward()
            loss = loss.detach()
            correct, seen = n_correct(logits.detach(), y, valid), valid.sum()
        optimizer.step()
        return loss, correct, seen

    def eval_step(x, y, valid, k: int = 1):
        model.eval()
        with torch.no_grad():
            logits = model(x)
            loss = weighted_loss(logits, y, valid)
            # top-k as the JAX package takes it: stable ascending argsort,
            # reversed (`utils.py:133-134`)
            topk = torch.argsort(logits, dim=-1, stable=True).flip(-1)[:, :k]
            correct = torch.sum((topk == y[:, None]).any(-1).float() * valid)
        return loss, correct, valid.sum(), logits.argmax(-1)

    return train_step, eval_step


def _batch_to(device, x, y, valid):
    return (torch.from_numpy(np.asarray(x, np.float32)).to(device, non_blocking=True),
            torch.from_numpy(np.asarray(y)).to(device, torch.int64, non_blocking=True),
            torch.from_numpy(np.asarray(valid, np.float32)).to(device, non_blocking=True))


class _Metrics:
    """Sums of (loss, correct, seen) read ``_PIPELINE_DEPTH`` steps late:
    reading a step's loss right after its launch would block the host on the
    device every step, so batch assembly could not overlap compute."""

    def __init__(self):
        self.pending: deque = deque()
        self.loss = self.correct = self.seen = 0.0
        self.batches = 0

    def add(self, loss, correct, seen):
        self.pending.append((loss, correct, seen))
        if len(self.pending) > _PIPELINE_DEPTH:
            self._drain_one()

    def _drain_one(self):
        loss, c, v = self.pending.popleft()
        self.loss += float(loss)
        self.correct += float(c)
        self.seen += float(v)
        self.batches += 1

    def result(self) -> tuple[float, float]:
        while self.pending:
            self._drain_one()
        return self.loss / max(self.batches, 1), self.correct / max(self.seen, 1.0)


def train_epoch(train_step, state: TrainState, loader, seed: int, epoch: int):
    """One pass over the training loader → (mean loss, accuracy). ≡ `utils.py:93-116`."""
    device = next(state.model.parameters()).device
    metrics = _Metrics()
    for step, (x, y, valid) in enumerate(loader.epoch(epoch)):
        metrics.add(*train_step(*_batch_to(device, x, y, valid), seed, epoch, step))
    return metrics.result()


def evaluate(eval_step, state: TrainState, loader, k: int = 1, epoch: int = 0):
    """Top-k evaluation → (mean loss, accuracy). ≡ `utils.py:118-142`."""
    device = next(state.model.parameters()).device
    metrics = _Metrics()
    for x, y, valid in loader.epoch(epoch):
        loss, c, v, _ = eval_step(*_batch_to(device, x, y, valid), k)
        metrics.add(loss, c, v)
    return metrics.result()


def predictions_plus_true(eval_step, state: TrainState, loader):
    """(y_pred, y_true) over a loader's valid rows. ≡ `utils.py:144-161`."""
    device = next(state.model.parameters()).device
    y_pred, y_true = [], []
    for x, y, valid in loader.epoch(0):
        _, _, _, pred = eval_step(*_batch_to(device, x, y, valid), 1)
        nvalid = int(np.sum(valid))
        y_pred += pred[:nvalid].cpu().tolist()
        y_true += np.asarray(y)[:nvalid].tolist()
    return y_pred, y_true


class EarlyStopper:
    """Stop after ``patience`` epochs without a better validation accuracy.
    ≡ `utils.py:353-368`."""

    def __init__(self, patience=1, min_delta=0):
        self.patience = patience
        self.min_delta = min_delta
        self.counter = 0
        self.max_validation_acc = 0.0

    def early_stop(self, validation_acc):
        if validation_acc > self.max_validation_acc:
            self.max_validation_acc = validation_acc
            self.counter = 0
        elif validation_acc < (self.max_validation_acc + self.min_delta):
            self.counter += 1
            if self.counter >= self.patience:
                return True
        return False


def run_epochs(cfg, state: TrainState, train_step, eval_step, train_loader, val_loader,
               early_stopper: EarlyStopper | None = None,
               progress: Callable[[int, dict], None] | None = None,
               plot: bool = True) -> TrainState:
    """Epochs ``state.epoch`` … ``cfg.epochs`` inclusive, with the cosine lr
    set at each, and the reference's three checkpoint triggers: best val
    loss, best val accuracy, and every ``save_interval`` epochs.
    ≡ `utils.py:240-290`."""
    from sl_hwgat_tpu_torch.train.reporting import plot_results

    hist = state.history
    best_val_loss = min(hist["val_loss"], default=9999.0)
    best_val_acc = max(hist["val_acc"], default=0.0)

    for epoch in range(state.epoch, cfg.epochs + 1):
        set_lr(state.optimizer,
               cosine_annealing_lr(epoch, cfg.lr, cfg.scheduler_t_max)
               if cfg.scheduler == "CosineAnnealingLR" else cfg.lr)
        train_loss, train_acc = train_epoch(train_step, state, train_loader, cfg.seed, epoch)
        val_loss, val_acc = evaluate(eval_step, state, val_loader, epoch=epoch)

        hist["train_loss"].append(train_loss)
        hist["train_acc"].append(train_acc)
        hist["val_loss"].append(val_loss)
        hist["val_acc"].append(val_acc)
        state.epoch = epoch

        backend = cfg.ckpt_backend
        if val_loss < best_val_loss:
            best_val_loss = val_loss
            ckpt_lib.save_checkpoint(f"{cfg.save_model_path}_best_loss.ckpt", state, cfg.lr,
                                     backend)
        if val_acc > best_val_acc:
            best_val_acc = val_acc
            ckpt_lib.save_checkpoint(f"{cfg.save_model_path}_best_acc.ckpt", state, cfg.lr,
                                     backend)
        if epoch > 0 and epoch % cfg.save_interval == 0:
            ckpt_lib.save_checkpoint(f"{cfg.save_model_path}_{epoch}.ckpt", state, cfg.lr,
                                     backend)

        if progress is not None:
            progress(epoch, dict(train_loss=train_loss, train_acc=train_acc,
                                 val_loss=val_loss, val_acc=val_acc,
                                 best_val_loss=best_val_loss))
        if plot:
            plot_results(hist["train_loss"], hist["val_loss"], "loss",
                         cfg.criterion_type, cfg.save_loss_curve_path)
            plot_results(hist["train_acc"], hist["val_acc"], "acc",
                         "accuracy", cfg.save_acc_curve_path)
        if cfg.early_stopping and early_stopper is not None and early_stopper.early_stop(val_acc):
            break
    return state


def init_state(cfg) -> TrainState:
    """The model of ``cfg`` initialised from ``cfg.seed`` on ``cfg.device``,
    and its optimizer, for a fresh run. ≡ `loop.py:290-302`."""
    from sl_hwgat_tpu_torch.models import build_model

    model = build_model(cfg.model_type, cfg.dataset_params, cfg.input_dim, device=cfg.device,
                        seed=cfg.seed, **cfg.overrides)
    optimizer = make_optimizer(cfg.optimizer_type, cfg.lr, model.parameters())
    return TrainState(model, optimizer, base_lr=cfg.lr)
