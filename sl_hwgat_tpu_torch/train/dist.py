"""Distributed training over ``torch.distributed``, ≡ ``sl_hwgat_tpu/train/dist.py``.

- ``initialize(backend, init_method, world_size, rank, device=None)`` joins
  the process group. The caller names the backend: ``nccl`` when each rank
  owns a card (``cuda:<local rank>``), ``gloo`` for CPU ranks and for ranks
  that share one card; nothing picks a backend or a device behind its back.
- ``run_distributed(cfg, mesh_shape=None, progress=None)`` builds the
  (dp, sp, tp) mesh over every rank, the same model on every rank from
  ``cfg.seed``, and the sharded steps (``parallel/sharding.py``: sp and tp
  where the model has a path for them, ``models.common.Splittable``; dp
  for every model), then trains:
  each rank's loaders read only its rows of every batch (``Loader.row_slice``;
  the batch order is the same everywhere, from the shared seed), every rank
  sees the global metrics, and at each better validation loss rank 0 writes
  the ``torch.save`` checkpoint gathered into the unsharded layout, or, with
  ``cfg.ckpt_backend == "orbax"``, every rank writes its own tensors into
  the sharded checkpoint (``train/checkpoint.py``), with no gather.
"""

from __future__ import annotations

import torch


def initialize(backend: str, init_method: str, world_size: int, rank: int,
               device: str | None = None) -> None:
    """Join the process group as ``rank`` of ``world_size``. ``device``: the
    rank's CUDA device (made current), or None / "cpu"."""
    import torch.distributed as dist

    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)


def shutdown() -> None:
    """Leave the process group (and forget the groups built on it)."""
    import torch.distributed as dist

    from sl_hwgat_tpu_torch.parallel import mesh as mesh_lib

    mesh_lib._GROUPS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def gathered_payload(model, optimizer, layout, epoch: int, lr: float, history: dict) -> dict:
    """The ``torch.save`` checkpoint payload of a sharded run, gathered into
    the unsharded layout on every rank (a collective of the tp group)."""
    from sl_hwgat_tpu_torch.parallel.sharding import tp_kind, unshard_state_dict
    from sl_hwgat_tpu_torch.train import checkpoint as ckpt_lib

    names = [n for n, _ in model.named_parameters()]
    model_sd = unshard_state_dict({k: v.detach() for k, v in model.state_dict().items()},
                                  layout)
    opt_sd = optimizer.state_dict()
    state = {}
    for i, fields in opt_sd["state"].items():
        state[i] = {}
        for key, t in fields.items():
            if torch.is_tensor(t) and t.ndim and tp_kind(names[i]) is not None:
                t = unshard_state_dict({names[i]: t}, layout)[names[i]]
            state[i][key] = t
    opt_sd = {"state": state, "param_groups": opt_sd["param_groups"]}
    return ckpt_lib.make_payload(model_sd, opt_sd, epoch, lr, history)


def run_distributed(cfg, mesh_shape: tuple | None = None, progress=None):
    """The distributed train and validation flow of a ``RunConfig`` on every
    rank of the process group → (final metrics, ``TrainState``)."""
    import torch.distributed as dist

    from sl_hwgat_tpu_torch.data.dataset import get_loaders
    from sl_hwgat_tpu_torch.parallel import make_mesh, mesh_shape_for
    from sl_hwgat_tpu_torch.parallel.sharding import make_sharded_steps
    from sl_hwgat_tpu_torch.train import checkpoint as ckpt_lib
    from sl_hwgat_tpu_torch.train.loop import _batch_to, init_state
    from sl_hwgat_tpu_torch.train.state import cosine_annealing_lr, set_lr

    device = torch.device(cfg.device)
    shape = tuple(mesh_shape) if mesh_shape is not None else mesh_shape_for(dist.get_world_size())
    mesh = make_mesh(shape, device.type)
    state = init_state(cfg)
    train_step, eval_step = make_sharded_steps(
        state.model, state.optimizer, mesh, criterion_type=cfg.criterion_type,
        shard_sequence=state.model.sp_path, use_tp=state.model.tp_path,
        grad_accum=cfg.grad_accum)
    layout = train_step.layout
    rank0 = dist.get_rank() == 0

    loaders = get_loaders(cfg, cfg.train_transform(), cfg.eval_transform())
    train_loader, val_loader = loaders[0], loaders[1]
    if layout.dp > 1:
        # every rank reads and transforms only its rows of each batch
        train_loader.row_slice = val_loader.row_slice = layout.rows(cfg.batch_size)
    if rank0:
        cfg.ensure_out_folder()
    hist = state.history
    best_val_loss = 9999.0
    train_loss = train_acc = val_loss = val_acc = float("nan")
    try:
        for epoch in range(state.epoch, cfg.epochs + 1):
            set_lr(state.optimizer,
                   cosine_annealing_lr(epoch, cfg.lr, cfg.scheduler_t_max)
                   if cfg.scheduler == "CosineAnnealingLR" else cfg.lr)
            tot = correct = seen = 0.0
            batches = 0
            for step, (x, y, valid) in enumerate(train_loader.epoch(epoch)):
                out = train_step(*_batch_to(device, x, y, valid), cfg.seed, epoch, step)
                tot += float(out[0])
                correct += float(out[1])
                seen += float(out[2])
                batches += 1
            train_loss, train_acc = tot / max(batches, 1), correct / max(seen, 1.0)
            vtot = vcorrect = vseen = 0.0
            vbatches = 0
            for x, y, valid in val_loader.epoch(epoch):
                loss, c, v, _ = eval_step(*_batch_to(device, x, y, valid), cfg.topk)
                vtot += float(loss)
                vcorrect += float(c)
                vseen += float(v)
                vbatches += 1
            val_loss, val_acc = vtot / max(vbatches, 1), vcorrect / max(vseen, 1.0)
            hist["train_loss"].append(train_loss)
            hist["train_acc"].append(train_acc)
            hist["val_loss"].append(val_loss)
            hist["val_acc"].append(val_acc)
            state.epoch = epoch

            if val_loss < best_val_loss:  # the same on every rank (global metric)
                best_val_loss = val_loss
                path = f"{cfg.save_model_path}_best_loss.ckpt"
                if cfg.ckpt_backend == "orbax":
                    ckpt_lib.save_checkpoint_sharded(path, state.model, state.optimizer,
                                                     state.epoch, cfg.lr, hist, mesh=layout)
                else:
                    payload = gathered_payload(state.model, state.optimizer, layout,
                                               state.epoch, cfg.lr, hist)
                    if rank0:
                        ckpt_lib.save_payload(path, payload)
                dist.barrier()
            if progress is not None:
                progress(epoch, dict(train_loss=train_loss, train_acc=train_acc,
                                     val_loss=val_loss, val_acc=val_acc))
    finally:
        for loader in loaders:
            loader.close()
    return {"train": (train_loss, train_acc), "val": (val_loss, val_acc)}, state
