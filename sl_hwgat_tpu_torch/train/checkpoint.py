"""Checkpoint, resume and transfer loading, ≡ ``sl_hwgat_tpu/train/checkpoint.py``
(reference `hwgat/utils.py:164-237`), in two formats: one ``torch.save``
file (backend "pickle", the default), or the sharded checkpoint (backend
"orbax", the JAX flag's name for the JAX package's Orbax directory).

- A checkpoint holds the reference's payload: the model's state_dict, the
  optimizer's, the epoch, the learning rate and the four history curves,
  under the JAX package's field names. A ``.tmp`` file is written, then
  moved into place.
- Resume restores all of it and continues at epoch + 1.
- Transfer loading is shape-checked and partial: tensors that are missing
  or of another shape keep their fresh init, with one report line. Its
  sources are a port ``.ckpt``, a JAX package ``.ckpt`` (weights only) and a
  reference or port ``.pt``.
- The experiment snapshot pickles the config and copies the model's,
  ``configs.py``'s and the transforms' sources into the run folder.

The sharded checkpoint is a ``torch.distributed.checkpoint`` directory
``<path>/`` plus a pickle sidecar ``<path>.meta`` (epoch, learning rate,
history, the parameter names and optimizer groups, the tp size). In a
sharded run every rank calls ``save_checkpoint_sharded`` and writes the
tensors it holds, with no gather: entries of ``parallel.sharding.TP_RULES``
are stored per tp rank (``<name>/tp<t>of<T>``), the others once.
``read_checkpoint_sharded`` loads each rank's own tensors back in place;
``read_checkpoint`` of such a directory assembles the unsharded payload, so
resume, transfer and ``Predictor.from_checkpoint`` read it as they read a
file.

A JAX package ``.ckpt`` is a plain pickle of numpy trees and optax states.
It is read by an unpickler that resolves numpy and gives a stub for every
``jax``, ``flax`` or ``optax`` class, so none of those packages is imported;
its ``variables`` become a state_dict through ``weights.state_dict_from_jax``
and its optimizer state is not used.
"""

from __future__ import annotations

import os
import pickle
import shutil
import zipfile

import torch

from sl_hwgat_tpu_torch import weights

FORMAT_VERSION = 1
_HISTORY = ("train_loss", "val_loss", "train_acc", "val_acc")


def make_payload(model_state_dict: dict, optimizer_state_dict: dict, epoch: int, lr: float,
                 history: dict) -> dict:
    """The checkpoint payload of the reference's fields."""
    return {
        "format_version": FORMAT_VERSION,
        "model_state_dict": {k: v.detach().cpu() for k, v in model_state_dict.items()},
        "optimizer_state_dict": optimizer_state_dict,
        "epoch": epoch,
        "learning_rate": lr,
        **{f"{name}_list": list(history[name]) for name in _HISTORY},
    }


def save_payload(path: str, payload: dict) -> None:
    """``torch.save`` a payload to ``path`` through a ``.tmp`` file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, state, lr: float, backend: str = "pickle") -> None:
    """Write ``state`` (a ``TrainState``) to ``path``: one ``torch.save``
    file, or with ``backend="orbax"`` the sharded checkpoint of this one
    process. ≡ `utils.py:164-176`."""
    if backend == "orbax":
        save_checkpoint_sharded(path, state.model, state.optimizer, state.epoch, lr,
                                state.history)
        return
    if backend != "pickle":
        raise ValueError(f"unknown checkpoint backend: {backend}")
    save_payload(path, make_payload(state.model.state_dict(), state.optimizer.state_dict(),
                                    state.epoch, lr, state.history))


def _sharded_entries(model, optimizer, tp: int, tp_rank: int) -> dict:
    """The tensors a rank writes (and reads back in place), by key."""
    from sl_hwgat_tpu_torch.parallel.sharding import tp_kind

    def key(prefix, name, *rest):
        suffix = f"/tp{tp_rank}of{tp}" if tp > 1 and tp_kind(name) is not None else ""
        return "/".join((prefix, name, *rest)) + suffix

    entries = {key("model", n): t for n, t in model.state_dict().items()}
    names = [n for n, _ in model.named_parameters()]
    index = {id(p): i for i, p in enumerate(model.parameters())}
    for group in optimizer.param_groups:
        for p in group["params"]:
            for field, t in optimizer.state.get(p, {}).items():
                name = names[index[id(p)]]
                entries[key("optim", name, field) if torch.is_tensor(t) and t.ndim
                        else "/".join(("optim", name, field))] = t
    return entries


def save_checkpoint_sharded(path: str, model, optimizer, epoch: int, lr: float, history: dict,
                            mesh=None) -> None:
    """Write the sharded checkpoint ``<path>/`` + ``<path>.meta``. In a
    sharded run every rank calls it with its live model and optimizer and
    its layout ``mesh`` (a ``parallel.mesh.Layout``), and writes what it
    holds; rank 0 writes the sidecar. Without a process group it writes one
    process's tensors."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    tp, tp_rank = (mesh.tp, mesh.rank("tp")) if mesh is not None else (1, 0)
    distributed = dist.is_initialized()
    d = os.path.abspath(path)
    if not distributed or dist.get_rank() == 0:
        os.makedirs(d, exist_ok=True)
    if distributed:
        dist.barrier()
    dcp.save(_sharded_entries(model, optimizer, tp, tp_rank), checkpoint_id=d,
             no_dist=not distributed)
    if not distributed or dist.get_rank() == 0:
        meta = {
            "format_version": FORMAT_VERSION,
            "epoch": epoch,
            "learning_rate": lr,
            **{f"{name}_list": list(history[name]) for name in _HISTORY},
            "param_names": [n for n, _ in model.named_parameters()],
            "param_groups": optimizer.state_dict()["param_groups"],
            "tp": tp,
        }
        tmp = d + ".meta.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(meta, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, d + ".meta")
    if distributed:
        dist.barrier()


def _read_meta(path: str) -> dict:
    with open(os.path.abspath(path) + ".meta", "rb") as f:
        return pickle.load(f)


def read_checkpoint_sharded(path: str, model, optimizer, mesh=None) -> dict:
    """Load a sharded checkpoint into ``model`` and ``optimizer`` in place:
    each rank reads the tensors it holds (the same call as
    ``save_checkpoint_sharded``, on every rank). Returns the sidecar's
    fields (epoch, learning rate, history)."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    meta = _read_meta(path)
    tp, tp_rank = (mesh.tp, mesh.rank("tp")) if mesh is not None else (1, 0)
    if meta["tp"] != tp:
        raise ValueError(f"{path} holds tp {meta['tp']} shards, this run has {tp}")
    # the optimizer state must exist to be read into: take a zero step
    # first if it has none (its values are then overwritten)
    if not optimizer.state and any(k.startswith("optim/") for k in _stored_keys(path)):
        _init_optimizer_state(model, optimizer)
    # state_dict() and the optimizer's state share storage with the live
    # tensors, so the load writes into them
    dcp.load(_sharded_entries(model, optimizer, tp, tp_rank),
             checkpoint_id=os.path.abspath(path), no_dist=not dist.is_initialized())
    return meta


def _stored_keys(path: str) -> list[str]:
    from torch.distributed.checkpoint import FileSystemReader

    return list(FileSystemReader(os.path.abspath(path)).read_metadata().state_dict_metadata)


def _init_optimizer_state(model, optimizer) -> None:
    """Create ``optimizer``'s per-parameter state with one step on zero
    gradients and no learning rate, then restore the parameters."""
    saved = [p.detach().clone() for p in model.parameters()]
    lrs = [g["lr"] for g in optimizer.param_groups]
    for g in optimizer.param_groups:
        g["lr"] = 0.0
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    optimizer.step()
    with torch.no_grad():
        for p, s in zip(model.parameters(), saved):
            p.copy_(s)
            p.grad = None
    for g, lr in zip(optimizer.param_groups, lrs):
        g["lr"] = lr


def _read_sharded_full(path: str) -> dict:
    """The unsharded payload of a sharded checkpoint, read in this process
    alone: every stored tensor, the tp shards merged."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemReader

    from sl_hwgat_tpu_torch.parallel.sharding import merge_tensor, tp_kind

    d = os.path.abspath(path)
    meta = _read_meta(path)
    stored = FileSystemReader(d).read_metadata().state_dict_metadata
    entries = {}
    for k, m in stored.items():
        if hasattr(m, "size"):
            entries[k] = torch.zeros(tuple(m.size), dtype=m.properties.dtype)
        else:
            entries[k] = None
    dcp.load(entries, checkpoint_id=d, no_dist=True)
    tp = meta["tp"]
    merged: dict = {}
    for k, t in entries.items():
        base, sep, shard = k.rpartition("/tp")
        if tp > 1 and sep and shard.endswith(f"of{tp}"):
            merged.setdefault(base, [None] * tp)[int(shard.split("of")[0])] = t
        else:
            merged[k] = t
    for k, v in merged.items():
        if isinstance(v, list):
            merged[k] = merge_tensor(v, tp_kind(k.split("/")[1]))
    model_sd = {k[len("model/"):]: v for k, v in merged.items() if k.startswith("model/")}
    names = meta["param_names"]
    state = {}
    for i, name in enumerate(names):
        prefix = f"optim/{name}/"
        fields = {k[len(prefix):]: v for k, v in merged.items() if k.startswith(prefix)}
        if fields:
            state[i] = fields
    out = {k: v for k, v in meta.items() if k not in ("param_names", "param_groups", "tp")}
    out["model_state_dict"] = model_sd
    out["optimizer_state_dict"] = {"state": state, "param_groups": meta["param_groups"]}
    return out


class _Stub:
    """Stands in for a class of jax, flax or optax: takes whatever the
    pickle gives it and keeps it."""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args, obj.kwargs = args, kwargs
        return obj

    def __setstate__(self, state):
        self.state = state


class _JaxCheckpointUnpickler(pickle.Unpickler):
    """Resolves numpy's names and stubs jax's, flax's and optax's; refuses
    anything else."""

    _STUBBED = ("jax", "jaxlib", "flax", "optax")

    def find_class(self, module, name):
        root = module.split(".")[0]
        if root in self._STUBBED:
            return type(name, (_Stub,), {"__module__": module})
        if root == "numpy":
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"unexpected class {module}.{name} in a JAX checkpoint")


def read_checkpoint(path: str) -> dict:
    """A checkpoint's payload, its weights as the port's ``model_state_dict``.
    A port file (a zip archive) is read with ``torch.load(weights_only=True)``;
    a JAX package file gives its weights, epoch, learning rate and history,
    and no ``optimizer_state_dict``; a sharded checkpoint's directory gives
    the unsharded payload."""
    if os.path.isdir(path):
        return _read_sharded_full(path)
    if zipfile.is_zipfile(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    with open(path, "rb") as f:
        payload = _JaxCheckpointUnpickler(f).load()
    out = {k: v for k, v in payload.items() if k not in ("variables", "opt_state")}
    out["model_state_dict"] = weights.state_dict_from_jax(payload["variables"])
    return out


def _source_state_dict(path: str) -> dict[str, torch.Tensor]:
    if path.endswith(".pt"):
        return weights.load_state_dict(path)
    return read_checkpoint(path)["model_state_dict"]


def load_pretrained_into(state, path: str, verbose: bool = True):
    """Shape-checked partial weight load; the optimizer and history stay
    fresh. Tensors missing from ``path`` or of another shape keep their
    fresh init and are named on one line. ≡ `utils.py:185-214`."""
    source = _source_state_dict(path)
    skipped = []
    with torch.no_grad():
        for name, tensor in state.model.state_dict().items():
            src = source.get(name)
            if src is None or tuple(src.shape) != tuple(tensor.shape):
                skipped.append(name)
                continue
            tensor.copy_(src)
    if verbose and skipped:
        print("[checkpoint] kept fresh init for:", ", ".join(skipped))
    return state


def resume_from(state, path: str):
    """Full resume: weights, optimizer, epoch + 1 and history.
    ≡ `utils.py:226-237`."""
    ckpt = read_checkpoint(path)
    if "optimizer_state_dict" not in ckpt:
        raise ValueError(f"{path} holds no optimizer state the port can read (a JAX "
                         "checkpoint); transfer its weights with -mw instead")
    state.model.load_state_dict(ckpt["model_state_dict"])
    state.optimizer.load_state_dict(ckpt["optimizer_state_dict"])
    state.epoch = ckpt["epoch"] + 1
    state.history = {name: list(ckpt[f"{name}_list"]) for name in _HISTORY}
    return state


def save_experiment_snapshot(cfg) -> None:
    """Pickle the config and copy the model, config and transform sources
    into the run folder. ≡ `utils.py:178-183`."""
    import sl_hwgat_tpu_torch.configs as configs_mod
    import sl_hwgat_tpu_torch.data.transforms as transforms_mod
    from sl_hwgat_tpu_torch import models as models_pkg

    out = cfg.ensure_out_folder()
    with open(cfg.save_config_path, "wb") as f:
        pickle.dump(cfg, f)
    model_file = {"HWGATE": "hwgate", "HGATE": "hgate", "WGATE": "wgate", "GATE": "gate",
                  "STGCN": "stgcn", "DecoupledGCN": "decoupled_gcn",
                  "Transformer": "transformer"}[cfg.model_type]
    pkg_dir = os.path.dirname(models_pkg.__file__)
    shutil.copy(os.path.join(pkg_dir, model_file + ".py"), out)
    shutil.copy(configs_mod.__file__, out)
    shutil.copy(transforms_mod.__file__, out)
