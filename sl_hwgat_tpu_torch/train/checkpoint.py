"""Checkpoint, resume and transfer loading, ≡ ``sl_hwgat_tpu/train/checkpoint.py``
(reference `hwgat/utils.py:164-237`), with one format: ``torch.save``.

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


def save_checkpoint(path: str, state, lr: float) -> None:
    """Write ``state`` (a ``TrainState``) to ``path``. ≡ `utils.py:164-176`."""
    payload = {
        "format_version": FORMAT_VERSION,
        "model_state_dict": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
        "optimizer_state_dict": state.optimizer.state_dict(),
        "epoch": state.epoch,
        "learning_rate": lr,
        **{f"{name}_list": list(state.history[name]) for name in _HISTORY},
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


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
    and no ``optimizer_state_dict``."""
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
    model_file = {"HWGATE": "hwgate", "HGATE": "hgate", "WGATE": "wgate",
                  "GATE": "gate"}[cfg.model_type]
    pkg_dir = os.path.dirname(models_pkg.__file__)
    shutil.copy(os.path.join(pkg_dir, model_file + ".py"), out)
    shutil.copy(configs_mod.__file__, out)
    shutil.copy(transforms_mod.__file__, out)
