"""Weights across frameworks: the reference key layout, JAX trees, ``.pt`` files.

The port's models use the reference PyTorch key layout
(`hwgat/models/HWGATE.py:260-331`, `HGATE.py`, `WGATE.py`, `GATE.py`): ``B``,
``pos_encoder.pe`` (1, T, 1, D), the blocks' ``{norm1,norm2}.*``, a fused
``attn.qkv`` with rows [q | k | v], ``attn.proj`` and ``ff.{fc1,fc2}`` under
``layers.{i}.blocks.{j}`` (HWGATE, HGATE) or ``layers.{i}`` (WGATE, GATE), then
``norm``, GATE's ``weightedAvg`` and ``head``. So a reference checkpoint
loads as it is, and ``state_dict_from_jax`` is the exact inverse of the JAX
package's ``gat_family_from_torch``.

Port checkpoints are ``torch.save({"model_state_dict": state_dict})``.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

# Reference buffers that the port rebuilds from the graph instead of loading.
_REBUILT = ("adj_mask", "attn_mask")


def params_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """A JAX HWGATE, HGATE, WGATE or GATE ``params`` tree (numpy leaves: the
    parameters, their gradients or any tree of that structure; no buffers)
    → a dict under the port's parameter names (``model.named_parameters()``).
    flax kernels (in, out) become torch weights (out, in); the separate
    q/k/v projections are stacked into ``attn.qkv``."""
    sd: dict[str, np.ndarray] = {}

    def dense(prefix: str, p: Mapping):
        sd[f"{prefix}.weight"] = np.asarray(p["kernel"]).T
        sd[f"{prefix}.bias"] = np.asarray(p["bias"])

    def norm(prefix: str, p: Mapping):
        sd[f"{prefix}.weight"] = np.asarray(p["scale"])
        sd[f"{prefix}.bias"] = np.asarray(p["bias"])

    blk = re.compile(r"layers_(\d+)(?:_blocks_(\d+))?$")
    for name, p in params.items():
        m = blk.match(name)
        if m is None:
            continue
        base = f"layers.{m.group(1)}" + (f".blocks.{m.group(2)}" if m.group(2) else "")
        norm(f"{base}.norm1", p["norm1"])
        norm(f"{base}.norm2", p["norm2"])
        attn = p["attn"]
        sd[f"{base}.attn.qkv.weight"] = np.concatenate(
            [np.asarray(attn[n]["kernel"]).T for n in ("q", "k", "v")])
        sd[f"{base}.attn.qkv.bias"] = np.concatenate(
            [np.asarray(attn[n]["bias"]) for n in ("q", "k", "v")])
        dense(f"{base}.attn.proj", attn["proj"])
        dense(f"{base}.ff.fc1", p["ff"]["fc1"])
        dense(f"{base}.ff.fc2", p["ff"]["fc2"])
    norm("norm", params["norm"])
    if "weightedAvg" in params:
        dense("weightedAvg", params["weightedAvg"])
    dense("head", params["head"])
    return {k: torch.tensor(np.asarray(v, dtype=np.float32)) for k, v in sd.items()}


def state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX ``{'params': ..., 'buffers': ...}`` of HWGATE, HGATE, WGATE or GATE
    (numpy leaves) → the port's state_dict: ``params_from_jax`` plus the two
    buffers."""
    buffers = variables["buffers"]
    sd = {
        "B": torch.tensor(np.asarray(buffers["fourier"]["B"], dtype=np.float32)),
        "pos_encoder.pe": torch.tensor(
            np.asarray(buffers["pos_encoder"]["pe"], dtype=np.float32)[None, :, None, :]),
    }
    sd.update(params_from_jax(variables["params"]))
    return sd


def strip_model_prefix(state_dict: Mapping) -> dict:
    """Drop a leading "model." from every key (reference `utils.py:188`)."""
    return {k.replace("model.", "", 1) if k.startswith("model.") else k: v
            for k, v in state_dict.items()}


def load_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A reference or port ``.pt`` file → the port's state_dict (on the CPU)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt)
    return {k: v for k, v in strip_model_prefix(sd).items()
            if not k.endswith(_REBUILT)}


def save_state_dict(path: str, model: torch.nn.Module) -> None:
    """Write a port checkpoint."""
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"model_state_dict": sd}, path)
