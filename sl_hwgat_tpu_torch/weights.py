"""Weights across frameworks: the reference key layout, JAX trees, ``.pt`` files.

The port's models use the reference PyTorch key layout
(`hwgat/models/HWGATE.py:260-331`, `HGATE.py`, `WGATE.py`, `GATE.py`): ``B``,
``pos_encoder.pe`` (1, T, 1, D), the blocks' ``{norm1,norm2}.*``, a fused
``attn.qkv`` with rows [q | k | v], ``attn.proj`` and ``ff.{fc1,fc2}`` under
``layers.{i}.blocks.{j}`` (HWGATE, HGATE) or ``layers.{i}`` (WGATE, GATE), then
``norm``, GATE's ``weightedAvg`` and ``head``. The baselines carry the reference's keys too: STGCN
(`STGCN.py:194-237`), DecoupledGCN (`DecoupledGCN.py:361-455`) and the
Transformer (`Transformer.py:8-99`), with torch's BatchNorm buffers
(``running_mean``, ``running_var``, ``num_batches_tracked``). So a reference
checkpoint loads as it is, and ``state_dict_from_jax`` is the exact inverse
of the JAX package's ``gat_family_from_torch``, ``stgcn_from_torch``,
``decoupled_gcn_from_torch`` and ``transformer_from_torch`` (which drop
``num_batches_tracked``; it comes back as 0).

Port checkpoints are ``torch.save({"model_state_dict": state_dict})``.
"""

from __future__ import annotations

import os
import re
from typing import Mapping

import numpy as np
import torch

# Reference buffers that the port rebuilds from the graph instead of loading:
# the attention masks, STGCN's partition stack ``A``, DecoupledGCN's ``A`` and
# ``eye_list``.
_REBUILT = ("adj_mask", "attn_mask", "eye_list")
_REBUILT_GRAPH = "A"


def _rebuilt(key: str) -> bool:
    return key.endswith(_REBUILT) or key.rsplit(".", 1)[-1] == _REBUILT_GRAPH


def _conv(sd: dict, prefix: str, p: Mapping) -> None:
    """flax conv kernel (*taps, in, out) → torch weight (out, in, *taps)."""
    k = np.asarray(p["kernel"])
    sd[f"{prefix}.weight"] = np.moveaxis(k, (-1, -2), (0, 1))
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _linear(sd: dict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = np.asarray(p["kernel"]).T
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _batch_norm(sd: dict, prefix: str, p: Mapping, stats: Mapping | None) -> None:
    """scale/bias (and, given ``stats``, mean/var) → torch's BatchNorm keys."""
    sd[f"{prefix}.weight"] = np.asarray(p["scale"])
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])
    if stats is not None:
        sd[f"{prefix}.running_mean"] = np.asarray(stats["mean"])
        sd[f"{prefix}.running_var"] = np.asarray(stats["var"])
        sd[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def _stats_at(stats: Mapping | None, *path: str) -> Mapping | None:
    """The batch-stats subtree at ``path``, or None without ``stats``."""
    if stats is None:
        return None
    for p in path:
        stats = stats[p]
    return stats


def _stgcn(params: Mapping, stats: Mapping | None) -> dict:
    """Inverse of the JAX package's ``stgcn_from_torch``."""
    sd: dict = {}

    def st(*path):
        return _stats_at(stats, *path)
    _batch_norm(sd, "data_bn", params["data_bn"], st("data_bn"))
    for name, p in params.items():
        if name.startswith("edge_importance_"):
            sd[f"edge_importance.{name.rsplit('_', 1)[1]}"] = np.asarray(p)
        elif name.startswith("st_gcn_"):
            i = name.rsplit("_", 1)[1]
            base = f"st_gcn_networks.{i}"
            _conv(sd, f"{base}.gcn.conv", p["gcn"]["conv"])
            _batch_norm(sd, f"{base}.tcn.0", p["tcn_bn1"], st(name, "tcn_bn1"))
            _conv(sd, f"{base}.tcn.2", p["tcn_conv"])
            _batch_norm(sd, f"{base}.tcn.3", p["tcn_bn2"], st(name, "tcn_bn2"))
            if "res_conv" in p:
                _conv(sd, f"{base}.residual.0", p["res_conv"])
                _batch_norm(sd, f"{base}.residual.1", p["res_bn"], st(name, "res_bn"))
    _linear(sd, "head.classifier", params["classifier"])
    return sd


def _decoupled_gcn(params: Mapping, stats: Mapping | None) -> dict:
    """Inverse of the JAX package's ``decoupled_gcn_from_torch``."""
    sd: dict = {}

    def st(*path):
        return _stats_at(stats, *path)
    _batch_norm(sd, "data_bn", params["data_bn"], st("data_bn"))
    for name, p in params.items():
        if not re.fullmatch(r"l\d+", name):
            continue
        g = p["gcn1"]
        sd[f"{name}.gcn1.decoupled_A"] = np.asarray(g["decoupled_A"])
        sd[f"{name}.gcn1.linear_weight"] = np.asarray(g["linear_weight"])
        sd[f"{name}.gcn1.linear_bias"] = np.asarray(g["linear_bias"]).reshape(1, -1, 1, 1)
        _batch_norm(sd, f"{name}.gcn1.bn0", g["bn0"], st(name, "gcn1", "bn0"))
        _batch_norm(sd, f"{name}.gcn1.bn", g["bn"], st(name, "gcn1", "bn"))
        if "down_conv" in g:
            _conv(sd, f"{name}.gcn1.down.0", g["down_conv"])
            _batch_norm(sd, f"{name}.gcn1.down.1", g["down_bn"], st(name, "gcn1", "down_bn"))
        for conv in ("conv_sa", "conv_ta"):
            _conv(sd, f"{name}.{conv}", p[conv])
        _linear(sd, f"{name}.fc1c", p["fc1c"])
        _linear(sd, f"{name}.fc2c", p["fc2c"])
        for unit in ("tcn1", "residual"):
            if unit in p:
                _conv(sd, f"{name}.{unit}.conv", p[unit]["conv"])
                _batch_norm(sd, f"{name}.{unit}.bn", p[unit]["bn"], st(name, unit, "bn"))
    _linear(sd, "head.classifier", params["classifier"])
    return sd


def _transformer(params: Mapping) -> dict:
    """Inverse of the JAX package's ``transformer_from_torch`` (parameters)."""
    sd: dict = {}
    _linear(sd, "encoder", params["encoder"])
    for name, p in params.items():
        m = re.fullmatch(r"layers_(\d+)", name)
        if m is None:
            continue
        base = f"transformer_encoder.layers.{m.group(1)}"
        attn = p["self_attn"]
        sd[f"{base}.self_attn.in_proj_weight"] = np.asarray(attn["in_proj"]["kernel"]).T
        sd[f"{base}.self_attn.in_proj_bias"] = np.asarray(attn["in_proj"]["bias"])
        _linear(sd, f"{base}.self_attn.out_proj", attn["out_proj"])
        _linear(sd, f"{base}.linear1", p["linear1"])
        _linear(sd, f"{base}.linear2", p["linear2"])
        for norm in ("norm1", "norm2"):
            sd[f"{base}.{norm}.weight"] = np.asarray(p[norm]["scale"])
            sd[f"{base}.{norm}.bias"] = np.asarray(p[norm]["bias"])
    sd["transformer_encoder.norm.weight"] = np.asarray(params["norm"]["scale"])
    sd["transformer_encoder.norm.bias"] = np.asarray(params["norm"]["bias"])
    _linear(sd, "classifier", params["classifier"])
    return sd


def _model_kind(params: Mapping) -> str:
    """Which model's JAX ``params`` tree this is: "stgcn", "decoupled_gcn",
    "transformer" or "gat" (HWGATE, HGATE, WGATE, GATE)."""
    if "st_gcn_0" in params:
        return "stgcn"
    if "l1" in params:
        return "decoupled_gcn"
    if "encoder" in params:
        return "transformer"
    return "gat"


def _tensors(sd: Mapping) -> dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(v, dtype=np.int64 if k.endswith("num_batches_tracked")
                                       else np.float32)) for k, v in sd.items()}


def params_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """A JAX ``params`` tree of any registry model (numpy leaves: the
    parameters, their gradients or any tree of that structure; no buffers or
    batch stats) → a dict under the port's parameter names
    (``model.named_parameters()``). flax kernels (in, out) become torch
    weights (out, in); the separate q/k/v projections of the graph-attention
    models are stacked into ``attn.qkv``."""
    kind = _model_kind(params)
    if kind == "stgcn":
        return _tensors(_stgcn(params, None))
    if kind == "decoupled_gcn":
        return _tensors(_decoupled_gcn(params, None))
    if kind == "transformer":
        return _tensors(_transformer(params))
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
    """JAX variables of any registry model (numpy leaves) → the port's
    state_dict: ``params_from_jax`` plus the buffers (HWGATE, HGATE, WGATE,
    GATE: ``B`` and ``pos_encoder.pe``, the latter absent from a model built
    with ``pe=False``; Transformer: ``pos_encoder.pe``) or
    the BatchNorm running statistics (STGCN, DecoupledGCN: ``batch_stats``'
    mean and var, ``num_batches_tracked`` 0)."""
    params = variables["params"]
    kind = _model_kind(params)
    if kind == "stgcn":
        return _tensors(_stgcn(params, variables["batch_stats"]))
    if kind == "decoupled_gcn":
        return _tensors(_decoupled_gcn(params, variables["batch_stats"]))
    if kind == "transformer":
        sd = _transformer(params)
        sd["pos_encoder.pe"] = np.asarray(variables["buffers"]["pe"])[None]
        return _tensors(sd)
    buffers = variables["buffers"]
    sd = {"B": torch.tensor(np.asarray(buffers["fourier"]["B"], dtype=np.float32))}
    if "pos_encoder" in buffers:
        sd["pos_encoder.pe"] = torch.tensor(
            np.asarray(buffers["pos_encoder"]["pe"], dtype=np.float32)[None, :, None, :])
    sd.update(params_from_jax(variables["params"]))
    return sd


def strip_model_prefix(state_dict: Mapping) -> dict:
    """Drop a leading "model." from every key (reference `utils.py:188`)."""
    return {k.replace("model.", "", 1) if k.startswith("model.") else k: v
            for k, v in state_dict.items()}


def load_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A reference or port ``.pt`` file, or a port checkpoint (a file, or a
    sharded checkpoint's directory) → the port's state_dict (on the CPU)."""
    if os.path.isdir(path):
        from sl_hwgat_tpu_torch.train.checkpoint import read_checkpoint

        return read_checkpoint(path)["model_state_dict"]
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt)
    return {k: v for k, v in strip_model_prefix(sd).items() if not _rebuilt(k)}


def save_state_dict(path: str, model: torch.nn.Module) -> None:
    """Write a port checkpoint."""
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"model_state_dict": sd}, path)
