"""Model registry of the port.

``build_model`` mirrors ``sl_hwgat_tpu.models.build_model``: a model is
chosen by its reference name and sized from a dataset entry and the input
dim. HWGATE, HGATE, WGATE and GATE are ported; the other names are queued
in ROADMAP.md.
"""

from __future__ import annotations

import torch

from sl_hwgat_tpu_torch.models.gate import GATE, gate_from_dataset
from sl_hwgat_tpu_torch.models.hgate import HGATE, hgate_from_dataset
from sl_hwgat_tpu_torch.models.hwgate import HWGATE, hwgate_from_dataset
from sl_hwgat_tpu_torch.models.wgate import WGATE, wgate_from_dataset

MODEL_REGISTRY = {"HWGATE": hwgate_from_dataset, "HGATE": hgate_from_dataset,
                  "WGATE": wgate_from_dataset, "GATE": gate_from_dataset}
NOT_PORTED = ("STGCN", "DecoupledGCN", "Transformer")

# Canonical joints each model consumes (64 = the WindowCreate layout, 29 = the
# raw skeleton).
MODEL_NUM_KPS = {"HWGATE": 64, "HGATE": 29, "WGATE": 64, "GATE": 29}


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def build_model(name: str, dataset_params: dict, input_dim: int, *, device="cuda",
                seed: int = 0, **overrides) -> torch.nn.Module:
    """Instantiate a model by registry name, initialised from ``seed``, in
    eval mode on ``device`` (default ``cuda``)."""
    if name in NOT_PORTED:
        raise NotImplementedError(f"{name} is not ported to PyTorch yet (see ROADMAP.md)")
    dev = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)
    model = MODEL_REGISTRY[name](dataset_params, input_dim, generator=generator, **overrides)
    return model.to(dev).eval()


__all__ = ["MODEL_REGISTRY", "MODEL_NUM_KPS", "GATE", "HGATE", "HWGATE", "WGATE",
           "build_model", "resolve_device"]
