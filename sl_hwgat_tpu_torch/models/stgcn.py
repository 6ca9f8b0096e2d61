"""ST-GCN baseline — spatial-temporal graph convolutional network.

PyTorch counterpart of ``sl_hwgat_tpu/models/stgcn.py`` (reference
`hwgat/models/STGCN.py:8-269`, Yan et al. 2018). It runs in the reference's
(N, C, T, V) layout, so every BatchNorm normalises axis 1 and every
convolution is an ``nn.Conv2d`` over (T, V); the per-partition aggregation is
``einsum('nkctv,kvw->nctw')`` on the (K, V, V) spatial-strategy stack of
``graphs.partition.GraphPartition``. Input (B, T, V=29, C), as the JAX model
takes it.

BatchNorm is torch's own (``nn.BatchNorm1d``/``2d``, momentum 0.1, eps
1e-5): the JAX package's ``TorchBatchNorm`` reproduces exactly its train
mode (biased variance to normalise, unbiased to update the running one).
``data_bn`` sees the clip flattened to (N, V·C, T) with feature v·C + c, the
JAX model's (T, V·C) reshape. The state_dict carries the reference's keys
(``data_bn``, ``st_gcn_networks.{i}.{gcn.conv, tcn.{0,2,3}, residual.{0,1}}``,
``edge_importance.{i}``, ``head.classifier``); the partition stack ``A`` is
rebuilt from the graph, not stored. Dropout draws from the generator the
train step passes in.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from sl_hwgat_tpu_torch.graphs.partition import GraphPartition
from sl_hwgat_tpu_torch.graphs.skeleton import BODY29_EDGES
from sl_hwgat_tpu_torch.models.common import Splittable, dropout, lecun_normal_

# (out_channels, stride) of the ten blocks, `STGCN.py:215-228`
SCHEDULE = ((64, 1), (64, 1), (64, 1), (64, 1), (128, 2),
            (128, 1), (128, 1), (256, 2), (256, 1), (256, 1))


def conv2d(cin: int, cout: int, kernel=(1, 1), stride=(1, 1), padding=(0, 0),
           generator: torch.Generator | None = None) -> nn.Conv2d:
    """``nn.Conv2d`` with flax ``nn.Conv``'s default init (lecun normal, zero bias)."""
    conv = nn.Conv2d(cin, cout, kernel, stride, padding)
    lecun_normal_(conv.weight, generator)
    nn.init.zeros_(conv.bias)
    return conv


def data_norm(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """The input BatchNorm over (V·C) features, feature index v·C + c (the
    JAX model normalises the last axis of (N, T, V·C), torch's BatchNorm1d
    axis 1 of (N, V·C, T)): x (N, T, V, C) → (N, C, T, V).
    ≡ `STGCN.py:214,256-259`."""
    n, t, v, c = x.shape
    x = bn(x.reshape(n, t, v * c).transpose(1, 2)).transpose(1, 2)
    return x.reshape(n, t, v, c).permute(0, 3, 1, 2)


class GraphConv(nn.Module):
    """Pointwise conv to K·C' channels + partition einsum.
    ≡ `STGCN.py:8-69` (t_kernel_size=1)."""

    def __init__(self, cin: int, cout: int, num_partitions: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cout, self.k = cout, num_partitions
        self.conv = conv2d(cin, cout * num_partitions, generator=generator)

    def forward(self, x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        n, _, t, v = x.shape
        x = self.conv(x).view(n, self.k, self.cout, t, v)
        return torch.einsum("nkctv,kvw->nctw", x, a)


class STGCNBlock(nn.Module):
    """graph conv → BN/ReLU/temporal conv/BN/dropout + residual.
    ≡ `STGCN.py:72-143`; ``tcn`` holds the reference's Sequential indices
    (0 BN, 1 ReLU, 2 conv, 3 BN)."""

    def __init__(self, cin: int, cout: int, num_partitions: int, temporal_kernel: int = 9,
                 stride: int = 1, dropout_rate: float = 0.0, residual: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.gcn = GraphConv(cin, cout, num_partitions, generator)
        pad = temporal_kernel // 2
        self.tcn = nn.ModuleList([
            nn.BatchNorm2d(cout), nn.ReLU(),
            conv2d(cout, cout, (temporal_kernel, 1), (stride, 1), (pad, 0), generator),
            nn.BatchNorm2d(cout)])
        self.residual_kind = ("none" if not residual
                              else "identity" if cin == cout and stride == 1 else "conv")
        if self.residual_kind == "conv":
            self.residual = nn.Sequential(conv2d(cin, cout, stride=(stride, 1),
                                                 generator=generator), nn.BatchNorm2d(cout))

    def forward(self, x: torch.Tensor, a: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        res = {"none": lambda: 0.0, "identity": lambda: x,
               "conv": lambda: self.residual(x)}[self.residual_kind]()
        y = self.gcn(x, a)
        bn1, relu, conv, bn2 = self.tcn
        y = bn2(conv(relu(bn1(y))))
        y = dropout(y, self.dropout_rate, self.training, generator)
        return torch.relu(y + res)


class _Head(nn.Module):
    """``head.classifier``, the reference's key."""

    def __init__(self, din: int, num_classes: int, generator: torch.Generator | None = None):
        super().__init__()
        self.classifier = nn.Linear(din, num_classes)
        with torch.no_grad():
            self.classifier.weight.normal_(0.0, math.sqrt(2.0 / num_classes),
                                           generator=generator)
            self.classifier.bias.zero_()


class STGCN(Splittable):
    """10-block ST-GCN classifier: (B, T, V=29, C) → logits (B, num_classes).
    Defaults ≡ ``STGCNParams`` (`model_params.py:490-538`)."""

    def __init__(self, in_channels: int = 2, num_nodes: int = 29, center: int = 0,
                 edges: tuple = BODY29_EDGES, edge_importance_weighting: bool = True,
                 n_out_features: int = 256, num_classes: int = 1000,
                 dropout_ratio: float = 0.05, generator: torch.Generator | None = None):
        super().__init__()
        a = GraphPartition(num_nodes, center, list(edges)).A.astype(np.float32)
        self.register_buffer("A", torch.from_numpy(a), persistent=False)
        self.dropout_ratio = dropout_ratio
        self.data_bn = nn.BatchNorm1d(in_channels * num_nodes)
        schedule = list(SCHEDULE[:-1]) + [(n_out_features, 1)]
        blocks, cin = [], in_channels
        for idx, (cout, stride) in enumerate(schedule):
            blocks.append(STGCNBlock(cin, cout, a.shape[0], stride=stride,
                                     residual=idx != 0, generator=generator))
            cin = cout
        self.st_gcn_networks = nn.ModuleList(blocks)
        self.edge_importance = (
            nn.ParameterList([nn.Parameter(torch.ones(a.shape)) for _ in blocks])
            if edge_importance_weighting else None)
        self.head = _Head(n_out_features, num_classes, generator)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        x = data_norm(self.data_bn, x.to(self.data_bn.weight.dtype))
        for idx, block in enumerate(self.st_gcn_networks):
            a = self.A if self.edge_importance is None else self.A * self.edge_importance[idx]
            x = block(x, a, generator)
        x = x.mean(dim=(2, 3))  # global average over (T, V)
        x = dropout(x, self.dropout_ratio, self.training, generator)
        return self.head.classifier(x)


def stgcn_from_dataset(dataset_params: dict, input_dim: int, **overrides) -> STGCN:
    """≡ the JAX package's ``stgcn_from_dataset`` (`models/stgcn.py:134-148`)."""
    kw = dict(
        in_channels=input_dim,
        num_nodes=29,
        center=0,
        edges=BODY29_EDGES,
        edge_importance_weighting=True,
        n_out_features=256,
        num_classes=dataset_params["num_class"],
        dropout_ratio=0.05,
    )
    kw.update(overrides)
    return STGCN(**kw)
