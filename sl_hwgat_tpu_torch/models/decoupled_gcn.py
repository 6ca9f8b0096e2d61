"""DecoupledGCN baseline — decoupled-group GCN with DropGraph and S/T/C attention.

PyTorch counterpart of ``sl_hwgat_tpu/models/decoupled_gcn.py`` (reference
`hwgat/models/DecoupledGCN.py:10-488`, CVPR21Chal-SLR), in the reference's
(N, C, T, V) layout: the per-channel decoupled aggregation is
``einsum('nkctv,kcvw->nctw')``, BatchNorm is torch's own over axis 1 (the
JAX ``TorchBatchNorm``'s semantics) and ``data_bn`` sees features v·C + c.
Input (B, T, V=29, C).

DropGraph (spatial, then temporal, on the block's output and then on its
skip) is train-only and draws its Bernoulli seeds with ``torch.bernoulli``
from the generator the train step passes in, as dropout does; the JAX
package draws them from a ``dropgraph`` stream of its own, so the two agree
in distribution and, given the same draw, exactly. The temporal dilation is
a stride-1 max pool of ``block_size`` taps over the frames. The state_dict
carries the keys the JAX package's ``decoupled_gcn_from_torch`` reads
(``data_bn``, ``l{1..10}.{gcn1.{decoupled_A, linear_weight, linear_bias,
bn0, bn, down.{0,1}}, conv_sa, conv_ta, fc1c, fc2c, tcn1.{conv,bn},
residual.{conv,bn}}``, ``head.classifier``); the graph buffers are rebuilt.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from sl_hwgat_tpu_torch.graphs.partition import spatial_graph
from sl_hwgat_tpu_torch.graphs.skeleton import BODY29_EDGES
from sl_hwgat_tpu_torch.models.common import Splittable, dropout, variance_scaling_
from sl_hwgat_tpu_torch.models.stgcn import _Head, data_norm


def find_drop_size(num_nodes: int, num_edges: int, k: int = 1) -> float:
    """Expected 1-hop neighbourhood size. ≡ `DecoupledGCN.py:20-26`."""
    s = 0.0
    for i in range(1, k + 1):
        s += (2 * num_edges / num_nodes) * math.pow((2 * num_edges / num_nodes) - 1, i - 1)
    return s


def drop_graph_temporal(x: torch.Tensor, keep_prob: float, block_size: int,
                        generator: torch.Generator | None = None) -> torch.Tensor:
    """Temporal DropGraph on (N, C, T, V). ≡ `DecoupledGCN.py:29-54`."""
    t = x.shape[2]
    ia = x.abs().mean(dim=(1, 3))                                # (N, T)
    ia = ia / ia.sum() * ia.numel()
    gamma = (1.0 - keep_prob) / block_size
    m = torch.bernoulli(torch.clamp(ia * gamma, max=1.0), generator=generator)
    # max over the block_size frames m[t - pad .. t - pad + block_size - 1]
    m = F.max_pool1d(m[:, None], block_size, stride=1, padding=block_size // 2)[:, 0, :t]
    mask = 1.0 - m
    return x * mask[:, None, :, None] * mask.numel() / mask.sum()


def drop_graph_spatial(x: torch.Tensor, keep_prob: float, adj_sum: torch.Tensor,
                       drop_size: float, generator: torch.Generator | None = None
                       ) -> torch.Tensor:
    """Spatial DropGraph on (N, C, T, V). ≡ `DecoupledGCN.py:57-82`."""
    ia = x.abs().mean(dim=(1, 2))                                # (N, V)
    ia = ia / ia.sum() * ia.numel()
    gamma = (1.0 - keep_prob) / (1.0 + drop_size)
    seed = torch.bernoulli(torch.clamp(ia * gamma, max=1.0), generator=generator)
    m = seed @ adj_sum
    m = torch.where(m > 0.001, 1.0, m)
    m = torch.where(m < 0.5, 0.0, m)
    mask = (1.0 - m)[:, None, None, :]                           # (N, 1, 1, V)
    return x * mask * mask.numel() / mask.sum()


def kaiming_conv(cin: int, cout: int, kernel=(1, 1), stride=(1, 1), padding=(0, 0),
                 generator: torch.Generator | None = None) -> nn.Conv2d:
    """``nn.Conv2d`` with the JAX model's ``_KAIMING`` (fan-out normal) init."""
    conv = nn.Conv2d(cin, cout, kernel, stride, padding)
    variance_scaling_(conv.weight, 2.0, "fan_out", "normal", generator)
    nn.init.zeros_(conv.bias)
    return conv


class TCNUnit(nn.Module):
    """Temporal conv + BN (DropGraph applied by the caller). ≡ `DecoupledGCN.py:85-119`."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 9, stride: int = 1,
                 generator: torch.Generator | None = None):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.conv = kaiming_conv(cin, cout, (kernel_size, 1), (stride, 1), (pad, 0), generator)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class DecoupledGCNUnit(nn.Module):
    """Per-channel learned adjacency aggregation. ≡ `DecoupledGCN.py:122-206`."""

    def __init__(self, cin: int, cout: int, groups: int, adj: np.ndarray,
                 generator: torch.Generator | None = None):
        super().__init__()
        s = adj.shape[0]
        self.cout, self.groups, self.num_subset = cout, groups, s
        self.decoupled_A = nn.Parameter(
            torch.from_numpy(np.tile(adj[:, None], (1, groups, 1, 1)).astype(np.float32)))
        self.linear_weight = nn.Parameter(torch.empty(cin, cout * s))
        with torch.no_grad():
            self.linear_weight.normal_(0.0, math.sqrt(0.5 / (cout * s)), generator=generator)
        self.linear_bias = nn.Parameter(torch.full((1, cout * s, 1, 1), 1e-6))
        self.bn0 = nn.BatchNorm2d(cout * s)
        self.bn = nn.BatchNorm2d(cout)
        nn.init.constant_(self.bn.weight, 1e-6)
        if cin != cout:
            self.down = nn.Sequential(kaiming_conv(cin, cout, generator=generator),
                                      nn.BatchNorm2d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, _, t, v = x.shape
        # groups repeated to channels, each subset column-normalised with eps
        # 0.001. ≡ `norm()` `DecoupledGCN.py:175-183`
        learn_adj = self.decoupled_A.repeat_interleave(self.cout // self.groups, dim=1)
        normed = learn_adj * (1.0 / (learn_adj.sum(dim=2, keepdim=True) + 0.001))
        h = torch.einsum("nctv,cd->ndtv", x, self.linear_weight) + self.linear_bias
        h = self.bn0(h).view(n, self.num_subset, self.cout, t, v)
        h = self.bn(torch.einsum("nkctv,kcvw->nctw", h, normed))
        return torch.relu(h + (self.down(x) if hasattr(self, "down") else x))


class DecoupledBlock(nn.Module):
    """GCN unit + spatial/temporal/channel attention + TCN + DropGraph
    residual. ≡ `DecoupledGCN.py:209-323`."""

    def __init__(self, cin: int, cout: int, groups: int, num_points: int, block_size: int,
                 drop_size: float, adj: np.ndarray, stride: int = 1, residual: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.block_size, self.drop_size = block_size, drop_size
        self.register_buffer("adj_sum", torch.from_numpy(adj.sum(axis=0)), persistent=False)
        self.gcn1 = DecoupledGCNUnit(cin, cout, groups, adj, generator)
        ker = num_points - 1 if num_points % 2 == 0 else num_points
        self.conv_sa = nn.Conv1d(cout, 1, ker, padding=(ker - 1) // 2)
        variance_scaling_(self.conv_sa.weight, 1.0, "fan_avg", "truncated_normal", generator)
        nn.init.zeros_(self.conv_sa.bias)
        self.conv_ta = nn.Conv1d(cout, 1, 9, padding=4)
        nn.init.zeros_(self.conv_ta.weight)
        nn.init.zeros_(self.conv_ta.bias)
        self.fc1c = nn.Linear(cout, cout // 2)
        variance_scaling_(self.fc1c.weight, 2.0, "fan_out", "normal", generator)
        nn.init.zeros_(self.fc1c.bias)
        self.fc2c = nn.Linear(cout // 2, cout)
        nn.init.zeros_(self.fc2c.weight)
        nn.init.zeros_(self.fc2c.bias)
        self.tcn1 = TCNUnit(cout, cout, stride=stride, generator=generator)
        self.residual_kind = ("none" if not residual
                              else "identity" if cin == cout and stride == 1 else "conv")
        if self.residual_kind == "conv":
            self.residual = TCNUnit(cin, cout, kernel_size=1, stride=stride, generator=generator)

    def drop(self, y: torch.Tensor, keep_prob: float, generator) -> torch.Tensor:
        y = drop_graph_spatial(y, keep_prob, self.adj_sum, self.drop_size, generator)
        return drop_graph_temporal(y, keep_prob, self.block_size, generator)

    def forward(self, x: torch.Tensor, keep_prob: float,
                generator: torch.Generator | None = None) -> torch.Tensor:
        y = self.gcn1(x)
        # spatial attention: a conv over joints on the time-averaged features
        y = y * torch.sigmoid(self.conv_sa(y.mean(dim=2)))[:, :, None, :] + y
        # temporal attention
        y = y * torch.sigmoid(self.conv_ta(y.mean(dim=3)))[:, :, :, None] + y
        # channel attention
        se = torch.relu(self.fc1c(y.mean(dim=(2, 3))))
        y = y * torch.sigmoid(self.fc2c(se))[:, :, None, None] + y

        y = self.tcn1(y)
        apply_drop = self.training and keep_prob < 1.0
        if apply_drop:
            y = self.drop(y, keep_prob, generator)
        if self.residual_kind == "none":
            return torch.relu(y)
        skip = x if self.residual_kind == "identity" else self.residual(x)
        if apply_drop:
            skip = self.drop(skip, keep_prob, generator)
        return torch.relu(y + skip)


class DecoupledGCN(Splittable):
    """10-block decoupled GCN classifier: (B, T, V=29, C) → logits.
    Defaults ≡ ``DecoupledGCNParams`` (`model_params.py:540-588`)."""

    def __init__(self, in_channels: int = 2, num_points: int = 29, edges: tuple = BODY29_EDGES,
                 groups: int = 8, block_size: int = 41, n_out_features: int = 256,
                 num_classes: int = 1000, dropout_ratio: float = 0.0, keep_prob: float = 0.9,
                 generator: torch.Generator | None = None):
        super().__init__()
        adj = spatial_graph(num_points, [list(e) for e in edges]).astype(np.float32)
        drop_size = find_drop_size(num_points, len(edges))
        self.dropout_ratio = dropout_ratio
        self.data_bn = nn.BatchNorm1d(in_channels * num_points)
        kp = keep_prob
        schedule = [(in_channels, 64, 1, False, 1.0), (64, 64, 1, True, 1.0),
                    (64, 64, 1, True, 1.0), (64, 64, 1, True, 1.0), (64, 128, 2, True, 1.0),
                    (128, 128, 1, True, 1.0), (128, 128, 1, True, kp), (128, 256, 2, True, kp),
                    (256, 256, 1, True, kp), (256, n_out_features, 1, True, kp)]
        self.keep_probs = [s[4] for s in schedule]
        for i, (cin, cout, stride, res, _) in enumerate(schedule):
            self.add_module(f"l{i + 1}", DecoupledBlock(
                cin, cout, groups, num_points, block_size, drop_size, adj, stride, res,
                generator))
        self.head = _Head(n_out_features, num_classes, generator)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        x = data_norm(self.data_bn, x.to(self.data_bn.weight.dtype))
        for i, kp in enumerate(self.keep_probs):
            x = getattr(self, f"l{i + 1}")(x, kp, generator)
        x = dropout(x.mean(dim=(2, 3)), self.dropout_ratio, self.training, generator)
        return self.head.classifier(x)


def decoupled_gcn_from_dataset(dataset_params: dict, input_dim: int,
                               **overrides) -> DecoupledGCN:
    """≡ the JAX package's ``decoupled_gcn_from_dataset``
    (`models/decoupled_gcn.py:264-278`)."""
    kw = dict(
        in_channels=input_dim,
        num_points=29,
        edges=BODY29_EDGES,
        groups=8,
        block_size=41,
        n_out_features=256,
        num_classes=dataset_params["num_class"],
        dropout_ratio=0.0,
    )
    kw.update(overrides)
    return DecoupledGCN(**kw)
