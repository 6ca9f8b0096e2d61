"""HGATE — hierarchical graph attention without spatial windows.

PyTorch counterpart of ``sl_hwgat_tpu/models/hgate.py`` (reference
`hwgat/models/HGATE.py:8-346`): HWGATE's 3-stage hierarchy, but each
attention unit holds the whole 29-joint skeleton over a temporal patch
(TP·K = 58 tokens), masked multiplicatively by the blocked whole-body
adjacency (``hgate_block_adj``). No train-time pruning.

- Every block's MSA is HWGATE's ``WindowedMSA`` with one "window" per frame:
  58-token units × head dim (64 at every stage of the defaults), which the
  JAX kernel pads to 64 and stacks two to a supertile. ``attn_impl`` "auto",
  "pallas" or "stacked" runs ``window_attention`` (the fused CUDA kernels,
  at 58 tokens), "hybrid" the batched GEMMs around the masked-softmax
  kernels; ``attn_dtype="bfloat16"`` runs the attention in bf16 under f32
  projections, as HWGATE's does.
- Shifted blocks roll the frames by -TP/2 and back; the last temporal group
  of every clip attends under ``adj ∧ shift_tail_mask``.
- Dtypes are the JAX model's: HGATE has no ``stream_dtype``, so under bf16
  compute the projections, attention and FFN run in bf16 while LayerNorm and
  the residual stream stay f32 (an f32 shortcut plus a bf16 branch promotes).
- ``remat`` recomputes each block in the backward pass
  (``models.common.remat``, which replays the block's generator).

The state_dict uses the reference's key layout, as HWGATE's (``B``,
``pos_encoder.pe``, ``layers.{i}.blocks.{j}.{norm1,attn.qkv,attn.proj,norm2,
ff.fc1,ff.fc2}``, ``norm``, ``head``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from sl_hwgat_tpu_torch.graphs.adjacency import hgate_block_adj
from sl_hwgat_tpu_torch.models.common import (
    DTYPES,
    LN_EPS,
    Dense,
    FeedForward,
    PositionalEncoding,
    Splittable,
    fourier_embed,
    fourier_matrix,
    layer_norm,
    remat,
)
from sl_hwgat_tpu_torch.models.hwgate import WindowedMSA, shift_tail_mask
from sl_hwgat_tpu_torch.ops.window import block_partition, block_reverse, temporal_merge


class GraphAttentionBlock(nn.Module):
    """LN → whole-skeleton masked MSA (with the temporal roll in shifted
    blocks) → residual → LN → FFN → residual. ≡ `HGATE.py:128-212`."""

    def __init__(self, dim: int, num_heads: int, num_kps: int, temporal_patch: int,
                 shift_size: int, adj: np.ndarray, *, drop: float = 0.0, ff_ratio: float = 2.0,
                 attn_impl: str = "auto", attn_dtype: str = "float32",
                 compute_dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.temporal_patch = temporal_patch
        self.shift_size = shift_size
        tail_adj = None
        if shift_size > 0:
            tail_adj = adj * shift_tail_mask(num_kps, temporal_patch, shift_size)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowedMSA(dim, num_heads, adj, tail_adj=tail_adj, proj_drop=drop,
                                prune=False, attn_impl=attn_impl, attn_dtype=attn_dtype,
                                compute_dtype=compute_dtype, generator=generator)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ff = FeedForward(dim, int(dim * ff_ratio), drop, compute_dtype, generator)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        _, f_total, k, _ = x.shape
        shortcut = x
        if self.shift_size > 0:
            x = torch.roll(x, -self.shift_size, dims=1)
        xb = block_partition(x, self.temporal_patch)
        xb = self.attn(layer_norm(self.norm1, xb), 1, f_total // self.temporal_patch, generator)
        x = block_reverse(xb, self.temporal_patch, f_total, k)
        if self.shift_size > 0:
            x = torch.roll(x, self.shift_size, dims=1)
        x = shortcut + x
        return x + self.ff(layer_norm(self.norm2, x), generator)


class _Stage(nn.Module):
    def __init__(self, blocks: list[GraphAttentionBlock]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class HGATE(Splittable):
    """Hierarchical whole-skeleton graph-attention classifier:
    (B, F, K=29, kp_dim) → logits (B, num_classes). Defaults ≡ ``HGATEParams``
    (`model_params.py:405-420`). ``compute_dtype``: 'float32' or 'bfloat16'
    (projections, attention and FFN); ``attn_dtype``: 'bfloat16' for bf16
    attention under f32 projections; ``remat``: recompute each block in the
    backward pass. In train mode, dropout masks come from the generator
    passed to ``forward``."""

    def __init__(self, kp_dim: int = 2, num_kps: int = 29, temporal_dim: int = 192,
                 num_classes: int = 2002, embed_dim: int = 128, temporal_patch: int = 2,
                 depths: Sequence[int] = (2, 2, 4), num_heads: Sequence[int] = (2, 4, 8),
                 drop_rate: float = 0.1, ff_ratio: float = 2.0, attn_impl: str = "auto",
                 attn_dtype: str = "float32", compute_dtype: str = "float32",
                 remat: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        cdt = DTYPES[compute_dtype]
        self.remat = remat
        self.temporal_patch = temporal_patch
        adj = hgate_block_adj(num_kps=num_kps, temporal_patch=temporal_patch)

        self.register_buffer("B", fourier_matrix(embed_dim, kp_dim, generator))
        self.pos_encoder = PositionalEncoding(embed_dim, temporal_dim, drop_rate)
        self.layers = nn.ModuleList()
        for i, depth in enumerate(depths):
            dim = int(embed_dim * 2**i)
            self.layers.append(_Stage([
                GraphAttentionBlock(
                    dim, num_heads[i], num_kps, temporal_patch,
                    0 if j % 2 == 0 else temporal_patch // 2, adj,
                    drop=drop_rate, ff_ratio=ff_ratio, attn_impl=attn_impl,
                    attn_dtype=attn_dtype, compute_dtype=cdt, generator=generator)
                for j in range(depth)]))
        last = int(embed_dim * 2 ** (len(depths) - 1))
        self.norm = nn.LayerNorm(last, eps=LN_EPS)
        self.head = Dense(last, num_classes, torch.float32, generator)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.pos_encoder(fourier_embed(x.float(), self.B), generator)
        for i, stage in enumerate(self.layers):
            for block in stage.blocks:
                x = remat(block, x, generator) if self.remat else block(x, generator)
            if i < len(self.layers) - 1:
                x = temporal_merge(x, self.temporal_patch)
        x = layer_norm(self.norm, x)
        return self.head(x.mean(dim=(1, 2)))


def hgate_from_dataset(dataset_params: dict, input_dim: int, **overrides) -> HGATE:
    """≡ the JAX package's ``hgate_from_dataset`` (`models/hgate.py:148-164`)."""
    kw = dict(
        kp_dim=input_dim,
        num_kps=29,
        temporal_dim=dataset_params["src_len"],
        num_classes=dataset_params["num_class"],
        embed_dim=128,
        temporal_patch=2,
        depths=(2, 2, 4),
        num_heads=(2, 4, 8),
        drop_rate=0.1,
        ff_ratio=2.0,
    )
    kw.update(overrides)
    return HGATE(**kw)
