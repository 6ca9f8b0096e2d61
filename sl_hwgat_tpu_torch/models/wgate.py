"""WGATE — windowed graph attention without hierarchy, and its banded MSA.

PyTorch counterpart of ``sl_hwgat_tpu/models/wgate.py`` (reference
`hwgat/models/WGATE.py:8-263`): 8 identical blocks at constant width; each
spatial window of 16 joints attends over all its frames (F·16 tokens) under
the block-tridiagonal mask of the window graph. The reference materializes
the (F·16)² additive mask; here every frame attends only to its ±1-frame
band through ``banded_attention``, the banded CUDA kernels on a card, or,
under ``attn_impl="ell"``, through the edge-space gather/scatter form of the
same topology (``ops/sparse_attention.py``, plain torch as in the JAX
package).

Dtypes are the JAX model's: projections and the FFN run in
``compute_dtype``; the attention output is f32 and is cast to it before
``proj``; LayerNorm is f32, so the residual stream stays f32 (an f32
shortcut plus a bf16 branch promotes).

Inside a sharded step with the frames split over sp ranks
(``parallel/``), ``BandedMSA`` runs on the rank's frames with its
neighbours' boundary frames of k and v attached
(``parallel.edge_partition.call_sharded_banded``), the positional encoding
starts at the rank's first frame and the pool is summed over the sp ranks.

The state_dict uses the reference's flat key layout (``B``,
``pos_encoder.pe``, ``layers.{i}.{norm1,attn.qkv,attn.proj,norm2,ff.fc1,
ff.fc2}``, ``norm``, ``head``), with one fused ``attn.qkv`` whose rows are
[q | k | v].
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from sl_hwgat_tpu_torch.graphs.adjacency import additive_mask, window_adj
from sl_hwgat_tpu_torch.models.common import (
    DTYPES,
    LN_EPS,
    Dense,
    FeedForward,
    PositionalEncoding,
    Splittable,
    dropout,
    encode_positions,
    fourier_embed,
    fourier_matrix,
    frame_mean,
    layer_norm,
)
from sl_hwgat_tpu_torch.ops.banded_attention import banded_attention
from sl_hwgat_tpu_torch.parallel import edge_partition
from sl_hwgat_tpu_torch.ops.sparse_attention import ell_from_band, ell_graph_attention
from sl_hwgat_tpu_torch.ops.window import spatial_window_partition, spatial_window_reverse


# The JAX package's ``attn_impl`` names of the banded models (WGATE, GATE).
# Each of them computes one function, the ±1-frame banded attention, which
# the port runs through ``banded_attention`` (K8/K9 on a card); "ell" runs
# it as the edge-space gather/scatter attention (``ell_graph_attention``).
BANDED_IMPLS = ("auto", "banded", "compact", "pallas_banded", "pallas_packed", "ell")


def check_banded_impl(attn_impl: str) -> str:
    if attn_impl not in BANDED_IMPLS:
        raise ValueError(f"attn_impl={attn_impl!r}: the banded models run {BANDED_IMPLS}")
    return attn_impl


def make_band(spatial_adj: np.ndarray) -> np.ndarray:
    """(3, V, V) additive band [prev | self | next]: the same joint one frame
    away, and the spatial graph within the frame."""
    eye = np.eye(spatial_adj.shape[0], dtype=np.float32)
    return np.stack([additive_mask(eye), additive_mask(spatial_adj), additive_mask(eye)])


class BandedMSA(nn.Module):
    """MSA over (G, F·V, D) tokens with a ±1-frame banded additive mask.
    ≡ `WGATE.py:68-108` / `GATE.py:30-69`. ``attn_impl="ell"`` computes the
    attention on the band's edge list (the spatial plane and ±1-frame
    links, ``ell_from_band``); every other name of ``BANDED_IMPLS`` runs
    ``banded_attention``."""

    def __init__(self, dim: int, num_heads: int, band: np.ndarray, *, proj_drop: float = 0.0,
                 compute_dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_heads = num_heads
        self.band = np.asarray(band, dtype=np.float32)
        self.attn_impl = check_banded_impl(attn_impl)
        self.qkv = Dense(dim, 3 * dim, compute_dtype, generator)
        self.proj = Dense(dim, dim, compute_dtype, generator)
        self.proj_drop = proj_drop

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        g, n, d = x.shape
        h = self.num_heads
        dh = d // h
        qkv = self.qkv(x).reshape(g, n, 3, h, dh).permute(2, 0, 3, 1, 4)
        # planes in (g, h) order, each (F·V, dh) token-major
        q, k, v = (t.reshape(g * h, n, dh).contiguous() for t in qkv)
        if edge_partition.sp_active():
            if self.attn_impl == "ell":
                raise ValueError("attn_impl='ell' has no sp path: the frames split over "
                                 "ranks run the banded kernels")
            out = edge_partition.call_sharded_banded(q, k, v, self.band, scale=dh**-0.5)
        elif self.attn_impl == "ell":
            col, val = ell_from_band(self.band[1], n // self.band.shape[1], device=x.device)
            out = ell_graph_attention(*(t.view(g, h, n, dh) for t in (q, k, v)), col, val,
                                      scale=dh**-0.5)
        else:
            out = banded_attention(q, k, v, self.band, scale=dh**-0.5)
        out = out.reshape(g, h, n, dh).permute(0, 2, 1, 3).reshape(g, n, d)
        out = self.proj(out.to(self.proj.compute_dtype))
        return dropout(out, self.proj_drop, self.training, generator)


class WPartAttentionBlock(nn.Module):
    """LN → banded MSA per spatial window over all frames → residual → LN →
    FFN → residual. ≡ `WGATE.py:128-162`."""

    def __init__(self, dim: int, num_heads: int, window_size: int, band: np.ndarray, *,
                 drop: float = 0.0, ff_ratio: float = 2.0,
                 compute_dtype: torch.dtype = torch.float32, attn_impl: str = "auto",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.window_size = window_size
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = BandedMSA(dim, num_heads, band, proj_drop=drop, compute_dtype=compute_dtype,
                              attn_impl=attn_impl, generator=generator)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ff = FeedForward(dim, int(dim * ff_ratio), drop, compute_dtype, generator)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        _, f, k, _ = x.shape
        xw = spatial_window_partition(x, self.window_size)
        xw = self.attn(layer_norm(self.norm1, xw), generator)
        x = x + spatial_window_reverse(xw, self.window_size, f, k)
        return x + self.ff(layer_norm(self.norm2, x), generator)


class WGATE(Splittable):
    """Windowed (non-hierarchical) graph-attention classifier:
    (B, F, K=64, kp_dim) → logits (B, num_classes). Defaults ≡ ``WGATEParams``
    (`model_params.py:80-96`), with the positional encoding always on. In
    train mode, dropout masks come from the generator passed to
    ``forward``. ``attn_impl``: any of ``BANDED_IMPLS``, one function
    ("ell" through the gather/scatter form, the others through the banded
    kernels)."""

    sp_path = True
    sp_replicated = (r"^head\.",)

    def __init__(self, kp_dim: int = 2, temporal_dim: int = 192, num_classes: int = 2002,
                 embed_dim: int = 128, pe: bool = True, depths: int = 8, num_heads: int = 8,
                 window_size: int = 16,
                 drop_rate: float = 0.1, ff_ratio: float = 2.0, attn_impl: str = "auto",
                 compute_dtype: str = "float32", generator: torch.Generator | None = None):
        super().__init__()
        check_banded_impl(attn_impl)
        cdt = DTYPES[compute_dtype]
        band = make_band(window_adj(window_size=window_size))
        self.register_buffer("B", fourier_matrix(embed_dim, kp_dim, generator))
        self.pos_encoder = PositionalEncoding(embed_dim, temporal_dim, drop_rate) if pe \
            else None
        self.layers = nn.ModuleList([
            WPartAttentionBlock(embed_dim, num_heads, window_size, band, drop=drop_rate,
                                ff_ratio=ff_ratio, compute_dtype=cdt, attn_impl=attn_impl,
                                generator=generator)
            for _ in range(depths)])
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.head = Dense(embed_dim, num_classes, torch.float32, generator)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        x = encode_positions(self.pos_encoder, fourier_embed(x.float(), self.B), generator)
        for block in self.layers:
            x = block(x, generator)
        x = layer_norm(self.norm, x)
        return self.head(frame_mean(x, (1, 2), replicated_grad=True))


def wgate_from_dataset(dataset_params: dict, input_dim: int, **overrides) -> WGATE:
    """≡ the JAX package's ``wgate_from_dataset`` (`models/wgate.py:263-279`)."""
    kw = dict(
        kp_dim=input_dim,
        temporal_dim=dataset_params["src_len"],
        num_classes=dataset_params["num_class"],
        embed_dim=128,
        depths=8,
        num_heads=8,
        window_size=16,
        drop_rate=0.1,
        ff_ratio=2.0,
    )
    kw.update(overrides)
    return WGATE(**kw)
