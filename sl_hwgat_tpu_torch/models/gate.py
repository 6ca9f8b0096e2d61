"""GATE — plain graph attention over the full F·K token sequence.

PyTorch counterpart of ``sl_hwgat_tpu/models/gate.py`` (reference
`hwgat/models/GATE.py:8-216`): 8 blocks at constant width attending over
all F·29 tokens under the spatio-temporal adjacency of the 29-joint body
graph (no self loops, so the diagonal is masked), through the ±1-frame band
(``banded_attention``, the banded CUDA kernels on a card; or its edge list
under ``attn_impl="ell"``), then a learned
weighted average over tokens (``weightedAvg``: Linear(F·K → 1)). Dtypes and
the state_dict layout are WGATE's (``models/wgate.py``), plus
``weightedAvg.{weight,bias}``. Under sp (``parallel/``) the banded MSA and
the positional encoding run as WGATE's do, and ``weightedAvg`` takes the
columns of the rank's tokens, sums the partial averages over the sp ranks
and adds its bias once.
"""

from __future__ import annotations

import torch
from torch import nn

from sl_hwgat_tpu_torch.graphs.skeleton import BODY29_EDGES, edges_to_dense
from sl_hwgat_tpu_torch.models.common import (
    DTYPES,
    LN_EPS,
    Dense,
    FeedForward,
    PositionalEncoding,
    Splittable,
    encode_positions,
    fourier_embed,
    fourier_matrix,
    layer_norm,
    row_split_linear,
    sequence_layout,
)
from sl_hwgat_tpu_torch.models.wgate import BandedMSA, check_banded_impl, make_band


class GAttentionBlock(nn.Module):
    """Pre-norm banded MSA + FFN over flat tokens. ≡ `GATE.py:89-116`."""

    def __init__(self, dim: int, num_heads: int, band, *, drop: float = 0.0,
                 ff_ratio: float = 2.0, compute_dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto", generator: torch.Generator | None = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = BandedMSA(dim, num_heads, band, proj_drop=drop, compute_dtype=compute_dtype,
                              attn_impl=attn_impl, generator=generator)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ff = FeedForward(dim, int(dim * ff_ratio), drop, compute_dtype, generator)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        x = x + self.attn(layer_norm(self.norm1, x), generator)
        return x + self.ff(layer_norm(self.norm2, x), generator)


class GATE(Splittable):
    """Flat spatio-temporal graph-attention classifier:
    (B, F, K=29, kp_dim) → logits (B, num_classes). Defaults ≡ ``GATEParams``
    (`model_params.py:5-19`), with the positional encoding always on.
    ``attn_impl``: any of ``models.wgate.BANDED_IMPLS``, one function."""

    sp_path = True
    sp_replicated = (r"^head\.", r"^weightedAvg\.bias$")

    def __init__(self, kp_dim: int = 2, num_kps: int = 29, temporal_dim: int = 192,
                 num_classes: int = 2002, embed_dim: int = 128, pe: bool = True, depths: int = 8,
                 num_heads: int = 8, drop_rate: float = 0.1, ff_ratio: float = 2.0,
                 attn_impl: str = "auto", compute_dtype: str = "float32",
                 generator: torch.Generator | None = None):
        super().__init__()
        check_banded_impl(attn_impl)
        cdt = DTYPES[compute_dtype]
        band = make_band(edges_to_dense(BODY29_EDGES, num_kps, self_loops=False))
        self.register_buffer("B", fourier_matrix(embed_dim, kp_dim, generator))
        self.pos_encoder = PositionalEncoding(embed_dim, temporal_dim, drop_rate) if pe \
            else None
        self.layers = nn.ModuleList([
            GAttentionBlock(embed_dim, num_heads, band, drop=drop_rate, ff_ratio=ff_ratio,
                            compute_dtype=cdt, attn_impl=attn_impl, generator=generator)
            for _ in range(depths)])
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.weightedAvg = Dense(temporal_dim * num_kps, 1, torch.float32, generator)
        self.head = Dense(embed_dim, num_classes, torch.float32, generator)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        x = encode_positions(self.pos_encoder, fourier_embed(x.float(), self.B), generator)
        b, f, k, d = x.shape
        x = x.reshape(b, f * k, d)
        for block in self.layers:
            x = block(x, generator)
        x = layer_norm(self.norm, x)
        # learned weighted average over tokens, `GATE.py:210`
        layout = sequence_layout()
        if layout is None:
            x = self.weightedAvg(x.transpose(1, 2))[..., 0]
        else:  # the columns of the rank's tokens, summed over the sp ranks
            avg, lo = self.weightedAvg, layout.rank("sp") * f * k
            x = row_split_linear(x.transpose(1, 2), avg.weight[:, lo:lo + f * k], avg.bias,
                                 layout.group("sp"), avg.compute_dtype)[..., 0]
        return self.head(x)


def gate_from_dataset(dataset_params: dict, input_dim: int, **overrides) -> GATE:
    """≡ the JAX package's ``gate_from_dataset`` (`models/gate.py:121-136`)."""
    kw = dict(
        kp_dim=input_dim,
        num_kps=29,
        temporal_dim=dataset_params["src_len"],
        num_classes=dataset_params["num_class"],
        embed_dim=128,
        depths=8,
        num_heads=8,
        drop_rate=0.1,
        ff_ratio=2.0,
    )
    kw.update(overrides)
    return GATE(**kw)
