"""Transformer baseline — flattened-keypoint sequence classifier.

PyTorch counterpart of ``sl_hwgat_tpu/models/transformer.py`` (reference
`hwgat/models/Transformer.py:8-177`): input (B, T, V, C) flattened to
(B, T, V·C), projected and scaled by √d, the sinusoid PE, 3 post-norm encoder
layers with torch ``MultiheadAttention``'s packed qkv projection and a
key-padding mask from ``src[:, :, 0] == pad_index``, mean/max/concat pooling
and a linear classifier. Init is xavier-uniform for matrices.

The attention follows the JAX package's arithmetic, not SDPA's: q is scaled
by 1/√dh before the product, the scores and the softmax are float32, the mask
adds ``BIG_NEG``, and A is cast to v's type before A·V, which accumulates in
float32. With ``compute_dtype="bfloat16"`` the projections and the FFN run in
bf16 (float32 parameters), LayerNorm and the residual stream stay float32.
The state_dict carries the reference's keys (``encoder``, ``pos_encoder.pe``
(1, T, D), ``transformer_encoder.layers.{i}.{self_attn.in_proj_weight,
self_attn.in_proj_bias, self_attn.out_proj, linear1, linear2, norm1, norm2}``,
``transformer_encoder.norm``, ``classifier``).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from sl_hwgat_tpu_torch.models.common import (
    DTYPES,
    LN_EPS,
    Splittable,
    dropout,
    sinusoid_table,
    variance_scaling_,
)

BIG_NEG = -1e9


def xavier_linear(din: int, dout: int, compute_dtype: torch.dtype | None = None,
                  generator: torch.Generator | None = None) -> nn.Linear:
    """An ``nn.Linear`` computing in ``compute_dtype`` (None: the parameters'
    type), xavier-uniform weight, zero bias (`Transformer.py:80-85`)."""
    lin = CastLinear(din, dout, compute_dtype)
    variance_scaling_(lin.weight, 1.0, "fan_avg", "uniform", generator)
    nn.init.zeros_(lin.bias)
    return lin


def cast_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                compute_dtype: torch.dtype | None) -> torch.Tensor:
    """``F.linear`` with input, weight and bias cast to ``compute_dtype``
    (flax ``nn.Dense(dtype=...)``; None: the weight's type)."""
    dt = compute_dtype or weight.dtype
    return F.linear(x.to(dt), weight.to(dt), bias.to(dt))


def accumulate_type(t: torch.Tensor) -> torch.Tensor:
    """``t`` in at least float32: bf16 values are exact there, so a product of
    two of them sums in float32 (the JAX model's ``preferred_element_type``)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


class CastLinear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (None: its parameters' type)."""

    def __init__(self, din: int, dout: int, compute_dtype: torch.dtype | None = None):
        super().__init__(din, dout)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return cast_linear(x, self.weight, self.bias, self.compute_dtype)


class TorchMHA(nn.Module):
    """torch ``nn.MultiheadAttention``-compatible self-attention (batch first)."""

    def __init__(self, d_model: int, nhead: int, drop: float = 0.1,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.nhead, self.drop, self.compute_dtype = nhead, drop, compute_dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        variance_scaling_(self.in_proj_weight, 1.0, "fan_avg", "uniform", generator)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = xavier_linear(d_model, d_model, compute_dtype, generator)

    def forward(self, x: torch.Tensor, key_padding_mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        b, t, d = x.shape
        h = self.nhead
        dh = d // h
        qkv = cast_linear(x, self.in_proj_weight, self.in_proj_bias, self.compute_dtype)
        q, k, v = qkv.reshape(b, t, 3, h, dh).permute(2, 0, 3, 1, 4)
        s = torch.matmul(accumulate_type(q / math.sqrt(dh)), accumulate_type(k).transpose(-1, -2))
        if key_padding_mask is not None:
            s = s + torch.where(key_padding_mask, BIG_NEG, 0.0).to(s.dtype)[:, None, None, :]
        a = dropout(torch.softmax(s, dim=-1), self.drop, self.training, generator)
        out = torch.matmul(accumulate_type(a.to(v.dtype)), accumulate_type(v))
        return self.out_proj(out.to(qkv.dtype).transpose(1, 2).reshape(b, t, d))


class EncoderLayer(nn.Module):
    """Post-norm encoder layer. ≡ `Transformer.py:102-144`."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, drop: float = 0.1,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.drop = drop
        self.self_attn = TorchMHA(d_model, nhead, drop, compute_dtype, generator)
        self.linear1 = xavier_linear(d_model, dim_feedforward, compute_dtype, generator)
        self.linear2 = xavier_linear(dim_feedforward, d_model, compute_dtype, generator)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x: torch.Tensor, key_padding_mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        sa = self.self_attn(x, key_padding_mask, generator)
        sa = dropout(sa, self.drop, self.training, generator)
        x = self.norm1(x + sa)  # the stream's type: bf16 sa promotes to it
        hid = dropout(torch.relu(self.linear1(x)), self.drop, self.training, generator)
        hid = dropout(self.linear2(hid), self.drop, self.training, generator)
        return self.norm2(x + hid)


class _PositionalEncoding(nn.Module):
    """``pos_encoder.pe`` (1, max_len, d_model), the reference's buffer."""

    def __init__(self, d_model: int, max_len: int):
        super().__init__()
        self.register_buffer("pe", torch.from_numpy(sinusoid_table(max_len, d_model))[None])


class _Encoder(nn.Module):
    """``transformer_encoder.{layers, norm}``, the reference's keys."""

    def __init__(self, layers: list, d_model: int):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)


class TransformerClassifier(Splittable):
    """(B, T, V, C) → logits (B, num_classes). Defaults ≡ ``TransformerParams``
    (`model_params.py:590-605`)."""

    def __init__(self, input_dim: int = 58, num_classes: int = 1000, pad_index: float = -1.0,
                 d_model: int = 512, nhead: int = 8, dim_feedforward: int = 2048,
                 num_encoder_layers: int = 3, dropout: float = 0.1, max_len: int = 64,
                 pool: str = "mean", compute_dtype: str = "float32",
                 generator: torch.Generator | None = None):
        super().__init__()
        if pool not in ("mean", "max", "concat"):
            raise ValueError(f"unknown pool: {pool}")
        # float32 computes in the parameters' type (float32; float64 in tests)
        cdt = None if compute_dtype == "float32" else DTYPES[compute_dtype]
        self.pad_index, self.d_model, self.pool = pad_index, d_model, pool
        self.drop = dropout  # the JAX package's parameter name
        self.encoder = xavier_linear(input_dim, d_model, None, generator)
        self.pos_encoder = _PositionalEncoding(d_model, max_len)
        self.transformer_encoder = _Encoder(
            [EncoderLayer(d_model, nhead, dim_feedforward, self.drop, cdt, generator)
             for _ in range(num_encoder_layers)], d_model)
        head_in = d_model * max_len if pool == "concat" else d_model
        self.classifier = xavier_linear(head_in, num_classes, None, generator)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        b, t = x.shape[:2]
        x = x.to(self.encoder.weight.dtype).reshape(b, t, -1)
        mask = x[:, :, 0] == self.pad_index  # key padding, `Transformer.py:40-49`
        x = self.encoder(x) * math.sqrt(self.d_model) + self.pos_encoder.pe[:, :t]
        x = dropout(x, self.drop, self.training, generator)
        for layer in self.transformer_encoder.layers:
            x = layer(x, mask, generator)
        x = self.transformer_encoder.norm(x)
        if self.pool == "concat":
            x = x.reshape(b, -1)
        elif self.pool == "max":
            x = x.max(dim=1).values
        else:
            x = x.mean(dim=1)
        return self.classifier(x)


def transformer_from_dataset(dataset_params: dict, input_dim: int,
                             **overrides) -> TransformerClassifier:
    """≡ the JAX package's ``transformer_from_dataset`` (`models/transformer.py:119-133`)."""
    kw = dict(
        input_dim=input_dim * 29,
        num_classes=dataset_params["num_class"],
        pad_index=-1.0,
        d_model=512,
        nhead=8,
        dim_feedforward=2048,
        num_encoder_layers=3,
        dropout=0.1,
        max_len=dataset_params["src_len"],
        pool="mean",
    )
    kw.update(overrides)
    return TransformerClassifier(**kw)
