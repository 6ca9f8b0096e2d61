"""HWGATE — Hierarchical Windowed Graph Attention Transformer Encoder.

PyTorch counterpart of ``sl_hwgat_tpu/models/hwgate.py`` on the token-major
(B, F, K, D) stream (reference `hwgat/models/HWGATE.py:8-360`):

- window partition/reverse and the temporal merge are index maps
  (``ops/window.py``);
- every block's adjacency-masked MSA is one attention call over units of 32
  tokens (2 frames × 16 joints) × head dim ordered (b, f, nW, h):
  ``attn_impl`` "auto", "pallas" or "stacked" (the JAX package's
  bit-compatible jnp form of the same function) runs ``window_attention``
  (the fused CUDA kernels on a card), "hybrid" runs
  ``hybrid_window_attention`` (batched GEMMs around the masked-softmax
  kernels), whose f32 output is cast to the compute dtype before ``proj`` as
  the JAX model does; ``hybrid_scores_dtype="bfloat16"`` stores that path's
  scores in bf16 when the attention runs in bf16 (the JAX package's
  ``PALLAS_HYBRID_S_BF16=1``);
- ``attn_dtype="bfloat16"`` (implied by bf16 compute) casts q, k and v to
  bf16 for the attention, which then stores bf16; the output is cast to the
  compute dtype before ``proj``;
- the residual stream runs in ``stream_dtype`` ("auto" follows
  ``compute_dtype``), cast after each LayerNorm, after each residual add and
  after the FFN, as in the JAX model;
- ``remat`` recomputes each block in the backward pass
  (``models.common.remat``, which replays the block's generator);
- shifted blocks roll the frames by -1 before attention and back after; the
  last temporal group of every clip attends under ``adj ∧ shift_tail_mask``
  (the kernel's dual-mask mode, with ``units_per_group = nW·h`` and
  ``groups = f``);
- train-time pruning (``prune_attn``) draws one uniform scalar per MSA call
  on the device, and dropout its masks, from the generator passed to
  ``forward`` (the train step seeds one per step);
- the zero-score quirk is always on;
- inside a sharded step (``parallel/``) a rank runs its own units: its dp
  rows, its sp frames and, with ``tp`` > 1 (``parallel.sharding.
  shard_model``), its heads of ``attn.qkv``, its columns of ``attn.proj``
  and its FFN shard. The shifted blocks' roll then crosses sp ranks as a
  ring exchange of one frame each way, the dual-mask selector comes from
  the rank's global temporal groups (``parallel.kernel_sharding``), the
  positional encoding starts at the rank's first frame, the pool is summed
  over the sp ranks, and every rank of a call prunes with the step's one
  scalar per MSA call (``prune_scalar``).

The state_dict uses the reference's key layout (``B``, ``pos_encoder.pe``,
``layers.{i}.blocks.{j}.{norm1,attn.qkv,attn.proj,norm2,ff.fc1,ff.fc2}``,
``norm``, ``head``), so a reference ``.pt`` loads as it is.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from sl_hwgat_tpu_torch.graphs.adjacency import windowed_block_adj
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
    remat,
    row_split_linear,
    sequence_layout,
    tp_branch_input,
)
from sl_hwgat_tpu_torch.parallel import kernel_sharding
from sl_hwgat_tpu_torch.parallel.mesh import active
from sl_hwgat_tpu_torch.ops.hybrid_attention import hybrid_window_attention
from sl_hwgat_tpu_torch.ops.window import temporal_merge, window_partition, window_reverse
from sl_hwgat_tpu_torch.ops.window_attention import window_attention

# The JAX package's ``attn_impl`` names that the port runs: the fused kernel
# ("auto" picks it, as on the TPU; "stacked" is the JAX package's jnp form of
# the same function) and the hybrid GEMMs + masked softmax.
ATTN_IMPLS = ("auto", "pallas", "stacked", "hybrid")


def check_attn_impl(attn_impl: str) -> str:
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl={attn_impl!r}: the port runs {ATTN_IMPLS}")
    return attn_impl


def check_scores_dtype(name: str) -> str:
    if name not in DTYPES:
        raise ValueError(f"hybrid_scores_dtype={name!r}: one of {tuple(DTYPES)}")
    return name


def _supertile_stack(tokens: int) -> tuple[int, int | None]:
    """(stack, pad_tokens) so that stack·pad ≈ 128 rows (the JAX kernel's
    supertile; the CUDA kernel works per unit, the plain version stacks)."""
    if tokens >= 128:
        return 1, None
    pad = tokens
    if tokens % 8 != 0:
        pad = ((tokens + 7) // 8) * 8
    stack = max(1, 128 // pad)
    return stack, (pad if pad != tokens else None)


def prune_scalar(module: nn.Module, generator: torch.Generator | None, device) -> torch.Tensor:
    """The prune scalar of one MSA call: drawn from ``generator``, or inside
    a sharded train step the step's scalar for ``module``, the same on every
    rank (each rank's generator draws masks of its own shapes, so their
    states part ways)."""
    layout = active()
    if layout is not None and layout.prune_scalars is not None:
        return layout.prune_scalars[module]
    return torch.rand((1,), generator=generator, device=device)


def roll_frames(x: torch.Tensor, shift: int) -> torch.Tensor:
    """``torch.roll(x, shift, dims=1)`` of the clip's frames; under sp the
    frames that cross a rank boundary come from the neighbouring rank
    (cyclic: the last rank's follow the first rank's)."""
    layout = sequence_layout()
    if layout is None:
        return torch.roll(x, shift, dims=1)
    from sl_hwgat_tpu_torch.parallel.comm import ring_take

    group = layout.group("sp")
    if shift < 0:
        return torch.cat([x[:, -shift:], ring_take(x[:, :-shift], group, 1)], 1)
    return torch.cat([ring_take(x[:, -shift:], group, -1), x[:, :-shift]], 1)


def shift_tail_mask(tokens_per_frame: int, temporal_patch: int, shift: int) -> np.ndarray:
    """Shift mask of the LAST temporal group of a shifted block: the first
    ``(TP-shift)·tokens_per_frame`` tokens are ordinary frames, the rest are
    wrapped frames, and attention across the two is blocked."""
    n = temporal_patch * tokens_per_frame
    split = (temporal_patch - shift) * tokens_per_frame
    m = np.zeros((n, n), dtype=np.float32)
    m[:split, :split] = 1.0
    m[split:, split:] = 1.0
    return m


class WindowedMSA(nn.Module):
    """Multi-head self-attention over token windows under one shared
    multiplicative adjacency mask. ≡ `HWGATE.py:65-118` (prune=True) and
    `HGATE.py:65-108` (prune=False)."""

    def __init__(self, dim: int, num_heads: int, adj: np.ndarray, *,
                 tail_adj: np.ndarray | None = None, proj_drop: float = 0.0,
                 prune: bool = True, attn_impl: str = "auto",
                 attn_dtype: str = "float32", compute_dtype: torch.dtype = torch.float32,
                 hybrid_scores_dtype: str = "float32",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_heads = num_heads
        self.adj = adj
        self.tail_adj = tail_adj
        self.prune = prune
        self.attn_impl = check_attn_impl(attn_impl)
        # the attention's input and store type (`models/hwgate.py:125`)
        bf16 = DTYPES[attn_dtype] == torch.bfloat16 or compute_dtype == torch.bfloat16
        self.attn_dtype = torch.bfloat16 if bf16 else torch.float32
        # the hybrid path's score type (bf16 only under bf16 attention)
        self.scores_dtype = DTYPES[check_scores_dtype(hybrid_scores_dtype)]
        # One fused (d, 3d) projection with output rows [q | k | v], as the
        # reference stores it.
        self.qkv = Dense(dim, 3 * dim, compute_dtype, generator)
        self.proj = Dense(dim, dim, compute_dtype, generator)
        self.proj_drop = proj_drop
        self.tp = 1  # head shards (``parallel.sharding.shard_model``)

    def forward(self, x: torch.Tensor, windows_per_frame: int, temporal_groups: int,
                generator: torch.Generator | None = None):
        g, n, d = x.shape
        h = self.num_heads // self.tp
        dh = d // self.num_heads
        cdt = self.proj.compute_dtype
        qkv = self.qkv(tp_branch_input(x, self.tp)).reshape(g, n, 3, h, dh)
        qkv = qkv.permute(2, 0, 3, 1, 4)
        # units in (b, f, nW, h) order, each (n, dh), in the attention's type
        adt = self.attn_dtype
        q, k, v = (t.reshape(g * h, n, dh).to(adt).contiguous() for t in qkv)

        # train-time pruning: one uniform scalar per call, drawn on the device
        prune_u = None
        if self.prune and self.training:
            prune_u = prune_scalar(self, generator, x.device)
        stack, pad = _supertile_stack(n)
        tail_kw = {}
        if self.tail_adj is not None:
            per_group = windows_per_frame * h
            if per_group % stack:
                # An odd head count (HGATE): a supertile would straddle two
                # temporal groups. One unit per supertile gives the function
                # of the JAX model's split by group, since units never mix.
                stack = 1
            # under sp, the selector of the rank's global temporal groups
            sel = kernel_sharding.rank_sel(q.shape[0] // stack, stack, per_group,
                                           temporal_groups, q.device)
            tail_kw = dict(tail_adj=self.tail_adj, units_per_group=per_group,
                           groups=temporal_groups, sel=sel)
        kw = dict(scale=dh**-0.5, stack=stack, pad_tokens=pad, prune_u=prune_u, **tail_kw)
        if self.attn_impl == "hybrid":
            out = hybrid_window_attention(q, k, v, self.adj, scores_dtype=self.scores_dtype,
                                          **kw)
        else:
            out = window_attention(q, k, v, self.adj, out_dtype=adt, **kw)
        out = out.to(cdt).reshape(g, h, n, dh).permute(0, 2, 1, 3).reshape(g, n, h * dh)
        if self.tp > 1:
            out = row_split_linear(out, self.proj.weight, self.proj.bias, active().group("tp"),
                                   cdt)
        else:
            out = self.proj(out)
        return dropout(out, self.proj_drop, self.training, generator)


class WindowedHierarchy(Splittable):
    """A hierarchy of ``WindowedMSA`` stages joined by temporal merges
    (HWGATE, HGATE): split over dp, sp and tp; the head after the sp pool is
    replicated. ``check_split`` also asks for heads that divide by tp at
    every stage, and a rank's frames by the temporal patch at every
    merge."""

    sp_path = tp_path = True
    sp_replicated = (r"^head\.",)

    def check_split(self, sp: int, tp: int, frames: int | None = None) -> None:
        super().check_split(sp, tp, frames)
        for stage in self.layers:
            for block in stage.blocks:
                if block.attn.num_heads % tp:
                    raise ValueError(f"{block.attn.num_heads} heads do not split over tp {tp}")
        need = self.temporal_patch ** len(self.layers)
        if frames is not None and sp > 1 and (frames // sp) % need:
            raise ValueError(f"{frames // sp} frames a rank do not divide by the temporal "
                             f"patch at every stage ({need})")


class PartAttentionBlock(nn.Module):
    """LN → windowed MSA (with the temporal roll in shifted blocks) →
    residual → LN → FFN → residual. ≡ `HWGATE.py:138-221`."""

    def __init__(self, dim: int, num_heads: int, window_size: int, temporal_patch: int,
                 shift_size: int, adj: np.ndarray, *, drop: float = 0.0,
                 ff_ratio: float = 2.0, prune: bool = True, attn_impl: str = "auto",
                 attn_dtype: str = "float32", compute_dtype: torch.dtype = torch.float32,
                 stream_dtype: torch.dtype = torch.float32, hybrid_scores_dtype: str = "float32",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.window_size = window_size
        self.temporal_patch = temporal_patch
        self.shift_size = shift_size
        self.stream_dtype = stream_dtype
        tail_adj = None
        if shift_size > 0:
            tail_adj = adj * shift_tail_mask(window_size, temporal_patch, shift_size)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowedMSA(dim, num_heads, adj, tail_adj=tail_adj, proj_drop=drop,
                                prune=prune, attn_impl=attn_impl, attn_dtype=attn_dtype,
                                compute_dtype=compute_dtype,
                                hybrid_scores_dtype=hybrid_scores_dtype, generator=generator)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ff = FeedForward(dim, int(dim * ff_ratio), drop, compute_dtype, generator)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        # the residual stream is in the stream dtype: LayerNorm returns f32,
        # which is cast to it, and so are the attention's and the FFN's
        # outputs (computed in the compute dtype) before each residual add
        sdt = self.stream_dtype
        _, f_total, k, _ = x.shape
        shortcut = x
        if self.shift_size > 0:
            x = roll_frames(x, -self.shift_size)
        xw = window_partition(x, self.window_size, self.temporal_patch)
        xw = self.attn(layer_norm(self.norm1, xw).to(sdt), k // self.window_size,
                       f_total // self.temporal_patch, generator)
        x = window_reverse(xw, self.window_size, self.temporal_patch, f_total, k)
        if self.shift_size > 0:
            x = roll_frames(x, self.shift_size)
        x = shortcut + x.to(sdt)
        return x + self.ff(layer_norm(self.norm2, x).to(sdt), generator).to(sdt)


class _Stage(nn.Module):
    def __init__(self, blocks: list[PartAttentionBlock]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class HWGATE(WindowedHierarchy):
    """Hierarchical windowed graph-attention classifier:
    (B, F, K=64, kp_dim) → logits (B, num_classes).

    ``compute_dtype``: 'float32', or 'bfloat16' to run every projection, the
    FFN and the attention kernel in bf16 (parameters, LayerNorm statistics,
    the pooling and the head stay f32). ``stream_dtype``: the residual
    stream's type, 'auto' (the compute dtype), 'float32' or 'bfloat16'.
    ``attn_dtype``: 'bfloat16' runs the attention in bf16 under f32
    projections. ``prune_attn``: train-time attention pruning; ``attn_impl``
    ("auto", "pallas", "stacked" or "hybrid"); ``remat``: recompute each
    block in the backward pass; ``pe=False`` leaves out the positional
    encoding (and its dropout). All are the JAX model's options of the same
    names. ``hybrid_scores_dtype``: 'bfloat16' stores the hybrid path's
    scores in bf16 under bf16 attention, what the JAX package's
    ``PALLAS_HYBRID_S_BF16=1`` does; no effect on the fused path.
    """

    def __init__(self, kp_dim: int = 2, temporal_dim: int = 192,
                 num_classes: int = 2002, embed_dim: int = 128, pe: bool = True,
                 temporal_patch: int = 2,
                 depths: Sequence[int] = (2, 2, 4), num_heads: Sequence[int] = (2, 4, 8),
                 window_size: int = 16, drop_rate: float = 0.1, ff_ratio: float = 2.0,
                 prune_attn: bool = True, attn_impl: str = "auto",
                 attn_dtype: str = "float32", compute_dtype: str = "float32",
                 stream_dtype: str = "auto", remat: bool = False,
                 hybrid_scores_dtype: str = "float32",
                 generator: torch.Generator | None = None):
        super().__init__()
        cdt = DTYPES[compute_dtype]
        self.stream_dtype = cdt if stream_dtype == "auto" else DTYPES[stream_dtype]
        self.remat = remat
        self.temporal_patch = temporal_patch
        # One (TP·W, TP·W) mask serves every (window, head) unit: the four
        # windows share one topology (`model_params.py:261-369`).
        adj = windowed_block_adj(temporal_patch, window_size, 1)[0]

        self.register_buffer("B", fourier_matrix(embed_dim, kp_dim, generator))
        self.pos_encoder = PositionalEncoding(embed_dim, temporal_dim, drop_rate) if pe \
            else None
        self.layers = nn.ModuleList()
        for i, depth in enumerate(depths):
            dim = int(embed_dim * 2**i)
            self.layers.append(_Stage([
                PartAttentionBlock(
                    dim, num_heads[i], window_size, temporal_patch,
                    0 if j % 2 == 0 else temporal_patch // 2, adj,
                    drop=drop_rate, ff_ratio=ff_ratio, prune=prune_attn,
                    attn_impl=attn_impl, attn_dtype=attn_dtype, compute_dtype=cdt,
                    stream_dtype=self.stream_dtype, hybrid_scores_dtype=hybrid_scores_dtype,
                    generator=generator)
                for j in range(depth)]))
        last = int(embed_dim * 2 ** (len(depths) - 1))
        self.norm = nn.LayerNorm(last, eps=LN_EPS)
        self.head = Dense(last, num_classes, torch.float32, generator)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits of a (B, F, K, kp_dim) batch. In train mode, the prune
        scalars and dropout masks come from ``generator`` (on x's device;
        None = torch's default generator)."""
        x = encode_positions(self.pos_encoder, fourier_embed(x.float(), self.B), generator)
        x = x.to(self.stream_dtype)
        for i, stage in enumerate(self.layers):
            for block in stage.blocks:
                x = remat(block, x, generator) if self.remat else block(x, generator)
            if i < len(self.layers) - 1:
                x = temporal_merge(x, self.temporal_patch)
        x = layer_norm(self.norm, x)
        # AvgPool1d over f·K tokens, `HWGATE.py:328,354`
        x = frame_mean(x, (1, 2), replicated_grad=True)
        return self.head(x)


def hwgate_from_dataset(dataset_params: dict, input_dim: int, **overrides) -> HWGATE:
    """≡ ``HWGATEParams`` defaults (`model_params.py:243-259`)."""
    kw = dict(
        kp_dim=input_dim,
        temporal_dim=dataset_params["src_len"],
        num_classes=dataset_params["num_class"],
        embed_dim=128,
        temporal_patch=2,
        depths=(2, 2, 4),
        num_heads=(2, 4, 8),
        window_size=16,
        drop_rate=0.1,
        ff_ratio=2.0,
    )
    kw.update(overrides)
    return HWGATE(**kw)
