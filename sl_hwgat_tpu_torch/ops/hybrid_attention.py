"""Hybrid window attention: batched GEMMs around the masked-softmax kernels.

Counterpart of ``sl_hwgat_tpu/ops/hybrid_attention.py`` (HWGATE's and
HGATE's ``attn_impl="hybrid"``): the same function as ``window_attention``,
computed as

    S = (q·T(scale))·kᵀ     f32 sums, stored in f32 (or bf16, below)
    P = masked_softmax(S)   stored in v's type
    O = P·V                 f32 sums, f32 out

with the scores making one round trip through device memory. The products
of bf16 operands on a card run on those operands (``aten::bmm.dtype``:
products exact in f32, f32 sums), as the JAX einsums with
``preferred_element_type=f32`` do; f32 operands, and every operand on the
CPU (where torch has no kernel for that overload), run ``torch.bmm`` on f32
(no TF32). ``scores_dtype=torch.bfloat16`` with bf16 values stores S in
bf16, the JAX package's ``PALLAS_HYBRID_S_BF16=1`` path: K7 reads the bf16
scores, upcasts each to f32, and its backward writes dS in bf16.

``masked_softmax`` is a ``torch.autograd.Function`` on CUDA tensors: its
forward launches ``csrc/masked_softmax_fwd.cu`` and its backward
``csrc/masked_softmax_bwd.cu``, on the current stream, or raises. On CPU
tensors it runs the plain version (``ops/attention.py::unit_masked_softmax``),
which torch differentiates. There is no fallback from one to the other. The
two GEMMs are library calls, as the JAX package leaves them to XLA; torch
differentiates them (the bf16 overload, which has no derivative in torch,
through ``_Bf16Product``).

The work is per unit: (U, N, N) scores, not the JAX supertiles'
(T, S·Np, S·Np). There, cross-unit and padded entries are −2e4, so after
the f32 softmax they are exactly 0 (`sl_hwgat_tpu/ops/pallas_attention.py:
788-799`) and the supertile holds the per-unit blocks on its diagonal. Pad
tokens (HGATE's 58 → 64) are dropped: they carry no weight and take no part
in either softmax, so a fully masked row still spreads uniformly over its
unit's real tokens.

``masked_softmax.launches`` and ``masked_softmax_bwd.launches`` count the two
kernels' launches (plain integers that a run may reset).

While ``torch.compiler.is_compiling()`` (``torch.export`` tracing an eval
forward), ``masked_softmax`` calls the custom op of ``ops/library.py``
instead, whose CUDA implementation is the same launch (``launch``).

``softmax_blocks`` is the kernel bench's ``softmax_only`` function in one
launch of ``csrc/softmax_probe.cu`` (K7's row routine on the two unit blocks
of each tile that reach the output, zeros elsewhere; counted by
``softmax_blocks.launches``).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from sl_hwgat_tpu_torch.ops import _build
from sl_hwgat_tpu_torch.ops.attention import unit_masked_softmax, unit_masked_softmax_bwd
from sl_hwgat_tpu_torch.ops.window_attention import (
    check_masks,
    device_args,
    device_masks,
    mask_mode,
    plain_sel,
    ptr,
)

KERNEL = "masked_softmax_fwd"
KERNEL_BWD = "masked_softmax_bwd"
KERNEL_BLOCKS = "softmax_probe"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_TOKENS = 64
_LOCK = threading.Lock()

_ARGTYPES = {
    # s, p, masks, sel, prune_u, units, n, s_dtype, p_dtype, zero_quirk,
    # dual, stack, per_group, groups, unit_offset, stream
    KERNEL: ["p"] * 5 + ["ll"] + ["i"] * 8 + ["ll", "p"],
    # s, dp, ds, masks, sel, prune_u, units, n, s_dtype, dp_dtype,
    # zero_quirk, dual, stack, per_group, groups, unit_offset, stream
    KERNEL_BWD: ["p"] * 6 + ["ll"] + ["i"] * 8 + ["ll", "p"],
    # x, out, masks, tiles, sn, dh, stream
    KERNEL_BLOCKS: ["p"] * 3 + ["ll", "i", "i", "p"],
}
_BLOCK_N = 32  # the unit blocks of softmax_blocks


def _check_scores(s):
    if s.dtype not in _DTYPE_CODE or s.ndim != 3 or s.shape[1] != s.shape[2]:
        raise ValueError(f"scores must be (U, N, N) float32/bfloat16, got {tuple(s.shape)} "
                         f"{s.dtype}")
    if not 1 <= s.shape[1] <= _MAX_TOKENS:
        raise ValueError(f"the masked-softmax kernels take at most {_MAX_TOKENS} tokens, "
                         f"got {s.shape[1]}")


def _kernel(s, adj, *, stack, zero_quirk, prune_u, tail_adj, units_per_group, groups,
            unit_offset, sel, p_dtype):
    _check_scores(s)
    s = s.contiguous()
    prune_u, sel = device_args(s, stack, prune_u, sel)
    return launch(s, device_masks(adj, tail_adj, s.device, wide=True), sel, prune_u,
                  zero_quirk=zero_quirk,
                  mode=mask_mode(tail_adj, stack, units_per_group, groups, unit_offset),
                  p_dtype=p_dtype)


def launch(s, masks, sel, prune_u, *, zero_quirk, mode, p_dtype):
    """One launch of the forward kernel on checked, contiguous scores:
    ``masks`` from ``device_masks(..., wide=True)``, ``sel`` and ``prune_u``
    from ``device_args``, ``mode`` from ``mask_mode``. Returns P."""
    if p_dtype not in _DTYPE_CODE:
        raise TypeError(f"the masked-softmax kernel stores float32/bfloat16, got {p_dtype}")
    u, n, _ = s.shape
    p = torch.empty(s.shape, dtype=p_dtype, device=s.device)
    with torch.cuda.device(s.device):
        err = _build.function(KERNEL, _ARGTYPES[KERNEL])(
            s.data_ptr(), p.data_ptr(), masks.data_ptr(), ptr(sel), ptr(prune_u), u, n,
            _DTYPE_CODE[s.dtype], _DTYPE_CODE[p_dtype], int(zero_quirk), *mode,
            torch.cuda.current_stream(s.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: cudaError {err}")
    with _LOCK:
        masked_softmax.launches += 1
    return p


def _kernel_bwd(s, dp, adj, *, stack, zero_quirk, prune_u, tail_adj, units_per_group, groups,
                unit_offset, sel):
    _check_scores(s)
    if dp.shape != s.shape or dp.dtype not in _DTYPE_CODE:
        raise ValueError(f"dp must be {tuple(s.shape)} float32/bfloat16, got "
                         f"{tuple(dp.shape)} {dp.dtype}")
    s, dp = s.contiguous(), dp.contiguous()
    prune_u, sel = device_args(s, stack, prune_u, sel)
    u, n, _ = s.shape
    ds = torch.empty_like(s)
    with torch.cuda.device(s.device):
        err = _build.function(KERNEL_BWD, _ARGTYPES[KERNEL_BWD])(
            s.data_ptr(), dp.data_ptr(), ds.data_ptr(),
            device_masks(adj, tail_adj, s.device, wide=True).data_ptr(), ptr(sel),
            ptr(prune_u), u, n, _DTYPE_CODE[s.dtype], _DTYPE_CODE[dp.dtype], int(zero_quirk),
            *mask_mode(tail_adj, stack, units_per_group, groups, unit_offset),
            torch.cuda.current_stream(s.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL_BWD} launch failed: cudaError {err}")
    with _LOCK:
        masked_softmax_bwd.launches += 1
    return ds


class _MaskedSoftmax(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient. The
    scores get a gradient in their type; ``prune_u`` and ``sel`` get none."""

    @staticmethod
    def forward(ctx, s, prune_u, sel, adj, kw):
        p = _kernel(s, adj, prune_u=prune_u, sel=sel, **kw)
        ctx.save_for_backward(s, prune_u, sel)
        ctx.adj = adj
        ctx.kw = {name: val for name, val in kw.items() if name != "p_dtype"}
        return p

    @staticmethod
    def backward(ctx, dp):
        s, prune_u, sel = ctx.saved_tensors
        return _kernel_bwd(s, dp, ctx.adj, prune_u=prune_u, sel=sel, **ctx.kw), None, None, \
            None, None


def masked_softmax(s, adj, *, stack: int = 4, zero_quirk: bool = True, prune_u=None,
                   tail_adj=None, units_per_group: int | None = None, groups: int | None = None,
                   unit_offset: int = 0, sel=None,
                   p_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """P of the (U, N, N) float32 or bfloat16 scores ``s`` (N ≤ 64; bf16
    upcast to f32 before any mask, prune or softmax) under the masking
    rules of the window attention, stored as ``p_dtype``. The mask arguments
    are ``window_attention``'s: ``adj`` (and the shifted blocks' ``tail_adj``
    with ``units_per_group``, ``groups``, ``unit_offset``, or ``sel`` per
    supertile of ``stack`` units); ``prune_u``: None, a float, or a
    one-element float32 tensor on s's device (read there, without a host
    sync). Differentiable in ``s``: dS comes back in s's type."""
    _check_scores(s)
    check_masks(s.shape[0], s.shape[1], adj, stack, tail_adj, units_per_group, groups)
    kw = dict(stack=stack, zero_quirk=zero_quirk, tail_adj=tail_adj,
              units_per_group=units_per_group, groups=groups, unit_offset=unit_offset,
              p_dtype=p_dtype)
    if torch.compiler.is_compiling():
        from sl_hwgat_tpu_torch.ops import library

        return library.masked_softmax(s, adj, prune_u=prune_u, sel=sel, **kw)
    if s.device.type == "cuda":
        prune_u, sel = device_args(s, stack, prune_u, sel)
        return _MaskedSoftmax.apply(s, prune_u, sel, adj, kw)
    if s.device.type != "cpu":
        raise ValueError(f"masked_softmax runs on cuda or cpu, got {s.device}")
    return plain_masked_softmax(s, adj, prune_u=prune_u, sel=sel, **kw)


def masked_softmax_bwd(s, dp, adj, *, stack: int = 4, zero_quirk: bool = True, prune_u=None,
                       tail_adj=None, units_per_group: int | None = None,
                       groups: int | None = None, unit_offset: int = 0, sel=None):
    """dS (in s's type) of ``masked_softmax`` for the gradient ``dp`` of P, with
    ``masked_softmax``'s arguments. On CUDA tensors it launches
    ``csrc/masked_softmax_bwd.cu`` or raises; on CPU tensors it runs
    ``plain_masked_softmax_bwd``. This is what the gradient of
    ``masked_softmax`` launches on a card."""
    kw = dict(stack=stack, zero_quirk=zero_quirk, prune_u=prune_u, tail_adj=tail_adj,
              units_per_group=units_per_group, groups=groups, unit_offset=unit_offset, sel=sel)
    if s.device.type == "cuda":
        return _kernel_bwd(s, dp, adj, **kw)
    if s.device.type != "cpu":
        raise ValueError(f"masked_softmax_bwd runs on cuda or cpu, got {s.device}")
    return plain_masked_softmax_bwd(s, dp, adj, **kw)


def plain_masked_softmax(s, adj, *, stack=4, zero_quirk=True, prune_u=None, tail_adj=None,
                         units_per_group=None, groups=None, unit_offset=0, sel=None,
                         p_dtype=torch.float32) -> torch.Tensor:
    """The plain PyTorch version of the forward kernel, with
    ``masked_softmax``'s arguments, on any device."""
    sel = plain_sel(s, stack, tail_adj, units_per_group, groups, unit_offset, sel)
    return unit_masked_softmax(s, adj, stack=stack, zero_quirk=zero_quirk, prune_u=prune_u,
                               tail_adj=tail_adj, sel=sel, p_dtype=p_dtype)


def plain_masked_softmax_bwd(s, dp, adj, *, stack=4, zero_quirk=True, prune_u=None,
                             tail_adj=None, units_per_group=None, groups=None, unit_offset=0,
                             sel=None) -> torch.Tensor:
    """The plain PyTorch version of the backward kernel, with
    ``masked_softmax_bwd``'s arguments, on any device."""
    sel = plain_sel(s, stack, tail_adj, units_per_group, groups, unit_offset, sel)
    return unit_masked_softmax_bwd(s, dp, adj, stack=stack, zero_quirk=zero_quirk,
                                   prune_u=prune_u, tail_adj=tail_adj, sel=sel)


class _Bf16Product(torch.autograd.Function):
    """a·b of bf16 CUDA operands with f32 sums (``aten::bmm.dtype``), stored
    as ``out_dtype``; torch defines no derivative of that overload. The
    gradients are the same products of the saved operands and the incoming
    gradient, in the operands' types: on the bf16 overload where that
    gradient is bf16 (dS of bf16 scores), else on f32 operands (dO, dS of f32
    scores), as the JAX einsums' transposes upcast a bf16 operand to meet an
    f32 cotangent."""

    @staticmethod
    def forward(ctx, a, b, out_dtype):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32).to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        # grad mode is off here: _product runs the bare overload where g is
        # bf16, else f32 operands
        da = _product(g, b.transpose(1, 2), a.dtype) if ctx.needs_input_grad[0] else None
        db = _product(a.transpose(1, 2), g, b.dtype) if ctx.needs_input_grad[1] else None
        return da, db, None


def _product(a, b, out_dtype: torch.dtype) -> torch.Tensor:
    """a·b (batched) with f32 sums, stored as ``out_dtype``: on a card, bf16
    operands go through ``_Bf16Product`` (its bare overload where no gradient
    is asked for, as in an export trace); otherwise f32 operands."""
    if a.dtype == b.dtype == torch.bfloat16 and a.device.type == "cuda":
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return _Bf16Product.apply(a, b, out_dtype)
        return torch.bmm(a, b, out_dtype=torch.float32).to(out_dtype)
    return torch.bmm(a.float(), b.float()).to(out_dtype)


def hybrid_window_attention(q, k, v, adj, *, scale: float, stack: int = 4,
                            pad_tokens: int | None = None, zero_quirk: bool = True,
                            prune_u=None, tail_adj=None, units_per_group: int | None = None,
                            groups: int | None = None, unit_offset: int = 0,
                            sel=None, scores_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Masked window attention over (U, N, dh) units with
    ``window_attention``'s contract (`sl_hwgat_tpu/ops/hybrid_attention.py:
    151-186`): the two GEMMs (``_product``) and the masking and softmax
    through ``masked_softmax``. ``pad_tokens`` is accepted for the JAX
    signature; per unit there is nothing to pad. ``scores_dtype``: the type
    S is stored in; bf16 takes effect only with bf16 values (the JAX gate
    ``vs.dtype == jnp.bfloat16``), else the scores stay f32. Returns f32
    (U, N, dh)."""
    if not (q.shape == k.shape == v.shape and q.ndim == 3):
        raise ValueError(f"q, k, v must share one (U, N, dh) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or not (q.device == k.device == v.device):
        raise ValueError("q, k, v must share one dtype and one device")
    if scores_dtype not in _DTYPE_CODE:
        raise ValueError(f"scores_dtype must be float32 or bfloat16, got {scores_dtype}")
    n = q.shape[1]
    if pad_tokens is not None and pad_tokens < n:
        raise ValueError(f"pad_tokens ({pad_tokens}) is below the unit's {n} tokens")
    s_dtype = torch.bfloat16 if scores_dtype == v.dtype == torch.bfloat16 else torch.float32
    # T(scale) as a 0-dim CPU tensor: a CUDA kernel reads it as an argument,
    # so a call copies nothing to the card (a copy would wait on the card)
    scaled = q * torch.tensor(scale, dtype=q.dtype)
    s = _product(scaled, k.transpose(1, 2), s_dtype)
    p = masked_softmax(s, adj, stack=stack, zero_quirk=zero_quirk, prune_u=prune_u,
                       tail_adj=tail_adj, units_per_group=units_per_group, groups=groups,
                       unit_offset=unit_offset, sel=sel, p_dtype=v.dtype)
    return _product(p, v, torch.float32)


def softmax_blocks(x, adj) -> torch.Tensor:
    """The kernel bench's ``softmax_only`` function of (T, SN, DH) f32 tiles
    x (SN, DH ≥ 64): per tile, P of the 32 × 32 blocks x[:32, :32] and
    x[32:64, 32:64] under ``masked_softmax``'s rules (single mask ``adj``,
    zero quirk, no prune) in their places, zeros everywhere else. On CUDA
    tensors it launches ``csrc/softmax_probe.cu`` once (P is K7's bit for
    bit) or raises; on CPU tensors it runs ``plain_softmax_blocks``."""
    if x.dtype != torch.float32 or x.ndim != 3 or min(x.shape[1:]) < 2 * _BLOCK_N:
        raise ValueError(f"x must be (T, SN, DH) float32 tiles with SN, DH >= {2 * _BLOCK_N}, "
                         f"got {tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return plain_softmax_blocks(x, adj)
    if x.device.type != "cuda":
        raise ValueError(f"softmax_blocks runs on cuda or cpu, got {x.device}")
    if np.shape(adj) != (_BLOCK_N, _BLOCK_N):
        raise ValueError(f"adj must be ({_BLOCK_N}, {_BLOCK_N}), got {np.shape(adj)}")
    if not x.is_contiguous() or x.data_ptr() % 16 or x.shape[2] % 4:
        raise ValueError("x must be contiguous and 16-byte aligned, DH a multiple of 4")
    t, sn, dh = x.shape
    out = torch.empty_like(x)
    if t == 0:
        return out
    with torch.cuda.device(x.device):
        err = _build.function(KERNEL_BLOCKS, _ARGTYPES[KERNEL_BLOCKS])(
            x.data_ptr(), out.data_ptr(), device_masks(adj, None, x.device, wide=True).data_ptr(),
            t, sn, dh, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL_BLOCKS} launch failed: cudaError {err}")
    with _LOCK:
        softmax_blocks.launches += 1
    return out


def plain_softmax_blocks(x, adj, softmax=None) -> torch.Tensor:
    """The plain PyTorch version of ``softmax_blocks`` on any device: the two
    blocks of each tile gathered, ``softmax`` over them (two units to a
    supertile; default ``plain_masked_softmax``, or ``masked_softmax``: K7 on
    a card), scattered into zeros."""
    t, n = x.shape[0], _BLOCK_N
    blocks = torch.stack([x[:, :n, :n], x[:, n:2 * n, n:2 * n]], 1).reshape(2 * t, n, n)
    p = (softmax or plain_masked_softmax)(blocks, adj, stack=2).view(t, 2, n, n)
    out = torch.zeros_like(x)
    out[:, :n, :n] = p[:, 0]
    out[:, n:2 * n, n:2 * n] = p[:, 1]
    return out


masked_softmax.launches = 0
masked_softmax_bwd.launches = 0
softmax_blocks.launches = 0
