"""Fused adjacency-masked window attention: the wrappers of the CUDA kernels.

``window_attention`` keeps the contract of the JAX package's
``pallas_window_attention`` (`sl_hwgat_tpu/ops/pallas_attention.py`) for the
token-major (U, N, dh) layout, gradient included. On CUDA tensors it is a
``torch.autograd.Function`` whose forward launches
``csrc/window_attention_fwd.cu`` and whose backward launches
``csrc/window_attention_bwd.cu`` (through ``window_attention_bwd``), on the
current stream, or raises. On CPU tensors it runs the plain version,
``plain_window_attention`` (``ops/attention.py::stacked_window_attention``),
which torch differentiates. There is no fallback from one to the other.

The kernels take units of 32 tokens with head dim 32 or 64 (HWGATE), and
units of up to 64 tokens with head dim 64 (HGATE's 58, which the JAX package
pads to 64 and stacks two to a supertile; per unit the padding is simply
absent). ``window_attention.launches`` and ``window_attention_bwd.launches``
count the two kernels' launches (plain integers that a run may reset), so a
caller can show that a path went through the kernels.

``window_attention_into`` computes the same forward on strided views of the
kernel bench's TPU layouts, in place: ``csrc/window_attention_layout.cu``
(32-token units, dh 64) reads q, k, v and writes o where they lie, with K1's
arithmetic, so o is K1's bit for bit; ``window_attention_bwd_into`` is its
backward, ``csrc/window_attention_layout_bwd.cu`` reading q, k, v, dO and
writing dq, dk, dv where they lie, with K2's arithmetic (bit for bit K2's).
``layout_window_attention`` differentiates the pair on storages of one
layout, one launch each way. ``window_attention_into.launches`` and
``window_attention_bwd_into.launches`` count their launches.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from sl_hwgat_tpu_torch.ops import _build
from sl_hwgat_tpu_torch.ops.attention import (
    stacked_window_attention,
    stacked_window_attention_bwd,
)

KERNEL = "window_attention_fwd"
KERNEL_BWD = "window_attention_bwd"
KERNEL_LAYOUT = "window_attention_layout"
KERNEL_LAYOUT_BWD = "window_attention_layout_bwd"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_TOKENS = 32        # units of 32 tokens: head dim 32 or 64
_KERNEL_HEAD_DIMS = (32, 64)
_WIDE_TOKENS = 64          # other units of up to 64 tokens: head dim 64
_MASKS: dict = {}
_LOCK = threading.Lock()


def check_masks(units: int, n: int, adj, stack: int, tail_adj, units_per_group, groups):
    """Check the mask arguments of U units of n tokens."""
    if np.shape(adj) != (n, n):
        raise ValueError(f"adj must be ({n}, {n}), got {np.shape(adj)}")
    if units % stack:
        raise ValueError(f"units ({units}) must be a multiple of the stack ({stack})")
    if tail_adj is not None:
        if units_per_group is None or groups is None:
            raise ValueError("tail_adj needs units_per_group and groups")
        if units_per_group % stack:
            raise ValueError(
                f"units per temporal group ({units_per_group}) must be a multiple of "
                f"the supertile stack ({stack}) so no supertile mixes mask planes")


def plain_sel(x, stack, tail_adj, units_per_group, groups, unit_offset, sel):
    """``sel`` as the plain versions take it: the one given, or in dual-mask
    mode the temporal-group phase's (``make_sel``) for the (U, …) tensor x."""
    if tail_adj is not None and sel is None:
        sel = make_sel(x.shape[0] // stack, stack, units_per_group, groups, unit_offset,
                       device=x.device)
    return sel


def make_sel(tiles: int, stack: int, units_per_group: int, groups: int,
             unit_offset: int = 0, device=None) -> torch.Tensor:
    """(tiles,) int32 selector, 1 where a supertile belongs to the last of
    every ``groups`` temporal groups (≡ ``_make_sel`` of the JAX package)."""
    starts = torch.arange(tiles, dtype=torch.int64, device=device) * stack
    group = (starts + unit_offset) // units_per_group
    return (group % groups == groups - 1).to(torch.int32)


def _row_bits(adj) -> np.ndarray:
    """(N, N) {0,1} mask → (N,) uint64, bit j of word i set where adj[i, j]."""
    a = np.asarray(adj, dtype=np.float32) != 0
    return (a.astype(np.uint64) << np.arange(a.shape[1], dtype=np.uint64)).sum(1, dtype=np.uint64)


def device_masks(adj, tail_adj, device, wide: bool = False) -> torch.Tensor:
    """(2, N) row bitmasks on ``device``: plane 0 ``adj``, plane 1 ``tail_adj``
    (or ``adj`` again in single-mask mode), 32-bit words for 32-token units
    unless ``wide``, else 64-bit; cached per mask pair, width and device."""
    a = np.asarray(adj, dtype=np.float32)
    t = a if tail_adj is None else np.asarray(tail_adj, dtype=np.float32)
    if a.shape[0] > _WIDE_TOKENS:
        raise ValueError(f"row bitmasks hold at most {_WIDE_TOKENS} tokens, got {a.shape[0]}")
    wide = wide or a.shape[0] != _KERNEL_TOKENS
    key = (a.tobytes(), t.tobytes(), wide, str(device))
    with _LOCK:
        m = _MASKS.get(key)
        if m is None:
            bits = np.stack([_row_bits(a), _row_bits(t)])
            bits = bits.view(np.int64) if wide else bits.astype(np.uint32).view(np.int32)
            m = _MASKS[key] = torch.from_numpy(bits).to(device)
        return m


def device_args(x, stack, prune_u, sel, units: int | None = None):
    """(prune_u, sel) as the kernels read them: a one-element float32 tensor
    (or None) and (U/stack,) int32 (or None), on x's device, where x is a
    (U, …) tensor (or ``units`` gives U)."""
    dev = x.device
    units = x.shape[0] if units is None else units
    if prune_u is not None and not torch.is_tensor(prune_u):
        prune_u = torch.full((1,), float(prune_u), dtype=torch.float32, device=dev)
    if prune_u is not None and (prune_u.device != dev or prune_u.dtype != torch.float32
                                or prune_u.numel() != 1):
        raise ValueError("prune_u must be a one-element float32 tensor on the inputs' device")
    if sel is not None:
        sel = torch.as_tensor(sel, dtype=torch.int32, device=dev).contiguous()
        if sel.shape != (units // stack,):
            raise ValueError(f"sel must have shape ({units // stack},), got "
                             f"{tuple(sel.shape)}")
    return prune_u, sel


def _kernel_args(q, adj, *, stack, pad_tokens, prune_u, tail_adj, sel, tensors):
    """Check what the kernels take; return the device (masks, prune_u, sel)."""
    u, n, dh = q.shape
    if pad_tokens not in (None, n) and not n < pad_tokens <= _WIDE_TOKENS:
        raise ValueError(f"pad_tokens={pad_tokens} for {n}-token units: the kernels pad "
                         f"nothing and take at most {_WIDE_TOKENS} tokens")
    if n == _KERNEL_TOKENS:
        if dh not in _KERNEL_HEAD_DIMS:
            raise ValueError(f"the CUDA kernels take head dims {_KERNEL_HEAD_DIMS} for "
                             f"{n}-token units, got {dh}")
    elif not (1 <= n <= _WIDE_TOKENS and dh == 64):
        raise ValueError(f"the CUDA kernels take {_KERNEL_TOKENS}-token units, or units of "
                         f"up to {_WIDE_TOKENS} tokens with head dim 64; got N={n}, dh={dh}")
    for name, t in tensors.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return (device_masks(adj, tail_adj, q.device), *device_args(q, stack, prune_u, sel))


def ptr(t):
    return t.data_ptr() if t is not None else None


def mask_mode(tail_adj, stack, units_per_group, groups, unit_offset):
    """(dual, stack, per_group, groups, unit_offset) of the C interfaces."""
    dual = tail_adj is not None
    return (int(dual), int(stack), int(units_per_group) if dual else 0,
            int(groups) if dual else 0, int(unit_offset))


def _kernel(q, k, v, adj, *, scale, stack, pad_tokens, zero_quirk, prune_u,
            tail_adj, units_per_group, groups, unit_offset, sel, out_dtype):
    if q.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise TypeError(f"the CUDA kernel takes float32/bfloat16, got {q.dtype} → {out_dtype}")
    masks, prune_u, sel = _kernel_args(q, adj, stack=stack, pad_tokens=pad_tokens,
                                       prune_u=prune_u, tail_adj=tail_adj, sel=sel,
                                       tensors={"q": q, "k": k, "v": v})
    u, n, dh = q.shape
    dev = q.device
    out = torch.empty((u, n, dh), dtype=out_dtype, device=dev)
    if u == 0:
        return out
    with torch.cuda.device(dev):
        err = _build.function(KERNEL, _ARGTYPES[KERNEL])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), masks.data_ptr(),
            ptr(sel), ptr(prune_u), u, n, dh, _DTYPE_CODE[q.dtype], _DTYPE_CODE[out_dtype],
            float(scale), int(zero_quirk),
            *mask_mode(tail_adj, stack, units_per_group, groups, unit_offset),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: cudaError {err}")
    with _LOCK:
        window_attention.launches += 1
    return out


def _kernel_bwd(q, k, v, do, adj, *, scale, stack, pad_tokens, zero_quirk, prune_u,
                tail_adj, units_per_group, groups, unit_offset, sel):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the CUDA kernel takes float32/bfloat16, got {q.dtype}")
    do = do.to(q.dtype).contiguous()
    masks, prune_u, sel = _kernel_args(q, adj, stack=stack, pad_tokens=pad_tokens,
                                       prune_u=prune_u, tail_adj=tail_adj, sel=sel,
                                       tensors={"q": q, "k": k, "v": v, "do": do})
    u, n, dh = q.shape
    dev = q.device
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if u == 0:
        return dq, dk, dv
    with torch.cuda.device(dev):
        err = _build.function(KERNEL_BWD, _ARGTYPES[KERNEL_BWD])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), masks.data_ptr(), ptr(sel), ptr(prune_u),
            u, n, dh, _DTYPE_CODE[q.dtype], float(scale), int(zero_quirk),
            *mask_mode(tail_adj, stack, units_per_group, groups, unit_offset),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL_BWD} launch failed: cudaError {err}")
    with _LOCK:
        window_attention_bwd.launches += 1
    return dq, dk, dv


_ARGTYPES = {
    # q, k, v, o, masks, sel, prune_u, units, tokens, dh, in_dtype, out_dtype,
    # scale, zero_quirk, dual, stack, per_group, groups, unit_offset, stream
    KERNEL: ["p"] * 7 + ["ll", "i", "i", "i", "i", "f", "i", "i", "i", "i", "i", "ll", "p"],
    # q, k, v, do, dq, dk, dv, masks, sel, prune_u, units, tokens, dh, dtype,
    # scale, zero_quirk, dual, stack, per_group, groups, unit_offset, stream
    KERNEL_BWD: ["p"] * 10 + ["ll", "i", "i", "i", "f", "i", "i", "i", "i", "i", "ll", "p"],
    # q, k, v, o, views, masks, sel, prune_u, units, dh, in_dtype, out_dtype,
    # forms, scale, zero_quirk, dual, stack, per_group, groups, unit_offset,
    # stream
    KERNEL_LAYOUT: ["p"] * 8 + ["ll", "i", "i", "i", "i", "f", "i", "i", "i", "i", "i", "ll",
                                "p"],
    # q, k, v, do, dq, dk, dv, views, masks, sel, prune_u, units, dh, dtype,
    # forms, scale, zero_quirk, dual, stack, per_group, groups, unit_offset,
    # stream
    KERNEL_LAYOUT_BWD: ["p"] * 11 + ["ll", "i", "i", "i", "f", "i", "i", "i", "i", "i", "ll",
                                     "p"],
}


class _WindowAttention(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient. q, k, v
    get gradients (in q's dtype); ``prune_u`` and ``sel`` get none."""

    @staticmethod
    def forward(ctx, q, k, v, prune_u, sel, adj, kw):
        out = _kernel(q, k, v, adj, prune_u=prune_u, sel=sel, **kw)
        ctx.save_for_backward(q, k, v, prune_u, sel)
        ctx.adj = adj
        ctx.kw = {name: val for name, val in kw.items() if name != "out_dtype"}
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, prune_u, sel = ctx.saved_tensors
        dq, dk, dv = _kernel_bwd(q, k, v, do.contiguous(), ctx.adj, prune_u=prune_u,
                                 sel=sel, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def window_attention(q, k, v, adj, *, scale: float, stack: int = 4,
                     pad_tokens: int | None = None, zero_quirk: bool = True,
                     prune_u=None, tail_adj=None, units_per_group: int | None = None,
                     groups: int | None = None, unit_offset: int = 0, sel=None,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Fused masked window attention over (U, N, dh) units.

    ``adj``: static (N, N) {0,1} numpy mask shared by every unit. Shifted
    blocks (``tail_adj`` given): units are ordered (…, group, unit-in-group)
    with ``groups`` temporal groups of ``units_per_group`` units, and the last
    group of each period attends under ``tail_adj``; ``unit_offset`` shifts
    the phase of unit 0, and ``sel`` ((U/stack,) ints, 1 = tail plane per
    supertile of ``stack`` units) overrides the selector. ``prune_u``: None, a
    float, or a one-element float32 tensor on q's device (the kernel reads it
    there, without a host sync). Returns (U, N, dh) in ``out_dtype``
    (default float32).
    """
    if not (q.shape == k.shape == v.shape and q.ndim == 3):
        raise ValueError(f"q, k, v must share one (U, N, dh) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or not (q.device == k.device == v.device):
        raise ValueError("q, k, v must share one dtype and one device")
    check_masks(q.shape[0], q.shape[1], adj, stack, tail_adj, units_per_group, groups)
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    kw = dict(scale=scale, stack=stack, pad_tokens=pad_tokens, zero_quirk=zero_quirk,
              tail_adj=tail_adj, units_per_group=units_per_group, groups=groups,
              unit_offset=unit_offset, out_dtype=out_dtype)
    if q.device.type == "cuda":
        if prune_u is not None and not torch.is_tensor(prune_u):
            prune_u = torch.full((1,), float(prune_u), dtype=torch.float32, device=q.device)
        if sel is not None:
            sel = torch.as_tensor(sel, dtype=torch.int32, device=q.device).contiguous()
        return _WindowAttention.apply(q, k, v, prune_u, sel, adj, kw)
    if q.device.type != "cpu":
        raise ValueError(f"window_attention runs on cuda or cpu, got {q.device}")
    return plain_window_attention(q, k, v, adj, prune_u=prune_u, sel=sel, **kw)


def window_attention_bwd(q, k, v, do, adj, *, scale: float, stack: int = 4,
                         pad_tokens: int | None = None, zero_quirk: bool = True,
                         prune_u=None, tail_adj=None, units_per_group: int | None = None,
                         groups: int | None = None, unit_offset: int = 0, sel=None,
                         out_dtype: torch.dtype | None = None):
    """(dq, dk, dv) of ``window_attention`` for the output gradient ``do``,
    with ``window_attention``'s arguments (``out_dtype`` names the forward's
    output type; the gradients are in q's dtype). On CUDA tensors it launches
    ``csrc/window_attention_bwd.cu`` or raises; on CPU tensors it runs
    ``plain_window_attention_bwd``. This is what the gradient of
    ``window_attention`` launches on a card."""
    kw = dict(scale=scale, stack=stack, pad_tokens=pad_tokens, zero_quirk=zero_quirk,
              prune_u=prune_u, tail_adj=tail_adj, units_per_group=units_per_group,
              groups=groups, unit_offset=unit_offset, sel=sel)
    if q.device.type == "cuda":
        return _kernel_bwd(q, k, v, do, adj, **kw)
    if q.device.type != "cpu":
        raise ValueError(f"window_attention_bwd runs on cuda or cpu, got {q.device}")
    return plain_window_attention_bwd(q, k, v, do, adj, **kw)


def plain_window_attention(q, k, v, adj, *, scale, stack=4, pad_tokens=None,
                           zero_quirk=True, prune_u=None, tail_adj=None,
                           units_per_group=None, groups=None, unit_offset=0, sel=None,
                           out_dtype=None) -> torch.Tensor:
    """The plain PyTorch version of the kernel, with ``window_attention``'s
    arguments, on any device: what ``window_attention`` runs on the CPU, and
    what the kernel is held against on a card."""
    sel = plain_sel(q, stack, tail_adj, units_per_group, groups, unit_offset, sel)
    return stacked_window_attention(
        q, k, v, adj, scale=scale, stack=stack, pad_tokens=pad_tokens,
        zero_quirk=zero_quirk, prune_u=prune_u, tail_adj=tail_adj, sel=sel,
        out_dtype=out_dtype)


def plain_window_attention_bwd(q, k, v, do, adj, *, scale, stack=4, pad_tokens=None,
                               zero_quirk=True, prune_u=None, tail_adj=None,
                               units_per_group=None, groups=None, unit_offset=0, sel=None,
                               out_dtype=None):
    """The plain PyTorch version of the backward kernel, with
    ``window_attention_bwd``'s arguments, on any device."""
    sel = plain_sel(q, stack, tail_adj, units_per_group, groups, unit_offset, sel)
    return stacked_window_attention_bwd(
        q, k, v, do, adj, scale=scale, stack=stack, pad_tokens=pad_tokens,
        zero_quirk=zero_quirk, prune_u=prune_u, tail_adj=tail_adj, sel=sel)


# --- the same forward on strided views of the TPU layouts -------------------

# forms of the layout kernel's instantiations, by (input dtype, output
# dtype): bit 0 q, 1 k, 2 v, 3 o, set where the operand is token-contiguous
_LAYOUT_FORMS = {(torch.float32, torch.float32): (0b1111,),
                 (torch.bfloat16, torch.bfloat16): (0b1111, 0b1110, 0b1100, 0b0000)}
_LAYOUT_HEAD_DIM = 64


def unit_view(name: str, x, n: int, dh: int) -> tuple[int, tuple]:
    """(form, (sa, sb, ss, ld, nb, ns)) of a (…, n, dh) view x as the layout
    kernel reads it: form 0 where a token's dh features are contiguous (ld:
    the token stride), 1 where a feature's n tokens are (ld: the feature
    stride); unit u = (a·nb + b)·ns + s of its leading axes, merged where
    they can be and padded to three, at a·sa + b·sb + s·ss elements. Raises
    ``ValueError`` on a view the kernel cannot take: neither inner stride 1,
    more than three unmergeable leading axes, or not 16-byte aligned."""
    *lead, tokens, feats = x.shape
    if (tokens, feats) != (n, dh):
        raise ValueError(f"{name} must be (…, {n}, {dh}), got {tuple(x.shape)}")
    *strides, sn, sd = x.stride()
    if sd == 1:
        form, ld = 0, sn
    elif sn == 1:
        form, ld = 1, sd
    else:
        raise ValueError(f"{name}: neither its tokens nor its features are contiguous "
                         f"(strides {tuple(x.stride())})")
    axes = []
    for size, stride in zip(lead, strides):
        if size == 1:
            continue
        if axes and axes[-1][1] == stride * size:
            axes[-1] = (axes[-1][0] * size, stride)
        else:
            axes.append((size, stride))
    if len(axes) > 3:
        raise ValueError(f"{name}: {len(axes)} leading axes that no reshape merges (at most 3)")
    (_, sa), (nb, sb), (ns, ss) = [(1, 0)] * (3 - len(axes)) + axes
    if x.data_ptr() % 16 or any(s * x.element_size() % 16 for s in (sa, sb, ss, ld)):
        raise ValueError(f"{name} must be 16-byte aligned: its start and its unit, row or "
                         "column strides")
    return form, (sa, sb, ss, ld, nb, ns)


def window_attention_into(q, k, v, adj, *, out, scale: float, stack: int = 4, tail_adj=None,
                          units_per_group: int | None = None, groups: int | None = None,
                          sel=None, prune_u=None):
    """``window_attention``'s forward (zero quirk on) over (…, N, dh) views of
    any of the TPU layouts, written into the view ``out``; returns ``out``.

    q, k, v and out are views whose units, the leading axes in row-major
    order, are the token-major units of ``window_attention``; each is
    token-major inside a unit (a token's features contiguous) or transposed
    (a feature's tokens contiguous), so that the row-major tiles, the
    transposed tiles and supertiles, the widened planes and the lane pairs
    of ``layouts`` are views of their storage (``layouts.*_view``). The mask
    and prune arguments are ``window_attention``'s. On CUDA tensors it
    launches ``csrc/window_attention_layout.cu`` once, which reads and writes
    the views in place (32-token units, dh 64; f32 or bf16 in and the same
    type out); a view it cannot take raises ``ValueError``. On CPU tensors
    it runs ``plain_window_attention`` on ``.reshape(-1, N, dh)`` copies and
    copies the result into ``out``."""
    if not (q.shape == k.shape == v.shape == out.shape and q.ndim >= 3):
        raise ValueError(f"q, k, v and out must share one (…, N, dh) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(out.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or not (q.device == k.device == v.device == out.device):
        raise ValueError("q, k, v must share one dtype, and q, k, v and out one device")
    n, dh = q.shape[-2:]
    units = q.numel() // (n * dh)
    check_masks(units, n, adj, stack, tail_adj, units_per_group, groups)
    kw = dict(scale=scale, stack=stack, tail_adj=tail_adj, units_per_group=units_per_group,
              groups=groups)
    if q.device.type == "cpu":
        o = plain_window_attention(*(x.reshape(-1, n, dh) for x in (q, k, v)), adj,
                                   prune_u=prune_u, sel=sel, out_dtype=out.dtype, **kw)
        return out.copy_(o.view(out.shape))
    if q.device.type != "cuda":
        raise ValueError(f"window_attention_into runs on cuda or cpu, got {q.device}")
    if n != _KERNEL_TOKENS or dh != _LAYOUT_HEAD_DIM:
        raise ValueError(f"the layout kernel takes {_KERNEL_TOKENS}-token units with head dim "
                         f"{_LAYOUT_HEAD_DIM}, got N={n}, dh={dh}")
    views = [unit_view(name, x, n, dh) for name, x in zip("qkv", (q, k, v))]
    views.append(unit_view("out", out, n, dh))
    _writable_views(out=out)
    forms = sum(form << i for i, (form, _) in enumerate(views))
    if forms not in _LAYOUT_FORMS.get((q.dtype, out.dtype), ()):
        raise ValueError(f"no layout kernel for {q.dtype} → {out.dtype} with operand forms "
                         f"{forms:04b} (bit 0 q … bit 3 out, 1 = token-contiguous)")
    if units == 0:
        return out
    masks = device_masks(adj, tail_adj, q.device)
    prune_u, sel = device_args(q, stack, prune_u, sel, units=units)
    _launch_layout(KERNEL_LAYOUT, (q, k, v, out), views, masks, sel, prune_u, units, dh,
                   _DTYPE_CODE[q.dtype], _DTYPE_CODE[out.dtype], forms, float(scale), 1,
                   *mask_mode(tail_adj, stack, units_per_group, groups, 0))
    with _LOCK:
        window_attention_into.launches += 1
    return out


def _launch_layout(kernel, tensors, views, masks, sel, prune_u, *rest) -> None:
    """Launch a layout kernel on the current stream of its tensors' device:
    their pointers, the views' strides as a host array, the masks, ``rest``."""
    strides = (ctypes.c_longlong * (6 * len(views)))(*(s for _, w in views for s in w))
    fn = _build.function(kernel, _ARGTYPES[kernel])
    dev = tensors[0].device
    args = (*(t.data_ptr() for t in tensors), ctypes.addressof(strides), masks.data_ptr(),
            ptr(sel), ptr(prune_u), *rest)
    if dev.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")


# every operand of the backward layout kernel token-contiguous: bit i of
# (q, k, v, do, dq, dk, dv)
_LAYOUT_BWD_FORMS = 0b1111111


def _writable_views(**views) -> None:
    for name, x in views.items():
        if any(st == 0 and size > 1 for size, st in zip(x.shape[:-2], x.stride()[:-2])):
            raise ValueError(f"{name} must not repeat a unit (a leading stride of 0)")


def window_attention_bwd_into(q, k, v, do, adj, *, dq, dk, dv, scale: float, stack: int = 4,
                              tail_adj=None, units_per_group: int | None = None,
                              groups: int | None = None, sel=None, prune_u=None):
    """(dq, dk, dv) of ``window_attention_into``'s forward for the output
    gradient ``do``, over (…, N, dh) views of the TPU layouts, written into
    the views ``dq``, ``dk``, ``dv``; returns them.

    Every tensor is a view of ``window_attention_into``'s kind, and all
    share one shape, dtype and device; the mask and prune arguments are the
    forward's. On CUDA tensors it launches
    ``csrc/window_attention_layout_bwd.cu`` once, which reads q, k, v, do and
    writes dq, dk, dv in place (32-token units, dh 64, f32 or bf16, every
    operand token-contiguous: the transposed units and supertiles, the
    widened planes); a view it cannot take raises ``ValueError``. On CPU
    tensors it runs ``plain_window_attention_bwd`` on ``.reshape(-1, N, dh)``
    copies and copies the results into the views."""
    tensors = {"q": q, "k": k, "v": v, "do": do, "dq": dq, "dk": dk, "dv": dv}
    if len({x.shape for x in tensors.values()}) != 1 or q.ndim < 3:
        raise ValueError("q, k, v, do, dq, dk and dv must share one (…, N, dh) shape, got "
                         + ", ".join(f"{n} {tuple(x.shape)}" for n, x in tensors.items()))
    if len({x.dtype for x in tensors.values()}) != 1 or len({x.device for x in tensors.values()}) != 1:
        raise ValueError("q, k, v, do, dq, dk and dv must share one dtype and one device")
    n, dh = q.shape[-2:]
    units = q.numel() // (n * dh)
    check_masks(units, n, adj, stack, tail_adj, units_per_group, groups)
    kw = dict(scale=scale, stack=stack, tail_adj=tail_adj, units_per_group=units_per_group,
              groups=groups)
    if q.device.type == "cpu":
        grads = plain_window_attention_bwd(*(x.reshape(-1, n, dh) for x in (q, k, v, do)), adj,
                                           prune_u=prune_u, sel=sel, **kw)
        for out, g in zip((dq, dk, dv), grads):
            out.copy_(g.view(out.shape))
        return dq, dk, dv
    if q.device.type != "cuda":
        raise ValueError(f"window_attention_bwd_into runs on cuda or cpu, got {q.device}")
    if n != _KERNEL_TOKENS or dh != _LAYOUT_HEAD_DIM:
        raise ValueError(f"the layout kernels take {_KERNEL_TOKENS}-token units with head dim "
                         f"{_LAYOUT_HEAD_DIM}, got N={n}, dh={dh}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"the backward layout kernel takes float32/bfloat16, got {q.dtype}")
    views = [unit_view(name, x, n, dh) for name, x in tensors.items()]
    _writable_views(dq=dq, dk=dk, dv=dv)
    forms = sum(form << i for i, (form, _) in enumerate(views))
    if forms != _LAYOUT_BWD_FORMS:
        raise ValueError(f"no backward layout kernel for operand forms {forms:07b} (bit 0 q … "
                         "bit 6 dv, 1 = token-contiguous): every operand must be")
    if units == 0:
        return dq, dk, dv
    masks = device_masks(adj, tail_adj, q.device)
    prune_u, sel = device_args(q, stack, prune_u, sel, units=units)
    _launch_layout(KERNEL_LAYOUT_BWD, tuple(tensors.values()), views, masks, sel, prune_u, units,
                   dh, _DTYPE_CODE[q.dtype], forms, float(scale), 1,
                   *mask_mode(tail_adj, stack, units_per_group, groups, 0))
    with _LOCK:
        window_attention_bwd_into.launches += 1
    return dq, dk, dv


class _LayoutWindowAttention(torch.autograd.Function):
    """``window_attention_into`` on views of q's, k's and v's storages, with
    ``window_attention_bwd_into`` as its gradient: dq, dk and dv come in
    storages shaped like q's, k's and v's, written through the same views
    (no relayout, no copy of a layout operand)."""

    @staticmethod
    def forward(ctx, q, k, v, view, adj, kw):
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        window_attention_into(view(q), view(k), view(v), adj, out=view(out), **kw)
        ctx.save_for_backward(q, k, v)
        ctx.view, ctx.adj, ctx.kw = view, adj, kw
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        view = ctx.view
        if not do.is_contiguous():  # the output gradient, in o's storage shape
            do = do.contiguous()
        grads = [torch.empty(x.shape, dtype=x.dtype, device=x.device) for x in (q, k, v)]
        window_attention_bwd_into(view(q), view(k), view(v), view(do), ctx.adj,
                                  dq=view(grads[0]), dk=view(grads[1]), dv=view(grads[2]),
                                  **ctx.kw)
        return (*grads, None, None, None)


def layout_window_attention(q, k, v, adj, *, view, scale: float, stack: int = 4, tail_adj=None,
                            units_per_group: int | None = None, groups: int | None = None,
                            sel=None, prune_u=None) -> torch.Tensor:
    """``window_attention``'s forward (zero quirk on) on the storages q, k, v
    of one TPU layout, differentiable; returns o in q's storage shape and
    type.

    ``view`` maps a storage of that layout to its (…, N, dh) unit view
    (``layouts.t_view``, ``layouts.wide_view``, …; contiguous storages). The
    forward is one ``window_attention_into`` on the views, the gradient one
    ``window_attention_bwd_into`` writing dq, dk and dv into storages shaped
    like q's, k's and v's: on CUDA tensors one launch of each layout kernel
    and no relayout; on CPU tensors their plain versions. The mask and
    prune arguments are ``window_attention``'s."""
    kw = dict(scale=scale, stack=stack, tail_adj=tail_adj, units_per_group=units_per_group,
              groups=groups, sel=sel, prune_u=prune_u)
    return _LayoutWindowAttention.apply(q, k, v, view, adj, kw)


window_attention.launches = 0
window_attention_bwd.launches = 0
window_attention_into.launches = 0
window_attention_bwd_into.launches = 0
