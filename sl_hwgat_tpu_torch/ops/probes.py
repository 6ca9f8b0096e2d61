"""The kernel bench's probe kernels: streams, relayouts and tile products.

The decomposition probes of ``bench_kernel.py`` compute few functions behind
many TPU layouts. Three CUDA kernels carry them (``csrc/stream_probe.cu``,
``csrc/relayout.cu``, ``csrc/tile_matmul.cu``):

- ``stream_copy``, ``stream_sum3``, ``stream_floor``: copy with a type
  change; x + 0·y + 0·z; (x [+ y]) · (Σ_group a [+ Σ_group b]).
- ``relayout``: an axis permutation of a contiguous tensor of up to 4 axes,
  differentiable (its gradient is the inverse permutation).
- ``tile_matmul``: per tile, S = X·Yᵀ (f32 sums), then O = round(S)·Z or
  O = S[:, :C], on (planes, tiles, rows, columns) views of any strides.

On CUDA tensors each wrapper launches its kernel on the current stream or
raises; on CPU tensors it runs its plain PyTorch version (``plain_*``
beside it). There is no fallback from one to the other. ``LAUNCHES`` counts
each kernel's launches (``reset_launches`` sets them to 0), so a run can show
that a path went through the kernels.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from sl_hwgat_tpu_torch.ops import _build

KERNEL_STREAM = "stream_probe"
KERNEL_RELAYOUT = "relayout"
KERNEL_MATMUL = "tile_matmul"
KERNELS = (KERNEL_STREAM, KERNEL_RELAYOUT, KERNEL_MATMUL)
LAUNCHES = dict.fromkeys(KERNELS, 0)
MAX_ROWS, MAX_DEPTH, MAX_COLS = 256, 128, 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = {
    # mode, x, y, a, b, o, outer, rows, cols, group_cols, in_dtype, out_dtype, stream
    KERNEL_STREAM: ["i"] + ["p"] * 5 + ["ll"] * 4 + ["i", "i", "p"],
    # x, o, d0-d3, p0-p3, elem_bytes, stream
    KERNEL_RELAYOUT: ["p", "p"] + ["ll"] * 4 + ["i"] * 5 + ["p"],
    # x, y, z, o, strides, planes, tiles, rows, depth, cols, mode, in_dtype,
    # out_dtype, stream
    KERNEL_MATMUL: ["p"] * 5 + ["ll", "ll"] + ["i"] * 6 + ["p"],
}
_LOCK = threading.Lock()
_FUNCTIONS: dict = {}  # kernel name → its bound C entry point


def reset_launches() -> None:
    with _LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _device(*tensors) -> str:
    """"cuda" or "cpu", the one device of ``tensors``; raises otherwise."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"the tensors must share one device, got {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the probe kernels run on cuda or cpu, got {dev}")
    return dev.type


def _dtype(dtype: torch.dtype, what: str = "input") -> int:
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"the probe kernels take float32/bfloat16 {what}s, got {dtype}")
    return _DTYPE_CODE[dtype]


def _flat(name: str, t) -> torch.Tensor:
    """t as the stream kernel reads it: contiguous and 16-byte aligned."""
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return t


def _launch(kernel: str, *args) -> None:
    """Launch ``kernel`` on the current stream of its tensors' device. The
    bench times these kernels at tens of microseconds, so the host path is
    kept short: the entry point is looked up once, and the device is
    switched only when it is not the current one."""
    fn = _FUNCTIONS.get(kernel)
    if fn is None:
        fn = _FUNCTIONS[kernel] = _build.function(kernel, _ARGTYPES[kernel])
    dev = next(a for a in args if torch.is_tensor(a)).device
    call = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
    if dev.index == torch.cuda.current_device():
        err = fn(*call, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*call, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    with _LOCK:
        LAUNCHES[kernel] += 1


# --- streams ---------------------------------------------------------------


def stream_copy(x, dtype: torch.dtype) -> torch.Tensor:
    """x converted to ``dtype`` (float32/bfloat16, round to nearest even)."""
    if _device(x) == "cpu":
        return plain_stream_copy(x, dtype)
    code_in, code_out = _dtype(x.dtype), _dtype(dtype, "output")
    _flat("x", x)
    out = torch.empty(x.shape, dtype=dtype, device=x.device)
    if x.numel():
        _launch(KERNEL_STREAM, 0, x, None, None, None, out, 1, 1, x.numel(), 1, code_in,
                code_out)
    return out


def stream_sum3(x, y, z) -> torch.Tensor:
    """x + 0·y + 0·z in x's type (the TPU's three-stream floor); y and z may
    be views into one packed tensor."""
    if not (x.shape == y.shape == z.shape and x.dtype == y.dtype == z.dtype):
        raise ValueError("x, y, z must share one shape and dtype")
    if _device(x, y, z) == "cpu":
        return plain_stream_sum3(x, y, z)
    code = _dtype(x.dtype)
    for name, t in (("x", x), ("y", y), ("z", z)):
        _flat(name, t)
    out = torch.empty_like(x)
    if x.numel():
        _launch(KERNEL_STREAM, 1, x, y, z, None, out, 1, 1, x.numel(), 1, code, code)
    return out


def _floor_view(view, group_cols, tensors) -> tuple[int, int, int]:
    outer, rows, cols = (int(d) for d in view)
    for name, t in tensors.items():
        if t is not None and t.numel() != outer * rows * cols:
            raise ValueError(f"{name} has {t.numel()} elements, the view {tuple(view)} "
                             f"{outer * rows * cols}")
    if group_cols <= 0 or group_cols % 8 or cols % group_cols:
        raise ValueError(f"group_cols ({group_cols}) must be a multiple of 8 dividing the "
                         f"view's {cols} columns")
    return outer, rows, cols


def stream_floor(x, a, *, y=None, b=None, view, group_cols: int,
                 out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """o = (x [+ y]) · (Σ_g a [+ Σ_g b]) in ``out_dtype``, x's shape.

    Every tensor is viewed as ``view`` = (outer, rows, cols); a group is one
    outer index and a run of ``group_cols`` columns over all rows. x + y is
    rounded to the inputs' type; the group sums run in f32.
    """
    tensors = {"x": x, "y": y, "a": a, "b": b}
    outer, rows, cols = _floor_view(view, group_cols, tensors)
    present = [t for t in tensors.values() if t is not None]
    if len({t.dtype for t in present}) != 1:
        raise ValueError("x, y, a, b must share one dtype")
    if _device(*present) == "cpu":
        return plain_stream_floor(x, a, y=y, b=b, view=view, group_cols=group_cols,
                                  out_dtype=out_dtype)
    code_in, code_out = _dtype(x.dtype), _dtype(out_dtype, "output")
    for name, t in tensors.items():
        if t is not None:
            _flat(name, t)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    _launch(KERNEL_STREAM, 2, x, y, a, b, out, outer, rows, cols, group_cols, code_in, code_out)
    return out


def plain_stream_copy(x, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype, copy=True)


def plain_stream_sum3(x, y, z) -> torch.Tensor:
    return x + y * 0 + z * 0


def plain_stream_floor(x, a, *, y=None, b=None, view, group_cols: int,
                       out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    outer, rows, cols = (int(d) for d in view)
    runs = cols // group_cols

    def sums(t):
        return t.reshape(outer, rows, runs, group_cols).float().sum((1, 3))

    scale = sums(a) if b is None else sums(a) + sums(b)
    xy = x if y is None else x + y
    o = xy.reshape(outer, rows, runs, group_cols).float() * scale[:, None, :, None]
    return o.to(out_dtype).reshape(x.shape)


# --- relayout --------------------------------------------------------------


def _check_perm(x, perm) -> tuple[int, ...]:
    perm = tuple(int(p) for p in perm)
    if sorted(perm) != list(range(x.ndim)) or not 1 <= x.ndim <= 4:
        raise ValueError(f"perm {perm} must permute the 1-4 axes of a {x.ndim}-axis tensor")
    return perm


def _relayout_kernel(x, perm) -> torch.Tensor:
    _dtype(x.dtype)
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("relayout takes a contiguous, 16-byte aligned tensor")
    out = torch.empty([x.shape[p] for p in perm], dtype=x.dtype, device=x.device)
    if x.numel():
        lead = 4 - x.ndim
        dims = [1] * lead + list(x.shape)
        full = list(range(lead)) + [p + lead for p in perm]
        _launch(KERNEL_RELAYOUT, x, out, *dims, *full, x.element_size())
    return out


class _Relayout(torch.autograd.Function):
    """The relayout kernel, with the inverse permutation as its gradient."""

    @staticmethod
    def forward(ctx, x, perm):
        ctx.inverse = tuple(perm.index(i) for i in range(len(perm)))
        return _relayout_kernel(x, perm)

    @staticmethod
    def backward(ctx, g):
        return _relayout_kernel(g.contiguous(), ctx.inverse), None


def relayout(x, perm) -> torch.Tensor:
    """``x.permute(perm).contiguous()`` of a contiguous x with 1-4 axes."""
    perm = _check_perm(x, perm)
    if _device(x) == "cpu":
        return plain_relayout(x, perm)
    if x.requires_grad and torch.is_grad_enabled():
        return _Relayout.apply(x, perm)
    return _relayout_kernel(x, perm)


def plain_relayout(x, perm) -> torch.Tensor:
    return x.permute(*perm).contiguous()


# --- tile products ---------------------------------------------------------


def _check_tiles(x, y, z, cols):
    if x.ndim != 4 or y.shape != x.shape:
        raise ValueError(f"x and y must be one (planes, tiles, rows, depth) shape, got "
                         f"{tuple(x.shape)}, {tuple(y.shape)}")
    planes, tiles, rows, depth = x.shape
    if z is not None:
        if z.ndim != 4 or z.shape[:3] != x.shape[:3] or z.dtype != x.dtype:
            raise ValueError(f"z must be (planes, tiles, rows, cols) in x's dtype, got "
                             f"{tuple(z.shape)} {z.dtype}")
        cols = z.shape[3]
    elif cols is None:
        raise ValueError("without z, cols names the columns of S to keep")
    if y.dtype != x.dtype:
        raise ValueError("x and y must share one dtype")
    return planes, tiles, rows, depth, int(cols)


def tile_matmul(x, y, z=None, *, cols: int | None = None,
                out_dtype: torch.dtype = torch.float32, out=None) -> torch.Tensor:
    """Per tile: S = X·Yᵀ with f32 sums; with z, O = S·Z where S is first
    rounded to the inputs' type (f32 sums, stored as ``out_dtype``), else
    O = S[:, :cols] (the f32 sums stored as ``out_dtype``).

    x, y: (planes, tiles, rows, depth) views of any strides (a tile stride
    of 0 shares one tile); z: (planes, tiles, rows, C). ``out``: a
    (planes, tiles, rows, C) view of any strides to write into (default a
    new contiguous tensor); it is returned. rows <= 256, depth <= 128,
    C <= min(128, rows) on the card.
    """
    planes, tiles, rows, depth, cols = _check_tiles(x, y, z, cols)
    shape = (planes, tiles, rows, cols)
    if out is not None and (tuple(out.shape) != shape or out.dtype != out_dtype):
        raise ValueError(f"out must be {shape} {out_dtype}, got {tuple(out.shape)} {out.dtype}")
    if _device(x, y, z, out) == "cpu":
        o = plain_tile_matmul(x, y, z, cols=cols, out_dtype=out_dtype)
        return o if out is None else out.copy_(o)
    code_in, code_out = _dtype(x.dtype), _dtype(out_dtype, "output")
    if not (1 <= rows <= MAX_ROWS and 1 <= depth <= MAX_DEPTH and 1 <= cols <= min(MAX_COLS, rows)):
        raise ValueError(f"tile_matmul takes rows <= {MAX_ROWS}, depth <= {MAX_DEPTH} and "
                         f"columns <= min({MAX_COLS}, rows); got {rows}, {depth}, {cols}")
    if out is None:
        out = torch.empty(shape, dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    zz = z if z is not None else x
    strides = (ctypes.c_longlong * 16)(*(s for t in (x, y, zz, out) for s in t.stride()))
    _launch(KERNEL_MATMUL, x, y, None if z is None else z, out, ctypes.addressof(strides),
            planes, tiles, rows, depth, cols, 0 if z is not None else 1, code_in, code_out)
    return out


def plain_tile_matmul(x, y, z=None, *, cols: int | None = None,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    s = torch.einsum("ptmk,ptnk->ptmn", x.float(), y.float())
    if z is None:
        return s[..., :cols].to(out_dtype)
    s = s.to(x.dtype).float()
    return torch.einsum("ptmn,ptnc->ptmc", s, z.float()).to(out_dtype)
