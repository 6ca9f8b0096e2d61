"""Banded (±1-frame) graph attention: the wrappers of the CUDA kernels.

``banded_attention`` computes the JAX package's ``banded_frame_attention``
(no halo) with the rounding of its frame-packed TPU kernel
(`sl_hwgat_tpu/ops/pallas_banded.py::pallas_packed_banded_attention`), on
the port's token-major (P, F·V, dh) layout, gradient included. On CUDA
tensors it is a ``torch.autograd.Function`` whose forward launches
``csrc/banded_attention_fwd.cu`` and whose backward launches
``csrc/banded_attention_bwd.cu`` (through ``banded_attention_bwd``), on the
current stream, or raises. On CPU tensors it runs the plain version,
``plain_banded_attention`` (``ops/attention.py::banded_frame_attention_k8``),
which torch differentiates. There is no fallback from one to the other.

The band is a static (3, V, V) additive mask [prev | self | next] with
entries {0, −1e4}; the kernels take it as per-row and per-column 32-bit edge
masks, cached on the device. Both kernels visit only the edges, which is
exact wherever a row has one: the wrapper refuses a band with an edgeless
row. ``banded_attention.launches`` and ``banded_attention_bwd.launches``
count the two kernels' launches.

While ``torch.compiler.is_compiling()`` (``torch.export`` tracing an eval
forward), ``banded_attention`` calls the custom op of ``ops/library.py``
instead, whose CUDA implementation is the same launch (``launch``).

``banded_packed_mm`` is the frame-packed kernel's product-only probe (K10,
`sl_hwgat_tpu/ops/pallas_banded.py:395` ``_fwd_kernel_packed_mm``, reached
there through ``PALLAS_BANDED_PACKED_MM=1``): per tile of 128/Vp frames, the
two products of the attention with no scale, band, mask or softmax. It runs
on the tile-product kernel (``ops/probes.py::tile_matmul``) and is forward
only.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from sl_hwgat_tpu_torch.ops import _build
from sl_hwgat_tpu_torch.ops.attention import (
    NEG,
    banded_frame_attention_bwd,
    banded_frame_attention_k8,
)
from sl_hwgat_tpu_torch.ops.probes import plain_tile_matmul, tile_matmul

KERNEL = "banded_attention_fwd"
KERNEL_BWD = "banded_attention_bwd"
HEAD_DIM = 16
MAX_JOINTS = 32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BITS: dict = {}
_LOCK = threading.Lock()


def band_edges(band) -> np.ndarray:
    """(3, V, V) additive band → (3, V, V) bool, True on the edges (0 entries).
    Raises ``ValueError`` on entries other than 0 and −1e4."""
    b = np.asarray(band, dtype=np.float32)
    if b.ndim != 3 or b.shape[0] != 3 or b.shape[1] != b.shape[2]:
        raise ValueError(f"band must be (3, V, V), got {b.shape}")
    if not np.all((b == 0) | (b == np.float32(NEG))):
        raise ValueError("band entries must be 0 (edge) or -1e4 (no edge)")
    return b == 0


def check_band(band, frames: int) -> None:
    """Refuse a band under which some query row of a ``frames``-frame clip
    has no edge: the plain version gives such a row a uniform softmax over
    masked scores, which the kernels, visiting only edges, do not compute."""
    e = band_edges(band)
    if e.shape[1] > MAX_JOINTS:
        raise ValueError(f"the banded kernels take at most {MAX_JOINTS} joints, got {e.shape[1]}")
    prev, self_, nxt = (e[p].any(1) for p in range(3))
    first = self_ | (nxt if frames > 1 else False)
    last = self_ | (prev if frames > 1 else False)
    inner = self_ | prev | nxt
    if not (first.all() and last.all() and (frames < 3 or inner.all())):
        raise ValueError("band has a query row with no edge in some frame")


def edges_per_row(band) -> int:
    """The most edges a query row has under ``band``, over its three planes
    (a row inside the clip; rows of the first and last frame have fewer).
    The kernels size their caches per row by it: the forward's of scores
    and exps, the backward's of A and dS."""
    return int(band_edges(band).sum(axis=(0, 2)).max())


def _bits(band, device) -> torch.Tensor:
    """(6, 32) int32 on ``device``: rows 0-2 bit j of word i set where plane
    p has the edge (i, j); rows 3-5 the transpose (bit i of word j)."""
    e = band_edges(band)
    key = (e.tobytes(), e.shape, str(device))
    with _LOCK:
        t = _BITS.get(key)
        if t is None:
            nv = e.shape[1]
            weights = np.uint64(1) << np.arange(nv, dtype=np.uint64)
            words = np.zeros((6, MAX_JOINTS), np.uint64)
            for p in range(3):
                words[p, :nv] = (e[p].astype(np.uint64) * weights).sum(1)
                words[3 + p, :nv] = (e[p].T.astype(np.uint64) * weights).sum(1)
            t = torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(device)
            if not torch.compiler.is_compiling():  # a traced tensor is no cache entry
                _BITS[key] = t
        return t


def _check(q, tensors: dict, band) -> tuple[int, int, int]:
    """(planes, frames, joints) of a call; raises on what the kernels do not
    take (on every device, so the CPU path keeps the kernels' contract)."""
    planes, frames, nv = check_planes(q, tensors, np.shape(band)[1])
    check_band(band, frames)
    return planes, frames, nv


def check_planes(q, tensors: dict, nv: int) -> tuple[int, int, int]:
    """``_check`` without the band's edge rows."""
    if q.ndim != 3:
        raise ValueError(f"q must be (P, F·V, dh), got {tuple(q.shape)}")
    for name, t in tensors.items():
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's shape {tuple(q.shape)}, dtype and device")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"banded attention runs on cuda or cpu, got {q.device}")
    p, n, dh = q.shape
    if dh != HEAD_DIM:
        raise ValueError(f"the banded kernels take head dim {HEAD_DIM}, got {dh}")
    if n % nv:
        raise ValueError(f"the tokens must be whole frames, got {n} tokens of {nv} joints")
    for name, t in {"q": q, **tensors}.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return p, n // nv, nv


def _kernel(q, k, v, band, *, scale, out_dtype):
    nv = _check(q, {"k": k, "v": v}, band)[2]
    return launch(q, k, v, _bits(band, q.device), scale=scale, joints=nv,
                  edges_per_row=edges_per_row(band), out_dtype=out_dtype)


def launch(q, k, v, bits, *, scale, joints, edges_per_row, out_dtype):
    """One launch of the forward kernel on checked (P, F·V, dh) planes:
    ``bits`` from ``_bits``, ``edges_per_row`` the band's. Returns the
    output in ``out_dtype``."""
    if q.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise TypeError(f"the CUDA kernel takes float32/bfloat16, got {q.dtype} → {out_dtype}")
    planes, n, _ = q.shape
    out = torch.empty(q.shape, dtype=out_dtype, device=q.device)
    if planes == 0:
        return out
    with torch.cuda.device(q.device):
        err = _build.function(KERNEL, _ARGTYPES[KERNEL])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bits.data_ptr(), planes,
            n // joints, joints, HEAD_DIM, _DTYPE_CODE[q.dtype], _DTYPE_CODE[out_dtype],
            edges_per_row, float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: cudaError {err}")
    with _LOCK:
        banded_attention.launches += 1
    return out


def _kernel_bwd(q, k, v, do, band, *, scale):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the CUDA kernel takes float32/bfloat16, got {q.dtype}")
    do = do.to(q.dtype).contiguous()
    planes, frames, nv = _check(q, {"k": k, "v": v, "do": do}, band)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if planes == 0:
        return dq, dk, dv
    with torch.cuda.device(q.device):
        err = _build.function(KERNEL_BWD, _ARGTYPES[KERNEL_BWD])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _bits(band, q.device).data_ptr(), planes, frames,
            nv, HEAD_DIM, _DTYPE_CODE[q.dtype], edges_per_row(band), float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL_BWD} launch failed: cudaError {err}")
    with _LOCK:
        banded_attention_bwd.launches += 1
    return dq, dk, dv


_ARGTYPES = {
    # q, k, v, o, bits, planes, frames, joints, dh, in_dtype, out_dtype,
    # edges_per_row, scale, stream
    KERNEL: ["p"] * 5 + ["ll", "i", "i", "i", "i", "i", "i", "f", "p"],
    # q, k, v, do, dq, dk, dv, bits, planes, frames, joints, dh, dtype,
    # edges_per_row, scale, stream
    KERNEL_BWD: ["p"] * 8 + ["ll", "i", "i", "i", "i", "i", "f", "p"],
}


class _BandedAttention(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient; q, k, v
    get gradients in q's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, band, scale, out_dtype):
        out = _kernel(q, k, v, band, scale=scale, out_dtype=out_dtype)
        ctx.save_for_backward(q, k, v)
        ctx.band, ctx.scale = band, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = _kernel_bwd(q, k, v, do.contiguous(), ctx.band, scale=ctx.scale)
        return dq, dk, dv, None, None, None


def banded_attention(q, k, v, band, *, scale: float,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Banded attention over (P, F·V, dh) planes: frame f's V joints attend
    to the joints of frames f−1, f and f+1 under ``band``, a static (3, V, V)
    numpy additive mask [prev | self | next] with entries {0, −1e4}.
    Returns (P, F·V, dh) in ``out_dtype`` (default float32). The kernels'
    contract holds on every device: dh 16, V ≤ 32, every query row with an
    edge."""
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    if torch.compiler.is_compiling():
        from sl_hwgat_tpu_torch.ops import library

        return library.banded_attention(q, k, v, band, scale=scale, out_dtype=out_dtype)
    if q.device.type == "cuda":
        return _BandedAttention.apply(q, k, v, band, float(scale), out_dtype)
    _check(q, {"k": k, "v": v}, band)
    return plain_banded_attention(q, k, v, band, scale=scale, out_dtype=out_dtype)


def banded_attention_bwd(q, k, v, do, band, *, scale: float):
    """(dq, dk, dv) of ``banded_attention`` for the output gradient ``do``,
    in q's dtype. On CUDA tensors it launches ``csrc/banded_attention_bwd.cu``
    or raises; on CPU tensors it runs ``plain_banded_attention_bwd``. This is
    what the gradient of ``banded_attention`` launches on a card."""
    if q.device.type == "cuda":
        return _kernel_bwd(q, k, v, do, band, scale=scale)
    _check(q, {"k": k, "v": v, "do": do.to(q.dtype).contiguous()}, band)
    return plain_banded_attention_bwd(q, k, v, do, band, scale=scale)


def _frames(x, band) -> torch.Tensor:
    """(P, F·V, dh) → (P, 1, F, V, dh)."""
    p, n, dh = x.shape
    nv = np.shape(band)[1]
    return x.reshape(p, 1, n // nv, nv, dh)


def plain_banded_attention(q, k, v, band, *, scale, out_dtype=None) -> torch.Tensor:
    """The plain PyTorch version of the forward kernel, with
    ``banded_attention``'s arguments, on any device and any band."""
    out = banded_frame_attention_k8(_frames(q, band), _frames(k, band), _frames(v, band),
                                    band, scale=scale, out_dtype=out_dtype)
    return out.reshape(q.shape)


def plain_banded_attention_bwd(q, k, v, do, band, *, scale):
    """The plain PyTorch version of the backward kernel, with
    ``banded_attention_bwd``'s arguments, on any device and any band."""
    grads = banded_frame_attention_bwd(*(_frames(t, band) for t in (q, k, v, do)), band,
                                       scale=scale)
    return tuple(g.reshape(q.shape) for g in grads)


def packed_frames_per_tile(joints: int) -> int:
    """Frames in one 128-lane tile of the JAX frame-packed layout: 128/Vp,
    Vp the smallest of 8, 16, 32, 64, 128 that holds the joints
    (`sl_hwgat_tpu/ops/pallas_banded.py:634-639`)."""
    for vp in (8, 16, 32, 64, 128):
        if joints <= vp:
            return 128 // vp
    raise ValueError(f"the frame-packed layout takes at most 128 joints, got {joints}")


def _packed_tiles(q, k, v, joints: int):
    if q.ndim != 3 or not (q.shape == k.shape == v.shape):
        raise ValueError(f"q, k, v must share one (P, F·V, dh) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share one dtype")
    fpt = packed_frames_per_tile(joints)
    planes, n, dh = q.shape
    rows = fpt * joints
    if n % rows:
        raise ValueError(f"{n} tokens are not whole tiles of {fpt} frames × {joints} joints")
    return tuple(x.reshape(planes, n // rows, rows, dh) for x in (q, k, v))


def banded_packed_mm(q, k, v, *, joints: int, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """K10 over (P, F·V, dh) planes: for every tile of 128/Vp frames (4 for
    29 joints, 8 for 16), S = Q·Kᵀ (f32 sums, rounded to v's type), O = S·V
    (f32 sums). Returns (P, F·V, dh) in ``out_dtype`` (default float32). The
    JAX kernel keeps S transposed, (keys, queries)
    (`pallas_banded.py:403-404`): the same entries. On CUDA tensors it
    launches the tile-product kernel or raises; it has no gradient, and a
    CUDA input that requires one raises."""
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    tiles = _packed_tiles(q, k, v, joints)
    if q.device.type == "cuda":
        if any(t.requires_grad for t in (q, k, v)) and torch.is_grad_enabled():
            raise RuntimeError("banded_packed_mm is forward only: its inputs must not "
                               "require a gradient")
        return tile_matmul(*tiles, out_dtype=out_dtype).reshape(q.shape)
    if q.device.type != "cpu":
        raise ValueError(f"banded_packed_mm runs on cuda or cpu, got {q.device}")
    return plain_tile_matmul(*tiles, out_dtype=out_dtype).reshape(q.shape)


def plain_banded_packed_mm(q, k, v, *, joints: int,
                           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The plain PyTorch version of ``banded_packed_mm``, on any device."""
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    tiles = _packed_tiles(q, k, v, joints)
    return plain_tile_matmul(*tiles, out_dtype=out_dtype).reshape(q.shape)


banded_attention.launches = 0
banded_attention_bwd.launches = 0
