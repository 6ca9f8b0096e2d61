"""The TPU layouts of the kernel bench, as maps from and to token-major.

The JAX package's Pallas kernels read window attention's operands in layouts
shaped by the TPU's (8, 128) tiling; the port's kernels read token-major
(U, N, dh) units. Each map here is a reshape around one ``relayout``: a plain
``permute`` on the CPU, the relayout kernel (``csrc/relayout.cu``) on the
card. The maps, and the JAX helpers they mirror:

- ``units_to_t``/``t_to_units``: token-major (U, N, dh) ↔ (T, dh, S·N)
  supertiles, S units side by side along the last axis (``_pack_t`` of
  `sl_hwgat_tpu/ops/pallas_attention.py:747-765` on (U, dh, N) units);
- ``widen``/``unwiden``: (T, SN, DH) ↔ the model-wide (H, DH, TH·SN) planes
  (``bench_kernel.py:941``; the 4-axis (H, DH, TH, SN) of ``:258`` is a
  reshape of it);
- ``pack2``/``unpack2``: (T, SN, DH) ↔ lane-packed pairs (T/2, SN, 2·DH)
  (``bench_kernel.py:1003``);
- ``transpose_tiles``: (T, A, B) → (T, B, A), the transposed streams of the
  ``tlay``/``mix``/``tmx``/``tmq`` probes (``stream_set`` builds each set);
- ``pack_plane``/``unpack_plane``: (G, H, F, V, dh) ↔ (G·H, dh, F·Vp) banded
  planes (`sl_hwgat_tpu/ops/pallas_banded.py:508-517`).

The ``*_view`` functions give the same units without a copy: views of the
layout's storage whose leading axes enumerate the token-major units in order
and whose last two are (N, dh), for ``window_attention_into``, which reads
and writes them in place. ``view.reshape(-1, N, dh)`` equals the map's
token-major units:

- ``rows_view``: (T, S·N, dh) row-major tiles → (T, S, N, dh);
- ``t_view``: (T, dh, S·N) transposed tiles or supertiles → (T, S, N, dh);
- ``wide_view``: (H, dh, TH·SN) planes → (H, TH, SN/N, N, dh);
- ``pair_view``: (T/2, SN, 2·dh) lane pairs → (T/2, 2, SN/N, N, dh);
- ``stream_set_views``: the (q, k, v) views of the ``mix``/``tmx``/``tmq``
  streams.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sl_hwgat_tpu_torch.ops.probes import relayout

# (q, k, v) of each mixed probe: "rm" row-major (T, SN, DH) tiles, "t"
# transposed (T, DH, SN) tiles (bench_kernel.py:586-588, 679-681, 799-801)
STREAM_SETS = {"mix": ("rm", "t", "t"), "tmx": ("rm", "rm", "t"), "tmq": ("t", "t", "t")}


def t_to_units(x, stack: int) -> torch.Tensor:
    """(T, dh, stack·N) supertiles → token-major (U, N, dh)."""
    t, dh, sn = x.shape
    return relayout(x.reshape(t, dh, stack, sn // stack), (0, 2, 3, 1)).reshape(
        t * stack, sn // stack, dh)


def units_to_t(x, stack: int) -> torch.Tensor:
    """Token-major (U, N, dh) → (T, dh, stack·N) supertiles."""
    u, n, dh = x.shape
    return relayout(x.reshape(u // stack, stack, n, dh), (0, 3, 1, 2)).reshape(
        u // stack, dh, stack * n)


def widen(x, heads: int) -> torch.Tensor:
    """(T, SN, DH) row-major tiles → (H, DH, TH·SN) model-wide planes."""
    t, sn, dh = x.shape
    th = t // heads
    return relayout(x.reshape(heads, th, sn, dh), (0, 3, 1, 2)).reshape(heads, dh, th * sn)


def unwiden(x, sn: int) -> torch.Tensor:
    """Inverse of ``widen``: (H, DH, TH·SN) → (T, SN, DH)."""
    h, dh, width = x.shape
    return relayout(x.reshape(h, dh, width // sn, sn), (0, 2, 3, 1)).reshape(
        h * (width // sn), sn, dh)


def pack2(x) -> torch.Tensor:
    """(T, SN, DH) → (T/2, SN, 2·DH): tiles 2i and 2i+1 side by side."""
    t, sn, dh = x.shape
    return relayout(x.reshape(t // 2, 2, sn, dh), (0, 2, 1, 3)).reshape(t // 2, sn, 2 * dh)


def unpack2(x) -> torch.Tensor:
    """Inverse of ``pack2``."""
    t2, sn, dh2 = x.shape
    return relayout(x.reshape(t2, sn, 2, dh2 // 2), (0, 2, 1, 3)).reshape(2 * t2, sn, dh2 // 2)


def transpose_tiles(x) -> torch.Tensor:
    """(T, A, B) → (T, B, A)."""
    return relayout(x, (0, 2, 1))


def stream_set(name: str, q, k, v, sn: int = 128):
    """The (q, k, v) streams of the ``mix``/``tmx``/``tmq`` probes from
    token-major (U, N, dh) units: (T, SN, DH) or (T, DH, SN) tiles."""
    out = []
    for form, x in zip(STREAM_SETS[name], (q, k, v)):
        tiles = x.reshape(-1, sn, x.shape[-1])
        out.append(tiles if form == "rm" else transpose_tiles(tiles))
    return tuple(out)


def stream_set_to_units(name: str, q, k, v, n: int = 32):
    """Inverse of ``stream_set``: token-major (U, N, dh) q, k, v."""
    out = []
    for form, x in zip(STREAM_SETS[name], (q, k, v)):
        tiles = x if form == "rm" else transpose_tiles(x)
        out.append(tiles.reshape(-1, n, tiles.shape[-1]))
    return tuple(out)


def rows_view(x, n: int = 32) -> torch.Tensor:
    """(T, S·N, dh) row-major tiles as (T, S, N, dh) units."""
    t, sn, dh = x.shape
    return x.view(t, sn // n, n, dh)


def t_view(x, n: int = 32) -> torch.Tensor:
    """(T, dh, S·N) transposed tiles (the tscore supertiles too) as (T, S, N,
    dh) units: tokens contiguous."""
    t, dh, sn = x.shape
    return x.view(t, dh, sn // n, n).permute(0, 2, 3, 1)


def wide_view(x, sn: int, n: int = 32) -> torch.Tensor:
    """(H, dh, TH·SN) model-wide planes as (H, TH, SN/N, N, dh) units
    (tile h·TH + th): tokens contiguous."""
    h, dh, width = x.shape
    return x.view(h, dh, width // sn, sn // n, n).permute(0, 2, 3, 4, 1)


def pair_view(x, n: int = 32) -> torch.Tensor:
    """(T/2, SN, 2·dh) lane pairs as (T/2, 2, SN/N, N, dh) units (tile 2i + e
    in lanes e·dh ..): features contiguous."""
    t2, sn, dh2 = x.shape
    return x.view(t2, sn // n, n, 2, dh2 // 2).permute(0, 3, 1, 2, 4)


def stream_set_views(name: str, q, k, v, n: int = 32):
    """The (q, k, v) streams of a ``mix``/``tmx``/``tmq`` probe as unit
    views (``stream_set``'s layouts)."""
    return tuple(rows_view(x, n) if form == "rm" else t_view(x, n)
                 for form, x in zip(STREAM_SETS[name], (q, k, v)))


def pack_plane(x, vp: int) -> torch.Tensor:
    """(G, H, F, V, dh) → (G·H, dh, F·Vp), joints padded to Vp with 0."""
    g, h, f, v, dh = x.shape
    if vp != v:
        x = F.pad(x, (0, 0, 0, vp - v))
    return relayout(x.reshape(g * h, f * vp, dh), (0, 2, 1))


def unpack_plane(x, g: int, h: int, f: int, v: int, dh: int, vp: int) -> torch.Tensor:
    """Inverse of ``pack_plane``: (G·H, dh, F·Vp) → (G, H, F, V, dh)."""
    return relayout(x, (0, 2, 1)).reshape(g, h, f, vp, dh)[:, :, :, :v]
