"""Measure one attention implementation or decomposition probe on the card.

    python -m sl_hwgat_tpu_torch.bench.kernel <impl> [units] [--tg N] [--device cpu]

Counterpart of ``bench_kernel.py``: every implementation name there has an
entry in ``IMPLS``. The probes' TPU layouts are kept as inputs and outputs;
the work between them runs on the port's kernels:

- stream probes (``floor_copy*``, ``floor_slab*``, ``tlay_copy*``,
  ``*_floor``, ``dmaflr_*``, ``xstrided_ref*``): ``ops/probes.py``
  ``stream_copy``/``stream_sum3``/``stream_floor``;
- relayouts (``xrelay_*``, ``xstrided_s0``/``_s2``): ``relayout``;
- tile products (``mm_*``, ``floor_dot1slim*``/``bigm*``/``sn256*``,
  ``*_mm``, ``tmq_bmm``, ``matmul_*``) and K10 (``banded_packed_mm*``, the
  JAX ``banded_packed*`` under ``PALLAS_BANDED_PACKED_MM=1``):
  ``tile_matmul``;
- the fused probes (``tlay_fused*``, ``mix_fused``, ``tmx_fused``,
  ``tmq_*fused``, ``tsw_*`` but the floor, ``lp_fused_bf16``) and the
  forward ``pallas_t*``/``pallas_widepre_bf16``/``pair_tscore_bf16``
  entries: ``window_attention_into`` on views of their layouts, one launch
  of the layout kernel (single mask, zero quirk, no prune); the ``*bwd*``
  layout entries: ``layout_window_attention`` on their layouts' storages,
  one launch of the layout kernel forward and one of the backward layout
  kernel (``window_attention_bwd_into``), no relayout; the token-major
  ``pallas*`` entries: K1 (and K2);
- ``softmax_only``: ``softmax_blocks``, one kernel over the two diagonal
  unit blocks of each supertile that reach the output (K7's row routine);
- ``hybrid*``: ``hybrid_window_attention`` (K7); ``banded_*``: the banded
  kernels K8/K9;
- ``ell_*``: ``ell_graph_attention`` (``ops/sparse_attention.py``, plain
  torch as in the JAX package: no kernel) at GATE's batch-16 shape on the
  BODY29 spatial plane plus ±1-frame links (``bench_kernel.py:1373-1426``);
  a ``units`` below the default cuts the batch in proportion (at least 1);
- yardsticks, timed only: ``stacked*`` (the plain attention; also bare
  ``ell``, which in ``bench_kernel.py`` does not match ``ell_`` and falls
  to its last branch, ``stacked_window_attention``), ``calib_*``
  (``torch.matmul``/``torch.bmm``), ``xrelay_copy*`` (an add).

The inputs are drawn as ``bench_kernel.py:104-108`` draws them. One JSON line
gives the keys of ``bench_kernel.py`` (``impl``, ``edges`` where it has
them, ``time_us``, ``time_us_min``, ``time_us_max``, ``n_repeats``,
``spread_pct``) and ``bound_us``/``bound_by`` (the H100 bound of the call's
bytes and operations, ``utils/profiling.py``), ``device_us`` (the call's
time with the card's queue kept full, ``profiling.device_seconds``; None for
the plain attention's yardsticks, whose masks are copied from the host at
every call, which waits on the card), the
kernels' launches per
call and the device (name and power limit from ``nvidia-smi``). Times come
from CUDA events around back-to-back calls, the median of the repeats; where
a call's host path takes longer than its kernels, ``time_us`` is the host's
and ``device_us`` the card's.
Without a card it exits non-zero unless ``--device cpu`` is given (host
times, for tests).
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from sl_hwgat_tpu_torch.graphs.adjacency import (
    additive_mask,
    dense_to_ell,
    spatio_temporal_adj,
    windowed_block_adj,
)
from sl_hwgat_tpu_torch.graphs.skeleton import BODY29_EDGES, edges_to_dense
from sl_hwgat_tpu_torch.ops import banded_attention as banded_mod
from sl_hwgat_tpu_torch.ops import hybrid_attention as hybrid_mod
from sl_hwgat_tpu_torch.ops import layouts, probes
from sl_hwgat_tpu_torch.ops import window_attention as window_mod
from sl_hwgat_tpu_torch.ops.attention import stacked_window_attention
from sl_hwgat_tpu_torch.ops.sparse_attention import ell_graph_attention
from sl_hwgat_tpu_torch.utils import profiling

UNITS, N, DH, SN, STACK, SCALE, HEADS = 12288, 32, 64, 128, 4, 0.125, 8
BANDED_SHAPE, BANDED_SCALE, BANDED_VP = (16, 8, 192, 29, 16), 0.25, 32
BF16, F32 = torch.bfloat16, torch.float32


def _suffixes(*bases, tails=("", "_bf16")):
    return tuple(b + t for b in bases for t in tails)


IMPLS = (
    "pallas", "pallas_dual", "pallas_bf16", "pallas_obf16", "pallas_tbf16", "pallas_tdual_bf16",
    "pallas_tpre_bf16", "pallas_tspre_bf16", "pallas_widepre_bf16", "pair_tscore_bf16",
    "pallas_bwd", "pallas_bwd_bf16", "pallas_bwd_obf16", "pallas_tbwd_bf16", "pallas_tsbwd_bf16",
    "pallas_widebwd_bf16",
    *_suffixes("mm_nt", "mm_split", "mm_nt_split", "mm_dot1", "mm_dot1_nt"),
    *_suffixes(*(f"floor_{p}{b}" for p in ("", "pure")
                 for b in ("copy", "slab", "dot1slim", "bigm", "sn256"))),
    *_suffixes("tlay_copy", "tlay_mm", "tlay_fused"),
    "mix_floor", "mix_mm", "mix_fused", "tmx_floor", "tmx_mm", "tmx_fused",
    "tmq_floor", "tmq_bmm", "tmq_bfused", "tmq_mm", "tmq_fused",
    "tsw_floor", "tsw_fused", "tsw_bstack", "tsw_1_fused", "lp_fused_bf16",
    "dmaflr_hbm", "dmaflr_3stream", "dmaflr_qkvpack",
    *_suffixes("xrelay_copy", "xrelay_s0", "xrelay_s2", "xrelay_s0pallas", "xrelay_s2pallas",
               tails=("", "_bf16", "_f32")),
    "xstrided_s0_bf16", "xstrided_s2_bf16", "xstrided_ref_bf16",
    "matmul_only", "matmul_k128", "matmul_only_bf16", "softmax_only",
    *_suffixes(*(f"banded_{b}{w}" for b in ("xla", "compact", "pallas", "packed")
                 for w in ("", "_bwd"))),
    *_suffixes("banded_packedpre", "banded_packed_mm"),
    *_suffixes("ell", "ell_bwd"),
    "calib_big_f32", "calib_big_bf16", "calib_shape_f32", "calib_shape_bf16",
    *_suffixes("hybrid", "hybrid_bwd"),
    "stacked", "stacked_bf16", "tsw1_fused",
)


# the forward entries in TPU layouts: one launch of the layout kernel a call
LAYOUT_ENTRIES = ("tlay_fused", "tlay_fused_bf16", "mix_fused", "tmx_fused", "tmq_fused",
                  "tmq_bfused", "tsw_fused", "tsw_bstack", "tsw_1_fused", "lp_fused_bf16",
                  "pallas_tbf16", "pallas_tdual_bf16", "pallas_tpre_bf16", "pallas_tspre_bf16",
                  "pallas_widepre_bf16", "pair_tscore_bf16")
# the gradient entries in TPU layouts: one launch of each layout kernel a call
LAYOUT_BWD_ENTRIES = ("pallas_tbwd_bf16", "pallas_tsbwd_bf16", "pallas_widebwd_bf16")


def window_adj() -> np.ndarray:
    """The (32, 32) adjacency of the bench's window units."""
    return windowed_block_adj(2)[0]


def dual_tail(adj) -> np.ndarray:
    """The shifted plane of the dual-mask probes (``bench_kernel.py:201``)."""
    parity = np.arange(adj.shape[0]) % 2
    return adj * (parity[:, None] == parity[None, :])


def banded_band() -> np.ndarray:
    """GATE's (3, 29, 29) band [identity | skeleton | identity]."""
    v = BANDED_SHAPE[3]
    eye = np.eye(v, dtype=np.float32)
    spatial = edges_to_dense(BODY29_EDGES, v, self_loops=False)
    return np.stack([additive_mask(eye), additive_mask(spatial), additive_mask(eye)])


@functools.lru_cache(maxsize=None)
def ell_tables(frames: int, joints: int):
    """(col_idx, valid) of the ``ell_*`` entries: GATE's spatial plane within
    each frame and same-joint links to the neighbouring frames
    (``bench_kernel.py:1386-1398``), through ``dense_to_ell``."""
    return dense_to_ell(spatio_temporal_adj(BODY29_EDGES, frames, joints))


def ell_batch(units: int) -> int:
    """The ``ell_*`` entries' batch: 16 at the default units, cut in
    proportion below them (at least 1)."""
    return max(1, BANDED_SHAPE[0] * min(units, UNITS) // UNITS)


@functools.lru_cache(maxsize=1)
def _qkv_draws(units: int):
    """q, k, v as every probe draws them first, and the generator's state
    after them (cached: the other probes' draws continue from there)."""
    r = np.random.default_rng(0)
    qkv = tuple(r.normal(size=(units, N, DH)).astype(np.float32) for _ in range(3))
    return qkv, r.bit_generator.state


def draws(impl: str, units: int = UNITS) -> dict:
    """The numpy arrays ``bench_kernel.py`` draws for ``impl``: q, k, v
    (units, 32, 64) from ``default_rng(0)``, then from the same generator
    the relayout probes' x0, or the calibrations' operand; the banded
    probes' q, k, v (16, 8, 192, 29, 16) from ``default_rng(1)``, and the
    ``ell_*`` entries' the same draws at ``ell_batch(units)``."""
    qkv, state = _qkv_draws(units)
    out = dict(zip("qkv", qkv))
    r = np.random.default_rng()
    r.bit_generator.state = state  # the generator where bench_kernel.py has it after q, k, v
    if impl.startswith(("xrelay_", "xstrided_")):
        base = impl.split("_", 1)[1]
        s0 = "s0" in base if impl.startswith("xrelay_") else not base.startswith("s2")
        gg, hh = (6144, 2) if s0 else (1536, 8)
        out["x0"] = r.normal(size=(gg, N, hh, DH)).astype(np.float32)
    elif impl.startswith("calib_big"):
        out["m"] = r.normal(size=(2048, 2048)).astype(np.float32)
    elif impl.startswith("calib_shape") or impl == "pair_tscore_bf16":
        out["ks2"] = r.normal(size=(units // 4, 128, 64)).astype(np.float32)
    elif impl.startswith(("banded_", "ell_")):
        shape = BANDED_SHAPE
        if impl.startswith("ell_"):
            shape = (ell_batch(units),) + BANDED_SHAPE[1:]
        rb = np.random.default_rng(1)
        for name in "qkv":
            out["b" + name] = rb.normal(size=shape).astype(np.float32)
    return out


@dataclass
class Probe:
    """One bench entry: ``body(state)`` is the measured call."""

    impl: str
    state: torch.Tensor
    body: Callable[[torch.Tensor], torch.Tensor]
    consts: tuple = ()        # the other tensors the call reads
    flops: float = 0.0        # operations of one call
    dtype: str = "float32"    # the type whose peak bounds the operations
    edges: int | None = None
    reads_state: bool = True  # False where the probe ignores its chained input
    # the entries in TPU layouts: [(args, kwargs)] of the body's last
    # window_attention_into call (the views it reads and writes), and the
    # map from a storage of the layout to its (…, N, dh) unit view
    into_call: list = field(default_factory=list)
    view: Callable | None = None
    # False where a call copies from host memory (the plain attention's
    # masks), which waits on the card: device_seconds cannot queue it ahead
    queues_ahead: bool = True


def _into(record: list, *args, **kw) -> None:
    """``window_attention_into(*args, **kw)``, its arguments kept in record."""
    record[:] = [(args, kw)]
    window_mod.window_attention_into(*args, **kw)


def _win_flops(units: int, products: int, n: int = N, dh: int = DH) -> float:
    return units * products * 2 * n * n * dh


def _grad_of(loss_of, x):
    """d loss_of(leaf) / d leaf at x, with grad mode on."""
    with torch.enable_grad():
        leaf = x.detach().requires_grad_(True)
        out, loss = loss_of(leaf)
        (grad,) = torch.autograd.grad(loss, leaf)
    return out, grad


def _window_probe(impl, d, dev) -> Probe:
    q, k, v = (torch.from_numpy(d[n]).to(dev) for n in "qkv")
    units = q.shape[0]
    adj = window_adj()
    kw = dict(scale=SCALE, stack=STACK)
    if "dual" in impl:
        kw.update(tail_adj=dual_tail(adj), units_per_group=32, groups=3)

    def att(qq, kk, vv, out_dtype=None):
        return window_mod.window_attention(qq, kk, vv, adj, out_dtype=out_dtype, **kw)

    kb, vb = k.to(BF16), v.to(BF16)
    edges = units * int((adj != 0).sum())
    bwd = "bwd" in impl
    flops = _win_flops(units, 7 if bwd else 2)
    if impl in ("pallas", "pallas_dual"):
        return Probe(impl, q, lambda x: att(x, k, v), (k, v), flops, edges=edges)
    if impl == "pallas_bf16":
        return Probe(impl, q, lambda x: att(x.to(BF16), kb, vb), (kb, vb), flops, "bfloat16",
                     edges)
    if impl == "pallas_obf16":
        return Probe(impl, q.to(BF16), lambda x: att(x, kb, vb, BF16), (kb, vb), flops,
                     "bfloat16", edges)
    if impl in ("pallas_bwd", "pallas_bwd_bf16"):
        kk, vv = (kb, vb) if impl.endswith("bf16") else (k, v)

        def loss(leaf):
            o = att(leaf.to(kk.dtype), kk, vv)
            return o, (o * o).sum()

        return Probe(impl, q, lambda x: _grad_of(loss, x)[1].float(), (kk, vv), flops,
                     "bfloat16" if kk.dtype == BF16 else "float32", edges)
    if impl == "pallas_bwd_obf16":
        def loss(leaf):
            o = att(leaf, kb, vb, BF16)
            return o, (o.float() ** 2).sum()

        return Probe(impl, q.to(BF16), lambda x: _grad_of(loss, x)[1], (kb, vb), flops,
                     "bfloat16", edges)
    # TPU layouts: (U, dh, N) transposed units, (T, dh, SN) prepacked
    # supertiles, (H, DH, TH, SN) model-wide planes; the inputs are laid out
    # once, outside the timed call, and the calls read them through views
    if impl in ("pallas_tbf16", "pallas_tdual_bf16", "pallas_tbwd_bf16", "pallas_tsbwd_bf16"):
        lay = layouts.transpose_tiles
    elif impl in ("pallas_tpre_bf16", "pallas_tspre_bf16", "pair_tscore_bf16"):
        def lay(x):
            return layouts.units_to_t(x, STACK)
    else:  # pallas_widepre_bf16, pallas_widebwd_bf16
        t = units // STACK
        th = t // HEADS

        def lay(x):
            return layouts.widen(x.reshape(t, SN, DH), HEADS).reshape(HEADS, DH, th, SN)
    if impl.startswith("pallas_wide"):
        def view(x):
            return layouts.wide_view(x.view(HEADS, DH, -1), SN)
    else:
        view = layouts.t_view
    qt, kt, vt = (lay(x) for x in (q.to(BF16), kb, vb))

    if not bwd:  # the layout kernel on views of the layout
        kv, calls = (view(kt), view(vt)), []

        def into(x):
            out = torch.empty_like(x)
            _into(calls, view(x), *kv, adj, out=view(out), **kw)
            return out

        return Probe(impl, qt, into, (kt, vt), flops, "bfloat16", edges, into_call=calls,
                     view=view)

    # forward and gradient: one launch of each layout kernel, no relayout
    def loss(leaf):
        o = window_mod.layout_window_attention(leaf, kt, vt, adj, view=view, **kw)
        return o, (o.float() ** 2).sum()

    if impl == "pallas_widebwd_bf16":
        def body(x):
            o, g = _grad_of(loss, x)
            return o.detach() + g.to(o.dtype)
    else:
        def body(x):
            return _grad_of(loss, x)[1]
    return Probe(impl, qt, body, (kt, vt), flops, "bfloat16", edges, view=view)


def _tiles4(x, transposed: bool):
    """(T, SN, DH) or transposed (T, DH, SN) storage as a (1, T, SN, DH) view."""
    t = x.shape[0]
    return x.view(1, *x.shape) if not transposed else x.view(1, t, *x.shape[1:]).transpose(2, 3)


def _product(x, y, z, *, transposed_out: bool, out_dtype):
    """O = round(X·Yᵀ)·Z per tile into (T, SN, C) or transposed (T, C, SN)."""
    _, t, m, _ = x.shape
    c = z.shape[3]
    out = torch.empty((t, c, m) if transposed_out else (t, m, c), dtype=out_dtype,
                      device=x.device)
    probes.tile_matmul(x, y, z, out_dtype=out_dtype, out=_tiles4(out, transposed_out))
    return out


def _tile_flops(tiles: int, m: int, depth: int, cols: int, second: bool) -> float:
    return tiles * (2 * m * m * depth + 2 * m * m * cols) if second else tiles * 2 * m * cols * depth


def _mm_probe(impl, d, dev, tg) -> Probe:
    q = torch.from_numpy(d["q"]).to(dev)
    units = q.shape[0]
    t = units // 4
    dt = BF16 if impl.endswith("bf16") else F32
    base = impl[3:].removesuffix("_bf16")
    nt, dot1 = "nt" in base, base.startswith("dot1")

    def body(x):
        xt = x.reshape(t, SN, DH).to(dt)
        x4 = _tiles4(xt, False)
        # nt: the rhs read from an XLA-transposed (T, DH, SN) copy
        y4 = _tiles4(layouts.transpose_tiles(xt), True) if nt else x4
        if dot1:
            o = probes.tile_matmul(x4, y4, cols=DH, out_dtype=F32)
        else:
            o = probes.tile_matmul(x4, y4, x4, out_dtype=F32)
        return o.reshape(units, N, DH)

    return Probe(impl, q, body, (), _tile_flops(t, SN, DH, DH, not dot1), dt_name(dt))


def dt_name(dtype) -> str:
    return str(dtype).split(".")[1]


def _floor_probe(impl, d, dev, tg) -> Probe:
    q = torch.from_numpy(d["q"]).to(dev)
    units = q.shape[0]
    dt = BF16 if impl.endswith("bf16") else F32
    base = impl[6:].removesuffix("_bf16")
    # the tile is read before "pure" comes off (bench_kernel.py:403-420):
    # floor_puresn256* runs the sn256 products on 128-row tiles
    sn = 256 if base == "sn256" else 128
    pure = "pure" in base
    base = base.removeprefix("pure")
    t = units // (sn // 32)
    tg = tg or (16 if sn == 128 else 8)
    out_dt = dt if pure else F32
    flops = 0.0

    if base in ("copy", "slab"):
        def kern(x3):
            return probes.stream_copy(x3, out_dt)
    elif base == "dot1slim":
        flops = _tile_flops(t, sn, DH, DH, False)

        def kern(x3):
            x4 = _tiles4(x3, False)
            return probes.tile_matmul(x4, x4, cols=DH, out_dtype=out_dt).view(t, sn, DH)
    elif base == "bigm":
        if t % tg:
            raise ValueError(f"floor_bigm needs whole groups: {t} tiles, TG {tg}")
        flops = _tile_flops(t, sn, DH, DH, False)

        def kern(x3):
            groups = x3.view(t // tg, tg, sn, DH)
            first = groups[:, :1].expand(-1, tg, -1, -1)  # the block's first tile
            return probes.tile_matmul(groups, first, cols=DH, out_dtype=out_dt).view(t, sn, DH)
    elif base == "sn256":
        flops = _tile_flops(t, sn, DH, DH, True)

        def kern(x3):
            x4 = _tiles4(x3, False)
            return probes.tile_matmul(x4, x4, x4, out_dtype=out_dt).view(t, sn, DH)
    else:
        raise ValueError(f"unknown floor probe {impl}")
    if pure:
        return Probe(impl, q.reshape(t, sn, DH).to(dt), kern, (), flops, dt_name(dt))
    return Probe(impl, q, lambda x: kern(x.reshape(t, sn, DH).to(dt)).reshape(units, N, DH),
                 (), flops, dt_name(dt))


def _layout_probe(impl, d, dev, tg) -> Probe:
    """tlay_*, mix_*, tmx_*, tmq_*, tsw_*, lp_fused_bf16."""
    q, k, v = (torch.from_numpy(d[n]).to(dev) for n in "qkv")
    units = q.shape[0]
    t = units // 4
    adj = window_adj()
    fused_flops = _win_flops(units, 2)
    family, base = impl.split("_", 1)
    calls = []

    def into(qv, kv, vv, out, scale=SCALE):
        _into(calls, qv, kv, vv, adj, out=out, scale=scale, stack=STACK)

    if family == "tlay":
        dt = BF16 if base.endswith("bf16") else F32
        base = base.removesuffix("_bf16")
        state = layouts.transpose_tiles(q.reshape(t, SN, DH)).to(dt)  # (T, DH, SN)
        if base == "copy":
            return Probe(impl, state, lambda x: probes.stream_copy(x, dt), (), 0.0, dt_name(dt))
        if base == "mm":
            def body(x):
                x4 = _tiles4(x, True)
                return _product(x4, x4, x4, transposed_out=True, out_dtype=dt)

            return Probe(impl, state, body, (), _tile_flops(t, SN, DH, DH, True), dt_name(dt))

        def body(x):  # no scale: q serves as q, k and v
            out = torch.empty_like(x)
            into(*[layouts.t_view(x)] * 3, layouts.t_view(out), 1.0)
            return out

        return Probe(impl, state, body, (), fused_flops, dt_name(dt), into_call=calls)

    if family in layouts.STREAM_SETS:
        qs, ks, vs = layouts.stream_set(family, q.to(BF16), k.to(BF16), v.to(BF16))
        forms = layouts.STREAM_SETS[family]
        chained = 1 if family == "mix" else 2  # mix chains on k, tmx/tmq on v
        streams = [qs, ks, vs]
        state = streams[chained]
        consts = tuple(s for i, s in enumerate(streams) if i != chained)

        def with_state(x):
            s = list(streams)
            s[chained] = x
            return s

        if base == "floor":
            group = dict(view=(t, 1, SN * DH), group_cols=SN * DH, out_dtype=BF16)
            if family == "mix":  # ((kᵀ + vᵀ) · Σ q) per tile
                def body(x):
                    return probes.stream_floor(x, qs, y=vs, **group)
            else:  # (vᵀ · (Σ q + Σ k)) per tile
                def body(x):
                    qq, kk, _ = with_state(x)
                    return probes.stream_floor(x, qq, b=kk, **group)
            return Probe(impl, state, body, consts, 0.0, "bfloat16")
        if base in ("mm", "bmm"):
            def body(x):
                ops = [_tiles4(s, f == "t") for s, f in zip(with_state(x), forms)]
                return _product(*ops, transposed_out=True, out_dtype=BF16)

            return Probe(impl, state, body, consts, _tile_flops(t, SN, DH, DH, True), "bfloat16")

        def body(x):  # fused, bfused
            out = torch.empty((t, DH, SN), dtype=BF16, device=x.device)
            into(*layouts.stream_set_views(family, *with_state(x)), layouts.t_view(out))
            return out

        return Probe(impl, state, body, consts, fused_flops, "bfloat16", into_call=calls)

    if family == "tsw":
        th = t // HEADS
        tg = tg or 16
        qw, kw, vw = (layouts.widen(x.reshape(t, SN, DH).to(BF16), HEADS) for x in (q, k, v))
        if base == "floor":
            if th % tg:
                raise ValueError(f"tsw_floor needs whole blocks: {th} tiles a head, TG {tg}")

            def body(x):  # one sum over each (DH, TG·SN) block
                return probes.stream_floor(x, qw, b=kw, view=(HEADS, DH, th * SN),
                                           group_cols=tg * SN, out_dtype=BF16)

            return Probe(impl, vw, body, (qw, kw), 0.0, "bfloat16")

        qv, kv = (layouts.wide_view(x, SN) for x in (qw, kw))

        def body(x):  # fused, bstack, 1_fused
            out = torch.empty_like(x)
            into(qv, kv, layouts.wide_view(x, SN), layouts.wide_view(out, SN))
            return out

        return Probe(impl, vw, body, (qw, kw), fused_flops, "bfloat16", into_call=calls)

    if impl == "lp_fused_bf16":
        qp, kp, vp = (layouts.pack2(x.reshape(t, SN, DH).to(BF16)) for x in (q, k, v))

        kv = (layouts.pair_view(kp), layouts.pair_view(vp))

        def body(x):
            out = torch.empty_like(x)
            into(layouts.pair_view(x), *kv, layouts.pair_view(out))
            return out

        return Probe(impl, qp, body, (kp, vp), fused_flops, "bfloat16", into_call=calls)
    raise ValueError(f"unknown layout probe {impl}")


def _stream_probe(impl, d, dev, tg) -> Probe:
    """dmaflr_*, xrelay_*, xstrided_*."""
    if impl.startswith("dmaflr_"):
        q, k, v = (torch.from_numpy(d[n]).to(dev).reshape(-1, SN, DH).to(BF16) for n in "qkv")
        base = impl[7:]
        if base == "hbm":
            return Probe(impl, q, lambda x: probes.stream_copy(x, BF16), (), 0.0, "bfloat16")
        if base == "3stream":
            return Probe(impl, q, lambda x: probes.stream_sum3(x, k, v), (k, v), 0.0, "bfloat16")
        packed = torch.stack([q, k, v])  # one (3, T, SN, DH) stream
        return Probe(impl, q, lambda x: probes.stream_sum3(packed[0], packed[1], packed[2]),
                     (packed,), 0.0, "bfloat16", reads_state=False)
    x0 = torch.from_numpy(d["x0"]).to(dev)
    gg, _, hh, _ = x0.shape
    if impl.startswith("xrelay_"):
        dt = BF16 if impl.endswith("bf16") else F32
        base = impl[7:].removesuffix("_bf16").removesuffix("_f32")
        x0 = x0.to(dt)
        if base == "copy":  # the same-bytes add of the XLA probe, a yardstick
            return Probe(impl, x0.reshape(gg * hh, N, DH), lambda x: x + 1, (), 0.0, dt_name(dt))
        if base in ("s0", "s2"):  # (g, n, h, dh) → (g·h, n, dh), +1, and back
            def body(x):
                y = probes.relayout(x, (0, 2, 1, 3)).reshape(gg * hh, N, DH) + 1
                return probes.relayout(y.reshape(gg, hh, N, DH), (0, 2, 1, 3))
        else:  # s0pallas, s2pallas: (g, n, h, dh) → (g, h, n, dh) and back
            def body(x):
                return probes.relayout(probes.relayout(x, (0, 2, 1, 3)), (0, 2, 1, 3))
        return Probe(impl, x0, body, (), 0.0, dt_name(dt))
    x0 = x0.to(BF16)
    if impl == "xstrided_ref_bf16":
        flat = probes.relayout(x0, (0, 2, 1, 3)).reshape(gg * hh, N, DH)
        return Probe(impl, flat, lambda x: probes.stream_copy(x, BF16), (), 0.0, "bfloat16")
    # xstrided_s0/s2: (g, n, h, dh) → (h·g, n, dh); the chained input is a dummy
    state = torch.zeros((gg * hh, N, DH), dtype=BF16, device=dev)
    return Probe(impl, state,
                 lambda x: probes.relayout(x0, (2, 0, 1, 3)).reshape(gg * hh, N, DH),
                 (x0,), 0.0, "bfloat16", reads_state=False)


def _matmul_probe(impl, d, dev, tg) -> Probe:
    q = torch.from_numpy(d["q"]).to(dev)
    units = q.shape[0]
    t = units // 4
    pad = impl == "matmul_k128"
    depth = 128 if pad else DH
    dt = BF16 if impl.endswith("bf16") else F32

    def body(x):
        x3 = x.reshape(t, SN, DH)
        if pad:
            x3 = F.pad(x3, (0, depth - DH))
        x4 = _tiles4(x3.to(dt), False)
        o = probes.tile_matmul(x4, x4, x4, out_dtype=F32).view(t, SN, depth)
        return o[:, :, :DH].reshape(units, N, DH)

    return Probe(impl, q, body, (), _tile_flops(t, SN, depth, depth, True), dt_name(dt))


def _softmax_probe(impl, d, dev, tg) -> Probe:
    """S = [q_g | q_g] per 128-token supertile, a = masked_softmax(S)[:, :64]:
    only the diagonal blocks of units 0 and 1 reach a[:, :64]; every other
    entry there is a cross-unit entry, exactly 0 after the f32 softmax."""
    q = torch.from_numpy(d["q"]).to(dev)
    units = q.shape[0]
    t = units // 4
    adj = window_adj()

    def body(x):
        return hybrid_mod.softmax_blocks(x.reshape(t, SN, DH), adj).reshape(units, N, DH)

    return Probe(impl, q, body)


def _banded_probe(impl, d, dev, tg) -> Probe:
    b, h, f, v, dh = BANDED_SHAPE
    band = banded_band()
    dt = BF16 if impl.endswith("bf16") else F32
    odt = dt if impl.endswith("bf16") else F32
    planes = (b * h, f * v, dh)
    qb, kb, vb = (torch.from_numpy(d["b" + n]).to(dev) for n in "qkv")
    kp, vp = (x.reshape(planes).to(dt) for x in (kb, vb))
    e = band == 0
    edges_band = b * h * (f * int(e[1].sum()) + (f - 1) * int(e[0].sum() + e[2].sum()))
    nnz = b * h * f * v * 3 * v
    bwd = "bwd" in impl
    flops = edges_band * 2 * dh * (7 if bwd else 2)

    def attend(x, out_dtype=F32):
        return banded_mod.banded_attention(x, kp, vp, band, scale=BANDED_SCALE,
                                           out_dtype=out_dtype)

    if "packed_mm" in impl:  # K10
        tiles = planes[1] // (banded_mod.packed_frames_per_tile(v) * v)
        rows = planes[1] // tiles
        return Probe(impl, qb.reshape(planes),
                     lambda x: banded_mod.banded_packed_mm(
                         x.to(dt), kp, vp, joints=v, out_dtype=odt).float(),
                     (kp, vp), b * h * tiles * 4.0 * rows * rows * dh, dt_name(dt), nnz)
    if "packedpre" in impl:  # (G·H, dh, F·Vp) planes in, the same out
        kq, vq = (layouts.pack_plane(x.to(dt), BANDED_VP) for x in (kb, vb))

        def to_planes(x):
            return layouts.unpack_plane(x, b, h, f, v, dh, BANDED_VP).reshape(planes)

        def body(x):
            o = banded_mod.banded_attention(to_planes(x), to_planes(kq), to_planes(vq), band,
                                            scale=BANDED_SCALE, out_dtype=dt)
            return layouts.pack_plane(o.reshape(b, h, f, v, dh), BANDED_VP)

        return Probe(impl, layouts.pack_plane(qb.to(dt), BANDED_VP), body, (kq, vq), flops,
                     dt_name(dt), nnz)
    out_dtype = odt if "packed" in impl else F32
    if not bwd:
        return Probe(impl, qb.reshape(planes), lambda x: attend(x.to(dt), out_dtype).float(),
                     (kp, vp), flops, dt_name(dt), nnz)

    def loss(leaf):
        o = attend(leaf.to(dt), out_dtype)
        return o, (o.float() ** 2).sum()

    return Probe(impl, qb.reshape(planes), lambda x: _grad_of(loss, x)[1].float(), (kp, vp),
                 flops, dt_name(dt), nnz)


def _ell_probe(impl, d, dev, tg) -> Probe:
    """ell_bf16, ell_bwd, ell_bwd_bf16: the edge-space attention on the
    BODY29 topology over (B, 8, 192·29, 16); the backward entries give dq
    of sum(o²) (``bench_kernel.py:1373-1426``)."""
    _, h, f, v, dh = BANDED_SHAPE
    col, valid = ell_tables(f, v)
    dt = BF16 if impl.endswith("bf16") else F32
    q, k, vv = (torch.from_numpy(d["b" + n]).to(dev).reshape(-1, h, f * v, dh).to(dt)
                for n in "qkv")
    colt, valt = torch.from_numpy(col).long().to(dev), torch.from_numpy(valid).to(dev)
    edges = q.shape[0] * h * int(valid.sum())
    bwd = "bwd" in impl

    def attend(x):
        return ell_graph_attention(x, k, vv, colt, valt, scale=BANDED_SCALE)

    if bwd:
        def loss(leaf):
            o = attend(leaf)
            return o, (o**2).sum()

        body = lambda x: _grad_of(loss, x)[1].to(dt)  # noqa: E731
    else:
        body = lambda x: attend(x).to(dt)  # noqa: E731
    # two products of 2·dh operations an edge forward; dA and dq backward,
    # all in f32 (a bf16 input's products are exact there)
    return Probe(impl, q, body, (k, vv), edges * 2.0 * dh * (4 if bwd else 2), "float32",
                 edges)


def _yardstick_probe(impl, d, dev, tg) -> Probe:
    """calib_*, hybrid*, stacked*, tsw1_fused, and bare ell."""
    q, k, v = (torch.from_numpy(d[n]).to(dev) for n in "qkv")
    units = q.shape[0]
    adj = window_adj()
    dt = BF16 if impl.endswith("bf16") else F32
    if impl.startswith("calib_big"):
        m = torch.from_numpy(d["m"]).to(dev).to(dt)
        return Probe(impl, m, lambda x: torch.matmul(x, m), (m,), 2.0 * 2048**3, dt_name(dt))
    if impl.startswith("calib_shape"):
        ks2 = torch.from_numpy(d["ks2"]).to(dev).to(dt)
        return Probe(impl, ks2, lambda x: calib_shape(x, ks2), (ks2,),
                     ks2.shape[0] * 4.0 * 128 * 128 * 64, dt_name(dt))
    kk, vv = k.to(dt), v.to(dt)
    edges = units * int((adj != 0).sum())
    kw = dict(scale=SCALE, stack=STACK)
    if impl.startswith("hybrid"):
        def att(x):
            return hybrid_mod.hybrid_window_attention(x.to(dt), kk, vv, adj, **kw)

        if "bwd" in impl:
            def loss(leaf):
                o = att(leaf)
                return o, (o * o).sum()

            return Probe(impl, q, lambda x: _grad_of(loss, x)[1].float(), (kk, vv),
                         _win_flops(units, 7), dt_name(dt), edges)
        return Probe(impl, q, lambda x: att(x).float(), (kk, vv), _win_flops(units, 2),
                     dt_name(dt), edges)
    # stacked, stacked_bf16, tsw1_fused, ell: the plain attention
    return Probe(impl, q, lambda x: stacked_window_attention(x.to(dt), kk, vv, adj, **kw),
                 (kk, vv), _win_flops(units, 2), dt_name(dt), edges, queues_ahead=False)


def calib_shape(x, ks2):
    """The kernel's batched shapes through ``torch.bmm``: (T,128,64)·(T,64,128)
    then (T,128,128)·(T,128,64), f32 sums, the operands' type out."""
    return torch.bmm(torch.bmm(x, ks2.transpose(1, 2)), ks2)


_BUILDERS = (
    (("pallas", "pair_tscore"), lambda i, d, dev, tg: _window_probe(i, d, dev)),
    (("mm_",), _mm_probe),
    (("floor_",), _floor_probe),
    (("tlay_", "mix_", "tmx_", "tmq_", "tsw_", "lp_"), _layout_probe),
    (("dmaflr_", "xrelay_", "xstrided_"), _stream_probe),
    (("matmul_",), _matmul_probe),
    (("softmax_only",), _softmax_probe),
    (("banded_",), _banded_probe),
    (("ell_",), _ell_probe),
    (("calib_", "hybrid", "stacked", "tsw1_", "ell"), _yardstick_probe),
)


def inputs(impl: str, units: int = UNITS, *, device="cuda", tg: int | None = None) -> Probe:
    """The probe of ``impl`` on ``device`` (the card unless "cpu" is asked
    for; without a card, "cuda" raises): its chained input in the probe's
    layout (``state``, equal to what ``bench_kernel.py`` chains), the call,
    and the call's work. ``tg``: the TPU block's tile count where the
    function depends on it (floor_bigm, tsw_floor; default 16, 8 for
    256-row tiles)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the kernel bench's inputs live on the card "
                           '(pass device="cpu" for host runs)')
    d = draws(impl, units)
    for prefixes, build in _BUILDERS:
        if impl.startswith(prefixes):
            return build(impl, d, dev, tg)
    raise AssertionError(impl)


def _counters() -> dict:
    return {window_mod.KERNEL: window_mod.window_attention.launches,
            window_mod.KERNEL_BWD: window_mod.window_attention_bwd.launches,
            window_mod.KERNEL_LAYOUT: window_mod.window_attention_into.launches,
            window_mod.KERNEL_LAYOUT_BWD: window_mod.window_attention_bwd_into.launches,
            hybrid_mod.KERNEL_BLOCKS: hybrid_mod.softmax_blocks.launches,
            banded_mod.KERNEL: banded_mod.banded_attention.launches,
            banded_mod.KERNEL_BWD: banded_mod.banded_attention_bwd.launches,
            hybrid_mod.KERNEL: hybrid_mod.masked_softmax.launches,
            hybrid_mod.KERNEL_BWD: hybrid_mod.masked_softmax_bwd.launches,
            **probes.LAUNCHES}


def reset_launches() -> None:
    """Every kernel's launch count to 0."""
    window_mod.window_attention.launches = window_mod.window_attention_bwd.launches = 0
    window_mod.window_attention_into.launches = hybrid_mod.softmax_blocks.launches = 0
    window_mod.window_attention_bwd_into.launches = 0
    banded_mod.banded_attention.launches = banded_mod.banded_attention_bwd.launches = 0
    hybrid_mod.masked_softmax.launches = hybrid_mod.masked_softmax_bwd.launches = 0
    probes.reset_launches()


def launches() -> dict:
    """The launch counts of the kernels launched since the last reset."""
    return {name: n for name, n in _counters().items() if n}


def launches_of(fn):
    """(fn(), the launches of each kernel it launched)."""
    before = _counters()
    out = fn()
    return out, {k: n - before[k] for k, n in _counters().items() if n > before[k]}


def device_info(device: str) -> dict:
    if device != "cuda":
        return {"platform": "cpu"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "nvidia_smi": smi.stdout.strip().splitlines()[0]}


def _timed(fn, arg, device, repeats, inner) -> list[float]:
    if device == "cuda":
        return profiling.timeit(fn, arg, warmup=3, repeats=repeats, inner=inner)
    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(arg)
        samples.append(time.perf_counter() - t0)
    return samples


def measure(impl: str, units: int = UNITS, *, device: str = "cuda", tg: int | None = None,
            repeats: int = 5, inner: int = 10) -> dict:
    """The bench line of ``impl`` (see the module docstring). On "cuda" the
    times are CUDA-event medians; on "cpu" host times of single calls (for
    tests: not a device measurement)."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the kernel bench measures on the card")
    p = inputs(impl, units, device=device, tg=tg)
    with torch.no_grad():
        out, counts = launches_of(lambda: p.body(p.state))
        if device == "cuda":
            torch.cuda.synchronize()
        nbytes = (p.state.nbytes if p.reads_state else 0) + sum(c.nbytes for c in p.consts) \
            + out.nbytes
        if impl == "pair_tscore_bf16":
            return _pair_record(p, device, repeats, inner, counts, nbytes)
        per_call = _timed(p.body, p.state, device, repeats, 1 if device == "cpu" else inner)
    bound_s, bound_by = profiling.bound(nbytes, p.flops, p.dtype)
    rec = {"impl": impl}
    if p.edges is not None:
        rec["edges"] = p.edges
    rec.update(profiling.repeat_stats(per_call))
    if impl.startswith(("banded_", "ell_")):
        rec["edges_per_sec"] = p.edges / (rec["time_us"] / 1e6)
    if impl.startswith("calib_"):
        rec["tflops"] = p.flops / (rec["time_us"] / 1e6) / 1e12
    if device == "cuda":  # the card's time, without the host's launch gaps
        rec["device_us"] = None  # where a call waits on the card, events are its time
        if p.queues_ahead:
            with torch.no_grad():
                rec["device_us"] = profiling.device_seconds(p.body, p.state, calls=inner,
                                                            repeats=repeats) * 1e6
    rec.update(bound_us=bound_s * 1e6, bound_by=bound_by, bytes=nbytes, flops=p.flops,
               launches=counts, clock="cuda_events" if device == "cuda" else "host",
               device=device_info(device))
    return rec


def _pair_record(p, device, repeats, inner, counts, nbytes) -> dict:
    """K1 (bf16, prepacked supertiles) and its ``torch.bmm`` shape
    calibration timed in turns, ratio per pair (``bench_kernel.py:110-185``)."""
    import statistics

    ks2 = torch.from_numpy(draws("pair_tscore_bf16", p.state.shape[0] * 4)["ks2"]).to(
        p.state.device).to(BF16)
    pairs = []
    for _ in range(repeats):
        tk = _timed(p.body, p.state, device, 1, inner)[0]
        tc = _timed(lambda x: calib_shape(x, ks2), ks2, device, 1, inner)[0]
        pairs.append((tk, tc))
    ratios = sorted(tc / tk for tk, tc in pairs)
    rec = {"impl": p.impl, "edges": p.edges}
    rec.update(profiling.repeat_stats([tk for tk, _ in pairs]))
    bound_s, bound_by = profiling.bound(nbytes, p.flops, p.dtype)
    rec.update(calib_time_us=statistics.median(tc for _, tc in pairs) * 1e6,
               ratio_vs_calib=round(statistics.median(ratios), 4), ratio_min=round(ratios[0], 4),
               ratio_max=round(ratios[-1], 4), bound_us=bound_s * 1e6, bound_by=bound_by,
               bytes=nbytes, flops=p.flops, launches=counts,
               clock="cuda_events" if device == "cuda" else "host", device=device_info(device))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("impl", choices=IMPLS, metavar="impl")
    ap.add_argument("units", type=int, nargs="?", default=UNITS)
    ap.add_argument("--tg", type=int, default=None,
                    help="tiles of a TPU block where the probe's function depends on it")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench.kernel: no CUDA device (pass --device cpu for host times)", file=sys.stderr)
        return 1
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps(measure(args.impl, args.units, device=args.device, tg=args.tg,
                             repeats=args.repeats)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
