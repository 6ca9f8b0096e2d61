"""Window attention on views of the TPU layouts, and the softmax probe's
function, on the CPU.

- Each ``layouts.*_view``, reshaped to (U, N, dh), equals the relayout map
  of its layout bit for bit; ``unit_view`` describes it as the layout
  kernel reads it (form, strides, unit enumeration).
- ``window_attention_into``'s CPU path (its plain version) equals
  ``window_attention`` on the token-major units mapped back, bit for bit, in
  f32 and bf16, single and dual mask, with pruning.
- It matches the JAX layout twins (``pallas_window_attention`` in interpret
  mode on the ``t``/``tscore``/``wide`` layouts) at the bar of
  ``test_torch_port_attention.py::test_forward_twins_match_port`` (f32
  atol 1e-5).
- ``softmax_blocks``'s CPU path equals the gather + masked softmax + scatter
  composition the bench ran before, bit for bit.
- What the wrappers refuse raises ``ValueError``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sl_hwgat_tpu import graphs
from sl_hwgat_tpu.ops.pallas_attention import pallas_window_attention

from sl_hwgat_tpu_torch.ops import hybrid_attention, layouts
from sl_hwgat_tpu_torch.ops.window_attention import (
    unit_view,
    window_attention,
    window_attention_into,
)

ADJ32 = graphs.windowed_block_adj(2)[0]
N, SN, STACK, HEADS = 32, 128, 4, 2


def _draw(units, dh, seed, dtype=torch.float32):
    r = np.random.default_rng(seed)
    return [torch.from_numpy(r.normal(size=(units, N, dh)).astype(np.float32)).to(dtype)
            for _ in range(3)]


def _tail(seed):
    r = np.random.default_rng(seed)
    return (ADJ32 * (r.random(ADJ32.shape) > 0.3)).astype(np.float32)


# layout: (token-major units → layout storage, storage → unit view)
LAYOUTS = {
    "rows": (lambda u: u.reshape(-1, SN, u.shape[-1]), layouts.rows_view),
    "t": (lambda u: layouts.units_to_t(u, STACK), layouts.t_view),
    "t_units": (lambda u: layouts.transpose_tiles(u), layouts.t_view),
    "wide": (lambda u: layouts.widen(u.reshape(-1, SN, u.shape[-1]), HEADS),
             lambda x: layouts.wide_view(x, SN)),
    "pairs": (lambda u: layouts.pack2(u.reshape(-1, SN, u.shape[-1])), layouts.pair_view),
}
# the relayout maps back to token-major units
TO_UNITS = {
    "rows": lambda x: x.reshape(-1, N, x.shape[-1]),
    "t": lambda x: layouts.t_to_units(x, STACK),
    "t_units": lambda x: layouts.transpose_tiles(x),
    "wide": lambda x: layouts.unwiden(x, SN).reshape(-1, N, x.shape[1]),
    "pairs": lambda x: layouts.unpack2(x).reshape(-1, N, x.shape[-1] // 2),
}


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("layout", [*LAYOUTS, "mix", "tmx", "tmq"])
def test_views_equal_relayout_maps(layout, dh):
    q, k, v = _draw(64, dh, seed=1)
    if layout in layouts.STREAM_SETS:
        streams = layouts.stream_set(layout, q, k, v)
        got = layouts.stream_set_views(layout, *streams)
        want = layouts.stream_set_to_units(layout, *streams)
        for g, w in zip(got, want):
            assert torch.equal(g.reshape(-1, N, dh), w)
        return
    to_layout, view = LAYOUTS[layout]
    x = to_layout(q)
    assert view(x).data_ptr() == x.data_ptr()  # a view, no copy
    assert torch.equal(view(x).reshape(-1, N, dh), TO_UNITS[layout](x))
    assert torch.equal(view(x).reshape(-1, N, dh), q)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_unit_view_describes_the_units(layout):
    """The layout kernel's description of a view (form, unit strides, row or
    column stride) finds every element of every unit: the storage holds its
    own offsets."""
    dh = 64
    to_layout, view = LAYOUTS[layout]
    storage = to_layout(torch.zeros(64, N, dh, dtype=torch.float64))
    storage.view(-1).copy_(torch.arange(storage.numel(), dtype=torch.float64))
    units = view(storage).reshape(-1, N, dh)
    form, (sa, sb, ss, ld, nb, ns) = unit_view("x", view(storage), N, dh)
    assert form == (1 if layout in ("t", "t_units", "wide") else 0)
    i, d = torch.meshgrid(torch.arange(N), torch.arange(dh), indexing="ij")
    inner = i * ld + d if form == 0 else i + d * ld
    for u in range(units.shape[0]):
        r = u // ns
        base = r // nb * sa + r % nb * sb + (u - r * ns) * ss
        assert torch.equal(units[u], (base + inner).double())


# the layouts above, and the mixed probes' streams (q, k rows; v, o transposed)
INTO_CASES = ["t", "t_units", "wide", "pairs", "mix", "tmx"]


@pytest.mark.parametrize("mask", ["single", "dual", "prune"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", INTO_CASES)
def test_into_equals_window_attention(layout, dtype, mask):
    units, dh = (128, 32) if layout in ("t", "mix") else (64, 64)
    q, k, v = _draw(units, dh, seed=2, dtype=dtype)
    kw = dict(scale=dh**-0.5, stack=STACK)
    if mask == "dual":
        kw.update(tail_adj=_tail(3), units_per_group=8, groups=3)
    if mask == "prune":
        kw.update(prune_u=0.3)
    want = window_attention(q, k, v, ADJ32, out_dtype=dtype, **kw)
    if layout in ("mix", "tmx"):
        views = layouts.stream_set_views(layout, *layouts.stream_set(layout, q, k, v))
        out = torch.empty((units // STACK, dh, SN), dtype=dtype)
        got = window_attention_into(*views, ADJ32, out=layouts.t_view(out), **kw)
        back = layouts.t_to_units(out, STACK)
    else:
        to_layout, view = LAYOUTS[layout]
        out = torch.empty_like(to_layout(q))
        got = window_attention_into(*(view(to_layout(x)) for x in (q, k, v)), ADJ32,
                                    out=view(out), **kw)
        back = TO_UNITS[layout](out)
    assert got.data_ptr() == out.data_ptr()
    assert back.dtype == dtype and torch.equal(back, want)


# (the JAX twin's transposed mode, PALLAS_ATTN_BATCHED)
TWINS = {
    "fwd_kernel_t": (True, False),
    "fwd_kernel_ts": ("tscore", False),
    "fwd_kernel_ts_batched": ("tscore", True),
    "fwd_kernel_wide": ("wide", False),
    "fwd_kernel_wide_batched": ("wide", True),
}


@pytest.mark.parametrize("twin", list(TWINS))
def test_into_matches_jax_layout_twins(twin, monkeypatch):
    transposed, batched = TWINS[twin]
    if batched:
        monkeypatch.setenv("PALLAS_ATTN_BATCHED", "1")
    h, g, dh = 2, 12, 16
    r = np.random.default_rng(9)
    q, k, v = (r.normal(size=(h * g, N, dh)).astype(np.float32) for _ in range(3))
    kw = dict(scale=0.25, stack=STACK, prune_u=0.3)
    if not batched:  # the batched forms are single-mask only
        kw.update(tail_adj=_tail(10), units_per_group=4, groups=3)
    if transposed == "wide":
        def to_layout(x):  # (H, DH, TH, S·N)
            return x.reshape(h, g // STACK, STACK, N, dh).transpose(0, 4, 1, 2, 3).reshape(
                h, dh, g // STACK, STACK * N)

        def view(x):
            return layouts.wide_view(x.reshape(h, dh, -1), STACK * N)
    else:
        def to_layout(x):  # (U, dh, N)
            return x.transpose(0, 2, 1)

        view = layouts.t_view
    want = pallas_window_attention(*(jnp.asarray(to_layout(x)) for x in (q, k, v)), ADJ32,
                                   transposed=transposed, **kw)
    out = torch.empty(to_layout(q).shape)
    window_attention_into(*(view(torch.from_numpy(np.ascontiguousarray(to_layout(x))))
                            for x in (q, k, v)), ADJ32, out=view(out), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)


def test_softmax_blocks_equals_the_composition():
    t = 24
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(t, SN, 64)).astype(np.float32))
    blocks = torch.stack([x[:, :N, :N], x[:, N:2 * N, N:2 * N]], 1).reshape(2 * t, N, N)
    p = hybrid_attention.masked_softmax(blocks, ADJ32, stack=2).view(t, 2, N, N)
    want = torch.zeros_like(x)
    want[:, :N, :N] = p[:, 0]
    want[:, N:2 * N, N:2 * N] = p[:, 1]
    assert torch.equal(hybrid_attention.softmax_blocks(x, ADJ32), want)


def test_wrappers_reject_what_the_kernels_cannot_take():
    x = torch.zeros(8, 64, SN)
    v = layouts.t_view(x)
    with pytest.raises(ValueError, match="neither its tokens nor its features"):
        unit_view("q", torch.zeros(4, N, 64)[:, :, ::2], N, 32)
    with pytest.raises(ValueError, match="16-byte aligned"):  # the start
        unit_view("q", layouts.t_view(torch.zeros(8 * 64 * SN + 1)[1:].view(8, 64, SN)), N, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):  # rows 65 floats apart
        unit_view("q", torch.zeros(8, N, 65)[..., :64], N, 64)
    with pytest.raises(ValueError, match="leading axes"):
        unit_view("q", torch.zeros(2, 3, 2, 3, 2, N, 64)[:, ::2, :, ::2], N, 64)
    with pytest.raises(ValueError, match=r"must be \(…, 32, 64\)"):
        unit_view("q", torch.zeros(4, N, 32), N, 64)
    with pytest.raises(ValueError, match="share one"):
        window_attention_into(v, v, v[:4], ADJ32, out=v, scale=0.25)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        m = v.to("meta")
        window_attention_into(m, m, m, ADJ32, out=m, scale=0.25)
    with pytest.raises(ValueError, match="float32 tiles"):
        hybrid_attention.softmax_blocks(torch.zeros(4, 32, 64), ADJ32)
    with pytest.raises(ValueError, match="float32 tiles"):
        hybrid_attention.softmax_blocks(torch.zeros(4, SN, 64, dtype=torch.bfloat16), ADJ32)
