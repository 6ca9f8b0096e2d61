"""Window attention's backward on views of the TPU layouts, on the CPU.

- ``window_attention_bwd_into``'s CPU path (its plain version) on the
  ``t_view``/``wide_view`` views of the transposed units, the tscore
  supertiles and the widened planes equals ``plain_window_attention_bwd`` on
  the token-major units bit for bit, in f32 and bf16, under a single mask,
  a dual mask with pruning and an explicit ``sel``.
- It matches the JAX backward twins (``jax.vjp`` of
  ``pallas_window_attention`` in interpret mode on the ``t``/``tscore``/
  ``wide`` layouts, the batched forms with ``PALLAS_ATTN_BATCHED=1``, which
  are single-mask only) at the bars of ``test_torch_port_backward.py``: f32
  atol 2e-5; bf16 atol 4e-3 and rtol 1e-2 (one bf16 ulp is 2^-8 relative).
- ``layout_window_attention``'s gradient (the layout Function: forward and
  backward layout wrappers) equals torch autograd through the plain path.
- The kernel bench's ``*bwd*`` entries run no relayout in their timed call
  and equal the token-major composition (plain attention, torch autograd).
- What ``window_attention_bwd_into`` refuses raises ``ValueError``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sl_hwgat_tpu import graphs
from sl_hwgat_tpu.ops.pallas_attention import pallas_window_attention

from sl_hwgat_tpu_torch.bench import kernel as port_bench
from sl_hwgat_tpu_torch.ops import layouts, probes
from sl_hwgat_tpu_torch.ops.window_attention import (
    layout_window_attention,
    plain_window_attention,
    plain_window_attention_bwd,
    window_attention_bwd_into,
)

ADJ32 = graphs.windowed_block_adj(2)[0]
H, G, N, DH, STACK = 2, 12, 32, 16, 4  # 2 heads x 12 groups of 32 tokens, units h-major
F32 = dict(atol=2e-5, rtol=0)
BF16 = dict(atol=4e-3, rtol=1e-2)


def _inputs(seed, count=4):
    r = np.random.default_rng(seed)
    return [r.normal(size=(H * G, N, DH)).astype(np.float32) for _ in range(count)]


def _tail(seed):
    r = np.random.default_rng(seed)
    return (ADJ32 * (r.random(ADJ32.shape) > 0.3)).astype(np.float32)


def _wide(x):
    """(U, N, dh) units → the JAX wide layout (H, dh, TH, S·N)."""
    return x.reshape(H, G // STACK, STACK, N, DH).transpose(0, 4, 1, 2, 3).reshape(
        H, DH, G // STACK, STACK * N)


# layout: (token-major numpy units → layout storage, storage → unit view)
LAYOUTS = {
    "t": (lambda x: x.transpose(0, 2, 1), layouts.t_view),
    "tscore": (lambda x: x.reshape(-1, STACK, N, DH).transpose(0, 3, 1, 2).reshape(-1, DH, STACK * N),
               layouts.t_view),
    "wide": (_wide, lambda x: layouts.wide_view(x.reshape(H, DH, -1), STACK * N)),
}
MASKS = {
    "single": {},
    "dual_prune": dict(tail_adj=_tail(3), units_per_group=4, groups=3, prune_u=0.3),
    "sel": dict(tail_adj=_tail(4), units_per_group=4, groups=3,
                sel=torch.tensor([1, 0, 0, 1, 1, 0], dtype=torch.int32)),
}


def _storages(to_layout, xs, dtype):
    return [torch.from_numpy(np.ascontiguousarray(to_layout(x))).to(dtype) for x in xs]


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_bwd_into_equals_the_plain_backward(layout, dtype, mask):
    to_layout, view = LAYOUTS[layout]
    xs = _inputs(5)
    kw = dict(scale=0.25, stack=STACK, **MASKS[mask])
    want = plain_window_attention_bwd(*(torch.from_numpy(x).to(dtype) for x in xs), ADJ32, **kw)
    q, k, v, do = _storages(to_layout, xs, dtype)
    grads = [torch.empty_like(q) for _ in range(3)]
    got = window_attention_bwd_into(view(q), view(k), view(v), view(do), ADJ32,
                                    dq=view(grads[0]), dk=view(grads[1]), dv=view(grads[2]), **kw)
    for name, g, out, w in zip(("dq", "dk", "dv"), got, grads, want):
        assert g.data_ptr() == out.data_ptr(), name
        assert g.dtype == dtype and torch.equal(g.reshape(-1, N, DH), w), name


def _jax_vjp(q, k, v, do, dtype=jnp.float32, **kw):
    def f(qq, kk, vv):
        return pallas_window_attention(qq, kk, vv, ADJ32, **kw)

    out, vjp = jax.vjp(f, *(jnp.asarray(x, dtype) for x in (q, k, v)))
    return [np.asarray(g).astype(np.float32) for g in vjp(jnp.asarray(do, out.dtype))]


# K2 layout twin → (the JAX twin's transposed mode, PALLAS_ATTN_BATCHED, the
# port's layout)
TWINS = {
    "bwd_kernel_t": (True, False, "t"),
    "bwd_kernel_ts": ("tscore", False, "t"),
    "bwd_kernel_ts_batched": ("tscore", True, "t"),
    "bwd_kernel_wide": ("wide", False, "wide"),
    "bwd_kernel_wide_batched": ("wide", True, "wide"),
}


@pytest.mark.parametrize("twin", list(TWINS))
def test_bwd_into_matches_jax_backward_twins(twin, monkeypatch):
    transposed, batched, layout = TWINS[twin]
    if batched:
        monkeypatch.setenv("PALLAS_ATTN_BATCHED", "1")
    to_layout, view = LAYOUTS[layout]
    xs = _inputs(9)
    kw = dict(scale=0.25, stack=STACK, prune_u=0.3)
    if not batched:  # the batched forms are single-mask only
        kw.update(tail_adj=_tail(10), units_per_group=4, groups=3)
    want = _jax_vjp(*(to_layout(x) for x in xs), transposed=transposed, **kw)
    q, k, v, do = _storages(to_layout, xs, torch.float32)
    grads = [torch.empty_like(q) for _ in range(3)]
    window_attention_bwd_into(view(q), view(k), view(v), view(do), ADJ32, dq=view(grads[0]),
                              dk=view(grads[1]), dv=view(grads[2]), **kw)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **F32)


def test_bwd_into_matches_the_jax_transposed_twin_in_bf16():
    """The model's bf16 mode: bf16 operands, output and output gradient."""
    to_layout, view = LAYOUTS["t"]
    q, k, v, do = _inputs(11)
    v = (v * 0.2).astype(np.float32)
    xs = (q, k, v, do)
    kw = dict(scale=0.25, stack=STACK, tail_adj=_tail(12), units_per_group=4, groups=3)
    want = _jax_vjp(*(to_layout(x) for x in xs), dtype=jnp.bfloat16, transposed=True,
                    out_dtype=jnp.bfloat16, **kw)
    qs, ks, vs, dos = _storages(to_layout, xs, torch.bfloat16)
    grads = [torch.empty_like(qs) for _ in range(3)]
    window_attention_bwd_into(view(qs), view(ks), view(vs), view(dos), ADJ32, dq=view(grads[0]),
                              dk=view(grads[1]), dv=view(grads[2]), **kw)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        np.testing.assert_allclose(g.float().numpy(), w, err_msg=name, **BF16)


@pytest.mark.parametrize("mask", ["single", "dual_prune"])
@pytest.mark.parametrize("layout", ["t", "wide"])
def test_layout_function_gradient_equals_torch_autograd(layout, mask):
    to_layout, view = LAYOUTS[layout]
    xs = _inputs(13)
    kw = dict(scale=0.25, stack=STACK, **MASKS[mask])
    leaves = [x.requires_grad_() for x in _storages(to_layout, xs[:3], torch.float32)]
    do = _storages(to_layout, xs[3:], torch.float32)[0]
    o = layout_window_attention(*leaves, ADJ32, view=view, **kw)
    assert o.shape == leaves[0].shape
    o.backward(do)
    units = [torch.from_numpy(x).requires_grad_() for x in xs[:3]]
    want = plain_window_attention(*units, ADJ32, **kw)
    assert torch.equal(view(o.detach()).reshape(-1, N, DH), want.detach())
    want.backward(torch.from_numpy(xs[3]))
    for name, leaf, unit in zip(("dq", "dk", "dv"), leaves, units):
        np.testing.assert_allclose(view(leaf.grad).reshape(-1, N, DH).numpy(),
                                   unit.grad.numpy(), err_msg=name, **F32)


BWD_ENTRIES = ["pallas_tbwd_bf16", "pallas_tsbwd_bf16", "pallas_widebwd_bf16"]


@pytest.mark.parametrize("impl", BWD_ENTRIES)
def test_gradient_entries_run_no_relayout(impl, monkeypatch):
    """The timed call reads its inputs through views: no relayout. It equals
    the same function on token-major units (copies of the views), the plain
    attention differentiated by torch, within two bf16 ulps of the largest
    entry (the bar of ``test_torch_port_probes_fused.py``'s gradients: the
    plain backward rounds dO and dS to bf16 where autograd's order may
    differ)."""
    units = 256
    p = port_bench.inputs(impl, units, device="cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("relayout in the timed call")

    monkeypatch.setattr(probes, "relayout", refuse)
    monkeypatch.setattr(layouts, "relayout", refuse)
    with torch.no_grad():
        got = p.body(p.state)
    assert got.shape == p.state.shape and got.dtype == torch.bfloat16

    kt, vt = p.consts
    with torch.enable_grad():
        leaf = p.state.detach().requires_grad_(True)
        tokens = [p.view(x).reshape(-1, N, 64) for x in (leaf, kt, vt)]
        o = plain_window_attention(*tokens, port_bench.window_adj(), scale=port_bench.SCALE,
                                   stack=STACK, out_dtype=torch.bfloat16)
        (grad,) = torch.autograd.grad((o.float() ** 2).sum(), leaf)
    want = grad
    if impl == "pallas_widebwd_bf16":  # o + dq, o in the layout
        o_layout = torch.empty_like(p.state)
        p.view(o_layout).copy_(o.detach().view(p.view(o_layout).shape))
        want = o_layout + grad
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=2.0**-6 * want.float().abs().max().item())


def test_bwd_into_rejects_what_the_kernel_cannot_take():
    x = torch.zeros(8, 64, 128)
    v = layouts.t_view(x)
    with pytest.raises(ValueError, match="share one"):  # shapes
        window_attention_bwd_into(v, v, v, v, ADJ32, dq=v, dk=v, dv=v[:4], scale=0.25)
    with pytest.raises(ValueError, match="share one dtype"):  # dtypes
        window_attention_bwd_into(v, v, v, v, ADJ32, dq=v, dk=v.bfloat16(), dv=v, scale=0.25)
    with pytest.raises(ValueError, match="share one dtype and one device"):  # devices
        window_attention_bwd_into(v, v, v, v, ADJ32, dq=v, dk=v, dv=v.to("meta"), scale=0.25)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        m = v.to("meta")
        window_attention_bwd_into(m, m, m, m, ADJ32, dq=m, dk=m, dv=m, scale=0.25)
    with pytest.raises(ValueError, match="adj must be"):
        window_attention_bwd_into(v, v, v, v, ADJ32[:16, :16], dq=v, dk=v, dv=v, scale=0.25)
