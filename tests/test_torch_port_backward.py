"""The port's window-attention backward against torch autograd and the JAX package.

``stacked_window_attention_bwd`` is the plain version of the backward kernel
(``csrc/window_attention_bwd.cu``). It is held against:

- torch autograd of the port's own forward, ``stacked_window_attention``;
- ``jax.vjp`` of ``pallas_window_attention`` in interpret mode (the K2
  ``_bwd_kernel`` and, through their layouts and switches, each of its twins).

Inputs and output gradients are made with numpy from a seed. Bars:
``tests/test_pallas_attention.py`` — f32 atol 2e-5; bf16 atol 4e-3 and rtol
1e-2 (one bf16 ulp is 2^-8 relative).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sl_hwgat_tpu import graphs
from sl_hwgat_tpu.graphs.skeleton import BODY29_EDGES
from sl_hwgat_tpu.ops.pallas_attention import pallas_window_attention

from sl_hwgat_tpu_torch.ops.attention import stacked_window_attention, stacked_window_attention_bwd
from sl_hwgat_tpu_torch.ops.window_attention import (
    make_sel,
    plain_window_attention_bwd,
    window_attention,
    window_attention_bwd,
)

ADJ32 = graphs.windowed_block_adj(2)[0]
ADJ58 = graphs.hgate_block_adj(BODY29_EDGES)
F32 = dict(atol=2e-5, rtol=0)
BF16 = dict(atol=4e-3, rtol=1e-2)


def _inputs(u, n, dh, seed):
    r = np.random.default_rng(seed)
    return tuple(r.normal(size=(u, n, dh)).astype(np.float32) for _ in range(4))


def _tail(seed):
    r = np.random.default_rng(seed)
    return (ADJ32 * (r.random(ADJ32.shape) > 0.3)).astype(np.float32)


def _case(case, prune_u):
    """(q, k, v, do, adj, keyword arguments) of a geometry."""
    if case == "single":
        q, k, v, do = _inputs(16, 32, 16, seed=1)
        return q, k, v, do, ADJ32, dict(scale=0.25, stack=4, prune_u=prune_u)
    if case == "dual":  # 3 temporal groups of 8 units, the last under the tail mask
        q, k, v, do = _inputs(48, 32, 16, seed=2)
        return q, k, v, do, ADJ32, dict(scale=0.25, stack=4, prune_u=prune_u,
                                        tail_adj=_tail(3), units_per_group=8, groups=3)
    # padded: HGATE geometry, 58 tokens padded to 64, two units per supertile
    q, k, v, do = _inputs(8, 58, 32, seed=4)
    return q, k, v, do, ADJ58, dict(scale=32**-0.5, stack=2, pad_tokens=64, prune_u=prune_u)


def _torch(*xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


def _np(ts):
    return [t.float().numpy() for t in ts]


@pytest.mark.parametrize("prune_u", [None, 0.3])
@pytest.mark.parametrize("case", ["single", "dual", "padded"])
def test_plain_backward_equals_torch_autograd(case, prune_u):
    q, k, v, do, adj, kw = _case(case, prune_u)
    tail = kw.pop("tail_adj", None)
    upg, groups = kw.pop("units_per_group", None), kw.pop("groups", None)
    sel = None
    if tail is not None:
        sel = make_sel(q.shape[0] // kw["stack"], kw["stack"], upg, groups)
    qt, kt, vt = (t.requires_grad_() for t in _torch(q, k, v))
    out = stacked_window_attention(qt, kt, vt, adj, tail_adj=tail, sel=sel, **kw)
    want = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    got = stacked_window_attention_bwd(*_torch(q, k, v, do), adj, tail_adj=tail, sel=sel, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **F32)


def _jax_vjp(q, k, v, do, adj, dtype=jnp.float32, **kw):
    def f(qq, kk, vv):
        return pallas_window_attention(qq, kk, vv, adj, **kw)

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    out, vjp = jax.vjp(f, *args)
    return [np.asarray(g).astype(np.float32) for g in vjp(jnp.asarray(do, out.dtype))]


@pytest.mark.parametrize("prune_u", [None, 0.3])
@pytest.mark.parametrize("case", ["single", "dual", "padded"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_equals_jax_vjp(dtype, case, prune_u):
    q, k, v, do, adj, kw = _case(case, prune_u)
    v = (v * 0.2).astype(np.float32)
    if dtype == "float32":
        want = _jax_vjp(q, k, v, do, adj, **kw)
        got = _np(plain_window_attention_bwd(*_torch(q, k, v, do), adj, **kw))
        tol = F32
    else:  # the model's bf16 mode: bf16 operands, bf16 output and output gradient
        want = _jax_vjp(q, k, v, do, adj, dtype=jnp.bfloat16, out_dtype=jnp.bfloat16, **kw)
        got = _np(plain_window_attention_bwd(*_torch(q, k, v, do, dtype=torch.bfloat16), adj,
                                             **kw))
        tol = BF16
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **tol)


# K2 twin → (transposed mode, PALLAS_ATTN_BATCHED, PALLAS_ATTN_COMPACT)
TWINS = {
    "bwd_kernel_batched": (False, True, False),
    "bwd_kernel_t": (True, False, False),
    "bwd_kernel_ts": ("tscore", False, False),
    "bwd_kernel_ts_batched": ("tscore", True, False),
    "bwd_kernel_wide": ("wide", False, False),
    "bwd_kernel_wide_batched": ("wide", True, False),
    "bwd_kernel_compact": (False, False, True),
}


@pytest.mark.parametrize("twin", list(TWINS))
def test_backward_twins_match_port(twin, monkeypatch):
    transposed, batched, compact = TWINS[twin]
    if batched:
        monkeypatch.setenv("PALLAS_ATTN_BATCHED", "1")
    if compact:
        monkeypatch.setenv("PALLAS_ATTN_COMPACT", "1")
    h, g, n, dh, st = 2, 12, 32, 16, 4
    q, k, v, do = _inputs(h * g, n, dh, seed=9)  # units h-major: u = head·G + group
    kw = dict(scale=0.25, stack=st, prune_u=0.3)
    if not batched:  # the batched forms are single-mask only
        kw.update(tail_adj=_tail(10), units_per_group=4, groups=3)
    want_units = _np(plain_window_attention_bwd(*_torch(q, k, v, do), ADJ32, **kw))

    if transposed == "wide":
        def to_layout(x):
            return x.reshape(h, g // st, st, n, dh).transpose(0, 4, 1, 2, 3).reshape(
                h, dh, g // st, st * n)
    elif transposed:
        def to_layout(x):
            return x.transpose(0, 2, 1)
    else:
        def to_layout(x):
            return x

    got = _jax_vjp(*(to_layout(x) for x in (q, k, v, do)), ADJ32, transposed=transposed, **kw)
    for name, gg, w in zip(("dq", "dk", "dv"), got, want_units):
        np.testing.assert_allclose(gg, to_layout(w), err_msg=name, **F32)


@pytest.mark.parametrize("dual", [False, True])
def test_window_attention_on_cpu_differentiates_through_the_plain_path(dual):
    q, k, v, do = _inputs(24, 32, 16, seed=11)
    kw = dict(scale=0.25, stack=4, prune_u=0.3)
    if dual:
        kw.update(tail_adj=_tail(12), units_per_group=8, groups=3)
    qt, kt, vt = (t.requires_grad_() for t in _torch(q, k, v))
    out = window_attention(qt, kt, vt, ADJ32, **kw)
    out.backward(torch.from_numpy(do))
    want = window_attention_bwd(*_torch(q, k, v, do), ADJ32, **kw)
    assert window_attention_bwd.launches == 0  # the CPU path never reaches a kernel
    for t, w in zip((qt, kt, vt), want):
        np.testing.assert_allclose(t.grad.numpy(), w.numpy(), **F32)


def test_autograd_function_routes_the_gradient_to_the_backward_wrapper(monkeypatch):
    """The Function that ``window_attention`` applies to CUDA tensors, run
    here with its two kernel launchers swapped for their plain versions: q,
    k, v get the backward's gradients in q's dtype (prune_u and sel get
    none), dO reaches the backward contiguous, and the Function also runs
    under inference mode."""
    from sl_hwgat_tpu_torch.ops import window_attention as wa

    seen = {}

    def fwd(q, k, v, adj, **kw):
        return wa.plain_window_attention(q, k, v, adj, **kw)

    def bwd(q, k, v, do, adj, **kw):
        seen["do"] = (do.dtype, do.is_contiguous())
        return wa.plain_window_attention_bwd(q, k, v, do.to(q.dtype), adj, **kw)

    monkeypatch.setattr(wa, "_kernel", fwd)
    monkeypatch.setattr(wa, "_kernel_bwd", bwd)
    q, k, v, do = _inputs(24, 32, 16, seed=13)
    prune_u = torch.full((1,), 0.3)
    kw = dict(scale=0.25, stack=4, pad_tokens=None, zero_quirk=True, tail_adj=_tail(14),
              units_per_group=8, groups=3, unit_offset=0, out_dtype=torch.float32)
    sel = make_sel(6, 4, 8, 3)
    qt, kt, vt = (t.to(torch.bfloat16).requires_grad_() for t in _torch(q, k, v))
    out = wa._WindowAttention.apply(qt, kt, vt, prune_u, sel, ADJ32, kw)
    assert out.dtype == torch.float32
    out.backward(torch.from_numpy(do).transpose(1, 2).contiguous().transpose(1, 2))
    want = wa.plain_window_attention_bwd(qt.detach(), kt.detach(), vt.detach(),
                                         torch.from_numpy(do), ADJ32, prune_u=prune_u, sel=sel,
                                         **kw)
    for t, w in zip((qt, kt, vt), want):
        assert t.grad.dtype == torch.bfloat16
        assert torch.equal(t.grad, w)
    assert seen["do"][1]
    with torch.inference_mode():
        again = wa._WindowAttention.apply(qt.detach(), kt.detach(), vt.detach(), prune_u, sel,
                                          ADJ32, kw)
    assert torch.equal(again, out.detach())
