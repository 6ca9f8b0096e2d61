"""The port's window attention and layout maps against the JAX package.

Inputs are made with numpy from a seed and handed to both frameworks. The
port's CPU path of ``window_attention`` is its plain version
(``stacked_window_attention``); the JAX side is ``stacked_window_attention``
and ``pallas_window_attention`` in interpret mode, including every forward
twin of the fused kernel (each reached through its layout and switches).
Bars: f32 atol 1e-5 and, for the bf16 store, 4e-3 (one bf16 ulp below 1.0,
``tests/test_pallas_attention.py``); bf16 cases draw v at 0.2 scale so the
outputs stay below 1.0, where one ulp is 2^-8.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sl_hwgat_tpu import graphs
from sl_hwgat_tpu.graphs.skeleton import BODY29_EDGES
from sl_hwgat_tpu.ops import attention as jax_attention
from sl_hwgat_tpu.ops import window as jax_window
from sl_hwgat_tpu.ops.pallas_attention import pallas_window_attention

from sl_hwgat_tpu_torch.graphs.adjacency import windowed_block_adj
from sl_hwgat_tpu_torch.ops import attention as th_attention
from sl_hwgat_tpu_torch.ops import window as th_window
from sl_hwgat_tpu_torch.ops.window_attention import make_sel, window_attention

ADJ32 = graphs.windowed_block_adj(2)[0]
ADJ58 = graphs.hgate_block_adj(BODY29_EDGES)


def _qkv(u, n, dh, seed, v_scale=1.0):
    r = np.random.default_rng(seed)
    q, k, v = (r.normal(size=(u, n, dh)).astype(np.float32) for _ in range(3))
    return q, k, (v * v_scale).astype(np.float32)


def _tail(seed):
    r = np.random.default_rng(seed)
    return (ADJ32 * (r.random(ADJ32.shape) > 0.3)).astype(np.float32)


def _port(q, k, v, adj, dtype=torch.float32, **kw):
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    return window_attention(*t, adj, **kw).float().numpy()


def test_port_adjacency_equals_jax():
    np.testing.assert_array_equal(windowed_block_adj(2), graphs.windowed_block_adj(2))


@pytest.mark.parametrize("prune_u", [None, 0.3])
@pytest.mark.parametrize("case", ["single", "padded"])
def test_plain_matches_jax_stacked(case, prune_u):
    if case == "single":
        q, k, v = _qkv(16, 32, 64, seed=1)
        adj, kw = ADJ32, dict(scale=0.125, stack=4)
    else:  # HGATE geometry: 58 tokens padded to 64, two units per supertile
        q, k, v = _qkv(8, 58, 32, seed=2)
        adj, kw = ADJ58, dict(scale=32**-0.5, stack=2, pad_tokens=64)
    want = jax_attention.stacked_window_attention(
        *(jnp.asarray(x) for x in (q, k, v)), adj, prune_u=prune_u, **kw)
    got = _port(q, k, v, adj, prune_u=prune_u, **kw)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("prune_u", [None, 0.3])
@pytest.mark.parametrize("per_f,groups", [(8, 3), (8, 1)])
def test_dual_mask_matches_pallas(per_f, groups, prune_u):
    # groups == 1: every unit is in the tail group (stage 2 at short clips)
    q, k, v = _qkv(2 * per_f * groups, 32, 16, seed=3)
    tail = _tail(4)
    kw = dict(scale=0.25, stack=4, prune_u=prune_u, tail_adj=tail,
              units_per_group=per_f, groups=groups)
    want = pallas_window_attention(*(jnp.asarray(x) for x in (q, k, v)), ADJ32, **kw)
    got = _port(q, k, v, ADJ32, **kw)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("dual", [False, True])
def test_bf16_store_matches_pallas(dual):
    q, k, v = _qkv(48, 32, 64, seed=5, v_scale=0.2)
    kw = dict(scale=0.125, stack=4, prune_u=0.3)
    if dual:
        kw.update(tail_adj=_tail(6), units_per_group=8, groups=3)
    want = pallas_window_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), ADJ32,
        out_dtype=jnp.bfloat16, **kw)
    got = _port(q, k, v, ADJ32, dtype=torch.bfloat16, out_dtype=torch.bfloat16, **kw)
    np.testing.assert_allclose(got, np.asarray(want).astype(np.float32), atol=4e-3)


def test_unit_offset_and_explicit_sel():
    q, k, v = _qkv(32, 32, 16, seed=7)
    tail = _tail(8)
    kw = dict(scale=0.25, stack=4, tail_adj=tail, units_per_group=8, groups=2)
    want = pallas_window_attention(*(jnp.asarray(x) for x in (q, k, v)), ADJ32,
                                   unit_offset=8, **kw)
    np.testing.assert_allclose(_port(q, k, v, ADJ32, unit_offset=8, **kw),
                               np.asarray(want), atol=1e-5)
    sel = make_sel(8, 4, 8, 2, unit_offset=8)
    np.testing.assert_allclose(_port(q, k, v, ADJ32, sel=sel, **kw),
                               np.asarray(want), atol=1e-5)


# (transposed mode, PALLAS_ATTN_BATCHED) → the K1 forward twin it runs
TWINS = {
    "fwd_kernel_t": (True, False),
    "fwd_kernel_ts": ("tscore", False),
    "fwd_kernel_ts_batched": ("tscore", True),
    "fwd_kernel_wide": ("wide", False),
    "fwd_kernel_wide_batched": ("wide", True),
    "fwd_kernel_batched": (False, True),
}


@pytest.mark.parametrize("twin", list(TWINS))
def test_forward_twins_match_port(twin, monkeypatch):
    transposed, batched = TWINS[twin]
    if batched:
        monkeypatch.setenv("PALLAS_ATTN_BATCHED", "1")
    h, g, n, dh, st = 2, 12, 32, 16, 4
    q, k, v = _qkv(h * g, n, dh, seed=9)  # units h-major: u = head·G + group
    kw = dict(scale=0.25, stack=st, prune_u=0.3)
    if not batched:  # the batched forms are single-mask only
        kw.update(tail_adj=_tail(10), units_per_group=4, groups=3)
    want_units = _port(q, k, v, ADJ32, **kw)

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

    got = pallas_window_attention(*(jnp.asarray(to_layout(x)) for x in (q, k, v)),
                                  ADJ32, transposed=transposed, **kw)
    np.testing.assert_allclose(np.asarray(got), to_layout(want_units), atol=1e-5)


@pytest.mark.parametrize("prune_u", [None, 0.3])
def test_masked_msa_oracle_matches_jax(prune_u):
    r = np.random.default_rng(11)
    q, k, v = (r.normal(size=(4, 2, 32, 16)).astype(np.float32) for _ in range(3))
    adj = np.stack([ADJ32, _tail(12)])
    want = jax_attention.masked_msa_oracle(
        *(jnp.asarray(x) for x in (q, k, v)), adj=jnp.asarray(adj), scale=0.25,
        prune_u=prune_u)
    got = th_attention.masked_msa_oracle(
        *(torch.from_numpy(x) for x in (q, k, v)), adj=torch.from_numpy(adj), scale=0.25,
        prune_u=prune_u)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_wrapper_rejects_what_it_cannot_run():
    q, k, v = (torch.from_numpy(x) for x in _qkv(12, 32, 16, seed=13))
    with pytest.raises(ValueError, match="multiple of the supertile"):
        window_attention(q, k, v, ADJ32, scale=0.25, tail_adj=ADJ32,
                         units_per_group=6, groups=2)
    with pytest.raises(ValueError, match="share one"):
        window_attention(q, k[:8], v, ADJ32, scale=0.25)
    with pytest.raises(ValueError, match="adj must be"):
        window_attention(q, k, v, ADJ58, scale=0.25)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        window_attention(*(t.to("meta") for t in (q, k, v)), ADJ32, scale=0.25)


@pytest.mark.parametrize("shape", [(2, 8, 64, 32), (1, 4, 64, 16)])
def test_layout_maps_equal_jax(shape):
    x = np.random.default_rng(14).normal(size=shape).astype(np.float32)
    xt = torch.from_numpy(x)
    w = th_window.window_partition(xt, 16, 2)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jax_window.window_partition(x, 16, 2)))
    np.testing.assert_array_equal(
        th_window.window_reverse(w, 16, 2, shape[1], shape[2]).numpy(), x)
    np.testing.assert_array_equal(th_window.temporal_merge(xt, 2).numpy(),
                                  np.asarray(jax_window.temporal_merge(x, 2)))
