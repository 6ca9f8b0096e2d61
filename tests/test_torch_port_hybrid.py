"""The port's hybrid window attention against the JAX package's, on the CPU.

- the plain masked softmax and its written-out backward against the JAX
  ``_masked_softmax`` (Pallas, interpret mode) and ``jax.vjp`` of it: the
  port's per-unit (U, N, N) blocks equal the diagonal unit blocks of the JAX
  (T, S·Np, S·Np) supertiles at 1e-6 / 2e-5, and every other JAX entry of a
  real token's row (every entry, for the gradient) is exactly 0;
- ``hybrid_window_attention`` forward and gradients against the JAX
  function: 32-token units (stack 4) and HGATE's 58-token units (padded to
  64, stack 2), single and dual mask, prune off and 0.05; f32 at 1e-5 / 2e-5,
  bf16 at 4e-3 (forward) and 4e-3 + 1e-2·|x| (gradients);
- HWGATE with ``attn_impl="hybrid"``: eval logits (f32 2e-4/1e-4, bf16
  0.05) and 3 AdamW steps against the JAX model and ``make_steps``;
- unknown ``attn_impl`` names raise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sl_hwgat_tpu.graphs.adjacency import hgate_block_adj as jax_hgate_block_adj
from sl_hwgat_tpu.graphs.adjacency import windowed_block_adj as jax_windowed_block_adj
from sl_hwgat_tpu.graphs.skeleton import BODY29_EDGES
from sl_hwgat_tpu.models.hwgate import hwgate_from_dataset as jax_hwgate
from sl_hwgat_tpu.ops import hybrid_attention as jax_hybrid
from sl_hwgat_tpu.ops.pallas_attention import _cache_adj, _make_sel
from sl_hwgat_tpu.train.loop import init_state as jax_init_state
from sl_hwgat_tpu.train.loop import make_steps as jax_make_steps

from sl_hwgat_tpu_torch.models.hgate import HGATE
from sl_hwgat_tpu_torch.models.hwgate import HWGATE, WindowedMSA, hwgate_from_dataset
from sl_hwgat_tpu_torch.ops import attention as plain
from sl_hwgat_tpu_torch.ops.hybrid_attention import (
    hybrid_window_attention,
    masked_softmax,
    masked_softmax_bwd,
    plain_masked_softmax,
    plain_masked_softmax_bwd,
)
from sl_hwgat_tpu_torch.ops.window_attention import make_sel
from sl_hwgat_tpu_torch.train.loop import make_steps
from sl_hwgat_tpu_torch.train.state import make_optimizer
from sl_hwgat_tpu_torch.weights import params_from_jax, state_dict_from_jax

ADJ32 = jax_windowed_block_adj(2)[0]
ADJ58 = jax_hgate_block_adj(BODY29_EDGES, 29, 2)
# name: (tokens, padded tokens, stack, adj, units per temporal group, groups, batch)
GEOMETRY = {
    "hwgate32": (32, 32, 4, ADJ32, 8, 2, 1),
    "hgate58": (58, 64, 2, ADJ58, 2, 2, 2),
}
SMALL = dict(embed_dim=32, depths=(2, 2, 2), num_heads=(1, 2, 4))
DS = {"num_class": 10, "src_len": 8}
TOL = {"float32": dict(atol=2e-4, rtol=1e-4), "bfloat16": dict(atol=0.05, rtol=0.05)}


def _tail(adj, seed):
    return adj * (np.random.default_rng(seed).random(adj.shape) > 0.3)


def _case(geometry, dual):
    n, np_, stack, adj, per_group, groups, batch = GEOMETRY[geometry]
    units = batch * per_group * groups
    mask_kw = {}
    if dual:
        mask_kw = dict(tail_adj=_tail(adj, 6), units_per_group=per_group, groups=groups)
    return n, np_, stack, adj, units, mask_kw


def _jax_supertiles(x_units, np_, stack, fill):
    """(U, N, N) unit blocks → (U/stack, stack·Np, stack·Np) supertiles with
    the blocks on the diagonal and ``fill`` values everywhere else."""
    u, n, _ = x_units.shape
    t, sn = u // stack, stack * np_
    out = fill.reshape(t, sn, sn).copy()
    for i in range(u):
        r = (i % stack) * np_
        out[i // stack, r:r + n, r:r + n] = x_units[i]
    return out


def _diag_blocks(x_tiles, n, np_, stack):
    """Inverse of ``_jax_supertiles`` on the diagonal blocks, and a mask of
    the entries outside them in the rows of real tokens."""
    t, sn, _ = x_tiles.shape
    blocks = np.stack([x_tiles[i // stack, (i % stack) * np_:(i % stack) * np_ + n,
                               (i % stack) * np_:(i % stack) * np_ + n]
                       for i in range(t * stack)])
    outside = np.ones((sn, sn), bool)
    real_row = np.zeros(sn, bool)
    for j in range(stack):
        outside[j * np_:j * np_ + n, j * np_:j * np_ + n] = False
        real_row[j * np_:j * np_ + n] = True
    return blocks, outside, real_row


def _jax_masked_softmax_args(adj, n, np_, stack, units, mask_kw, prune_u):
    tail = None
    if mask_kw:
        tail = (_cache_adj(mask_kw["tail_adj"]), mask_kw["units_per_group"], mask_kw["groups"])
    sel = _make_sel(units // stack, stack, tail, None)
    u_val = jnp.asarray([prune_u if prune_u is not None else 0.0], jnp.float32)
    static = (prune_u is not None, (_cache_adj(adj), tail, True), (n, np_, stack, stack * np_))
    return u_val, sel, static


@pytest.mark.parametrize("prune_u", [None, 0.05])
@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("geometry", sorted(GEOMETRY))
def test_masked_softmax_and_backward_match_jax(geometry, dual, prune_u):
    n, np_, stack, adj, units, mask_kw = _case(geometry, dual)
    sn = stack * np_
    r = np.random.default_rng(3)
    s = (2.0 * r.normal(size=(units, n, n))).astype(np.float32)
    s[:, 0, :3] = 0.0  # exact zeros: the zero quirk
    dp = r.normal(size=(units, n, n)).astype(np.float32)
    s_t = _jax_supertiles(s, np_, stack, r.normal(size=(units // stack, sn, sn)).astype(np.float32))
    dp_t = _jax_supertiles(dp, np_, stack, r.normal(size=s_t.shape).astype(np.float32))

    u_val, sel, (prune, masks, shape_info) = _jax_masked_softmax_args(
        adj, n, np_, stack, units, mask_kw, prune_u)

    def f(x):
        return jax_hybrid._masked_softmax(x, u_val, sel, prune, masks, shape_info, "float32")

    p_jax, vjp = jax.vjp(f, jnp.asarray(s_t))
    (ds_jax,) = vjp(jnp.asarray(dp_t))
    p_blocks, outside, real_row = _diag_blocks(np.asarray(p_jax), n, np_, stack)
    ds_blocks, _, _ = _diag_blocks(np.asarray(ds_jax), n, np_, stack)
    assert not np.asarray(p_jax)[:, real_row][:, outside[real_row]].any()
    assert not np.asarray(ds_jax)[:, outside].any()

    sel_t = torch.from_numpy(np.array(sel))
    kw = dict(stack=stack, prune_u=prune_u, tail_adj=mask_kw.get("tail_adj"), sel=sel_t)
    st = torch.from_numpy(s)
    p = plain.unit_masked_softmax(st, adj, **kw)
    np.testing.assert_allclose(p.numpy(), p_blocks, atol=1e-6)
    ds = plain.unit_masked_softmax_bwd(st, torch.from_numpy(dp), adj, **kw)
    np.testing.assert_allclose(ds.numpy(), ds_blocks, atol=2e-5)

    # the CPU wrappers: the phase selector equals the JAX one, and torch
    # autograd of the plain forward is the written-out backward
    wkw = dict(stack=stack, prune_u=prune_u, **mask_kw)
    leaf = st.clone().requires_grad_()
    pw = masked_softmax(leaf, adj, **wkw)
    np.testing.assert_array_equal(pw.detach().numpy(), p.numpy())
    pw.backward(torch.from_numpy(dp))
    np.testing.assert_allclose(leaf.grad.numpy(), ds.numpy(), atol=2e-6)
    np.testing.assert_array_equal(
        masked_softmax_bwd(st, torch.from_numpy(dp), adj, **wkw).numpy(), ds.numpy())


def _random_adj(n, seed):
    r = np.random.default_rng(seed)
    a = r.random((n, n)) < 3.0 / n
    return (a | a.T | np.eye(n, dtype=bool)).astype(np.float32)


# (tokens, padded tokens, adj): HGATE's units, and 33 tokens (odd: the
# kernel's rows and units lose their 16-byte alignment there)
RAGGED = {"hgate58": (58, 64, ADJ58), "odd33": (33, 33, _random_adj(33, 4))}


@pytest.mark.parametrize("geometry", sorted(RAGGED))
def test_masked_softmax_and_backward_match_jax_at_a_ragged_unit_count(geometry):
    """37 units, one a supertile, under the dual mask through a seeded
    ``sel`` and with pruning at u = 0.3: the case the chip run holds K7 at."""
    n, np_, adj = RAGGED[geometry]
    units, stack, prune_u = 37, 1, 0.3
    tail = _tail(adj, 6)
    r = np.random.default_rng(13)
    s = (2.0 * r.normal(size=(units, n, n))).astype(np.float32)
    s[:, 0, :3] = 0.0
    dp = r.normal(size=(units, n, n)).astype(np.float32)
    sel = (r.random(units) < 0.5).astype(np.int32)
    s_t = _jax_supertiles(s, np_, stack, r.normal(size=(units, np_, np_)).astype(np.float32))
    dp_t = _jax_supertiles(dp, np_, stack, r.normal(size=s_t.shape).astype(np.float32))
    static = (True, (_cache_adj(adj), (_cache_adj(tail), 1, 2), True), (n, np_, stack, np_))

    def f(x):
        return jax_hybrid._masked_softmax(x, jnp.asarray([prune_u], jnp.float32),
                                          jnp.asarray(sel), *static, "float32")

    p_jax, vjp = jax.vjp(f, jnp.asarray(s_t))
    p_blocks, _, _ = _diag_blocks(np.asarray(p_jax), n, np_, stack)
    ds_blocks, _, _ = _diag_blocks(np.asarray(vjp(jnp.asarray(dp_t))[0]), n, np_, stack)
    st, dpt, selt = torch.from_numpy(s), torch.from_numpy(dp), torch.from_numpy(sel)
    kw = dict(stack=stack, prune_u=prune_u, tail_adj=tail, units_per_group=1, groups=2,
              sel=selt)
    p = plain_masked_softmax(st, adj, **kw)
    np.testing.assert_allclose(p.numpy(), p_blocks, atol=1e-6)
    ds = plain_masked_softmax_bwd(st, dpt, adj, **kw)
    np.testing.assert_allclose(ds.numpy(), ds_blocks, atol=2e-5)
    np.testing.assert_array_equal(masked_softmax(st, adj, **kw).numpy(), p.numpy())
    np.testing.assert_array_equal(masked_softmax_bwd(st, dpt, adj, **kw).numpy(), ds.numpy())
    bf = plain_masked_softmax(st, adj, p_dtype=torch.bfloat16, **kw)
    assert torch.equal(bf, p.to(torch.bfloat16))


def test_masked_softmax_stores_p_in_the_given_type():
    s = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 32, 32)).astype(np.float32))
    p = plain_masked_softmax(s, ADJ32, p_dtype=torch.bfloat16)
    assert p.dtype == torch.bfloat16
    torch.testing.assert_close(p, plain_masked_softmax(s, ADJ32).to(torch.bfloat16),
                               atol=0, rtol=0)
    with pytest.raises(ValueError, match="at most 64"):
        masked_softmax(torch.zeros(2, 65, 65), np.ones((65, 65)), stack=2)


def _qkv(units, n, dh, seed):
    r = np.random.default_rng(seed)
    return [r.normal(size=(units, n, dh)).astype(np.float32) for _ in range(3)]


HYBRID_CASES = [(g, dual, prune, "float32") for g in sorted(GEOMETRY) for dual in (False, True)
                for prune in (None, 0.05)] + [(g, True, None, "bfloat16") for g in sorted(GEOMETRY)]


@pytest.mark.parametrize("geometry,dual,prune_u,dtype", HYBRID_CASES)
def test_hybrid_window_attention_matches_jax(geometry, dual, prune_u, dtype):
    n, np_, stack, adj, units, mask_kw = _case(geometry, dual)
    q, k, v = _qkv(units, n, 16, seed=5)
    do = np.random.default_rng(9).normal(size=(units, n, 16)).astype(np.float32)
    kw = dict(scale=0.25, stack=stack, pad_tokens=None if np_ == n else np_, prune_u=prune_u,
              **mask_kw)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def f(q_, k_, v_):
        return jax_hybrid.hybrid_window_attention(q_, k_, v_, adj, **kw)

    want, vjp = jax.vjp(f, *(jnp.asarray(x).astype(jdt) for x in (q, k, v)))
    want_grads = vjp(jnp.asarray(do))

    tdt = getattr(torch, dtype)
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v)]
    got = hybrid_window_attention(*leaves, adj, **kw)
    assert got.dtype == torch.float32 and got.shape == (units, n, 16)
    got.backward(torch.from_numpy(do))
    if dtype == "float32":
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
        for t, w, name in zip(leaves, want_grads, "qkv"):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=2e-5, err_msg=name)
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want, np.float32), atol=4e-3)
        for t, w, name in zip(leaves, want_grads, "qkv"):
            assert t.grad.dtype == torch.bfloat16
            np.testing.assert_allclose(t.grad.float().numpy(), np.asarray(w, np.float32),
                                       atol=4e-3, rtol=1e-2, err_msg=name)


def test_hybrid_equals_the_fused_function():
    """The hybrid path and the fused window attention compute one function."""
    from sl_hwgat_tpu_torch.ops.window_attention import window_attention

    for geometry in GEOMETRY:
        n, np_, stack, adj, units, mask_kw = _case(geometry, True)
        q, k, v = (torch.from_numpy(x) for x in _qkv(units, n, 16, seed=2))
        kw = dict(scale=0.25, stack=stack, pad_tokens=None if np_ == n else np_, prune_u=0.05,
                  **mask_kw)
        torch.testing.assert_close(hybrid_window_attention(q, k, v, adj, **kw),
                                   window_attention(q, k, v, adj, **kw), atol=1e-6, rtol=0)
        sel = make_sel(units // stack, stack, mask_kw["units_per_group"], mask_kw["groups"])
        s = torch.bmm(q * 0.25, k.transpose(1, 2))
        torch.testing.assert_close(
            masked_softmax(s, adj, stack=stack, sel=sel, **mask_kw),
            masked_softmax(s, adj, stack=stack, **mask_kw), atol=0, rtol=0)


def _jax_model_and_variables(compute_dtype="float32", **kw):
    jm = jax_hwgate(DS, 2, stream_layout="token", attn_impl="hybrid",
                    compute_dtype=compute_dtype, **SMALL, **kw)
    x = np.random.default_rng(0).random((2, DS["src_len"], 64, 2)).astype(np.float32)
    init = jax.jit(lambda key, xx: jm.init(key, xx, train=False))
    return jm, jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), x)), x


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_hwgate_hybrid_logits_match_jax(compute_dtype):
    jm, variables, x = _jax_model_and_variables(compute_dtype)
    want = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(variables, x))
    tm = hwgate_from_dataset(DS, 2, attn_impl="hybrid", compute_dtype=compute_dtype, **SMALL)
    tm.load_state_dict(state_dict_from_jax(variables))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL[compute_dtype])


class _Cfg:
    seed = 0
    optimizer_type = "adamw"
    lr = 5e-4


def test_hwgate_hybrid_train_steps_match_jax():
    jm = jax_hwgate(DS, 2, stream_layout="token", attn_impl="hybrid", drop_rate=0.0,
                    prune_attn=False, **SMALL)
    state, jopt = jax_init_state(jm, _Cfg, (DS["src_len"], 64, 2))
    variables, opt_state = state.variables, state.opt_state
    jstep, _ = jax_make_steps(jm, jopt, donate=False)
    tm = hwgate_from_dataset(DS, 2, attn_impl="hybrid", drop_rate=0.0, prune_attn=False,
                             **SMALL)
    tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, variables)))
    tstep, _ = make_steps(tm, make_optimizer("adamw", _Cfg.lr, tm.parameters()))
    r = np.random.default_rng(1)
    key = jax.random.PRNGKey(0)
    for step in range(3):
        x = r.random((4, DS["src_len"], 64, 2)).astype(np.float32)
        y = r.integers(0, DS["num_class"], size=4).astype(np.int32)
        valid = np.array([1, 1, 1, 0], np.float32)
        variables, opt_state, jloss, _, _ = jstep(
            variables, opt_state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(valid), key, 0, step)
        tloss, _, _ = tstep(torch.from_numpy(x), torch.from_numpy(y).long(),
                            torch.from_numpy(valid), 0, 0, step)
        np.testing.assert_allclose(tloss.item(), float(jloss), **TOL["float32"])
    want = params_from_jax(jax.tree.map(np.asarray, variables["params"]))
    got = dict(tm.named_parameters())
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(), **TOL["float32"],
                                   err_msg=k)


@pytest.mark.parametrize("build", [
    lambda impl: HWGATE(temporal_dim=8, num_classes=10, attn_impl=impl, **SMALL),
    lambda impl: HGATE(temporal_dim=8, num_classes=10, attn_impl=impl, **SMALL),
    lambda impl: WindowedMSA(32, 2, ADJ32, attn_impl=impl),
], ids=["HWGATE", "HGATE", "WindowedMSA"])
def test_unknown_attn_impl_raises(build):
    for impl in ("pallas_banded", "xla", "ell"):
        with pytest.raises(ValueError, match="'auto', 'pallas', 'stacked', 'hybrid'"):
            build(impl)
    # "stacked" (the JAX package's jnp form of the fused kernel's function)
    # takes the fused path
    assert build("hybrid") is not None and build("stacked") is not None


@pytest.mark.parametrize("source", ["masked_softmax_fwd.cu", "masked_softmax_bwd.cu"])
def test_ablation_variants_apply_to_the_masked_softmax_source(source, monkeypatch):
    """bench.ablate softmax's variants of the sources' design apply to this
    checkout, once each, the no_softmax twin edits the forward and the
    backward alike, and the cases it holds against the parent are built
    (dual masks with pruning, ragged spans, an offset view)."""
    from sl_hwgat_tpu_torch.bench import ablate
    from sl_hwgat_tpu_torch.ops import _build

    design, variants = ablate.design_of(_build.CSRC_DIR, ablate.SOFTMAX_FWD,
                                        ablate.SOFTMAX_DESIGNS)
    assert design == "staged"
    assert {"full", "no_softmax", "no_copies"} <= set(variants)
    assert source in variants["no_softmax"]
    for edits in variants.values():
        for fname in {source, ablate.SOFTMAX_COMMON} & set(edits):
            text = (_build.CSRC_DIR / fname).read_text()
            for old, _ in edits[fname]:
                assert text.count(old) == 1, (fname, old)
    monkeypatch.setattr(ablate, "SOFTMAX_SHAPES", {"HWGATE": (16, 32), "HGATE": (4, 58)})
    cases = list(ablate.softmax_cases("cpu"))
    assert len(cases) == 8
    assert any(s.storage_offset() == 1 for _, s, _, _ in cases)
    assert ablate.main(["softmax"]) == 1  # no card here
