"""The hybrid path with bf16 scores (the JAX package's ``PALLAS_HYBRID_S_BF16=1``)
against the JAX package, on the CPU.

- the plain masked softmax and its backward on bf16 scores against the JAX
  ``_masked_softmax`` (Pallas, interpret mode) and ``jax.vjp`` of it, with
  bf16 s: 32-token units at stack 4 (single mask; dual mask with pruning)
  and 58-token units at stack 1 with a ``sel``; P at 4e-3, dS at 4e-3 +
  1e-2·|x| and in bf16, as the JAX kernel writes it;
- ``hybrid_window_attention(scores_dtype=bf16)``: forward at 4e-3 and the q,
  k, v gradients at 4e-3 + 1e-2·|x| against the JAX function under the
  variable; each side is shown to have taken the bf16-score path (the JAX
  ``_masked_softmax`` traced with bf16 scores only; the port's result
  differs from its f32-score result);
- HWGATE ``attn_impl="hybrid"`` with ``hybrid_scores_dtype="bfloat16"``
  (embed 32, depths (1, 1), heads (2, 2)) against the JAX model under the
  variable (one JAX init shared by both tests; the JAX ``_masked_softmax``
  traced with bf16 scores only): bf16 eval logits at the bf16 model bar
  (0.05 / 0.05), and one step's gradients with bf16 attention under f32 projections (max abs
  5e-4, ‖g − g′‖/‖g′‖ ≤ 2e-2 per parameter);
- the option on f32 attention is the default path bit for bit;
- ``cli.main`` puts the variable into ``cfg.overrides``, ``bench.step``
  has its flag, and an exported bf16-score program is its eager forward;
- ``bench.rounding``'s float64 dv anchor on the plain backward.
"""

import functools

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
from sl_hwgat_tpu.train import losses as jax_losses

from sl_hwgat_tpu_torch import cli
from sl_hwgat_tpu_torch.bench import step as bench_step
from sl_hwgat_tpu_torch.models.hwgate import WindowedMSA, hwgate_from_dataset
from sl_hwgat_tpu_torch.ops.hybrid_attention import (
    hybrid_window_attention,
    masked_softmax,
    masked_softmax_bwd,
    plain_masked_softmax,
    plain_masked_softmax_bwd,
)
from sl_hwgat_tpu_torch.train.losses import per_sample, smoothed_cross_entropy
from sl_hwgat_tpu_torch.weights import params_from_jax, state_dict_from_jax

BF16 = torch.bfloat16
ADJ32 = jax_windowed_block_adj(2)[0]
ADJ58 = jax_hgate_block_adj(BODY29_EDGES, 29, 2)
VAR = "PALLAS_HYBRID_S_BF16"
P_TOL = 4e-3
GRAD_TOL = dict(atol=4e-3, rtol=1e-2)
SMALL = dict(embed_dim=32, depths=(1, 1), num_heads=(2, 2))
DS = {"num_class": 10, "src_len": 8}
MODEL_TOL = dict(atol=0.05, rtol=0.05)
GRAD_REL = 2e-2


def _tail(adj, seed):
    return adj * (np.random.default_rng(seed).random(adj.shape) > 0.3)


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 (nearest even), back in f32."""
    return torch.from_numpy(x).to(BF16).float().numpy()


def _supertiles(x_units, np_, stack, fill):
    """(U, N, N) unit blocks → (U/stack, stack·Np, stack·Np) with the blocks
    on the diagonal and ``fill`` elsewhere."""
    u, n, _ = x_units.shape
    out = fill.reshape(u // stack, stack * np_, stack * np_).copy()
    for i in range(u):
        r = (i % stack) * np_
        out[i // stack, r:r + n, r:r + n] = x_units[i]
    return out


def _diag(x_tiles, n, np_, stack):
    return np.stack([x_tiles[i // stack, (i % stack) * np_:(i % stack) * np_ + n,
                             (i % stack) * np_:(i % stack) * np_ + n]
                     for i in range(x_tiles.shape[0] * stack)])


# name: (tokens, padded tokens, stack, adj, units, dual, prune_u, explicit sel)
SOFTMAX_CASES = {
    "n32_single": (32, 32, 4, ADJ32, 16, False, None, False),
    "n32_dual_prune": (32, 32, 4, ADJ32, 16, True, 0.05, False),
    "n58_sel": (58, 64, 1, ADJ58, 9, True, 0.3, True),
}


@pytest.mark.parametrize("case", sorted(SOFTMAX_CASES))
def test_plain_masked_softmax_on_bf16_scores_matches_jax(case):
    n, np_, stack, adj, units, dual, prune_u, explicit = SOFTMAX_CASES[case]
    r = np.random.default_rng(7)
    s = _bf16((2.0 * r.normal(size=(units, n, n))).astype(np.float32))
    s[:, 0, :3] = 0.0  # exact zeros: the zero quirk
    dp = _bf16(r.normal(size=(units, n, n)).astype(np.float32))
    shape = (units // stack, stack * np_, stack * np_)
    s_t = _supertiles(s, np_, stack, _bf16(r.normal(size=shape).astype(np.float32)))
    dp_t = _supertiles(dp, np_, stack, _bf16(r.normal(size=shape).astype(np.float32)))
    tail = _tail(adj, 6) if dual else None
    per_group, groups = (1, 2) if stack == 1 else (4, 2)
    if explicit:
        sel = (r.random(units) < 0.5).astype(np.int32)
    else:
        jtail = (_cache_adj(tail), per_group, groups) if dual else None
        sel = np.asarray(_make_sel(units // stack, stack, jtail, None))
    static = (prune_u is not None,
              (_cache_adj(adj), (_cache_adj(tail), per_group, groups) if dual else None, True),
              (n, np_, stack, stack * np_))
    u_val = jnp.asarray([prune_u or 0.0], jnp.float32)

    def f(x):
        return jax_hybrid._masked_softmax(x, u_val, jnp.asarray(sel), *static, "bfloat16")

    p_jax, vjp = jax.vjp(f, jnp.asarray(s_t, jnp.bfloat16))
    (ds_jax,) = vjp(jnp.asarray(dp_t, jnp.bfloat16))
    assert p_jax.dtype == jnp.bfloat16 and ds_jax.dtype == jnp.bfloat16
    p_want = _diag(np.asarray(p_jax, np.float32), n, np_, stack)
    ds_want = _diag(np.asarray(ds_jax, np.float32), n, np_, stack)

    st, dpt = torch.from_numpy(s).to(BF16), torch.from_numpy(dp).to(BF16)
    kw = dict(stack=stack, prune_u=prune_u, tail_adj=tail, sel=torch.tensor(sel))
    if dual:
        kw.update(units_per_group=per_group, groups=groups)
    p = plain_masked_softmax(st, adj, p_dtype=BF16, **kw)
    assert p.dtype == BF16
    np.testing.assert_allclose(p.float().numpy(), p_want, atol=P_TOL)
    ds = plain_masked_softmax_bwd(st, dpt, adj, **kw)
    assert ds.dtype == BF16
    np.testing.assert_allclose(ds.float().numpy(), ds_want, **GRAD_TOL)
    # the CPU wrappers are the plain versions, and torch autograd of the
    # forward gives dS in bf16 within the same bar
    np.testing.assert_array_equal(masked_softmax(st, adj, p_dtype=BF16, **kw).float().numpy(),
                                  p.float().numpy())
    assert torch.equal(masked_softmax_bwd(st, dpt, adj, **kw), ds)
    leaf = st.clone().requires_grad_()
    masked_softmax(leaf, adj, p_dtype=BF16, **kw).backward(dpt)
    assert leaf.grad.dtype == BF16
    np.testing.assert_allclose(leaf.grad.float().numpy(), ds_want, **GRAD_TOL)


def _bf16_scores_in_jax(monkeypatch) -> list:
    """Set the variable, clear JAX's caches (no trace made without it serves
    a call), and wrap the JAX ``_masked_softmax`` so that each trace of it
    records its scores' dtype in the list returned."""
    monkeypatch.setenv(VAR, "1")
    jax.clear_caches()
    seen, real = [], jax_hybrid._masked_softmax

    def spy(s, *args):
        seen.append(str(s.dtype))
        return real(s, *args)

    monkeypatch.setattr(jax_hybrid, "_masked_softmax", spy)
    return seen


def _jax_attention(monkeypatch, q, k, v, do, adj, kw):
    """The JAX hybrid attention's output and q, k, v gradients (f32 numpy)
    under the variable, shown to have traced the bf16-score path."""
    seen = _bf16_scores_in_jax(monkeypatch)

    def f(q_, k_, v_):
        return jax_hybrid.hybrid_window_attention(q_, k_, v_, adj, **kw)

    out, vjp = jax.vjp(f, *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    grads = vjp(jnp.asarray(do))
    assert seen and set(seen) == {"bfloat16"}, seen
    return np.asarray(out, np.float32), [np.asarray(g, np.float32) for g in grads]


# name: (tokens, padded tokens, stack, adj, units per temporal group, groups, batch, prune)
ATTENTION_CASES = {"hwgate32": (32, 32, 4, ADJ32, 8, 2, 1, 0.05),
                   "hgate58": (58, 64, 2, ADJ58, 2, 2, 2, None)}


@pytest.mark.parametrize("geometry", sorted(ATTENTION_CASES))
def test_hybrid_window_attention_with_bf16_scores_matches_jax(geometry, monkeypatch):
    n, np_, stack, adj, per_group, groups, batch, prune_u = ATTENTION_CASES[geometry]
    units = batch * per_group * groups
    r = np.random.default_rng(5)
    q, k, v = (r.normal(size=(units, n, 16)).astype(np.float32) for _ in range(3))
    do = r.normal(size=(units, n, 16)).astype(np.float32)
    kw = dict(scale=0.25, stack=stack, pad_tokens=None if np_ == n else np_, prune_u=prune_u,
              tail_adj=_tail(adj, 6), units_per_group=per_group, groups=groups)
    want, want_grads = _jax_attention(monkeypatch, q, k, v, do, adj, kw)

    leaves = [torch.from_numpy(x).to(BF16).requires_grad_() for x in (q, k, v)]
    got = hybrid_window_attention(*leaves, adj, scores_dtype=BF16, **kw)
    assert got.dtype == torch.float32
    got.backward(torch.from_numpy(do))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=P_TOL)
    for t, w, name in zip(leaves, want_grads, "qkv"):
        assert t.grad.dtype == BF16
        np.testing.assert_allclose(t.grad.float().numpy(), w, **GRAD_TOL, err_msg=name)
    with torch.no_grad():
        port_f32_scores = hybrid_window_attention(*leaves, adj, **kw)
    assert not torch.equal(got.detach(), port_f32_scores)  # and so did the port


def _batch(n=2, seed=0):
    r = np.random.default_rng(seed)
    x = r.random((n, DS["src_len"], 64, 2)).astype(np.float32)
    y = r.integers(0, DS["num_class"], size=n).astype(np.int32)
    return x, y


def _jax_hwgate(**kw):
    return jax_hwgate(DS, 2, stream_layout="token", attn_impl="hybrid", **kw, **SMALL)


@functools.cache
def _jax_variables():
    """The JAX hybrid HWGATE's variables at SMALL width from key 0 (f32
    parameters whatever the compute type), made once for both model tests."""
    jm = _jax_hwgate()
    return jax.tree.map(np.asarray, jax.jit(lambda key, xx: jm.init(key, xx, train=False))(
        jax.random.PRNGKey(0), _batch()[0]))


def _port_model(variables, **kw):
    tm = hwgate_from_dataset(DS, 2, attn_impl="hybrid", **kw, **SMALL)
    tm.load_state_dict(state_dict_from_jax(variables))
    return tm


def test_hwgate_hybrid_bf16_logits_with_bf16_scores_match_jax(monkeypatch):
    """HWGATE hybrid bf16 with bf16 scores: eval logits against the JAX model
    under the variable at the bf16 model bar; the JAX side traced bf16
    scores only, and the port's logits differ from its f32-score logits."""
    x, _ = _batch()
    variables = _jax_variables()
    jm = _jax_hwgate(compute_dtype="bfloat16")
    seen = _bf16_scores_in_jax(monkeypatch)
    want = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(variables, x),
                      np.float32)
    assert seen and set(seen) == {"bfloat16"}, seen
    got = {}
    for scores in ("bfloat16", "float32"):
        with torch.no_grad():
            got[scores] = _port_model(variables, compute_dtype="bfloat16",
                                      hybrid_scores_dtype=scores).eval()(
                torch.from_numpy(x)).float().numpy()
    np.testing.assert_allclose(got["bfloat16"], want, **MODEL_TOL)
    assert not np.array_equal(got["bfloat16"], got["float32"])


def test_hwgate_hybrid_step_gradients_with_bf16_scores_match_jax(monkeypatch):
    """One step's gradients (dropout and pruning off) with bf16 attention and
    bf16 scores against the JAX model's under the variable, every parameter
    within max abs 5e-4 and 2e-2 of its norm. The projections run f32
    (``attn_dtype="bfloat16"``): with bf16 projections the bias gradients of
    the two packages part by up to 45% at this size whatever the scores
    (XLA reduces a bf16 bias gradient in bf16 on the CPU, torch in f32)."""
    det = dict(drop_rate=0.0, prune_attn=False, attn_dtype="bfloat16")
    variables = _jax_variables()
    jm = _jax_hwgate(**det)
    seen = _bf16_scores_in_jax(monkeypatch)
    x, y = _batch()
    aux = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(params):
        logits = jm.apply({**aux, "params": params}, jnp.asarray(x), train=True)
        per = jax.vmap(lambda lg, lb: jax_losses.smoothed_cross_entropy(lg[None], lb[None]))(
            logits, jnp.asarray(y))
        return jnp.mean(per)

    want = params_from_jax(jax.tree.map(
        np.asarray, jax.jit(jax.grad(loss_fn))(variables["params"])))
    assert seen and set(seen) == {"bfloat16"}, seen
    tm = _port_model(variables, hybrid_scores_dtype="bfloat16", **det).train()
    logits = tm(torch.from_numpy(x), torch.Generator().manual_seed(0))
    per_sample(smoothed_cross_entropy, logits, torch.from_numpy(y).long()).mean().backward()
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].grad
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=5e-4, err_msg=name)
        assert ((g - w).norm() / w.norm()).item() <= GRAD_REL, name


def test_bf16_scores_on_f32_attention_are_the_default_path():
    """The option and the keyword take effect only under bf16 values (the
    JAX gate ``vs.dtype == jnp.bfloat16``): on f32 attention the call is the
    f32-score path bit for bit, forward and gradients."""
    r = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(r.normal(size=(8, 32, 16)).astype(np.float32))
               for _ in range(3))
    kw = dict(scale=0.25, stack=4, prune_u=0.05)
    outs = []
    for scores in (torch.float32, BF16):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = hybrid_window_attention(*leaves, ADJ32, scores_dtype=scores, **kw)
        o.square().sum().backward()
        outs.append([o.detach(), *(t.grad for t in leaves)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    x, _ = _batch()
    logits, state = [], None
    for scores in ("float32", "bfloat16"):
        model = hwgate_from_dataset(DS, 2, attn_impl="hybrid", hybrid_scores_dtype=scores,
                                    **SMALL)
        state = state or model.state_dict()
        model.load_state_dict(state)
        with torch.no_grad():
            logits.append(model.eval()(torch.from_numpy(x)))
    assert torch.equal(*logits)
    with pytest.raises(ValueError, match="scores_dtype"):
        hybrid_window_attention(q, k, v, ADJ32, scale=0.25, scores_dtype=torch.float16)
    with pytest.raises(ValueError, match="hybrid_scores_dtype"):
        WindowedMSA(32, 2, ADJ32, attn_impl="hybrid", hybrid_scores_dtype="float16")


def test_cli_reads_the_variable_into_the_overrides(monkeypatch, tmp_path):
    """``cli.main`` under ``PALLAS_HYBRID_S_BF16=1`` gives HWGATE and HGATE
    ``hybrid_scores_dtype="bfloat16"``; without it, or for other models,
    nothing."""
    monkeypatch.chdir(tmp_path)
    seen = []
    monkeypatch.setattr(cli, "run", lambda cfg, **kw: seen.append((cfg.model_type,
                                                                    cfg.overrides)))
    common = ["-d", "SYNTH", "-c", "cpu", "--attn-impl", "hybrid", "--compute-dtype", "bfloat16"]
    monkeypatch.setenv(VAR, "1")
    for model in ("HWGATE", "HGATE", "WGATE"):
        cli.main(["--model", model, *common])
    monkeypatch.delenv(VAR)
    cli.main(["--model", "HWGATE", *common])
    scores = {"hybrid_scores_dtype": "bfloat16"}
    hybrid = {"compute_dtype": "bfloat16", "attn_impl": "hybrid"}
    assert seen == [("HWGATE", {**hybrid, **scores}), ("HGATE", {**hybrid, **scores}),
                    ("WGATE", {"compute_dtype": "bfloat16"}), ("HWGATE", hybrid)]


def test_step_bench_flag():
    assert bench_step.model_overrides("HWGATE", "bf16", attn_impl="hybrid",
                                      hybrid_scores_bf16=True) == {
        "compute_dtype": "bfloat16", "attn_impl": "hybrid", "hybrid_scores_dtype": "bfloat16"}
    assert bench_step.model_overrides("WGATE", "bf16", hybrid_scores_bf16=True) == {
        "compute_dtype": "bfloat16"}


def test_exported_bf16_score_program_is_its_eager_forward():
    """``torch.export`` traces the bf16-score hybrid forward through the
    masked-softmax custom op (bf16 scores in, bf16 P out); the program's
    logits are the eager forward's bit for bit."""
    model = hwgate_from_dataset(DS, 2, attn_impl="hybrid", compute_dtype="bfloat16",
                                hybrid_scores_dtype="bfloat16", **SMALL).eval()
    x = torch.from_numpy(_batch()[0])
    with torch.no_grad():
        want = model(x)
        program = torch.export.export(model, (x,))
        got = program.module()(x)
    ops = {str(node.target) for node in program.graph.nodes if node.op == "call_function"}
    assert "sl_hwgat_torch.masked_softmax.default" in ops
    assert torch.equal(got, want)


@pytest.mark.parametrize("mask", ["single", "dual_prune"])
def test_float64_dv_anchor_holds_the_plain_backward(mask):
    """``bench.rounding.dv_float64``: dV = Aᵀ·dO in float64 from the float64 A
    under the plain version's decisions (within 1e-4 of the same product
    from the plain version's f32 A), and the plain bf16 dV within 4e-3 +
    1e-2·|dv64| + Σᵢ ulp_bf16(A64ᵢⱼ)·|dOᵢ| of it, the bound ``chip_smoke.py``
    holds each side to on the card."""
    from sl_hwgat_tpu_torch.bench import rounding
    from sl_hwgat_tpu_torch.ops.window_attention import plain_window_attention_bwd

    g = torch.Generator().manual_seed(18)
    q, k, v, do = (torch.randn(64, 32, 64, generator=g).to(BF16) for _ in range(4))
    kw = dict(scale=0.125, stack=4)
    if mask == "dual_prune":
        kw.update(tail_adj=_tail(ADJ32, 6), units_per_group=4, groups=4, prune_u=0.3)
    dv64, slack = rounding.dv_float64(q, k, do, ADJ32, kw)
    a32 = rounding.plain_a(q, k, ADJ32, kw, torch.float32)
    np.testing.assert_allclose(dv64.numpy(), torch.bmm(a32.double().transpose(1, 2),
                                                       do.double()).numpy(), atol=1e-4)
    assert slack.dtype == torch.float64 and (slack > 0).all()
    dv = plain_window_attention_bwd(q, k, v, do, ADJ32, **kw)[2]
    assert dv.dtype == BF16
    assert rounding.dv_bound_ratio(dv, dv64, slack) <= 1.0
    # a dV off by more than the bound somewhere is over it
    assert rounding.dv_bound_ratio(dv.float() + 0.1, dv64, slack) > 1.0
