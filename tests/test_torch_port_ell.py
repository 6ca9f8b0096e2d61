"""The port's ELL graph attention against the JAX package's, on the CPU.

- the sparse adjacency forms (``spatio_temporal_adj``, ``dense_to_csr``,
  ``dense_to_ell``, ``num_edges``) and the ELL tables (``ell_from_band``,
  ``ell_from_dense``) equal the JAX ones exactly;
- ``ell_graph_attention`` matches the JAX function at atol 1e-5 (f32) and
  4e-3 (bf16), its q, k, v gradients ``jax.vjp``'s at 2e-5 (f32), and the
  port's dense (``masked_msa_oracle``) and banded attention on the same
  topology at 1e-5;
- WGATE and GATE with ``attn_impl="ell"``: eval logits against the JAX
  models' at 2e-4 / 1e-4 (f32; bf16 compute at 0.05), and 3 AdamW steps
  against the JAX ``make_steps`` (f32, dropout off);
- the kernel bench's ``ell*`` entries at a reduced batch against the JAX
  function on the same draws.

Small geometry: 8 frames, 10 classes, embed 32, 2 blocks, 2 heads (dh 16).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sl_hwgat_tpu.graphs import adjacency as jax_adjacency
from sl_hwgat_tpu.models.gate import gate_from_dataset as jax_gate
from sl_hwgat_tpu.models.wgate import wgate_from_dataset as jax_wgate
from sl_hwgat_tpu.ops import sparse_attention as jax_sparse
from sl_hwgat_tpu.train.loop import init_state as jax_init_state
from sl_hwgat_tpu.train.loop import make_steps as jax_make_steps

from sl_hwgat_tpu_torch.bench import kernel as port_bench
from sl_hwgat_tpu_torch.graphs import adjacency
from sl_hwgat_tpu_torch.graphs.skeleton import BODY29_EDGES, edges_to_dense
from sl_hwgat_tpu_torch.models import MODEL_NUM_KPS
from sl_hwgat_tpu_torch.models.gate import gate_from_dataset
from sl_hwgat_tpu_torch.models.wgate import make_band, wgate_from_dataset
from sl_hwgat_tpu_torch.ops import sparse_attention
from sl_hwgat_tpu_torch.ops.attention import masked_msa_oracle
from sl_hwgat_tpu_torch.ops.banded_attention import banded_attention
from sl_hwgat_tpu_torch.train.loop import make_steps
from sl_hwgat_tpu_torch.train.state import make_optimizer
from sl_hwgat_tpu_torch.weights import params_from_jax, state_dict_from_jax

DS = {"num_class": 10, "src_len": 8}
SMALL = dict(embed_dim=32, depths=2, num_heads=2)
TOL = {"float32": dict(atol=2e-4, rtol=1e-4), "bfloat16": dict(atol=0.05, rtol=0.05)}
ATTN_TOL = {"float32": 1e-5, "bfloat16": 4e-3}
MODELS = {"WGATE": (jax_wgate, wgate_from_dataset), "GATE": (jax_gate, gate_from_dataset)}
LR = 5e-4


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _adjacencies():
    spatial = edges_to_dense(BODY29_EDGES, 29, self_loops=False)
    return {"gate_st": adjacency.spatio_temporal_adj(BODY29_EDGES, 4, 29),
            "window": adjacency.windowed_block_adj(2)[0],
            "hgate": adjacency.hgate_block_adj(),
            "spatial": spatial}


@pytest.mark.parametrize("name", ["gate_st", "window", "hgate", "spatial"])
def test_sparse_forms_equal_jax(name):
    adj = _adjacencies()[name]
    if name == "gate_st":
        np.testing.assert_array_equal(adj, jax_adjacency.spatio_temporal_adj(BODY29_EDGES, 4, 29))
    for got, want in zip(adjacency.dense_to_csr(adj), jax_adjacency.dense_to_csr(adj)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for pad in (None, 40):
        for got, want in zip(adjacency.dense_to_ell(adj, pad), jax_adjacency.dense_to_ell(adj, pad)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    for got, want in zip(sparse_attention.ell_from_dense(adj), jax_sparse.ell_from_dense(adj)):
        np.testing.assert_array_equal(got, want)
    assert adjacency.num_edges(adj) == jax_adjacency.num_edges(adj)


@pytest.mark.parametrize("model", ["WGATE", "GATE"])
@pytest.mark.parametrize("frames", [1, 2, 7])
def test_ell_from_band_equals_jax(model, frames):
    spatial = (adjacency.window_adj(window_size=16) if model == "WGATE"
               else edges_to_dense(BODY29_EDGES, 29, self_loops=False))
    plane = make_band(spatial)[1]
    got = sparse_attention.ell_from_band(plane, frames)
    want = jax_sparse.ell_from_band(plane, frames)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    again = sparse_attention.ell_from_band(plane, frames)  # cached
    assert all(a is b for a, b in zip(again, got))
    col, val = sparse_attention.ell_from_band(plane, frames, device="cpu")
    assert col.dtype == torch.int64 and val.dtype == torch.float32
    np.testing.assert_array_equal(col.numpy(), want[0])
    np.testing.assert_array_equal(val.numpy(), want[1])
    assert sparse_attention.ell_from_band(plane, frames, device="cpu")[0] is col


def _gate_tables(frames=6):
    plane = make_band(edges_to_dense(BODY29_EDGES, 29, self_loops=False))[1]
    return sparse_attention.ell_from_band(plane, frames)


def _qkv(seed, shape, dtype=np.float32):
    r = np.random.default_rng(seed)
    return [r.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ell_attention_matches_jax(dtype):
    col, val = _gate_tables()
    q, k, v = _qkv(0, (2, 2, col.shape[0], 16))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (q, k, v))
    got = sparse_attention.ell_graph_attention(tq, tk, tv, col, val, scale=0.25)
    want = jax_sparse.ell_graph_attention(jq, jk, jv, col, val, scale=0.25)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL[dtype], rtol=0)


def test_ell_gradients_match_jax_vjp():
    col, val = _gate_tables()
    q, k, v = _qkv(1, (2, 2, col.shape[0], 16))
    do = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = sparse_attention.ell_graph_attention(*leaves, col, val, scale=0.25)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    _, vjp = jax.vjp(lambda a, b, c: jax_sparse.ell_graph_attention(a, b, c, col, val,
                                                                      scale=0.25),
                     *(jnp.asarray(a) for a in (q, k, v)))
    for name, g, w in zip("qkv", got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=0, err_msg=name)


def test_device_tables_made_in_inference_mode_take_a_gradient():
    plane = make_band(edges_to_dense(BODY29_EDGES, 29, self_loops=False))[1]
    with torch.inference_mode():  # an eval forward caches the tables first
        col, val = sparse_attention.ell_from_band(plane, 5, device="cpu")
    assert not col.is_inference()
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _qkv(4, (1, 2, 5 * 29, 16)))
    sparse_attention.ell_graph_attention(q, k, v, col, val, scale=0.25).sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))


def test_ell_matches_dense_and_banded_attention():
    frames = 6
    col, val = _gate_tables(frames)
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, (2, 2, col.shape[0], 16)))
    got = sparse_attention.ell_graph_attention(q, k, v, col, val, scale=0.25)
    adj = adjacency.spatio_temporal_adj(BODY29_EDGES, frames, 29)
    dense = masked_msa_oracle(q, k, v, add_mask=torch.from_numpy(adjacency.additive_mask(adj))[None],
                              scale=0.25)
    torch.testing.assert_close(got, dense, atol=1e-5, rtol=0)
    band = make_band(edges_to_dense(BODY29_EDGES, 29, self_loops=False))
    planes = [t.reshape(4, -1, 16).contiguous() for t in (q, k, v)]
    banded = banded_attention(*planes, band, scale=0.25).reshape(got.shape)
    torch.testing.assert_close(got, banded, atol=1e-5, rtol=0)


def _jax_variables(name, seed=0, batch=2):
    jm = MODELS[name][0](DS, 2, **SMALL)
    x = np.random.default_rng(seed).random(
        (batch, DS["src_len"], MODEL_NUM_KPS[name], 2)).astype(np.float32)
    init = jax.jit(lambda key, xx: jm.init(key, xx, train=False))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), x)), x


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_ell_logits_match_jax(name, compute_dtype):
    variables, x = _jax_variables(name)
    jm = MODELS[name][0](DS, 2, compute_dtype=compute_dtype, attn_impl="ell", **SMALL)
    want = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(variables, x))
    models = {impl: MODELS[name][1](DS, 2, compute_dtype=compute_dtype, attn_impl=impl, **SMALL)
              for impl in ("ell", "auto")}
    with torch.no_grad():
        for tm in models.values():
            tm.load_state_dict(state_dict_from_jax(variables))
        got = {impl: tm.eval()(torch.from_numpy(x)).numpy() for impl, tm in models.items()}
    np.testing.assert_allclose(got["ell"], want, **TOL[compute_dtype])
    np.testing.assert_allclose(got["ell"], got["auto"], **TOL[compute_dtype])


class _Cfg:
    seed = 0
    optimizer_type = "adamw"
    lr = LR


@pytest.mark.parametrize("name", sorted(MODELS))
def test_ell_train_steps_match_jax(name):
    jm = MODELS[name][0](DS, 2, drop_rate=0.0, attn_impl="ell", **SMALL)
    state, jopt = jax_init_state(jm, _Cfg, (DS["src_len"], MODEL_NUM_KPS[name], 2))
    variables, opt_state = state.variables, state.opt_state
    jstep, _ = jax_make_steps(jm, jopt, donate=False)
    tm = MODELS[name][1](DS, 2, drop_rate=0.0, attn_impl="ell", **SMALL)
    tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, variables)))
    tstep, _ = make_steps(tm, make_optimizer("adamw", LR, tm.parameters()))
    r = np.random.default_rng(1)
    key = jax.random.PRNGKey(0)
    for step in range(3):
        x = r.random((4, DS["src_len"], MODEL_NUM_KPS[name], 2)).astype(np.float32)
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


@pytest.mark.parametrize("impl", ["ell_bf16", "ell_bwd", "ell_bwd_bf16"])
def test_bench_ell_entries_match_jax(impl):
    units = 256
    p = port_bench.inputs(impl, units, device="cpu")
    d = port_bench.draws(impl, units)
    b, h, f, v, dh = (port_bench.ell_batch(units),) + port_bench.BANDED_SHAPE[1:]
    assert b == 1 and p.state.shape == (b, h, f * v, dh)
    col, valid = port_bench.ell_tables(f, v)
    # the JAX bench's topology and edge count (bench_kernel.py:1386-1399)
    dense = np.zeros((f * v, f * v), np.float32)
    spatial = edges_to_dense(BODY29_EDGES, v, self_loops=False)
    for fr in range(f):
        s = slice(fr * v, (fr + 1) * v)
        dense[s, s] = spatial
        if fr > 0:
            pr = slice((fr - 1) * v, fr * v)
            dense[s, pr] = dense[pr, s] = np.eye(v)
    for got, want in zip((col, valid), jax_adjacency.dense_to_ell(dense)):
        np.testing.assert_array_equal(got, want)
    assert p.edges == b * h * int(valid.sum())
    jdt = jnp.bfloat16 if impl.endswith("bf16") else jnp.float32
    jq, jk, jv = (jnp.asarray(d["b" + n].reshape(b, h, f * v, dh)).astype(jdt) for n in "qkv")

    def attn(qq):
        return jax_sparse.ell_graph_attention(qq, jk, jv, col, valid, scale=0.25)

    if "bwd" in impl:
        want = jax.grad(lambda qq: jnp.sum(attn(qq) ** 2))(jq).astype(jdt)
    else:
        want = attn(jq).astype(jdt)
    got = p.body(p.state)
    assert got.dtype == getattr(torch, str(want.dtype))
    scale = float(np.abs(np.asarray(want, np.float32)).max())
    tol = 1e-5 if jdt == jnp.float32 else 2.0**-7  # one bf16 ulp of the output's cast
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol * scale, rtol=0)
    rec = port_bench.measure(impl, units, device="cpu", repeats=1)
    assert rec["edges"] == p.edges and rec["edges_per_sec"] > 0
    assert rec["bound_by"] == "bytes" and rec["launches"] == {}
