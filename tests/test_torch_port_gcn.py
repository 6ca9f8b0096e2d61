"""The port's STGCN and DecoupledGCN against the JAX package's, on the CPU.

Small geometry of the JAX parity tests: ``DS = {"num_class": 7,
"src_len": 16}``, 29 joints × 2. The JAX model initialises the weights, its
parameters are perturbed and its BatchNorm running statistics drawn at
random (a mapping that confused mean, var or the (V, C) flattening of
``data_bn`` would pass on the init statistics 0 and 1), and
``weights.state_dict_from_jax`` carries them into the port.

- eval logits at atol 2e-4 / rtol 1e-4 (f32);
- the port's ``state_dict`` read back by the JAX package's own importer
  (``stgcn_from_torch``, ``decoupled_gcn_from_torch``) gives the same
  logits: the keys are the reference's;
- 3 AdamW steps against the JAX ``make_steps(mutable_stats=True)`` (dropout
  0, DecoupledGCN's keep_prob 1), both in float64: parameters at 2e-4 /
  1e-4, running mean and var at 1e-5 (absolute and relative: DecoupledGCN's
  running variances reach 300), STGCN with ``grad_accum=2`` (the
  statistics advance once per microbatch); the port's float32 first-step
  loss on the same weights;
- DropGraph on an injected Bernoulli draw equal to JAX's at 1e-6,
  statistically against its expected rate, and repeatable from a generator;
- ``graphs.partition`` equal to the JAX package's arrays.
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sl_hwgat_tpu.graphs import partition as jax_partition
from sl_hwgat_tpu.models import build_model as jax_build_model
from sl_hwgat_tpu.models import decoupled_gcn as jax_dgcn
from sl_hwgat_tpu.train import torch_import
from sl_hwgat_tpu.train.loop import make_steps as jax_make_steps
from sl_hwgat_tpu.train.state import make_optimizer as jax_make_optimizer

from sl_hwgat_tpu_torch.graphs import partition
from sl_hwgat_tpu_torch.graphs.skeleton import BODY29_EDGES
from sl_hwgat_tpu_torch.models import build_model
from sl_hwgat_tpu_torch.models import decoupled_gcn as dgcn
from sl_hwgat_tpu_torch.train.loop import make_steps
from sl_hwgat_tpu_torch.train.state import make_optimizer
from sl_hwgat_tpu_torch.weights import state_dict_from_jax

DS = {"num_class": 7, "src_len": 16}
TOL = dict(atol=2e-4, rtol=1e-4)
STATS_TOL = dict(atol=1e-5, rtol=1e-5)
LR = 5e-4
IMPORTERS = {"STGCN": torch_import.stgcn_from_torch,
             "DecoupledGCN": torch_import.decoupled_gcn_from_torch}
# dropout off (STGCN's head dropout, DecoupledGCN's DropGraph) for the step parity
DETERMINISTIC = {"STGCN": dict(dropout_ratio=0.0), "DecoupledGCN": dict(keep_prob=1.0)}


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """The tier-1 run puts six test workers on the machine's cores: torch
    runs these tests on two threads, so that the workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def randomised(variables, seed, perturb=True):
    """Perturbed parameters (``perturb``) and random running statistics."""
    r = np.random.default_rng(seed)

    def param(a):
        a = np.asarray(a)
        if not perturb:
            return a
        if not a.any():  # zero-initialised (biases, the attention convs)
            return (0.02 * r.normal(size=a.shape)).astype(np.float32)
        return (a * (1 + 0.1 * r.normal(size=a.shape))).astype(np.float32)

    def stat(path, a):
        if path[-1].key == "mean":
            return r.uniform(-0.5, 0.5, size=np.shape(a)).astype(np.float32)
        return r.uniform(0.5, 1.5, size=np.shape(a)).astype(np.float32)

    return {"params": jax.tree.map(param, variables["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(stat, variables["batch_stats"])}


@functools.lru_cache(maxsize=None)
def jax_init(name):
    """The JAX model's initial variables, seed 0 (the init does not depend on
    the dropout rates)."""
    jm = jax_build_model(name, DS, 2)
    x = np.zeros((1, DS["src_len"], 29, 2), np.float32)
    init = jax.jit(lambda key, xx: jm.init(key, xx, train=False))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), x))


def jax_variables(name, perturb=True):
    return jax_build_model(name, DS, 2), randomised(jax_init(name), 0, perturb)


def clips(batch, seed):
    return np.random.default_rng(seed).normal(size=(batch, DS["src_len"], 29, 2)).astype(
        np.float32)


@pytest.fixture(scope="module", params=["STGCN", "DecoupledGCN"])
def gcn(request):
    """(name, jitted eval apply, randomised variables) of a JAX model."""
    jm, variables = jax_variables(request.param)
    return request.param, jax.jit(lambda v, xx: jm.apply(v, xx, train=False)), variables


@pytest.mark.parametrize("strategy", ["uniform", "distance", "spatial"])
def test_partition_equals_jax(strategy):
    edges = list(BODY29_EDGES)
    got = partition.GraphPartition(29, 0, edges, strategy=strategy)
    want = jax_partition.GraphPartition(29, 0, edges, strategy=strategy)
    np.testing.assert_array_equal(got.A, want.A)
    np.testing.assert_array_equal(got.hop_dis, want.hop_dis)
    np.testing.assert_array_equal(partition.spatial_graph(29, edges),
                                  jax_partition.spatial_graph(29, edges))


def test_eval_logits_match_jax(gcn):
    name, apply, variables = gcn
    x = clips(3, 1)
    want = np.asarray(apply(variables, x))
    model = build_model(name, DS, 2, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (3, DS["num_class"]) and np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, **TOL)


def test_jax_importer_reads_the_port_state_dict(gcn):
    """The port model's state_dict (its own seeded init, random running
    statistics) through the JAX package's importer gives the port's logits."""
    name, apply, _ = gcn
    model = build_model(name, DS, 2, device="cpu", seed=4)
    g = torch.Generator().manual_seed(5)
    for m in model.modules():
        if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
            m.running_mean.uniform_(-0.5, 0.5, generator=g)
            m.running_var.uniform_(0.5, 1.5, generator=g)
            m.weight.data.uniform_(0.5, 1.5, generator=g)
    x = clips(3, 2)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    variables = jax.tree.map(jnp.asarray, IMPORTERS[name](sd))
    want = np.asarray(apply(variables, x))
    np.testing.assert_allclose(got, want, **TOL)
    # and back: the JAX tree maps onto the port's keys, num_batches_tracked 0
    back = state_dict_from_jax(jax.tree.map(np.asarray, variables))
    assert back.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(back[k]) == 0
        else:
            np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)


def _jax_trajectory(name, variables, batches, grad_accum):
    """The JAX package's 3 steps in float64 → (losses, final variables)."""
    jm = jax_build_model(name, DS, 2, **DETERMINISTIC[name])
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        jopt = jax_make_optimizer("adamw", LR)
        opt_state = jopt.init(v64["params"])
        jstep, _ = jax_make_steps(jm, jopt, rng_streams=("dropout", "dropgraph"),
                                  mutable_stats=True, donate=False, grad_accum=grad_accum)
        losses = []
        for step, (x, y, valid) in enumerate(batches):
            v64, opt_state, loss, _, _ = jstep(v64, opt_state, x.astype(np.float64), y, valid,
                                               jax.random.PRNGKey(0), 0, step)
            losses.append(float(loss))
        return losses, jax.tree.map(np.asarray, v64)


def _port_trajectory(name, variables, batches, grad_accum, dtype):
    model = build_model(name, DS, 2, device="cpu", **DETERMINISTIC[name])
    model.load_state_dict(state_dict_from_jax(variables))
    model = model.to(dtype)
    tstep, _ = make_steps(model, make_optimizer("adamw", LR, model.parameters()),
                          grad_accum=grad_accum)
    losses = [float(tstep(torch.from_numpy(x).to(dtype), torch.from_numpy(y).long(),
                          torch.from_numpy(valid), 0, 0, step)[0])
              for step, (x, y, valid) in enumerate(batches)]
    return losses, model.state_dict()


@pytest.mark.parametrize("name, grad_accum", [("STGCN", 2), ("DecoupledGCN", 1)])
def test_train_steps_match_jax(name, grad_accum):
    """Parameters and statistics are compared in float64 on both sides: on
    the CPU the JAX package's float32 gradients of these models are 0.5% off
    its float64 ones (the port's float32 ones 1e-6), and a conv bias ahead of
    a BatchNorm has a zero gradient in exact arithmetic, so float32 AdamW
    moves it by ±lr on rounding noise in either framework (and the next
    running mean with it)."""
    # the init's parameters: a perturbed model is chaotic under AdamW steps at
    # batch 4
    _, variables = jax_variables(name, perturb=False)
    r = np.random.default_rng(7)
    batches = [(clips(4, 10 + step), r.integers(0, DS["num_class"], size=4).astype(np.int32),
                np.array([1, 1, 1, 0], np.float32)) for step in range(3)]
    want_losses, want_vars = _jax_trajectory(name, variables, batches, grad_accum)
    losses, got = _port_trajectory(name, variables, batches, grad_accum, torch.float64)
    np.testing.assert_allclose(losses, want_losses, **TOL)
    want = state_dict_from_jax(want_vars)
    assert got.keys() == want.keys()
    for k in got:
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 3 * grad_accum, k
            continue
        tol = STATS_TOL if k.endswith(("running_mean", "running_var")) else TOL
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **tol, err_msg=k)
    # float32: the first step's loss (the train-mode forward) on the same
    # weights; after one update DecoupledGCN's float32 trajectory drifts (its
    # 1e-6 BatchNorm scales leave the parameters behind them gradients near
    # AdamW's eps)
    losses32, _ = _port_trajectory(name, variables, batches[:1], grad_accum, torch.float32)
    np.testing.assert_allclose(losses32, want_losses[:1], **TOL)


@pytest.mark.parametrize("name", ["STGCN", "DecoupledGCN"])
def test_stats_move_in_train_mode_only(name):
    ds = {"num_class": 7, "src_len": 8}
    model = build_model(name, ds, 2, device="cpu", **DETERMINISTIC[name])
    before = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 8, 29, 2)).astype(np.float32))
    with torch.no_grad():
        model(x)
        assert all(torch.equal(model.state_dict()[k], v) for k, v in before.items())
        model.train()(x)
    assert all(not torch.equal(model.state_dict()[k], v) for k, v in before.items())


# ---- DropGraph ----------------------------------------------------------------


class _Uniforms:
    """One uniform stream both frameworks read in the same order (the draw
    of ``tests/test_decoupled_gcn_parity.py``)."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.n_draws = 0

    def draw(self, shape):
        self.n_draws += 1
        return self.rng.uniform(size=shape).astype(np.float32)


def _inject(monkeypatch, seed):
    seq_t, seq_j = _Uniforms(seed), _Uniforms(seed)

    def torch_bernoulli(p, generator=None):
        return torch.from_numpy((seq_t.draw(tuple(p.shape)) < p.numpy()).astype(np.float32))

    def jax_bernoulli(rng, p=0.5, shape=None):
        return jnp.asarray(seq_j.draw(np.shape(p))) < p

    monkeypatch.setattr(torch, "bernoulli", torch_bernoulli)
    monkeypatch.setattr(jax.random, "bernoulli", jax_bernoulli)
    return seq_t, seq_j


@pytest.mark.parametrize("block_size", [5, 4, 41])
def test_drop_graph_on_an_injected_draw_equals_jax(monkeypatch, block_size):
    """Keep probability 0.5 so that the draws drop something; an even block
    size checks the max pool's window against JAX's shifted slices."""
    n, c, t, v = 3, 5, 12, 29
    keep_prob = 0.5
    edges = [list(e) for e in BODY29_EDGES]
    adj_sum = partition.spatial_graph(v, edges).astype(np.float32).sum(axis=0)
    drop_size = dgcn.find_drop_size(v, len(edges))
    assert drop_size == jax_dgcn.find_drop_size(v, len(edges))
    x = np.random.default_rng(2).normal(size=(n, c, t, v)).astype(np.float32)
    x_cl = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))  # JAX's (N, T, V, C)
    seq_t, seq_j = _inject(monkeypatch, 3)

    got = dgcn.drop_graph_temporal(torch.from_numpy(x), keep_prob, block_size)
    want = jax_dgcn.drop_graph_temporal(x_cl, keep_prob, block_size, jax.random.key(0))
    np.testing.assert_allclose(got.numpy(), np.transpose(np.asarray(want), (0, 3, 1, 2)),
                               atol=1e-6, rtol=0)
    got = dgcn.drop_graph_spatial(torch.from_numpy(x), keep_prob, torch.from_numpy(adj_sum),
                                  drop_size)
    want = jax_dgcn.drop_graph_spatial(x_cl, keep_prob, jnp.asarray(adj_sum), drop_size,
                                       jax.random.key(0))
    np.testing.assert_allclose(got.numpy(), np.transpose(np.asarray(want), (0, 3, 1, 2)),
                               atol=1e-6, rtol=0)
    assert seq_t.n_draws == seq_j.n_draws == 2


def test_drop_graph_rate_and_generator():
    """Over 400 draws from a seeded generator the share of dropped frames
    (temporal seeds before dilation: block_size 1) and of dropped joints
    (spatial seeds, isolated joints: an identity adjacency) each lie within 4
    binomial standard deviations of the expected rate; two calls on
    generators in the same state drop the same entries."""
    n, c, t, v = 8, 4, 16, 10
    keep_prob = 0.7
    x = torch.ones(n, c, t, v)  # uniform |x|: every seed has p = gamma
    g = torch.Generator().manual_seed(0)
    trials = 400
    dropped_t = dropped_s = 0
    for _ in range(trials):
        y = dgcn.drop_graph_temporal(x, keep_prob, 1, g)
        dropped_t += int((y[:, 0, :, 0] == 0).sum())
        y = dgcn.drop_graph_spatial(x, keep_prob, torch.eye(v), 0.0, g)
        dropped_s += int((y[:, 0, 0, :] == 0).sum())
    for dropped, cells, p in ((dropped_t, n * t, 1 - keep_prob),
                              (dropped_s, n * v, 1 - keep_prob)):
        total = trials * cells
        sd = math.sqrt(total * p * (1 - p))
        assert abs(dropped - total * p) < 4 * sd, (dropped, total * p, sd)

    xr = torch.from_numpy(np.random.default_rng(1).normal(size=(n, c, t, v)).astype(np.float32))
    adj = torch.from_numpy(partition.spatial_graph(v, [(i, i + 1) for i in range(v - 1)])
                           .astype(np.float32).sum(axis=0))
    a = dgcn.drop_graph_spatial(dgcn.drop_graph_temporal(xr, 0.5, 5, torch.Generator()
                                                         .manual_seed(9)), 0.5, adj, 2.0,
                                torch.Generator().manual_seed(9))
    b = dgcn.drop_graph_spatial(dgcn.drop_graph_temporal(xr, 0.5, 5, torch.Generator()
                                                         .manual_seed(9)), 0.5, adj, 2.0,
                                torch.Generator().manual_seed(9))
    assert torch.equal(a, b) and bool((a == 0).any())


def test_reference_pt_loads_without_its_graph_buffers(tmp_path):
    """A reference ``.pt`` carries the graph buffers (STGCN's ``A``,
    DecoupledGCN's ``A`` and ``eye_list``); ``weights.load_state_dict``
    drops them (the port rebuilds them) and keeps ``decoupled_A``."""
    from sl_hwgat_tpu_torch.weights import load_state_dict

    for name, extra in (("STGCN", ("A",)), ("DecoupledGCN", ("l1.gcn1.A", "l1.gcn1.eye_list"))):
        model = build_model(name, DS, 2, device="cpu")
        sd = {f"model.{k}": v for k, v in model.state_dict().items()}
        sd.update({f"model.{k}": torch.zeros(3, 29, 29) for k in extra})
        torch.save({"model_state_dict": sd}, tmp_path / f"{name}.pt")
        loaded = load_state_dict(str(tmp_path / f"{name}.pt"))
        assert loaded.keys() == model.state_dict().keys()
        model.load_state_dict(loaded)
