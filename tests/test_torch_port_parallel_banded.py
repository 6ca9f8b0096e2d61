"""The halo-exchange banded attention and the dp BatchNorm on gloo CPU
ranks, against the JAX package and the port's unsharded ops.

- ``edge_partition.call_sharded_banded`` on 2 and 4 sp ranks, at the
  shapes of ``tests/test_edge_partition.py`` with dh 16 (the banded
  kernels' contract): the output within 1e-5 of JAX's
  ``sharded_banded_frame_attention`` (virtual CPU mesh) and of the port's
  unsharded op, dq, dk and dv of sum(o·cos o) within 2e-5 of the unsharded
  op's;
- WGATE's and GATE's sharded train step at (2, 2, 1), from the JAX
  model's initial weights, against the port's unsharded step and JAX's
  ``make_steps`` (loss, counts, logits and the parameters after one AdamW
  step at 2e-4 / 1e-4; the gradients within 5e-5 of the unsharded port's);
- a dp = 2 STGCN step in float64 against the JAX ``make_steps
  (mutable_stats=True)`` step on the global batch: the BatchNorm statistics
  are the global batch's (running mean and var at 1e-5), as in
  ``tests/test_torch_port_gcn.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from sl_hwgat_tpu.graphs.skeleton import BODY29_EDGES
from sl_hwgat_tpu.models import build_model as jax_build_model
from sl_hwgat_tpu.models.gate import gate_from_dataset as jax_gate
from sl_hwgat_tpu.models.wgate import wgate_from_dataset as jax_wgate
from sl_hwgat_tpu.parallel.edge_partition import sharded_banded_frame_attention
from sl_hwgat_tpu.train.loop import init_state as jax_init_state
from sl_hwgat_tpu.train.loop import make_steps as jax_make_steps
from sl_hwgat_tpu.train.state import make_optimizer as jax_make_optimizer

from sl_hwgat_tpu_torch.graphs.adjacency import additive_mask, window_adj
from sl_hwgat_tpu_torch.graphs.skeleton import edges_to_dense
from sl_hwgat_tpu_torch.models import build_model
from sl_hwgat_tpu_torch.ops.banded_attention import banded_attention
from sl_hwgat_tpu_torch.parallel.dryrun import halo_worker, run_jobs, spawn
from sl_hwgat_tpu_torch.train.loop import make_steps
from sl_hwgat_tpu_torch.train.state import make_optimizer
from sl_hwgat_tpu_torch.weights import params_from_jax, state_dict_from_jax

TOL = dict(atol=2e-4, rtol=1e-4)
LR = 5e-4


def _band(vtok, spatial):
    eye = np.eye(vtok, dtype=np.float32)
    return np.stack([additive_mask(eye), additive_mask(spatial), additive_mask(eye)])


@pytest.mark.parametrize("shards, f, vtok, g, h, scale", [
    (2, 16, 29, 2, 2, 0.3),   # GATE's body graph
    (4, 16, 29, 2, 2, 0.3),
    (4, 8, 16, 1, 2, 0.5),    # WGATE's 16-joint window
])
def test_halo_attention_matches_jax_and_the_unsharded_op(tmp_path, shards, f, vtok, g, h,
                                                         scale):
    dh = 16
    r = np.random.default_rng(0 if vtok == 29 else 1)
    q, k, v = (r.normal(size=(g, h, f, vtok, dh)).astype(np.float32) for _ in range(3))
    spatial = (edges_to_dense(BODY29_EDGES, vtok, self_loops=False) if vtok == 29
               else window_adj(window_size=vtok))
    band = _band(vtok, spatial)
    mesh = Mesh(np.asarray(jax.devices()[:shards]).reshape(shards), ("sp",))
    want_jax = np.asarray(sharded_banded_frame_attention(
        *(jnp.asarray(t) for t in (q, k, v)), jnp.asarray(band), mesh=mesh, axis="sp",
        scale=scale)).reshape(g * h, f * vtok, dh)
    planes = [torch.from_numpy(t.reshape(g * h, f * vtok, dh)).requires_grad_()
              for t in (q, k, v)]
    out = banded_attention(*planes, band, scale=scale)
    torch.sum(out * torch.cos(out)).backward()
    torch.save((*(p.detach() for p in planes), torch.from_numpy(band)), tmp_path / "qkv.pt")
    job = dict(qkv=str(tmp_path / "qkv.pt"), scale=scale, device="cpu",
               out=str(tmp_path / "out.pt"))
    spawn(halo_worker, shards, job)
    got = torch.load(tmp_path / "out.pt")
    np.testing.assert_allclose(got["out"].numpy(), want_jax, atol=1e-5)
    np.testing.assert_allclose(got["out"].numpy(), out.detach().numpy(), atol=1e-5)
    for name, p in zip(("dq", "dk", "dv"), planes):
        np.testing.assert_allclose(got[name].numpy(), p.grad.numpy(), atol=2e-5, err_msg=name)


def _unsharded_step(name, overrides, sd, batch, dtype=torch.float32):
    model = build_model(name, DS_BANDED if name != "STGCN" else DS_GCN, 2, device="cpu",
                        **overrides)
    model.load_state_dict(sd)
    model.to(dtype)
    model.eval()
    x, y, valid = batch
    x = x.to(dtype)
    with torch.no_grad():
        logits = model(x)
    step, _ = make_steps(model, make_optimizer("adamw", LR, model.parameters()))
    out = step(x, y, valid, 0, 0, 0)
    return logits, [t.item() for t in out], model


DS_BANDED = {"num_class": 6, "src_len": 16}
BANDED = dict(embed_dim=32, depths=2, num_heads=2, drop_rate=0.0)
JAX_BANDED = {"WGATE": jax_wgate, "GATE": jax_gate}


class _Cfg:
    seed = 0
    optimizer_type = "adamw"
    lr = LR


@pytest.mark.parametrize("name, kps", [("WGATE", 64), ("GATE", 29)])
def test_banded_models_sharded_step_matches_the_unsharded_port(tmp_path, name, kps):
    """At (2, 2, 1), from the JAX model's initial weights: eval logits, loss,
    counts and the parameters after one AdamW step against the port's
    unsharded step and JAX's ``make_steps``, the gradients against the
    unsharded port's."""
    jm = JAX_BANDED[name](DS_BANDED, 2, **BANDED)
    state, jopt = jax_init_state(jm, _Cfg, (DS_BANDED["src_len"], kps, 2))
    sd = state_dict_from_jax(jax.tree.map(np.asarray, state.variables))
    r = np.random.default_rng(4)
    x = torch.from_numpy(r.normal(size=(8, 16, kps, 2)).astype(np.float32))
    y = torch.from_numpy(r.integers(0, 6, size=8)).long()
    valid = torch.ones(8)
    valid[-1] = 0.0
    jax_logits = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(
        state.variables, jnp.asarray(x.numpy())))
    jstep, _ = jax_make_steps(jm, jopt, donate=False)
    variables, _, jloss, jcorrect, jseen = jstep(
        state.variables, state.opt_state, *(jnp.asarray(t.numpy()) for t in (x, y, valid)),
        jax.random.PRNGKey(0), 0, 0)
    jax_params = params_from_jax(jax.tree.map(np.asarray, variables["params"]))
    torch.save(sd, tmp_path / "state.pt")
    torch.save((x, y, valid), tmp_path / "batch.pt")
    job = dict(model=name, dataset=DS_BANDED, overrides=BANDED, state=str(tmp_path / "state.pt"),
               batch=str(tmp_path / "batch.pt"), mesh=(2, 2, 1), device="cpu", use_tp=False,
               steps=["logits", "train", "params"], out=str(tmp_path / "out.pt"))
    got, ranks = run_jobs([job], 4)[0]
    logits, (loss, correct, seen), ref = _unsharded_step(name, BANDED, sd, (x, y, valid))
    np.testing.assert_allclose(got["logits"].numpy(), logits.numpy(), **TOL)
    np.testing.assert_allclose(got["logits"].numpy(), jax_logits, **TOL)
    np.testing.assert_allclose(got["train"][0].item(), loss, **TOL)
    np.testing.assert_allclose(got["train"][0].item(), float(jloss), **TOL)
    assert got["train"][1:].tolist() == [correct, seen] == [float(jcorrect), float(jseen)]
    for k, p in ref.named_parameters():
        np.testing.assert_allclose(got["grads"][k].numpy(), p.grad.numpy(), atol=5e-5,
                                   err_msg=k)
    for k, v in ref.state_dict().items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), **TOL, err_msg=k)
    for k, v in jax_params.items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), **TOL, err_msg=k)
    assert len(ranks) == 4


DS_GCN = {"num_class": 7, "src_len": 16}


def test_dp_stgcn_step_takes_global_batch_statistics(tmp_path):
    jm = jax_build_model("STGCN", DS_GCN, 2, dropout_ratio=0.0)
    x0 = np.zeros((1, 16, 29, 2), np.float32)
    variables = jax.tree.map(np.asarray, jax.jit(lambda key, xx: jm.init(key, xx, train=False))(
        jax.random.PRNGKey(0), x0))
    r = np.random.default_rng(7)
    x = r.normal(size=(4, 16, 29, 2)).astype(np.float32)
    y = r.integers(0, 7, size=4).astype(np.int32)
    valid = np.array([1, 1, 1, 0], np.float32)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        jopt = jax_make_optimizer("adamw", LR)
        jstep, _ = jax_make_steps(jm, jopt, rng_streams=("dropout", "dropgraph"),
                                  mutable_stats=True, donate=False)
        v64, _, jloss, _, _ = jstep(v64, jopt.init(v64["params"]), x.astype(np.float64), y,
                                    valid, jax.random.PRNGKey(0), 0, 0)
        want = state_dict_from_jax(jax.tree.map(np.asarray, v64))
        jloss = float(jloss)
    sd = state_dict_from_jax(variables)
    torch.save(sd, tmp_path / "state.pt")
    batch = (torch.from_numpy(x), torch.from_numpy(y).long(), torch.from_numpy(valid))
    torch.save(batch, tmp_path / "batch.pt")
    overrides = dict(dropout_ratio=0.0)
    job = dict(model="STGCN", dataset=DS_GCN, overrides=overrides, state=str(tmp_path / "state.pt"),
               batch=str(tmp_path / "batch.pt"), mesh=(2, 1, 1), device="cpu", dtype="float64",
               steps=["train", "params"], out=str(tmp_path / "out.pt"))
    got, _ = run_jobs([job], 2)[0]
    _, (loss, _, _), ref = _unsharded_step("STGCN", overrides, sd,
                                           (batch[0].double(), *batch[1:]), torch.float64)
    np.testing.assert_allclose(got["train"][0].item(), jloss, **TOL)
    np.testing.assert_allclose(got["train"][0].item(), loss, atol=1e-10)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got["params"][k]) == 1, k
            continue
        tol = dict(atol=1e-5, rtol=1e-5) if k.endswith(("running_mean", "running_var")) else TOL
        np.testing.assert_allclose(got["params"][k].numpy(), w.numpy(), **tol, err_msg=k)
        # the pre-BatchNorm conv biases have a zero gradient in exact arithmetic
        # and move on rounding noise: 1e-8 holds them, 1e-10 the loss
        np.testing.assert_allclose(got["params"][k].numpy(), ref.state_dict()[k].numpy(),
                                   atol=1e-8, err_msg=k)
