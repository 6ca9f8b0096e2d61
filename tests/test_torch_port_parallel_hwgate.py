"""HWGATE's sharded train and eval steps on 4 gloo CPU ranks, against the
port's unsharded steps and the JAX package's ``make_steps``.

At the config of ``tests/test_sharding.py`` (16 frames, 6 classes, embed
32, depths (1, 1), heads (2, 2)), batch 8 with one padded row, meshes
(1, 2, 2) and (2, 2, 1), dropout off: the JAX model's initial weights go to
both ports through ``weights.state_dict_from_jax``, and after one AdamW
step the loss, the global counts, the eval logits (before the step) and
every parameter are within 2e-4 / 1e-4 of the port's unsharded step and of
JAX's, and the summed gradients within 5e-5 of the unsharded step's (pruning off for the JAX comparison: the two frameworks draw other
prune scalars; the sharded step draws the unsharded step's scalars, so
against the port it runs with pruning on too, and with ``grad_accum=2``).
``attn_impl="hybrid"``'s eval logits at (1, 2, 2) against the unsharded
hybrid forward. The ranks run ``parallel.dryrun.step_worker``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sl_hwgat_tpu.models.hwgate import hwgate_from_dataset as jax_hwgate
from sl_hwgat_tpu.train.loop import init_state as jax_init_state
from sl_hwgat_tpu.train.loop import make_steps as jax_make_steps

from sl_hwgat_tpu_torch.models.hwgate import hwgate_from_dataset
from sl_hwgat_tpu_torch.parallel.dryrun import run_jobs
from sl_hwgat_tpu_torch.train.loop import make_steps
from sl_hwgat_tpu_torch.train.state import make_optimizer
from sl_hwgat_tpu_torch.weights import params_from_jax, state_dict_from_jax

DS = {"num_class": 6, "src_len": 16}
CONFIG = dict(embed_dim=32, depths=(1, 1), num_heads=(2, 2), drop_rate=0.0)
TOL = dict(atol=2e-4, rtol=1e-4)
LR = 5e-4


class _Cfg:
    seed = 0
    optimizer_type = "adamw"
    lr = LR


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX's initial weights as a port state_dict, a batch, and JAX's step
    results (pruning off): eval logits, loss, params after one step."""
    jm = jax_hwgate(DS, 2, stream_layout="token", prune_attn=False, **CONFIG)
    state, jopt = jax_init_state(jm, _Cfg, (DS["src_len"], 64, 2))
    r = np.random.default_rng(0)
    x = r.normal(size=(8, 16, 64, 2)).astype(np.float32)
    y = r.integers(0, 6, size=8).astype(np.int32)
    valid = np.ones(8, np.float32)
    valid[-1] = 0.0
    logits = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(
        state.variables, jnp.asarray(x)))
    jstep, _ = jax_make_steps(jm, jopt, donate=False)
    variables, _, loss, correct, seen = jstep(
        state.variables, state.opt_state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(valid),
        jax.random.PRNGKey(0), 0, 0)
    work = tmp_path_factory.mktemp("hwgate_parallel")
    sd = state_dict_from_jax(jax.tree.map(np.asarray, state.variables))
    torch.save(sd, work / "state.pt")
    batch = (torch.from_numpy(x), torch.from_numpy(y).long(), torch.from_numpy(valid))
    torch.save(batch, work / "batch.pt")
    jax_out = {"logits": logits, "loss": float(loss), "correct": float(correct),
               "seen": float(seen),
               "params": params_from_jax(jax.tree.map(np.asarray, variables["params"]))}
    return work, sd, batch, jax_out


def _job(work, mesh, name, **kw):
    job = dict(model="HWGATE", dataset=DS, overrides=dict(CONFIG, prune_attn=False),
               state=str(work / "state.pt"), batch=str(work / "batch.pt"), mesh=mesh,
               device="cpu", steps=["logits", "train", "params", "eval"],
               out=str(work / f"{name}.pt"))
    job.update(kw)
    return job


def _unsharded(sd, batch, grad_accum=1, **overrides):
    """The port's unsharded eval logits, then one train step → (logits,
    (loss, correct, seen), model)."""
    model = hwgate_from_dataset(DS, 2, **{**CONFIG, "prune_attn": False, **overrides})
    model.load_state_dict(sd)
    model.eval()
    with torch.no_grad():
        logits = model(batch[0])
    step, _ = make_steps(model, make_optimizer("adamw", LR, model.parameters()),
                         grad_accum=grad_accum)
    out = step(*batch, 0, 0, 0)
    return logits, [t.item() for t in out], model


def _close_params(got: dict, want: dict):
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), **TOL, err_msg=k)


@pytest.mark.parametrize("mesh", [(1, 2, 2), (2, 2, 1)])
def test_sharded_steps_match_port_and_jax(setup, mesh):
    work, sd, batch, jax_out = setup
    got, ranks = run_jobs([_job(work, mesh, f"m{''.join(map(str, mesh))}")], 4)[0]
    logits, (loss, correct, seen), model = _unsharded(sd, batch)
    np.testing.assert_allclose(got["logits"].numpy(), logits.numpy(), **TOL)
    np.testing.assert_allclose(got["logits"].numpy(), jax_out["logits"], **TOL)
    np.testing.assert_allclose(got["train"][0].item(), loss, **TOL)
    np.testing.assert_allclose(got["train"][0].item(), jax_out["loss"], **TOL)
    assert got["train"][1:].tolist() == [correct, seen] == [jax_out["correct"], 7.0]
    # the summed gradients: AdamW's first update is about lr·sign(g), so the
    # parameters alone would pass a gradient off by a factor
    for k, p in model.named_parameters():
        np.testing.assert_allclose(got["grads"][k].numpy(), p.grad.numpy(), atol=5e-5,
                                   err_msg=k)
    _close_params(got["params"], {k: v.detach() for k, v in model.state_dict().items()})
    _close_params(got["params"], jax_out["params"])
    # the eval step after the update: global loss, counts and argmax
    model.eval()
    with torch.no_grad():
        after = model(batch[0])
    assert torch.equal(got["eval_argmax"], after.argmax(-1))
    assert got["eval"][2].item() == 7.0
    # every rank ran its steps and saw the mesh it was given
    assert sorted(tuple(r["coords"].values()) for r in ranks) == sorted(
        (d, s, t) for d in range(mesh[0]) for s in range(mesh[1]) for t in range(mesh[2]))


def test_pruning_and_grad_accum_match_the_unsharded_port(setup):
    """Pruning on (every rank takes the unsharded step's scalars) and two
    microbatches a step, at (1, 2, 2)."""
    work, sd, batch, _ = setup
    job = _job(work, (1, 2, 2), "prune_ga", overrides=dict(CONFIG, prune_attn=True),
               grad_accum=2, steps=["train", "params"])
    got, _ = run_jobs([job], 4)[0]
    _, (loss, correct, seen), model = _unsharded(sd, batch, grad_accum=2, prune_attn=True)
    np.testing.assert_allclose(got["train"][0].item(), loss, **TOL)
    assert got["train"][1:].tolist() == [correct, seen]
    grads = {k: p.grad for k, p in model.named_parameters()}
    for k, g in grads.items():
        np.testing.assert_allclose(got["grads"][k].numpy(), g.numpy(), atol=5e-5, err_msg=k)
    _close_params(got["params"], {k: v.detach() for k, v in model.state_dict().items()})


def test_hybrid_eval_matches_the_unsharded_hybrid_forward(setup):
    work, sd, batch, _ = setup
    job = _job(work, (1, 2, 2), "hybrid", overrides=dict(CONFIG, attn_impl="hybrid"),
               steps=["logits"])
    got, _ = run_jobs([job], 4)[0]
    logits, _, _ = _unsharded(sd, batch, attn_impl="hybrid")
    np.testing.assert_allclose(got["logits"].numpy(), logits.numpy(), **TOL)
