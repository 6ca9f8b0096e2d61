"""HGATE over dp, sp and tp and the Transformer over dp and tp, on 4 gloo
CPU ranks, against the port's unsharded steps and the JAX ``make_steps``.

One spawn of 4 ranks (``parallel.dryrun.run_jobs``) runs every job:

- HGATE (embed 32, depths (2, 2), heads (2, 4), 16 frames, 6 classes,
  dropout off) at meshes (1, 2, 2) and (2, 2, 1), from the JAX model's
  initial weights (``weights.state_dict_from_jax``), batch 8 with one padded
  row: eval logits, one AdamW step (loss, counts, summed gradients,
  parameters) and the eval step after it. At tp 2 stage 0 holds one head a
  rank, so the shifted blocks run one 58-token unit a supertile, and at sp
  2 only the last rank holds a clip's last temporal group (the tail mask);
- HGATE's ``attn_impl="hybrid"`` eval logits at (1, 2, 2);
- HGATE ``remat=True`` at (1, 2, 2) with dropout on, against the same step
  without remat: the recompute replays each rank's masks and ring exchange;
- the Transformer (d 32, 2 heads, FFN 64, 1 layer, SYNTH's 32 frames and 16
  classes, padded frames) at (2, 1, 2): f32 eval logits, and one AdamW
  step in f64 (its key bias has no gradient in exact arithmetic, so in f32
  AdamW moves it by rounding noise), whose gathered parameters are then
  served by ``Predictor.from_checkpoint`` and read by
  ``load_pretrained_into``.

Bars: logits, losses and parameters 2e-4 / 1e-4, gradients 5e-5 (as
``tests/test_torch_port_parallel_hwgate.py``). The ranks' kernel launches
are counted on the card only (``chip_smoke.py``'s parallel phase).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sl_hwgat_tpu.models import build_model as jax_build_model
from sl_hwgat_tpu.models.hgate import hgate_from_dataset as jax_hgate
from sl_hwgat_tpu.train.loop import init_state as jax_init_state
from sl_hwgat_tpu.train.loop import make_steps as jax_make_steps
from sl_hwgat_tpu.train.state import make_optimizer as jax_make_optimizer

from sl_hwgat_tpu_torch.constants import DATASET_PARAMS
from sl_hwgat_tpu_torch.models import build_model
from sl_hwgat_tpu_torch.parallel.dryrun import run_jobs
from sl_hwgat_tpu_torch.train.checkpoint import load_pretrained_into, save_checkpoint
from sl_hwgat_tpu_torch.train.loop import make_steps
from sl_hwgat_tpu_torch.train.state import TrainState, make_optimizer
from sl_hwgat_tpu_torch.weights import params_from_jax, state_dict_from_jax

DS = {"num_class": 6, "src_len": 16}
HGATE_CONFIG = dict(embed_dim=32, depths=(2, 2), num_heads=(2, 4), drop_rate=0.0)
SYNTH = DATASET_PARAMS["SYNTH"]
TRANSFORMER_CONFIG = dict(d_model=32, nhead=2, dim_feedforward=64, num_encoder_layers=1,
                          dropout=0.0)
TOL = dict(atol=2e-4, rtol=1e-4)
GRAD_ATOL = 5e-5
LR = 5e-4
HGATE_MESHES = [(1, 2, 2), (2, 2, 1)]


class _Cfg:
    seed = 0
    optimizer_type = "adamw"
    lr = LR


def _batch(frames, joints, classes, seed, pad_frames=False):
    r = np.random.default_rng(seed)
    x = r.random((8, frames, joints, 2)).astype(np.float32)
    if pad_frames:
        x[1, 20:] = -1.0  # the Transformer's key padding
        x[5, 9:] = -1.0
    y = r.integers(0, classes, size=8).astype(np.int32)
    valid = np.ones(8, np.float32)
    valid[-1] = 0.0
    return x, y, valid


def _save(work, name, sd, batch):
    torch.save(sd, work / f"{name}.state.pt")
    torch.save((torch.from_numpy(batch[0]), torch.from_numpy(batch[1]).long(),
                torch.from_numpy(batch[2])), work / f"{name}.batch.pt")


def _job(work, name, model, ds, mesh, steps, overrides, state=None, **kw):
    return dict(model=model, dataset=ds, overrides=overrides,
                state=str(work / f"{state or name}.state.pt"),
                batch=str(work / f"{state or name}.batch.pt"), mesh=mesh, device="cpu",
                steps=steps, out=str(work / f"{name}.out.pt"), **kw)


def _jax_hgate(batch):
    jm = jax_hgate(DS, 2, **HGATE_CONFIG)
    state, jopt = jax_init_state(jm, _Cfg, (DS["src_len"], 29, 2))
    x, y, valid = (jnp.asarray(t) for t in batch)
    logits = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(
        state.variables, x))
    jstep, _ = jax_make_steps(jm, jopt, donate=False)
    variables, _, loss, correct, seen = jstep(state.variables, state.opt_state, x, y, valid,
                                              jax.random.PRNGKey(0), 0, 0)
    sd = state_dict_from_jax(jax.tree.map(np.asarray, state.variables))
    return sd, {"logits": logits, "loss": float(loss), "correct": float(correct),
                "seen": float(seen),
                "params": params_from_jax(jax.tree.map(np.asarray, variables["params"]))}


def _jax_transformer(batch):
    jm = jax_build_model("Transformer", SYNTH, 2, **TRANSFORMER_CONFIG)
    x32 = jnp.asarray(batch[0])
    variables = jax.jit(lambda key, xx: jm.init(key, xx, train=False))(
        jax.random.PRNGKey(0), x32[:1])
    logits = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(variables, x32))
    sd = state_dict_from_jax(jax.tree.map(np.asarray, variables))
    jopt = jax_make_optimizer("adamw", LR)
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), variables)
        jstep, _ = jax_make_steps(jm, jopt, donate=False)
        v64, _, loss, correct, seen = jstep(v64, jopt.init(v64["params"]),
                                            batch[0].astype(np.float64), batch[1], batch[2],
                                            jax.random.PRNGKey(0), 0, 0)
        params = params_from_jax(jax.tree.map(np.asarray, v64["params"]))
    return sd, {"logits": logits, "loss": float(loss), "correct": float(correct),
                "seen": float(seen), "params": params}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every sharded job in one 4-rank spawn, and the JAX results."""
    work = tmp_path_factory.mktemp("hgate_parallel")
    hgate_batch = _batch(DS["src_len"], 29, DS["num_class"], 0)
    hgate_sd, hgate_jax = _jax_hgate(hgate_batch)
    _save(work, "hgate", hgate_sd, hgate_batch)
    tr_batch = _batch(SYNTH["src_len"], 29, SYNTH["num_class"], 1, pad_frames=True)
    tr_sd, tr_jax = _jax_transformer(tr_batch)
    _save(work, "transformer", tr_sd, tr_batch)
    full = ["logits", "train", "params", "eval"]
    jobs = {f"hgate{''.join(map(str, m))}": _job(work, f"hgate{''.join(map(str, m))}", "HGATE",
                                                   DS, m, full, HGATE_CONFIG, state="hgate")
            for m in HGATE_MESHES}
    jobs["hybrid"] = _job(work, "hybrid", "HGATE", DS, (1, 2, 2), ["logits"],
                          dict(HGATE_CONFIG, attn_impl="hybrid"), state="hgate")
    for remat in (False, True):
        jobs[f"dropout_remat{int(remat)}"] = _job(
            work, f"dropout_remat{int(remat)}", "HGATE", DS, (1, 2, 2), ["train"],
            dict(HGATE_CONFIG, drop_rate=0.1, remat=remat), state="hgate", seed=3)
    jobs["transformer_f32"] = _job(work, "transformer_f32", "Transformer", SYNTH, (2, 1, 2),
                                   ["logits"], TRANSFORMER_CONFIG, state="transformer")
    jobs["transformer"] = _job(work, "transformer", "Transformer", SYNTH, (2, 1, 2),
                               ["train", "params", "eval"], TRANSFORMER_CONFIG,
                               dtype="float64")
    results = dict(zip(jobs, run_jobs(list(jobs.values()), 4)))
    batches = {"hgate": hgate_batch, "transformer": tr_batch}
    sds = {"hgate": hgate_sd, "transformer": tr_sd}
    return work, results, batches, sds, {"hgate": hgate_jax, "transformer": tr_jax}


def _unsharded(name, ds, config, sd, batch, dtype=torch.float32, **overrides):
    """The port's unsharded eval logits, then one train step → (logits,
    (loss, correct, seen), model)."""
    model = build_model(name, ds, 2, device="cpu", **config, **overrides)
    model.load_state_dict(sd)
    model.to(dtype)
    x, y, valid = (torch.from_numpy(batch[0]).to(dtype), torch.from_numpy(batch[1]).long(),
                   torch.from_numpy(batch[2]))
    model.eval()
    with torch.no_grad():
        logits = model(x)
    step, _ = make_steps(model, make_optimizer("adamw", LR, model.parameters()))
    out = step(x, y, valid, 0, 0, 0)
    return logits, [t.item() for t in out], model


def _check_step(got, want_loss, want_counts, model, jax_out):
    """A sharded train step's loss, counts, gradients and parameters against
    the unsharded step's ``model`` and JAX's step."""
    np.testing.assert_allclose(got["train"][0].item(), want_loss, **TOL)
    np.testing.assert_allclose(got["train"][0].item(), jax_out["loss"], **TOL)
    assert got["train"][1:].tolist() == want_counts == [jax_out["correct"], 7.0]
    for k, p in model.named_parameters():
        np.testing.assert_allclose(got["grads"][k].numpy(), p.grad.numpy(), atol=GRAD_ATOL,
                                   err_msg=k)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), **TOL, err_msg=k)
    for k, v in jax_out["params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), np.asarray(v), **TOL, err_msg=k)


@pytest.mark.parametrize("mesh", HGATE_MESHES)
def test_sharded_hgate_matches_port_and_jax(runs, mesh):
    _, results, batches, sds, jax_outs = runs
    got, ranks = results[f"hgate{''.join(map(str, mesh))}"]
    logits, (loss, correct, seen), model = _unsharded("HGATE", DS, HGATE_CONFIG, sds["hgate"],
                                                      batches["hgate"])
    np.testing.assert_allclose(got["logits"].numpy(), logits.numpy(), **TOL)
    np.testing.assert_allclose(got["logits"].numpy(), jax_outs["hgate"]["logits"], **TOL)
    _check_step(got, loss, [correct, seen], model, jax_outs["hgate"])
    model.eval()
    with torch.no_grad():
        after = model(torch.from_numpy(batches["hgate"][0]))
    assert torch.equal(got["eval_argmax"], after.argmax(-1))
    assert got["eval"][2].item() == 7.0
    assert sorted(tuple(r["coords"].values()) for r in ranks) == sorted(
        (d, s, t) for d in range(mesh[0]) for s in range(mesh[1]) for t in range(mesh[2]))


def test_sharded_hgate_hybrid_matches_the_unsharded_hybrid_forward(runs):
    _, results, batches, sds, _ = runs
    got, _ = results["hybrid"]
    logits, _, _ = _unsharded("HGATE", DS, HGATE_CONFIG, sds["hgate"], batches["hgate"],
                              attn_impl="hybrid")
    np.testing.assert_allclose(got["logits"].numpy(), logits.numpy(), **TOL)


def test_sharded_hgate_remat_replays_each_ranks_dropout_and_ring(runs):
    """At sp 2 and tp 2 with dropout on, the remat step's loss and gradients
    are the step's without remat (the same masks, drawn and replayed on
    each rank; the same ring exchange, issued again in the recompute)."""
    _, results, _, _, _ = runs
    plain, _ = results["dropout_remat0"]
    rematted, _ = results["dropout_remat1"]
    assert rematted["train"].tolist() == plain["train"].tolist()
    for k, g in plain["grads"].items():
        np.testing.assert_allclose(rematted["grads"][k].numpy(), g.numpy(), atol=1e-6,
                                   err_msg=k)
    # dropout is on: the loss is not the dropout-free step's
    assert rematted["train"][0].item() != results["hgate122"][0]["train"][0].item()


def test_sharded_transformer_matches_port_and_jax(runs):
    _, results, batches, sds, jax_outs = runs
    got32, _ = results["transformer_f32"]
    logits, _, _ = _unsharded("Transformer", SYNTH, TRANSFORMER_CONFIG, sds["transformer"],
                              batches["transformer"])
    np.testing.assert_allclose(got32["logits"].numpy(), logits.numpy(), **TOL)
    np.testing.assert_allclose(got32["logits"].numpy(), jax_outs["transformer"]["logits"],
                               **TOL)
    got, _ = results["transformer"]
    _, (loss, correct, seen), model = _unsharded(
        "Transformer", SYNTH, TRANSFORMER_CONFIG, sds["transformer"], batches["transformer"],
        dtype=torch.float64)
    _check_step(got, loss, [correct, seen], model, jax_outs["transformer"])
    assert got["eval"][2].item() == 7.0


def test_gathered_transformer_checkpoint_serves_and_transfers(runs):
    """The tp ranks' parameters gathered into the unsharded layout make a
    checkpoint that ``Predictor.from_checkpoint`` serves and
    ``load_pretrained_into`` reads, as the unsharded model's."""
    from sl_hwgat_tpu_torch.serve import Predictor

    work, results, batches, _, _ = runs
    params = results["transformer"][0]["params"]
    model = build_model("Transformer", SYNTH, 2, device="cpu", **TRANSFORMER_CONFIG)
    model.load_state_dict({k: v.float() for k, v in params.items()})
    path = str(work / "transformer_best_loss.ckpt")
    save_checkpoint(path, TrainState(model, make_optimizer("adamw", LR, model.parameters())),
                    LR)
    pred = Predictor.from_checkpoint(path, model_type="Transformer", dataset="SYNTH",
                                     device="cpu", **TRANSFORMER_CONFIG)
    x = torch.from_numpy(batches["transformer"][0])
    model.eval()
    with torch.no_grad():
        assert torch.equal(pred.model(x), model(x))
    fresh = build_model("Transformer", SYNTH, 2, device="cpu", seed=9, **TRANSFORMER_CONFIG)
    load_pretrained_into(TrainState(fresh, None), path, verbose=False)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
