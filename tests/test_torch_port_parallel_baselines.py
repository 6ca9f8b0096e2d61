"""STGCN, DecoupledGCN and the Transformer split over dp, sp and tp on 4
gloo CPU ranks, against the port's unsharded steps and the JAX package.

One spawn of 4 ranks (``parallel.dryrun.run_jobs``) runs every sharded
job, in float64 where a step is held (as ``tests/test_torch_port_gcn.py``
holds the GCN trajectories):

- STGCN and DecoupledGCN at mesh (2, 2, 1), SYNTH's 32 frames, batch 8 with
  one padded row, dropout and DropGraph off: eval logits, one AdamW step
  (loss, counts, gradients, parameters and running statistics) and the
  eval step, against the unsharded port and JAX's ``make_steps``; sp 2
  puts the temporal convolutions' halo and the stride-2 blocks across the
  split, and every BatchNorm takes dp × sp statistics;
- STGCN at (1, 4, 1) on 64 frames (4 frames a rank at the coarsest block):
  logits and one step's gradients against the unsharded port;
- DecoupledGCN at (4, 1, 1) with DropGraph on, and STGCN and DecoupledGCN at
  (2, 2, 1) with dropout (and DropGraph) on: one train step equal to the
  unsharded step from the same seed (the masks are drawn at the global
  batch's shape from the unsharded step's generator);
- the Transformer (d 32, 2 heads, FFN 64, 1 layer) at (1, 2, 2) with padded
  frames (row 1's padding starts on the first sp rank and fills the next),
  the mean pool: eval logits, one AdamW step and the eval step, in
  float64; the max and concat pools' f32 eval logits at (2, 2, 1).

A second spawn isolates DropGraph's normalisation: each of 4 ranks applies
the DropGraph functions to its rows of one batch under one seed map drawn
for the whole batch; the rows put together are JAX's functions' output on
the whole batch under that map (``ia`` and the mask's scale are global).

``check_split``'s rules for the new splits are held without processes
(``tests/test_torch_port_parallel.py``).
Bars: logits 2e-4 / 1e-4, gradients 5e-5, running statistics 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sl_hwgat_tpu.models import build_model as jax_build_model
from sl_hwgat_tpu.models import decoupled_gcn as jax_dgcn
from sl_hwgat_tpu.train import torch_import
from sl_hwgat_tpu.train.loop import make_steps as jax_make_steps
from sl_hwgat_tpu.train.state import make_optimizer as jax_make_optimizer

from sl_hwgat_tpu_torch.constants import DATASET_PARAMS
from sl_hwgat_tpu_torch.models import build_model
from sl_hwgat_tpu_torch.parallel.dryrun import run_jobs, spawn
from sl_hwgat_tpu_torch.train.loop import make_steps
from sl_hwgat_tpu_torch.train.state import make_optimizer
from sl_hwgat_tpu_torch.weights import params_from_jax, state_dict_from_jax

SYNTH = DATASET_PARAMS["SYNTH"]
DS64 = {"num_class": 16, "src_len": 64}
TRANSFORMER_CONFIG = dict(d_model=32, nhead=2, dim_feedforward=64, num_encoder_layers=1,
                          dropout=0.0)
# dropout off (STGCN's head dropout, DecoupledGCN's DropGraph) for the JAX parity
DETERMINISTIC = {"STGCN": dict(dropout_ratio=0.0), "DecoupledGCN": dict(keep_prob=1.0)}
# dropout on: STGCN's 0.05 after the pool, DecoupledGCN's DropGraph and 0.1 after the pool
DROPOUT = {"STGCN": {}, "DecoupledGCN": dict(dropout_ratio=0.1)}
IMPORTERS = {"STGCN": torch_import.stgcn_from_torch,
             "DecoupledGCN": torch_import.decoupled_gcn_from_torch,
             "Transformer": torch_import.transformer_from_torch}
GCNS = ("STGCN", "DecoupledGCN")
TOL = dict(atol=2e-4, rtol=1e-4)
STATS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_ATOL = 5e-5
LR = 5e-4
DROP_SEED = 3


def _batch(frames, classes, seed, pad_frames=False):
    r = np.random.default_rng(seed)
    x = r.normal(size=(8, frames, 29, 2)).astype(np.float32)
    if pad_frames:
        x[1, 12:] = -1.0  # the Transformer's key padding, across the sp split at 16
        x[5, 20:] = -1.0
    y = r.integers(0, classes, size=8).astype(np.int32)
    valid = np.ones(8, np.float32)
    valid[-1] = 0.0
    return x, y, valid


def _tensors(batch, dtype=torch.float32):
    return (torch.from_numpy(batch[0]).to(dtype), torch.from_numpy(batch[1]).long(),
            torch.from_numpy(batch[2]))


def _port_state(name, ds, **overrides):
    model = build_model(name, ds, 2, device="cpu", **overrides)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _jax_reference(name, ds, sd, batch, overrides):
    """JAX's f32 eval logits and one f64 AdamW step from the port's weights."""
    jm = jax_build_model(name, ds, 2, **overrides)
    variables = IMPORTERS[name]({k: v.numpy() for k, v in sd.items()})
    logits = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(
        variables, jnp.asarray(batch[0])))
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), variables)
        jopt = jax_make_optimizer("adamw", LR)
        gcn = name in GCNS
        jstep, _ = jax_make_steps(jm, jopt, donate=False, mutable_stats=gcn,
                                  **(dict(rng_streams=("dropout", "dropgraph")) if gcn else {}))
        v64, _, loss, correct, seen = jstep(v64, jopt.init(v64["params"]),
                                            batch[0].astype(np.float64), batch[1], batch[2],
                                            jax.random.PRNGKey(0), 0, 0)
        v64 = jax.tree.map(np.asarray, v64)
    after = (state_dict_from_jax(v64) if gcn
             else params_from_jax(v64["params"]))
    return {"logits": logits, "loss": float(loss), "correct": float(correct),
            "seen": float(seen), "params": after}


def _save(work, name, sd, batch):
    torch.save(sd, work / f"{name}.state.pt")
    torch.save(_tensors(batch), work / f"{name}.batch.pt")


def _job(work, name, model, ds, mesh, steps, overrides, state, **kw):
    return dict(model=model, dataset=ds, overrides=overrides,
                state=str(work / f"{state}.state.pt"), batch=str(work / f"{state}.batch.pt"),
                mesh=mesh, device="cpu", steps=steps, out=str(work / f"{name}.out.pt"), **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every sharded job in one 4-rank spawn, and the JAX references."""
    work = tmp_path_factory.mktemp("baselines_parallel")
    batches = {"gcn": _batch(32, 16, 0), "gcn64": _batch(64, 16, 1),
               "transformer": _batch(32, 16, 2, pad_frames=True)}
    sds, jax_outs = {}, {}
    for name in GCNS:
        sds[name] = _port_state(name, SYNTH)
        _save(work, name, sds[name], batches["gcn"])
        jax_outs[name] = _jax_reference(name, SYNTH, sds[name], batches["gcn"],
                                        DETERMINISTIC[name])
    sds["STGCN64"] = _port_state("STGCN", DS64)
    _save(work, "STGCN64", sds["STGCN64"], batches["gcn64"])
    for pool in ("mean", "max", "concat"):
        key = f"Transformer-{pool}"
        sds[key] = _port_state("Transformer", SYNTH, **TRANSFORMER_CONFIG, pool=pool)
        _save(work, key, sds[key], batches["transformer"])
        cfg = dict(TRANSFORMER_CONFIG, pool=pool)
        if pool == "mean":
            jax_outs[key] = _jax_reference("Transformer", SYNTH, sds[key],
                                           batches["transformer"], cfg)
        else:
            jm = jax_build_model("Transformer", SYNTH, 2, **cfg)
            variables = IMPORTERS["Transformer"]({k: v.numpy() for k, v in sds[key].items()})
            jax_outs[key] = {"logits": np.asarray(jax.jit(
                lambda v, xx: jm.apply(v, xx, train=False))(
                    variables, jnp.asarray(batches["transformer"][0])))}

    full = ["logits", "train", "params", "eval"]
    f64 = dict(dtype="float64")
    jobs = {}
    for name in GCNS:
        jobs[f"{name}221"] = _job(work, f"{name}221", name, SYNTH, (2, 2, 1), full,
                                  DETERMINISTIC[name], name, **f64)
        jobs[f"{name}221-dropout"] = _job(work, f"{name}221-dropout", name, SYNTH, (2, 2, 1),
                                          ["train"], DROPOUT[name], name, seed=DROP_SEED, **f64)
    jobs["STGCN141"] = _job(work, "STGCN141", "STGCN", DS64, (1, 4, 1), ["logits", "train"],
                            DETERMINISTIC["STGCN"], "STGCN64", **f64)
    jobs["DecoupledGCN411-dropgraph"] = _job(work, "DecoupledGCN411-dropgraph", "DecoupledGCN",
                                             SYNTH, (4, 1, 1), ["train"], {}, "DecoupledGCN",
                                             seed=DROP_SEED, **f64)
    jobs["Transformer122"] = _job(work, "Transformer122", "Transformer", SYNTH, (1, 2, 2),
                                  full, TRANSFORMER_CONFIG, "Transformer-mean", **f64)
    for pool in ("max", "concat"):
        jobs[f"Transformer221-{pool}"] = _job(
            work, f"Transformer221-{pool}", "Transformer", SYNTH, (2, 2, 1), ["logits"],
            dict(TRANSFORMER_CONFIG, pool=pool), f"Transformer-{pool}")
    results = dict(zip(jobs, run_jobs(list(jobs.values()), 4)))
    return results, batches, sds, jax_outs


class Unsharded:
    """The port's unsharded steps on one model state and batch."""

    def __init__(self, name, ds, sd, batch, overrides, dtype=torch.float64, seed=0):
        model = build_model(name, ds, 2, device="cpu", **overrides)
        model.load_state_dict(sd)
        model.to(dtype)
        self.x, self.y, self.valid = _tensors(batch, dtype)
        model.eval()
        with torch.no_grad():
            self.logits = model(self.x)
        step, self.evaluate = make_steps(model, make_optimizer("adamw", LR, model.parameters()))
        self.train = [t.item() for t in step(self.x, self.y, self.valid, seed, 0, 0)]
        self.model = model

    def eval_step(self):
        out = self.evaluate(self.x, self.y, self.valid, 1)
        self.model.eval()
        with torch.no_grad():
            argmax = self.model(self.x).argmax(-1)
        return out[0].item(), argmax


def _check_grads(got, model, atol=GRAD_ATOL):
    for k, p in model.named_parameters():
        np.testing.assert_allclose(got["grads"][k].numpy(), p.grad.numpy(), atol=atol,
                                   err_msg=k)


def _check_state(got, model, jax_params):
    """The parameters (and running statistics) after the sharded step
    against the unsharded step's and JAX's. The Transformer's key bias (the
    middle third of ``in_proj_bias``) has no gradient in exact arithmetic:
    AdamW moves it on each side's float64 rounding noise (about 1e-17),
    which makes each entry's step anywhere in [-lr, lr]. Against the
    unsharded port it is held at the bar; against JAX, within lr of it."""
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(got["params"][k]) == int(v) == 1, k
            continue
        stats = k.endswith(("running_mean", "running_var"))
        tol = STATS_TOL if stats else TOL
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), **tol, err_msg=k)
        if k not in jax_params:
            continue
        mine, theirs = got["params"][k].numpy(), np.asarray(jax_params[k])
        if k.endswith("self_attn.in_proj_bias"):
            d = mine.shape[0] // 3
            np.testing.assert_allclose(mine[d:2 * d], theirs[d:2 * d], atol=LR, rtol=0,
                                       err_msg=k)
            mine, theirs = np.delete(mine, np.s_[d:2 * d]), np.delete(theirs, np.s_[d:2 * d])
        np.testing.assert_allclose(mine, theirs, **tol, err_msg=k)


@pytest.mark.parametrize("name", GCNS)
def test_gcn_at_dp2_sp2_matches_port_and_jax(runs, name):
    results, batches, sds, jax_outs = runs
    got, ranks = results[f"{name}221"]
    ref = Unsharded(name, SYNTH, sds[name], batches["gcn"], DETERMINISTIC[name])
    jout = jax_outs[name]
    np.testing.assert_allclose(got["logits"].numpy(), ref.logits.numpy(), **TOL)
    np.testing.assert_allclose(got["logits"].numpy(), jout["logits"], **TOL)
    loss, correct, seen = got["train"].tolist()
    np.testing.assert_allclose(loss, ref.train[0], atol=1e-10)
    np.testing.assert_allclose(loss, jout["loss"], **TOL)
    assert [correct, seen] == ref.train[1:] == [jout["correct"], 7.0]
    _check_grads(got, ref.model)
    _check_state(got, ref.model, jout["params"])
    eval_loss, argmax = ref.eval_step()
    np.testing.assert_allclose(got["eval"][0].item(), eval_loss, **TOL)
    assert torch.equal(got["eval_argmax"], argmax)
    assert got["eval"][2].item() == 7.0
    assert sorted(tuple(r["coords"].values()) for r in ranks) == [
        (d, s, 0) for d in range(2) for s in range(2)]


def test_stgcn_over_four_sp_ranks_matches_the_unsharded_port(runs):
    """64 frames at sp 4: 16, 8 and 4 frames a rank at the three temporal
    resolutions, the stride-2 blocks' windows crossing every split."""
    results, batches, sds, _ = runs
    got, _ = results["STGCN141"]
    ref = Unsharded("STGCN", DS64, sds["STGCN64"], batches["gcn64"], DETERMINISTIC["STGCN"])
    np.testing.assert_allclose(got["logits"].numpy(), ref.logits.numpy(), **TOL)
    np.testing.assert_allclose(got["train"][0].item(), ref.train[0], atol=1e-10)
    _check_grads(got, ref.model)


@pytest.mark.parametrize("job, name, overrides", [
    ("DecoupledGCN411-dropgraph", "DecoupledGCN", {}),
    ("STGCN221-dropout", "STGCN", DROPOUT["STGCN"]),
    ("DecoupledGCN221-dropout", "DecoupledGCN", DROPOUT["DecoupledGCN"]),
])
def test_dropout_and_dropgraph_steps_are_the_unsharded_step(runs, job, name, overrides):
    """With DropGraph (blocks l7-l10, keep_prob 0.9) and dropout on, the
    sharded step is the unsharded step from the same seed: the seed maps
    and masks are the global batch's, ``ia`` and the scales are normalised
    over every row and frame."""
    results, batches, sds, _ = runs
    got, _ = results[job]
    ref = Unsharded(name, SYNTH, sds[name], batches["gcn"], overrides, seed=DROP_SEED)
    # the draws change the step: not the same weights' step with them off
    assert ref.train[0] != results[f"{name}221"][0]["train"][0].item()
    np.testing.assert_allclose(got["train"][0].item(), ref.train[0], atol=1e-10)
    assert got["train"][1:].tolist() == ref.train[1:]
    _check_grads(got, ref.model)


def dropgraph_worker(rank, world, job):
    """Each rank's DropGraph outputs on its rows of ``job["x"]`` at mesh
    (world, 1, 1), with ``torch.bernoulli`` giving the seed maps
    ``job["seeds"]`` of the whole batch (or their rows of this rank, to a
    call at the rank's shape)."""
    from sl_hwgat_tpu_torch.models import decoupled_gcn as dgcn
    from sl_hwgat_tpu_torch.parallel import mesh as mesh_lib

    layout = mesh_lib.Layout(mesh_lib.make_mesh((world, 1, 1), "cpu"))
    x = torch.load(job["x"])
    seeds = torch.load(job["seeds"])
    lo, hi = layout.rows(x.shape[0])
    current = {}

    def seed_map(p, generator=None):
        full = current["map"]
        return full if p.shape == full.shape else full[lo:hi]

    real = torch.bernoulli
    torch.bernoulli = seed_map
    try:
        with mesh_lib.activate(layout):
            current["map"] = seeds["spatial"]
            spatial = dgcn.drop_graph_spatial(x[lo:hi], 0.9, torch.from_numpy(job["adj_sum"]),
                                              job["drop_size"])
            current["map"] = seeds["temporal"]
            temporal = dgcn.drop_graph_temporal(x[lo:hi], 0.9, 41)
    finally:
        torch.bernoulli = real
    torch.save({"spatial": spatial, "temporal": temporal}, f"{job['out']}.{rank}")


def test_dropgraph_normalises_over_the_global_batch(tmp_path, monkeypatch):
    """``ia`` and the mask's scale of the DropGraph functions are sums over
    the whole batch, as the JAX functions' are under GSPMD: ranks that
    each hold 2 of 8 rows, under one seed map of the whole batch, put
    together the JAX functions' output on the whole batch."""
    from sl_hwgat_tpu_torch.graphs.partition import spatial_graph
    from sl_hwgat_tpu_torch.graphs.skeleton import BODY29_EDGES
    from sl_hwgat_tpu_torch.models.decoupled_gcn import find_drop_size

    r = np.random.default_rng(5)
    x = np.abs(r.normal(size=(8, 16, 12, 29))) * r.uniform(0.2, 3.0, size=(8, 1, 1, 1))
    seeds = {"spatial": (r.random((8, 29)) < 0.05).astype(np.float64),
             "temporal": (r.random((8, 12)) < 0.01).astype(np.float64)}
    seeds["temporal"][0, 3] = 1.0  # at least one temporal block dropped
    adj_sum = spatial_graph(29, [list(e) for e in BODY29_EDGES]).sum(0)
    drop_size = find_drop_size(29, len(BODY29_EDGES))
    torch.save(torch.from_numpy(x), tmp_path / "x.pt")
    torch.save({k: torch.from_numpy(v) for k, v in seeds.items()}, tmp_path / "seeds.pt")
    spawn(dropgraph_worker, 4, dict(x=str(tmp_path / "x.pt"), seeds=str(tmp_path / "seeds.pt"),
                                    adj_sum=adj_sum, drop_size=drop_size,
                                    out=str(tmp_path / "out")))
    parts = [torch.load(tmp_path / f"out.{r}") for r in range(4)]
    with jax.enable_x64(True):
        jx = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))  # the JAX functions' (N, T, V, C)
        for kind, want_of in (
                ("spatial", lambda: jax_dgcn.drop_graph_spatial(jx, 0.9, jnp.asarray(adj_sum),
                                                                drop_size, None)),
                ("temporal", lambda: jax_dgcn.drop_graph_temporal(jx, 0.9, 41, None))):
            monkeypatch.setattr(jax_dgcn.jax.random, "bernoulli",
                                lambda rng, p, s=seeds[kind]: jnp.asarray(s))
            want = np.transpose(np.asarray(want_of()), (0, 3, 1, 2))
            got = torch.cat([p[kind] for p in parts]).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12, err_msg=kind)


def test_sharded_transformer_with_sp_and_tp_matches_port_and_jax(runs):
    results, batches, sds, jax_outs = runs
    key = "Transformer-mean"
    got, ranks = results["Transformer122"]
    ref = Unsharded("Transformer", SYNTH, sds[key], batches["transformer"], TRANSFORMER_CONFIG)
    jout = jax_outs[key]
    np.testing.assert_allclose(got["logits"].numpy(), ref.logits.numpy(), **TOL)
    np.testing.assert_allclose(got["logits"].numpy(), jout["logits"], **TOL)
    np.testing.assert_allclose(got["train"][0].item(), ref.train[0], **TOL)
    np.testing.assert_allclose(got["train"][0].item(), jout["loss"], **TOL)
    assert got["train"][1:].tolist() == ref.train[1:] == [jout["correct"], 7.0]
    _check_grads(got, ref.model)
    _check_state(got, ref.model, jout["params"])
    eval_loss, argmax = ref.eval_step()
    np.testing.assert_allclose(got["eval"][0].item(), eval_loss, **TOL)
    assert torch.equal(got["eval_argmax"], argmax)
    assert sorted(tuple(r["coords"].values()) for r in ranks) == [
        (0, s, t) for s in range(2) for t in range(2)]


@pytest.mark.parametrize("pool", ["max", "concat"])
def test_sharded_transformer_pools_gather_the_clip(runs, pool):
    results, batches, sds, jax_outs = runs
    key = f"Transformer-{pool}"
    got, _ = results[f"Transformer221-{pool}"]
    ref = Unsharded("Transformer", SYNTH, sds[key], batches["transformer"],
                    dict(TRANSFORMER_CONFIG, pool=pool), dtype=torch.float32)
    np.testing.assert_allclose(got["logits"].numpy(), ref.logits.numpy(), **TOL)
    np.testing.assert_allclose(got["logits"].numpy(), jax_outs[key]["logits"], **TOL)
