"""The port's training path against the JAX package's, on the CPU.

- losses and the cosine schedule;
- train steps: the JAX package's ``init_state`` makes the weights,
  ``weights.state_dict_from_jax`` carries them into the port, and both
  ``make_steps`` take 3 AdamW steps on the same batches (one padded row each):
  loss per step at 2e-4/1e-4 (f32) and 0.05 (bf16), step-1 gradients at
  5e-4 and the weights after 3 steps at 2e-4/1e-4 (f32), key by key through
  ``weights.params_from_jax``. Pruning and dropout are off there; with them
  on, the mean train-mode loss over 16 seeds agrees within 3 combined
  standard errors (the two frameworks draw different random numbers);
- gradient accumulation, and a step's reproducibility from its seed;
- the data path: train transforms, ``Loader`` batches and the synthetic
  dataset are exactly the JAX package's for the same seeds, and a SYNTH
  epoch trains through ``train_epoch``.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sl_hwgat_tpu import configs as jax_configs
from sl_hwgat_tpu.data import dataset as jax_dataset
from sl_hwgat_tpu.data import synthetic as jax_synthetic
from sl_hwgat_tpu.data import transforms as jax_T
from sl_hwgat_tpu.models.hwgate import hwgate_from_dataset as jax_hwgate
from sl_hwgat_tpu.train import losses as jax_losses
from sl_hwgat_tpu.train.loop import init_state as jax_init_state
from sl_hwgat_tpu.train.loop import make_steps as jax_make_steps
from sl_hwgat_tpu.train.state import cosine_annealing_lr as jax_cosine

from sl_hwgat_tpu_torch import configs
from sl_hwgat_tpu_torch.constants import DATASET_PARAMS
from sl_hwgat_tpu_torch.data import dataset, synthetic
from sl_hwgat_tpu_torch.data import transforms as T
from sl_hwgat_tpu_torch.models.hwgate import hwgate_from_dataset
from sl_hwgat_tpu_torch.train import losses
from sl_hwgat_tpu_torch.train.loop import evaluate, make_steps, step_seed, train_epoch
from sl_hwgat_tpu_torch.train.state import TrainState, cosine_annealing_lr, make_optimizer
from sl_hwgat_tpu_torch.weights import params_from_jax, state_dict_from_jax

SMALL = dict(embed_dim=32, depths=(2, 2, 2), num_heads=(1, 2, 4))
DS = {"num_class": 10, "src_len": 8}
LR = 5e-4
DETERMINISTIC = dict(drop_rate=0.0, prune_attn=False)


@pytest.mark.parametrize("name", ["smooth_cross_entropy", "cross_entropy", "mse"])
def test_losses_equal_jax(name):
    r = np.random.default_rng(0)
    logits = (3 * r.normal(size=(6, 11))).astype(np.float32)
    labels = r.integers(0, 11, size=6).astype(np.int32)
    lt, yt = torch.from_numpy(logits), torch.from_numpy(labels).long()
    if name != "mse":  # mse of (N, C) logits against (N,) labels takes one row at a time
        want = jax_losses.CRITERIA[name](jnp.asarray(logits), jnp.asarray(labels))
        got = losses.CRITERIA[name](lt, yt)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    per = losses.per_sample(losses.CRITERIA[name], lt, yt)
    want_per = jax.vmap(lambda lg, lb: jax_losses.CRITERIA[name](lg[None], lb[None]))(
        jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(per.numpy(), np.asarray(want_per), rtol=1e-6)


def test_cosine_annealing_lr_equals_jax_and_torch():
    m = torch.nn.Linear(2, 2)
    opt = torch.optim.AdamW(m.parameters(), lr=LR)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=20)
    for epoch in range(45):
        got = cosine_annealing_lr(epoch, LR, 20)
        np.testing.assert_allclose(got, float(jax_cosine(epoch, LR, 20)), atol=1e-9)
        np.testing.assert_allclose(got, opt.param_groups[0]["lr"], atol=1e-9)
        opt.step()
        sched.step()


def _batches(n_steps, batch, ds, seed):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        x = r.random((batch, ds["src_len"], 64, 2)).astype(np.float32)
        y = r.integers(0, ds["num_class"], size=batch).astype(np.int32)
        valid = np.ones(batch, np.float32)
        valid[-1] = 0.0  # one padded row
        out.append((x, y, valid))
    return out


class _Cfg:
    seed = 0
    optimizer_type = "adamw"
    lr = LR


def _jax_grads(model, variables, x, y, valid):
    aux = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(params):
        logits = model.apply({**aux, "params": params}, x, train=True)
        per = jax.vmap(lambda lg, lb: jax_losses.smoothed_cross_entropy(lg[None], lb[None]))(
            logits, y)
        return jnp.sum(per * valid) / jnp.maximum(jnp.sum(valid), 1.0)

    return jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(variables["params"]))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_train_steps_match_jax(compute_dtype):
    jm = jax_hwgate(DS, 2, stream_layout="token", compute_dtype=compute_dtype,
                    **DETERMINISTIC, **SMALL)
    state, jopt = jax_init_state(jm, _Cfg, (DS["src_len"], 64, 2))
    variables, opt_state = state.variables, state.opt_state
    jstep, _ = jax_make_steps(jm, jopt, donate=False)

    tm = hwgate_from_dataset(DS, 2, compute_dtype=compute_dtype, **DETERMINISTIC, **SMALL)
    tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, variables)))
    topt = make_optimizer("adamw", LR, tm.parameters())
    tstep, _ = make_steps(tm, topt)

    batches = _batches(3, 4, DS, seed=1)
    want_grads = _jax_grads(jm, variables, *(jnp.asarray(a) for a in batches[0]))
    key = jax.random.PRNGKey(0)
    loss_tol = dict(atol=2e-4, rtol=1e-4) if compute_dtype == "float32" else dict(atol=0.05)
    for step, (x, y, valid) in enumerate(batches):
        variables, opt_state, jloss, jc, jn = jstep(
            variables, opt_state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(valid), key, 0, step)
        tloss, tc, tn = tstep(torch.from_numpy(x), torch.from_numpy(y).long(),
                              torch.from_numpy(valid), 0, 0, step)
        np.testing.assert_allclose(tloss.item(), float(jloss), **loss_tol)
        assert tn.item() == float(jn) == 3.0
        if step == 0 and compute_dtype == "float32":
            got = {k: p.grad for k, p in tm.named_parameters()}
            want = params_from_jax(want_grads)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=5e-4,
                                           err_msg=k)
    if compute_dtype == "float32":
        want = params_from_jax(jax.tree.map(np.asarray, variables["params"]))
        got = dict(tm.named_parameters())
        for k in want:
            np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(), atol=2e-4,
                                       rtol=1e-4, err_msg=k)


def _small_model(seed=0, **kw):
    return hwgate_from_dataset(DS, 2, generator=torch.Generator().manual_seed(seed),
                               **{**SMALL, **kw})


def test_grad_accum_equals_full_batch_with_padding():
    r = np.random.default_rng(2)
    x = torch.from_numpy(r.random((8, DS["src_len"], 64, 2)).astype(np.float32))
    y = torch.from_numpy(r.integers(0, DS["num_class"], size=8)).long()
    valid = torch.tensor([1, 1, 1, 0, 0, 0, 0, 0], dtype=torch.float32)  # 2nd half all padding
    out = []
    for accum in (1, 2):
        model = _small_model(**DETERMINISTIC)
        # SGD is linear in the gradient, so the weights compare as tightly
        step, _ = make_steps(model, make_optimizer("sgd", 1e-2, model.parameters()),
                             grad_accum=accum)
        loss, correct, seen = step(x, y, valid, 0, 0, 0)
        out.append((loss.item(), correct.item(), seen.item(),
                    {k: (p.grad.clone(), p.detach().clone()) for k, p in model.named_parameters()}))
    (l1, c1, n1, p1), (l2, c2, n2, p2) = out
    np.testing.assert_allclose(l2, l1, rtol=1e-6)
    assert (c1, n1) == (c2, n2) and n1 == 3.0
    for k in p1:
        torch.testing.assert_close(p2[k][0], p1[k][0], atol=1e-7, rtol=1e-5)
        torch.testing.assert_close(p2[k][1], p1[k][1], atol=1e-7, rtol=1e-6)


def _jax_train_losses(variables, x, y, seeds):
    jm = jax_hwgate(DS, 2, stream_layout="token", **SMALL)
    apply = jax.jit(lambda v, xx, rngs: jm.apply(v, xx, train=True, rngs=rngs))
    out = []
    for s in seeds:
        key = jax.random.fold_in(jax.random.PRNGKey(123), s)
        kd, kp = jax.random.split(key)
        logits = apply(variables, jnp.asarray(x), {"dropout": kd, "prune": kp})
        out.append(float(jax_losses.smoothed_cross_entropy(logits, jnp.asarray(y))))
    return np.asarray(out)


def test_dropout_and_prune_mean_loss_matches_jax():
    jm = jax_hwgate(DS, 2, stream_layout="token", **SMALL)
    r = np.random.default_rng(3)
    x = r.random((4, DS["src_len"], 64, 2)).astype(np.float32)
    y = r.integers(0, DS["num_class"], size=4).astype(np.int32)
    variables = jax.tree.map(np.asarray, jax.jit(lambda k, xx: jm.init(k, xx, train=False))(
        jax.random.PRNGKey(0), x))
    seeds = range(16)
    want = _jax_train_losses(variables, x, y, seeds)

    tm = hwgate_from_dataset(DS, 2, **SMALL)
    tm.load_state_dict(state_dict_from_jax(variables))
    tm.train()
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    with torch.no_grad():
        got = np.asarray([losses.smoothed_cross_entropy(
            tm(xt, torch.Generator().manual_seed(step_seed(0, 0, s))), yt).item() for s in seeds])
        eval_loss = losses.smoothed_cross_entropy(tm.eval()(xt), yt).item()
    se = np.sqrt(want.var(ddof=1) / len(want) + got.var(ddof=1) / len(got))
    assert se > 0 and np.ptp(got) > 0 and not np.allclose(got, eval_loss)
    assert abs(got.mean() - want.mean()) <= 3 * se, (got.mean(), want.mean(), se)


def test_train_step_is_reproducible_from_its_seed():
    r = np.random.default_rng(4)
    x = torch.from_numpy(r.random((2, DS["src_len"], 64, 2)).astype(np.float32))
    y = torch.from_numpy(r.integers(0, DS["num_class"], size=2)).long()
    valid = torch.ones(2)
    losses_seen = []
    for step in (0, 0, 1):
        model = _small_model()
        train_step, _ = make_steps(model, make_optimizer("adamw", LR, model.parameters()))
        losses_seen.append(train_step(x, y, valid, 7, 2, step)[0].item())
    assert losses_seen[0] == losses_seen[1] != losses_seen[2]


def _clip(rng, frames=30):
    clip = rng.uniform(0.1, 0.9, size=(frames, 29, 2)).astype(np.float32)
    return clip


TRAIN_TRANSFORMS = {
    "KeypointMasking": lambda m: m.KeypointMasking(0.2, 9, 29),
    "ShearTransform": lambda m: m.ShearTransform(0.1),
    "RotationTransform": lambda m: m.RotationTransform(0.1),
    "TemporalAugmentation": lambda m: m.TemporalAugmentation((0.5, 1.5), uniform_sample=True,
                                                             random_sample=True),
    "TemporalSample": lambda m: m.TemporalSample(32, random_shift=True),
    "RandomFlip": lambda m: m.RandomFlip("keypoints"),
}


@pytest.mark.parametrize("name", list(TRAIN_TRANSFORMS))
def test_train_transform_equals_jax(name):
    for seed in range(6):
        clip = _clip(np.random.default_rng(100 + seed), frames=20 + 7 * seed)
        want = TRAIN_TRANSFORMS[name](jax_T)(clip.copy(), np.random.default_rng(seed))
        got = TRAIN_TRANSFORMS[name](T)(clip.copy(), np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)


def test_train_pipeline_equals_jax():
    want_t = jax_configs.build_train_transform(32)
    got_t = configs.build_train_transform(32)
    for seed in range(4):
        clip = _clip(np.random.default_rng(200 + seed), frames=25 + 10 * seed)
        want = want_t(clip.copy(), np.random.default_rng(seed))
        got = got_t(clip.copy(), np.random.default_rng(seed))
        assert got.shape == (32, 64, 2)
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def synth_roots(tmp_path_factory):
    """SYNTH written by the JAX package and by the port, from the same seed."""
    root = tmp_path_factory.mktemp("synth")
    jax_synthetic.write_synthetic_dataset(str(root / "jax"), seed=5)
    synthetic.write_synthetic_dataset(str(root / "port"), seed=5)
    return str(root / "jax"), str(root / "port")


def test_synthetic_dataset_equals_jax(synth_roots):
    jroot, proot = synth_roots
    names = sorted(os.listdir(os.path.join(jroot, "SYNTH")))
    assert names == sorted(os.listdir(os.path.join(proot, "SYNTH"))) and len(names) == 4
    for name in names:
        with open(os.path.join(jroot, "SYNTH", name), "rb") as f:
            want = f.read()
        with open(os.path.join(proot, "SYNTH", name), "rb") as f:
            got = f.read()
        if name.endswith(".pkl"):
            want, got = pickle.loads(want), pickle.loads(got)
            assert list(got) == list(want)
            for k in want:
                if isinstance(want[k], np.ndarray):
                    np.testing.assert_array_equal(got[k], want[k])
                else:
                    assert got[k] == want[k]
        else:
            assert got == want


def test_loader_batches_equal_jax(synth_roots):
    _, proot = synth_roots
    splits, classes, data_map = dataset.load_artifacts(proot, "SYNTH")
    ids = splits["train"]  # 32 clips: batches of 6 leave a padded tail
    jl = jax_dataset.Loader(jax_dataset.KeypointDataset(
        ids, data_map, classes, jax_configs.build_train_transform(32), seed=9),
        6, shuffle=True, num_workers=2, seed=9)
    tl = dataset.Loader(dataset.KeypointDataset(
        ids, data_map, classes, configs.build_train_transform(32), seed=9),
        6, shuffle=True, num_workers=2, seed=9)
    try:
        for epoch in (0, 1):
            jb, tb = list(jl.epoch(epoch)), list(tl.epoch(epoch))
            assert len(tb) == len(jb) == len(tl) == 6
            for (jx, jy, jv), (tx, ty, tv) in zip(jb, tb):
                assert tx.shape == (6, 32, 64, 2) and tx.dtype == np.float32
                np.testing.assert_array_equal(tx, jx)
                np.testing.assert_array_equal(ty, jy)
                np.testing.assert_array_equal(tv, jv)
            assert tb[-1][2].tolist() == [1, 1, 0, 0, 0, 0]
    finally:
        tl.close()


def test_synth_epochs_train_on_cpu(synth_roots):
    _, proot = synth_roots
    ds = DATASET_PARAMS["SYNTH"]
    splits, classes, data_map = dataset.load_artifacts(proot, "SYNTH")
    train = dataset.Loader(dataset.KeypointDataset(
        splits["train"], data_map, classes, configs.build_train_transform(ds["src_len"])),
        8, shuffle=True, num_workers=2)
    val = dataset.Loader(dataset.KeypointDataset(
        splits["val"], data_map, classes, configs.build_eval_transform(ds["src_len"])),
        8, num_workers=2)
    model = hwgate_from_dataset(ds, 2, generator=torch.Generator().manual_seed(0), **SMALL)
    opt = make_optimizer("adamw", LR, model.parameters())
    state = TrainState(model, opt)
    train_step, eval_step = make_steps(model, opt)
    try:
        results = [train_epoch(train_step, state, train, 0, e) for e in (0, 1)]
        val_loss, val_acc = evaluate(eval_step, state, val, k=5)
    finally:
        train.close()
        val.close()
    for loss, acc in results:
        assert np.isfinite(loss) and 0.0 <= acc <= 1.0
    assert np.isfinite(val_loss) and 0.0 <= val_acc <= 1.0


@pytest.mark.slow
def test_full_geometry_train_step_matches_jax():
    """FDMSE-ISL (192 frames, 2002 classes, the flagship widths), batch 2:
    one f32 step's loss and gradients against the JAX package's."""
    ds = DATASET_PARAMS["FDMSE-ISL"]
    jm = jax_hwgate(ds, 2, stream_layout="token", **DETERMINISTIC)
    state, jopt = jax_init_state(jm, _Cfg, (ds["src_len"], 64, 2))
    tm = hwgate_from_dataset(ds, 2, **DETERMINISTIC)
    tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, state.variables)))
    tstep, _ = make_steps(tm, make_optimizer("adamw", LR, tm.parameters()))
    x, y, valid = _batches(1, 2, ds, seed=6)[0]
    want = params_from_jax(_jax_grads(jm, state.variables, jnp.asarray(x), jnp.asarray(y),
                                      jnp.asarray(valid)))
    jstep, _ = jax_make_steps(jm, jopt, donate=False)
    jloss = jstep(state.variables, state.opt_state, jnp.asarray(x), jnp.asarray(y),
                  jnp.asarray(valid), jax.random.PRNGKey(0), 0, 0)[2]
    tloss = tstep(torch.from_numpy(x), torch.from_numpy(y).long(), torch.from_numpy(valid),
                  0, 0, 0)[0]
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=2e-4, rtol=1e-4)
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), atol=5e-4, err_msg=k)
