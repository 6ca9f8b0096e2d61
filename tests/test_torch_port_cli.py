"""The port's training CLI against the JAX package's, on the CPU.

HWGATE at embed 32, depths (1, 1), heads (2, 2), SYNTH, batch 4, 2 workers
(the JAX package's ``tests/test_e2e_train.py`` sizes). The weights come from
one JAX ``.ckpt`` written by the JAX ``init_state`` + ``save_checkpoint``.

- ``cli.run`` in test mode on that file (``-mw``) against the JAX
  ``cli.run``: per split loss at atol 2e-4 / rtol 1e-4 and accuracy exactly,
  the confusion CSV byte for byte and the final table's text equal.
- One epoch of ``run_epochs`` from those weights (dropout and pruning off,
  the train transforms seeded alike): the four history values at
  2e-4 / 1e-4. run_epochs' lr per epoch, save triggers and early stopping
  against the JAX package's, on stub steps.
- Resume: one epoch, ``save_checkpoint``, ``resume_from`` and one more give
  the parameters, AdamW moments and history of two straight epochs bit for
  bit (dropout and pruning on).
- ``get_loaders`` (val/test replayed, train warmed) gives the JAX loaders'
  batches; the reporting functions write the JAX package's CSV; the
  composite-target inference gives the JAX package's cases.
"""

import csv
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sl_hwgat_tpu import cli as jax_cli
from sl_hwgat_tpu.configs import RunConfig as JaxRunConfig
from sl_hwgat_tpu.data import dataset as jax_dataset
from sl_hwgat_tpu.models import build_model as jax_build_model
from sl_hwgat_tpu.train import checkpoint as jax_ckpt
from sl_hwgat_tpu.train import loop as jax_loop
from sl_hwgat_tpu.train import reporting as jax_reporting
from sl_hwgat_tpu.train.state import cosine_annealing_lr as jax_cosine

from sl_hwgat_tpu_torch import cli
from sl_hwgat_tpu_torch.configs import RunConfig
from sl_hwgat_tpu_torch.data import dataset
from sl_hwgat_tpu_torch.data.synthetic import write_synthetic_dataset
from sl_hwgat_tpu_torch.train import checkpoint as ckpt_lib
from sl_hwgat_tpu_torch.train import inference, loop, reporting
from sl_hwgat_tpu_torch.train.loop import (
    EarlyStopper,
    init_state,
    make_steps,
    run_epochs,
)
from sl_hwgat_tpu_torch.train.state import TrainState, make_optimizer

SMALL = dict(embed_dim=32, depths=(1, 1), num_heads=(2, 2))
DETERMINISTIC = dict(drop_rate=0.0, prune_attn=False)
LOSS_TOL = dict(atol=2e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """SYNTH under ``input/`` and a JAX HWGATE checkpoint."""
    root = tmp_path_factory.mktemp("cli")
    write_synthetic_dataset(str(root / "input"))
    cfg = jax_cfg(root, "ckpt")
    model = jax_build_model("HWGATE", cfg.dataset_params, 2, **cfg.overrides)
    state, _ = jax_loop.init_state(model, cfg, (32, 64, 2), ("dropout", "prune"))
    jax_ckpt.save_checkpoint(str(root / "jax_init.ckpt"), state, cfg.lr)
    return root


def jax_cfg(root, time, mode="train", weights="none", **overrides):
    cfg = JaxRunConfig(dataset="SYNTH", model_type="HWGATE", mode=mode, time=time,
                       model_weights=weights, input_root=str(root / "input"),
                       output_root=str(root / "jax_out"))
    cfg.batch_size, cfg.n_workers = 4, 2
    cfg.overrides = dict(SMALL, stream_layout="token", **overrides)
    return cfg


def port_cfg(root, time, mode="train", weights="none", **overrides):
    cfg = RunConfig(dataset="SYNTH", model_type="HWGATE", mode=mode, time=time,
                    model_weights=weights, input_root=str(root / "input"),
                    output_root=str(root / "port_out"), device="cpu")
    cfg.batch_size, cfg.n_workers = 4, 2
    cfg.overrides = dict(SMALL, **overrides)
    return cfg


def final_table(text: str) -> list[str]:
    lines = text.splitlines()
    start = lines.index("=" * 89)
    return lines[start:start + 4]


def test_test_mode_on_a_jax_checkpoint_matches_jax(workdir, monkeypatch, capsys):
    monkeypatch.setenv("SL_HWGAT_NO_COMPILE_CACHE", "1")
    weights = str(workdir / "jax_init.ckpt")
    jcfg = jax_cfg(workdir, "test_mode", mode="test", weights=weights)
    want, _ = jax_cli.run(jcfg, progress=False)
    want_text = capsys.readouterr().out
    tcfg = port_cfg(workdir, "test_mode", mode="test", weights=weights)
    got, state = cli.run(tcfg, progress=False)
    got_text = capsys.readouterr().out

    assert set(got) == set(want) == {"train", "val", "test"}
    for split in want:
        np.testing.assert_allclose(got[split][0], want[split][0], **LOSS_TOL, err_msg=split)
        assert got[split][1] == want[split][1], split
    with open(jcfg.save_cm_path, "rb") as f:
        want_csv = f.read()
    with open(tcfg.save_cm_path, "rb") as f:
        assert f.read() == want_csv
    assert final_table(got_text) == final_table(want_text)
    assert next(state.model.parameters()).device.type == "cpu"


def test_one_epoch_history_matches_jax(workdir, monkeypatch):
    monkeypatch.setenv("SL_HWGAT_NO_COMPILE_CACHE", "1")
    weights = str(workdir / "jax_init.ckpt")

    jcfg = jax_cfg(workdir, "epoch", **DETERMINISTIC)
    jcfg.epochs = 0
    jmodel = jax_build_model("HWGATE", jcfg.dataset_params, 2, **jcfg.overrides)
    jstate, jopt = jax_loop.init_state(jmodel, jcfg, (32, 64, 2), ("dropout", "prune"))
    jstate = jax_ckpt.load_pretrained_into(jstate, weights, "HWGATE", verbose=False)
    jtrain, jeval = jax_loop.make_steps(jmodel, jopt, rng_streams=("dropout", "prune"),
                                        donate=False)
    jl = jax_dataset.get_loaders(jcfg, jcfg.train_transform(), jcfg.eval_transform())
    jstate = jax_loop.run_epochs(jmodel, jcfg, jstate, jtrain, jeval, jl[0], jl[1], plot=False)

    tcfg = port_cfg(workdir, "epoch", **DETERMINISTIC)
    tcfg.epochs = 0
    state = ckpt_lib.load_pretrained_into(init_state(tcfg), weights, verbose=False)
    ttrain, teval = make_steps(state.model, state.optimizer)
    tl = dataset.get_loaders(tcfg, tcfg.train_transform(), tcfg.eval_transform())
    try:
        state = run_epochs(tcfg, state, ttrain, teval, tl[0], tl[1], plot=False)
    finally:
        for loader in tl:
            loader.close()

    for name in ("train_loss", "train_acc", "val_loss", "val_acc"):
        assert len(state.history[name]) == len(jstate.history[name]) == 1, name
        np.testing.assert_allclose(state.history[name], jstate.history[name], **LOSS_TOL,
                                   err_msg=name)
    assert os.path.exists(f"{tcfg.save_model_path}_best_loss.ckpt")


class _StubLoader:
    def __init__(self, n):
        self.n = n

    def epoch(self, epoch=0):
        for _ in range(self.n):
            yield (np.zeros((2, 1), np.float32), np.zeros(2, np.int32),
                   np.ones(2, np.float32))


def _stub_run(tmp_path, val, t_max=3, epochs=5, save_interval=2, early=None, start=0):
    """run_epochs on a Linear model with steps that return ``val[epoch]`` as
    (val_loss, val_acc); records the lr set at each epoch."""
    cfg = RunConfig(dataset="SYNTH", time="stub", output_root=str(tmp_path), device="cpu")
    cfg.epochs, cfg.scheduler_t_max, cfg.save_interval = epochs, t_max, save_interval
    if early is not None:
        cfg.early_stopping, cfg.early_stopping_step = True, early
    model = torch.nn.Linear(1, 1)
    state = TrainState(model, make_optimizer("adamw", cfg.lr, model.parameters()), epoch=start)
    lrs = []

    def train_step(x, y, valid, seed, epoch, step):
        lrs.append(state.optimizer.param_groups[0]["lr"])
        return torch.tensor(1.0), torch.tensor(1.0), valid.sum()

    def eval_step(x, y, valid, k=1):
        loss, acc = val[len(state.history["val_loss"])]
        return torch.tensor(loss), torch.tensor(acc * 2.0), valid.sum(), None

    stopper = EarlyStopper(early, 0) if early is not None else None
    state = run_epochs(cfg, state, train_step, eval_step, _StubLoader(1), _StubLoader(1),
                       early_stopper=stopper, plot=False)
    return cfg, state, lrs


def test_run_epochs_lr_and_save_triggers(tmp_path):
    # values exact in float32, as the steps' tensors hold them
    val = [(2.0, 0.125), (1.5, 0.125), (1.75, 0.375), (1.25, 0.25), (1.375, 0.25), (1.125, 0.5)]
    cfg, state, lrs = _stub_run(tmp_path, val)
    # epochs 0 … cfg.epochs inclusive, each at the JAX package's cosine lr
    assert state.epoch == 5 and len(state.history["val_loss"]) == 6
    # (the JAX package computes it in float32)
    np.testing.assert_allclose(lrs, [float(jax_cosine(e, cfg.lr, 3)) for e in range(6)],
                               rtol=1e-6, atol=0)
    best_loss = ckpt_lib.read_checkpoint(f"{cfg.save_model_path}_best_loss.ckpt")
    best_acc = ckpt_lib.read_checkpoint(f"{cfg.save_model_path}_best_acc.ckpt")
    assert best_loss["epoch"] == 5 and best_acc["epoch"] == 5
    assert best_loss["val_loss_list"] == [v[0] for v in val]
    names = sorted(os.listdir(cfg.out_folder))
    assert names == ["model_2.ckpt", "model_4.ckpt", "model_best_acc.ckpt",
                     "model_best_loss.ckpt"]
    every = ckpt_lib.read_checkpoint(f"{cfg.save_model_path}_4.ckpt")
    assert every["epoch"] == 4 and every["val_acc_list"] == [v[1] for v in val[:5]]


def test_run_epochs_early_stopping_on_val_acc(tmp_path):
    val = [(2.0, 0.375), (1.5, 0.25), (1.375, 0.25), (1.25, 0.5), (1.125, 0.125), (1.0, 0.125)]
    _, state, _ = _stub_run(tmp_path, val, early=2)
    assert state.epoch == 2 and len(state.history["val_acc"]) == 3


def test_early_stopper_decisions_equal_jax():
    r = np.random.default_rng(0)
    seq = np.round(r.uniform(0, 1, size=200), 1).tolist()
    for patience, delta in ((1, 0), (3, 0), (5, 0.05)):
        a, b = EarlyStopper(patience, delta), jax_loop.EarlyStopper(patience, delta)
        assert [a.early_stop(v) for v in seq] == [b.early_stop(v) for v in seq]


def _epochs(cfg, state):
    train_step, eval_step = make_steps(state.model, state.optimizer)
    loaders = dataset.get_loaders(cfg, cfg.train_transform(), cfg.eval_transform())
    try:
        return run_epochs(cfg, state, train_step, eval_step, loaders[0], loaders[1], plot=False)
    finally:
        for loader in loaders:
            loader.close()


def test_resume_is_bit_for_bit(workdir):
    straight = port_cfg(workdir, "straight")
    straight.epochs = 1
    want = _epochs(straight, init_state(straight))

    first = port_cfg(workdir, "first")
    first.epochs = 0
    state = _epochs(first, init_state(first))
    path = str(workdir / "port_out" / "interrupted.ckpt")
    ckpt_lib.save_checkpoint(path, state, first.lr)
    second = port_cfg(workdir, "second")
    second.epochs = 1
    resumed = ckpt_lib.resume_from(init_state(second), path)
    assert resumed.epoch == 1
    got = _epochs(second, resumed)

    assert got.history == want.history and len(got.history["train_loss"]) == 2
    for (name, p), (_, q) in zip(got.model.named_parameters(), want.model.named_parameters()):
        assert torch.equal(p, q), name
    got_opt, want_opt = got.optimizer.state_dict(), want.optimizer.state_dict()
    assert got_opt["state"].keys() == want_opt["state"].keys()
    for i, s in want_opt["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(got_opt["state"][i][key], s[key]), (i, key)


def test_resume_refuses_a_jax_checkpoint(workdir):
    cfg = port_cfg(workdir, "refuse")
    with pytest.raises(ValueError, match="no optimizer state"):
        ckpt_lib.resume_from(init_state(cfg), str(workdir / "jax_init.ckpt"))


def test_jax_checkpoint_reads_as_its_state_dict(workdir):
    from sl_hwgat_tpu_torch.weights import state_dict_from_jax

    with open(workdir / "jax_init.ckpt", "rb") as f:
        payload = pickle.load(f)
    got = ckpt_lib.read_checkpoint(str(workdir / "jax_init.ckpt"))
    want = state_dict_from_jax(jax.tree.map(np.asarray, payload["variables"]))
    assert got.keys() >= {"model_state_dict", "epoch", "learning_rate", "train_loss_list"}
    assert "optimizer_state_dict" not in got
    assert got["model_state_dict"].keys() == want.keys()
    for k in want:
        assert torch.equal(got["model_state_dict"][k], want[k]), k


def test_get_loaders_batches_equal_jax(workdir):
    for mode in ("train", "test"):
        jcfg, tcfg = jax_cfg(workdir, "loaders", mode=mode), port_cfg(workdir, "loaders", mode=mode)
        jl = jax_dataset.get_loaders(jcfg, jcfg.train_transform(), jcfg.eval_transform())
        tl = dataset.get_loaders(tcfg, tcfg.train_transform(), tcfg.eval_transform())
        try:
            assert [(l.shuffle, l.auto_warm_next, l.cache_transforms) for l in tl] == [
                (l.shuffle, l.auto_warm_next, l.cache_transforms) for l in jl]
            for epoch in (0, 1):
                for j, t in zip(jl, tl):
                    jb, tb = list(j.epoch(epoch)), list(t.epoch(epoch))
                    assert len(tb) == len(jb) == len(t)
                    for a, b in zip(jb, tb):
                        for x, y in zip(a, b):
                            np.testing.assert_array_equal(y, x)
            # val/test replay their first pass; a shuffled train loader has its
            # next epoch warmed
            assert tl[1]._cache is not None and tl[2]._cache is not None
            assert (2 in tl[0]._warm) == (mode == "train")
        finally:
            for loader in tl:
                loader.close()


def test_cache_transforms_replays_and_warm_reads_the_same_batches(workdir):
    cfg = port_cfg(workdir, "warm")
    splits, classes, data_map = dataset.load_artifacts(cfg.input_root, "SYNTH")
    calls = []

    def transform(feat, rng):
        calls.append(1)
        return cfg.eval_transform()(feat, rng)

    ds = dataset.KeypointDataset(splits["val"], data_map, classes, transform, seed=cfg.seed)
    cached = dataset.Loader(ds, 5, num_workers=2, cache_transforms=True)
    warmed = dataset.Loader(ds, 5, shuffle=True, num_workers=2)
    plain = dataset.Loader(ds, 5, shuffle=True, num_workers=2)
    try:
        first = list(cached.epoch(0))
        n = len(calls)
        again = list(cached.epoch(3))
        assert len(calls) == n == 20 and all(a is b for a, b in zip(first, again))
        warmed.warm(4)
        for a, b in zip(warmed.epoch(4), plain.epoch(4)):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        assert warmed._warm == {}
    finally:
        for loader in (cached, warmed, plain):
            loader.close()


def test_reporting_equals_jax(tmp_path, capsys):
    r = np.random.default_rng(1)
    class_map = {i: f"sign{i}" for i in range(6)}
    y_true = r.integers(0, 6, size=40).tolist()
    y_pred = r.integers(0, 6, size=40).tolist()
    reporting.gen_cm_w(y_true, y_pred, class_map, str(tmp_path / "port.csv"))
    jax_reporting.gen_cm_w(y_true, y_pred, class_map, str(tmp_path / "jax.csv"))
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    with open(tmp_path / "map.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "name"])
        w.writerows(class_map.items())
    assert reporting.read_class_map(str(tmp_path / "map.csv")) == \
        jax_reporting.read_class_map(str(tmp_path / "map.csv")) == class_map
    results = {"train": (1.23456, 0.5), "val": (2.5, 0.25), "test": (3.0, 0.125)}
    reporting.show_final_result(results, 5)
    got = capsys.readouterr().out
    jax_reporting.show_final_result(results, 5)
    assert got == capsys.readouterr().out


def test_curves_are_written(tmp_path):
    reporting.plot_results([3.0, 2.0, 1.5], [3.1, 2.5, 2.4], "loss", "smooth_cross_entropy",
                           str(tmp_path / "loss.png"))
    reporting.plot_results([0.5], [0.25], "acc", "accuracy", str(tmp_path / "one.png"))
    from PIL import Image

    for name in ("loss.png", "one.png"):
        with Image.open(tmp_path / name) as img:
            assert img.format == "PNG" and img.size[0] >= 320
    with Image.open(tmp_path / "loss.png") as img:
        colours = {c for _, c in img.convert("RGB").getcolors(1 << 16)}
    assert (31, 119, 180) in colours and (255, 127, 14) in colours


class _RankModel(torch.nn.Module):
    """Logits that rank the classes from the clip's first value j: top-5 =
    j, j+1, …, j+4 (mod 10); the cases of tests/test_inference_composite.py."""

    def __init__(self, num_classes=10):
        super().__init__()
        self.num_classes = num_classes
        self.w = torch.nn.Parameter(torch.zeros(1))

    def forward(self, x):
        j = int(x.reshape(x.shape[0], -1)[0, 0])
        logits = torch.zeros(1, self.num_classes)
        for rank, c in enumerate([(j + d) % self.num_classes for d in range(self.num_classes)]):
            logits[0, c] = self.num_classes - rank
        return logits + 0 * self.w


class _Items:
    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def get(self, i):
        return self.items[i]


def _feat(j):
    return np.full((4, 2, 2), float(j), np.float32)


@pytest.mark.parametrize("target", [200120345, 10007, 3000102000030, 10, 1234567890])
def test_decode_classes_equals_jax(target):
    from sl_hwgat_tpu.train.inference import decode_classes

    assert inference.decode_classes(target) == decode_classes(target)


def test_composite_cases_of_the_jax_suite():
    assert inference.decode_classes(200120345) == (2, [12, 345])
    ds = _Items([(_feat(0), 10003), (_feat(0), 10007), (_feat(0), 200010004),
                 (_feat(0), 200010005)])
    assert inference.evaluate_composite(_RankModel(), ds, top=5) == 0.5
    assert inference.evaluate_composite(_RankModel(), _Items([(_feat(0), 0), (_feat(0), 10002)]),
                                        top=5) == 1.0


def test_show_final_result_composite(capsys):
    accs = inference.show_final_result_composite(_RankModel(), {"test": _Items([(_feat(0), 10002)])},
                                                 top=5)
    assert accs["test"] == 1.0 and "test acc 1.0000" in capsys.readouterr().out


def test_composite_on_a_real_model_equals_jax(workdir):
    """A HWGATE's composite accuracy equals the JAX model's on the same weights."""
    from sl_hwgat_tpu.train.inference import evaluate_composite as jax_composite

    weights = str(workdir / "jax_init.ckpt")
    cfg = port_cfg(workdir, "composite")
    state = ckpt_lib.load_pretrained_into(init_state(cfg), weights, verbose=False)
    jcfg = jax_cfg(workdir, "composite")
    jm = jax_build_model("HWGATE", jcfg.dataset_params, 2, **jcfg.overrides)
    with open(weights, "rb") as f:
        variables = pickle.load(f)["variables"]
    r = np.random.default_rng(2)
    feats = [r.random((32, 64, 2)).astype(np.float32) for _ in range(6)]
    with torch.no_grad():
        logits = [state.model.eval()(torch.from_numpy(f)[None])[0].numpy() for f in feats]
    order = [np.argsort(lg)[::-1] for lg in logits]
    targets = [int(f"1{o[0]:04d}") for o in order[:3]] + [int(f"2{o[1]:04d}{o[9]:04d}")
                                                          for o in order[3:5]] + [0]
    items = _Items(list(zip(feats, targets)))
    apply = jax.jit(lambda v, x: jm.apply(v, x, train=False))
    want = jax_composite(apply, variables, items, top=5)
    assert inference.evaluate_composite(state.model, items, top=5) == want == 3 / 5
