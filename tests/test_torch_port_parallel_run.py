"""``train.dist.run_distributed`` on 2 gloo CPU ranks, the sharded
checkpoint through the CLI, and ``dryrun_multichip``.

- ``run_distributed`` at mesh (2, 1, 1) on SYNTH (HWGATE at embed 32,
  dropout off), with both checkpoint backends: each rank's loaders read only
  its rows of every batch (``Loader.row_slice``), both ranks hold the same
  metrics, history and weights, the history is the single-process
  ``run_epochs``' (2e-4 / 1e-4), and rank 0's checkpoint (gathered into the
  unsharded layout, or the sharded directory) serves through
  ``Predictor.from_checkpoint`` the logits of the trained weights, and
  resumes;
- ``--ckpt-backend orbax`` through ``cli.main`` (what ``main_torch.py``
  runs): train, resume (``-m load``) and test on the checkpoint directory;
- HGATE and the Transformer, which train under dp only: a dp = 2 step
  against the port's unsharded step (loss, gradients and parameters at
  2e-4 / 1e-4);
- ``dryrun_multichip(4)`` at the flagship geometry (slow).
"""

import os

import numpy as np
import pytest
import torch

from sl_hwgat_tpu_torch import cli, models
from sl_hwgat_tpu_torch.configs import RunConfig
from sl_hwgat_tpu_torch.data import dataset
from sl_hwgat_tpu_torch.data.synthetic import write_synthetic_dataset
from sl_hwgat_tpu_torch.models.hwgate import hwgate_from_dataset
from sl_hwgat_tpu_torch.models import build_model
from sl_hwgat_tpu_torch.parallel.dryrun import dryrun_multichip, run_jobs, run_worker, spawn
from sl_hwgat_tpu_torch.serve import Predictor
from sl_hwgat_tpu_torch.train import checkpoint as ckpt_lib
from sl_hwgat_tpu_torch.train.loop import init_state, make_steps, run_epochs
from sl_hwgat_tpu_torch.train.state import make_optimizer

SMALL = dict(embed_dim=32, depths=(1, 1), num_heads=(2, 2), drop_rate=0.0)
TOL = dict(atol=2e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist")
    write_synthetic_dataset(str(root / "input"))
    return root


def _config(root, backend, tag):
    return dict(dataset="SYNTH", model_type="HWGATE", mode="train", time=tag,
                input_root=str(root / "input"), output_root=str(root / "out"), device="cpu",
                epochs=0, batch_size=4, n_workers=1, ckpt_backend=backend)


def _rows_of(cfg, split, rank, epoch):
    """The dataset indices rank ``rank`` of 2 reads in ``epoch``."""
    splits, classes, data = dataset.load_artifacts(cfg.input_root, cfg.dataset)
    loader = dataset.Loader(dataset.KeypointDataset(splits[split], data, classes, None),
                            cfg.batch_size, shuffle=split == "train", seed=cfg.seed)
    loader.row_slice = (2 * rank, 2 * rank + 2)
    order = loader._order(epoch)
    return {int(i) for s in range(0, len(order), 4) for i in loader._batch_ids(order, s)[0]}


@pytest.mark.parametrize("backend", ["pickle", "orbax"])
def test_run_distributed_on_two_ranks(root, backend):
    config = _config(root, backend, f"dist_{backend}")
    out = str(root / f"run_{backend}.pt")
    spawn(run_worker, 2, dict(config=config, overrides=SMALL, mesh=(2, 1, 1), out=out))
    r0, r1 = (torch.load(f"{out}.{r}", weights_only=False) for r in range(2))
    assert r0["metrics"] == r1["metrics"] and r0["history"] == r1["history"]
    assert r0["states"].keys() == {0}
    final = r0["states"][0]
    for k, v in final.items():
        assert torch.equal(v, r1["states"][0][k]), k
    cfg = RunConfig(**config)
    cfg.overrides = dict(SMALL)
    splits, _, _ = dataset.load_artifacts(cfg.input_root, cfg.dataset)
    for rank, got in enumerate((r0, r1)):
        def seen(split, epoch):
            return {i for e, n, i in got["reads"] if e == epoch and n == len(splits[split])}

        assert seen("train", 0) == _rows_of(cfg, "train", rank, 0)
        assert seen("val", 0) == _rows_of(cfg, "val", rank, 0)
        # the train loader warms the first batches of epoch 1 at the end of epoch 0
        assert seen("train", 1) and seen("train", 1) <= _rows_of(cfg, "train", rank, 1)
    # the single-process run of the same config
    state = init_state(cfg)
    train_step, eval_step = make_steps(state.model, state.optimizer)
    loaders = dataset.get_loaders(cfg, cfg.train_transform(), cfg.eval_transform())
    cfg_single = RunConfig(**{**config, "time": f"single_{backend}", "ckpt_backend": "pickle"})
    try:
        run_epochs(cfg_single, state, train_step, eval_step, loaders[0], loaders[1],
                   plot=False)
    finally:
        for loader in loaders:
            loader.close()
    for key, values in state.history.items():
        np.testing.assert_allclose(r0["history"][key], values, **TOL, err_msg=key)
    # rank 0's checkpoint serves the trained weights, and resumes
    path = f"{cfg.save_model_path}_best_loss.ckpt"
    assert os.path.isdir(path) == (backend == "orbax")
    saved = ckpt_lib.read_checkpoint(path)
    for k, v in final.items():
        assert torch.equal(saved["model_state_dict"][k], v), k
    pred = Predictor.from_checkpoint(path, model_type="HWGATE", dataset="SYNTH", device="cpu",
                                     **SMALL)
    trained = hwgate_from_dataset(cfg.dataset_params, 2, **SMALL)
    trained.load_state_dict(final)
    trained.eval()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 32, 64, 2)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(pred.model(x), trained(x))
    resumed = ckpt_lib.resume_from(init_state(cfg), path)
    assert resumed.epoch == 1 and resumed.history == r0["history"]


def test_orbax_backend_trains_resumes_and_tests_through_the_cli(root, monkeypatch, capsys):
    monkeypatch.chdir(root)
    monkeypatch.setitem(models.MODEL_REGISTRY, "HWGATE",
                        lambda ds, d, **kw: hwgate_from_dataset(ds, d, **{**SMALL, **kw}))
    base = ["-d", "SYNTH", "--model", "HWGATE", "-t", "cli", "--ckpt-backend", "orbax",
            "-c", "cpu", "--batch-size", "4"]
    cli.main(["-m", "train", "--epochs", "0", *base])
    folder = root / "output" / "SYNTH" / "HWGATE_cli"
    assert (folder / "model_best_loss.ckpt").is_dir()
    assert (folder / "model_best_loss.ckpt.meta").is_file()
    capsys.readouterr()
    cli.main(["-m", "load", "-px", "best_loss", "--epochs", "1", *base])
    text = capsys.readouterr().out
    assert "epoch    1 |" in text and "epoch    0 |" not in text  # resumed after epoch 0
    cli.main(["-m", "test", "-px", "best_loss", "-k", "5", *base])
    text = capsys.readouterr().out
    assert "no checkpoint" not in text and "=" * 89 in text


DP_ONLY = {"HGATE": dict(embed_dim=32, depths=(1, 1), num_heads=(1, 2), drop_rate=0.0),
           "Transformer": dict(d_model=32, nhead=2, dim_feedforward=64, num_encoder_layers=1,
                               dropout=0.0)}


@pytest.mark.parametrize("name", sorted(DP_ONLY))
def test_dp_only_models_match_the_unsharded_port(tmp_path, name):
    ds = {"num_class": 6, "src_len": 16}
    model = build_model(name, ds, 2, device="cpu", seed=5, **DP_ONLY[name])
    sd = model.state_dict()
    r = np.random.default_rng(6)
    x = torch.from_numpy(r.normal(size=(4, 16, 29, 2)).astype(np.float32))
    y = torch.from_numpy(r.integers(0, 6, size=4)).long()
    valid = torch.tensor([1.0, 1.0, 1.0, 0.0])
    torch.save(sd, tmp_path / "state.pt")
    torch.save((x, y, valid), tmp_path / "batch.pt")
    job = dict(model=name, dataset=ds, overrides=DP_ONLY[name], state=str(tmp_path / "state.pt"),
               batch=str(tmp_path / "batch.pt"), mesh=(2, 1, 1), device="cpu",
               steps=["train", "params"], out=str(tmp_path / "out.pt"))
    got, _ = run_jobs([job], 2)[0]
    step, _ = make_steps(model, make_optimizer("adamw", 5e-4, model.parameters()))
    loss, correct, seen = step(x, y, valid, 0, 0, 0)
    np.testing.assert_allclose(got["train"][0].item(), loss.item(), **TOL)
    assert got["train"][1:].tolist() == [correct.item(), seen.item()]
    for k, p in model.named_parameters():
        np.testing.assert_allclose(got["grads"][k].numpy(), p.grad.numpy(), atol=5e-5,
                                   err_msg=k)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), **TOL, err_msg=k)


@pytest.mark.slow
def test_dryrun_multichip_four_ranks(capfd):
    dryrun_multichip(4)
    assert "dryrun_multichip OK: mesh (1, 2, 2)" in capfd.readouterr().out
