"""The port's command line for STGCN, DecoupledGCN and Transformer, on the CPU.

SYNTH (the port's ``data/synthetic.py``), batch 4, 2 workers, full widths
(the JAX package's ``tests/test_e2e_train.py`` sizes). For each model:

- ``cli.run`` in test mode on one JAX ``.ckpt`` (written by the JAX
  ``init_state`` + ``save_checkpoint``; for the GCNs with random BatchNorm
  statistics, which the port reads as ``running_mean``/``running_var``)
  against the JAX ``cli.run`` on the same file: per split loss at atol 2e-4
  / rtol 1e-4 and accuracy exactly;
- ``cli.main`` trains one epoch (``-m train --epochs 0 -c cpu``) and tests
  the best checkpoint (with ``--remat``, ``--stream-dtype``, ``--attn-dtype``
  and ``--attn-impl``, which are dropped for these models); STGCN instead through ``cli.run`` with
  ``RunConfig.optimizer_type = "nadam"`` (the JAX package's ``nadam``
  option; neither command line has a flag for it): the optimizer state saved
  is the port's NAdam's, and resume reads it back.
"""

import os

import numpy as np
import pytest
import torch

import jax

from sl_hwgat_tpu import cli as jax_cli
from sl_hwgat_tpu.configs import RunConfig as JaxRunConfig
from sl_hwgat_tpu.models import build_model as jax_build_model
from sl_hwgat_tpu.train import checkpoint as jax_ckpt
from sl_hwgat_tpu.train import loop as jax_loop

from sl_hwgat_tpu_torch import cli
from sl_hwgat_tpu_torch.configs import RunConfig
from sl_hwgat_tpu_torch.data.synthetic import write_synthetic_dataset
from sl_hwgat_tpu_torch.train import checkpoint as ckpt_lib
from sl_hwgat_tpu_torch.train.loop import init_state
from sl_hwgat_tpu_torch.train.state import OptaxNAdam

MODELS = ("STGCN", "DecoupledGCN", "Transformer")
LOSS_TOL = dict(atol=2e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """The tier-1 run puts six test workers on the machine's cores: torch
    runs these tests on two threads, so that the workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_baselines")
    write_synthetic_dataset(str(root / "input"))
    return root


def jax_cfg(root, model, time, mode="train", weights="none"):
    cfg = JaxRunConfig(dataset="SYNTH", model_type=model, mode=mode, time=time,
                       model_weights=weights, input_root=str(root / "input"),
                       output_root=str(root / "jax_out"))
    cfg.batch_size, cfg.n_workers = 4, 2
    return cfg


def port_cfg(root, model, time, mode="train", weights="none"):
    cfg = RunConfig(dataset="SYNTH", model_type=model, mode=mode, time=time,
                    model_weights=weights, input_root=str(root / "input"),
                    output_root=str(root / "port_out"), device="cpu")
    cfg.batch_size, cfg.n_workers = 4, 2
    return cfg


def jax_checkpoint(root, model) -> str:
    cfg = jax_cfg(root, model, "ckpt")
    jm = jax_build_model(model, cfg.dataset_params, 2)
    state, _ = jax_loop.init_state(jm, cfg, (cfg.src_len, 29, 2), ("dropout",))
    if "batch_stats" in state.variables:
        r = np.random.default_rng(3)
        state.variables["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, a: (r.uniform(-0.2, 0.2, np.shape(a)) if p[-1].key == "mean"
                          else r.uniform(0.8, 1.2, np.shape(a))).astype(np.float32),
            state.variables["batch_stats"])
    path = str(root / f"jax_{model}.ckpt")
    jax_ckpt.save_checkpoint(path, state, cfg.lr)
    return path


@pytest.mark.parametrize("model", MODELS)
def test_test_mode_on_a_jax_checkpoint_matches_jax(workdir, model, monkeypatch):
    monkeypatch.setenv("SL_HWGAT_NO_COMPILE_CACHE", "1")
    weights = jax_checkpoint(workdir, model)
    want, _ = jax_cli.run(jax_cfg(workdir, model, "test_mode", "test", weights), progress=False)
    got, state = cli.run(port_cfg(workdir, model, "test_mode", "test", weights), progress=False)
    assert set(got) == set(want) == {"train", "val", "test"}
    for split in want:
        np.testing.assert_allclose(got[split][0], want[split][0], **LOSS_TOL, err_msg=split)
        assert got[split][1] == want[split][1], split
    if model != "Transformer":  # the JAX file's statistics were carried
        stats = [v for k, v in state.model.state_dict().items() if k.endswith("running_var")]
        assert stats and all(not torch.all(v == 1.0) for v in stats)


@pytest.mark.parametrize("model, optimizer", [("STGCN", "nadam"), ("DecoupledGCN", "adamw"),
                                              ("Transformer", "adamw")])
def test_cli_trains_and_tests_one_epoch(workdir, model, optimizer, monkeypatch, capsys):
    monkeypatch.chdir(workdir)
    tag = f"main_{optimizer}"
    common = ["-d", "SYNTH", "--model", model, "-t", tag, "-c", "cpu", "--batch-size", "4"]
    cfg = port_cfg(workdir, model, tag)
    cfg.output_root, cfg.input_root = "output", "input"
    if optimizer == "nadam":
        cfg.epochs, cfg.optimizer_type = 0, "nadam"
        cli.run(cfg)
    else:
        cli.main(["-m", "train", "--epochs", "0", *common])
    out = capsys.readouterr().out
    assert "epoch    0 | tr_ls" in out and "=" * 89 in out
    best = f"{cfg.save_model_path}_best_loss.ckpt"
    assert os.path.exists(best) and os.path.exists(cfg.save_cm_path)
    payload = ckpt_lib.read_checkpoint(best)
    assert payload["epoch"] == 0 and len(payload["train_loss_list"]) == 1
    # the HWGATE/HGATE flags are dropped for these models, as the JAX
    # command line drops them
    cli.main(["-m", "test", "-px", "best_loss", "-k", "5", "--remat", "--stream-dtype",
              "bfloat16", "--attn-dtype", "bfloat16", "--attn-impl", "hybrid", *common])
    out = capsys.readouterr().out
    assert "[cli] no checkpoint" not in out and "=" * 89 in out
    if optimizer == "nadam":
        state = ckpt_lib.resume_from(init_state(cfg), best)  # cfg.optimizer_type nadam
        assert isinstance(state.optimizer, OptaxNAdam) and state.epoch == 1
        steps = {float(s["step"]) for s in state.optimizer.state_dict()["state"].values()}
        assert steps == {8.0}  # 32 train clips in batches of 4
