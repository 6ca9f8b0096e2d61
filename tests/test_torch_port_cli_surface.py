"""The port's command line and transfer loading, on the CPU.

- ``cli.parser`` has every flag of the JAX package's parser, with its
  default, choices and type; ``cli.main`` maps the flags to the config and
  the model overrides exactly as the JAX ``cli.main`` does.
- ``main_torch.py -m train … --epochs 2 -c cpu``, then ``-m load`` and
  ``-m test … -px best_loss -k 5``, run in a subprocess on a written SYNTH
  (HWGATE narrowed to embed 32, depths (1, 1), heads (2, 2) through the
  model registry) and leave the verify recipe's artifacts.
- Without ``-c cpu`` and with no card the run raises; ``--ckpt-backend
  orbax`` is refused with its message, and ``--attn-impl ell`` reaches
  WGATE's and GATE's constructors.
- Transfer: a 7-class HWGATE takes the body of a 16-class one, its head left
  at fresh init, from a port ``.ckpt``, from a JAX ``.ckpt`` (read in a
  subprocess with jax, flax and optax blocked; logits against the JAX model
  with the same body and head at 2e-4 / 1e-4) and from a reference-named
  ``.pt``.
"""

import argparse
import json
import os
import subprocess
import sys

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
from sl_hwgat_tpu_torch.data.synthetic import write_synthetic_dataset
from sl_hwgat_tpu_torch.models import build_model
from sl_hwgat_tpu_torch.train import checkpoint as ckpt_lib
from sl_hwgat_tpu_torch.train.state import TrainState, make_optimizer
from sl_hwgat_tpu_torch.weights import params_from_jax, state_dict_from_jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(embed_dim=32, depths=(1, 1), num_heads=(2, 2))


def captured_parser(parse, argv):
    """The ArgumentParser that ``parse`` builds while it parses ``argv``."""
    seen = []
    real = argparse.ArgumentParser.parse_args

    def spy(self, args=None, namespace=None):
        seen.append(self)
        return real(self, argv, namespace)

    argparse.ArgumentParser.parse_args = spy
    try:
        parse()
    finally:
        argparse.ArgumentParser.parse_args = real
    return seen[0]


def test_parser_has_every_jax_flag_and_default():
    argv = ["-d", "SYNTH", "--model", "HWGATE"]
    want = captured_parser(jax_cli.parser, argv)
    got = captured_parser(cli.parser, argv)
    assert set(got._option_string_actions) == set(want._option_string_actions)
    for opt, w in want._option_string_actions.items():
        g = got._option_string_actions[opt]
        assert (g.dest, g.default, g.choices, g.type, g.nargs, g.required, g.const) == \
            (w.dest, w.default, w.choices, w.type, w.nargs, w.required, w.const), opt
    assert vars(cli.parser(argv)) == vars(want.parse_args(argv))


FLAG_SETS = [
    [],
    ["--epochs", "3", "--batch-size", "8", "--lr", "3e-4", "--t-max", "3", "--grad-accum", "2"],
    ["--attn-dtype", "bfloat16", "--compute-dtype", "bfloat16", "--stream-dtype", "float32",
     "--remat", "--attn-impl", "hybrid"],
    ["--model", "HGATE", "--attn-dtype", "bfloat16", "--stream-dtype", "bfloat16", "--remat",
     "--attn-impl", "stacked"],
    ["--model", "WGATE", "--attn-impl", "pallas_packed", "--compute-dtype", "bfloat16",
     "--remat", "--attn-dtype", "bfloat16"],
    ["--model", "GATE", "--attn-impl", "hybrid", "-m", "load", "-mw", "w.ckpt", "-px", "best_acc",
     "-k", "5", "-t", "v1", "-ft", "keypoints"],
]


@pytest.mark.parametrize("flags", FLAG_SETS, ids=range(len(FLAG_SETS)))
def test_main_maps_flags_as_jax_does(flags, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    argv = ["-d", "SYNTH", "--model", "HWGATE", "-t", "v0", *flags]
    seen = {}
    monkeypatch.setattr(jax_cli, "run", lambda cfg, progress=True: seen.setdefault("jax", cfg))
    monkeypatch.setattr(cli, "run", lambda cfg, progress=True: seen.setdefault("port", cfg))
    monkeypatch.setattr(sys, "argv", ["main.py", *argv])
    jax_cli.main()
    cli.main(argv)
    want, got = seen["jax"], seen["port"]
    for name in ("dataset", "model_type", "mode", "feature_type", "time", "postfix",
                 "model_weights", "topk", "epochs", "batch_size", "lr", "scheduler_t_max",
                 "grad_accum", "overrides", "seed", "optimizer_type", "save_interval",
                 "n_workers", "out_folder"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.device == "cuda:0"


def test_device_flag_keeps_its_meaning():
    assert [cli.device_of(f) for f in ("0", "1", "cpu", "cuda:2")] == [
        "cuda:0", "cuda:1", "cpu", "cuda:2"]


def test_without_cpu_flag_and_card_the_run_raises(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-m", "test", "-d", "SYNTH", "--model", "HWGATE"])


def test_orbax_and_ell_are_refused(monkeypatch, tmp_path):
    """Neither flag is refused any more: ``--ckpt-backend orbax`` (the
    sharded checkpoint since the parallel layer was ported) and
    ``--attn-impl ell`` (since the ELL attention was ported) reach the run's
    config; here the run stops at the absent dataset, after the model was
    configured."""
    monkeypatch.chdir(tmp_path)
    seen = []
    real = cli.run

    def capture(cfg, **kw):
        seen.append((cfg.ckpt_backend, cfg.overrides))
        return real(cfg, **kw)

    monkeypatch.setattr(cli, "run", capture)
    with pytest.raises(FileNotFoundError):
        cli.main(["-d", "SYNTH", "--model", "HWGATE", "--ckpt-backend", "orbax", "-c", "cpu"])
    for model in ("WGATE", "GATE"):
        with pytest.raises(FileNotFoundError):
            cli.main(["-d", "SYNTH", "--model", model, "--attn-impl", "ell", "-c", "cpu"])
    assert seen == [("orbax", {}), ("pickle", {"attn_impl": "ell"}),
                    ("pickle", {"attn_impl": "ell"})]


_RUN_MAIN = """
import functools, json, runpy, sys
import torch
from sl_hwgat_tpu_torch import models
torch.set_num_threads(2)
models.MODEL_REGISTRY["HWGATE"] = functools.partial(models.MODEL_REGISTRY["HWGATE"], **{small})
for argv in json.loads(sys.argv[1]):
    sys.argv = ["main_torch.py", *argv]
    runpy.run_path({main!r}, run_name="__main__")
"""


def test_main_torch_trains_loads_and_tests_on_the_cpu(tmp_path):
    write_synthetic_dataset(str(tmp_path / "input"))
    common = ["-d", "SYNTH", "--model", "HWGATE", "-t", "v1", "-c", "cpu"]
    runs = [["-m", "train", "--epochs", "2", *common], ["-m", "load", "--epochs", "3", *common],
            ["-m", "test", "-px", "best_loss", "-k", "5", *common]]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO_ROOT
    script = _RUN_MAIN.format(small=SMALL, main=os.path.join(REPO_ROOT, "main_torch.py"))
    out = subprocess.run([sys.executable, "-c", script, json.dumps(runs)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    folder = tmp_path / "output" / "SYNTH" / "HWGATE_v1"
    names = set(os.listdir(folder))
    assert {"model_best_loss.ckpt", "model_best_acc.ckpt", "loss_curve.png", "acc_curve.png",
            "cm_list_w.csv", "config.pkl", "hwgate.py", "configs.py",
            "transforms.py"} <= names, names
    lines = out.stdout.splitlines()
    epochs = [int(ln.split()[1]) for ln in lines if ln.startswith("epoch ")]
    best = [float(ln.split()[-1]) for ln in lines if ln.startswith("epoch ")][:3]
    resumed_at = 1 + max(e for e in range(3) if e == 0 or best[e] < best[e - 1])
    # train ran epochs 0-2; load resumed after the best-loss checkpoint's epoch
    assert epochs == [0, 1, 2, *range(resumed_at, 4)]
    tables = [i for i, ln in enumerate(lines) if ln == "=" * 89]
    assert len(tables) == 6 and lines[tables[-2] + 1].startswith("train acc ")
    ckpt = ckpt_lib.read_checkpoint(str(folder / "model_best_loss.ckpt"))
    assert ckpt["format_version"] == 1 and len(ckpt["val_loss_list"]) == ckpt["epoch"] + 1
    assert ckpt["val_loss_list"][-1] == min(ckpt["val_loss_list"])


# --- transfer ---------------------------------------------------------------

DS7 = {"num_class": 7, "src_len": 32}
DS16 = {"num_class": 16, "src_len": 32}


def fresh7(seed=5):
    model = build_model("HWGATE", DS7, 2, device="cpu", seed=seed, **SMALL)
    return TrainState(model, make_optimizer("adamw", 5e-4, model.parameters()))


def assert_transferred(got: dict, source: dict, fresh: dict):
    """The head of ``got`` is ``fresh``'s, every other tensor ``source``'s."""
    for name, t in got.items():
        if name.startswith("head."):
            assert torch.equal(t, fresh[name]), name
        else:
            assert torch.equal(t, source[name]), name


def test_transfer_from_a_port_checkpoint(tmp_path, capsys):
    src = build_model("HWGATE", DS16, 2, device="cpu", seed=1, **SMALL)
    state16 = TrainState(src, make_optimizer("adamw", 5e-4, src.parameters()))
    path = str(tmp_path / "port.ckpt")
    ckpt_lib.save_checkpoint(path, state16, 5e-4)
    state = fresh7()
    fresh = {k: v.clone() for k, v in state.model.state_dict().items()}
    ckpt_lib.load_pretrained_into(state, path)
    assert capsys.readouterr().out.strip() == (
        "[checkpoint] kept fresh init for: head.weight, head.bias")
    assert_transferred(state.model.state_dict(), src.state_dict(), fresh)


def test_transfer_from_a_reference_pt(tmp_path):
    src = build_model("HWGATE", DS16, 2, device="cpu", seed=2, **SMALL)
    sd = {f"model.{k}": v for k, v in src.state_dict().items()}
    sd["model.layers.0.blocks.1.attn.attn_mask"] = torch.ones(3, 3)  # rebuilt, not loaded
    torch.save({"model_state_dict": sd}, tmp_path / "reference.pt")
    state = fresh7()
    fresh = {k: v.clone() for k, v in state.model.state_dict().items()}
    ckpt_lib.load_pretrained_into(state, str(tmp_path / "reference.pt"), verbose=False)
    assert_transferred(state.model.state_dict(), src.state_dict(), fresh)


_BLOCKED_TRANSFER = """
import json, sys
for name in ("jax", "jaxlib", "flax", "optax"):
    sys.modules[name] = None  # any import of them raises ImportError
import torch
from sl_hwgat_tpu_torch.models import build_model
from sl_hwgat_tpu_torch.train import checkpoint
from sl_hwgat_tpu_torch.train.state import TrainState, make_optimizer
model = build_model("HWGATE", {{"num_class": 7, "src_len": 32}}, 2, device="cpu", seed=5, **{small})
state = TrainState(model, make_optimizer("adamw", 5e-4, model.parameters()))
checkpoint.load_pretrained_into(state, sys.argv[1], verbose=False)
x = torch.load(sys.argv[2])
with torch.no_grad():
    logits = model.eval()(x)
torch.save({{"state_dict": model.state_dict(), "logits": logits}}, sys.argv[3])
print(json.dumps([n for n, m in sys.modules.items() if m is not None
                  and n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "sl_hwgat_tpu")]))
"""


def test_transfer_from_a_jax_checkpoint_with_jax_blocked(tmp_path):
    cfg = JaxRunConfig(dataset="SYNTH", time="t")
    jm16 = jax_build_model("HWGATE", DS16, 2, stream_layout="token", **SMALL)
    state16, _ = jax_loop.init_state(jm16, cfg, (32, 64, 2), ("dropout", "prune"))
    path = str(tmp_path / "jax.ckpt")
    jax_ckpt.save_checkpoint(path, state16, cfg.lr)
    x = torch.from_numpy(np.random.default_rng(6).random((2, 32, 64, 2)).astype(np.float32))
    torch.save(x, tmp_path / "x.pt")

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO_ROOT
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_TRANSFER.format(small=SMALL), path,
         str(tmp_path / "x.pt"), str(tmp_path / "out.pt")],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    result = torch.load(tmp_path / "out.pt")

    source = state_dict_from_jax(jax.tree.map(np.asarray, state16.variables))
    assert_transferred(result["state_dict"], source, fresh7().model.state_dict())

    # the JAX model with the same body (the checkpoint's) and head (the port's)
    jm7 = jax_build_model("HWGATE", DS7, 2, stream_layout="token", **SMALL)
    state7, _ = jax_loop.init_state(jm7, cfg, (32, 64, 2), ("dropout", "prune"))
    state7 = jax_ckpt.load_pretrained_into(state7, path, "HWGATE", verbose=False)
    variables = jax.tree.map(np.asarray, state7.variables)
    head = result["state_dict"]
    variables["params"]["head"] = {"kernel": head["head.weight"].numpy().T,
                                   "bias": head["head.bias"].numpy()}
    assert set(params_from_jax(variables["params"])) == {
        k for k in head if k not in ("B", "pos_encoder.pe")}
    want = np.asarray(jm7.apply(variables, x.numpy(), train=False))
    np.testing.assert_allclose(result["logits"].numpy(), want, atol=2e-4, rtol=1e-4)


def test_trace_flag_writes_a_chrome_trace(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(cli, "run", lambda cfg, progress=True: torch.ones(64).sum())
    cli.main(["-d", "SYNTH", "--model", "HWGATE", "-c", "cpu", "--trace", str(tmp_path / "tr")])
    (trace_file,) = (tmp_path / "tr").iterdir()
    with open(trace_file) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::sum" for e in events)
