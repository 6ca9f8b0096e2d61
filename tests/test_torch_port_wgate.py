"""The port's WGATE and GATE against the JAX package's, on the CPU.

- the own copies: ``BODY29_EDGES``, ``additive_mask``, the spatial window
  maps and the 29-joint (skeleton) transforms equal the JAX originals
  exactly;
- eval logits on the same weights (JAX init, carried over by
  ``weights.state_dict_from_jax``): f32 at atol 2e-4 / rtol 1e-4, bf16
  compute at 0.05 / 0.05, against the JAX models' default banded attention
  and their frame-packed Pallas kernel (``attn_impl="pallas_packed"``,
  interpret mode; WGATE through its plane entry);
- 3 AdamW steps against the JAX ``make_steps`` (dropout off);
- the weights round trip through ``gat_family_from_torch``;
- ``Predictor.from_checkpoint`` serves GATE through the 29-joint transform;
- one SYNTH epoch of WGATE trains through the loader.

Small geometry: 8 frames, 10 classes, embed 32, 2 blocks, 2 heads (dh 16,
the banded kernels' head dim).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sl_hwgat_tpu import configs as jax_configs
from sl_hwgat_tpu.data import transforms as jax_T
from sl_hwgat_tpu.graphs import adjacency as jax_adjacency
from sl_hwgat_tpu.graphs import skeleton as jax_skeleton
from sl_hwgat_tpu.models.gate import gate_from_dataset as jax_gate
from sl_hwgat_tpu.models.wgate import wgate_from_dataset as jax_wgate
from sl_hwgat_tpu.ops import window as jax_window
from sl_hwgat_tpu.train import losses as jax_losses
from sl_hwgat_tpu.train.loop import init_state as jax_init_state
from sl_hwgat_tpu.train.loop import make_steps as jax_make_steps
from sl_hwgat_tpu.train.torch_import import gat_family_from_torch

from sl_hwgat_tpu_torch import configs
from sl_hwgat_tpu_torch.constants import DATASET_PARAMS
from sl_hwgat_tpu_torch.data import dataset, synthetic
from sl_hwgat_tpu_torch.data import transforms as T
from sl_hwgat_tpu_torch.graphs import adjacency, skeleton
from sl_hwgat_tpu_torch.models import MODEL_NUM_KPS, build_model
from sl_hwgat_tpu_torch.models.gate import gate_from_dataset
from sl_hwgat_tpu_torch.models.wgate import wgate_from_dataset
from sl_hwgat_tpu_torch.ops import window
from sl_hwgat_tpu_torch.serve import Predictor
from sl_hwgat_tpu_torch.train.loop import evaluate, make_steps, train_epoch
from sl_hwgat_tpu_torch.train.state import TrainState, make_optimizer
from sl_hwgat_tpu_torch.weights import params_from_jax, save_state_dict, state_dict_from_jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DS = {"num_class": 10, "src_len": 8}
SMALL = dict(embed_dim=32, depths=2, num_heads=2)
TOL = {"float32": dict(atol=2e-4, rtol=1e-4), "bfloat16": dict(atol=0.05, rtol=0.05)}
LR = 5e-4
MODELS = {"WGATE": (jax_wgate, wgate_from_dataset), "GATE": (jax_gate, gate_from_dataset)}


def test_body29_edges_and_additive_mask_equal_jax():
    assert skeleton.BODY29_EDGES == jax_skeleton.BODY29_EDGES
    for adj in (skeleton.edges_to_dense(skeleton.BODY29_EDGES, 29, self_loops=False),
                adjacency.window_adj(window_size=16)):
        got, want = adjacency.additive_mask(adj), jax_adjacency.additive_mask(adj)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(2, 8, 64, 6), (1, 5, 32, 4)])
def test_spatial_window_maps_equal_jax(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    b, f, k, _ = shape
    got = window.spatial_window_partition(torch.from_numpy(x), 16)
    want = np.asarray(jax_window.spatial_window_partition(jnp.asarray(x), 16))
    np.testing.assert_array_equal(got.numpy(), want)
    back = window.spatial_window_reverse(got, 16, f, k)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_window.spatial_window_reverse(jnp.asarray(want), 16, f, k)))
    np.testing.assert_array_equal(back.numpy(), x)


def _clip(rng, frames):
    return rng.uniform(0.1, 0.9, size=(frames, 29, 2)).astype(np.float32)


@pytest.mark.parametrize("kind", ["eval", "train"])
def test_skeleton_transforms_equal_jax(kind):
    build = f"build_skeleton_{kind}_transform"
    want_t, got_t = getattr(jax_configs, build)(32), getattr(configs, build)(32)
    assert [type(x).__name__ for x in got_t.transforms] == \
        [type(x).__name__ for x in want_t.transforms]
    for seed in range(4):
        clip = _clip(np.random.default_rng(300 + seed), frames=20 + 13 * seed)
        want = want_t(clip.copy(), np.random.default_rng(seed))
        got = got_t(clip.copy(), np.random.default_rng(seed))
        assert got.shape == (32, 29, 2)
        np.testing.assert_array_equal(got, want)


def _jax_variables(name, seed=0, batch=2):
    jm = MODELS[name][0](DS, 2, **SMALL)
    x = np.random.default_rng(seed).random(
        (batch, DS["src_len"], MODEL_NUM_KPS[name], 2)).astype(np.float32)
    init = jax.jit(lambda key, xx: jm.init(key, xx, train=False))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), x)), x


@pytest.fixture(scope="module", params=sorted(MODELS))
def model_case(request):
    variables, x = _jax_variables(request.param)
    return request.param, variables, x


def test_state_dict_round_trips_to_jax(model_case):
    name, variables, _ = model_case
    sd = state_dict_from_jax(variables)
    model = MODELS[name][1](DS, 2, **SMALL)
    assert set(model.state_dict()) == set(sd)
    assert sd["layers.0.attn.qkv.weight"].shape == (96, 32)
    back = gat_family_from_torch({k: v.numpy() for k, v in sd.items()})
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn_impl", ["auto", "pallas_packed"])
def test_eval_logits_match_jax(model_case, compute_dtype, attn_impl):
    name, variables, x = model_case
    jm = MODELS[name][0](DS, 2, compute_dtype=compute_dtype, attn_impl=attn_impl, **SMALL)
    want = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(variables, x))
    tm = MODELS[name][1](DS, 2, compute_dtype=compute_dtype, **SMALL)
    tm.load_state_dict(state_dict_from_jax(variables))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (x.shape[0], DS["num_class"])
    np.testing.assert_allclose(got, want, **TOL[compute_dtype])


class _Cfg:
    seed = 0
    optimizer_type = "adamw"
    lr = LR


def _batches(name, n_steps, batch, seed):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        x = r.random((batch, DS["src_len"], MODEL_NUM_KPS[name], 2)).astype(np.float32)
        y = r.integers(0, DS["num_class"], size=batch).astype(np.int32)
        valid = np.ones(batch, np.float32)
        valid[-1] = 0.0  # one padded row
        out.append((x, y, valid))
    return out


def _jax_grads(model, variables, x, y, valid):
    aux = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(params):
        logits = model.apply({**aux, "params": params}, x, train=True)
        per = jax.vmap(lambda lg, lb: jax_losses.smoothed_cross_entropy(lg[None], lb[None]))(
            logits, y)
        return jnp.sum(per * valid) / jnp.maximum(jnp.sum(valid), 1.0)

    return jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(variables["params"]))


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_train_steps_match_jax(name, compute_dtype):
    jm = MODELS[name][0](DS, 2, compute_dtype=compute_dtype, drop_rate=0.0, **SMALL)
    state, jopt = jax_init_state(jm, _Cfg, (DS["src_len"], MODEL_NUM_KPS[name], 2))
    variables, opt_state = state.variables, state.opt_state
    jstep, _ = jax_make_steps(jm, jopt, donate=False)

    tm = MODELS[name][1](DS, 2, compute_dtype=compute_dtype, drop_rate=0.0, **SMALL)
    tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, variables)))
    tstep, _ = make_steps(tm, make_optimizer("adamw", LR, tm.parameters()))

    batches = _batches(name, 3, 4, seed=1)
    want_grads = _jax_grads(jm, variables, *(jnp.asarray(a) for a in batches[0]))
    key = jax.random.PRNGKey(0)
    loss_tol = TOL["float32"] if compute_dtype == "float32" else dict(atol=0.05)
    for step, (x, y, valid) in enumerate(batches):
        variables, opt_state, jloss, _, jn = jstep(
            variables, opt_state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(valid), key, 0, step)
        tloss, _, tn = tstep(torch.from_numpy(x), torch.from_numpy(y).long(),
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
            np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(), **TOL["float32"],
                                       err_msg=k)


def test_build_model_cpu_is_seeded_and_cuda_needs_a_card():
    for name in MODELS:
        a, b = (build_model(name, DS, 2, device="cpu", seed=3, **SMALL) for _ in range(2))
        assert not a.training
        for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for name in MODELS:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(name, DATASET_PARAMS["FDMSE-ISL"], 2)


def _raw_clip(frames, rng):
    return rng.random((frames, 543, 4)).astype(np.float32)


def test_predictor_serves_gate_through_the_skeleton_transform(tmp_path):
    ds = DATASET_PARAMS["SYNTH"]
    path = str(tmp_path / "gate.pt")
    save_state_dict(path, build_model("GATE", ds, 2, device="cpu", seed=1, **SMALL))
    pred = Predictor.from_checkpoint(path, model_type="GATE", dataset="SYNTH", device="cpu",
                                     **SMALL)
    rng = np.random.default_rng(5)
    clips = [_raw_clip(f, rng) for f in (20, 45, 70)]
    jax_pipe = jax_T.Compose([*jax_configs.build_static_transform("mediapipe").transforms,
                              *jax_configs.build_skeleton_eval_transform(ds["src_len"]).transforms])
    payload = {"feat": clips[1].copy(), "vid_width": 1, "vid_height": 1}
    x = pred.preprocess(clips[1])
    assert x.shape == (ds["src_len"], 29, 2)
    np.testing.assert_array_equal(x, jax_pipe(payload))
    logits = pred.predict_logits(clips)
    with torch.no_grad():
        want = pred.model(torch.from_numpy(np.stack([pred.preprocess(c) for c in clips])))
    np.testing.assert_allclose(logits, want.numpy(), atol=2e-4, rtol=1e-4)
    pred.close()
    wgate = str(tmp_path / "wgate.pt")
    save_state_dict(wgate, build_model("WGATE", ds, 2, device="cpu", **SMALL))
    pw = Predictor.from_checkpoint(wgate, model_type="WGATE", dataset="SYNTH", device="cpu",
                                   **SMALL)
    assert pw.preprocess(clips[0]).shape == (ds["src_len"], 64, 2)


def test_synth_epoch_trains_wgate_on_cpu(tmp_path):
    ds = DATASET_PARAMS["SYNTH"]
    synthetic.write_synthetic_dataset(str(tmp_path), seed=2)
    splits, classes, data_map = dataset.load_artifacts(str(tmp_path), "SYNTH")
    train = dataset.Loader(dataset.KeypointDataset(
        splits["train"], data_map, classes, configs.build_train_transform(ds["src_len"])),
        8, shuffle=True, num_workers=2)
    val = dataset.Loader(dataset.KeypointDataset(
        splits["val"], data_map, classes, configs.build_eval_transform(ds["src_len"])),
        8, num_workers=2)
    model = wgate_from_dataset(ds, 2, generator=torch.Generator().manual_seed(0), **SMALL)
    opt = make_optimizer("adamw", LR, model.parameters())
    state = TrainState(model, opt)
    train_step, eval_step = make_steps(model, opt)
    try:
        loss, acc = train_epoch(train_step, state, train, 0, 0)
        val_loss, val_acc = evaluate(eval_step, state, val, k=5)
    finally:
        train.close()
        val.close()
    assert np.isfinite(loss) and 0.0 <= acc <= 1.0
    assert np.isfinite(val_loss) and 0.0 <= val_acc <= 1.0


_IMPORT_CHECK = """
import json, sys
for name in ("jax", "flax", "optax"):
    sys.modules[name] = None  # any import of them raises ImportError
import sl_hwgat_tpu_torch.ops.banded_attention, sl_hwgat_tpu_torch.models.wgate
import sl_hwgat_tpu_torch.models.gate
print(json.dumps(sorted(n for n in sys.modules if n.split(".")[0] == "sl_hwgat_tpu")))
"""


def test_banded_modules_import_no_jax_and_no_reference_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO_ROOT
    out = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], cwd=REPO_ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(MODELS))
def test_full_geometry_logits_match_jax(name):
    """FDMSE-ISL: 192 frames, 2002 classes, embed 128, 8 blocks, 8 heads."""
    ds = DATASET_PARAMS["FDMSE-ISL"]
    jm = MODELS[name][0](ds, 2)
    x = np.random.default_rng(0).random((2, 192, MODEL_NUM_KPS[name], 2)).astype(np.float32)
    variables = jax.tree.map(np.asarray, jax.jit(lambda k, xx: jm.init(k, xx, train=False))(
        jax.random.PRNGKey(0), x))
    want = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(variables, x))
    tm = MODELS[name][1](ds, 2)
    tm.load_state_dict(state_dict_from_jax(variables))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL["float32"])
