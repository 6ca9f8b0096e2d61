"""The port's HGATE against the JAX package's, on the CPU.

- the own copies: ``block_partition``/``block_reverse`` and
  ``hgate_block_adj`` equal the JAX originals exactly;
- eval logits on the same weights (JAX init, carried over by
  ``weights.state_dict_from_jax``), on the default path (the JAX model's
  stacked attention on the CPU) and on ``attn_impl="hybrid"`` (its Pallas
  masked softmax, interpret mode): f32 at atol 2e-4 / rtol 1e-4, bf16
  compute at 0.05 / 0.05; odd head counts (1 at stage 0) included;
- 3 AdamW steps against the JAX ``make_steps`` (dropout off), both paths;
- the weights round trip through ``gat_family_from_torch``;
- ``build_model("HGATE")`` works on the CPU and needs a card by default;
- ``Predictor.from_checkpoint`` serves HGATE through the 29-joint transform;
- one SYNTH epoch trains HGATE through the loader.

Small geometry: 8 frames, 10 classes, embed 32, depths (2, 2, 2); the
58-token units of the full model (29 joints × 2 frames) at every stage.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sl_hwgat_tpu import configs as jax_configs
from sl_hwgat_tpu.data import transforms as jax_T
from sl_hwgat_tpu.graphs import adjacency as jax_adjacency
from sl_hwgat_tpu.graphs.skeleton import BODY29_EDGES
from sl_hwgat_tpu.models.hgate import hgate_from_dataset as jax_hgate
from sl_hwgat_tpu.ops import window as jax_window
from sl_hwgat_tpu.train.loop import init_state as jax_init_state
from sl_hwgat_tpu.train.loop import make_steps as jax_make_steps
from sl_hwgat_tpu.train.torch_import import gat_family_from_torch

from sl_hwgat_tpu_torch import configs
from sl_hwgat_tpu_torch.constants import DATASET_PARAMS
from sl_hwgat_tpu_torch.data import dataset, synthetic
from sl_hwgat_tpu_torch.graphs import adjacency
from sl_hwgat_tpu_torch.models import MODEL_NUM_KPS, build_model
from sl_hwgat_tpu_torch.models.hgate import hgate_from_dataset
from sl_hwgat_tpu_torch.ops import window
from sl_hwgat_tpu_torch.serve import Predictor
from sl_hwgat_tpu_torch.train.loop import evaluate, make_steps, train_epoch
from sl_hwgat_tpu_torch.train.state import TrainState, make_optimizer
from sl_hwgat_tpu_torch.weights import params_from_jax, save_state_dict, state_dict_from_jax

DS = {"num_class": 10, "src_len": 8}
# heads (1, 2, 4): stage 0 has one head, so its shifted block mixes temporal
# groups inside a JAX supertile of two units and takes the split path
SMALL = {"odd": dict(embed_dim=32, depths=(2, 2, 2), num_heads=(1, 2, 4)),
         "even": dict(embed_dim=32, depths=(2, 2, 2), num_heads=(2, 2, 2))}
TOL = {"float32": dict(atol=2e-4, rtol=1e-4), "bfloat16": dict(atol=0.05, rtol=0.05)}
LR = 5e-4


@pytest.mark.parametrize("shape", [(2, 8, 29, 6), (1, 6, 29, 4)])
def test_block_maps_equal_jax(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    _, f, k, _ = shape
    got = window.block_partition(torch.from_numpy(x), 2)
    want = np.asarray(jax_window.block_partition(jnp.asarray(x), 2))
    np.testing.assert_array_equal(got.numpy(), want)
    back = window.block_reverse(got, 2, f, k)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_window.block_reverse(jnp.asarray(want), 2, f, k)))
    np.testing.assert_array_equal(back.numpy(), x)


def test_hgate_block_adj_equals_jax():
    for tp in (1, 2, 3):
        got = adjacency.hgate_block_adj(num_kps=29, temporal_patch=tp)
        want = jax_adjacency.hgate_block_adj(BODY29_EDGES, 29, tp)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert MODEL_NUM_KPS["HGATE"] == 29


def _jax_variables(small, seed=0, batch=2):
    jm = jax_hgate(DS, 2, **SMALL[small])
    x = np.random.default_rng(seed).random((batch, DS["src_len"], 29, 2)).astype(np.float32)
    init = jax.jit(lambda key, xx: jm.init(key, xx, train=False))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), x)), x


@pytest.fixture(scope="module", params=sorted(SMALL))
def heads(request):
    variables, x = _jax_variables(request.param)
    return request.param, variables, x


def test_state_dict_round_trips_to_jax(heads):
    small, variables, _ = heads
    sd = state_dict_from_jax(variables)
    model = hgate_from_dataset(DS, 2, **SMALL[small])
    assert set(model.state_dict()) == set(sd)
    assert sd["layers.2.blocks.1.attn.qkv.weight"].shape == (384, 128)
    back = gat_family_from_torch({k: v.numpy() for k, v in sd.items()})
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn_impl", ["auto", "hybrid"])
def test_eval_logits_match_jax(heads, attn_impl, compute_dtype):
    small, variables, x = heads
    jm = jax_hgate(DS, 2, attn_impl=attn_impl, compute_dtype=compute_dtype, **SMALL[small])
    want = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(variables, x))
    tm = hgate_from_dataset(DS, 2, attn_impl=attn_impl, compute_dtype=compute_dtype,
                            **SMALL[small])
    tm.load_state_dict(state_dict_from_jax(variables))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (x.shape[0], DS["num_class"])
    np.testing.assert_allclose(got, want, **TOL[compute_dtype])


class _Cfg:
    seed = 0
    optimizer_type = "adamw"
    lr = LR


@pytest.mark.parametrize("attn_impl", ["auto", "hybrid"])
def test_train_steps_match_jax(attn_impl):
    small = SMALL["even"]
    jm = jax_hgate(DS, 2, attn_impl=attn_impl, drop_rate=0.0, **small)
    state, jopt = jax_init_state(jm, _Cfg, (DS["src_len"], 29, 2))
    variables, opt_state = state.variables, state.opt_state
    jstep, _ = jax_make_steps(jm, jopt, donate=False)
    tm = hgate_from_dataset(DS, 2, attn_impl=attn_impl, drop_rate=0.0, **small)
    tm.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, variables)))
    tstep, _ = make_steps(tm, make_optimizer("adamw", LR, tm.parameters()))
    r = np.random.default_rng(1)
    key = jax.random.PRNGKey(0)
    for step in range(3):
        x = r.random((4, DS["src_len"], 29, 2)).astype(np.float32)
        y = r.integers(0, DS["num_class"], size=4).astype(np.int32)
        valid = np.array([1, 1, 1, 0], np.float32)
        variables, opt_state, jloss, _, jn = jstep(
            variables, opt_state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(valid), key, 0, step)
        tloss, _, tn = tstep(torch.from_numpy(x), torch.from_numpy(y).long(),
                             torch.from_numpy(valid), 0, 0, step)
        np.testing.assert_allclose(tloss.item(), float(jloss), **TOL["float32"])
        assert tn.item() == float(jn) == 3.0
    want = params_from_jax(jax.tree.map(np.asarray, variables["params"]))
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(), **TOL["float32"],
                                   err_msg=k)


def test_build_model_cpu_is_seeded_and_cuda_needs_a_card():
    a, b = (build_model("HGATE", DS, 2, device="cpu", seed=3, **SMALL["even"])
            for _ in range(2))
    assert not a.training
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("HGATE", DATASET_PARAMS["FDMSE-ISL"], 2)


def test_predictor_serves_hgate_through_the_skeleton_transform(tmp_path):
    ds = DATASET_PARAMS["SYNTH"]
    path = str(tmp_path / "hgate.pt")
    save_state_dict(path, build_model("HGATE", ds, 2, device="cpu", seed=1, **SMALL["even"]))
    pred = Predictor.from_checkpoint(path, model_type="HGATE", dataset="SYNTH", device="cpu",
                                     attn_impl="hybrid", **SMALL["even"])
    assert all(b.attn.attn_impl == "hybrid" for s in pred.model.layers for b in s.blocks)
    rng = np.random.default_rng(5)
    clips = [rng.random((f, 543, 4)).astype(np.float32) for f in (20, 45, 70)]
    jax_pipe = jax_T.Compose([*jax_configs.build_static_transform("mediapipe").transforms,
                              *jax_configs.build_skeleton_eval_transform(ds["src_len"]).transforms])
    x = pred.preprocess(clips[1])
    assert x.shape == (ds["src_len"], 29, 2)
    np.testing.assert_array_equal(x, jax_pipe({"feat": clips[1].copy(), "vid_width": 1,
                                               "vid_height": 1}))
    logits = pred.predict_logits(clips)
    with torch.no_grad():
        want = pred.model(torch.from_numpy(np.stack([pred.preprocess(c) for c in clips])))
    np.testing.assert_allclose(logits, want.numpy(), atol=2e-4, rtol=1e-4)
    pred.close()


def test_synth_epoch_trains_hgate_on_cpu(tmp_path):
    ds = DATASET_PARAMS["SYNTH"]
    synthetic.write_synthetic_dataset(str(tmp_path), seed=2)
    splits, classes, data_map = dataset.load_artifacts(str(tmp_path), "SYNTH")
    train = dataset.Loader(dataset.KeypointDataset(
        splits["train"], data_map, classes, configs.build_skeleton_train_transform(ds["src_len"])),
        8, shuffle=True, num_workers=2)
    val = dataset.Loader(dataset.KeypointDataset(
        splits["val"], data_map, classes, configs.build_skeleton_eval_transform(ds["src_len"])),
        8, num_workers=2)
    model = hgate_from_dataset(ds, 2, generator=torch.Generator().manual_seed(0),
                               **SMALL["even"])
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


@pytest.mark.slow
@pytest.mark.parametrize("attn_impl", ["auto", "hybrid"])
def test_full_geometry_logits_match_jax(attn_impl):
    """FDMSE-ISL: 192 frames, 2002 classes, embed 128, depths (2,2,4), heads (2,4,8)."""
    ds = DATASET_PARAMS["FDMSE-ISL"]
    jm = jax_hgate(ds, 2, attn_impl=attn_impl)
    x = np.random.default_rng(0).random((2, 192, 29, 2)).astype(np.float32)
    variables = jax.tree.map(np.asarray, jax.jit(lambda k, xx: jm.init(k, xx, train=False))(
        jax.random.PRNGKey(0), x))
    want = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(variables, x))
    tm = hgate_from_dataset(ds, 2, attn_impl=attn_impl)
    tm.load_state_dict(state_dict_from_jax(variables))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL["float32"])
