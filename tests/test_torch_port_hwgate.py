"""The port's HWGATE against the JAX package's, with the same weights.

JAX initialises the model; ``weights.state_dict_from_jax`` carries the tree
into the port; eval logits of both on the same seeded clips must agree:
f32 at atol 2e-4 / rtol 1e-4 (``tests/test_hwgate_parity.py``), bf16 compute
at 0.05 / 0.05 (``tests/test_pallas_bf16.py``). The JAX model runs its
token-major stream, whose attention on the CPU is ``stacked_window_attention``.
"""

import numpy as np
import pytest
import torch

import jax

from sl_hwgat_tpu.constants import DATASET_PARAMS
from sl_hwgat_tpu.models.hwgate import hwgate_from_dataset as jax_hwgate
from sl_hwgat_tpu.train.torch_import import hwgate_from_torch

from sl_hwgat_tpu_torch.models import build_model
from sl_hwgat_tpu_torch.models.hwgate import hwgate_from_dataset
from sl_hwgat_tpu_torch.weights import state_dict_from_jax

SMALL = dict(embed_dim=32, depths=(2, 2, 2), num_heads=(1, 2, 4))
TOL = {"float32": dict(atol=2e-4, rtol=1e-4), "bfloat16": dict(atol=0.05, rtol=0.05)}
GEOMETRIES = {
    # 8 frames, 10 classes, embed 32: dh 32 at every stage
    "small": ({"num_class": 10, "src_len": 8}, SMALL),
    # SYNTH at full width: embed 128, depths (2,2,4), heads (2,4,8)
    "synth": (DATASET_PARAMS["SYNTH"], {}),
}


def _jax_model_and_variables(ds, overrides, batch, seed=0):
    model = jax_hwgate(ds, 2, stream_layout="token", **overrides)
    x = np.random.default_rng(seed).random((batch, ds["src_len"], 64, 2)).astype(np.float32)
    init = jax.jit(lambda key, xx: model.init(key, xx, train=False))
    variables = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), x))
    return variables, x


def _logits_pair(ds, overrides, compute_dtype, variables, x):
    jm = jax_hwgate(ds, 2, stream_layout="token", compute_dtype=compute_dtype, **overrides)
    want = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(variables, x))
    tm = hwgate_from_dataset(ds, 2, compute_dtype=compute_dtype, **overrides)
    tm.load_state_dict(state_dict_from_jax(variables))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    return got, want


@pytest.fixture(scope="module", params=list(GEOMETRIES))
def geometry(request):
    ds, overrides = GEOMETRIES[request.param]
    variables, x = _jax_model_and_variables(ds, overrides, batch=2)
    return ds, overrides, variables, x


def test_state_dict_round_trips_to_jax(geometry):
    _, _, variables, _ = geometry
    sd = state_dict_from_jax(variables)
    back = hwgate_from_torch({k: v.numpy() for k, v in sd.items()})
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, b)


def test_state_dict_has_reference_layout(geometry):
    ds, overrides, variables, _ = geometry
    model = hwgate_from_dataset(ds, 2, **overrides)
    sd = state_dict_from_jax(variables)
    assert set(model.state_dict()) == set(sd)
    d = model.state_dict()["layers.0.blocks.0.attn.qkv.weight"].shape[1]
    assert sd["layers.0.blocks.0.attn.qkv.weight"].shape == (3 * d, d)
    assert sd["pos_encoder.pe"].shape == (1, ds["src_len"], 1, d)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_eval_logits_match_jax(geometry, compute_dtype):
    ds, overrides, variables, x = geometry
    got, want = _logits_pair(ds, overrides, compute_dtype, variables, x)
    assert got.shape == (x.shape[0], ds["num_class"])
    np.testing.assert_allclose(got, want, **TOL[compute_dtype])


def test_build_model_cpu_is_seeded_eval_and_cuda_needs_a_card():
    a = build_model("HWGATE", {"num_class": 10, "src_len": 8}, 2, device="cpu", seed=3, **SMALL)
    b = build_model("HWGATE", {"num_class": 10, "src_len": 8}, 2, device="cpu", seed=3, **SMALL)
    assert not a.training
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model("STGCN", {"num_class": 10, "src_len": 8}, 2, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("HWGATE", {"num_class": 10, "src_len": 8}, 2, **SMALL)


def test_train_mode_prunes_through_the_same_op(monkeypatch):
    """Train mode draws one prune scalar per MSA call (here pinned at 0.01,
    below every row maximum of a fresh model's near-uniform softmax); with
    dropout 0, outputs differ from eval only through pruning."""
    model = build_model("HWGATE", {"num_class": 10, "src_len": 8}, 2, device="cpu",
                        drop_rate=0.0, **SMALL)
    x = torch.from_numpy(np.random.default_rng(1).random((2, 8, 64, 2)).astype(np.float32))
    draws = []

    def rand(*shape, device=None, **kw):
        draws.append(shape)
        return torch.full(*shape, 0.01, device=device)

    with torch.no_grad():
        ev = model(x)
        monkeypatch.setattr(torch, "rand", rand)
        tr = model.train()(x)
    assert draws == [((1,),)] * 6  # one per block
    assert torch.isfinite(tr).all() and not torch.allclose(ev, tr, atol=1e-4)


@pytest.mark.slow
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_full_geometry_logits_match_jax(compute_dtype):
    """FDMSE-ISL: 192 frames, 2002 classes, the flagship widths."""
    ds = DATASET_PARAMS["FDMSE-ISL"]
    variables, x = _jax_model_and_variables(ds, {}, batch=2)
    got, want = _logits_pair(ds, {}, compute_dtype, variables, x)
    np.testing.assert_allclose(got, want, **TOL[compute_dtype])
