"""The port's Transformer baseline against the JAX package's, on the CPU.

``DS = {"num_class": 7, "src_len": 16}``, 29 joints × 2, the full widths
(d_model 512, 8 heads, ff 2048, 3 layers). The JAX model initialises the
weights and ``weights.state_dict_from_jax`` carries them (and the ``pe``
buffer) into the port. Clips with padded frames (every value ``pad_index``
−1) exercise the key-padding mask.

- eval logits at atol 2e-4 / rtol 1e-4 in f32; bf16 compute against the JAX
  bf16 model at 0.05 / 0.05 and against the port's f32 at the JAX package's
  bar (``tests/test_transformer_parity.py:40``: 0.15 of the largest logit);
- the port's ``state_dict`` through the JAX ``transformer_from_torch``;
- 3 AdamW steps against the JAX ``make_steps`` (dropout 0): losses at
  2e-4 / 1e-4 in float32; losses and parameters at 2e-4 / 1e-4 with both
  sides in float64 (in float32 AdamW's first steps move a weight whose
  gradient is near zero by ±lr on rounding noise: 207 of layer 0's 786432
  in_proj weights), but for the key biases, whose gradient is zero in exact
  arithmetic: they stay within 3·lr of their start on both sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sl_hwgat_tpu.models import build_model as jax_build_model
from sl_hwgat_tpu.train.loop import make_steps as jax_make_steps
from sl_hwgat_tpu.train.state import make_optimizer as jax_make_optimizer
from sl_hwgat_tpu.train.torch_import import transformer_from_torch

from sl_hwgat_tpu_torch.models import build_model
from sl_hwgat_tpu_torch.train.loop import make_steps
from sl_hwgat_tpu_torch.train.state import make_optimizer
from sl_hwgat_tpu_torch.weights import state_dict_from_jax

DS = {"num_class": 7, "src_len": 16}
TOL = {"float32": dict(atol=2e-4, rtol=1e-4), "bfloat16": dict(atol=0.05, rtol=0.05)}
LR = 5e-4


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """The tier-1 run puts six test workers on the machine's cores: torch
    runs these tests on two threads, so that the workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def padded_clips(batch, seed, pad_from=(None, 10, 4)):
    """Seeded clips of keypoint coordinates in [0, 1) (what the transforms
    give); clip i's frames from ``pad_from[i]`` on are padding."""
    x = np.random.default_rng(seed).random((batch, DS["src_len"], 29, 2)).astype(np.float32)
    for i, start in enumerate(pad_from[:batch]):
        if start is not None:
            x[i, start:] = -1.0
    return x


@pytest.fixture(scope="module")
def jax_variables():
    jm = jax_build_model("Transformer", DS, 2)
    init = jax.jit(lambda key, xx: jm.init(key, xx, train=False))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), padded_clips(1, 0)))


@pytest.fixture(scope="module")
def jax_apply():
    """The JAX model's jitted eval forward, per compute dtype."""
    return {cdt: jax.jit(lambda v, xx, m=jax_build_model("Transformer", DS, 2, compute_dtype=cdt):
                         m.apply(v, xx, train=False))
            for cdt in ("float32", "bfloat16")}


def port_model(variables, **overrides):
    model = build_model("Transformer", DS, 2, device="cpu", **overrides)
    model.load_state_dict(state_dict_from_jax(variables))
    return model


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_eval_logits_match_jax(jax_variables, jax_apply, compute_dtype):
    x = padded_clips(3, 1)
    want = np.asarray(jax_apply[compute_dtype](jax_variables, x))
    model = port_model(jax_variables, compute_dtype=compute_dtype)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (3, DS["num_class"]) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL[compute_dtype])
    if compute_dtype == "bfloat16":
        with torch.no_grad():
            f32 = port_model(jax_variables)(torch.from_numpy(x)).numpy()
        assert np.max(np.abs(got - f32)) < 0.15 * (np.max(np.abs(f32)) + 1e-3)


def test_key_padding_mask_hides_padded_frames(jax_variables, jax_apply):
    """A padded frame's content does not reach another frame: with mean
    pooling it enters the logits only through its own position, so changing
    the padded frames' other coordinates (the mask reads coordinate 0 of
    the first joint) moves the logits as the JAX model's move."""
    x = padded_clips(3, 3, pad_from=(None, 8, None))
    y = x.copy()
    y[1, 8:, 1:] = 5.0  # still padding: x[:, :, 0] == -1 decides the mask
    apply = jax_apply["float32"]
    model = port_model(jax_variables)
    with torch.no_grad():
        got = [model(torch.from_numpy(c)).numpy() for c in (x, y)]
    want = [np.asarray(apply(jax_variables, c)) for c in (x, y)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL["float32"])
    np.testing.assert_array_equal(got[0][0], got[1][0])


def test_jax_importer_reads_the_port_state_dict(jax_apply):
    model = build_model("Transformer", DS, 2, device="cpu", seed=6)
    x = padded_clips(3, 2)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    variables = transformer_from_torch({k: v.numpy() for k, v in model.state_dict().items()})
    want = np.asarray(jax_apply["float32"](jax.tree.map(jnp.asarray, variables), x))
    np.testing.assert_allclose(got, want, **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_train_steps_match_jax(jax_variables, dtype):
    jm = jax_build_model("Transformer", DS, 2, dropout=0.0)
    jopt = jax_make_optimizer("adamw", LR)
    model = port_model(jax_variables, dropout=0.0).to(getattr(torch, dtype))
    tstep, _ = make_steps(model, make_optimizer("adamw", LR, model.parameters()))
    r = np.random.default_rng(7)
    with jax.enable_x64(dtype == "float64"):
        variables = jax.tree.map(lambda a: jnp.asarray(a, dtype), jax_variables)
        opt_state = jopt.init(variables["params"])
        jstep, _ = jax_make_steps(jm, jopt, donate=False)
        for step in range(3):
            x = padded_clips(3, 10 + step).astype(dtype)
            y = r.integers(0, DS["num_class"], size=3).astype(np.int32)
            valid = np.array([1, 1, 0], np.float32)
            variables, opt_state, jloss, _, _ = jstep(variables, opt_state, x, y, valid,
                                                      jax.random.PRNGKey(0), 0, step)
            loss, _, _ = tstep(torch.from_numpy(x), torch.from_numpy(y).long(),
                               torch.from_numpy(valid), 0, 0, step)
            np.testing.assert_allclose(float(loss), float(jloss), **TOL["float32"])
        want = state_dict_from_jax(jax.tree.map(np.asarray, variables))
    if dtype == "float32":
        return
    got = model.state_dict()
    start = state_dict_from_jax(jax_variables)
    assert got.keys() == want.keys()
    d = 512
    for k in got:
        g, w = got[k].numpy(), want[k].numpy()
        if k.endswith("self_attn.in_proj_bias"):
            # the key bias adds q·b_k to every score of a row, which the
            # softmax cancels: its gradient is zero in exact arithmetic, so
            # AdamW moves it by rounding noise (up to lr a step) on each side
            s = start[k].numpy()
            for moved in (g, w):
                assert np.all(np.abs(moved[d:2 * d] - s[d:2 * d]) <= 3 * LR * 1.001), k
            g, w = np.delete(g, np.s_[d:2 * d]), np.delete(w, np.s_[d:2 * d])
        np.testing.assert_allclose(g, w, **TOL["float32"], err_msg=k)
