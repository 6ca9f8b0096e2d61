"""The model options the CLI's flags select, against the JAX models, on the CPU.

- ``remat``: with dropout and pruning on, HWGATE's and HGATE's gradients
  with ``remat=True`` equal those without it bit for bit; a plain
  ``torch.utils.checkpoint`` wrap (no generator replay) gives other
  gradients; with dropout and pruning off, the remat gradients match the JAX
  model's ``remat=True`` at atol 5e-4 (the gradient bar of
  ``tests/test_torch_port_train.py``).
- ``attn_dtype="bfloat16"`` under f32 compute (HWGATE and HGATE) and
  ``compute_dtype="bfloat16", stream_dtype="float32"`` (HWGATE): eval
  logits against the JAX model's at the bf16 model bar, atol 0.05 /
  rtol 0.05; the f32 stream is f32 between blocks.
- ``attn_impl="stacked"`` is the fused path (logits equal to "auto"'s);
  WGATE and GATE take every banded name of the JAX package, "ell" included.
"""

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import jax
import jax.numpy as jnp

from sl_hwgat_tpu.models.hgate import hgate_from_dataset as jax_hgate
from sl_hwgat_tpu.models.hwgate import hwgate_from_dataset as jax_hwgate
from sl_hwgat_tpu.train import losses as jax_losses

from sl_hwgat_tpu_torch.models import build_model, common, hgate, hwgate
from sl_hwgat_tpu_torch.train.losses import per_sample, smoothed_cross_entropy
from sl_hwgat_tpu_torch.weights import params_from_jax, state_dict_from_jax

DS = {"num_class": 10, "src_len": 8}
SIZES = {"HWGATE": dict(embed_dim=32, depths=(2, 2), num_heads=(2, 4)),
         "HGATE": dict(embed_dim=32, depths=(2, 2), num_heads=(1, 2))}
KPS = {"HWGATE": 64, "HGATE": 29}
JAX_MODELS = {"HWGATE": lambda **kw: jax_hwgate(DS, 2, stream_layout="token", **kw),
              "HGATE": lambda **kw: jax_hgate(DS, 2, **kw)}
BF16_TOL = dict(atol=0.05, rtol=0.05)


def batch(name, n=3, seed=0):
    r = np.random.default_rng(seed)
    x = r.random((n, DS["src_len"], KPS[name], 2)).astype(np.float32)
    y = r.integers(0, DS["num_class"], size=n).astype(np.int32)
    return x, y


def port_model(name, **kw):
    return build_model(name, DS, 2, device="cpu", seed=3, **SIZES[name], **kw)


def grads(model, x, y, seed=11):
    """(loss, {name: grad}) of one train-mode step drawn from ``seed``."""
    model.train()
    model.zero_grad(set_to_none=True)
    logits = model(torch.from_numpy(x), torch.Generator().manual_seed(seed))
    loss = per_sample(smoothed_cross_entropy, logits, torch.from_numpy(y).long()).mean()
    loss.backward()
    return loss.detach(), {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("name", ["HWGATE", "HGATE"])
def test_remat_gradients_equal_bit_for_bit_with_dropout_and_pruning(name):
    x, y = batch(name)
    model = port_model(name)  # drop_rate 0.1; HWGATE prunes
    want_loss, want = grads(model, x, y)
    model.remat = True
    got_loss, got = grads(model, x, y)
    assert torch.equal(got_loss, want_loss)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the step is random: another seed gives another loss
    model.remat = False
    assert not torch.equal(grads(model, x, y, seed=12)[0], want_loss)


@pytest.mark.parametrize("name", ["HWGATE", "HGATE"])
def test_a_plain_checkpoint_wrap_would_change_the_gradients(name, monkeypatch):
    """torch.utils.checkpoint restores only the default generators: without
    the replay, the recompute draws other masks from the step's generator."""
    x, y = batch(name)
    model = port_model(name)
    _, want = grads(model, x, y)

    def naive(block, inp, generator=None):
        return checkpoint(block, inp, generator, use_reentrant=False)

    module = hwgate if name == "HWGATE" else hgate
    monkeypatch.setattr(module, "remat", naive)
    model.remat = True
    _, got = grads(model, x, y)
    assert any(not torch.equal(got[k], want[k]) for k in want)


def test_remat_replays_the_generator_state():
    """The replay generator starts from the saved state: the recompute's draws
    are the first pass's."""
    g = torch.Generator().manual_seed(5)
    draws = []

    class Block(torch.nn.Module):
        def forward(self, x, generator):
            u = torch.rand(x.shape, generator=generator)
            draws.append(u)
            return x * u

    x = torch.ones(4, requires_grad=True)
    common.remat(Block(), x, g).sum().backward()
    assert len(draws) == 2 and torch.equal(draws[0], draws[1])
    assert torch.equal(x.grad, draws[0])
    # the caller's generator advanced once, as without remat
    once = torch.Generator().manual_seed(5)
    torch.rand(4, generator=once)
    assert torch.equal(g.get_state(), once.get_state())


def _jax_grads(jm, variables, x, y):
    aux = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(params):
        logits = jm.apply({**aux, "params": params}, x, train=True)
        per = jax.vmap(lambda lg, lb: jax_losses.smoothed_cross_entropy(lg[None], lb[None]))(
            logits, y)
        return jnp.mean(per)

    return jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(variables["params"]))


@pytest.mark.parametrize("name", ["HWGATE", "HGATE"])
def test_remat_gradients_match_jax_remat(name):
    det = dict(drop_rate=0.0, **({"prune_attn": False} if name == "HWGATE" else {}))
    x, y = batch(name, n=2, seed=1)  # HGATE's JAX split by group needs an even unit count
    jm = JAX_MODELS[name](remat=True, **det, **SIZES[name])
    variables = jax.tree.map(np.asarray, jax.jit(lambda k, xx: jm.init(k, xx, train=False))(
        jax.random.PRNGKey(0), x))
    want = params_from_jax(_jax_grads(jm, variables, jnp.asarray(x), jnp.asarray(y)))
    model = port_model(name, remat=True, **det)
    model.load_state_dict(state_dict_from_jax(variables))
    _, got = grads(model, x, y)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=5e-4, err_msg=k)


def _logits_against_jax(name, **kw):
    x, _ = batch(name, n=2, seed=2)
    jm = JAX_MODELS[name](**kw, **SIZES[name])
    variables = jax.tree.map(np.asarray, jax.jit(lambda k, xx: jm.init(k, xx, train=False))(
        jax.random.PRNGKey(1), x))
    want = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(variables, x),
                      np.float32)
    model = port_model(name, **kw)
    model.load_state_dict(state_dict_from_jax(variables))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).float().numpy()
    return model, got, want


@pytest.mark.parametrize("name", ["HWGATE", "HGATE"])
def test_bf16_attention_under_f32_projections_matches_jax(name):
    model, got, want = _logits_against_jax(name, attn_dtype="bfloat16")
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **BF16_TOL)
    _, f32, _ = _logits_against_jax(name)
    assert not np.array_equal(got, f32)  # the attention really ran in bf16


def test_f32_stream_under_bf16_compute_matches_jax():
    model, got, want = _logits_against_jax("HWGATE", compute_dtype="bfloat16",
                                           stream_dtype="float32")
    np.testing.assert_allclose(got, want, **BF16_TOL)
    seen = []
    block = model.layers[0].blocks[1]
    handle = block.register_forward_hook(lambda m, i, o: seen.append((i[0].dtype, o.dtype)))
    with torch.no_grad():
        model(torch.from_numpy(batch("HWGATE", n=1)[0]))
    handle.remove()
    assert seen == [(torch.float32, torch.float32)]
    _, auto, _ = _logits_against_jax("HWGATE", compute_dtype="bfloat16")
    assert not np.array_equal(got, auto)


@pytest.mark.parametrize("stream, dtype", [("auto", torch.bfloat16), ("bfloat16", torch.bfloat16),
                                           ("float32", torch.float32)])
def test_stream_dtype_sets_the_stream(stream, dtype):
    model = port_model("HWGATE", compute_dtype="bfloat16", stream_dtype=stream)
    seen = []
    handle = model.layers[1].blocks[0].register_forward_hook(lambda m, i, o: seen.append(o.dtype))
    with torch.no_grad():
        model(torch.from_numpy(batch("HWGATE", n=1)[0]))
    handle.remove()
    assert seen == [dtype]


@pytest.mark.parametrize("name", ["HWGATE", "HGATE"])
def test_stacked_is_the_fused_path(name):
    x = torch.from_numpy(batch(name, n=2)[0])
    with torch.no_grad():
        auto = port_model(name).eval()(x)
        stacked = port_model(name, attn_impl="stacked").eval()(x)
    assert torch.equal(auto, stacked)
    with pytest.raises(ValueError, match="the port runs"):
        port_model(name, attn_impl="banded")


@pytest.mark.parametrize("name", ["WGATE", "GATE"])
def test_banded_models_take_the_jax_attn_impl_names(name):
    size = dict(embed_dim=16, depths=1, num_heads=1)
    kps = 64 if name == "WGATE" else 29
    x = torch.from_numpy(np.random.default_rng(4).random((1, 8, kps, 2)).astype(np.float32))
    outs = []
    for impl in ("auto", "banded", "compact", "pallas_banded", "pallas_packed"):
        with torch.no_grad():
            outs.append(build_model(name, DS, 2, device="cpu", seed=0, attn_impl=impl,
                                    **size).eval()(x))
    assert all(torch.equal(o, outs[0]) for o in outs)
    # "ell" builds too (the edge-space form: the same function, other sums)
    with torch.no_grad():
        ell = build_model(name, DS, 2, device="cpu", seed=0, attn_impl="ell", **size).eval()(x)
    torch.testing.assert_close(ell, outs[0], atol=2e-4, rtol=1e-4)
