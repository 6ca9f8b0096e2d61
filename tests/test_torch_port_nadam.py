"""``make_optimizer("nadam")`` against ``optax.nadam`` (the JAX package's
``-o nadam``: ``inject_hyperparams(optax.nadam)``), on the CPU.

Five steps on a small parameter set with seeded gradients, the learning rate
changed through ``set_lr`` between steps 2 and 3 (the JAX package's
``set_lr`` on its injected hyperparameter), at atol 1e-6; the state_dict
round-trips and a resumed optimizer continues bit for bit; and the update is
not ``torch.optim.NAdam``'s.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from sl_hwgat_tpu.train.state import make_optimizer as jax_make_optimizer
from sl_hwgat_tpu.train.state import set_lr as jax_set_lr

from sl_hwgat_tpu_torch.train.state import make_optimizer, set_lr

SHAPES = {"w": (4, 3), "b": (3,), "s": ()}
LR, LR2 = 5e-3, 1e-3


def _params(seed=0):
    r = np.random.default_rng(seed)
    return {k: np.asarray(r.normal(size=s), np.float32) for k, s in SHAPES.items()}


def _grads(step):
    r = np.random.default_rng(100 + step)
    return {k: np.asarray(r.normal(size=s) * 10.0 ** r.integers(-3, 2), np.float32)
            for k, s in SHAPES.items()}


def _torch_run(params, steps, start=0, state=None):
    """Steps ``start`` … ``steps`` − 1 from ``params`` (and a saved optimizer
    ``state``) → (parameters, optimizer)."""
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_optimizer("nadam", LR, ps.values())
    if state is not None:
        opt.load_state_dict(state)
    for step in range(start, steps):
        if step == 2:
            set_lr(opt, LR2)
        for k, g in _grads(step).items():
            ps[k].grad = torch.from_numpy(g)
        opt.step()
    return {k: p.detach().numpy().copy() for k, p in ps.items()}, opt


def test_nadam_matches_optax():
    params = _params()
    tx = jax_make_optimizer("nadam", LR)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for step in range(5):
        if step == 2:
            state = jax_set_lr(state, LR2)
        updates, state = tx.update({k: jnp.asarray(g) for k, g in _grads(step).items()},
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
    got, _ = _torch_run(params, 5)
    for k in SHAPES:
        np.testing.assert_allclose(got[k], np.asarray(jp[k]), atol=1e-6, rtol=0, err_msg=k)
        assert not np.allclose(got[k], params[k], atol=1e-4)


def test_nadam_is_not_torch_nadam():
    params = _params()
    got, _ = _torch_run(params, 5)
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = torch.optim.NAdam(ps.values(), lr=LR)
    for step in range(5):
        if step == 2:
            set_lr(opt, LR2)
        for k, g in _grads(step).items():
            ps[k].grad = torch.from_numpy(g)
        opt.step()
    assert not np.allclose(got["w"], ps["w"].detach().numpy(), atol=1e-6)


def test_nadam_state_dict_resumes_bit_for_bit():
    params = _params(1)
    straight, _ = _torch_run(params, 5)
    half, opt = _torch_run(params, 3)
    sd = opt.state_dict()
    assert {"step", "exp_avg", "exp_avg_sq"} <= set(sd["state"][0])
    resumed, fresh = _torch_run(half, 5, start=3, state=sd)
    assert fresh.param_groups[0]["lr"] == LR2
    for k in SHAPES:
        np.testing.assert_array_equal(resumed[k], straight[k], err_msg=k)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("lamb", LR, [torch.nn.Parameter(torch.zeros(1))])
