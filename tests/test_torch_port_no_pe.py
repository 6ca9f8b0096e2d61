"""``pe=False`` on HWGATE, HGATE, WGATE and GATE against the JAX models'
option of the same name: the model has no positional encoding (no
``pos_encoder`` buffer and no dropout after it), ``weights.state_dict_from_jax``
carries the JAX variables, which hold no ``pos_encoder`` buffer, and the
eval logits match at 2e-4 / 1e-4 (f32); the logits differ from the same
weights' with the PE.
"""

import numpy as np
import pytest
import torch

import jax

from sl_hwgat_tpu.models import build_model as jax_build_model

from sl_hwgat_tpu_torch.models import MODEL_NUM_KPS, build_model
from sl_hwgat_tpu_torch.weights import state_dict_from_jax

DS = {"num_class": 10, "src_len": 16}
SMALL = {"HWGATE": dict(embed_dim=32, depths=(2, 2), num_heads=(2, 4)),
         "HGATE": dict(embed_dim=32, depths=(2, 2), num_heads=(2, 4)),
         "WGATE": dict(embed_dim=32, depths=2, num_heads=2),
         "GATE": dict(embed_dim=32, depths=2, num_heads=2)}
TOL = dict(atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_models_without_pe_match_jax(name):
    x = np.random.default_rng(0).random((2, DS["src_len"], MODEL_NUM_KPS[name], 2)).astype(
        np.float32)
    jm = jax_build_model(name, DS, 2, pe=False, **SMALL[name])
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda key, xx: jm.init(key, xx, train=False))(jax.random.PRNGKey(0), x))
    assert "pos_encoder" not in variables["buffers"]
    want = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(variables, x))
    sd = state_dict_from_jax(variables)
    model = build_model(name, DS, 2, device="cpu", pe=False, **SMALL[name])
    assert model.pos_encoder is None and "pos_encoder.pe" not in model.state_dict()
    model.load_state_dict(sd)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # the same weights with the positional encoding give other logits
    with_pe = build_model(name, DS, 2, device="cpu", **SMALL[name])
    with_pe.load_state_dict(sd, strict=False)
    with torch.no_grad():
        assert not np.allclose(with_pe(torch.from_numpy(x)).numpy(), got, **TOL)
    # train mode without the PE draws no dropout mask before the first block
    model.train()
    assert torch.isfinite(model(torch.from_numpy(x), torch.Generator().manual_seed(0))).all()
