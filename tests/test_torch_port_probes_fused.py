"""The kernel bench's fused probes and the ``pallas*``/``hybrid*`` entries
against the JAX package's, on the CPU (see ``test_torch_port_probes.py``).

Each fused probe's TPU layout goes through the port's relayouts into
token-major units, the window-attention kernel's plain version (single
mask, zero quirk, no prune) and back. Bars: f32 1e-5 (the bar of
``test_torch_port_attention.py::test_forward_twins_match_port``); bf16
inputs one bf16 step of a probability times the largest |v|, 2⁻⁸·max|v|,
plus one bf16 ulp of |x|: the probabilities are rounded to bf16 before the
second product and a bf16 output once more, a summation order that differs
from the TPU kernel's can flip either rounding, and the bench's v is
unit-scale (max|v| about 4.5 at 256 units). Gradients of the ``*bwd*`` entries: f32 2e-5, the bar of
``test_torch_port_backward.py``; bf16 two bf16 ulps of the largest entry,
2⁻⁶·max|x|: dO and dS are rounded to bf16 before their products and the
gradient once more, and at the bench's unit-scale inputs one flip moves an
entry by up to one ulp of the largest terms (measured: 0.45% of max|x|,
0.89% for ``pallas_widebwd_bf16``'s o + dq).
"""

import numpy as np
import pytest

from test_torch_port_probes import ULP_BF16, UNITS, port_probe, run_jax_probe

from sl_hwgat_tpu_torch.bench import kernel as port_bench

FUSED = ["tlay_fused", "tlay_fused_bf16", "mix_fused", "tmx_fused", "tmq_fused", "tmq_bfused",
         "tsw_fused", "tsw_bstack", "tsw_1_fused", "lp_fused_bf16"]
WINDOW = ["pallas", "pallas_dual", "pallas_bf16", "pallas_obf16", "pallas_tbf16",
          "pallas_tdual_bf16", "pallas_tpre_bf16", "pallas_tspre_bf16", "pallas_widepre_bf16",
          "hybrid", "hybrid_bf16"]
GRADS = ["pallas_bwd", "pallas_bwd_bf16", "pallas_bwd_obf16", "pallas_tbwd_bf16",
         "pallas_tsbwd_bf16", "pallas_widebwd_bf16", "hybrid_bwd", "hybrid_bwd_bf16"]


def _compare(impl, monkeypatch):
    x0, want, want_dtype = run_jax_probe(impl, monkeypatch)
    _, out = port_probe(impl, x0)
    assert str(out.dtype).split(".")[1] == want_dtype
    return out.float().numpy().reshape(want.shape), want, want_dtype


@pytest.mark.parametrize("impl", FUSED + WINDOW)
def test_fused_probes_match_jax(impl, monkeypatch):
    got, want, _ = _compare(impl, monkeypatch)
    if "bf16" in impl or impl.startswith(("mix_", "tmx_", "tmq_", "tsw_")):  # bf16 inputs
        vmax = max(np.abs(x).max() for x in port_bench.draws(impl, UNITS).values())
        np.testing.assert_allclose(got, want, atol=2.0**-8 * vmax, rtol=ULP_BF16)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("impl", GRADS)
def test_gradient_entries_match_jax(impl, monkeypatch):
    got, want, _ = _compare(impl, monkeypatch)
    if "bf16" in impl:
        np.testing.assert_allclose(got, want, atol=2.0**-6 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, atol=2e-5)
