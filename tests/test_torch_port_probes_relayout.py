"""The kernel bench's relayout probes against the JAX package's, on the CPU
(see ``test_torch_port_probes.py``), bit for bit: the (g, n, h, dh) →
(g, h, n, dh) round trips of ``xrelay_*`` and the (g, n, h, dh) →
(h·g, n, dh) gathers of ``xstrided_*``, and ``xstrided_ref``'s copy of the
flat tensor. Their sizes are fixed (6144 × 32 × 2 × 64 or
1536 × 32 × 8 × 64), whatever the units.
"""

import pytest

from test_torch_port_probes import check_probe

RELAYOUT = ["xrelay_s0pallas_bf16", "xrelay_s2pallas_f32", "xrelay_s0_bf16", "xrelay_s2",
            "xstrided_s0_bf16", "xstrided_s2_bf16", "xstrided_ref_bf16"]


@pytest.mark.parametrize("impl", RELAYOUT)
def test_relayout_probes_match_jax(impl, monkeypatch):
    check_probe(impl, monkeypatch, "exact")
