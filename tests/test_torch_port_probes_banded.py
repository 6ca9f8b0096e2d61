"""The kernel bench's ``banded_*`` entries against the JAX package's, on
the CPU (see ``test_torch_port_probes.py``), at the bench's fixed GATE shape
(16 clips, 8 heads, 192 frames, 29 joints, dh 16), through the plain
version of the banded kernels. Bars: 2e-5 forward and 3e-5 for the
gradient (f32; the bars of ``test_torch_port_banded.py``), 4e-3 + 1e-2·|x|
(bf16 inputs). ``banded_packedpre*`` compares the real joints only: the JAX
planes carry values at the padded joints 29-31 that no caller reads, the
port's zeros.
"""

import numpy as np
import pytest

from test_torch_port_probes import port_probe, run_jax_probe

BANDED = ["banded_xla", "banded_packed_bf16", "banded_xla_bwd", "banded_packedpre_bf16"]


@pytest.mark.parametrize("impl", BANDED)
def test_banded_entries_match_jax(impl, monkeypatch):
    x0, want, want_dtype = run_jax_probe(impl, monkeypatch)
    if "packedpre" in impl:  # (G·H, dh, F·Vp) planes: keep the 29 real joints of 32
        real = (np.arange(want.shape[2]) % 32) < 29
    _, out = port_probe(impl, x0)
    assert str(out.dtype).split(".")[1] == want_dtype
    got = out.float().numpy().reshape(want.shape)
    if "packedpre" in impl:
        got, want = got[:, :, real], want[:, :, real]
    if "bf16" in impl:
        np.testing.assert_allclose(got, want, atol=4e-3, rtol=1e-2)
    else:
        np.testing.assert_allclose(got, want, atol=3e-5 if "bwd" in impl else 2e-5)
