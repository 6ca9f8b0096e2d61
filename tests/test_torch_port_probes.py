"""The port's kernel bench against the JAX package's, on the CPU.

Each case runs one ``bench_kernel.py`` probe of the JAX package as it is
(``run_jax_probe``: 256 units, a TPU block of 8 tiles, Pallas in interpret
mode, the timing loop cut to one call) and the port's entry of the same name
(``sl_hwgat_tpu_torch/bench/kernel.py``) through the plain versions of its
kernels. The port's chained input equals the JAX one bit for bit (the same
draws through the port's layout maps), and its output matches:

- stream probes (copies, the three-stream sum) and relayouts
  (``test_torch_port_probes_relayout.py``): bit for bit;
- the group-sum floors: one bf16 ulp (2⁻⁷·|x|): the f32 sums of 8192 or more
  terms run in another order, which can move the product across a rounding
  boundary;
- tile products and K10: 1e-5·max|O| in f32, 4e-3·max|O| in bf16 (S is
  rounded to bf16 between the products; another summation order can flip
  one rounding);
- ``softmax_only``: 1e-5.

This file also holds the port's layout maps against the JAX helpers they
mirror, the cost arithmetic of ``utils/profiling.py``, K10
against ``pallas_packed_banded_attention`` under ``PALLAS_BANDED_PACKED_MM=1``
at GATE's 29 and WGATE's 16 joints, and the bench's plumbing.
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

from sl_hwgat_tpu.graphs.adjacency import windowed_block_adj as jax_windowed_block_adj
from sl_hwgat_tpu.ops.pallas_attention import _pack_t, _unpack_t
from sl_hwgat_tpu.ops.pallas_banded import (
    _pack_plane,
    _unpack_plane,
    pallas_packed_banded_attention,
)
from sl_hwgat_tpu.utils import profiling as jax_profiling

from sl_hwgat_tpu_torch.bench import kernel as port_bench
from sl_hwgat_tpu_torch.graphs.adjacency import additive_mask
from sl_hwgat_tpu_torch.ops import layouts, probes
from sl_hwgat_tpu_torch.ops.banded_attention import banded_packed_mm, plain_banded_packed_mm
from sl_hwgat_tpu_torch.utils import profiling

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNITS, TG = 256, 8
ULP_BF16 = 2.0**-7  # one bf16 ulp, relative


def run_jax_probe(impl: str, monkeypatch, env=()) -> tuple[np.ndarray, np.ndarray, str]:
    """(x0, loop(x0), the output's dtype name) of ``bench_kernel.py``'s
    ``impl``, as float32 arrays: ``main()`` as it is, at 256 units and
    ``PALLAS_ATTN_TG=8``, with ``jax.lax.fori_loop`` cut to one iteration and
    ``_timed_repeats`` keeping x0 and loop(x0) instead of timing them
    (``BENCH_CPU=1`` keeps JAX on the CPU, ``BENCH_NO_CACHE=1`` writes no
    compile cache)."""
    import bench_kernel

    for name, value in (("BENCH_CPU", "1"), ("BENCH_NO_CACHE", "1"), ("BENCH_REPEATS", "1"),
                        ("PALLAS_ATTN_TG", str(TG)), *env):
        monkeypatch.setenv(name, value)
    for name in ("PALLAS_ATTN_NOMAX", "PALLAS_ATTN_BUFS", "PALLAS_ATTN_BATCHED",
                 "PALLAS_BANDED_PACKED_MM"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(jax.lax, "fori_loop", lambda lo, hi, body, init: body(lo, init))
    captured = {}

    def keep(loop, x0, inner, outer, force, repeats=None):
        y = loop(x0)
        captured.update(x0=np.asarray(jnp.asarray(x0, jnp.float32)),
                        y=np.asarray(jnp.asarray(y, jnp.float32)), dtype=str(y.dtype))
        return [1.0]

    monkeypatch.setattr(bench_kernel, "_timed_repeats", keep)
    monkeypatch.setattr(sys, "argv", ["bench_kernel.py", impl, str(UNITS)])
    bench_kernel.main()
    return captured["x0"], captured["y"], captured["dtype"]


def port_probe(impl: str, x0: np.ndarray):
    """The port's (state, output) of ``impl`` on the CPU; the state must
    equal the JAX chained input bit for bit."""
    p = port_bench.inputs(impl, UNITS, device="cpu", tg=TG)
    np.testing.assert_array_equal(p.state.float().numpy().reshape(x0.shape), x0)
    with torch.no_grad():
        out = p.body(p.state)
    return p, out


def check_probe(impl: str, monkeypatch, bar: str) -> float:
    """Hold the port's ``impl`` against the JAX probe at ``bar``: "exact",
    "ulp" (one bf16 ulp), "tile" (1e-5 / 4e-3 × max|O|), or an absolute
    float. Returns the max abs error."""
    x0, want, want_dtype = run_jax_probe(impl, monkeypatch)
    _, out = port_probe(impl, x0)
    assert str(out.dtype).split(".")[1] == want_dtype
    got = out.float().numpy().reshape(want.shape)
    err = float(np.abs(got - want).max())
    if bar == "exact":
        np.testing.assert_array_equal(got, want)
    elif bar == "ulp":
        np.testing.assert_allclose(got, want, rtol=ULP_BF16, atol=0)
    elif bar == "tile":
        scale = 4e-3 if out.dtype == torch.bfloat16 or "bf16" in impl else 1e-5
        assert err <= scale * float(np.abs(want).max()), (err, np.abs(want).max())
    else:
        assert err <= bar, err
    return err


STREAM = ["floor_copy", "floor_copy_bf16", "floor_purecopy_bf16", "floor_slab_bf16",
          "floor_pureslab", "tlay_copy_bf16", "dmaflr_hbm", "dmaflr_3stream", "dmaflr_qkvpack"]
FLOORS = ["mix_floor", "tmx_floor", "tmq_floor", "tsw_floor"]


@pytest.mark.parametrize("impl", STREAM)
def test_stream_probes_match_jax(impl, monkeypatch):
    check_probe(impl, monkeypatch, "exact")


@pytest.mark.parametrize("impl", FLOORS)
def test_group_sum_floors_match_jax(impl, monkeypatch):
    check_probe(impl, monkeypatch, "ulp")


# --- the port's copies of the JAX helpers ----------------------------------


@pytest.mark.parametrize("units, n, stack", [(8, 32, 4), (8, 32, 2), (12, 16, 4), (6, 58, 2),
                                             (4, 32, 1)])
def test_supertile_maps_equal_jax_pack_t(units, n, stack):
    """``units_to_t``/``t_to_units`` are ``_pack_t``/``_unpack_t`` on
    token-major units (the JAX helpers take (U, dh, N))."""
    x = np.random.default_rng(3).normal(size=(units, n, 16)).astype(np.float32)
    got = layouts.units_to_t(torch.from_numpy(x), stack)
    want, t, sn, np_ = _pack_t(jnp.asarray(x).swapaxes(1, 2), n, None, stack)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (t, 16, sn) and np_ == n
    back = layouts.t_to_units(got, stack)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(_unpack_t(want, units, n, np_, stack, 16)).swapaxes(1, 2))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("joints, vp", [(29, 32), (16, 16)])
def test_pack_plane_equals_jax(joints, vp):
    x = np.random.default_rng(4).normal(size=(2, 3, 8, joints, 16)).astype(np.float32)
    got = layouts.pack_plane(torch.from_numpy(x), vp)
    want = _pack_plane(jnp.asarray(x), vp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = layouts.unpack_plane(got, 2, 3, 8, joints, 16, vp)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(_unpack_plane(want, 2, 3, 8, joints, 16, vp)))


def test_layout_maps_invert_and_match_the_probes():
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(64, 32, 64)).astype(np.float32))
    tiles = x.reshape(16, 128, 64)
    np.testing.assert_array_equal(layouts.units_to_t(x, 4).numpy(),
                                  np.asarray(_pack_t(jnp.asarray(x.numpy()).swapaxes(1, 2),
                                                     32, None, 4)[0]))
    assert torch.equal(layouts.t_to_units(layouts.units_to_t(x, 4), 4), x)
    wide = layouts.widen(tiles, 8)
    want = np.swapaxes(tiles.numpy().reshape(8, 2, 128, 64), 2, 3).reshape(
        8, 2, 64, 128).transpose(0, 2, 1, 3).reshape(8, 64, 256)  # bench_kernel.py:941
    np.testing.assert_array_equal(wide.numpy(), want)
    assert torch.equal(layouts.unwiden(wide, 128), tiles)
    pairs = layouts.pack2(tiles)
    np.testing.assert_array_equal(pairs.numpy(), np.swapaxes(
        tiles.numpy().reshape(8, 2, 128, 64), 1, 2).reshape(8, 128, 128))  # :1003
    assert torch.equal(layouts.unpack2(pairs), tiles)
    for name in layouts.STREAM_SETS:
        streams = layouts.stream_set(name, x, x * 2, x * 3)
        for back, want in zip(layouts.stream_set_to_units(name, *streams), (x, x * 2, x * 3)):
            assert torch.equal(back, want)


# --- cost arithmetic --------------------------------------------------------


def test_profiling_costs_equal_jax():
    assert profiling.window_attention_cost(12288, 32, 64, 164) == \
        profiling.AttentionCost(**vars(jax_profiling.window_attention_cost(12288, 32, 64, 164)))
    assert profiling.hwgate_forward_cost(16) == jax_profiling.hwgate_forward_cost(16)
    for compact in (True, False):
        assert vars(profiling.banded_attention_cost(16, 8, 192, 29, 16, 2, compact)) == \
            vars(jax_profiling.banded_attention_cost(16, 8, 192, 29, 16, 2, compact))


def test_bound_on_the_h100():
    seconds, by = profiling.bound(100.66e6, 0.0, "bfloat16")  # a bf16 copy at the bench shape
    assert by == "bytes" and seconds == pytest.approx(30.05e-6, rel=1e-3)
    seconds, by = profiling.bound(25.2e6, 12.9e9, "float32")  # matmul_only, f32
    assert by == "operations" and seconds == pytest.approx(192.5e-6, rel=1e-3)
    seconds, by = profiling.bound(151e6, 12.9e9, "bfloat16")
    assert by == "bytes" and seconds == pytest.approx(45.07e-6, rel=1e-3)


# --- K10 --------------------------------------------------------------------


def _identity_band(v):
    eye = np.eye(v, dtype=np.float32)
    return np.stack([additive_mask(eye)] * 3)


@pytest.mark.parametrize("joints, frames", [(29, 16), (16, 24)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k10_matches_jax_packed_mm(joints, frames, dtype, monkeypatch):
    monkeypatch.setenv("PALLAS_BANDED_PACKED_MM", "1")
    r = np.random.default_rng(6)
    q, k, v = (r.normal(size=(1, 2, frames, joints, 16)).astype(np.float32) for _ in range(3))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = pallas_packed_banded_attention(*(jnp.asarray(x).astype(jdt) for x in (q, k, v)),
                                          _identity_band(joints), scale=0.25, out_dtype=jdt)
    tdt = getattr(torch, dtype)
    planes = [torch.from_numpy(x.reshape(2, frames * joints, 16)).to(tdt) for x in (q, k, v)]
    got = banded_packed_mm(*planes, joints=joints, out_dtype=tdt)
    assert torch.equal(got, plain_banded_packed_mm(*planes, joints=joints, out_dtype=tdt))
    want = np.asarray(jnp.asarray(want, jnp.float32)).reshape(2, frames * joints, 16)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= (4e-3 if dtype == "bfloat16" else 1e-5) * np.abs(want).max(), err


def test_k10_takes_whole_tiles_only():
    x = torch.zeros(2, 29 * 6, 16)
    with pytest.raises(ValueError, match="whole tiles"):
        banded_packed_mm(x, x, x, joints=29)
    assert banded_packed_mm(x[:, :116], x[:, :116], x[:, :116], joints=29).shape == (2, 116, 16)


# --- wrappers ---------------------------------------------------------------


def test_probe_wrappers_reject_what_the_kernels_cannot_run():
    x = torch.zeros(2, 3, 128, 64)
    with pytest.raises(ValueError, match="one \\(planes, tiles, rows, depth\\) shape"):
        probes.tile_matmul(x, x[:, :2])
    with pytest.raises(ValueError, match="cols names"):
        probes.tile_matmul(x, x)
    with pytest.raises(ValueError, match="perm"):
        probes.relayout(x, (0, 1, 1, 2))
    with pytest.raises(ValueError, match="group_cols"):
        probes.stream_floor(x, x, view=(2, 3, 8192), group_cols=100)
    with pytest.raises(ValueError, match="share one shape"):
        probes.stream_sum3(x, x, x[:1])
    with pytest.raises(ValueError, match="cuda or cpu"):
        probes.relayout(x.to("meta"), (0, 1, 3, 2))


def test_plain_tile_matmul_modes():
    r = np.random.default_rng(8)
    x = torch.from_numpy(r.normal(size=(1, 2, 16, 8)).astype(np.float32))
    z = torch.from_numpy(r.normal(size=(1, 2, 16, 4)).astype(np.float32))
    s = torch.einsum("ptmk,ptnk->ptmn", x, x)
    assert torch.allclose(probes.tile_matmul(x, x, cols=4), s[..., :4])
    assert torch.allclose(probes.tile_matmul(x, x, z), s @ z, atol=1e-5)
    out = torch.empty(1, 2, 4, 16).transpose(2, 3)
    assert probes.tile_matmul(x, x, z, out=out) is out
    assert torch.allclose(out, s @ z, atol=1e-5)


# --- the bench's plumbing ---------------------------------------------------


def test_measure_on_the_cpu_gives_the_line_keys():
    rec = port_bench.measure("tmq_floor", UNITS, device="cpu", tg=TG, repeats=2)
    for key in ("impl", "time_us", "time_us_min", "time_us_max", "n_repeats", "spread_pct",
                "bound_us", "bound_by", "launches", "device"):
        assert key in rec
    assert rec["device"] == {"platform": "cpu"} and rec["clock"] == "host"
    # q, k, v read once and o written once, bf16: 4 · 256 · 32 · 64 · 2 bytes
    assert rec["bytes"] == 4 * UNITS * 32 * 64 * 2 and rec["bound_by"] == "bytes"
    rec = port_bench.measure("pallas", UNITS, device="cpu", repeats=1)
    assert rec["edges"] == UNITS * int((jax_windowed_block_adj(2)[0] != 0).sum())


def test_every_impl_has_an_entry_and_ell_raises():
    assert len(set(port_bench.IMPLS)) == len(port_bench.IMPLS)
    for impl in ("ell", "ell_bwd_bf16"):
        with pytest.raises(NotImplementedError, match="queue 1 item 5"):
            port_bench.inputs(impl, UNITS)
    with pytest.raises(ValueError, match="unknown impl"):
        port_bench.inputs("pallas_nonesuch", UNITS)


def test_draws_are_bench_kernels():
    d = port_bench.draws("xrelay_s2pallas_bf16", UNITS)
    r = np.random.default_rng(0)
    for name in "qkv":
        np.testing.assert_array_equal(d[name], r.normal(size=(UNITS, 32, 64)).astype(np.float32))
    np.testing.assert_array_equal(d["x0"], r.normal(size=(1536, 32, 8, 64)).astype(np.float32))


def _python_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO_ROOT
    return env


def test_cli_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "-m", "sl_hwgat_tpu_torch.bench.kernel", "pallas",
                          "64"], cwd=REPO_ROOT, env=_python_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    out = subprocess.run([sys.executable, "-m", "sl_hwgat_tpu_torch.bench.run", "--device",
                          "cpu", "--units", "64"], cwd=REPO_ROOT, env=_python_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metric"] == "fused_window_attention_edges_per_sec"
    assert line["unit"] == "edges/s" and line["value"] > 0 and line["vs_baseline"] > 0
