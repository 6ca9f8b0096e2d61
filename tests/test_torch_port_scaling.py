"""The port's scaling bench (``sl_hwgat_tpu_torch/bench/scaling.py``)
against ``bench_scaling.py``, on 2 gloo CPU ranks at a few units.

- ``measure(2)`` (8 units a rank) and ``measure_banded(2)`` (4 frames a
  rank), one warm and one timed pass: each record's keys are a superset of
  the JAX script's at the same scale, its edge count is the JAX script's,
  and the ranks' last outputs, put together, are JAX's
  ``pallas_window_attention`` (interpret mode) and
  ``banded_frame_attention`` applied as often to the ranks' inputs joined
  (1e-5);
- ``efficiency_lines`` leave out the points that shared a card, and the
  command line prints the JAX script's lines.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench_scaling
from sl_hwgat_tpu import graphs as jax_graphs
from sl_hwgat_tpu.ops.attention import banded_frame_attention
from sl_hwgat_tpu.ops.pallas_attention import pallas_window_attention

from sl_hwgat_tpu_torch.bench import scaling

UNITS, FRAMES = 8, 4
RUNS = dict(inner=1, outer=1)  # two applications: the warm pass and the timed one


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    window_dir = tmp_path_factory.mktemp("scaling_window")
    banded_dir = tmp_path_factory.mktemp("scaling_banded")
    window = scaling.measure(2, units_per_shard=UNITS, device="cpu", out_dir=str(window_dir),
                             **RUNS)
    banded = scaling.measure_banded(2, frames_per_shard=FRAMES, device="cpu",
                                    out_dir=str(banded_dir), **RUNS)
    return window, banded, window_dir, banded_dir


def test_window_record_is_the_jax_scripts_and_its_outputs_are_k1s(records):
    window, _, out_dir, _ = records
    want = bench_scaling.measure(1, units_per_shard=2 * UNITS, **RUNS)
    assert set(want) <= set(window)
    assert {"device_us", "backend", "shared_card", "device"} <= set(window)
    assert (window["n_shards"], window["units"], window["backend"]) == (2, 2 * UNITS, "gloo")
    assert window["device_us"] is None and window["shared_card"] is False
    nnz = int((jax_graphs.windowed_block_adj(2)[0] != 0).sum())
    assert nnz == 164
    np.testing.assert_allclose(window["edges_per_sec"] * window["time_us"] / 1e6,
                               2 * UNITS * nnz, rtol=1e-9)
    np.testing.assert_allclose(want["edges_per_sec"] * want["time_us"] / 1e6,
                               2 * UNITS * nnz, rtol=1e-9)
    q, k, v = (torch.cat(ts).numpy() for ts in zip(*(scaling.window_inputs(UNITS, r)
                                                     for r in range(2))))
    adj = jax_graphs.windowed_block_adj(2)[0]
    y = jnp.asarray(q)
    for _ in range(2):
        y = pallas_window_attention(y, jnp.asarray(k), jnp.asarray(v), adj, scale=0.125,
                                    stack=4)
    got = torch.cat([torch.load(out_dir / f"0.{r}")["out"] for r in range(2)])
    np.testing.assert_allclose(got.numpy(), np.asarray(y), atol=1e-5, rtol=0)


def test_banded_record_is_the_jax_scripts_and_its_outputs_are_the_halo_op(records):
    _, banded, _, out_dir = records
    want = bench_scaling.measure_banded(1, frames_per_shard=2 * FRAMES, **RUNS)
    assert set(want) <= set(banded)
    assert (banded["op"], banded["frames"]) == (want["op"], want["frames"]) == (
        "banded_halo", 2 * FRAMES)
    edges = 16 * 8 * 2 * FRAMES * 29 * 3 * 29
    for rec in (banded, want):
        np.testing.assert_allclose(rec["edges_per_sec"] * rec["time_us"] / 1e6, edges,
                                   rtol=1e-9)
    b = scaling.BANDED
    shape = (b["batch"], b["heads"], 2 * FRAMES, b["joints"], b["head_dim"])
    q, k, v = (torch.cat(ts, 1).reshape(shape).numpy()
               for ts in zip(*(scaling.banded_inputs(FRAMES, r) for r in range(2))))
    y = jnp.asarray(q)
    for _ in range(2):
        y = banded_frame_attention(y, jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(scaling.band()), scale=0.25)
    got = torch.cat([torch.load(out_dir / f"0.{r}")["out"] for r in range(2)], 1)
    np.testing.assert_allclose(got.reshape(shape).numpy(), np.asarray(y), atol=1e-5, rtol=0)


def test_efficiency_lines_leave_out_shared_cards(capsys, monkeypatch):
    base = {"n_shards": 1, "edges_per_sec": 10.0, "shared_card": False}
    lines = scaling.efficiency_lines([
        base, {"n_shards": 2, "edges_per_sec": 18.0, "shared_card": False},
        {"n_shards": 4, "edges_per_sec": 30.0, "shared_card": True}])
    assert lines == [{"scaling_efficiency": 0.9, "n_shards": 2, "target": 0.85}]
    assert scaling.efficiency_lines([base, {"n_shards": 2, "edges_per_sec": 9.0,
                                            "shared_card": True}]) == []
    # the command line: the JAX script's arguments, one line a scale
    monkeypatch.setenv("SCALING_UNITS_PER_SHARD", str(UNITS))
    monkeypatch.setattr(scaling, "measure", lambda n, units_per_shard, device: dict(
        base, n_shards=n, units=units_per_shard * n, edges_per_sec=10.0 * n, device=device))
    scaling.main(["--device", "cpu", "1", "2"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [p.get("n_shards") for p in printed] == [1, 2, 2]
    assert printed[0]["units"] == UNITS and printed[2]["scaling_efficiency"] == 1.0
