"""The plain K1/K2 at the unit sizes that the wide kernels cut otherwise than HGATE's 58.

The window-attention kernels for units of up to 64 tokens
(``csrc/window_attention_wide.cuh``) give each warp 16 query rows and take
a row's kept keys four lanes at a time; 17, 33, 48 and 64 tokens end their
last strip at other rows than 58 does. On the card the kernels are held
against the plain versions (``plain_window_attention``,
``plain_window_attention_bwd``) at these sizes (``chip_smoke.py``); here the
plain versions are held against the JAX package's
``stacked_window_attention`` (`sl_hwgat_tpu/ops/attention.py:96`) and its
``jax.vjp``: dh 64, tokens padded to 64, two units to a supertile, a seeded
random symmetric adjacency with self-loops, prune off and u = 0.3, and the
dual mask (the JAX function takes one plane, so its reference runs each
plane's supertiles on their own). Inputs are made with numpy from a seed.
Bars: f32 atol 1e-5 forward, 2e-5 gradients.

Also here: ``bench.run`` takes ``vs_calib`` from the paired child,
``bench.kernel.inputs`` defaults to the card, and ``bench.ablate``'s source
variants still apply to the kernels' sources.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sl_hwgat_tpu.ops.attention import stacked_window_attention as jax_stacked

from sl_hwgat_tpu_torch.bench import ablate as port_ablate
from sl_hwgat_tpu_torch.bench import kernel as port_bench
from sl_hwgat_tpu_torch.bench import run as port_run
from sl_hwgat_tpu_torch.ops import _build
from sl_hwgat_tpu_torch.ops.window_attention import (
    make_sel,
    plain_window_attention,
    plain_window_attention_bwd,
)

SIZES = (17, 33, 48, 64)
UNITS, STACK, PAD, DH, SCALE = 8, 2, 64, 64, 0.125
FWD_ATOL, GRAD_ATOL = 1e-5, 2e-5
# dual mask: two temporal groups of two units, the second under the tail plane
PER_GROUP, GROUPS = 2, 2


def _adj(n, seed):
    r = np.random.default_rng(seed)
    a = r.random((n, n)) < 0.3
    return (a | a.T | np.eye(n, dtype=bool)).astype(np.float32)


def _inputs(n, seed):
    r = np.random.default_rng(seed)
    return tuple(r.normal(size=(UNITS, n, DH)).astype(np.float32) for _ in range(4))


def _jax(q, k, v, do, adj, prune_u):
    """(out, dq, dk, dv) of the JAX function and its vjp, as numpy."""
    def f(q, k, v):
        return jax_stacked(q, k, v, jnp.asarray(adj), scale=SCALE, stack=STACK, pad_tokens=PAD,
                           prune_u=prune_u)

    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return (np.asarray(out), *(np.asarray(g) for g in vjp(jnp.asarray(do))))


def _jax_dual(q, k, v, do, adj, tail, sel, prune_u):
    """The JAX reference under two mask planes: each plane's supertiles
    through the JAX function on their own, put back in place."""
    per_unit = np.repeat(np.asarray(sel) != 0, STACK)
    results = [np.empty_like(q) for _ in range(4)]
    for plane, mask in ((False, adj), (True, tail)):
        idx = np.nonzero(per_unit == plane)[0]
        for res, part in zip(results, _jax(q[idx], k[idx], v[idx], do[idx], mask, prune_u)):
            res[idx] = part
    return results


def _check(got, want):
    out, dq, dk, dv = got
    w_out, w_dq, w_dk, w_dv = want
    np.testing.assert_allclose(out, w_out, atol=FWD_ATOL, rtol=0)
    for g, w in ((dq, w_dq), (dk, w_dk), (dv, w_dv)):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=0)


def _plain(q, k, v, do, adj, **kw):
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    kw = dict(scale=SCALE, stack=STACK, pad_tokens=PAD, **kw)
    out = plain_window_attention(*t[:3], adj, **kw)
    grads = plain_window_attention_bwd(*t, adj, **kw)
    return (out.numpy(), *(g.numpy() for g in grads))


@pytest.mark.parametrize("prune_u", [None, 0.3])
@pytest.mark.parametrize("n", SIZES)
def test_plain_matches_jax_single_mask(n, prune_u):
    q, k, v, do = _inputs(n, seed=n)
    adj = _adj(n, seed=100 + n)
    _check(_plain(q, k, v, do, adj, prune_u=prune_u), _jax(q, k, v, do, adj, prune_u))


@pytest.mark.parametrize("n", SIZES)
def test_plain_matches_jax_dual_mask(n):
    q, k, v, do = _inputs(n, seed=200 + n)
    adj = _adj(n, seed=300 + n)
    r = np.random.default_rng(400 + n)
    keep = r.random((n, n)) < 0.5
    tail = adj * (keep | keep.T | np.eye(n, dtype=bool))
    sel = make_sel(UNITS // STACK, STACK, PER_GROUP, GROUPS)
    assert sel.tolist() == [0, 1, 0, 1]
    got = _plain(q, k, v, do, adj, tail_adj=tail, units_per_group=PER_GROUP, groups=GROUPS)
    _check(got, _jax_dual(q, k, v, do, adj, tail, sel.numpy(), None))


def _child_lines(ratio=0.8123, low=0.8017, high=0.8301):
    """What ``run_child`` returns for the two children of ``bench.run``."""
    return {
        "pallas_obf16": {"impl": "pallas_obf16", "edges": 1000, "time_us": 200.0,
                         "time_us_min": 195.0, "time_us_max": 210.0, "n_repeats": 5,
                         "bound_us": 60.0, "bound_by": "bytes", "device": {"platform": "cpu"}},
        "pair_tscore_bf16": {"impl": "pair_tscore_bf16", "calib_time_us": 150.0,
                             "ratio_vs_calib": ratio, "ratio_min": low, "ratio_max": high},
    }


def test_bench_run_takes_vs_calib_from_the_paired_child(monkeypatch, capsys):
    lines, ran = _child_lines(), []

    def run_child(impl, units, device):
        ran.append((impl, units, device))
        return lines[impl]

    monkeypatch.setattr(port_run, "run_child", run_child)
    assert port_run.main(["--device", "cpu", "--units", "64"]) == 0
    assert ran == [("pallas_obf16", 64, "cpu"), ("pair_tscore_bf16", 64, "cpu")]
    captured = capsys.readouterr()
    metric = json.loads(captured.out.strip().splitlines()[-1])
    assert metric["vs_calib"] == 0.8123
    assert metric["value"] == 1000 / 200e-6 and metric["vs_baseline"] == 60.0 / 200.0
    assert "vs_calib 0.8123 [0.8017, 0.8301] (pair_tscore_bf16:" in captured.err


@pytest.mark.parametrize("missing", ["pallas_obf16", "pair_tscore_bf16"])
def test_bench_run_prints_no_metric_without_either_child(monkeypatch, capsys, missing):
    lines = _child_lines()
    monkeypatch.setattr(port_run, "run_child",
                        lambda impl, units, device: None if impl == missing else lines[impl])
    assert port_run.main(["--device", "cpu", "--units", "64"]) == 1
    assert capsys.readouterr().out == ""


def test_bench_inputs_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_bench.inputs("pallas", 64)
    assert port_bench.inputs("pallas", 64, device="cpu").state.device.type == "cpu"


@pytest.mark.parametrize("variant", sorted(port_ablate.VARIANTS))
def test_ablation_variants_apply_to_the_kernel_sources(variant):
    for fname, replacements in port_ablate.VARIANTS[variant].items():
        text = (_build.CSRC_DIR / fname).read_text()
        for old, _ in replacements:
            assert text.count(old) == 1, (variant, fname, old)


WINDOW32_VARIANTS = ["full", "no_column", "no_da", "no_scores", "eight_warps"]


@pytest.mark.parametrize("variant", WINDOW32_VARIANTS)
def test_window32_ablation_variants_apply_to_the_32_token_backward(variant):
    """``bench.ablate window32`` recognises the 32-token K2's design in the
    sources and each of its variants' edits finds its text once."""
    design, variants = port_ablate.design_of(_build.CSRC_DIR, port_ablate.WINDOW_BWD,
                                             port_ablate.WINDOW32_DESIGNS)
    assert design == "shared" and set(variants) == set(WINDOW32_VARIANTS)
    for fname, replacements in variants[variant].items():
        text = (_build.CSRC_DIR / fname).read_text()
        for old, _ in replacements:
            assert text.count(old) == 1, (variant, fname, old)


WINDOW32_FWD_VARIANTS = ["full", "no_scores", "no_av", "warps_1", "warps_2", "warps_8"]


@pytest.mark.parametrize("variant", WINDOW32_FWD_VARIANTS)
def test_window32_fwd_ablation_variants_apply_to_the_32_token_forward(variant):
    """``bench.ablate window32_fwd`` recognises the 32-token K1's design and
    each of its variants' edits finds its text once."""
    design, variants = port_ablate.design_of(_build.CSRC_DIR, port_ablate.WINDOW_FWD,
                                             port_ablate.WINDOW32_FWD_DESIGNS)
    assert design == "staged" and set(variants) == set(WINDOW32_FWD_VARIANTS)
    for fname, replacements in variants[variant].items():
        text = (_build.CSRC_DIR / fname).read_text()
        for old, _ in replacements:
            assert text.count(old) == 1, (variant, fname, old)


def test_ablation_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert port_ablate.main() == 1
    assert capsys.readouterr().out == ""
