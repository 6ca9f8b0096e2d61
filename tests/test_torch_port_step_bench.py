"""The port's step and serving benches, its step roofline and its debug
helpers, on the CPU (plumbing: no time here is a device number).

- ``hwgate_step_roofline`` equals the JAX package's at the JAX constants
  (47.3e12, 27.0e12, 1.05e12 B/s, 2 bytes, attention ratio 2.5) for train and
  eval at batch 1 and 16, to 1e-12 relative; at the card's defaults it gives
  the values PERF.md records;
- ``bench.step.measure`` at a small HWGATE (embed 32, depths (1, 1), heads
  (2, 2), 16 frames) and a small Transformer: the JAX script's keys, exactly one
  warm-up plus ``repeats × steps`` train steps, the flags dropped for the
  non-windowed models as the JAX script drops them, bf16 refused for the
  GCNs;
- ``bench.run``: a failing step child exits non-zero and prints no number
  (on a card; ``--device cpu`` and ``BENCH_SKIP_STEP=1`` skip the steps);
- ``bench.serve.measure`` at a small HWGATE on SYNTH: the JAX script's keys,
  every request answered, the batch sizes summing to the request count;
- ``nan_checks`` raises on a backward that makes a NaN, and
  ``assert_finite_state`` names the bad keys.
"""

import json
import math

import numpy as np
import pytest
import torch

from sl_hwgat_tpu.utils.profiling import hwgate_step_roofline as jax_roofline

from sl_hwgat_tpu_torch.bench import run as bench_run
from sl_hwgat_tpu_torch.bench import serve as bench_serve
from sl_hwgat_tpu_torch.bench import step as bench_step
from sl_hwgat_tpu_torch.utils import profiling
from sl_hwgat_tpu_torch.utils.debug import assert_finite_state, nan_checks

JAX_CONSTANTS = dict(mxu_flops=47.3e12, shape_flops=27.0e12, mem_bw=1.05e12, dtype_bytes=2,
                     attn_train_ratio=2.5)
SMALL_HWGATE = dict(embed_dim=32, depths=(1, 1), num_heads=(2, 2))
SMALL_DS = {"src_len": 16, "num_class": 10}
JAX_STEP_KEYS = {"impl", "time_us", "time_us_min", "time_us_max", "n_repeats", "clips_per_sec"}


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """The tier-1 run puts six test workers on the machine's cores: torch
    runs these tests on two threads, so that the workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("train", [True, False])
def test_roofline_equals_jax_at_its_constants(batch, train):
    want = jax_roofline(batch, train=train)
    got = profiling.hwgate_step_roofline(batch, train=train, **JAX_CONSTANTS)
    for key in ("seconds", "flops", "clips_per_sec"):
        assert math.isclose(got[key], want[key], rel_tol=1e-12), key


def test_roofline_card_defaults():
    """The card's peaks (989e12 bf16, 67e12 f32, 3.35e12 B/s) and the
    attention ratios of PERF.md §6's K1/K2 card times."""
    assert profiling.ATTN_TRAIN_RATIO["float32"] == pytest.approx(3.3202, abs=1e-4)
    assert profiling.ATTN_TRAIN_RATIO["bfloat16"] == pytest.approx(2.7383, abs=1e-4)
    bf16 = profiling.hwgate_step_roofline(16, dtype="bfloat16")
    explicit = profiling.hwgate_step_roofline(
        16, mxu_flops=989e12, shape_flops=989e12, mem_bw=3.35e12, dtype_bytes=2,
        attn_train_ratio=(0.1391 + 0.2418) / 0.1391)
    assert bf16 == explicit
    assert bf16["clips_per_sec"] == pytest.approx(2407.64, rel=1e-5)
    assert profiling.hwgate_step_roofline(16, train=False)["clips_per_sec"] == pytest.approx(
        7170.07, rel=1e-5)
    f32 = profiling.hwgate_step_roofline(16, dtype="float32")
    assert f32["clips_per_sec"] == pytest.approx(285.685, rel=1e-5)


def _count_steps(monkeypatch):
    """Wrap ``train.loop.make_steps`` so its steps are counted."""
    from sl_hwgat_tpu_torch.train import loop

    calls = {"train": 0, "eval": 0}
    inner = loop.make_steps

    def counting(*args, **kwargs):
        train_step, eval_step = inner(*args, **kwargs)

        def t(*a, **k):
            calls["train"] += 1
            return train_step(*a, **k)

        def e(*a, **k):
            calls["eval"] += 1
            return eval_step(*a, **k)

        return t, e

    monkeypatch.setattr(loop, "make_steps", counting)
    return calls


@pytest.mark.parametrize("step", ["train", "eval"])
def test_step_bench_line_and_step_count(monkeypatch, step):
    calls = _count_steps(monkeypatch)
    line = bench_step.measure("HWGATE", "f32", batch=2, step=step, repeats=2, device="cpu",
                              dataset=SMALL_DS, steps=2, **SMALL_HWGATE)
    assert JAX_STEP_KEYS <= set(line) and line["impl"] == f"HWGATE_{step}_step_f32"
    assert line["n_repeats"] == 2 and line["device"] == "cpu" and "card_ms" not in line
    assert all(math.isfinite(line[k]) and line[k] > 0 for k in JAX_STEP_KEYS - {"impl"})
    assert line["time_us_min"] <= line["time_us"] <= line["time_us_max"]
    assert calls[step] == 1 + 2 * 2 and calls["eval" if step == "train" else "train"] == 0
    json.dumps(line)


def test_step_bench_drops_flags_for_other_models(monkeypatch):
    calls = _count_steps(monkeypatch)
    assert bench_step.model_overrides("STGCN", "f32", remat=True, no_prune=True,
                                      stream_dtype="bfloat16") == {}
    assert bench_step.model_overrides("HWGATE", "bf16", remat=True, no_prune=True) == {
        "compute_dtype": "bfloat16", "remat": True, "prune_attn": False}
    assert bench_step.model_overrides("Transformer", "bf16") == {"compute_dtype": "bfloat16"}
    with pytest.raises(SystemExit, match="f32 only"):
        bench_step.model_overrides("DecoupledGCN", "bf16")
    small = dict(d_model=32, nhead=2, dim_feedforward=64, num_encoder_layers=1)
    line = bench_step.measure("Transformer", "f32", batch=2, repeats=2, device="cpu",
                              dataset=SMALL_DS, steps=1, remat=True, no_prune=True, **small)
    assert line["impl"] == "Transformer_train_step_f32" and line["overrides"] == small
    assert calls["train"] == 1 + 2 * 1


def test_bench_run_fails_on_a_failing_step_child(monkeypatch, capsys):
    kernel = {"time_us": 100.0, "time_us_min": 90.0, "time_us_max": 110.0, "n_repeats": 5,
              "bound_us": 50.0, "bound_by": "bytes", "edges": 1e9, "device": "cpu"}
    pair = {"ratio_vs_calib": 0.9, "ratio_min": 0.8, "ratio_max": 1.0, "calib_time_us": 90.0}
    monkeypatch.delenv("BENCH_SKIP_STEP", raising=False)
    # the children are stubs; the step lines run only for the card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench_run, "run_child",
                        lambda impl, units, device: pair if impl == bench_run.PAIR else kernel)
    monkeypatch.setattr(bench_run, "run_step_child", lambda step, device: None)
    assert bench_run.main(["--device", "cuda"]) == 1
    captured = capsys.readouterr()
    assert captured.out == "" and "train-step child printed no line" in captured.err
    assert "clips_per_sec" not in captured.err

    # with the steps, their lines go to standard error and the headline stays last
    rec = {"time_us": 60000.0, "time_us_min": 59000.0, "time_us_max": 61000.0,
           "clips_per_sec": 16 / 0.06, "batch": 16, "card_ms": 50.0, "device": "cpu"}
    monkeypatch.setattr(bench_run, "run_step_child", lambda step, device: rec)
    assert bench_run.main(["--device", "cuda"]) == 0
    captured = capsys.readouterr()
    head = json.loads(captured.out.strip().splitlines()[-1])
    assert head["metric"] == "fused_window_attention_edges_per_sec"
    steps = [json.loads(ln) for ln in captured.err.splitlines() if ln.startswith("{")]
    assert [s["metric"] for s in steps] == ["hwgate_train_step_clips_per_sec",
                                            "hwgate_eval_step_clips_per_sec"]
    roof = profiling.hwgate_step_roofline(16)
    assert steps[0]["vs_step_roofline"] == pytest.approx(rec["clips_per_sec"]
                                                         / roof["clips_per_sec"])
    assert steps[0]["mfu"] == pytest.approx(roof["flops"] / (0.06 * 989e12))
    monkeypatch.setattr(bench_run, "run_step_child", lambda step, device: None)
    assert bench_run.main(["--device", "cpu"]) == 0  # host plumbing: no step lines
    monkeypatch.setenv("BENCH_SKIP_STEP", "1")
    assert bench_run.main(["--device", "cuda"]) == 0


def test_serve_bench_answers_every_request():
    line = bench_serve.measure("SYNTH", "float32", "cpu", buckets=(1, 2), reps=1,
                               n_requests=6, n_clients=3, max_batch=2, max_wait_ms=5.0,
                               **SMALL_HWGATE)
    for key in ("per_bucket_ms", "clips_per_sec_b16", "clips_per_sec_bmax",
                "queue_clips_per_sec", "queue_batches", "queue_batch_sizes", "queue_p50_ms",
                "queue_p99_ms", "queue_speedup_vs_serial_b1"):
        assert key in line, key
    assert set(line["per_bucket_ms"]) == {"1", "2"} and line["clips_per_sec_b16"] is None
    assert line["queue_answered"] == 6 and sum(line["queue_batch_sizes"]) == 6
    assert line["queue_batches"] == len(line["queue_batch_sizes"])
    assert max(line["queue_batch_sizes"]) <= 2
    json.dumps(line)


def test_nan_checks_raise_on_a_nan_gradient():
    w = torch.tensor([1.0, -1.0], requires_grad=True)
    with pytest.raises(RuntimeError, match="nan"):
        with nan_checks():
            torch.sqrt(w).sum().backward()
    w.grad = None
    with nan_checks():
        (w * 2).sum().backward()
    assert torch.equal(w.grad, torch.tensor([2.0, 2.0]))


def test_assert_finite_state_names_the_bad_keys():
    model = torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.BatchNorm1d(2))
    assert_finite_state(model)
    with torch.no_grad():
        model[0].bias[1] = float("nan")
        model[1].running_var[0] = float("inf")
    with pytest.raises(FloatingPointError, match=r"\['0.bias', '1.running_var'\]"):
        assert_finite_state(model, "model")
    with pytest.raises(FloatingPointError, match="0.bias"):
        assert_finite_state({"0.bias": model[0].bias.detach(), "n": torch.tensor(3)})
