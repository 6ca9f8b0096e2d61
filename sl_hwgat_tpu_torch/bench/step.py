"""A whole train step (forward, backward, AdamW) or eval step of one model at
the FDMSE-ISL geometry on the card, as one JSON line.

    python -m sl_hwgat_tpu_torch.bench.step {f32|bf16} [batch] [--model NAME]
        [--step train|eval] [--attn-impl IMPL] [--remat] [--drop RATE]
        [--no-prune] [--stream-dtype float32|bfloat16] [--hybrid-scores-bf16]
        [--repeats 5] [--device cuda|cpu]

Counterpart of ``bench_train_step.py``: its ``SL_HWGAT_*`` variables are
flags here, and so is ``PALLAS_HYBRID_S_BF16=1``, which the JAX hybrid op
reads (``--hybrid-scores-bf16``: the hybrid path's scores in bf16 under
bf16 attention); ``--remat``, ``--no-prune``, ``--stream-dtype`` and
``--hybrid-scores-bf16`` are dropped for models other than HWGATE and
HGATE, as the JAX script drops the first three and the variable reaches no
other model. Its TPU knobs (the PRNG, the stream layout, the compile cache) have no
counterpart. STGCN and DecoupledGCN have no ``compute_dtype``: ``bf16`` is
refused for them. Clips of 192 frames × ``MODEL_NUM_KPS`` joints × 2, 2002
classes, random weights and data from seed 0, AdamW at lr 5e-4; TF32 is off,
so f32 GEMMs and convolutions run on the CUDA cores.

Timing follows the JAX script: one warm-up step, then ``repeats`` samples of
10 train steps (20 eval steps) on the host clock, synchronised once at the
end of each sample and never inside it. The line carries the JAX script's
keys (``impl`` = ``{model}_{train|eval}_step_{dtype}``, ``time_us``,
``time_us_min``, ``time_us_max``, ``n_repeats``, ``clips_per_sec``), the
card (``device``: nvidia-smi's name and power limit) and ``card_ms``, the
card's busy time in one step (``profiling.busy_seconds``: the kernels'
summed device time, median of 3 profiled steps), so that host time and
card time can be told apart. (``profiling.device_seconds`` cannot time a
step: its thousands of launches overflow the card's queue, so they cannot
all be queued behind the spin.)
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

DATASET = {"src_len": 192, "num_class": 2002}  # FDMSE-ISL (constants.py)
LR = 5e-4
SEED = 0
STEPS = {"train": 10, "eval": 20}
F32_ONLY = ("STGCN", "DecoupledGCN")
WINDOWED = ("HWGATE", "HGATE")


def card_name() -> str:
    """nvidia-smi's name and power limit of the card, or the device type."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return "cpu"


def model_overrides(model: str, dtype: str, attn_impl: str | None = None,
                    remat: bool = False, drop: float | None = None, no_prune: bool = False,
                    stream_dtype: str | None = None, hybrid_scores_bf16: bool = False) -> dict:
    """The constructor overrides of the flags (``bench_train_step.py:44-66``)."""
    if dtype not in ("f32", "bf16"):
        raise SystemExit(f"bench.step: dtype must be f32 or bf16, not {dtype!r}")
    if dtype == "bf16" and model in F32_ONLY:
        raise SystemExit(f"bench.step: {model} has no compute_dtype (it runs f32 only), "
                         "as in the JAX package")
    overrides = {} if dtype == "f32" else {"compute_dtype": "bfloat16"}
    if attn_impl:
        overrides["attn_impl"] = attn_impl
    if remat:
        overrides["remat"] = True
    if drop is not None:
        overrides["drop_rate"] = drop
    if no_prune:
        overrides["prune_attn"] = False
    if stream_dtype:
        overrides["stream_dtype"] = stream_dtype
    if hybrid_scores_bf16:
        overrides["hybrid_scores_dtype"] = "bfloat16"
    if model not in WINDOWED:
        for key in ("remat", "prune_attn", "stream_dtype", "hybrid_scores_dtype"):
            overrides.pop(key, None)
    return overrides


def measure(model: str = "HWGATE", dtype: str = "bf16", batch: int = 16, step: str = "train",
            repeats: int = 5, device: str = "cuda", dataset: dict | None = None,
            steps: int | None = None, **flags) -> dict:
    """Time ``step`` steps of ``model`` → the JSON line's fields (on a card
    with ``card_ms``). ``dataset``, ``steps`` and extra constructor
    ``flags`` (e.g. ``embed_dim``) shrink the run for tests."""
    import numpy as np
    import torch

    from sl_hwgat_tpu_torch.models import MODEL_NUM_KPS, build_model
    from sl_hwgat_tpu_torch.train.loop import make_steps
    from sl_hwgat_tpu_torch.train.state import make_optimizer
    from sl_hwgat_tpu_torch.utils.profiling import busy_seconds

    if step not in STEPS:
        raise SystemExit(f"bench.step: --step must be train or eval, not {step!r}")
    bench_flags = {k: flags.pop(k) for k in ("attn_impl", "remat", "drop", "no_prune",
                                            "stream_dtype", "hybrid_scores_bf16") if k in flags}
    overrides = {**model_overrides(model, dtype, **bench_flags), **flags}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ds = dataset or DATASET
    net = build_model(model, ds, 2, device=device, seed=SEED, **overrides)
    dev = next(net.parameters()).device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    train_step, eval_step = make_steps(net, make_optimizer("adamw", LR, net.parameters()))

    r = np.random.default_rng(SEED)
    kps = MODEL_NUM_KPS[model]
    x = torch.from_numpy(r.normal(size=(batch, ds["src_len"], kps, 2)).astype(np.float32)).to(dev)
    y = torch.from_numpy(r.integers(0, ds["num_class"], size=batch)).to(dev)
    valid = torch.ones(batch, device=dev)

    counter = iter(range(1 << 62))
    if step == "train":
        def one():
            train_step(x, y, valid, SEED, 0, next(counter))
    else:
        def one():
            eval_step(x, y, valid, 1)
    n = steps or STEPS[step]
    one()  # warm-up
    sync()
    per = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(n):
            one()
        sync()
        per.append((time.perf_counter() - t0) / n)
    per_step = statistics.median(per)
    out = {
        "impl": f"{model}_{step}_step_{dtype}",
        "time_us": per_step * 1e6,
        "time_us_min": min(per) * 1e6,
        "time_us_max": max(per) * 1e6,
        "n_repeats": repeats,
        "clips_per_sec": batch / per_step,
        "batch": batch,
        "steps_per_repeat": n,
        "overrides": overrides,
        "device": card_name() if dev.type == "cuda" else "cpu",
    }
    if dev.type == "cuda":
        out["card_ms"] = busy_seconds(one) * 1e3
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dtype", nargs="?", default="f32", choices=("f32", "bf16"))
    ap.add_argument("batch", nargs="?", type=int, default=16)
    ap.add_argument("--model", default="HWGATE")
    ap.add_argument("--step", default="train", choices=tuple(STEPS))
    ap.add_argument("--attn-impl", default=None)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--drop", type=float, default=None)
    ap.add_argument("--no-prune", action="store_true")
    ap.add_argument("--stream-dtype", default=None, choices=("float32", "bfloat16"))
    ap.add_argument("--hybrid-scores-bf16", action="store_true")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    line = measure(args.model, args.dtype, args.batch, args.step, args.repeats, args.device,
                   attn_impl=args.attn_impl, remat=args.remat, drop=args.drop,
                   no_prune=args.no_prune, stream_dtype=args.stream_dtype,
                   hybrid_scores_bf16=args.hybrid_scores_bf16)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
