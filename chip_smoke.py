"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure ends the run non-zero):

1. device   — the card (nvidia-smi name and power limit), torch and CUDA.
2. build    — nvcc builds every CUDA source of the port (sm_90a) into build/.
3. kernel   — the window-attention kernel against its plain PyTorch version
              at the flagship shape (12288 units × 32 tokens × dh 64): single
              and dual mask, prune off and u = 0.3, f32 and bf16.
4. forward  — HWGATE at the FDMSE-ISL geometry (192 frames, 2002 classes,
              embed 128, depths (2,2,4), heads (2,4,8)), batch 16, f32 and
              bf16: logits through the kernel against logits through the plain
              attention, and exactly 8 kernel launches per forward.
5. serve    — the main path: a checkpoint → Predictor.from_checkpoint →
              warmup → 48 raw clips (F_i from 96 to 384 frames) submitted from
              4 threads through BatchingQueue; every row must equal
              predict_logits of its clip. Launch counts are reset just before
              and read just after this phase.
6. timings  — CUDA-event medians of the kernel, its plain version and
              masked scaled_dot_product_attention (a yardstick the port never
              calls), and of the eval forward.

The last lines are the kernels line, the nvidia-smi line and
{"ok": true, "device": {...}}. Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from contextlib import contextmanager
from pathlib import Path

SEED = 0
UNITS, TOKENS, HEAD_DIM = 12288, 32, 64  # 16·96·4·2 = 16·48·4·4 = 16·24·4·8
PEAK_BYTES_PER_S = 3.35e12               # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # f32 CUDA cores; bf16 dense tensor
TOL = {"float32": 1e-5, "bfloat16": 4e-3}
LOGIT_TOL = {"float32": dict(atol=2e-4, rtol=1e-4), "bfloat16": dict(atol=0.05, rtol=0.05)}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = 30, inner: int = 10, warmup: int = 5) -> float:
    """Median milliseconds of one call of ``fn`` on the current stream, by CUDA
    events around ``inner`` back-to-back calls: with one call per sample, the
    host's time to prepare the launch into an empty queue would be counted as
    device time."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def attention_inputs(dtype):
    """Seeded flagship-shape q, k, v on the card; v at 0.2 scale keeps |o| < 1,
    where one bf16 ulp (2^-8) sits inside the 4e-3 bar."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn(UNITS, TOKENS, HEAD_DIM, generator=g, device="cuda") for _ in range(3))
    return q.to(dtype), k.to(dtype), (v * 0.2).to(dtype)


def masks():
    from sl_hwgat_tpu_torch.graphs.adjacency import windowed_block_adj
    from sl_hwgat_tpu_torch.models.hwgate import shift_tail_mask

    adj = windowed_block_adj(2)[0]
    return adj, adj * shift_tail_mask(16, 2, 1)


def attention_kwargs(dual: bool, prune_u, tail):
    import torch

    kw = dict(scale=HEAD_DIM**-0.5, stack=4)
    if prune_u is not None:
        kw["prune_u"] = torch.full((1,), prune_u, device="cuda")
    if dual:  # stage 0 at batch 16: 96 temporal groups of nW·h = 8 units
        kw.update(tail_adj=tail, units_per_group=8, groups=96)
    return kw


def phase_kernel():
    import torch

    from sl_hwgat_tpu_torch.ops.window_attention import plain_window_attention, window_attention

    adj, tail = masks()
    errors = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        q, k, v = attention_inputs(dtype)
        for dual in (False, True):
            for prune_u in (None, 0.3):
                kw = attention_kwargs(dual, prune_u, tail)
                got = window_attention(q, k, v, adj, out_dtype=dtype, **kw)
                want = plain_window_attention(q, k, v, adj, out_dtype=dtype, **kw)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                case = f"{name}/{'dual' if dual else 'single'}/prune={prune_u}"
                errors[case] = err
                if not err <= TOL[name]:
                    raise AssertionError(f"kernel vs plain {case}: max abs err {err} > {TOL[name]}")
    emit("kernel", units=UNITS, tokens=TOKENS, head_dim=HEAD_DIM, tolerance=TOL,
         max_abs_err=errors)
    return errors


@contextmanager
def plain_attention_in_model():
    """Run HWGATE's attention through the plain version instead of the kernel."""
    from sl_hwgat_tpu_torch.models import hwgate
    from sl_hwgat_tpu_torch.ops.window_attention import plain_window_attention

    kernel = hwgate.window_attention
    hwgate.window_attention = plain_window_attention
    try:
        yield
    finally:
        hwgate.window_attention = kernel


def flagship(compute_dtype: str):
    from sl_hwgat_tpu_torch.constants import DATASET_PARAMS
    from sl_hwgat_tpu_torch.models import build_model

    return build_model("HWGATE", DATASET_PARAMS["FDMSE-ISL"], 2, device="cuda", seed=SEED,
                       compute_dtype=compute_dtype)


def eval_batch(batch: int = 16):
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    return torch.rand(batch, 192, 64, 2, generator=g, device="cuda")


def phase_forward():
    import torch

    from sl_hwgat_tpu_torch.ops.window_attention import window_attention

    x = eval_batch()
    out = {}
    for cdt in ("float32", "bfloat16"):
        model = flagship(cdt)
        with torch.inference_mode():
            before = window_attention.launches
            got = model(x)
            torch.cuda.synchronize()
            launches = window_attention.launches - before
            with plain_attention_in_model():
                want = model(x)
            torch.cuda.synchronize()
        if launches != 8:
            raise AssertionError(f"{cdt} forward launched the kernel {launches} times, not 8")
        if got.shape != (16, 2002) or not torch.isfinite(got).all():
            raise AssertionError(f"{cdt} logits: shape {tuple(got.shape)} or non-finite values")
        torch.testing.assert_close(got, want, **LOGIT_TOL[cdt])
        out[cdt] = {"max_abs_diff": (got - want).abs().max().item(),
                    "launches_per_forward": launches}
    emit("forward", batch=16, frames=192, classes=2002, tolerance=LOGIT_TOL, results=out)


def phase_serve(workdir: Path):
    import numpy as np
    import torch

    from sl_hwgat_tpu_torch.ops.window_attention import window_attention
    from sl_hwgat_tpu_torch.serve import BatchingQueue, Predictor
    from sl_hwgat_tpu_torch.weights import save_state_dict

    ckpt = workdir / "hwgate_fdmse_isl.pt"
    save_state_dict(str(ckpt), flagship("float32"))
    rng = np.random.default_rng(SEED)
    clips = [rng.random((int(f), 543, 4)).astype(np.float32)
             for f in rng.integers(96, 385, size=48)]
    t0 = time.perf_counter()
    pred = Predictor.from_checkpoint(str(ckpt), model_type="HWGATE", dataset="FDMSE-ISL")
    pred.warmup(clips[0])
    setup_s = time.perf_counter() - t0

    window_attention.launches = 0
    t0 = time.perf_counter()
    q = BatchingQueue(pred, max_batch=16, max_wait_ms=5.0)
    futures: list = [None] * len(clips)

    def client(ids):
        for i in ids:
            futures[i] = q.submit(clips[i])

    threads = [threading.Thread(target=client, args=(range(c, len(clips), 4),)) for c in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            raise AssertionError("a client thread did not finish")
    rows = [f.result(timeout=600) for f in futures]
    q.close()
    serve_s = time.perf_counter() - t0
    launches = window_attention.launches

    if launches != 8 * q.stats["batches"]:
        raise AssertionError(f"{launches} launches for {q.stats['batches']} batches")
    errs = []
    for clip, row in zip(clips, rows):
        want = pred.predict_logits([clip])[0]
        errs.append(float(np.abs(row - want).max()))
        if not (row.shape == (2002,) and np.isfinite(row).all() and errs[-1] <= 2e-4):
            raise AssertionError(f"served row differs from predict_logits by {errs[-1]}")
    pred.close()
    emit("serve", requests=q.stats["requests"], batches=q.stats["batches"],
         batch_sizes=q.stats["batch_sizes"], launches=launches, max_abs_err=max(errs),
         setup_s=setup_s, serve_s=serve_s, clips_per_s=len(clips) / serve_s)
    torch.cuda.synchronize()
    return launches


def bound(dtype_name: str) -> tuple[float, str]:
    elem = 4 if dtype_name == "float32" else 2
    bytes_ms = 4 * UNITS * TOKENS * HEAD_DIM * elem / PEAK_BYTES_PER_S * 1e3
    flops = 2 * 2 * TOKENS * TOKENS * HEAD_DIM * UNITS
    ops_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def phase_timings():
    import torch
    import torch.nn.functional as F

    from sl_hwgat_tpu_torch.ops.window_attention import plain_window_attention, window_attention

    adj, tail = masks()
    additive = torch.where(torch.from_numpy(adj) != 0, 0.0, -1e4).cuda()
    kernels = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        q, k, v = attention_inputs(dtype)
        cases = {}
        for dual in (False, True):
            kw = attention_kwargs(dual, None, tail)
            cases["dual" if dual else "single"] = {
                "ms": cuda_ms(lambda: window_attention(q, k, v, adj, out_dtype=dtype, **kw)),
                "plain_ms": cuda_ms(
                    lambda: plain_window_attention(q, k, v, adj, out_dtype=dtype, **kw), runs=20),
            }
        mask = additive.to(dtype)[None, None]
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q[:, None], k[:, None], v[:, None], attn_mask=mask, scale=HEAD_DIM**-0.5))
        bound_ms, bound_by = bound(name)
        kernels[name] = {"cases": cases, "library_ms": library_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by}
    emit("timings", shape=[UNITS, TOKENS, HEAD_DIM], kernels=kernels,
         note="library_ms: scaled_dot_product_attention with the plain adjacency as an "
              "additive mask, timed only")

    x = eval_batch()
    forward = {}
    for cdt in ("float32", "bfloat16"):
        model = flagship(cdt)
        with torch.inference_mode():
            ms = cuda_ms(lambda: model(x), runs=20, inner=1)  # one request's forward
        forward[cdt] = {"forward_ms": ms, "clips_per_s": 16 / ms * 1e3}
    emit("eval", batch=16, frames=192, results=forward)
    return kernels


def phase_profile():
    """Device time of one bf16 and one f32 eval forward by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = eval_batch()
    out = {}
    for cdt in ("float32", "bfloat16"):
        model = flagship(cdt)
        with torch.inference_mode():
            model(x)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                model(x)
                torch.cuda.synchronize()
        rows = []
        for ev in prof.key_averages():
            dev_us = getattr(ev, "device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "cuda_time_total", 0)
            if dev_us and ev.device_type == torch.autograd.DeviceType.CUDA:
                rows.append((dev_us, ev.key, ev.count))
        rows.sort(reverse=True)
        total = sum(r[0] for r in rows)
        out[cdt] = {"device_ms": total / 1e3,
                    "top": [{"kernel": k[:90], "ms": us / 1e3, "calls": c,
                             "share": us / total if total else None}
                            for us, k, c in rows[:10]]}
    emit("profile", batch=16, results=out)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    if not (repo / "sl_hwgat_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the sl_hwgat_tpu_torch package is not beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi()
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    from sl_hwgat_tpu_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build()
    emit("build", seconds=time.perf_counter() - t0,
         sources={n: {"seconds": r["seconds"],
                      "ptxas": [ln.strip() for ln in r["log"].splitlines()
                                if "registers" in ln or "spill" in ln]}
                  for n, r in report.items()})

    errors = phase_kernel()
    phase_forward()
    with tempfile.TemporaryDirectory() as tmp:
        launches = phase_serve(Path(tmp))
    timings = phase_timings()
    phase_profile()

    from sl_hwgat_tpu_torch.ops.window_attention import KERNEL

    entry = {"name": KERNEL, "route": "cuda",
             "source": f"sl_hwgat_tpu_torch/csrc/{KERNEL}.cu",
             "replaces": "sl_hwgat_tpu/ops/pallas_attention.py:241 (_fwd_kernel)",
             "launches": launches}
    for dtype_name, t in timings.items():
        # single mask: the function the masked-SDPA yardstick computes too
        single, dual = t["cases"]["single"], t["cases"]["dual"]
        fields = {
            "ms": single["ms"], "kernel_ms": single["ms"], "plain_ms": single["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "max_abs_err": max(e for c, e in errors.items() if c.startswith(dtype_name)),
            "dual_mask_ms": dual["ms"], "dual_mask_plain_ms": dual["plain_ms"],
        }
        if dtype_name == "float32":  # the serving path's dtype
            entry.update(fields)
        else:
            entry[dtype_name] = fields
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
