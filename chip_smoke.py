"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure ends the run non-zero):

1. device   — the card (nvidia-smi name and power limit), torch and CUDA.
2. build    — nvcc builds every CUDA source of the port (sm_90a) into build/,
              one process per source, all at once.
3. kernel   — the forward window-attention kernel against its plain PyTorch
              version at the flagship shape (12288 units × 32 tokens × dh 64):
              single and dual mask, prune off and u = 0.3, f32 and bf16.
4. backward — the backward kernel against its plain version at the same shape
              and cases, with a seeded output gradient; the autograd
              Function's gradients equal a direct call of the kernel.
5. forward  — HWGATE at the FDMSE-ISL geometry (192 frames, 2002 classes,
              embed 128, depths (2,2,4), heads (2,4,8)), batch 16, f32 and
              bf16: logits through the kernel against logits through the plain
              attention, and exactly 8 kernel launches per forward.
6. serve    — main path 1: a checkpoint → Predictor.from_checkpoint →
              warmup → 48 raw clips (F_i from 96 to 384 frames) submitted from
              4 threads through BatchingQueue; every row must equal
              predict_logits of its clip. Launch counts are reset just before
              and read just after this phase.
7. train    — HWGATE at FDMSE-ISL, batch 16, f32 and bf16: one step's
              parameter gradients through the kernels against those through
              the plain attention (dropout 0, the same prune generator), every
              parameter's gradient nonzero, 8 forward and 8 backward launches
              per step; ten AdamW steps on one batch lower the loss; a step's
              train-mode loss repeats from its seed.
8. synth    — main path 2: SYNTH written to a temp dir → Loader with the
              train transforms (batch 16) → 2 × train_epoch → evaluate, at
              full width. Launch counts are reset just before and read just
              after this phase: 8 backward launches per train step.
9. timings  — CUDA-event medians of both kernels, their plain versions and
              the masked scaled_dot_product_attention yardsticks (timed, never
              called by the port), of the eval forward and of the train step;
              a torch.profiler table of one eval forward and one train step.

The last lines are the kernels line, the nvidia-smi line and
{"ok": true, "device": {...}}. Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
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
# backward kernel vs plain: |got - want| <= atol + rtol·|want| (one bf16 ulp is 2^-8)
BWD_TOL = {"float32": dict(atol=2e-5, rtol=0.0), "bfloat16": dict(atol=4e-3, rtol=1e-2)}
LOGIT_TOL = {"float32": dict(atol=2e-4, rtol=1e-4), "bfloat16": dict(atol=0.05, rtol=0.05)}
# model gradients, kernels vs plain attention: max abs error (f32) and
# ‖g − g′‖/‖g′‖ per parameter (bf16) (tests/test_pallas_attention.py:380)
GRAD_ATOL_F32, GRAD_REL_BF16 = 5e-4, 2e-2
LR = 5e-4


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


def output_grad(dtype):
    """Seeded flagship-shape gradient of the attention output."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    return torch.randn(UNITS, TOKENS, HEAD_DIM, generator=g, device="cuda").to(dtype)


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[1]


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
        name = dtype_name(dtype)
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


def phase_backward():
    import torch

    from sl_hwgat_tpu_torch.ops.window_attention import (
        plain_window_attention_bwd,
        window_attention,
        window_attention_bwd,
    )

    adj, tail = masks()
    errors, detail = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        q, k, v = attention_inputs(dtype)
        do = output_grad(dtype)
        tol = BWD_TOL[name]
        for dual in (False, True):
            for prune_u in (None, 0.3):
                kw = attention_kwargs(dual, prune_u, tail)
                got = window_attention_bwd(q, k, v, do, adj, **kw)
                want = plain_window_attention_bwd(q, k, v, do, adj, **kw)
                torch.cuda.synchronize()
                case = f"{name}/{'dual' if dual else 'single'}/prune={prune_u}"
                detail[case] = {}
                for grad, g, w in zip(("dq", "dk", "dv"), got, want):
                    diff = (g.float() - w.float()).abs()
                    excess = (diff - tol["atol"] - tol["rtol"] * w.float().abs()).max().item()
                    detail[case][grad] = diff.max().item()
                    if g.dtype != dtype or not excess <= 0:
                        raise AssertionError(f"backward kernel vs plain {case} {grad}: max abs "
                                             f"err {detail[case][grad]} over {tol}")
                errors[case] = max(detail[case].values())
    # the autograd Function's gradients are the kernel's
    q, k, v = (t.detach().requires_grad_() for t in attention_inputs(torch.float32))
    do = output_grad(torch.float32)
    kw = attention_kwargs(True, 0.3, tail)
    window_attention(q, k, v, adj, **kw).backward(do)
    direct = window_attention_bwd(q.detach(), k.detach(), v.detach(), do, adj, **kw)
    if not all(torch.equal(t.grad, d) for t, d in zip((q, k, v), direct)):
        raise AssertionError("autograd gradients differ from a direct backward kernel call")
    emit("backward", units=UNITS, tokens=TOKENS, head_dim=HEAD_DIM, tolerance=BWD_TOL,
         max_abs_err=detail, autograd_equals_kernel=True)
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


def flagship(compute_dtype: str, **overrides):
    from sl_hwgat_tpu_torch.constants import DATASET_PARAMS
    from sl_hwgat_tpu_torch.models import build_model

    return build_model("HWGATE", DATASET_PARAMS["FDMSE-ISL"], 2, device="cuda", seed=SEED,
                       compute_dtype=compute_dtype, **overrides)


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


def train_batch(batch: int = 16):
    """A seeded FDMSE-ISL train batch (x, y, valid) on the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    x = torch.rand(batch, 192, 64, 2, generator=g, device="cuda")
    y = torch.randint(0, 2002, (batch,), generator=g, device="cuda")
    return x, y, torch.ones(batch, device="cuda")


def one_step_grads(model, x, y, valid, seed: int):
    """(loss, {name: grad}) of one train-mode forward/backward."""
    import torch

    from sl_hwgat_tpu_torch.train.losses import per_sample, smoothed_cross_entropy

    model.train()
    model.zero_grad(set_to_none=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    logits = model(x, gen)
    loss = torch.sum(per_sample(smoothed_cross_entropy, logits, y) * valid) / valid.sum()
    loss.backward()
    return loss.item(), {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def phase_train():
    import torch

    from sl_hwgat_tpu_torch.ops.window_attention import window_attention, window_attention_bwd
    from sl_hwgat_tpu_torch.train.loop import make_steps, step_seed
    from sl_hwgat_tpu_torch.train.state import make_optimizer

    x, y, valid = train_batch()
    out = {}
    for cdt in ("float32", "bfloat16"):
        # one step, kernels against plain attention: dropout 0, one prune generator
        model = flagship(cdt, drop_rate=0.0)
        fwd0, bwd0 = window_attention.launches, window_attention_bwd.launches
        loss, grads = one_step_grads(model, x, y, valid, seed=SEED)
        torch.cuda.synchronize()
        launches = (window_attention.launches - fwd0, window_attention_bwd.launches - bwd0)
        if launches != (8, 8):
            raise AssertionError(f"{cdt} step launched (fwd, bwd) = {launches}, not (8, 8)")
        with plain_attention_in_model():
            plain_loss, plain = one_step_grads(model, x, y, valid, seed=SEED)
        zero = [k for k, g in grads.items() if not (g.abs().max().item() > 0)]
        if zero:
            raise AssertionError(f"{cdt}: zero gradients through the kernels: {zero}")
        qkv = [k for k in grads if k.endswith("attn.qkv.weight")]
        worst = {}
        for k, g in grads.items():
            w = plain[k]
            if cdt == "float32":
                worst[k] = (g - w).abs().max().item()
                ok = worst[k] <= GRAD_ATOL_F32
            else:
                worst[k] = ((g - w).norm() / w.norm()).item()
                ok = worst[k] <= GRAD_REL_BF16
            if not ok:
                raise AssertionError(f"{cdt} gradient of {k}: kernels vs plain {worst[k]}")
        del grads, plain

        # ten AdamW steps on one batch, dropout and pruning on
        model = flagship(cdt)
        opt = make_optimizer("adamw", LR, model.parameters())
        train_step, _ = make_steps(model, opt)
        losses = [train_step(x, y, valid, SEED, 0, step)[0].item() for step in range(10)]
        if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"{cdt} AdamW losses: {losses}")
        # a step's train-mode randomness repeats from its seed
        model.train()
        with torch.no_grad():
            a, b = (model(x, torch.Generator(device="cuda").manual_seed(step_seed(SEED, 0, 3)))
                    for _ in range(2))
        if not torch.equal(a, b):
            raise AssertionError(f"{cdt}: the same step seed gave different logits")
        out[cdt] = {"loss_kernels": loss, "loss_plain": plain_loss,
                    "launches_per_step": {"fwd": launches[0], "bwd": launches[1]},
                    "grad_err_worst": max(worst.values()),
                    "grad_err_worst_param": max(worst, key=worst.get),
                    "grad_err_metric": "max abs" if cdt == "float32" else "rel norm",
                    "qkv_weight_grads_nonzero": len(qkv), "adamw_losses": losses}
        del model, opt
        torch.cuda.empty_cache()
    emit("train", batch=16, frames=192, classes=2002, lr=LR,
         tolerance={"float32": GRAD_ATOL_F32, "bfloat16": GRAD_REL_BF16}, results=out)


def phase_synth(workdir: Path):
    """Main path 2: SYNTH through the loader, train_epoch and evaluate."""
    import numpy as np
    import torch

    from sl_hwgat_tpu_torch import configs
    from sl_hwgat_tpu_torch.constants import DATASET_PARAMS
    from sl_hwgat_tpu_torch.data.dataset import KeypointDataset, Loader, load_artifacts
    from sl_hwgat_tpu_torch.data.synthetic import write_synthetic_dataset
    from sl_hwgat_tpu_torch.models import build_model
    from sl_hwgat_tpu_torch.ops.window_attention import window_attention, window_attention_bwd
    from sl_hwgat_tpu_torch.train.loop import evaluate, make_steps, train_epoch
    from sl_hwgat_tpu_torch.train.state import (
        TrainState,
        cosine_annealing_lr,
        make_optimizer,
        set_lr,
    )

    ds = DATASET_PARAMS["SYNTH"]
    write_synthetic_dataset(str(workdir), seed=SEED)
    splits, classes, data_map = load_artifacts(str(workdir), "SYNTH")
    train = Loader(KeypointDataset(splits["train"], data_map, classes,
                                   configs.build_train_transform(ds["src_len"]), seed=SEED),
                   16, shuffle=True, num_workers=4, seed=SEED)
    val = Loader(KeypointDataset(splits["val"], data_map, classes,
                                 configs.build_eval_transform(ds["src_len"]), seed=SEED),
                 16, num_workers=4, seed=SEED)
    model = build_model("HWGATE", ds, 2, device="cuda", seed=SEED)
    opt = make_optimizer("adamw", LR, model.parameters())
    state = TrainState(model, opt)
    train_step, eval_step = make_steps(model, opt)

    window_attention.launches = window_attention_bwd.launches = 0
    t0 = time.perf_counter()
    try:
        epochs = []
        for epoch in (0, 1):
            set_lr(opt, cosine_annealing_lr(epoch, LR))
            epochs.append(train_epoch(train_step, state, train, SEED, epoch))
        val_loss, val_acc = evaluate(eval_step, state, val, k=5)
    finally:
        train.close()
        val.close()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"fwd": window_attention.launches, "bwd": window_attention_bwd.launches}

    steps = 2 * len(train)
    if launches != {"fwd": 8 * (steps + len(val)), "bwd": 8 * steps}:
        raise AssertionError(f"SYNTH: launches {launches} for {steps} train and "
                             f"{len(val)} eval steps")
    if not all(np.isfinite([*(e[0] for e in epochs), val_loss])):
        raise AssertionError(f"SYNTH: non-finite losses {epochs}, {val_loss}")
    emit("synth", train_clips=len(train.dataset), batch=16, train_steps=steps,
         eval_steps=len(val), launches=launches,
         epochs=[{"loss": e[0], "acc": e[1]} for e in epochs],
         val_loss=val_loss, val_top5=val_acc, seconds=seconds)
    return launches


# Per unit of the flagship shape: tensors of TOKENS × HEAD_DIM that a call
# reads and writes once, and TOKENS × TOKENS × HEAD_DIM products it does.
# forward: q, k, v → o; S = QKᵀ, O = AV. backward: q, k, v, dO → dq, dk, dv;
# S, dA = dO Vᵀ, dV = Aᵀ dO, dQ = dS K, dK = dSᵀ Q.
WORK = {"fwd": (4, 2), "bwd": (7, 5)}


def bound(kind: str, dtype_name: str) -> tuple[float, str]:
    """(least ms on an H100 SXM, what bounds it) for one call at the
    flagship shape: bytes over the memory rate or operations over the peak
    rate of the type (f32: CUDA cores; bf16: dense tensor cores)."""
    tensors, products = WORK[kind]
    elem = 4 if dtype_name == "float32" else 2
    bytes_ms = tensors * UNITS * TOKENS * HEAD_DIM * elem / PEAK_BYTES_PER_S * 1e3
    flops = products * 2 * TOKENS * TOKENS * HEAD_DIM * UNITS
    ops_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def sdpa_ms(q, k, v, do, mask):
    """(forward ms, backward ms) of masked scaled_dot_product_attention on the
    same units, the backward as (forward + backward) − forward. Timed only."""
    import torch
    import torch.nn.functional as F

    qg, kg, vg = (t[:, None].detach().requires_grad_() for t in (q, k, v))
    do4 = do[:, None]

    def fwd():
        return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, scale=HEAD_DIM**-0.5)

    with torch.no_grad():
        fwd_ms = cuda_ms(fwd)
    grad_fwd_ms = cuda_ms(fwd)
    both_ms = cuda_ms(lambda: torch.autograd.grad(fwd(), (qg, kg, vg), do4), runs=20)
    return fwd_ms, both_ms - grad_fwd_ms


def train_step_ms(cdt: str, steps: int = 10) -> float:
    """Median ms of one FDMSE-ISL train step at batch 16 (forward, backward,
    AdamW), by CUDA events around each step."""
    import torch

    from sl_hwgat_tpu_torch.train.loop import make_steps
    from sl_hwgat_tpu_torch.train.state import make_optimizer

    model = flagship(cdt)
    train_step, _ = make_steps(model, make_optimizer("adamw", LR, model.parameters()))
    x, y, valid = train_batch()
    for step in range(3):
        train_step(x, y, valid, SEED, 0, step)
    times = []
    for step in range(3, 3 + steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        train_step(x, y, valid, SEED, 0, step)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_timings():
    import torch

    from sl_hwgat_tpu_torch.ops.window_attention import (
        plain_window_attention,
        plain_window_attention_bwd,
        window_attention,
        window_attention_bwd,
    )

    adj, tail = masks()
    additive = torch.where(torch.from_numpy(adj) != 0, 0.0, -1e4).cuda()
    kernels = {"fwd": {}, "bwd": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        q, k, v = attention_inputs(dtype)
        do = output_grad(dtype)
        fwd, bwd = {}, {}
        for dual in (False, True):
            kw = attention_kwargs(dual, None, tail)
            case = "dual" if dual else "single"
            fwd[case] = {
                "ms": cuda_ms(lambda: window_attention(q, k, v, adj, out_dtype=dtype, **kw)),
                "plain_ms": cuda_ms(
                    lambda: plain_window_attention(q, k, v, adj, out_dtype=dtype, **kw), runs=20),
            }
            bwd[case] = {
                "ms": cuda_ms(lambda: window_attention_bwd(q, k, v, do, adj, **kw)),
                "plain_ms": cuda_ms(
                    lambda: plain_window_attention_bwd(q, k, v, do, adj, **kw), runs=10),
            }
        library_fwd, library_bwd = sdpa_ms(q, k, v, do, additive.to(dtype)[None, None])
        for kind, cases, library in (("fwd", fwd, library_fwd), ("bwd", bwd, library_bwd)):
            bound_ms, bound_by = bound(kind, name)
            kernels[kind][name] = {"cases": cases, "library_ms": library, "bound_ms": bound_ms,
                                   "bound_by": bound_by}
    emit("timings", shape=[UNITS, TOKENS, HEAD_DIM], kernels=kernels,
         note="library_ms: scaled_dot_product_attention with the plain adjacency as an "
              "additive mask (its backward as fwd+bwd minus fwd), timed only")

    x = eval_batch()
    results = {}
    for cdt in ("float32", "bfloat16"):
        model = flagship(cdt)
        with torch.inference_mode():
            ms = cuda_ms(lambda: model(x), runs=20, inner=1)  # one request's forward
        del model
        step_ms = train_step_ms(cdt)
        results[cdt] = {"forward_ms": ms, "clips_per_s": 16 / ms * 1e3,
                        "train_step_ms": step_ms, "train_clips_per_s": 16 / step_ms * 1e3}
        torch.cuda.empty_cache()
    emit("eval_train", batch=16, frames=192, results=results)
    return kernels


def device_table(prof, top: int = 12) -> dict:
    """Device time of a profiled region, summed by kernel name."""
    import torch

    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0)
        if dev_us and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    return {"device_ms": total / 1e3,
            "top": [{"kernel": k[:90], "ms": us / 1e3, "calls": c,
                     "share": us / total if total else None}
                    for us, k, c in rows[:top]]}


def phase_profile():
    """Device time by kernel of one eval forward and of one train step, in
    f32 and bf16, with the wall time of the profiled step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sl_hwgat_tpu_torch.train.loop import make_steps
    from sl_hwgat_tpu_torch.train.state import make_optimizer

    x = eval_batch()
    xt, yt, valid = train_batch()
    out = {}
    for cdt in ("float32", "bfloat16"):
        model = flagship(cdt)
        with torch.inference_mode():
            model(x)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                model(x)
                torch.cuda.synchronize()
        out[f"eval/{cdt}"] = device_table(prof)
        train_step, _ = make_steps(model, make_optimizer("adamw", LR, model.parameters()))
        for step in range(2):
            train_step(xt, yt, valid, SEED, 0, step)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            train_step(xt, yt, valid, SEED, 0, 2)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        out[f"train/{cdt}"] = {**device_table(prof), "wall_ms_profiled": wall_ms}
        del model, train_step
        torch.cuda.empty_cache()
    emit("profile", batch=16, results=out)


def kernel_entry(kind: str, name: str, replaces: str, launches: int, timings: dict,
                 errors: dict) -> dict:
    """One entry of the kernels line: the f32 numbers at the top level (the
    serving path's type), bf16 under "bfloat16"; single-mask times (the
    function the masked-SDPA yardstick computes too), dual-mask beside."""
    entry = {"name": name, "route": "cuda", "source": f"sl_hwgat_tpu_torch/csrc/{name}.cu",
             "replaces": replaces, "launches": launches}
    for dt, t in timings[kind].items():
        single, dual = t["cases"]["single"], t["cases"]["dual"]
        fields = {
            "ms": single["ms"], "kernel_ms": single["ms"], "plain_ms": single["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "max_abs_err": max(e for c, e in errors.items() if c.startswith(dt)),
            "dual_mask_ms": dual["ms"], "dual_mask_plain_ms": dual["plain_ms"],
        }
        if dt == "float32":
            entry.update(fields)
        else:
            entry[dt] = fields
    return entry


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

    fwd_errors = phase_kernel()
    bwd_errors = phase_backward()
    phase_forward()
    with tempfile.TemporaryDirectory() as tmp:
        serve_launches = phase_serve(Path(tmp))
    phase_train()
    with tempfile.TemporaryDirectory() as tmp:
        train_launches = phase_synth(Path(tmp))
    timings = phase_timings()
    phase_profile()

    from sl_hwgat_tpu_torch.ops.window_attention import KERNEL, KERNEL_BWD

    fwd = kernel_entry("fwd", KERNEL, "sl_hwgat_tpu/ops/pallas_attention.py:241 (_fwd_kernel)",
                       serve_launches, timings, fwd_errors)
    fwd["train_launches"] = train_launches["fwd"]
    bwd = kernel_entry("bwd", KERNEL_BWD,
                       "sl_hwgat_tpu/ops/pallas_attention.py:295 (_bwd_kernel)",
                       train_launches["bwd"], timings, bwd_errors)
    print(json.dumps({"kernels": [fwd, bwd]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
