"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure ends the run non-zero):

1. device   — the card (nvidia-smi name and power limit), torch and CUDA.
2. build    — nvcc builds every CUDA source of the port (sm_90a) into build/,
              one process per source, all at once.
3. kernel   — the forward window-attention kernel against its plain PyTorch
              version at the flagship shape (12288 units × 32 tokens × dh 64)
              and at HGATE's (3072 units × 58 tokens × dh 64, two units to a
              64-token padded supertile): single and dual mask, prune off and
              u = 0.3, f32 and bf16.
4. backward — the backward kernel against its plain version at the same shapes
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
9. banded   — the banded forward and backward kernels against their plain
              versions at WGATE's (512 planes × 192 frames × 16 joints) and
              GATE's (128 × 192 × 29) batch-16 shapes, dh 16, f32 and bf16,
              under the models' identity ±1-frame band and under a
              non-diagonal band (the spatial plane as prev/next); the
              autograd Function's gradients equal a direct backward call.
10. banded forward — WGATE and GATE at FDMSE-ISL (192 frames, 2002 classes,
              embed 128, 8 blocks, 8 heads), batch 16, f32 and bf16: logits
              through the kernel against the plain attention, 8 launches per
              forward.
11. banded serve — main path 3: for each of WGATE and GATE, a checkpoint →
              Predictor.from_checkpoint → a 24-clip burst from 4 threads
              through BatchingQueue (GATE through the 29-joint transform);
              every row equals predict_logits; counts reset just before and
              read just after each burst.
12. banded train — WGATE and GATE at FDMSE-ISL, batch 16, f32 and bf16: one
              step's gradients through the kernels against the plain
              attention (dropout 0), all nonzero, 8 + 8 launches per step,
              the step repeating bit for bit from its seed; main path 4: ten
              AdamW steps through make_steps lower the loss, with the counts
              reset just before and read just after.
13. masked softmax — the hybrid attention's masked-softmax kernels (K7)
              against their plain versions at HWGATE's (12288 × 32 × 32) and
              HGATE's (3072 × 58 × 58) f32 scores: single and dual mask, prune
              off and 0.3 (HWGATE), P in f32 and bf16; the hybrid attention
              through K7 against the fused kernel (one function); the
              autograd Function's gradient equals a direct backward call.
14. windowed forward — HWGATE with attn_impl="hybrid", and HGATE on its
              default (K1/K2 at 58 tokens) and hybrid paths, at FDMSE-ISL,
              batch 16, f32 and bf16: logits against the plain path, 8
              launches per forward and none of the other path's kernels.
15. windowed serve — main paths 5-7: each of the three served from a
              checkpoint through a 24-clip burst (HGATE through the 29-joint
              transform); rows equal predict_logits; counts reset just before
              and read just after each burst.
16. windowed train — the three paths, f32 and bf16: one step's gradients
              against the plain path, all nonzero, 8 + 8 launches; main paths
              8-10: ten AdamW steps lower the loss, counts reset just before
              and read just after.
17. timings  — CUDA-event medians of every kernel, its plain version and its
              library yardstick (masked scaled_dot_product_attention, or
              torch.softmax over masked scores for K7; timed, never called by
              the port); the hybrid attention against the fused kernels per
              call; the eval forward and the train step of each model and
              path; a torch.profiler table of one eval forward and one train
              step of each.

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
from contextlib import contextmanager, nullcontext
from pathlib import Path

SEED = 0
UNITS, TOKENS, HEAD_DIM = 12288, 32, 64  # 16·96·4·2 = 16·48·4·4 = 16·24·4·8
# (units, tokens, head dim) of one windowed attention call at batch 16:
# HWGATE's 32-token windows, HGATE's 58-token whole skeletons (16·96·2 =
# 16·48·4 = 16·24·8 units of 29 joints × 2 frames)
WINDOW_SHAPE = {"HWGATE": (UNITS, TOKENS, HEAD_DIM), "HGATE": (3072, 58, HEAD_DIM)}
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


def attention_inputs(dtype, model: str = "HWGATE"):
    """Seeded q, k, v of one of ``model``'s attention calls on the card; v at
    0.2 scale keeps |o| < 1, where one bf16 ulp (2^-8) sits inside the 4e-3
    bar."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn(*WINDOW_SHAPE[model], generator=g, device="cuda") for _ in range(3))
    return q.to(dtype), k.to(dtype), (v * 0.2).to(dtype)


def output_grad(dtype, model: str = "HWGATE"):
    """Seeded gradient of the output of one of ``model``'s attention calls."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    return torch.randn(*WINDOW_SHAPE[model], generator=g, device="cuda").to(dtype)


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[1]


def masks(model: str = "HWGATE"):
    """(adj, tail_adj) of ``model``'s windowed attention."""
    from sl_hwgat_tpu_torch.graphs.adjacency import hgate_block_adj, windowed_block_adj
    from sl_hwgat_tpu_torch.models.hwgate import shift_tail_mask

    if model == "HGATE":
        adj = hgate_block_adj()
        return adj, adj * shift_tail_mask(29, 2, 1)
    adj = windowed_block_adj(2)[0]
    return adj, adj * shift_tail_mask(16, 2, 1)


def attention_kwargs(dual: bool, prune_u, tail, model: str = "HWGATE"):
    import torch

    if model == "HGATE":  # 58 tokens padded to 64, two units to a supertile
        kw = dict(scale=HEAD_DIM**-0.5, stack=2, pad_tokens=64)
    else:
        kw = dict(scale=HEAD_DIM**-0.5, stack=4)
    if prune_u is not None:
        kw["prune_u"] = torch.full((1,), prune_u, device="cuda")
    if dual:  # stage 0 at batch 16: 96 temporal groups of nW·h = 8 (HGATE: h = 2) units
        kw.update(tail_adj=tail, units_per_group=8 if model == "HWGATE" else 2, groups=96)
    return kw


def case_prefix(model: str) -> str:
    """The prefix of ``model``'s cases in the kernel phases' error keys."""
    return "" if model == "HWGATE" else f"{model}/"


def phase_kernel(model: str = "HWGATE"):
    import torch

    from sl_hwgat_tpu_torch.ops.window_attention import plain_window_attention, window_attention

    adj, tail = masks(model)
    errors = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        q, k, v = attention_inputs(dtype, model)
        for dual in (False, True):
            for prune_u in (None, 0.3):
                kw = attention_kwargs(dual, prune_u, tail, model)
                got = window_attention(q, k, v, adj, out_dtype=dtype, **kw)
                want = plain_window_attention(q, k, v, adj, out_dtype=dtype, **kw)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                case = f"{case_prefix(model)}{name}/{'dual' if dual else 'single'}/prune={prune_u}"
                errors[case] = err
                if not err <= TOL[name]:
                    raise AssertionError(f"kernel vs plain {case}: max abs err {err} > {TOL[name]}")
    units, tokens, head_dim = WINDOW_SHAPE[model]
    emit("kernel", model=model, units=units, tokens=tokens, head_dim=head_dim, tolerance=TOL,
         max_abs_err=errors)
    return errors


def phase_backward(model: str = "HWGATE"):
    import torch

    from sl_hwgat_tpu_torch.ops.window_attention import (
        plain_window_attention_bwd,
        window_attention,
        window_attention_bwd,
    )

    adj, tail = masks(model)
    errors, detail = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        q, k, v = attention_inputs(dtype, model)
        do = output_grad(dtype, model)
        tol = BWD_TOL[name]
        for dual in (False, True):
            for prune_u in (None, 0.3):
                kw = attention_kwargs(dual, prune_u, tail, model)
                got = window_attention_bwd(q, k, v, do, adj, **kw)
                want = plain_window_attention_bwd(q, k, v, do, adj, **kw)
                torch.cuda.synchronize()
                case = f"{case_prefix(model)}{name}/{'dual' if dual else 'single'}/prune={prune_u}"
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
    q, k, v = (t.detach().requires_grad_() for t in attention_inputs(torch.float32, model))
    do = output_grad(torch.float32, model)
    kw = attention_kwargs(True, 0.3, tail, model)
    window_attention(q, k, v, adj, **kw).backward(do)
    direct = window_attention_bwd(q.detach(), k.detach(), v.detach(), do, adj, **kw)
    if not all(torch.equal(t.grad, d) for t, d in zip((q, k, v), direct)):
        raise AssertionError("autograd gradients differ from a direct backward kernel call")
    units, tokens, head_dim = WINDOW_SHAPE[model]
    emit("backward", model=model, units=units, tokens=tokens, head_dim=head_dim,
         tolerance=BWD_TOL, max_abs_err=detail, autograd_equals_kernel=True)
    return errors


@contextmanager
def plain_attention_in_model():
    """Run HWGATE's and HGATE's attention through the plain version of the
    fused kernel instead of the kernel."""
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


def burst(pred, clips):
    """Submit ``clips`` from 4 client threads through a BatchingQueue; returns
    (rows, queue stats, seconds)."""
    from sl_hwgat_tpu_torch.serve import BatchingQueue

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
    return rows, q.stats, time.perf_counter() - t0


def phase_serve(workdir: Path):
    import numpy as np
    import torch

    from sl_hwgat_tpu_torch.ops.window_attention import window_attention
    from sl_hwgat_tpu_torch.serve import Predictor
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
    rows, stats, serve_s = burst(pred, clips)
    launches = window_attention.launches

    if launches != 8 * stats["batches"]:
        raise AssertionError(f"{launches} launches for {stats['batches']} batches")
    errs = []
    for clip, row in zip(clips, rows):
        want = pred.predict_logits([clip])[0]
        errs.append(float(np.abs(row - want).max()))
        if not (row.shape == (2002,) and np.isfinite(row).all() and errs[-1] <= 2e-4):
            raise AssertionError(f"served row differs from predict_logits by {errs[-1]}")
    pred.close()
    emit("serve", requests=stats["requests"], batches=stats["batches"],
         batch_sizes=stats["batch_sizes"], launches=launches, max_abs_err=max(errs),
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


def grad_errors(case: str, cdt: str, grads: dict, plain: dict) -> dict:
    """Per parameter, the gradient through the kernels against the plain
    path's: max abs error (f32) or ‖g − g′‖/‖g′‖ (bf16), each held to its bar;
    every gradient through the kernels must be nonzero."""
    zero = [k for k, g in grads.items() if not (g.abs().max().item() > 0)]
    if zero:
        raise AssertionError(f"{case}: zero gradients through the kernels: {zero}")
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
            raise AssertionError(f"{case} gradient of {k}: kernels vs plain {worst[k]}")
    return worst


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
        qkv = [k for k in grads if k.endswith("attn.qkv.weight")]
        worst = grad_errors(cdt, cdt, grads, plain)
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


# ---------------------------------------------------------------------------
# The banded models, WGATE and GATE (phases 9-12).

BANDED_MODELS = ("WGATE", "GATE")
# (planes, frames, joints) of one attention call at batch 16: WGATE's 16·4
# windows × 8 heads over 192 frames of 16 joints; GATE's 16 clips × 8 heads
# over 192 frames of 29 joints. dh = 128 / 8 = 16.
BANDED_SHAPE = {"WGATE": (512, 192, 16), "GATE": (128, 192, 29)}
BANDED_DH = 16
BANDED_SCALE = BANDED_DH**-0.5
NUM_KPS = {"WGATE": 64, "GATE": 29, "HWGATE": 64, "HGATE": 29}


def banded_bands() -> dict:
    """{model: {"identity": the model's band (K8's case), "spatial": the
    spatial plane as prev/next too (K9's general case)}}."""
    import numpy as np

    from sl_hwgat_tpu_torch.graphs.adjacency import additive_mask, window_adj
    from sl_hwgat_tpu_torch.graphs.skeleton import BODY29_EDGES, edges_to_dense
    from sl_hwgat_tpu_torch.models.wgate import make_band

    spatial = {"WGATE": window_adj(window_size=16),
               "GATE": edges_to_dense(BODY29_EDGES, 29, self_loops=False)}
    return {m: {"identity": make_band(a), "spatial": np.stack([additive_mask(a)] * 3)}
            for m, a in spatial.items()}


def banded_inputs(model: str, dtype):
    """Seeded q, k, v, dO of one attention call of ``model`` on the card. v
    and dO at 0.2 scale: a probability that rounds to the other side of a
    bf16 step in the kernel and in the plain version (their f32 scores sum
    in different orders) moves dV by one step of A times dO, 2^-8·|dO|,
    which stays inside the 4e-3 bar only for |dO| < 1."""
    import torch

    planes, frames, joints = BANDED_SHAPE[model]
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    q, k, v, do = (torch.randn(planes, frames * joints, BANDED_DH, generator=g, device="cuda")
                   for _ in range(4))
    return q.to(dtype), k.to(dtype), (v * 0.2).to(dtype), (do * 0.2).to(dtype)


def phase_banded():
    import torch

    from sl_hwgat_tpu_torch.ops.banded_attention import (
        banded_attention,
        banded_attention_bwd,
        plain_banded_attention,
        plain_banded_attention_bwd,
    )

    bands = banded_bands()
    fwd_errors, bwd_errors = {}, {}
    for model in BANDED_MODELS:
        for dtype in (torch.float32, torch.bfloat16):
            name = dtype_name(dtype)
            q, k, v, do = banded_inputs(model, dtype)
            for kind, band in bands[model].items():
                case = f"{model}/{kind}/{name}"
                got = banded_attention(q, k, v, band, scale=BANDED_SCALE)
                want = plain_banded_attention(q, k, v, band, scale=BANDED_SCALE)
                torch.cuda.synchronize()
                fwd_errors[case] = (got - want).abs().max().item()
                if not (got.dtype == torch.float32 and fwd_errors[case] <= TOL[name]):
                    raise AssertionError(f"banded kernel vs plain {case}: max abs err "
                                         f"{fwd_errors[case]} > {TOL[name]}")
                tol = BWD_TOL[name]
                bwd_errors[case] = {}
                got = banded_attention_bwd(q, k, v, do, band, scale=BANDED_SCALE)
                want = plain_banded_attention_bwd(q, k, v, do, band, scale=BANDED_SCALE)
                torch.cuda.synchronize()
                for grad, g_, w in zip(("dq", "dk", "dv"), got, want):
                    diff = (g_.float() - w.float()).abs()
                    excess = diff - tol["atol"] - tol["rtol"] * w.float().abs()
                    bwd_errors[case][grad] = diff.max().item()
                    if g_.dtype != dtype or not excess.max().item() <= 0:
                        at = int(excess.argmax())
                        raise AssertionError(
                            f"banded backward vs plain {case} {grad}: max abs err "
                            f"{bwd_errors[case][grad]}, worst excess at {at}: got "
                            f"{g_.flatten()[at].item()}, want {w.flatten()[at].item()}, "
                            f"{int((excess > 0).sum())} entries over {tol}")
                del got, want
            del q, k, v, do
            torch.cuda.empty_cache()
    # the autograd Function's gradients are the backward kernel's
    band = bands["GATE"]["identity"]
    q, k, v, do = banded_inputs("GATE", torch.float32)
    leaves = tuple(t.detach().requires_grad_() for t in (q, k, v))
    banded_attention(*leaves, band, scale=BANDED_SCALE).backward(do)
    direct = banded_attention_bwd(q, k, v, do, band, scale=BANDED_SCALE)
    if not all(torch.equal(t.grad, d) for t, d in zip(leaves, direct)):
        raise AssertionError("banded autograd gradients differ from a direct backward call")
    emit("banded", shapes={m: [*BANDED_SHAPE[m], BANDED_DH] for m in BANDED_MODELS},
         tolerance={"fwd": TOL, "bwd": BWD_TOL}, fwd_max_abs_err=fwd_errors,
         bwd_max_abs_err=bwd_errors, autograd_equals_kernel=True)
    return fwd_errors, {c: max(e.values()) for c, e in bwd_errors.items()}


@contextmanager
def plain_banded_in_models():
    """Run WGATE's and GATE's attention through the plain versions of both
    kernels: the plain forward, and as its gradient the plain backward, which
    rounds where the backward kernel rounds (torch autograd of the plain
    forward would not round dS to bf16)."""
    import torch

    from sl_hwgat_tpu_torch.models import wgate
    from sl_hwgat_tpu_torch.ops.banded_attention import (
        plain_banded_attention,
        plain_banded_attention_bwd,
    )

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, band, scale, out_dtype):
            ctx.save_for_backward(q, k, v)
            ctx.band, ctx.scale = band, scale
            return plain_banded_attention(q, k, v, band, scale=scale, out_dtype=out_dtype)

        @staticmethod
        def backward(ctx, do):
            grads = plain_banded_attention_bwd(*ctx.saved_tensors, do, ctx.band, scale=ctx.scale)
            return (*grads, None, None, None)

    kernel = wgate.banded_attention
    wgate.banded_attention = lambda q, k, v, band, *, scale, out_dtype=None: Plain.apply(
        q, k, v, band, scale, out_dtype)
    try:
        yield
    finally:
        wgate.banded_attention = kernel


def banded_model(name: str, compute_dtype: str, **overrides):
    from sl_hwgat_tpu_torch.constants import DATASET_PARAMS
    from sl_hwgat_tpu_torch.models import build_model

    return build_model(name, DATASET_PARAMS["FDMSE-ISL"], 2, device="cuda", seed=SEED,
                       compute_dtype=compute_dtype, **overrides)


def banded_batch(name: str, batch: int = 16, train: bool = False):
    """A seeded FDMSE-ISL batch of ``name``'s joints: x, or (x, y, valid)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + (3 if train else 1))
    x = torch.rand(batch, 192, NUM_KPS[name], 2, generator=g, device="cuda")
    if not train:
        return x
    y = torch.randint(0, 2002, (batch,), generator=g, device="cuda")
    return x, y, torch.ones(batch, device="cuda")


def phase_banded_forward():
    import torch

    from sl_hwgat_tpu_torch.ops.banded_attention import banded_attention

    out = {}
    for name in BANDED_MODELS:
        x = banded_batch(name)
        for cdt in ("float32", "bfloat16"):
            model = banded_model(name, cdt)
            with torch.inference_mode():
                before = banded_attention.launches
                got = model(x)
                torch.cuda.synchronize()
                launches = banded_attention.launches - before
                with plain_banded_in_models():
                    want = model(x)
                torch.cuda.synchronize()
            if launches != 8:
                raise AssertionError(f"{name} {cdt} forward launched {launches} times, not 8")
            if got.shape != (16, 2002) or not torch.isfinite(got).all():
                raise AssertionError(f"{name} {cdt} logits: shape {tuple(got.shape)} or "
                                     "non-finite values")
            torch.testing.assert_close(got, want, **LOGIT_TOL[cdt])
            out[f"{name}/{cdt}"] = {"max_abs_diff": (got - want).abs().max().item(),
                                    "launches_per_forward": launches}
            del model
    emit("banded_forward", batch=16, frames=192, classes=2002, tolerance=LOGIT_TOL,
         results=out)


def phase_banded_serve(workdir: Path) -> int:
    """Main path 3: serving WGATE and GATE; returns the forward launches."""
    import numpy as np
    import torch

    from sl_hwgat_tpu_torch.ops.banded_attention import banded_attention
    from sl_hwgat_tpu_torch.serve import Predictor
    from sl_hwgat_tpu_torch.weights import save_state_dict

    rng = np.random.default_rng(SEED + 1)
    clips = [rng.random((int(f), 543, 4)).astype(np.float32)
             for f in rng.integers(96, 385, size=24)]
    out, total = {}, 0
    for name in BANDED_MODELS:
        ckpt = workdir / f"{name.lower()}_fdmse_isl.pt"
        save_state_dict(str(ckpt), banded_model(name, "float32"))
        t0 = time.perf_counter()
        pred = Predictor.from_checkpoint(str(ckpt), model_type=name, dataset="FDMSE-ISL")
        pred.warmup(clips[0])
        setup_s = time.perf_counter() - t0

        banded_attention.launches = 0
        rows, stats, serve_s = burst(pred, clips)
        launches = banded_attention.launches

        if launches != 8 * stats["batches"]:
            raise AssertionError(f"{name}: {launches} launches for {stats['batches']} batches")
        errs = []
        for clip, row in zip(clips, rows):
            want = pred.predict_logits([clip])[0]
            errs.append(float(np.abs(row - want).max()))
            if not (row.shape == (2002,) and np.isfinite(row).all() and errs[-1] <= 2e-4):
                raise AssertionError(f"{name}: served row differs from predict_logits by "
                                     f"{errs[-1]}")
        kps = pred.preprocess(clips[0]).shape[1]
        if kps != NUM_KPS[name]:
            raise AssertionError(f"{name} served {kps}-joint clips")
        pred.close()
        out[name] = {"requests": stats["requests"], "batches": stats["batches"],
                     "batch_sizes": stats["batch_sizes"], "launches": launches,
                     "joints": kps, "max_abs_err": max(errs), "setup_s": setup_s,
                     "serve_s": serve_s, "clips_per_s": len(clips) / serve_s}
        total += launches
        del pred
        torch.cuda.empty_cache()
    emit("banded_serve", results=out)
    return total


def phase_banded_train() -> dict:
    """Gradients against the plain attention, then main path 4: ten AdamW
    steps per model and type. Returns the launches of the AdamW runs."""
    import torch

    from sl_hwgat_tpu_torch.ops.banded_attention import banded_attention, banded_attention_bwd
    from sl_hwgat_tpu_torch.train.loop import make_steps
    from sl_hwgat_tpu_torch.train.state import make_optimizer

    out, total = {}, {"fwd": 0, "bwd": 0}
    for name in BANDED_MODELS:
        x, y, valid = banded_batch(name, train=True)
        for cdt in ("float32", "bfloat16"):
            model = banded_model(name, cdt, drop_rate=0.0)
            fwd0, bwd0 = banded_attention.launches, banded_attention_bwd.launches
            loss, grads = one_step_grads(model, x, y, valid, seed=SEED)
            torch.cuda.synchronize()
            launches = (banded_attention.launches - fwd0, banded_attention_bwd.launches - bwd0)
            if launches != (8, 8):
                raise AssertionError(f"{name} {cdt} step launched (fwd, bwd) = {launches}")
            loss2, grads2 = one_step_grads(model, x, y, valid, seed=SEED)
            if loss2 != loss or not all(torch.equal(grads[k], grads2[k]) for k in grads):
                raise AssertionError(f"{name} {cdt}: a step does not repeat bit for bit")
            del grads2
            with plain_banded_in_models():
                plain_loss, plain = one_step_grads(model, x, y, valid, seed=SEED)
            worst = grad_errors(f"{name} {cdt}", cdt, grads, plain)
            del grads, plain, model

            model = banded_model(name, cdt)
            opt = make_optimizer("adamw", LR, model.parameters())
            train_step, _ = make_steps(model, opt)
            banded_attention.launches = banded_attention_bwd.launches = 0
            losses = [train_step(x, y, valid, SEED, 0, step)[0].item() for step in range(10)]
            torch.cuda.synchronize()
            run = {"fwd": banded_attention.launches, "bwd": banded_attention_bwd.launches}
            if run != {"fwd": 80, "bwd": 80}:
                raise AssertionError(f"{name} {cdt}: ten steps launched {run}")
            if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
                raise AssertionError(f"{name} {cdt} AdamW losses: {losses}")
            for kind in total:
                total[kind] += run[kind]
            out[f"{name}/{cdt}"] = {
                "loss_kernels": loss, "loss_plain": plain_loss,
                "launches_per_step": {"fwd": launches[0], "bwd": launches[1]},
                "step_repeats_bit_for_bit": True,
                "grad_err_worst": max(worst.values()),
                "grad_err_worst_param": max(worst, key=worst.get),
                "grad_err_metric": "max abs" if cdt == "float32" else "rel norm",
                "params_with_grad": len(worst), "adamw_losses": losses, "adamw_launches": run}
            del model, opt, train_step
            torch.cuda.empty_cache()
    emit("banded_train", batch=16, frames=192, classes=2002, lr=LR,
         tolerance={"float32": GRAD_ATOL_F32, "bfloat16": GRAD_REL_BF16}, results=out)
    return total


# ---------------------------------------------------------------------------
# The hybrid attention (K7) and HGATE (phases 14-17).

# (model, attn_impl) of the windowed paths this section drives: HWGATE's
# hybrid attention, and HGATE on its default (fused K1/K2 at 58 tokens) and
# hybrid paths.
WINDOWED_PATHS = (("HWGATE", "hybrid"), ("HGATE", "auto"), ("HGATE", "hybrid"))


def scores_of(q, k, scale: float):
    """The hybrid path's f32 scores (q·T(scale))·kᵀ of (U, N, dh) units."""
    import torch

    scaled = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    return torch.bmm(scaled.float(), k.float().transpose(1, 2))


def softmax_kwargs(kw: dict) -> dict:
    """The masked softmax's arguments out of the attention's."""
    return {k: v for k, v in kw.items() if k not in ("scale", "pad_tokens")}


def phase_masked_softmax():
    """K7 forward and backward against their plain versions at HWGATE's
    (12288 × 32 × 32) and HGATE's (3072 × 58 × 58) scores, and the hybrid
    attention through K7 against the fused kernel K1 (one function)."""
    import torch

    from sl_hwgat_tpu_torch.ops.hybrid_attention import (
        hybrid_window_attention,
        masked_softmax,
        masked_softmax_bwd,
        plain_masked_softmax,
        plain_masked_softmax_bwd,
    )
    from sl_hwgat_tpu_torch.ops.window_attention import window_attention

    fwd_err, bwd_err, hybrid_err = {}, {}, {}
    for model in ("HWGATE", "HGATE"):
        adj, tail = masks(model)
        for dtype in (torch.float32, torch.bfloat16):
            name = dtype_name(dtype)
            q, k, v = attention_inputs(dtype, model)
            g = torch.Generator(device="cuda").manual_seed(SEED + 5)
            for dual in (False, True):
                # HGATE trains without pruning
                for prune_u in ((None, 0.3) if model == "HWGATE" else (None,)):
                    kw = attention_kwargs(dual, prune_u, tail, model)
                    skw = softmax_kwargs(kw)
                    case = f"{model}/{'dual' if dual else 'single'}/prune={prune_u}/{name}"
                    s = scores_of(q, k, kw["scale"])
                    got = masked_softmax(s, adj, p_dtype=dtype, **skw)
                    want = plain_masked_softmax(s, adj, p_dtype=dtype, **skw)
                    torch.cuda.synchronize()
                    fwd_err[case] = (got.float() - want.float()).abs().max().item()
                    if got.dtype != dtype or not fwd_err[case] <= TOL[name]:
                        raise AssertionError(f"masked softmax vs plain {case}: max abs err "
                                             f"{fwd_err[case]} > {TOL[name]}")
                    dp = (torch.randn(s.shape, generator=g, device="cuda") * 0.2).to(dtype)
                    got = masked_softmax_bwd(s, dp, adj, **skw)
                    want = plain_masked_softmax_bwd(s, dp, adj, **skw)
                    torch.cuda.synchronize()
                    tol = BWD_TOL[name]
                    diff = (got - want).abs()
                    bwd_err[case] = diff.max().item()
                    excess = (diff - tol["atol"] - tol["rtol"] * want.abs()).max().item()
                    if got.dtype != torch.float32 or not excess <= 0:
                        raise AssertionError(f"masked softmax backward vs plain {case}: max abs "
                                             f"err {bwd_err[case]} over {tol}")
                    got = hybrid_window_attention(q, k, v, adj, **kw)
                    want = window_attention(q, k, v, adj, **kw)
                    torch.cuda.synchronize()
                    hybrid_err[case] = (got - want).abs().max().item()
                    if not hybrid_err[case] <= TOL[name]:
                        raise AssertionError(f"hybrid vs fused attention {case}: max abs err "
                                             f"{hybrid_err[case]} > {TOL[name]}")
                    del s, dp, got, want
            del q, k, v
    # the autograd Function's gradient is the backward kernel's
    adj, tail = masks("HGATE")
    q, k, _ = attention_inputs(torch.float32, "HGATE")
    kw = softmax_kwargs(attention_kwargs(True, None, tail, "HGATE"))
    s = scores_of(q, k, HEAD_DIM**-0.5).requires_grad_()
    dp = torch.randn(s.shape, generator=torch.Generator(device="cuda").manual_seed(SEED),
                     device="cuda")
    masked_softmax(s, adj, **kw).backward(dp)
    if not torch.equal(s.grad, masked_softmax_bwd(s.detach(), dp, adj, **kw)):
        raise AssertionError("masked softmax autograd differs from a direct backward call")
    emit("masked_softmax", scores={m: [u, n, n] for m, (u, n, _) in WINDOW_SHAPE.items()},
         tolerance={"fwd": TOL, "bwd": BWD_TOL, "hybrid_vs_fused": TOL},
         fwd_max_abs_err=fwd_err, bwd_max_abs_err=bwd_err, hybrid_vs_fused_max_abs_err=hybrid_err,
         autograd_equals_kernel=True)
    return fwd_err, bwd_err


def path_kernels(impl: str):
    """((forward, backward) counters of the kernels ``impl`` runs, the same
    pair of the other path), each a function with a ``launches`` count."""
    from sl_hwgat_tpu_torch.ops.hybrid_attention import masked_softmax, masked_softmax_bwd
    from sl_hwgat_tpu_torch.ops.window_attention import window_attention, window_attention_bwd

    fused, hybrid = (window_attention, window_attention_bwd), (masked_softmax, masked_softmax_bwd)
    return (hybrid, fused) if impl == "hybrid" else (fused, hybrid)


def reset_launches(*counters) -> None:
    for c in counters:
        c.launches = 0


@contextmanager
def plain_path(impl: str):
    """Run a windowed model's attention through the plain versions: the
    plain fused attention ("auto"), or the plain masked softmax between the
    same GEMMs ("hybrid"); torch differentiates both."""
    from sl_hwgat_tpu_torch.ops import hybrid_attention

    if impl != "hybrid":
        with plain_attention_in_model():
            yield
        return
    kernel = hybrid_attention.masked_softmax
    hybrid_attention.masked_softmax = hybrid_attention.plain_masked_softmax
    try:
        yield
    finally:
        hybrid_attention.masked_softmax = kernel


def windowed_model(name: str, impl: str, compute_dtype: str, **overrides):
    from sl_hwgat_tpu_torch.constants import DATASET_PARAMS
    from sl_hwgat_tpu_torch.models import build_model

    return build_model(name, DATASET_PARAMS["FDMSE-ISL"], 2, device="cuda", seed=SEED,
                       attn_impl=impl, compute_dtype=compute_dtype, **overrides)


def phase_windowed_forward():
    import torch

    out = {}
    for name, impl in WINDOWED_PATHS:
        x = banded_batch(name)
        (fwd, _), (other, _) = path_kernels(impl)
        for cdt in ("float32", "bfloat16"):
            model = windowed_model(name, impl, cdt)
            with torch.inference_mode():
                reset_launches(fwd, other)
                got = model(x)
                torch.cuda.synchronize()
                launches, other_launches = fwd.launches, other.launches
                with plain_path(impl):
                    want = model(x)
                torch.cuda.synchronize()
            case = f"{name}/{impl}/{cdt}"
            if launches != 8 or other_launches != 0:
                raise AssertionError(f"{case} forward launched {launches} times (the other "
                                     f"path's kernel {other_launches}), not 8 (0)")
            if got.shape != (16, 2002) or not torch.isfinite(got).all():
                raise AssertionError(f"{case} logits: shape {tuple(got.shape)} or non-finite")
            torch.testing.assert_close(got, want, **LOGIT_TOL[cdt])
            out[case] = {"max_abs_diff": (got - want).abs().max().item(),
                         "launches_per_forward": launches, "other_path_launches": other_launches}
            del model
    emit("windowed_forward", batch=16, frames=192, classes=2002, tolerance=LOGIT_TOL,
         results=out)


def phase_windowed_serve(workdir: Path) -> dict:
    """Main paths 5-7: serving HWGATE hybrid, HGATE and HGATE hybrid; returns
    the forward launches by kernel."""
    import numpy as np
    import torch

    from sl_hwgat_tpu_torch.serve import Predictor
    from sl_hwgat_tpu_torch.weights import save_state_dict

    rng = np.random.default_rng(SEED + 2)
    clips = [rng.random((int(f), 543, 4)).astype(np.float32)
             for f in rng.integers(96, 385, size=24)]
    out, total = {}, {}
    for name, impl in WINDOWED_PATHS:
        ckpt = workdir / f"{name.lower()}_{impl}_fdmse_isl.pt"
        save_state_dict(str(ckpt), windowed_model(name, impl, "float32"))
        t0 = time.perf_counter()
        pred = Predictor.from_checkpoint(str(ckpt), model_type=name, dataset="FDMSE-ISL",
                                         attn_impl=impl)
        pred.warmup(clips[0])
        setup_s = time.perf_counter() - t0
        (fwd, _), (other, _) = path_kernels(impl)

        reset_launches(fwd, other)
        rows, stats, serve_s = burst(pred, clips)
        launches, other_launches = fwd.launches, other.launches

        case = f"{name}/{impl}"
        if launches != 8 * stats["batches"] or other_launches != 0:
            raise AssertionError(f"{case}: {launches} launches ({other_launches} of the other "
                                 f"path) for {stats['batches']} batches")
        errs = []
        for clip, row in zip(clips, rows):
            want = pred.predict_logits([clip])[0]
            errs.append(float(np.abs(row - want).max()))
            if not (row.shape == (2002,) and np.isfinite(row).all() and errs[-1] <= 2e-4):
                raise AssertionError(f"{case}: served row differs from predict_logits by "
                                     f"{errs[-1]}")
        kps = pred.preprocess(clips[0]).shape[1]
        if kps != NUM_KPS[name]:
            raise AssertionError(f"{case} served {kps}-joint clips")
        pred.close()
        out[case] = {"requests": stats["requests"], "batches": stats["batches"],
                     "batch_sizes": stats["batch_sizes"], "kernel": fwd.__name__,
                     "launches": launches, "joints": kps, "max_abs_err": max(errs),
                     "setup_s": setup_s, "serve_s": serve_s, "clips_per_s": len(clips) / serve_s}
        total[fwd.__name__] = total.get(fwd.__name__, 0) + launches
        del pred
        torch.cuda.empty_cache()
    emit("windowed_serve", results=out)
    return total


def phase_windowed_train() -> dict:
    """Gradients against the plain path, then main paths 8-10: ten AdamW
    steps per path and type. Returns the launches of the AdamW runs by
    kernel."""
    import torch

    from sl_hwgat_tpu_torch.train.loop import make_steps
    from sl_hwgat_tpu_torch.train.state import make_optimizer

    out, total = {}, {}
    for name, impl in WINDOWED_PATHS:
        x, y, valid = banded_batch(name, train=True)
        (fwd, bwd), (ofwd, obwd) = path_kernels(impl)
        for cdt in ("float32", "bfloat16"):
            case = f"{name}/{impl}/{cdt}"
            model = windowed_model(name, impl, cdt, drop_rate=0.0)
            reset_launches(fwd, bwd, ofwd, obwd)
            loss, grads = one_step_grads(model, x, y, valid, seed=SEED)
            torch.cuda.synchronize()
            launches = (fwd.launches, bwd.launches, ofwd.launches + obwd.launches)
            if launches != (8, 8, 0):
                raise AssertionError(f"{case} step launched (fwd, bwd, other path) = {launches}")
            with plain_path(impl):
                plain_loss, plain = one_step_grads(model, x, y, valid, seed=SEED)
            worst = grad_errors(case, cdt, grads, plain)
            del grads, plain, model

            model = windowed_model(name, impl, cdt)
            opt = make_optimizer("adamw", LR, model.parameters())
            train_step, _ = make_steps(model, opt)
            reset_launches(fwd, bwd, ofwd, obwd)
            losses = [train_step(x, y, valid, SEED, 0, step)[0].item() for step in range(10)]
            torch.cuda.synchronize()
            run = {"fwd": fwd.launches, "bwd": bwd.launches,
                   "other_path": ofwd.launches + obwd.launches}
            if run != {"fwd": 80, "bwd": 80, "other_path": 0}:
                raise AssertionError(f"{case}: ten steps launched {run}")
            if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
                raise AssertionError(f"{case} AdamW losses: {losses}")
            for c, n in ((fwd, run["fwd"]), (bwd, run["bwd"])):
                total[c.__name__] = total.get(c.__name__, 0) + n
            out[case] = {"loss_kernels": loss, "loss_plain": plain_loss,
                         "launches_per_step": {"fwd": launches[0], "bwd": launches[1]},
                         "grad_err_worst": max(worst.values()),
                         "grad_err_worst_param": max(worst, key=worst.get),
                         "grad_err_metric": "max abs" if cdt == "float32" else "rel norm",
                         "params_with_grad": len(worst), "adamw_losses": losses,
                         "adamw_launches": run}
            del model, opt, train_step
            torch.cuda.empty_cache()
    emit("windowed_train", batch=16, frames=192, classes=2002, lr=LR,
         tolerance={"float32": GRAD_ATOL_F32, "bfloat16": GRAD_REL_BF16}, results=out)
    return total


# Operations per score entry of the masked softmax (f32, CUDA cores):
# forward the prune softmax (max, subtract, exp, sum, divide, compare), the
# mask (select, compare) and the softmax (max, subtract, exp, sum, divide);
# backward the same plus the product, the row sum, the difference, the
# product and the gate.
SOFTMAX_OPS = {"fwd": 13, "bwd": 18}


def softmax_bound(kind: str, dtype_name: str, model: str) -> tuple[float, str]:
    """(least ms on an H100 SXM, what bounds it) for one masked-softmax call
    at ``model``'s scores: S (f32) read and P (v's type) written once; the
    backward reads S and dP (P's type) and writes dS (f32) once."""
    units, tokens, _ = WINDOW_SHAPE[model]
    entries = units * tokens * tokens
    elem = 4 if dtype_name == "float32" else 2
    nbytes = entries * (4 + elem if kind == "fwd" else 4 + elem + 4)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = entries * SOFTMAX_OPS[kind] / PEAK_FLOPS["float32"] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def phase_windowed_timings() -> dict:
    """K1/K2 at HGATE's 58-token units and K7 at both models' scores: kernel,
    plain, bound and library ms; the hybrid attention against the fused
    kernels per call; eval forward and train step of every windowed path."""
    import torch

    from sl_hwgat_tpu_torch.ops.attention import masked_scores, unit_allowed
    from sl_hwgat_tpu_torch.ops.hybrid_attention import (
        hybrid_window_attention,
        masked_softmax,
        masked_softmax_bwd,
        plain_masked_softmax,
        plain_masked_softmax_bwd,
    )
    from sl_hwgat_tpu_torch.ops.window_attention import (
        plain_window_attention,
        plain_window_attention_bwd,
        window_attention,
        window_attention_bwd,
    )

    wide = {"fwd": {}, "bwd": {}}
    softmax = {"fwd": {}, "bwd": {}}
    versus = {}
    for model in ("HWGATE", "HGATE"):
        adj, tail = masks(model)
        additive = torch.where(torch.from_numpy(adj) != 0, 0.0, -1e4).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            name = dtype_name(dtype)
            key = f"{model}/{name}"
            q, k, v = attention_inputs(dtype, model)
            do = output_grad(dtype, model)
            kw = attention_kwargs(False, None, tail, model)
            skw = softmax_kwargs(kw)
            if model == "HGATE":  # K1/K2 at 58-token units
                fwd, bwd = {}, {}
                for dual in (False, True):
                    dkw = attention_kwargs(dual, None, tail, model)
                    case = "dual" if dual else "single"
                    fwd[case] = {
                        "ms": cuda_ms(lambda: window_attention(q, k, v, adj, out_dtype=dtype,
                                                               **dkw)),
                        "plain_ms": cuda_ms(lambda: plain_window_attention(
                            q, k, v, adj, out_dtype=dtype, **dkw), runs=10)}
                    bwd[case] = {
                        "ms": cuda_ms(lambda: window_attention_bwd(q, k, v, do, adj, **dkw)),
                        "plain_ms": cuda_ms(lambda: plain_window_attention_bwd(
                            q, k, v, do, adj, **dkw), runs=5)}
                library = sdpa_ms(q, k, v, do, additive.to(dtype)[None, None])
                for kind, cases, lib in (("fwd", fwd, library[0]), ("bwd", bwd, library[1])):
                    bound_ms, bound_by = bound(kind, name, model)
                    wide[kind][key] = {"cases": cases, "library_ms": lib, "bound_ms": bound_ms,
                                       "bound_by": bound_by}
            # K7, single mask (the library call's function), with the library
            # yardstick: one softmax call over the already-masked scores, and
            # the softmax backward of its output
            s = scores_of(q, k, kw["scale"])
            dp = (torch.randn(s.shape, generator=torch.Generator(device="cuda").manual_seed(SEED),
                              device="cuda") * 0.2).to(dtype)
            masked = masked_scores(s, unit_allowed(adj, None, None, s.shape[0], kw["stack"],
                                                   s.device), zero_quirk=True, prune_u=None)
            p32 = torch.softmax(masked, -1)
            dp32 = dp.float()
            library = {
                "fwd": cuda_ms(lambda: torch.softmax(masked, -1)),
                "bwd": cuda_ms(lambda: torch.ops.aten._softmax_backward_data(
                    dp32, p32, -1, torch.float32))}
            cases = {
                "fwd": {"ms": cuda_ms(lambda: masked_softmax(s, adj, p_dtype=dtype, **skw)),
                        "plain_ms": cuda_ms(lambda: plain_masked_softmax(
                            s, adj, p_dtype=dtype, **skw), runs=10)},
                "bwd": {"ms": cuda_ms(lambda: masked_softmax_bwd(s, dp, adj, **skw)),
                        "plain_ms": cuda_ms(lambda: plain_masked_softmax_bwd(s, dp, adj, **skw),
                                            runs=10)},
            }
            for kind in ("fwd", "bwd"):
                bound_ms, bound_by = softmax_bound(kind, name, model)
                softmax[kind][key] = {**cases[kind], "library_ms": library[kind],
                                      "bound_ms": bound_ms, "bound_by": bound_by}
            del s, dp, masked, p32, dp32
            # the whole hybrid attention against the fused kernels, per call,
            # shifted blocks' dual mask (the models' larger share)
            dkw = attention_kwargs(True, None, tail, model)
            leaves = tuple(t.detach().requires_grad_() for t in (q, k, v))

            def both(fn):
                return lambda: torch.autograd.grad(fn(*leaves, adj, **dkw), leaves, do)

            with torch.no_grad():
                versus[key] = {
                    "hybrid_fwd_ms": cuda_ms(lambda: hybrid_window_attention(q, k, v, adj, **dkw)),
                    "fused_fwd_ms": cuda_ms(lambda: window_attention(q, k, v, adj, **dkw))}
            versus[key]["hybrid_fwd_bwd_ms"] = cuda_ms(both(hybrid_window_attention), runs=20)
            versus[key]["fused_fwd_bwd_ms"] = cuda_ms(both(window_attention), runs=20)
            del q, k, v, do, leaves
            torch.cuda.empty_cache()
    emit("windowed_timings", shapes={m: list(s) for m, s in WINDOW_SHAPE.items()},
         window_attention=wide, masked_softmax=softmax, hybrid_vs_fused=versus,
         note="K1/K2 library_ms: scaled_dot_product_attention per 58-token unit with the "
              "adjacency as an additive mask (backward as fwd+bwd minus fwd); masked_softmax "
              "library_ms: torch.softmax over the already-masked f32 scores (backward: "
              "aten._softmax_backward_data of its output); timed only. hybrid_vs_fused: "
              "one attention call (dual mask, f32 output), forward and forward+backward")

    results = {}
    for name, impl in WINDOWED_PATHS:
        for cdt in ("float32", "bfloat16"):
            model = windowed_model(name, impl, cdt)
            with torch.inference_mode():
                x = banded_batch(name)
                ms = cuda_ms(lambda: model(x), runs=20, inner=1)
            step_ms = train_step_ms(model, *banded_batch(name, train=True))
            results[f"{name}/{impl}/{cdt}"] = {
                "forward_ms": ms, "clips_per_s": 16 / ms * 1e3, "train_step_ms": step_ms,
                "train_clips_per_s": 16 / step_ms * 1e3}
            del model
            torch.cuda.empty_cache()
    emit("windowed_eval_train", batch=16, frames=192, results=results)
    return {"window_attention": wide, "masked_softmax": softmax}


# Per unit: tensors of N × HEAD_DIM that a call reads and writes once, and
# N × N × HEAD_DIM products it does. forward: q, k, v → o; S = QKᵀ, O = AV.
# backward: q, k, v, dO → dq, dk, dv; S, dA = dO Vᵀ, dV = Aᵀ dO, dQ = dS K,
# dK = dSᵀ Q.
WORK = {"fwd": (4, 2), "bwd": (7, 5)}


def bound(kind: str, dtype_name: str, model: str = "HWGATE") -> tuple[float, str]:
    """(least ms on an H100 SXM, what bounds it) for one call at ``model``'s
    shape: bytes over the memory rate or operations over the peak rate of
    the type (f32: CUDA cores; bf16: dense tensor cores). The padding of
    HGATE's units is not work: 58 tokens, not 64."""
    units, tokens, head_dim = WINDOW_SHAPE[model]
    tensors, products = WORK[kind]
    elem = 4 if dtype_name == "float32" else 2
    bytes_ms = tensors * units * tokens * head_dim * elem / PEAK_BYTES_PER_S * 1e3
    flops = products * 2 * tokens * tokens * head_dim * units
    ops_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def sdpa_ms(q, k, v, do, mask, scale: float = HEAD_DIM**-0.5, runs: int = 30,
            backends=None):
    """(forward ms, backward ms) of masked scaled_dot_product_attention on the
    same units, the backward as (forward + backward) − forward. Timed only.
    ``backends``: the SDPA backends it may use (default: PyTorch's choice)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    qg, kg, vg = (t[:, None].detach().requires_grad_() for t in (q, k, v))
    do4 = do[:, None]

    def fwd():
        return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, scale=scale)

    with sdpa_kernel(backends) if backends else nullcontext():
        with torch.no_grad():
            fwd_ms = cuda_ms(fwd, runs=runs)
        grad_fwd_ms = cuda_ms(fwd, runs=runs)
        both_ms = cuda_ms(lambda: torch.autograd.grad(fwd(), (qg, kg, vg), do4),
                          runs=max(runs * 2 // 3, 5))
    return fwd_ms, both_ms - grad_fwd_ms


def train_step_ms(model, x, y, valid, steps: int = 10) -> float:
    """Median ms of one train step of ``model`` on a batch (forward,
    backward, AdamW), by CUDA events around each step."""
    import torch

    from sl_hwgat_tpu_torch.train.loop import make_steps
    from sl_hwgat_tpu_torch.train.state import make_optimizer

    train_step, _ = make_steps(model, make_optimizer("adamw", LR, model.parameters()))
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

    results = {}
    for name in ("HWGATE", *BANDED_MODELS):
        for cdt in ("float32", "bfloat16"):
            model = build(name, cdt)
            with torch.inference_mode():
                x = banded_batch(name) if name in BANDED_MODELS else eval_batch()
                ms = cuda_ms(lambda: model(x), runs=20, inner=1)  # one request's forward
            batch = banded_batch(name, train=True) if name in BANDED_MODELS else train_batch()
            step_ms = train_step_ms(model, *batch)
            key = cdt if name == "HWGATE" else f"{name}/{cdt}"
            results[key] = {"forward_ms": ms, "clips_per_s": 16 / ms * 1e3,
                            "train_step_ms": step_ms, "train_clips_per_s": 16 / step_ms * 1e3}
            del model
            torch.cuda.empty_cache()
    emit("eval_train", batch=16, frames=192, results=results)
    return kernels


def build(name: str, cdt: str):
    """The FDMSE-ISL model ``name`` on the card, seeded."""
    return flagship(cdt) if name == "HWGATE" else banded_model(name, cdt)


def dense_band_mask(band, frames: int):
    """The (F·V, F·V) additive block-tridiagonal mask of ``band`` that the
    reference's dense attention applies (`WGATE.py:94-104`)."""
    import numpy as np

    nv = band.shape[1]
    m = np.full((frames * nv, frames * nv), -1e4, np.float32)
    for f in range(frames):
        for p, g in ((0, f - 1), (1, f), (2, f + 1)):
            if 0 <= g < frames:
                m[f * nv:(f + 1) * nv, g * nv:(g + 1) * nv] = band[p]
    return m


def banded_bound(kind: str, dtype_name: str, model: str, band) -> tuple[float, str]:
    """(least ms on an H100 SXM, what bounds it) for one banded call at
    ``model``'s shape: q, k, v (and dO) read once and o (f32) or dq, dk, dv
    written once, against the operations this band's edges need (per edge
    two dh-long dots forward, five backward)."""
    planes, frames, joints = BANDED_SHAPE[model]
    elems = planes * frames * joints * BANDED_DH
    elem = 4 if dtype_name == "float32" else 2
    nbytes = elems * (3 * elem + 4) if kind == "fwd" else 7 * elems * elem
    e = band == 0
    edges = planes * (frames * int(e[1].sum()) + (frames - 1) * int(e[0].sum() + e[2].sum()))
    flops = edges * 2 * BANDED_DH * (2 if kind == "fwd" else 5)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def phase_banded_timings() -> dict:
    """Kernel, plain, bound and library ms of the banded kernels at WGATE's
    and GATE's shapes; the kernels under the non-diagonal band beside."""
    import torch
    from torch.nn.attention import SDPBackend

    from sl_hwgat_tpu_torch.ops.banded_attention import (
        banded_attention,
        banded_attention_bwd,
        plain_banded_attention,
        plain_banded_attention_bwd,
    )

    bands = banded_bands()
    out = {"fwd": {}, "bwd": {}}
    for model in BANDED_MODELS:
        band, spatial = bands[model]["identity"], bands[model]["spatial"]
        dense = torch.from_numpy(dense_band_mask(band, BANDED_SHAPE[model][1])).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            name = dtype_name(dtype)
            q, k, v, do = banded_inputs(model, dtype)
            kw = dict(scale=BANDED_SCALE)
            cases = {
                "fwd": {
                    "ms": cuda_ms(lambda: banded_attention(q, k, v, band, **kw)),
                    "nondiagonal_band_ms": cuda_ms(
                        lambda: banded_attention(q, k, v, spatial, **kw)),
                    "plain_ms": cuda_ms(lambda: plain_banded_attention(q, k, v, band, **kw),
                                        runs=10)},
                "bwd": {
                    "ms": cuda_ms(lambda: banded_attention_bwd(q, k, v, do, band, **kw)),
                    "nondiagonal_band_ms": cuda_ms(
                        lambda: banded_attention_bwd(q, k, v, do, spatial, **kw)),
                    "plain_ms": cuda_ms(
                        lambda: plain_banded_attention_bwd(q, k, v, do, band, **kw), runs=5)},
            }
            # the reference's dense masked attention over the whole F·V
            # sequence, through the memory-efficient backend: the dense score
            # matrix alone would take 15-19 GB
            library = sdpa_ms(q, k, v, do, dense.to(dtype)[None, None], scale=BANDED_SCALE,
                              runs=5, backends=[SDPBackend.EFFICIENT_ATTENTION])
            for kind, lib in zip(("fwd", "bwd"), library):
                bound_ms, bound_by = banded_bound(kind, name, model, band)
                out[kind][f"{model}/{name}"] = {**cases[kind], "library_ms": lib,
                                                "bound_ms": bound_ms, "bound_by": bound_by}
            del q, k, v, do
            torch.cuda.empty_cache()
    emit("banded_timings", shapes={m: [*BANDED_SHAPE[m], BANDED_DH] for m in BANDED_MODELS},
         kernels=out,
         note="library_ms: scaled_dot_product_attention (memory-efficient backend) over the "
              "whole F·V sequence with the dense block-tridiagonal additive mask (its backward "
              "as fwd+bwd minus fwd), timed only; nondiagonal_band_ms: the kernel under the "
              "spatial plane as prev/next")
    return out


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
    f32 and bf16, of every model and windowed path, with the wall time of
    the profiled step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sl_hwgat_tpu_torch.train.loop import make_steps
    from sl_hwgat_tpu_torch.train.state import make_optimizer

    out = {}
    for name, impl in [(m, None) for m in ("HWGATE", *BANDED_MODELS)] + list(WINDOWED_PATHS):
        # banded_batch("HWGATE") is eval_batch() / train_batch(): same seeds and shapes
        x = banded_batch(name)
        xt, yt, valid = banded_batch(name, train=True)
        for cdt in ("float32", "bfloat16"):
            if impl is None:
                key = cdt if name == "HWGATE" else f"{name}/{cdt}"
                model = build(name, cdt)
            else:
                key = f"{name}/{impl}/{cdt}"
                model = windowed_model(name, impl, cdt)
            with torch.inference_mode():
                model(x)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    model(x)
                    torch.cuda.synchronize()
            out[f"eval/{key}"] = device_table(prof)
            train_step, _ = make_steps(model, make_optimizer("adamw", LR, model.parameters()))
            for step in range(2):
                train_step(xt, yt, valid, SEED, 0, step)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                train_step(xt, yt, valid, SEED, 0, 2)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            out[f"train/{key}"] = {**device_table(prof), "wall_ms_profiled": wall_ms}
            del model, train_step
            torch.cuda.empty_cache()
    emit("profile", batch=16, results=out)


def kernel_entry(kind: str, name: str, replaces: str, launches: int, timings: dict,
                 errors: dict) -> dict:
    """One entry of the kernels line: HWGATE's f32 numbers at the top level
    (the serving path's type), bf16 under "bfloat16", HGATE's 58-token units
    under "HGATE/<dtype>"; single-mask times (the function the masked-SDPA
    yardstick computes too), dual-mask beside."""
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


def case_entry(kind: str, name: str, replaces: str, launches: int, timings: dict,
               errors: dict, top: str) -> dict:
    """One entry of the kernels line from timings by "<model>/<dtype>" case:
    the ``top`` case's numbers at the top level (the serving path's model and
    type), the others under their case; max_abs_err over the error cases of
    that model and type (errors keyed "<model>/.../<dtype>")."""
    entry = {"name": name, "route": "cuda", "source": f"sl_hwgat_tpu_torch/csrc/{name}.cu",
             "replaces": replaces, "launches": launches}
    for case, t in timings[kind].items():
        model, dt = case.split("/")
        fields = {"ms": t["ms"], "kernel_ms": t["ms"], **t,
                  "max_abs_err": max(e for c, e in errors.items()
                                     if c.startswith(model + "/") and c.endswith(dt))}
        if case == top:
            entry.update(fields)
        else:
            entry[case] = fields
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
    fwd_errors.update(phase_kernel("HGATE"))
    bwd_errors.update(phase_backward("HGATE"))
    phase_forward()
    with tempfile.TemporaryDirectory() as tmp:
        serve_launches = phase_serve(Path(tmp))
    phase_train()
    with tempfile.TemporaryDirectory() as tmp:
        train_launches = phase_synth(Path(tmp))
    banded_fwd_errors, banded_bwd_errors = phase_banded()
    phase_banded_forward()
    with tempfile.TemporaryDirectory() as tmp:
        banded_serve_launches = phase_banded_serve(Path(tmp))
    banded_train_launches = phase_banded_train()
    softmax_fwd_errors, softmax_bwd_errors = phase_masked_softmax()
    phase_windowed_forward()
    with tempfile.TemporaryDirectory() as tmp:
        windowed_serve_launches = phase_windowed_serve(Path(tmp))
    windowed_train_launches = phase_windowed_train()
    timings = phase_timings()
    banded_timings = phase_banded_timings()
    windowed_timings = phase_windowed_timings()
    for kind in ("fwd", "bwd"):
        timings[kind].update(windowed_timings["window_attention"][kind])
    phase_profile()

    from sl_hwgat_tpu_torch.ops import banded_attention, hybrid_attention, window_attention

    # launches of the main paths: the serving bursts and the AdamW/SYNTH runs
    served, trained = windowed_serve_launches, windowed_train_launches
    fwd = kernel_entry("fwd", window_attention.KERNEL,
                       "sl_hwgat_tpu/ops/pallas_attention.py:241 (_fwd_kernel)",
                       serve_launches + served["window_attention"], timings, fwd_errors)
    fwd["hgate_serve_launches"] = served["window_attention"]
    fwd["train_launches"] = train_launches["fwd"] + trained["window_attention"]
    bwd = kernel_entry("bwd", window_attention.KERNEL_BWD,
                       "sl_hwgat_tpu/ops/pallas_attention.py:295 (_bwd_kernel)",
                       train_launches["bwd"] + trained["window_attention_bwd"], timings,
                       bwd_errors)
    bwd["hgate_train_launches"] = trained["window_attention_bwd"]
    bfwd = case_entry("fwd", banded_attention.KERNEL,
                      "sl_hwgat_tpu/ops/pallas_banded.py:408 (_fwd_kernel_packed); "
                      ":129 (_fwd_kernel)",
                      banded_serve_launches, banded_timings, banded_fwd_errors, "WGATE/float32")
    bfwd["train_launches"] = banded_train_launches["fwd"]
    bbwd = case_entry("bwd", banded_attention.KERNEL_BWD,
                      "sl_hwgat_tpu/ops/pallas_banded.py:427 (_bwd_kernel_packed); "
                      ":146 (_bwd_kernel)",
                      banded_train_launches["bwd"], banded_timings, banded_bwd_errors,
                      "WGATE/float32")
    softmax_timings = windowed_timings["masked_softmax"]
    sfwd = case_entry("fwd", hybrid_attention.KERNEL,
                      "sl_hwgat_tpu/ops/hybrid_attention.py:46 (_softmax_fwd_kernel)",
                      served["masked_softmax"], softmax_timings, softmax_fwd_errors,
                      "HWGATE/float32")
    sfwd["train_launches"] = trained["masked_softmax"]
    sbwd = case_entry("bwd", hybrid_attention.KERNEL_BWD,
                      "sl_hwgat_tpu/ops/hybrid_attention.py:61 (_softmax_bwd_kernel)",
                      trained["masked_softmax_bwd"], softmax_timings, softmax_bwd_errors,
                      "HWGATE/float32")
    print(json.dumps({"kernels": [fwd, bwd, bfwd, bbwd, sfwd, sbwd]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
