"""Tracing, timing and roofline accounting of the port on an H100.

Counterpart of ``sl_hwgat_tpu/utils/profiling.py``: ``trace`` records a
``torch.profiler`` Chrome trace of a block of work, ``timeit`` times a
function on the card with CUDA events, ``device_seconds`` times it with the
card's queue kept full, and the cost arithmetic (``AttentionCost``,
``window_attention_cost``, ``hwgate_forward_cost``,
``banded_attention_cost``) counts the work of the attention calls, equal to
the JAX package's; ``hwgate_step_roofline`` is the JAX package's analytic
speed of light of a whole HWGATE train or eval step, at the card's peaks.
``bound`` turns bytes and operations into the least time an H100 SXM could
take for them. The peaks are the card's published ones
(NVIDIA's data sheet, dense, at the 700 W limit); none of them is a TPU
number.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from dataclasses import dataclass

import torch

from sl_hwgat_tpu_torch.graphs.adjacency import windowed_block_adj

PEAK_BYTES_PER_S = 3.35e12               # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # f32 CUDA cores; bf16 dense tensor
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}

# The window attention's train/eval work ratio on the card: (K1 + K2) / K1 at
# 32-token units, card ms of `chip_smoke.py`'s timings phase (PERF.md §6:
# K1 0.1755 / 0.1391, K2 0.4072 / 0.2418; NVIDIA H100 80GB HBM3, 700.00 W).
# The JAX package's literal 2.5 is a TPU measurement.
ATTN_TRAIN_RATIO = {"float32": (0.1755 + 0.4072) / 0.1755,
                    "bfloat16": (0.1391 + 0.2418) / 0.1391}


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the host's and, where a card is present, the card's activity
    inside the ``with`` block, and write it into ``log_dir`` as a Chrome
    trace (``trace_<seconds since the epoch>.json``, readable in Perfetto or
    chrome://tracing). ≡ `utils/profiling.py:19-25`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{int(time.time())}.json"))


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """(least seconds on an H100 SXM, "bytes" or "operations"): the larger of
    ``nbytes`` over the memory rate and ``flops`` over the peak of ``dtype``
    ("float32" or "bfloat16")."""
    bytes_s = nbytes / PEAK_BYTES_PER_S
    ops_s = flops / PEAK_FLOPS[dtype]
    return (bytes_s, "bytes") if bytes_s >= ops_s else (ops_s, "operations")


def timeit(fn, *args, warmup: int = 3, repeats: int = 10, inner: int = 10) -> list[float]:
    """Seconds per call of ``fn(*args)`` on the current CUDA stream, one
    sample per repeat: CUDA events around ``inner`` back-to-back calls (one
    call per sample would count the host's time to fill an empty queue)."""
    for _ in range(warmup):
        fn(*args)
    samples = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn(*args)
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / 1e3 / inner)
    return samples


def device_seconds(fn, *args, calls: int = 10, repeats: int = 5) -> float:
    """Device seconds per call of ``fn(*args)``, the median of ``repeats``
    samples: CUDA events around ``calls`` back-to-back calls that the host
    queues while the card spins (``torch.cuda._sleep``), so that the card
    runs them without waiting for the host. Where a call's host path takes
    longer than its kernels, ``timeit`` gives the host's time and this the
    card's. A sample whose start event the card reached before the host had
    queued every call is taken again with a longer spin. A call of more
    launches than the card's queue holds (a whole train step) cannot be
    queued ahead: ``busy_seconds`` times it."""
    fn(*args)
    torch.cuda.synchronize()
    spin = 1 << 22  # cycles, about 2 ms
    samples = []
    while len(samples) < repeats:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(calls):
            fn(*args)
        end.record()
        queued_in_time = not start.query()
        end.synchronize()
        if queued_in_time:
            samples.append(start.elapsed_time(end) / 1e3 / calls)
        elif spin >= 1 << 31:  # about a second: the calls wait on the host
            raise RuntimeError("the calls cannot be queued ahead of the card")
        else:
            spin *= 2
    return statistics.median(samples)


def busy_seconds(fn, *args, repeats: int = 3) -> float:
    """The card's busy seconds in one call of ``fn(*args)``, the median of
    ``repeats`` calls: the summed device time of the kernels and copies the
    call runs, from ``torch.profiler`` (ranges that code annotates span
    kernels already counted and are left out). Against the call's host
    time, the rest is the card idle, waiting on the host."""
    from torch.profiler import ProfilerActivity, profile

    samples = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda.synchronize()
        total_us = 0.0
        for ev in prof.key_averages():
            dev_us = getattr(ev, "device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "cuda_time_total", 0)
            if (ev.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(ev, "is_user_annotation", False)):
                total_us += dev_us
        samples.append(total_us / 1e6)
    return statistics.median(samples)


def repeat_stats(per_call: list[float]) -> dict:
    """The repeat fields of a bench line (``bench_kernel.py:70-80``)."""
    med = statistics.median(per_call)
    return {
        "time_us": med * 1e6,
        "time_us_min": min(per_call) * 1e6,
        "time_us_max": max(per_call) * 1e6,
        "n_repeats": len(per_call),
        "spread_pct": round(100.0 * (max(per_call) - min(per_call)) / med, 1),
    }


@dataclass(frozen=True)
class AttentionCost:
    """Work accounting for one masked-window attention call."""

    edges: int          # nnz of the applied masks (SDDMM+SpMM pairs)
    dense_flops: int    # FLOPs issued by the dense supertile path
    sparse_flops: int   # FLOPs a perfect sparse kernel would issue (4·dh per edge)
    bytes_min: int      # compulsory q/k/v/out traffic


def window_attention_cost(units: int, tokens: int, head_dim: int, nnz: int,
                          stack: int = 4, dtype_bytes: int = 4) -> AttentionCost:
    """Cost of ``stacked_window_attention`` over ``units`` (group, head) units."""
    tiles = units // stack
    s_tok = stack * tokens
    dense = tiles * 2 * (2 * s_tok * s_tok * head_dim)
    sparse = units * nnz * 4 * head_dim
    io = units * tokens * head_dim * dtype_bytes * 4  # q, k, v, out
    return AttentionCost(edges=units * nnz, dense_flops=dense, sparse_flops=sparse, bytes_min=io)


def hwgate_forward_cost(batch: int, frames: int = 192, embed: int = 128,
                        depths=(2, 2, 4), heads=(2, 4, 8), tp: int = 2,
                        nw: int = 4, window: int = 16) -> dict:
    """Aggregate per-forward attention cost of HWGATE (flagship config)."""
    nnz = int((windowed_block_adj(tp, window, 1)[0] != 0).sum())
    tokens = tp * window
    total = dict(edges=0, dense_flops=0, sparse_flops=0, bytes_min=0)
    f = frames
    for i, (d_i, h_i) in enumerate(zip(depths, heads)):
        dim = embed * 2**i
        dh = dim // h_i
        units = batch * (f // tp) * nw * h_i
        c = window_attention_cost(units, tokens, dh, nnz)
        for _ in range(d_i):
            total["edges"] += c.edges
            total["dense_flops"] += c.dense_flops
            total["sparse_flops"] += c.sparse_flops
            total["bytes_min"] += c.bytes_min
        f //= tp
    return total


def banded_attention_cost(groups: int, heads: int, frames: int, vtok: int,
                          head_dim: int, dtype_bytes: int = 4,
                          compact: bool = True) -> AttentionCost:
    """Cost of the banded (GATE/WGATE) attention over the full (V, 3V) band;
    ``dense_flops`` is what the compact identity-temporal form issues (the
    (V, V) same-frame block and two elementwise temporal dots), or the
    whole (V, 3V) band without ``compact``."""
    bhf = groups * heads * frames
    edges = bhf * vtok * 3 * vtok
    if compact:
        dense = bhf * 2 * (2 * vtok * vtok * head_dim) + bhf * 2 * (2 * vtok * head_dim)
    else:
        dense = bhf * 2 * (2 * vtok * 3 * vtok * head_dim)
    sparse = edges * 4 * head_dim
    io = bhf * vtok * head_dim * dtype_bytes * 4  # q, k, v, out (compulsory)
    return AttentionCost(edges=edges, dense_flops=dense, sparse_flops=sparse, bytes_min=io)


def hwgate_step_roofline(batch: int, frames: int = 192, embed: int = 128,
                         depths=(2, 2, 4), heads=(2, 4, 8), tp: int = 2,
                         nw: int = 4, window: int = 16, kps: int = 64,
                         num_classes: int = 2002, ff_ratio: float = 2.0,
                         train: bool = True, mxu_flops: float | None = None,
                         shape_flops: float | None = None,
                         mem_bw: float = PEAK_BYTES_PER_S,
                         dtype_bytes: int | None = None,
                         attn_train_ratio: float | None = None,
                         dtype: str = "bfloat16") -> dict:
    """Analytic speed of light of one HWGATE train (or eval) step
    (``sl_hwgat_tpu/utils/profiling.py:85-159``, the same arithmetic).

    A sequential roofline: every GEMM contributes max(FLOPs / peak, bytes /
    memory rate), the projections and the FFN at ``mxu_flops``, the 32-token
    attention supertiles at ``shape_flops``, plus AdamW's traffic over the
    parameters. Train counts each GEMM 3× (forward, input and weight
    gradients) and the attention ``attn_train_ratio``×. LayerNorm, residual,
    roll and window-partition passes are left out: they are implementation
    overhead, not compulsory work. The defaults are the card's: the peak of
    ``dtype`` for both rates (989e12 bf16, 67e12 f32: the f32 GEMMs run on
    the CUDA cores, as every bench sets with TF32 off), 3.35e12 B/s, 2 or 4
    bytes an element and ``ATTN_TRAIN_RATIO[dtype]``. At the JAX package's
    arguments (47.3e12, 27.0e12, 1.05e12, 2 bytes, ratio 2.5) it returns the
    JAX package's numbers: the attention's compulsory bytes, counted in
    f32, scale by ``dtype_bytes`` / 4 (the JAX code's halving)."""
    mxu_flops = PEAK_FLOPS[dtype] if mxu_flops is None else mxu_flops
    shape_flops = PEAK_FLOPS[dtype] if shape_flops is None else shape_flops
    dtype_bytes = DTYPE_BYTES[dtype] if dtype_bytes is None else dtype_bytes
    if attn_train_ratio is None:
        attn_train_ratio = ATTN_TRAIN_RATIO[dtype]

    def gemm_t(m, k, n, count=1):
        flops = 2.0 * m * k * n * count
        byts = float(m * k + k * n + m * n) * dtype_bytes * count
        return max(flops / mxu_flops, byts / mem_bw), flops

    total_t, total_flops = 0.0, 0.0
    mult = 3 if train else 1  # fwd + dgrad + wgrad GEMMs
    f = frames
    for i, (d_i, h_i) in enumerate(zip(depths, heads)):
        dim = embed * 2**i
        tok = batch * f * kps
        hidden = int(dim * ff_ratio)
        for _ in range(d_i):
            for (k_, n_, cnt) in ((dim, dim, 3),       # q, k, v projections
                                  (dim, dim, 1),       # output projection
                                  (dim, hidden, 1),    # fc1
                                  (hidden, dim, 1)):   # fc2
                t1, fl = gemm_t(tok, k_, n_, cnt)
                total_t += mult * t1
                total_flops += mult * fl
        if i < len(depths) - 1:
            f //= tp
    # classifier head + Fourier embed (embed/2 random features per coord)
    t1, fl = gemm_t(batch, embed * 2 ** (len(depths) - 1), num_classes)
    total_t += mult * t1
    total_flops += mult * fl
    t1, fl = gemm_t(batch * frames * kps, 2, embed // 2)
    total_t += mult * t1
    total_flops += mult * fl

    # attention supertiles at the shape rate; bytes_min counts f32 elements
    attn = hwgate_forward_cost(batch, frames, embed, depths, heads, tp, nw, window)
    attn_t = max(attn["dense_flops"] / shape_flops,
                 attn["bytes_min"] * dtype_bytes / 4 / mem_bw)
    attn_mult = attn_train_ratio if train else 1.0
    total_t += attn_mult * attn_t
    total_flops += attn_mult * attn["dense_flops"]

    if train:
        # AdamW: read p/m/v + write p/m/v, f32 master copies
        n_params = 0
        for i, d_i in enumerate(depths):
            dim = embed * 2**i
            hidden = int(dim * ff_ratio)
            n_params += d_i * (3 * dim * dim + dim * dim + 2 * dim * hidden)
        n_params += embed * 2 ** (len(depths) - 1) * num_classes
        total_t += n_params * 4 * 6 / mem_bw

    return {"seconds": total_t, "flops": total_flops,
            "clips_per_sec": batch / total_t}
