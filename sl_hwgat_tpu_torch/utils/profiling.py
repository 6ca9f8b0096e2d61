"""Tracing, timing and roofline accounting of the port on an H100.

Counterpart of ``sl_hwgat_tpu/utils/profiling.py``: ``trace`` records a
``torch.profiler`` Chrome trace of a block of work, ``timeit`` times a
function on the card with CUDA events, ``device_seconds`` times it with the
card's queue kept full, and the cost arithmetic (``AttentionCost``,
``window_attention_cost``, ``hwgate_forward_cost``,
``banded_attention_cost``) counts the work of the attention calls, equal to
the JAX package's. ``bound`` turns bytes and operations into the least time
an H100 SXM could take for them. The peaks are the card's published ones
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
    queued every call is taken again with a longer spin."""
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
