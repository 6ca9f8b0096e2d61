"""Weak scaling of the window attention (K1) and the halo banded attention
(K8) over ranks, as JSON lines: the counterpart of ``bench_scaling.py``.

    python -m sl_hwgat_tpu_torch.bench.scaling [--op banded] [--device cuda|cpu] [N ...]

Scales default to 1 2 4 8; ``SCALING_UNITS_PER_SHARD`` sets the window
op's units a rank (12288). ``eff(n) = edges_per_sec(n) / (n ·
edges_per_sec(1))`` at a constant work per rank.

- ``measure(n)``: n ranks over a (n, 1, 1) mesh, each running K1
  (``ops.window_attention.window_attention``, f32, scale 0.125, stack 4,
  the 164-edge adjacency ``windowed_block_adj(2)[0]``) on its own 12288
  units of 32 tokens × dh 64; the output fed back as q ``inner`` times,
  once warm and ``outer`` times timed (no traffic between ranks: the units
  are disjoint edge blocks).
- ``measure_banded(n)``: B 16 × H 8 planes of V 29 joints × dh 16, 96
  frames a rank over a (1, n, 1) mesh, the band [eye | BODY29 spatial |
  eye]; K8 on each rank's frames behind the one-frame halo exchange
  (``parallel.edge_partition.call_sharded_banded``), or K8 directly at n
  = 1; edges ``B·H·F·V·3·V``.

``time_us`` is the slowest rank's host time per op; ``device_us`` its card
time per op (CUDA events around the timed loops; null on the CPU). Ranks
are spawned by ``parallel.dryrun.spawn``: with n at most the number of
cards, NCCL with a card a rank; beyond it, gloo ranks that share
``cuda:0``, whose lines carry ``"shared_card": true`` and enter no
``scaling_efficiency`` line (they time-slice one card: they check the
mechanics and measure no scaling). Each line also names the backend and
the card (nvidia-smi's name and power limit). Inputs are drawn on the host
from a generator seeded by the rank (``window_inputs``,
``banded_inputs``), so a rank's output can be recomputed elsewhere; with
``out_dir`` each rank writes its last output and its kernel launches
there, outside the timed window.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

SCALE = 0.125
STACK = 4
TOKENS, HEAD_DIM = 32, 64
BANDED = dict(batch=16, heads=8, joints=29, head_dim=16)
BANDED_SCALE = 0.25


def window_adj() -> np.ndarray:
    """The (32, 32) adjacency of the JAX script: ``windowed_block_adj(2)[0]``."""
    from sl_hwgat_tpu_torch.graphs.adjacency import windowed_block_adj

    return windowed_block_adj(2)[0]


def band() -> np.ndarray:
    """(3, 29, 29) additive band [eye | BODY29 spatial | eye]."""
    from sl_hwgat_tpu_torch.graphs.adjacency import additive_mask
    from sl_hwgat_tpu_torch.graphs.skeleton import BODY29_EDGES, edges_to_dense

    v = BANDED["joints"]
    eye = np.eye(v, dtype=np.float32)
    spatial = edges_to_dense(BODY29_EDGES, v, self_loops=False)
    return np.stack([additive_mask(eye), additive_mask(spatial), additive_mask(eye)])


def window_inputs(units: int, rank: int) -> tuple[torch.Tensor, ...]:
    """Rank ``rank``'s q, k, v: (units, 32, 64) f32 each, on the host."""
    g = torch.Generator().manual_seed(1000 + rank)
    return tuple(torch.randn(units, TOKENS, HEAD_DIM, generator=g) for _ in range(3))


def banded_inputs(frames: int, rank: int) -> tuple[torch.Tensor, ...]:
    """Rank ``rank``'s q, k, v: (B·H, frames·V, dh) f32 planes, on the host
    (its frames of the clip: the ranks' planes joined along axis 1 are the
    global ones)."""
    g = torch.Generator().manual_seed(2000 + rank)
    b = BANDED
    shape = (b["batch"] * b["heads"], frames * b["joints"], b["head_dim"])
    return tuple(torch.randn(shape, generator=g) for _ in range(3))


def window_edges(units: int) -> int:
    return units * int((window_adj() != 0).sum())


def banded_edges(frames: int) -> int:
    b = BANDED
    return b["batch"] * b["heads"] * frames * b["joints"] * 3 * b["joints"]


def _timed(step, y, inner: int, outer: int, device: torch.device):
    """``step`` applied ``inner`` times to ``y`` once warm, then ``outer``
    times timed → (last y, host s per op, card s per op or None)."""
    import torch.distributed as dist

    for _ in range(inner):
        y = step(y)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    dist.barrier()
    t0 = time.perf_counter()
    if cuda:
        start.record()
    for _ in range(outer):
        for _ in range(inner):
            y = step(y)
    if cuda:
        end.record()
        torch.cuda.synchronize(device)
    host = (time.perf_counter() - t0) / (outer * inner)
    card = start.elapsed_time(end) / 1e3 / (outer * inner) if cuda else None
    return y, host, card


def _rank_worker(rank: int, world: int, ops: list, out_dir: str, keep: bool,
                 on_card: bool) -> None:
    """Each op of ``ops`` ((kind, kwargs), in order) on this rank, on its
    current card (``on_card``) or the host; writes ``{out_dir}/{i}.{rank}``:
    host and card s per op, the launches, and (``keep``) the last output."""
    import torch.distributed as dist

    from sl_hwgat_tpu_torch.ops import banded_attention, window_attention
    from sl_hwgat_tpu_torch.parallel import edge_partition
    from sl_hwgat_tpu_torch.parallel import mesh as mesh_lib

    dev = torch.device("cuda", torch.cuda.current_device()) if on_card else torch.device("cpu")
    for i, (kind, kw) in enumerate(ops):
        if kind == "window":
            q, k, v = (t.to(dev) for t in window_inputs(kw["units"], rank))
            adj = window_adj()

            def step(y):
                return window_attention.window_attention(y, k, v, adj, scale=SCALE, stack=STACK)

            counter = window_attention.window_attention
        else:
            q, k, v = (t.to(dev) for t in banded_inputs(kw["frames"], rank))
            bnd = band()
            layout = mesh_lib.Layout(mesh_lib.make_mesh((1, world, 1), dev.type)) \
                if world > 1 else None

            def step(y):
                if layout is None:
                    return banded_attention.banded_attention(y, k, v, bnd, scale=BANDED_SCALE)
                with mesh_lib.activate(layout):
                    return edge_partition.call_sharded_banded(y, k, v, bnd, scale=BANDED_SCALE)

            counter = banded_attention.banded_attention
        counter.launches = 0
        with torch.no_grad():
            y, host, card = _timed(step, q, kw["inner"], kw["outer"], dev)
        mine = {"host_s": host, "card_s": card, "launches": counter.launches}
        if keep:
            mine["out"] = y.cpu()
        torch.save(mine, os.path.join(out_dir, f"{i}.{rank}"))
        del q, k, v, y
        dist.barrier()


def _spawn_plan(n: int, device: str) -> tuple[str, str, bool]:
    """(backend, spawn device, shared card) for n ranks on ``device``."""
    if device == "cpu":
        return "gloo", "cpu", False
    if not torch.cuda.is_available():
        raise RuntimeError("scaling on cuda needs a card (pass --device cpu for the host)")
    if n <= torch.cuda.device_count():
        return "nccl", "cuda", False
    return "gloo", "cuda:0", True


def run(n: int, ops: list, device: str = "cuda", out_dir: str | None = None) -> list[dict]:
    """The records of ``ops`` (("window" | "banded", kwargs), in order), run
    by n ranks in one spawn. kwargs: ``units`` or ``frames`` a rank,
    ``inner``, ``outer``. With ``out_dir``, each rank writes its last output
    of op i there (``{i}.{rank}``, key ``out``)."""
    from sl_hwgat_tpu_torch.bench.step import card_name
    from sl_hwgat_tpu_torch.parallel.dryrun import spawn

    backend, spawn_device, shared = _spawn_plan(n, device)
    with tempfile.TemporaryDirectory(prefix="sl_hwgat_scaling_") as tmp:
        spawn(_rank_worker, n, ops, out_dir or tmp, out_dir is not None, spawn_device != "cpu",
              backend=backend, device=spawn_device)
        ranks = [[torch.load(os.path.join(out_dir or tmp, f"{i}.{r}")) for r in range(n)]
                 for i in range(len(ops))]
    card = card_name() if device != "cpu" else "cpu"
    records = []
    for (kind, kw), mine in zip(ops, ranks):
        per_op = max(m["host_s"] for m in mine)
        card_s = [m["card_s"] for m in mine]
        rec = {"n_shards": n}
        if kind == "window":
            units = kw["units"] * n
            rec.update(units=units, time_us=per_op * 1e6,
                       edges_per_sec=window_edges(units) / per_op)
        else:
            frames = kw["frames"] * n
            rec.update(op="banded_halo", frames=frames, time_us=per_op * 1e6,
                       edges_per_sec=banded_edges(frames) / per_op)
        rec.update(device_us=None if None in card_s else max(card_s) * 1e6, backend=backend,
                   shared_card=shared, device=card,
                   launches_per_rank=[m["launches"] for m in mine])
        records.append(rec)
    return records


def measure(n_shards: int, units_per_shard: int = 12288, inner: int = 10, outer: int = 3,
            device: str = "cuda", out_dir: str | None = None) -> dict:
    """The window op's record at n ranks (``bench_scaling.measure``)."""
    return run(n_shards, [("window", dict(units=units_per_shard, inner=inner, outer=outer))],
               device, out_dir)[0]


def measure_banded(n_shards: int, frames_per_shard: int = 96, inner: int = 10,
                   outer: int = 3, device: str = "cuda", out_dir: str | None = None) -> dict:
    """The halo banded op's record at n ranks (``bench_scaling.measure_banded``)."""
    return run(n_shards, [("banded", dict(frames=frames_per_shard, inner=inner, outer=outer))],
               device, out_dir)[0]


def efficiency_lines(records: list[dict]) -> list[dict]:
    """``bench_scaling.py``'s ``scaling_efficiency`` lines, from the records
    that did not share a card."""
    results = [r for r in records if "edges_per_sec" in r and not r["shared_card"]]
    if len(results) < 2:
        return []
    base = results[0]["edges_per_sec"] / results[0]["n_shards"]
    return [{"scaling_efficiency": round(r["edges_per_sec"] / (r["n_shards"] * base), 4),
             "n_shards": r["n_shards"], "target": 0.85} for r in results[1:]]


def main(argv: list[str] | None = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("scales", nargs="*", type=int, default=[1, 2, 4, 8])
    p.add_argument("--op", choices=("window", "banded"), default="window")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    units = int(os.environ.get("SCALING_UNITS_PER_SHARD", "12288"))
    records = []
    for n in args.scales:
        rec = (measure_banded(n, device=args.device) if args.op == "banded"
               else measure(n, units_per_shard=units, device=args.device))
        print(json.dumps(rec), flush=True)
        records.append(rec)
    for line in efficiency_lines(records):
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
