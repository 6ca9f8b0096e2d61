"""Serving: ``Predictor`` end to end (host transform + the card's forward) at
each batch bucket, then the ``BatchingQueue`` under concurrent clients, as one
JSON line.

    python -m sl_hwgat_tpu_torch.bench.serve [dataset] [--dtype bfloat16|float32]
        [--device cuda|cpu]

Counterpart of ``bench_serve.py``: HWGATE at the dataset's geometry
(FDMSE-ISL by default), random weights from seed 0 written with the port's
``save_checkpoint`` and read by ``Predictor.from_checkpoint``; bf16 compute
by default (``--dtype float32`` opts out). Buckets 1, 8, 16, 32 and 64:
``predict_topk`` of a bucket's clips is timed over 10 calls after a warm
one. Then 128 requests from 32 client threads go through a ``BatchingQueue``
(``max_batch`` 32, ``max_wait_ms`` 10, ``max_inflight`` 3) after one warm
request. The line has the JAX script's keys (``per_bucket_ms``,
``clips_per_sec_b16``, ``clips_per_sec_bmax``, ``queue_clips_per_sec``,
``queue_batches``, ``queue_batch_sizes``, ``queue_p50_ms``,
``queue_p99_ms``, ``queue_speedup_vs_serial_b1``), the warm request left out
of the queue's counts, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

BUCKETS = (1, 8, 16, 32, 64)
REPS = 10


def measure(dataset: str = "FDMSE-ISL", dtype: str = "bfloat16", device: str = "cuda",
            buckets=BUCKETS, reps: int = REPS, n_requests: int = 128, n_clients: int = 32,
            max_batch: int = 32, max_wait_ms: float = 10.0, max_inflight: int = 3,
            **model_overrides) -> dict:
    """The serving line; ``model_overrides`` (e.g. ``embed_dim``) shrink the
    model for tests."""
    import numpy as np
    import torch

    from sl_hwgat_tpu_torch.bench.step import card_name
    from sl_hwgat_tpu_torch.constants import DATASET_PARAMS
    from sl_hwgat_tpu_torch.models import build_model
    from sl_hwgat_tpu_torch.serve import BatchingQueue, Predictor
    from sl_hwgat_tpu_torch.train.checkpoint import save_checkpoint
    from sl_hwgat_tpu_torch.train.state import TrainState, make_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ds = DATASET_PARAMS[dataset]
    overrides = dict(model_overrides)
    if dtype == "bfloat16":
        overrides["compute_dtype"] = "bfloat16"
    model = build_model("HWGATE", ds, 2, device="cpu", seed=0, **overrides)
    state = TrainState(model, make_optimizer("adamw", 5e-4, model.parameters()))
    rng = np.random.default_rng(0)

    def clip():
        return {"feat": rng.uniform(size=(ds["src_len"], 543, 4)).astype(np.float32),
                "vid_width": 640, "vid_height": 480}

    with tempfile.TemporaryDirectory(prefix="serve_") as tmp:
        path = os.path.join(tmp, "model.ckpt")
        save_checkpoint(path, state, 5e-4)
        del model, state
        pred = Predictor.from_checkpoint(path, model_type="HWGATE", dataset=dataset,
                                         batch_buckets=tuple(buckets), device=device,
                                         **overrides)
    try:
        pred.warmup(clip())
        per_bucket = {}
        for b in buckets:
            clips = [clip() for _ in range(b)]
            pred.predict_topk(clips, k=5)  # warm the exact path
            t0 = time.perf_counter()
            for _ in range(reps):
                pred.predict_topk(clips, k=5)
            per_bucket[str(b)] = (time.perf_counter() - t0) / reps * 1e3

        queue = BatchingQueue(pred, max_batch=max_batch, max_wait_ms=max_wait_ms,
                              max_inflight=max_inflight)
        try:
            reqs = [clip() for _ in range(n_requests)]
            queue.submit(reqs[0]).result()  # warm
            warm_batches = queue.stats["batches"]

            def timed_call(req):
                s = time.perf_counter()
                row = queue.submit(req).result()
                return time.perf_counter() - s, row

            t0 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=n_clients) as ex:
                results = list(ex.map(timed_call, reqs))
            wall = time.perf_counter() - t0
        finally:
            queue.close()
    finally:
        pred.close()
    sizes = queue.stats["batch_sizes"][warm_batches:]
    lat_ms = np.sort(np.asarray([t for t, _ in results])) * 1e3
    answered = sum(1 for _, row in results if np.isfinite(row).all())
    bmax = str(buckets[-1])
    return {
        "impl": "serve", "model": "HWGATE", "dataset": dataset, "dtype": dtype,
        "per_bucket_ms": per_bucket,
        "clips_per_sec_b16": 16 / (per_bucket["16"] / 1e3) if "16" in per_bucket else None,
        "clips_per_sec_bmax": buckets[-1] / (per_bucket[bmax] / 1e3),
        "queue": {"requests": n_requests, "clients": n_clients, "max_batch": max_batch,
                  "max_wait_ms": max_wait_ms, "max_inflight": max_inflight},
        "queue_answered": answered,
        "queue_clips_per_sec": n_requests / wall,
        "queue_batches": len(sizes),
        "queue_batch_sizes": sizes,
        "queue_p50_ms": float(np.percentile(lat_ms, 50)),
        "queue_p99_ms": float(np.percentile(lat_ms, 99)),
        "queue_speedup_vs_serial_b1": (per_bucket["1"] / 1e3) * n_requests / wall
        if "1" in per_bucket else None,
        "device": card_name() if pred.device.type == "cuda" else "cpu",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dataset", nargs="?", default="FDMSE-ISL")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.dataset, args.dtype, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
