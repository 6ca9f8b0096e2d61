"""Inference serving: checkpoint → bucketed predictor → coalescing queue.

Counterpart of ``sl_hwgat_tpu/serve.py`` on PyTorch:

- requests are padded to fixed batch buckets (zero clips, padded logits
  dropped), so each bucket always runs one shape;
- raw keypoint clips (any frame count, the extractor's (F, K, C) layout) go
  through the eval transform the training pipeline used;
- checkpoints: a port or reference ``.pt`` (``weights.load_state_dict``);
- export: ``Predictor.export_program`` writes the eval forward of one
  bucket, weights included, as a ``torch.export`` program (``.pt2``);
  ``Predictor.load_exported`` runs it with the port's custom ops
  (``ops/library.py``) and none of its models.

Usage::

    pred = Predictor.from_checkpoint("model.pt", model_type="HWGATE", dataset="FDMSE-ISL")
    out = pred.predict_topk([clip1, clip2], k=5)   # clips: (F_i, 543, 4) arrays
    pred.export_program("hwgate16.pt2", 16, clip1)
    logits = Predictor.load_exported("hwgate16.pt2")(batch)   # (16, F, K, C) float32
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from sl_hwgat_tpu_torch import configs
from sl_hwgat_tpu_torch.constants import DATASET_PARAMS
from sl_hwgat_tpu_torch.data import transforms as T
from sl_hwgat_tpu_torch.weights import load_state_dict


def _softmax_np(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


@dataclass
class Predictor:
    """Eval-mode classifier over raw keypoint clips."""

    model: torch.nn.Module
    transform: object
    num_classes: int
    device: torch.device
    batch_buckets: tuple = (1, 4, 8, 16)
    _pool: ThreadPoolExecutor | None = field(default=None, repr=False)

    @classmethod
    def from_checkpoint(cls, path: str, *, model_type: str, dataset: str,
                        pose_method: str = "mediapipe",
                        batch_buckets: tuple = (1, 4, 8, 16), device="cuda",
                        **model_overrides):
        """Load ``path`` into ``model_type`` sized for ``dataset`` on
        ``device`` (default ``cuda``; raises when no card is present).
        HWGATE and WGATE take the 64-joint windowed transform, the other
        models the 29-joint skeleton one (``MODEL_NUM_KPS``).
        ``model_overrides`` reach the model's constructor, e.g.
        ``attn_impl="hybrid"`` for HWGATE and HGATE."""
        # imported here: a process that only runs exported programs
        # (load_exported) imports no model
        from sl_hwgat_tpu_torch.models import MODEL_NUM_KPS, build_model, resolve_device

        dev = resolve_device(device)
        ds = DATASET_PARAMS[dataset]
        model = build_model(model_type, ds, 2, device=dev, **model_overrides)
        model.load_state_dict(load_state_dict(path))
        # the preprocess-time static transform (extractor layout → selected
        # joints/coords) chained with the eval transform of the model's joints
        static = configs.build_static_transform(pose_method)
        if MODEL_NUM_KPS[model_type] == 64:
            ev = configs.build_eval_transform(ds["src_len"])
        else:
            ev = configs.build_skeleton_eval_transform(ds["src_len"])
        transform = T.Compose([*static.transforms, *ev.transforms])
        return cls(model=model, transform=transform, num_classes=ds["num_class"],
                   device=dev, batch_buckets=tuple(batch_buckets))

    def _bucket(self, n: int) -> int:
        for b in self.batch_buckets:
            if n <= b:
                return b
        return int(np.ceil(n / self.batch_buckets[-1])) * self.batch_buckets[-1]

    def forward(self, x: np.ndarray) -> torch.Tensor:
        """Preprocessed (B, F, K, C) batch → logits on the device (the launch
        returns before a card finishes)."""
        with torch.inference_mode():
            return self.model(torch.from_numpy(x).to(self.device))

    @staticmethod
    def _payload(clip):
        """A pose-extract payload dict, or a plain (F, K, C) array in pixel
        space (unit video size)."""
        if isinstance(clip, dict):
            return {"feat": np.array(clip["feat"], np.float32, copy=True),
                    "vid_width": clip.get("vid_width", 1),
                    "vid_height": clip.get("vid_height", 1)}
        return {"feat": np.array(clip, np.float32, copy=True),
                "vid_width": 1, "vid_height": 1}

    def preprocess(self, clip) -> np.ndarray:
        return np.asarray(self.transform(self._payload(clip)), np.float32)

    def predict_logits(self, clips: Sequence) -> np.ndarray:
        """Raw clips → (len(clips), num_classes) logits."""
        if len(clips) > 1:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix="serve-prep")
            xs = list(self._pool.map(self.preprocess, clips))
        else:
            xs = [self.preprocess(clips[0])]
        shape = xs[0].shape
        if any(x.shape != shape for x in xs):
            raise ValueError(f"transform produced inconsistent shapes: {[x.shape for x in xs]}")
        n = len(xs)
        x = np.zeros((self._bucket(n),) + shape, np.float32)
        x[:n] = np.stack(xs)
        return self.forward(x)[:n].float().cpu().numpy()

    def predict_topk(self, clips: Sequence, k: int = 5):
        """→ list of (class_ids, softmax_scores), each of length k, per clip."""
        logits = self.predict_logits(clips)
        probs = _softmax_np(logits)
        idx = np.argsort(-logits, axis=-1)[:, :k]
        return [(idx[i], probs[i, idx[i]]) for i in range(len(clips))]

    def warmup(self, sample_clip) -> None:
        """Run every batch bucket once (call at service start)."""
        shape = self.preprocess(sample_clip).shape
        for b in self.batch_buckets:
            self.forward(np.zeros((b,) + shape, np.float32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- export ----------------------------------------------------------------
    def export_program(self, path: str, batch: int, sample_clip) -> str:
        """Write the eval forward at bucket ``batch``, weights included, as a
        ``torch.export`` program (``torch.export.save``, a ``.pt2`` file):
        the port's counterpart of the JAX ``Predictor.export_stablehlo``.
        Returns ``path``.

        The program takes one (batch, *transform output shape) float32
        tensor on the Predictor's device and returns logits. Its attention
        runs through the custom ops of ``ops/library.py`` (the hand kernels
        on a card), so ``load_exported`` needs that module and none of the
        port's models. The masks and tables the forward builds are
        constants of this bucket. One eager forward runs first (the kernels
        built, the masks cached as device tensors); the trace runs under
        ``no_grad`` (``inference_mode`` tensors cannot be traced)."""
        x = torch.zeros((batch,) + self.preprocess(sample_clip).shape, dtype=torch.float32,
                        device=self.device)
        self.model.eval()
        with torch.no_grad():
            self.model(x)
            program = torch.export.export(self.model, (x,))
        torch.export.save(program, path)
        return path

    @staticmethod
    def load_exported(path: str):
        """Load an ``export_program`` artifact; returns a callable
        (batch, ...) float32 → logits, run on the device the program was
        exported on. Imports ``ops.library`` (the custom ops) and nothing of
        the port's models."""
        from sl_hwgat_tpu_torch.ops import library  # noqa: F401  (registers the ops)

        program = torch.export.load(path)
        module = program.module()
        device = next(iter(program.state_dict.values())).device

        def call(xb):
            with torch.no_grad():
                return module(torch.as_tensor(xb, dtype=torch.float32, device=device))

        return call

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


class BatchingQueue:
    """Dynamic request batching for concurrent serving.

    - ``submit(clip)`` → ``Future`` of the clip's logits row. The transform
      runs in the caller's thread; only the forward is serialized.
    - One dispatcher thread launches as soon as ``max_batch`` requests are
      pending or the oldest has waited ``max_wait_ms``, groups by shape, pads
      to the Predictor's bucket and hands the batch to a dispatch pool.
    - A dispatch worker launches the forward on a CUDA stream of the queue,
      queues the device→host copy of the logits behind it, records an event
      and returns; a completion thread waits on the event and resolves the
      futures. While one batch runs, the next is already coalescing.
      ``max_inflight`` bounds the batches on the device.
    - ``close()`` serves everything already submitted, then stops.
    """

    def __init__(self, predictor: Predictor, max_batch: int = 16,
                 max_wait_ms: float = 5.0, max_inflight: int = 3):
        self.predictor = predictor
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait_ms) / 1e3
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._closed = False
        self._stats_lock = threading.Lock()
        self.stats = {"requests": 0, "batches": 0, "rows": 0, "batch_sizes": []}
        dev = predictor.device
        self._stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self._done_q: queue.SimpleQueue = queue.SimpleQueue()
        self._inflight = threading.Semaphore(int(max_inflight))
        self._dispatch_pool = ThreadPoolExecutor(
            max_workers=int(max_inflight), thread_name_prefix="serve-dispatch")
        self._completer = threading.Thread(
            target=self._complete_loop, name="serve-completer", daemon=True)
        self._completer.start()
        self._thread = threading.Thread(target=self._loop, name="serve-batcher", daemon=True)
        self._thread.start()

    # -- API -----------------------------------------------------------------
    def submit(self, clip) -> Future:
        if self._closed:
            raise RuntimeError("BatchingQueue is closed")
        x = self.predictor.preprocess(clip)
        fut: Future = Future()
        with self._stats_lock:
            self.stats["requests"] += 1
        self._q.put((x, fut))
        return fut

    def predict_topk(self, clip, k: int = 5):
        """Blocking convenience: one clip → (class_ids, softmax_scores)."""
        logits = self.submit(clip).result()
        probs = _softmax_np(logits)
        idx = np.argsort(-logits)[:k]
        return idx, probs[idx]

    def close(self) -> None:
        """Serve all already-submitted requests, then stop every thread."""
        self._closed = True
        self._q.put(None)
        self._thread.join()
        self._dispatch_pool.shutdown(wait=True)
        self._done_q.put(None)
        self._completer.join()

    # -- dispatcher ------------------------------------------------------------
    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            batch = [item]
            deadline = time.monotonic() + self.max_wait
            stop = False
            acquired = False
            while len(batch) < self.max_batch and not stop:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    # past the soft deadline: launch as soon as the device
                    # takes work; until then keep coalescing
                    if self._inflight.acquire(blocking=False):
                        acquired = True
                        break
                    timeout = 0.002
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    continue
                if nxt is None:
                    stop = True
                else:
                    batch.append(nxt)
            self._dispatch_pool.submit(self._run, batch, acquired)
            if stop:
                return

    def _launch(self, xp: np.ndarray):
        """Forward + device→host copy of the logits, queued on the queue's
        stream; returns (host logits, event marking their arrival)."""
        p = self.predictor
        if self._stream is None:
            return p.forward(xp), None
        with torch.cuda.stream(self._stream):
            logits = p.forward(xp)
            host = torch.empty(logits.shape, dtype=logits.dtype, pin_memory=True)
            host.copy_(logits, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return host, event

    def _run(self, batch, acquired: bool = False) -> None:
        # Runs on the dispatch pool, whose futures nobody reads: any uncaught
        # exception would vanish, leak the in-flight token and hang every
        # client future of the batch, so all failures land on the futures.
        try:
            groups: dict = {}
            for x, fut in batch:
                groups.setdefault(x.shape, []).append((x, fut))
            p = self.predictor
            for shape, items in groups.items():
                n = len(items)
                xp = np.zeros((p._bucket(n),) + shape, np.float32)
                xp[:n] = np.stack([x for x, _ in items])
                if acquired:
                    acquired = False
                else:
                    self._inflight.acquire()
                try:
                    host, event = self._launch(xp)
                except Exception as e:
                    self._inflight.release()
                    for _, fut in items:
                        fut.set_exception(e)
                    continue
                self._done_q.put((host, event, items))
        except Exception as e:
            if acquired:
                self._inflight.release()
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)

    def _complete_loop(self) -> None:
        while True:
            item = self._done_q.get()
            if item is None:
                return
            host, event, items = item
            try:
                if event is not None:
                    event.synchronize()
                logits = host[: len(items)].float().numpy()
            except Exception as e:
                self._inflight.release()
                for _, fut in items:
                    fut.set_exception(e)
                continue
            self._inflight.release()
            with self._stats_lock:
                self.stats["batches"] += 1
                self.stats["rows"] += len(items)
                self.stats["batch_sizes"].append(len(items))
            for i, (_, fut) in enumerate(items):
                fut.set_result(logits[i])
