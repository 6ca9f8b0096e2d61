"""Dataset and host loader, the port's own copy of ``sl_hwgat_tpu/data/dataset.py``.

≡ reference `hwgat/dataset.py:12-41` + `hwgat/utils.py:16-52`:

- fixed batch shapes: the last partial batch is padded (the last id
  repeated) and carried with a {0,1} validity mask; loss and metrics weight
  by the mask;
- deterministic per-sample RNG: stream = SeedSequence([seed, epoch, index]),
  so a run is reproducible however the workers are scheduled, and gives the
  JAX package's batches for the same seeds;
- transforms run in a thread pool (NumPy/SciPy release the GIL on the hot
  paths), ``prefetch`` batches ahead of the consumer.

The data map is an in-memory pickle of arrays or ``.pkl`` paths, or a
``{"__clipstore__": path}`` marker that ``load_artifacts`` resolves to a
``ClipStore`` (``data/clipstore.py``, written by ``preprocess(...,
store="clipstore")``). ``.mp4`` entries are not ported: they need
``decord`` (see ROADMAP.md).
"""

from __future__ import annotations

import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np


def load_entry(data):
    """Resolve a data-map entry: in-memory array | .pkl path. ≡ `dataset.py:21-28`."""
    if isinstance(data, np.ndarray):
        return data
    if isinstance(data, str) and data.endswith("pkl"):
        with open(data, "rb") as f:
            return pickle.load(f)
    raise ValueError(f"unsupported data-map entry: {type(data)} (.mp4 is not ported)")


@dataclass
class KeypointDataset:
    """id-list + data-map + label-map + transform. ≡ `CustomDataset`."""

    ids: list
    data_map: dict
    label_map: dict
    transform: object
    seed: int = 1001

    def __len__(self):
        return len(self.ids)

    def get(self, index: int, epoch: int = 0):
        vid = self.ids[index]
        raw = self.data_map[vid]
        feat = load_entry(raw)
        if feat is raw:  # in-memory entry: transforms mutate, so copy
            feat = feat.copy()
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch, index]))
        feat = self.transform(feat, rng) if self.transform is not None else feat
        return feat.astype(np.float32), np.int32(self.label_map[vid])


@dataclass
class Loader:
    """Fixed-shape batch iterator with a validity mask and thread-pool
    transforms. ``close()`` shuts the pool down.

    ``auto_warm_next``: when an epoch has been read to its end, the first
    ``prefetch + 1`` batches of the next epoch are submitted at once
    (``warm``), so their transforms overlap whatever the caller does between
    epochs (validation, checkpoints, curves). ``cache_transforms``: the
    batches of the first pass are kept and replayed by every later one; only
    for a transform that draws no randomness and does not depend on the
    epoch (the eval transform of the val and test loaders). ``row_slice``
    (lo, hi): read and transform only rows [lo, hi) of every batch (a rank
    of a sharded run, ``train/dist.py``); the batch order and padding are
    the global ones, so the ranks' rows make up the same batches.
    """

    dataset: KeypointDataset
    batch_size: int
    shuffle: bool = False
    num_workers: int = 8
    seed: int = 1001
    prefetch: int = 2
    auto_warm_next: bool = False
    cache_transforms: bool = False
    row_slice: tuple | None = None
    _pool: ThreadPoolExecutor | None = field(default=None, repr=False)
    _warm: dict = field(default_factory=dict, repr=False)
    _cache: list | None = field(default=None, repr=False)

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def _batch_ids(self, order, s: int):
        ids = order[s : s + self.batch_size]
        valid = np.ones(len(ids), dtype=np.float32)
        if len(ids) < self.batch_size:  # pad to the fixed shape
            pad = self.batch_size - len(ids)
            ids = np.concatenate([ids, np.repeat(ids[-1:], pad)])
            valid = np.concatenate([valid, np.zeros(pad, np.float32)])
        if self.row_slice is not None:
            lo, hi = self.row_slice
            ids, valid = ids[lo:hi], valid[lo:hi]
        return ids, valid

    def _order(self, epoch: int) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(np.random.SeedSequence([self.seed, epoch])).shuffle(order)
        return order

    def _submit(self, order, s: int, epoch: int):
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=max(1, self.num_workers))
        ids, valid = self._batch_ids(order, s)
        return [self._pool.submit(self.dataset.get, int(i), epoch) for i in ids], valid

    def warm(self, epoch: int) -> None:
        """Submit the first ``prefetch + 1`` batches of ``epoch`` now; the
        sample order is fixed by (seed, epoch), so ``epoch(epoch)`` later
        reads exactly these."""
        if epoch in self._warm:
            return
        order = self._order(epoch)
        starts = range(0, len(self.dataset), self.batch_size)
        self._warm[epoch] = [self._submit(order, s, epoch)
                             for s in starts[: self.prefetch + 1]]

    def epoch(self, epoch: int = 0) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """(features, labels, valid) batches; the transforms of the next
        ``prefetch`` batches run in worker threads while the caller consumes
        the current one."""
        if self.cache_transforms and self._cache is not None:
            yield from self._cache
            return
        order = self._order(epoch)
        starts = list(range(0, len(self.dataset), self.batch_size))
        pending = self._warm.pop(epoch, None)
        if pending is None:
            pending = [self._submit(order, s, epoch) for s in starts[: self.prefetch + 1]]
        batches = [] if self.cache_transforms else None
        for n in range(len(starts)):
            futures, valid = pending.pop(0)
            if n + self.prefetch + 1 < len(starts):
                pending.append(self._submit(order, starts[n + self.prefetch + 1], epoch))
            samples = [f.result() for f in futures]
            batch = (np.stack([s[0] for s in samples]),
                     np.asarray([s[1] for s in samples], dtype=np.int32), valid)
            if batches is not None:
                batches.append(batch)
            yield batch
        if batches is not None:
            self._cache = batches
        if self.auto_warm_next:
            self.warm(epoch + 1)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
        self._warm.clear()


def load_artifacts(input_root: str, dataset_name: str, feature_type: str = "keypoints"):
    """(vid_splits, vid_class, data_map): the preprocessed pickles of
    ``<input_root>/<dataset_name>/`` (the paths of the JAX package's
    ``DataConfig``). ≡ `utils.py:18-26`. A clip-store marker in place of
    the data map gives a ``ClipStore`` on the native reader."""
    folder = os.path.join(input_root, dataset_name)
    paths = (f"vid_splits_{dataset_name}.pkl", f"vid_class_{dataset_name}.pkl",
             f"data_map_{dataset_name}_{feature_type}.pkl")
    out = []
    for name in paths:
        with open(os.path.join(folder, name), "rb") as f:
            out.append(pickle.load(f))
    if isinstance(out[2], dict) and "__clipstore__" in out[2]:
        from sl_hwgat_tpu_torch.data.clipstore import ClipStore

        out[2] = ClipStore(out[2]["__clipstore__"])
    return tuple(out)


def get_loaders(cfg, train_transform, eval_transform):
    """(train, val, test) loaders of ``cfg`` (a ``RunConfig``); in test mode
    every split takes the eval transform. val and test replay their first
    pass (``cache_transforms``), and the shuffled train loader warms its next
    epoch. ≡ `utils.py:16-52`."""
    vid_splits, vid_cls, vid_feat = load_artifacts(cfg.input_root, cfg.dataset,
                                                   cfg.feature_type)
    tt = eval_transform if cfg.mode == "test" else train_transform

    def mk(split, transform, shuffle, cache=False):
        ds = KeypointDataset(vid_splits[split], vid_feat, vid_cls, transform, seed=cfg.seed)
        return Loader(ds, cfg.batch_size, shuffle=shuffle, num_workers=cfg.n_workers,
                      seed=cfg.seed, auto_warm_next=shuffle, cache_transforms=cache)

    return (mk("train", tt, shuffle=cfg.mode != "test"),
            mk("val", eval_transform, shuffle=False, cache=True),
            mk("test", eval_transform, shuffle=False, cache=True))
