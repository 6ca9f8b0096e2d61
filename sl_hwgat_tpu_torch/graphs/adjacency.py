"""Attention masks of the graph-attention models: the multiplicative {0,1}
masks of the windowed models (reference `hwgat/models/model_params.py:373-400`)
and of HGATE (`:461-484`), and the additive {-1e4, 0} form of the banded ones.

Per spatial window over T temporal blocks of V joints: diagonal blocks are
the spatial adjacency with self loops, the ±1 off-diagonal blocks are the
identity (same-joint temporal edges), everything else is 0.
"""

from __future__ import annotations

import numpy as np

from sl_hwgat_tpu_torch.graphs.skeleton import BODY29_EDGES, WINDOW_EDGES_16, edges_to_dense


def window_adj(edges=WINDOW_EDGES_16, window_size: int = 16) -> np.ndarray:
    """(W, W) spatial adjacency with self loops for one window."""
    return edges_to_dense(edges, window_size, self_loops=True)


def block_tridiagonal(spatial: np.ndarray, num_blocks: int) -> np.ndarray:
    """(T·V, T·V) block matrix: diag=``spatial``, ±1 blocks=I, else 0."""
    v = spatial.shape[0]
    t = num_blocks
    out = np.zeros((t * v, t * v), dtype=spatial.dtype)
    eye = np.eye(v, dtype=spatial.dtype)
    for i in range(t):
        out[i * v : (i + 1) * v, i * v : (i + 1) * v] = spatial
        if i + 1 < t:
            out[i * v : (i + 1) * v, (i + 1) * v : (i + 2) * v] = eye
            out[(i + 1) * v : (i + 2) * v, i * v : (i + 1) * v] = eye
    return out


def windowed_block_adj(temporal_blocks: int, window_size: int = 16,
                       num_windows: int = 4, edges_per_window=None) -> np.ndarray:
    """(num_windows, T·W, T·W) mask stack; HWGATE uses ``temporal_blocks =
    temporal_patch`` (2 → 32×32 masks)."""
    if edges_per_window is None:
        edges_per_window = [WINDOW_EDGES_16] * num_windows
    return np.stack([
        block_tridiagonal(window_adj(edges_per_window[w], window_size), temporal_blocks)
        for w in range(num_windows)
    ])


def hgate_block_adj(edges=BODY29_EDGES, num_kps: int = 29,
                    temporal_patch: int = 2) -> np.ndarray:
    """(TP·K, TP·K) whole-skeleton block mask of HGATE (`model_params.py:461-484`):
    the body graph with self loops on the diagonal blocks, same-joint links
    between neighbouring frames."""
    return block_tridiagonal(edges_to_dense(edges, num_kps, self_loops=True), temporal_patch)


def additive_mask(adj: np.ndarray, neg: float = -10000.0) -> np.ndarray:
    """{0,1} adjacency → additive attention mask {neg, 0}
    (`GATE.py:142` / `WGATE.py:190`: masked_fill(adj==0, -1e4) then (==1, 0))."""
    return np.where(adj == 0, np.float32(neg), np.float32(0.0))
