"""Attention masks of the graph-attention models: the multiplicative {0,1}
masks of the windowed models (reference `hwgat/models/model_params.py:373-400`)
and of HGATE (`:461-484`), GATE's flat spatio-temporal adjacency (`:60-73`),
the additive {-1e4, 0} form of the banded ones, and the sparse (CSR, ELL)
forms of a dense adjacency.

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


def spatio_temporal_adj(edges, num_frames: int, num_kps: int) -> np.ndarray:
    """(F·K, F·K) flat spatio-temporal adjacency of GATE: per frame the
    symmetric spatial edges (no self loops), and same-joint links between
    consecutive frames. ≡ `model_params.py:60-73` (``GATEParams.get_adj``)."""
    n = num_frames * num_kps
    a = np.zeros((n, n), dtype=np.float32)
    for f in range(num_frames):
        base = f * num_kps
        for i, j in edges:
            a[base + i, base + j] = 1
            a[base + j, base + i] = 1
        if f < num_frames - 1:
            for i in range(num_kps):
                a[base + i, base + i + num_kps] = 1
                a[base + i + num_kps, base + i] = 1
    return a


def additive_mask(adj: np.ndarray, neg: float = -10000.0) -> np.ndarray:
    """{0,1} adjacency → additive attention mask {neg, 0}
    (`GATE.py:142` / `WGATE.py:190`: masked_fill(adj==0, -1e4) then (==1, 0))."""
    return np.where(adj == 0, np.float32(neg), np.float32(0.0))


def dense_to_csr(adj: np.ndarray):
    """Dense {0,1} adjacency → (indptr, indices) int32 CSR."""
    indptr = [0]
    indices = []
    for row in adj:
        indices.extend(np.nonzero(row)[0].tolist())
        indptr.append(len(indices))
    return np.asarray(indptr, dtype=np.int32), np.asarray(indices, dtype=np.int32)


def dense_to_ell(adj: np.ndarray, pad_to: int | None = None):
    """Dense {0,1} adjacency → fixed-degree ELL form ``(col_idx, valid)`` of
    shape (N, max_deg): column indices padded with the row's own index, and
    a {0,1} float32 validity mask."""
    n = adj.shape[0]
    degs = (adj != 0).sum(axis=1)
    max_deg = int(degs.max()) if pad_to is None else pad_to
    col = np.zeros((n, max_deg), dtype=np.int32)
    valid = np.zeros((n, max_deg), dtype=np.float32)
    for i in range(n):
        nz = np.nonzero(adj[i])[0]
        col[i, : len(nz)] = nz
        col[i, len(nz):] = i
        valid[i, : len(nz)] = 1.0
    return col, valid


def num_edges(adj: np.ndarray) -> int:
    """Count of nonzero entries (directed edges, self loops included)."""
    return int((adj != 0).sum())
