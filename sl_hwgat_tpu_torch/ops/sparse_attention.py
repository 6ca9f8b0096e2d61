"""Sparse (ELL) gather/scatter graph attention.

Counterpart of ``sl_hwgat_tpu/ops/sparse_attention.py``: scores computed
only on graph edges, a softmax over each node's edge list, and the output as
a gather-weighted sum of its neighbours' values. The topology is a
fixed-degree ELL table (``graphs.adjacency.dense_to_ell``), so every shape is
static.

The semantics are those of the additive-mask models (GATE, WGATE): the dense
form adds −1e4 off the edges, whose softmax weight underflows to exactly 0
in f32, so a softmax over a node's edge slots (padded slots at −1e4) is the
dense row softmax.

The JAX package computes this with a plain gather, two einsums and an edge
softmax, and no Pallas kernel; so does the port, with ordinary torch ops
(the gather's backward, an index accumulation, is torch's; on a card it uses
atomics, so its gradients are not bit for bit the same from run to run).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from sl_hwgat_tpu_torch.graphs.adjacency import dense_to_ell

NEG = -10000.0


def ell_graph_attention(q, k, v, col_idx, valid, *, scale: float) -> torch.Tensor:
    """Edge-space attention over a fixed-degree graph.

    q, k, v: (G, H, T, dh), T graph nodes (e.g. F·K spatio-temporal joints).
    col_idx: (T, D) integer neighbour table; valid: (T, D) {0,1} mask of the
    padded slots (numpy arrays or tensors). Returns (G, H, T, dh) float32:
    ``q * scale`` in q's own type, the scores and the output in f32 (a bf16
    input's products are exact in f32).
    """
    col = torch.as_tensor(col_idx, device=q.device).long()
    val = torch.as_tensor(valid, device=q.device).float()
    k_nbr = k.float()[:, :, col]                 # (G, H, T, D, dh) gather
    v_nbr = v.float()[:, :, col]
    s = torch.einsum("ghtd,ghtjd->ghtj", (q * scale).float(), k_nbr)
    s = s.masked_fill(val != 1, NEG)
    a = torch.exp(s - s.amax(dim=-1, keepdim=True))
    a = a / a.sum(dim=-1, keepdim=True)
    return torch.einsum("ghtj,ghtjd->ghtd", a, v_nbr)


def ell_from_dense(adj: np.ndarray):
    """Dense {0,1} adjacency → (col_idx, valid) ELL tables."""
    return dense_to_ell(adj)


_ELL_CACHE: dict = {}
_LOCK = threading.Lock()


def ell_from_band(spatial_additive: np.ndarray, frames: int, device=None):
    """ELL tables of the family's spatio-temporal topology: same-frame
    spatial edges (where the additive plane is 0) and same-joint ±1-frame
    links, the edge set the banded attention covers. Padded slots point at
    node 0. Cached per (topology, frames); with ``device``, the tables as
    (int64, float32) tensors there, cached too (a copy from host memory
    would wait on the card at every call)."""
    key = (frames, spatial_additive.shape, spatial_additive.tobytes())
    if device is not None:
        dkey = key + (str(device),)
        with _LOCK:
            hit = _ELL_CACHE.get(dkey)
        if hit is None:
            col, val = ell_from_band(spatial_additive, frames)
            with torch.inference_mode(False):  # the gather's backward saves col
                hit = (torch.from_numpy(col).long().to(device),
                       torch.from_numpy(val).to(device))
            if not torch.compiler.is_compiling():  # a traced tensor is no cache entry
                with _LOCK:
                    _ELL_CACHE[dkey] = hit
        return hit
    with _LOCK:
        hit = _ELL_CACHE.get(key)
    if hit is not None:
        return hit
    vtok = spatial_additive.shape[0]
    nbrs = [np.nonzero(spatial_additive[i] == 0)[0] for i in range(vtok)]
    deg = max(len(n) for n in nbrs) + 2
    col = np.zeros((frames * vtok, deg), np.int32)
    val = np.zeros((frames * vtok, deg), np.float32)
    for f in range(frames):
        for i in range(vtok):
            t = f * vtok + i
            slots = [f * vtok + j for j in nbrs[i]]
            if f > 0:
                slots.append((f - 1) * vtok + i)
            if f < frames - 1:
                slots.append((f + 1) * vtok + i)
            col[t, : len(slots)] = slots
            val[t, : len(slots)] = 1.0
    with _LOCK:
        _ELL_CACHE[key] = (col, val)
    return col, val
