"""Adjacency-masked multi-head attention in plain PyTorch.

Counterpart of ``sl_hwgat_tpu/ops/attention.py``:

1. ``masked_msa_oracle``: the reference MSA semantics written out literally
   (`hwgat/models/HWGATE.py:84-118`), the numerics oracle of the tests.
2. ``stacked_window_attention``: the plain version of the fused window
   attention kernel (``csrc/window_attention_fwd.cu``). S units of N tokens
   are stacked into supertiles of S·N rows exactly as the JAX function does;
   cross-unit and padded scores go to 2·NEG, so after the f32 softmax they
   are exactly 0 and the result equals a per-unit softmax.

The reference's quirks are kept under the same flags:

- multiplicative masking also sends scores that are exactly zero to -1e4
  (``attn.masked_fill(attn == 0, -1e4)``, `HWGATE.py:110`): ``zero_quirk``;
- train-time pruning (`HWGATE.py:94-100`) zeroes the scores whose softmax
  probability over the raw scores exceeds a scalar drawn once per call:
  ``prune_u``.
"""

from __future__ import annotations

import numpy as np
import torch

NEG = -10000.0
# Finite stand-in for -inf when isolating units inside a supertile: exp of it
# underflows to exactly 0 and inf - inf never appears.
UNIT_NEG = -1e30


def _softmax(s: torch.Tensor) -> torch.Tensor:
    """exp(s - max) / sum over the last axis, in the JAX package's order."""
    a = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return a / a.sum(dim=-1, keepdim=True)


def _prune(scores: torch.Tensor, prune_u) -> torch.Tensor:
    """Zero the scores whose softmax probability exceeds ``prune_u``; the
    zeros are then caught by the ==0 quirk (`HWGATE.py:94-100`)."""
    return torch.where(_softmax(scores) > prune_u, 0.0, scores)


def masked_msa_oracle(q, k, v, *, adj=None, add_mask=None, scale: float,
                      zero_quirk: bool = True, prune_u=None) -> torch.Tensor:
    """Reference-ordered masked attention on (G, H, N, dh) float tensors.

    ``adj``: (M, N, N) multiplicative {0,1} mask, group g uses ``adj[g % M]``.
    ``add_mask``: (M, N, N) additive {-1e4, 0} mask with the same period.
    """
    g, h, n, _ = q.shape
    s = torch.einsum("ghnd,ghmd->ghnm", q * scale, k)
    if prune_u is not None:
        s = _prune(s, prune_u)
    if adj is not None:
        m = adj.shape[0]
        s = (s.reshape(g // m, m, h, n, n) * adj[None, :, None]).reshape(g, h, n, n)
        if zero_quirk:
            s = torch.where(s == 0, NEG, s)
    if add_mask is not None:
        m = add_mask.shape[0]
        s = (s.reshape(g // m, m, h, n, n) + add_mask[None, :, None]).reshape(g, h, n, n)
    return torch.einsum("ghnm,ghmd->ghnd", _softmax(s), v)


def tile_planes(adj, n: int, np_: int, stack: int) -> tuple[np.ndarray, np.ndarray]:
    """(allowed, unit) {0,1} planes of one (stack·Np)² supertile: the
    block-diagonal adjacency and the block-diagonal unit membership, both
    with padded tokens removed."""
    adj_p = np.zeros((np_, np_), dtype=np.float32)
    adj_p[:n, :n] = np.asarray(adj, dtype=np.float32)
    valid = np.zeros((np_,), np.float32)
    valid[:n] = 1.0
    tok = np.tile(valid, stack)
    outer = tok[None, :] * tok[:, None]
    eye = np.eye(stack, dtype=np.float32)
    allowed = np.kron(eye, adj_p) * outer
    unit = np.kron(eye, np.ones((np_, np_), np.float32)) * outer
    return allowed, unit


def stacked_window_attention(q, k, v, adj, *, scale: float, stack: int = 4,
                             pad_tokens: int | None = None, zero_quirk: bool = True,
                             prune_u=None, tail_adj=None, sel=None,
                             out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Masked attention over (U, N, dh) units through S·N-token supertiles.

    All units share the (N, N) multiplicative ``adj``; with ``tail_adj`` and
    ``sel`` (a (U/stack,) integer tensor, 1 where the supertile attends under
    ``tail_adj``) each supertile picks one of the two planes. ``pad_tokens``
    pads N up; padded tokens are masked out and stripped from the output.
    ``prune_u``: None, a float, or a one-element tensor.

    The numerics are the fused kernel's: q·scale is rounded to q's type,
    scores and softmax are f32, the probabilities are rounded to v's type
    before the f32-accumulated product with V, and the result is stored as
    ``out_dtype`` (default float32). For float32 inputs this is the JAX
    package's ``stacked_window_attention``.
    """
    u, n, dh = q.shape
    np_ = n if pad_tokens is None else pad_tokens
    if np_ != n:
        pad = (0, 0, 0, np_ - n)
        q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
    t = u // stack
    qs, ks, vs = (x.reshape(t, stack * np_, dh) for x in (q, k, v))
    dev = q.device

    allowed_np, unit_np = tile_planes(adj, n, np_, stack)
    allowed = torch.from_numpy(allowed_np != 0).to(dev)
    if tail_adj is not None:
        tail = torch.from_numpy(tile_planes(tail_adj, n, np_, stack)[0] != 0).to(dev)
        allowed = torch.where(sel.to(dev).bool()[:, None, None], tail, allowed)
    unit = torch.from_numpy(unit_np != 0).to(dev)

    scaled = qs * torch.tensor(scale, dtype=q.dtype, device=dev)
    s = torch.matmul(scaled.float(), ks.float().transpose(1, 2))
    if prune_u is not None:
        s_iso = torch.where(unit, s, UNIT_NEG)
        s = torch.where(_softmax(s_iso) > prune_u, 0.0, s)
    keep = allowed & (s != 0) if zero_quirk else allowed
    s = torch.where(keep, s, NEG)
    # Cross-unit / padded entries sit below the -1e4 mask level, so a fully
    # masked row still softmaxes uniformly over its own unit's tokens.
    s = torch.where(unit, s, 2 * NEG)
    a = _softmax(s).to(v.dtype)
    out = torch.matmul(a.float(), vs.float()).reshape(u, np_, dh)
    if np_ != n:
        out = out[:, :n]
    return out.to(out_dtype or torch.float32)
