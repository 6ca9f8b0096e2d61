"""Adjacency-masked multi-head attention in plain PyTorch.

Counterpart of ``sl_hwgat_tpu/ops/attention.py``:

1. ``masked_msa_oracle``: the reference MSA semantics written out literally
   (`hwgat/models/HWGATE.py:84-118`), the numerics oracle of the tests.
2. ``stacked_window_attention``: the plain version of the fused window
   attention kernel (``csrc/window_attention_fwd.cu``). S units of N tokens
   are stacked into supertiles of S·N rows exactly as the JAX function does;
   cross-unit and padded scores go to 2·NEG, so after the f32 softmax they
   are exactly 0 and the result equals a per-unit softmax.
3. ``stacked_window_attention_bwd``: the plain version of the backward
   kernel (``csrc/window_attention_bwd.cu``), on the same supertiles.
   ``unit_masked_softmax`` and ``unit_masked_softmax_bwd`` are the plain
   versions of the masked-softmax kernels (``csrc/masked_softmax_*.cu``) on
   per-unit (U, N, N) scores; all of them mask through ``masked_scores``.
4. ``banded_frame_attention``: the JAX package's ±1-frame banded attention
   of GATE/WGATE (without its halo arguments); ``banded_frame_attention_k8``
   computes the same function with the rounding of the frame-packed TPU
   kernel, which the banded CUDA kernels follow, and
   ``banded_frame_attention_bwd`` is its gradient written out.

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


def _stack(x: torch.Tensor, np_: int, stack: int) -> torch.Tensor:
    """(U, N, dh) → (U/stack, stack·Np, dh) supertiles, tokens padded to Np."""
    u, n, dh = x.shape
    if np_ != n:
        x = torch.nn.functional.pad(x, (0, 0, 0, np_ - n))
    return x.reshape(u // stack, stack * np_, dh)


def _unstack(x: torch.Tensor, n: int, np_: int) -> torch.Tensor:
    """Inverse of ``_stack``: (T, stack·Np, dh) → (U, N, dh)."""
    return x.reshape(-1, np_, x.shape[-1])[:, :n]


def masked_scores(raw, allowed, *, zero_quirk, prune_u, unit=None):
    """The softmax input of raw f32 scores (the masking rules of
    `sl_hwgat_tpu/ops/pallas_attention.py:38-63`): prune over the raw
    scores of each row's own unit, then NEG wherever ``allowed`` is False
    or (``zero_quirk``) the pruned score is exactly 0. ``unit``: None when
    every entry of the last axis is a token of the row's unit, else the
    bool plane of the in-unit entries; the others go to 2·NEG."""
    s = raw
    if prune_u is not None:
        s_iso = s if unit is None else torch.where(unit, s, UNIT_NEG)
        s = torch.where(_softmax(s_iso) > prune_u, 0.0, s)
    keep = allowed & (s != 0) if zero_quirk else allowed
    s = torch.where(keep, s, NEG)
    # Cross-unit / padded entries sit below the -1e4 mask level, so a fully
    # masked row still softmaxes uniformly over its own unit's tokens.
    return s if unit is None else torch.where(unit, s, 2 * NEG)


def _tile_scores(qs, ks, adj, *, n, np_, stack, scale, zero_quirk, prune_u, tail_adj, sel):
    """(raw, masked) f32 scores of the supertiles: the raw scores of the
    scaled q, and the scores after pruning, adjacency masking and unit
    isolation (the softmax input)."""
    dev = qs.device
    allowed_np, unit_np = tile_planes(adj, n, np_, stack)
    allowed = torch.from_numpy(allowed_np != 0).to(dev)
    if tail_adj is not None:
        tail = torch.from_numpy(tile_planes(tail_adj, n, np_, stack)[0] != 0).to(dev)
        allowed = torch.where(sel.to(dev).bool()[:, None, None], tail, allowed)
    unit = torch.from_numpy(unit_np != 0).to(dev)

    scaled = qs * torch.tensor(scale, dtype=qs.dtype, device=dev)
    raw = torch.matmul(scaled.float(), ks.float().transpose(1, 2))
    return raw, masked_scores(raw, allowed, zero_quirk=zero_quirk, prune_u=prune_u, unit=unit)


def unit_allowed(adj, tail_adj, sel, units: int, stack: int, device) -> torch.Tensor:
    """(U, N, N) bool adjacency of every unit: ``adj``, or ``tail_adj`` for
    the units of each supertile of ``stack`` units whose ``sel`` is 1."""
    allowed = torch.from_numpy(np.asarray(adj, dtype=np.float32) != 0).to(device)
    if tail_adj is None:
        return allowed.expand(units, -1, -1)
    tail = torch.from_numpy(np.asarray(tail_adj, dtype=np.float32) != 0).to(device)
    per_unit = sel.to(device).bool().repeat_interleave(stack)
    return torch.where(per_unit[:, None, None], tail, allowed)


def unit_masked_softmax(s, adj, *, stack: int = 4, zero_quirk: bool = True, prune_u=None,
                        tail_adj=None, sel=None,
                        p_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """P = softmax of the masked (U, N, N) f32 scores ``s``, one N-token unit
    each, stored as ``p_dtype``: the per-unit form of the JAX package's
    ``_masked_softmax`` (`sl_hwgat_tpu/ops/hybrid_attention.py:46-58`), whose
    (T, S·Np, S·Np) supertiles hold these blocks on their diagonal and exact
    zeros elsewhere. ``sel``: (U/stack,) ints, 1 where a supertile of
    ``stack`` units attends under ``tail_adj``."""
    allowed = unit_allowed(adj, tail_adj, sel, s.shape[0], stack, s.device)
    sm = masked_scores(s, allowed, zero_quirk=zero_quirk, prune_u=prune_u)
    return _softmax(sm).to(p_dtype)


def unit_masked_softmax_bwd(s, dp, adj, *, stack: int = 4, zero_quirk: bool = True,
                            prune_u=None, tail_adj=None, sel=None) -> torch.Tensor:
    """dS of ``unit_masked_softmax`` for the gradient ``dp`` of P, written out
    as `sl_hwgat_tpu/ops/hybrid_attention.py:61-75` computes it: A is
    recomputed in f32, dS = A∘(dP − rowsum(dP∘A)), kept only where the
    masked score still equals the raw one (the prune mask is not
    differentiated). f32, like the scores."""
    allowed = unit_allowed(adj, tail_adj, sel, s.shape[0], stack, s.device)
    sm = masked_scores(s, allowed, zero_quirk=zero_quirk, prune_u=prune_u)
    a = _softmax(sm)
    dpf = dp.float()
    ds = a * (dpf - (dpf * a).sum(dim=-1, keepdim=True))
    return ds * (sm == s)


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
    n = q.shape[1]
    np_ = n if pad_tokens is None else pad_tokens
    qs, ks, vs = (_stack(x, np_, stack) for x in (q, k, v))
    _, s = _tile_scores(qs, ks, adj, n=n, np_=np_, stack=stack, scale=scale,
                        zero_quirk=zero_quirk, prune_u=prune_u, tail_adj=tail_adj, sel=sel)
    a = _softmax(s).to(v.dtype)
    out = _unstack(torch.matmul(a.float(), vs.float()), n, np_)
    return out.to(out_dtype or torch.float32)


def stacked_window_attention_bwd(q, k, v, do, adj, *, scale: float, stack: int = 4,
                                 pad_tokens: int | None = None, zero_quirk: bool = True,
                                 prune_u=None, tail_adj=None, sel=None):
    """(dq, dk, dv) of ``stacked_window_attention`` for the output gradient
    ``do``: the plain version of the backward kernel
    (``csrc/window_attention_bwd.cu``), written out as the JAX package's
    ``_bwd_kernel`` computes it (`sl_hwgat_tpu/ops/pallas_attention.py:295-353`).

    With dt = q's dtype: dO is cast to dt; A is recomputed exactly as the
    forward does; dV = dt(A)ᵀ·dO; dA = dO·Vᵀ; dS = A∘(dA − rowsum(dA∘A)),
    kept only where the masked score still equals the raw one (masked,
    zero-quirk and pruned entries pass no gradient; the prune mask itself is
    not differentiated), then rounded to dt; dQ = (dS·K)·scale and
    dK = (dSᵀ·Q)·scale. Products sum in f32; every gradient is stored in dt.
    """
    dt = q.dtype
    n = q.shape[1]
    np_ = n if pad_tokens is None else pad_tokens
    qs, ks, vs, dos = (_stack(x, np_, stack) for x in (q, k, v, do.to(dt)))
    raw, s = _tile_scores(qs, ks, adj, n=n, np_=np_, stack=stack, scale=scale,
                          zero_quirk=zero_quirk, prune_u=prune_u, tail_adj=tail_adj, sel=sel)
    a = _softmax(s)
    dof = dos.float()
    dv = torch.matmul(a.to(dt).float().transpose(1, 2), dof).to(dt)
    da = torch.matmul(dof, vs.float().transpose(1, 2))
    ds = a * (da - (da * a).sum(dim=-1, keepdim=True))
    ds = (ds * (s == raw)).to(dt).float()
    dq = (torch.matmul(ds, ks.float()) * scale).to(dt)
    dk = (torch.matmul(ds.transpose(1, 2), qs.float()) * scale).to(dt)
    return tuple(_unstack(x, n, np_) for x in (dq, dk, dv))


def _frame_neighbours(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(G, H, F, V, dh) → (frame f−1, frame f+1) of every frame, zeros past
    the clip's ends."""
    zeros = torch.zeros_like(x[:, :, :1])
    return torch.cat([zeros, x[:, :, :-1]], 2), torch.cat([x[:, :, 1:], zeros], 2)


def _shift_frames(x: torch.Tensor, step: int) -> torch.Tensor:
    """out[:, :, f] = x[:, :, f + step] for step ±1, zeros past the ends."""
    prev, nxt = _frame_neighbours(x)
    return nxt if step == 1 else prev


def _banded_scores(q, k, band_mask, *, scale, round_q: bool) -> torch.Tensor:
    """(G, H, F, V, 3V) f32 scores of every query against the keys of frames
    f−1, f and f+1 plus the additive band, with −1e4 on the prev block of
    frame 0 and the next block of frame F−1. ``round_q``: q·scale in q's type
    before the dot (``banded_frame_attention``); else the f32 dot times scale
    (the frame-packed kernel)."""
    f, v = q.shape[2], q.shape[3]
    dev = q.device
    kp, kn = _frame_neighbours(k)
    k_band = torch.cat([kp, k, kn], 3).float()
    if round_q:
        s = torch.einsum("ghfvd,ghfwd->ghfvw",
                         (q * torch.tensor(scale, dtype=q.dtype, device=dev)).float(), k_band)
    else:
        s = torch.einsum("ghfvd,ghfwd->ghfvw", q.float(), k_band) * scale
    band = torch.as_tensor(np.asarray(band_mask, dtype=np.float32), device=dev)
    s = s + torch.cat([band[0], band[1], band[2]], -1)
    fidx = torch.arange(f, device=dev)
    left = (fidx == 0).float() * NEG
    right = (fidx == f - 1).float() * NEG
    edge = torch.cat([left[:, None].expand(f, v), torch.zeros(f, v, device=dev),
                      right[:, None].expand(f, v)], -1)
    return s + edge[:, None, :]


def banded_frame_attention(q, k, v, band_mask, *, scale: float) -> torch.Tensor:
    """Additive-masked attention with block-tridiagonal (±1 frame) structure:
    the JAX package's ``banded_frame_attention`` without halo
    (`sl_hwgat_tpu/ops/attention.py:162-231`).

    q, k, v: (G, H, F, V, dh), tokens grouped by frame; ``band_mask``: (3, V, V)
    additive masks (0 on edges, −1e4 off) for the [prev | self | next] key
    frames. q·scale is rounded to q's type, scores and softmax are f32, the
    probabilities are rounded to v's type before the f32-summed product.
    Returns f32.
    """
    s = _banded_scores(q, k, band_mask, scale=scale, round_q=True)
    vp, vn = _frame_neighbours(v)
    v_band = torch.cat([vp, v, vn], 3).float()
    return torch.einsum("ghfvw,ghfwd->ghfvd", _softmax(s).to(v.dtype).float(), v_band)


def banded_frame_attention_k8(q, k, v, band_mask, *, scale: float,
                              out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``banded_frame_attention`` rounded where the frame-packed TPU kernel
    rounds (`sl_hwgat_tpu/ops/pallas_banded.py:408-424`): scores are the f32
    dot of q and k times scale; the self block's probabilities are rounded to
    v's type before A·V, the prev/next blocks' are not; the result is stored
    as ``out_dtype`` (default f32). For f32 inputs it is
    ``banded_frame_attention`` up to the order of f32 sums."""
    nv = q.shape[3]
    a_prev, a_self, a_next = _softmax(
        _banded_scores(q, k, band_mask, scale=scale, round_q=False)).split(nv, -1)
    vp, vn = _frame_neighbours(v.float())
    out = (torch.einsum("ghfvw,ghfwd->ghfvd", a_self.to(v.dtype).float(), v.float())
           + torch.einsum("ghfvw,ghfwd->ghfvd", a_prev, vp)
           + torch.einsum("ghfvw,ghfwd->ghfvd", a_next, vn))
    return out.to(out_dtype or torch.float32)


def banded_frame_attention_bwd(q, k, v, do, band_mask, *, scale: float):
    """(dq, dk, dv) of ``banded_frame_attention_k8`` for the output gradient
    ``do``, written out as the frame-packed TPU kernel's backward computes it
    (`sl_hwgat_tpu/ops/pallas_banded.py:427-481`). With dt = q's dtype: dO is
    cast to dt; A is recomputed; dP = dO·V_bandᵀ and D = Σ A∘dP over all
    three blocks (f32); dS = A∘(dP − D); the self block's dS and A are
    rounded to dt before their products; key frame f gathers from the query
    frames f+1 (their prev block), f and f−1 (their next block). Products sum
    in f32; every gradient is stored in dt."""
    dt = q.dtype
    nv = q.shape[3]
    a = _softmax(_banded_scores(q, k, band_mask, scale=scale, round_q=False))
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.to(dt).float()
    kp, kn = _frame_neighbours(kf)
    vp, vn = _frame_neighbours(vf)
    dp = torch.einsum("ghfvd,ghfwd->ghfvw", dof, torch.cat([vp, vf, vn], 3))
    ds = a * (dp - (a * dp).sum(-1, keepdim=True))
    ds_prev, ds_self, ds_next = ds.split(nv, -1)
    ds_self = ds_self.to(dt).float()
    a_prev, a_self, a_next = a.split(nv, -1)

    def mm(x, y):  # (.., V, W) · (.., V, dh) contracted over the query rows
        return torch.einsum("ghfvw,ghfvd->ghfwd", x, y)

    dq = (torch.einsum("ghfvw,ghfwd->ghfvd", ds_self, kf) * scale
          + scale * (torch.einsum("ghfvw,ghfwd->ghfvd", ds_prev, kp)
                     + torch.einsum("ghfvw,ghfwd->ghfvd", ds_next, kn)))
    dk = (mm(ds_self, qf) * scale + scale * _shift_frames(mm(ds_prev, qf), 1)
          + scale * _shift_frames(mm(ds_next, qf), -1))
    dv = (mm(a_self.to(dt).float(), dof) + _shift_frames(mm(a_prev, dof), 1)
          + _shift_frames(mm(a_next, dof), -1))
    return dq.to(dt), dk.to(dt), dv.to(dt)
