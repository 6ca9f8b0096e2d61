"""The forward kernels of an eval forward as ``torch.library`` custom ops, so
that ``torch.export`` can trace a model through them
(``serve.Predictor.export_program``) and a loaded program launches them.

``torch.export`` traces with fake tensors, which have no ``data_ptr()``, so
a trace cannot go through the ctypes wrappers. While
``torch.compiler.is_compiling()``, the wrappers ``window_attention``
(K1), ``masked_softmax`` (K7's forward) and ``banded_attention`` (K8's
forward; K9 is the same launch under another band) call the functions here
instead; eager calls never do. Each op takes tensors and plain scalars
only: the masks as the device tensors the kernels read (row bitmasks,
band edge bits), ``sel`` and ``prune_u`` as tensors or None (``device_args``),
the window ops' masking mode as ``mask_mode``'s five ints. Its CUDA
implementation is the wrapper's launch (``launch`` of
``ops/window_attention.py``, ``ops/hybrid_attention.py``,
``ops/banded_attention.py``), which counts its launches as the eager path
does; its CPU implementation is the plain version, on the masks read back
from their bits; ``register_fake`` gives the output's shape and type.

Importing this module registers the ops (namespace ``sl_hwgat_torch``): a
process that loads an exported program imports it, and nothing of the
port's models.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sl_hwgat_tpu_torch.ops import banded_attention as banded_mod
from sl_hwgat_tpu_torch.ops import hybrid_attention as hybrid_mod
from sl_hwgat_tpu_torch.ops import window_attention as window_mod
from sl_hwgat_tpu_torch.ops.attention import NEG

NAMESPACE = "sl_hwgat_torch"


def mask_rows(words: torch.Tensor, n: int) -> np.ndarray:
    """(R,) row bitmask words (int32 or int64) → (R, n) {0,1} float32: entry
    j of row i is bit j of word i."""
    w = words.detach().cpu().numpy().astype(np.int64)
    return ((w[:, None] >> np.arange(n, dtype=np.int64)) & 1).astype(np.float32)


def _plain_mask_kw(masks, n, mode):
    """The plain versions' mask arguments from the kernels' (2, N) masks and
    ``mask_mode``'s (dual, stack, per_group, groups, unit_offset)."""
    dual, stack, per_group, groups, unit_offset = mode
    kw = dict(stack=stack, unit_offset=unit_offset, tail_adj=None, units_per_group=None,
              groups=None)
    if dual:
        kw.update(tail_adj=mask_rows(masks[1], n), units_per_group=per_group, groups=groups)
    return mask_rows(masks[0], n), kw


# --- K1: the fused window attention's forward ---------------------------------

@torch.library.custom_op(f"{NAMESPACE}::window_attention", mutates_args=(), device_types="cpu")
def window_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, masks: torch.Tensor,
                        sel: Optional[torch.Tensor], prune_u: Optional[torch.Tensor],
                        scale: float, pad_tokens: int, zero_quirk: bool, mode: list[int],
                        out_dtype: torch.dtype) -> torch.Tensor:
    """K1 on (U, N, dh) units; ``pad_tokens`` 0 for none. CPU: the plain
    version (contiguous, as the kernel's output is)."""
    adj, kw = _plain_mask_kw(masks, q.shape[1], mode)
    return window_mod.plain_window_attention(
        q, k, v, adj, scale=scale, pad_tokens=pad_tokens or None, zero_quirk=zero_quirk,
        prune_u=prune_u, sel=sel, out_dtype=out_dtype, **kw).contiguous()


@window_attention_op.register_kernel("cuda")
def _window_attention_cuda(q, k, v, masks, sel, prune_u, scale, pad_tokens, zero_quirk, mode,
                           out_dtype):
    window_mod._check_kernel_inputs(q, pad_tokens or None, {"q": q, "k": k, "v": v})
    return window_mod.launch(q, k, v, masks, sel, prune_u, scale=scale, zero_quirk=zero_quirk,
                             mode=tuple(mode), out_dtype=out_dtype)


@window_attention_op.register_fake
def _window_attention_fake(q, k, v, masks, sel, prune_u, scale, pad_tokens, zero_quirk, mode,
                           out_dtype):
    return q.new_empty(q.shape, dtype=out_dtype)


def window_attention(q, k, v, adj, *, scale, stack, pad_tokens, zero_quirk, prune_u, tail_adj,
                     units_per_group, groups, unit_offset, sel, out_dtype):
    """``window_attention``'s arguments → the op (the masks built by
    ``device_masks``, ``prune_u`` and ``sel`` by ``device_args``)."""
    prune_u, sel = window_mod.device_args(q, stack, prune_u, sel)
    return window_attention_op(
        q, k, v, window_mod.device_masks(adj, tail_adj, q.device), sel, prune_u, float(scale),
        int(pad_tokens or 0), bool(zero_quirk),
        list(window_mod.mask_mode(tail_adj, stack, units_per_group, groups, unit_offset)),
        out_dtype)


# --- K7: the masked softmax's forward ------------------------------------------

@torch.library.custom_op(f"{NAMESPACE}::masked_softmax", mutates_args=(), device_types="cpu")
def masked_softmax_op(s: torch.Tensor, masks: torch.Tensor, sel: Optional[torch.Tensor],
                      prune_u: Optional[torch.Tensor], zero_quirk: bool, mode: list[int],
                      p_dtype: torch.dtype) -> torch.Tensor:
    """K7's forward on (U, N, N) f32 scores. CPU: the plain version."""
    adj, kw = _plain_mask_kw(masks, s.shape[1], mode)
    return hybrid_mod.plain_masked_softmax(s, adj, zero_quirk=zero_quirk, prune_u=prune_u,
                                           sel=sel, p_dtype=p_dtype, **kw)


@masked_softmax_op.register_kernel("cuda")
def _masked_softmax_cuda(s, masks, sel, prune_u, zero_quirk, mode, p_dtype):
    hybrid_mod._check_scores(s)
    return hybrid_mod.launch(s.contiguous(), masks, sel, prune_u, zero_quirk=zero_quirk,
                             mode=tuple(mode), p_dtype=p_dtype)


@masked_softmax_op.register_fake
def _masked_softmax_fake(s, masks, sel, prune_u, zero_quirk, mode, p_dtype):
    return s.new_empty(s.shape, dtype=p_dtype)


def masked_softmax(s, adj, *, stack, zero_quirk, prune_u, tail_adj, units_per_group, groups,
                   unit_offset, sel, p_dtype):
    """``masked_softmax``'s arguments → the op."""
    prune_u, sel = window_mod.device_args(s, stack, prune_u, sel)
    return masked_softmax_op(
        s, window_mod.device_masks(adj, tail_adj, s.device, wide=True), sel, prune_u,
        bool(zero_quirk),
        list(window_mod.mask_mode(tail_adj, stack, units_per_group, groups, unit_offset)),
        p_dtype)


# --- K8 (and K9): the banded attention's forward -------------------------------

def band_of(bits: torch.Tensor, joints: int) -> np.ndarray:
    """(6, 32) band edge bits → the (3, V, V) additive band [prev | self |
    next] with entries {0, −1e4}."""
    edges = np.stack([mask_rows(bits[p, :joints], joints) for p in range(3)])
    return np.where(edges != 0, np.float32(0.0), np.float32(NEG))


@torch.library.custom_op(f"{NAMESPACE}::banded_attention", mutates_args=(), device_types="cpu")
def banded_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bits: torch.Tensor,
                        scale: float, joints: int, edges_per_row: int,
                        out_dtype: torch.dtype) -> torch.Tensor:
    """K8 on (P, F·V, dh) planes. CPU: the plain version."""
    band = band_of(bits, joints)
    banded_mod._check(q, {"k": k, "v": v}, band)
    return banded_mod.plain_banded_attention(q, k, v, band, scale=scale, out_dtype=out_dtype)


@banded_attention_op.register_kernel("cuda")
def _banded_attention_cuda(q, k, v, bits, scale, joints, edges_per_row, out_dtype):
    # the band's edge rows were checked where the op was traced (reading the
    # bits back here would wait on the card)
    banded_mod.check_planes(q, {"k": k, "v": v}, joints)
    return banded_mod.launch(q, k, v, bits, scale=scale, joints=joints,
                             edges_per_row=edges_per_row, out_dtype=out_dtype)


@banded_attention_op.register_fake
def _banded_attention_fake(q, k, v, bits, scale, joints, edges_per_row, out_dtype):
    return q.new_empty(q.shape, dtype=out_dtype)


def banded_attention(q, k, v, band, *, scale, out_dtype):
    """``banded_attention``'s arguments → the op (the band as ``_bits``),
    after the band's check."""
    banded_mod.check_band(band, q.shape[1] // np.shape(band)[1])
    return banded_attention_op(q, k, v, banded_mod._bits(band, q.device), float(scale),
                               int(np.shape(band)[1]), banded_mod.edges_per_row(band), out_dtype)
