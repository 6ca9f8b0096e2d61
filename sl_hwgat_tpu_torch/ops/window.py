"""Token-major window layout maps: pure reshape/permute index maps, equal
element for element to ``sl_hwgat_tpu/ops/window.py``.

- ``window_partition`` (B,F,K,D) → (B·f·nW, TP·W, D)  (`HWGATE.py:30-47`)
- ``block_partition``  (B,F,K,D) → (B·f, TP·K, D), whole-skeleton temporal
  blocks (HGATE, `HGATE.py:30-47`)
- ``temporal_merge``   (B,F,K,D) → (B, F/TP, K, TP·D) (`HWGATE.py:49-63`)
- ``spatial_window_partition`` (B,F,K,D) → (B·nW, F·W, D), one spatial window
  over all frames (WGATE, `WGATE.py:32-66`)
"""

from __future__ import annotations

import torch


def window_partition(x: torch.Tensor, window_size: int, temporal_patch: int) -> torch.Tensor:
    """(B, F, K, D) → (B·f·nW, TP·W, D): TP frames × one spatial window."""
    b, f_total, k, d = x.shape
    tp, w = temporal_patch, window_size
    f, nw = f_total // tp, k // w
    x = x.reshape(b, f, tp, nw, w, d).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * f * nw, tp * w, d)


def window_reverse(x: torch.Tensor, window_size: int, temporal_patch: int,
                   temporal_dim: int, num_kps: int) -> torch.Tensor:
    """Inverse of :func:`window_partition`."""
    tp, w = temporal_patch, window_size
    f, nw = temporal_dim // tp, num_kps // w
    d = x.shape[-1]
    b = x.shape[0] // (f * nw)
    x = x.reshape(b, f, nw, tp, w, d).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, temporal_dim, num_kps, d)


def block_partition(x: torch.Tensor, temporal_patch: int) -> torch.Tensor:
    """(B, F, K, D) → (B·f, TP·K, D): TP frames of the whole skeleton."""
    b, f_total, k, d = x.shape
    return x.reshape(b * (f_total // temporal_patch), temporal_patch * k, d)


def block_reverse(x: torch.Tensor, temporal_patch: int, temporal_dim: int,
                  num_kps: int) -> torch.Tensor:
    """Inverse of :func:`block_partition`."""
    b = x.shape[0] // (temporal_dim // temporal_patch)
    return x.reshape(b, temporal_dim, num_kps, x.shape[-1])


def spatial_window_partition(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """(B, F, K, D) → (B·nW, F·W, D): one spatial window over all frames."""
    b, f, k, d = x.shape
    nw = k // window_size
    x = x.reshape(b, f, nw, window_size, d).permute(0, 2, 1, 3, 4)
    return x.reshape(b * nw, f * window_size, d)


def spatial_window_reverse(x: torch.Tensor, window_size: int, temporal_dim: int,
                           num_kps: int) -> torch.Tensor:
    """Inverse of :func:`spatial_window_partition`."""
    d = x.shape[-1]
    nw = num_kps // window_size
    b = x.shape[0] // nw
    x = x.reshape(b, nw, temporal_dim, window_size, d).permute(0, 2, 1, 3, 4)
    return x.reshape(b, temporal_dim, num_kps, d)


def temporal_merge(x: torch.Tensor, temporal_patch: int) -> torch.Tensor:
    """(B, F, K, D) → (B, F/TP, K, TP·D). The reference transposes (TP, K)
    before flattening, so channel block t of joint k is frame t's features."""
    b, f_total, k, d = x.shape
    f = f_total // temporal_patch
    x = x.reshape(b, f, temporal_patch, k, d).permute(0, 1, 3, 2, 4)
    return x.reshape(b, f, k, temporal_patch * d)
