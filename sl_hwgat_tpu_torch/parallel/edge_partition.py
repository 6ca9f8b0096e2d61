"""Banded attention over frames split across sp ranks, with a halo
exchange, ≡ ``sl_hwgat_tpu/parallel/edge_partition.py``.

For the banded models (WGATE, GATE) the only edges that cross a split of
the frame axis are the same-joint ±1-frame links, so a rank needs exactly
one boundary frame of k and v from each neighbour (BASELINE.json config
5). ``call_sharded_banded`` gets them with ``comm.halo_extend`` (one
``all_gather`` of the boundary frames: gloo has no send/recv for CUDA
tensors), attaches them to the rank's (P, F_loc·V, dh) planes, and runs
``ops.banded_attention.banded_attention`` (K8 and its backward) on
F_loc + 1 frames (the first and last rank) or F_loc + 2. The halo frames'
queries are zeros and their outputs are dropped; no q crosses ranks, as in
JAX. In the backward the gradients of the halo frames go back to their
owner and are added there. The first rank has no left halo and the last
no right one (JAX's ``edge_valid``), so their boundary frames see exactly
the clip's ends, and every real row sees the edges it has in the whole
clip: the result is the unsharded op's.

Windowed models (HWGATE, HGATE) need no halo: their attention units are
disjoint edge blocks (``kernel_sharding``).
"""

from __future__ import annotations

import numpy as np
import torch

from sl_hwgat_tpu_torch.parallel import mesh as mesh_lib


def sp_active() -> bool:
    """True inside a layout that splits the frames over more than one rank."""
    layout = mesh_lib.active()
    return layout is not None and layout.sp > 1


def call_sharded_banded(q, k, v, band, *, scale: float, out_dtype=None) -> torch.Tensor:
    """The banded attention of a rank's (P, F_loc·V, dh) planes, whose frames
    are its sp shard of the clip's: (P, F_loc·V, dh) in ``out_dtype``."""
    from sl_hwgat_tpu_torch.ops.banded_attention import banded_attention
    from sl_hwgat_tpu_torch.parallel.comm import halo_extend

    layout = mesh_lib.active()
    group, rank, n = layout.group("sp"), layout.rank("sp"), layout.sp
    nv = np.shape(band)[1]
    dh = q.shape[-1]
    # k and v with the neighbours' boundary frames attached, one exchange
    kv = halo_extend(torch.cat([k, v], -1), group, nv)
    halo_q = torch.zeros_like(q[:, :nv])
    q_ext = torch.cat(([halo_q] if rank > 0 else []) + [q] + ([halo_q] if rank < n - 1 else []), 1)
    out = banded_attention(q_ext, kv[..., :dh].contiguous(), kv[..., dh:].contiguous(), band,
                           scale=scale, out_dtype=out_dtype)
    lo = nv if rank > 0 else 0
    return out[:, lo:lo + q.shape[1]]
