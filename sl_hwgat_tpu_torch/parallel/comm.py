"""The collectives of the parallel layer, as autograd Functions.

Only ``all_reduce``, ``all_gather`` and ``broadcast`` are used: the gloo
backend runs them on CUDA tensors too (ranks that share one card), while it
has no send/recv for them. Every Function names its backward:

- ``copy_to``: identity forward, all-reduce backward (Megatron's f, at the
  input of a tp-split branch);
- ``reduce_from``: all-reduce forward, identity backward (Megatron's g, at
  the output of a row-split layer and at the sp pool, where every rank
  holds the same downstream gradient);
- ``all_reduce``: all-reduce both ways, the exact adjoint (global
  BatchNorm statistics, where each dp rank's loss is its own);
- ``ring_take``: each rank takes the tensor of the rank ``offset`` places
  on around the ring (cyclic), and in the backward the gradient goes back
  to its owner and is added there (the shifted blocks' roll);
- ``halo_extend``: a rank's (P, T, C) planes with the neighbours' boundary
  tokens attached (none before the first rank, none after the last), and in
  the backward the halo gradients go back to their owners. One Function
  for both ends, whose output every rank uses, so every rank takes part in
  the backward's collective (a halo that a rank dropped would leave its
  gradient's all_gather out on that rank alone).

``gather_rows`` concatenates a tensor over a group, with no gradient.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _reduced(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


def _gathered(x: torch.Tensor, group) -> list[torch.Tensor]:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return parts


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group), None


class _RingTake(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, offset):
        ctx.group, ctx.offset = group, offset
        n, r = dist.get_world_size(group), dist.get_rank(group)
        return _gathered(x, group)[(r + offset) % n]

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return _gathered(g, ctx.group)[(r - ctx.offset) % n], None, None


class _HaloExtend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, width):
        n, r = dist.get_world_size(group), dist.get_rank(group)
        ctx.group, ctx.width, ctx.tokens = group, width, x.shape[1]
        parts = _gathered(torch.cat([x[:, :width], x[:, -width:]], 1), group)
        pieces = [x]
        if r > 0:
            pieces.insert(0, parts[r - 1][:, width:])
        if r < n - 1:
            pieces.append(parts[r + 1][:, :width])
        return torch.cat(pieces, 1)

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        w, t = ctx.width, ctx.tokens
        lo = w if r > 0 else 0
        zeros = torch.zeros_like(g[:, :w])
        halo = torch.cat([g[:, :w] if r > 0 else zeros, g[:, lo + t:] if r < n - 1 else zeros], 1)
        parts = _gathered(halo, ctx.group)
        own = g[:, lo:lo + t].clone()
        if r < n - 1:  # my last tokens were the next rank's left halo
            own[:, -w:] += parts[r + 1][:, :w]
        if r > 0:  # my first tokens were the previous rank's right halo
            own[:, :w] += parts[r - 1][:, w:]
        return own, None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduce.apply(x, group)


def ring_take(x: torch.Tensor, group, offset: int) -> torch.Tensor:
    """The ``x`` of the rank ``offset`` places on in ``group`` (cyclic)."""
    return _RingTake.apply(x, group, offset)


def halo_extend(x: torch.Tensor, group, width: int) -> torch.Tensor:
    """(P, T, C) → (P, [w +] T [+ w], C): the previous rank's last ``width``
    tokens before ``x`` (not on the first rank) and the next rank's first
    ``width`` tokens after it (not on the last rank)."""
    return _HaloExtend.apply(x, group, width)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of every rank of ``group``, concatenated along dim 0 in rank
    order (no gradient)."""
    with torch.no_grad():
        return torch.cat(_gathered(x.detach(), group))


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (no gradient)."""
    with torch.no_grad():
        return _reduced(x.detach(), group)
