"""Sharding rules and the sharded train and eval steps,
≡ ``sl_hwgat_tpu/parallel/sharding.py``.

- **dp**: each rank takes its rows of the batch (``local_batch``). The loss
  of a rank is its rows' valid-weighted loss sum over the global valid
  count, so the gradients summed over the ranks are the global batch's,
  however the padding falls. STGCN's and DecoupledGCN's BatchNorm take
  their statistics over the global batch (``global_batch_norm``).
- **sp**: each rank takes its frames of every clip; the models' sp hooks
  (the shifted roll, the positional encoding's offset, the pool, the
  banded models' halo) make a rank's work its share of the clip's.
- **tp** (HWGATE): Megatron over heads. ``TP_RULES`` name the state_dict
  entries a tp rank holds a slice of; ``shard_model`` keeps only that
  slice in each parameter.

Every rank holds the same loss and logits. Gradients are summed over the
ranks that share this rank's tp coordinate (``Layout.grad_group``; the tp
ranks' gradients of replicated parameters are already equal, Megatron's f
and g make them so). The parameters after the sp pool (the model's
``sp_replicated``) see the whole clip on every sp rank, so their gradients
are taken from sp rank 0 only. Each model declares what may be split in
it (``models.common.Splittable``). The state_dict keys and layout stay
those of the unsharded model: ``unshard_state_dict`` gathers a rank's
tensors back into them.
"""

from __future__ import annotations

import re
import types

import numpy as np
import torch

from sl_hwgat_tpu_torch.parallel import mesh as mesh_lib
from sl_hwgat_tpu_torch.parallel.comm import all_reduce, gather_rows, reduce_sum

# (state_dict key regex, how a tp rank holds it) — first match wins; default
# replicate. The kinds, in the port's (out, in) weight layout:
# "qkv": the fused projection's rows [q | k | v] with heads major inside each
#        third, so a rank holds its heads' rows of each third (JAX's q/k/v
#        kernels column-split by head);
# "rows": a rank holds a contiguous block of rows (JAX's column split);
# "cols": a rank holds a contiguous block of columns (JAX's row split).
TP_RULES: list[tuple[str, str]] = [
    (r".*attn\.qkv\.(weight|bias)$", "qkv"),
    (r".*attn\.proj\.weight$", "cols"),
    (r".*ff\.fc1\.(weight|bias)$", "rows"),
    (r".*ff\.fc2\.weight$", "cols"),
]


def tp_kind(name: str) -> str | None:
    for pattern, kind in TP_RULES:
        if re.match(pattern, name):
            return kind
    return None


def shard_tensor(x: torch.Tensor, kind: str | None, tp: int, rank: int) -> torch.Tensor:
    """The slice of ``x`` that tp rank ``rank`` of ``tp`` holds."""
    if kind is None or tp == 1:
        return x
    if kind == "qkv":
        third = x.shape[0] // 3
        if third % tp:
            raise ValueError(f"{third} q rows do not split over tp {tp}")
        per = third // tp
        return x.reshape(3, tp, per, *x.shape[1:])[:, rank].reshape(3 * per, *x.shape[1:])
    dim = 0 if kind == "rows" else 1
    if x.shape[dim] % tp:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over tp {tp}")
    return x.chunk(tp, dim)[rank]


def merge_tensor(pieces: list[torch.Tensor], kind: str | None) -> torch.Tensor:
    """Inverse of ``shard_tensor``: the tp ranks' slices, in rank order."""
    if kind is None or len(pieces) == 1:
        return pieces[0]
    if kind == "qkv":
        per = pieces[0].shape[0] // 3
        parts = [p.reshape(3, 1, per, *p.shape[1:]) for p in pieces]
        full = torch.cat(parts, 1)
        return full.reshape(3 * per * len(pieces), *pieces[0].shape[1:])
    return torch.cat(pieces, 0 if kind == "rows" else 1)


def shard_state_dict(full: dict, layout: mesh_lib.Layout) -> dict:
    """The tensors of ``full`` (an unsharded state_dict) that this rank of
    ``layout`` holds: its tp slice of every entry ``TP_RULES`` names, the
    rest as they are."""
    return {name: shard_tensor(t, tp_kind(name), layout.tp, layout.rank("tp"))
            for name, t in full.items()}


def merge_state_dicts(pieces: list[dict]) -> dict:
    """The unsharded state_dict of the tp ranks' ``pieces`` (in rank order)."""
    return {name: merge_tensor([p[name] for p in pieces], tp_kind(name))
            for name in pieces[0]}


def unshard_state_dict(local: dict, layout: mesh_lib.Layout) -> dict:
    """``local`` (a rank's tensors) gathered over the tp ranks of ``layout``
    into the unsharded layout, on every rank (a collective of the tp
    group)."""
    import torch.distributed as dist

    tp = layout.tp
    if tp == 1:
        return dict(local)
    group = layout.group("tp")
    pieces = [dict(local) for _ in range(tp)]
    for name, t in local.items():
        if tp_kind(name) is not None:
            parts = [torch.empty_like(t) for _ in range(tp)]
            dist.all_gather(parts, t.contiguous(), group=group)
            for piece, part in zip(pieces, parts):
                piece[name] = part
    return merge_state_dicts(pieces)


def local_batch(x, y, valid, mesh, shard_sequence: bool = True):
    """(x, y, valid) of a rank out of a global batch: its dp rows and, with
    ``shard_sequence``, its sp frames (x is (B, F, …))."""
    layout = mesh if isinstance(mesh, mesh_lib.Layout) else \
        mesh_lib.Layout(mesh, shard_sequence=shard_sequence)
    lo, hi = layout.rows(x.shape[0])
    x, y, valid = x[lo:hi], y[lo:hi], valid[lo:hi]
    return (layout.own_frames(x) if shard_sequence else x), y, valid


def shard_model(model, layout: mesh_lib.Layout) -> None:
    """Keep in each parameter of ``model`` (in place, so an optimizer over
    its parameters stays valid) the slice this rank holds, and tell the
    tp-split modules their tp size."""
    if layout.tp == 1:
        return
    from sl_hwgat_tpu_torch.models.common import FeedForward
    from sl_hwgat_tpu_torch.models.hwgate import WindowedMSA

    local = shard_state_dict(dict(model.named_parameters()), layout)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if tp_kind(name) is not None:
                p.data = local[name].detach().clone()
    for m in model.modules():
        if isinstance(m, (WindowedMSA, FeedForward)):
            m.tp = layout.tp


def global_batch_norm(bn, x: torch.Tensor, group) -> torch.Tensor:
    """``bn(x)`` in train mode with the statistics of the global batch: the
    mean and the (biased) variance over every dp rank's rows, through
    all-reduces that carry the gradient both ways; the running statistics
    advance as torch's do, with the unbiased global variance."""
    dims = [0] + list(range(2, x.ndim))
    shape = [1, -1] + [1] * (x.ndim - 2)
    n = torch.tensor(float(x.numel() // x.shape[1]), dtype=x.dtype, device=x.device)
    count = reduce_sum(n, group)
    mean = all_reduce(x.sum(dims), group) / count
    centred = x - mean.reshape(shape)
    var = all_reduce((centred * centred).sum(dims), group) / count
    if bn.track_running_stats:
        with torch.no_grad():
            bn.num_batches_tracked += 1
            m = bn.momentum if bn.momentum is not None else 1.0 / float(bn.num_batches_tracked)
            bn.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
            bn.running_var.mul_(1 - m).add_(var.detach() * (count / (count - 1)), alpha=m)
    y = centred / torch.sqrt(var.reshape(shape) + bn.eps)
    if bn.affine:
        y = y * bn.weight.reshape(shape) + bn.bias.reshape(shape)
    return y


def _use_global_statistics(model, layout: mesh_lib.Layout) -> None:
    """Make every BatchNorm of ``model`` take train-mode statistics over
    the dp ranks while ``layout`` is active (eval mode is unchanged)."""
    cls = torch.nn.modules.batchnorm._BatchNorm
    for bn in model.modules():
        if isinstance(bn, cls) and not hasattr(bn, "_local_forward"):
            bn._local_forward = bn.forward

            def forward(self, x):
                active = mesh_lib.active()
                if self.training and active is not None and active.dp > 1:
                    return global_batch_norm(self, x, active.group("dp"))
                return self._local_forward(x)

            bn.forward = types.MethodType(forward, bn)


def _seed(*entropy) -> int:
    return int(np.random.SeedSequence(list(entropy)).generate_state(1, np.uint64)[0])


def rank_seed(seed: int, epoch: int, step: int, micro: int | None, dp: int, sp: int) -> int:
    """The dropout seed of a rank at dp and sp coordinates ``dp``, ``sp``."""
    return _seed(seed, epoch, step, 0 if micro is None else micro + 1, dp, sp)


def _prune_modules(model) -> list:
    from sl_hwgat_tpu_torch.models.hwgate import WindowedMSA

    return [m for m in model.modules() if isinstance(m, WindowedMSA) and m.prune]


def make_sharded_steps(model, optimizer, mesh, *, criterion_type: str = "smooth_cross_entropy",
                       shard_sequence: bool = True, use_tp: bool = True, grad_accum: int = 1):
    """(train_step, eval_step) of ``model`` over ``mesh`` (a ``DeviceMesh``
    or a ``Layout``), with the call signatures of ``train.loop.make_steps``.

    Build it on every rank, with the same unsharded model and an optimizer
    over its parameters that has taken no step: ``shard_model`` cuts the
    tp-split parameters in place. Both steps take the rank's dp rows with
    all their frames (what a ``Loader`` with ``row_slice`` yields) and cut
    the rank's frames themselves. ``(loss, correct, seen)`` come back global
    and the same on every rank; ``eval_step``'s argmax is the global
    batch's.

    Randomness: dropout draws from a generator seeded by (seed, epoch, step,
    microbatch) and the rank's dp and sp coordinates, the same on the tp
    ranks, whose replicated activations must stay equal (the FFN's hidden
    units, split over tp, take their columns of a full-width mask); the
    prune scalars come from a generator that every rank seeds alike, one a
    pruning MSA module, drawn before the forward.
    """
    from sl_hwgat_tpu_torch.train.loop import step_seed
    from sl_hwgat_tpu_torch.train.losses import CRITERIA, per_sample

    layout = mesh if isinstance(mesh, mesh_lib.Layout) else \
        mesh_lib.Layout(mesh, shard_sequence=shard_sequence, use_tp=use_tp)
    model.check_split(layout.sp, layout.tp)
    if any(optimizer.state.values()):
        raise ValueError("make_sharded_steps needs an optimizer that has taken no step")
    shard_model(model, layout)
    _use_global_statistics(model, layout)
    criterion = CRITERIA[criterion_type]
    device = next(model.parameters()).device
    params = [p for p in model.parameters()]
    names = [n for n, _ in model.named_parameters()]
    sp_replicated = [any(re.match(r, n) for r in model.sp_replicated) for n in names]
    pruning = _prune_modules(model)
    dp_group = layout.group("dp")

    def generators(seed, epoch, step, micro):
        local = torch.Generator(device=device)
        local.manual_seed(rank_seed(seed, epoch, step, micro, layout.rank("dp"),
                                    layout.rank("sp") if layout.sp > 1 else 0))
        shared = torch.Generator(device=device)
        shared.manual_seed(step_seed(seed, epoch, step, micro))
        layout.prune_scalars = {m: torch.rand((1,), generator=shared, device=device)
                                for m in pruning}
        return local

    def reduce_gradients():
        grads, owners = [], []
        for p, rep in zip(params, sp_replicated):
            if p.grad is None:
                continue
            if rep and layout.sp > 1 and layout.rank("sp") != 0:
                p.grad.zero_()
            grads.append(p.grad.reshape(-1))
            owners.append(p)
        flat = torch.cat(grads)
        torch.distributed.all_reduce(flat, group=layout.grad_group)
        offset = 0
        for p in owners:
            n = p.grad.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
            offset += n

    def n_correct(logits, labels, valid):
        return torch.sum((logits.argmax(-1) == labels).float() * valid)

    def train_step(x, y, valid, seed: int, epoch: int, step: int):
        model.check_split(layout.sp, layout.tp, x.shape[1])
        model.train()
        optimizer.zero_grad(set_to_none=True)
        x = layout.own_frames(x)
        denom = torch.clamp(reduce_sum(valid.sum(), dp_group), min=1.0)
        if x.shape[0] % grad_accum:
            raise ValueError(f"rows {x.shape[0]} not divisible by grad_accum {grad_accum}")
        total = correct = torch.zeros((), device=device)
        try:
            with mesh_lib.activate(layout):
                for i, (xm, ym, vm) in enumerate(zip(x.chunk(grad_accum), y.chunk(grad_accum),
                                                     valid.chunk(grad_accum))):
                    gen = generators(seed, epoch, step, i if grad_accum > 1 else None)
                    logits = model(xm, gen)
                    loss = torch.sum(per_sample(criterion, logits, ym) * vm) / denom
                    loss.backward()
                    total = total + loss.detach()
                    correct = correct + n_correct(logits.detach(), ym, vm)
        finally:
            layout.prune_scalars = None
        reduce_gradients()
        optimizer.step()
        loss, correct, seen = reduce_sum(torch.stack([total, correct, valid.sum()]), dp_group)
        return loss, correct, seen

    def eval_step(x, y, valid, k: int = 1):
        model.check_split(layout.sp, layout.tp, x.shape[1])
        model.eval()
        with torch.no_grad(), mesh_lib.activate(layout):
            logits = model(layout.own_frames(x))
        denom = torch.clamp(reduce_sum(valid.sum(), dp_group), min=1.0)
        loss_sum = torch.sum(per_sample(criterion, logits, y) * valid)
        topk = torch.argsort(logits, dim=-1, stable=True).flip(-1)[:, :k]
        correct = torch.sum((topk == y[:, None]).any(-1).float() * valid)
        loss_sum, correct, seen = reduce_sum(torch.stack([loss_sum, correct, valid.sum()]),
                                             dp_group)
        return loss_sum / denom, correct, seen, gather_rows(logits.argmax(-1), dp_group)

    train_step.layout = eval_step.layout = layout
    return train_step, eval_step


def sharded_logits(model, layout: mesh_lib.Layout, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode logits of the global batch, on every rank, from each
    rank's dp rows ``x`` (all frames)."""
    model.eval()
    with torch.no_grad(), mesh_lib.activate(layout):
        logits = model(layout.own_frames(x))
    return gather_rows(logits, layout.group("dp"))
