"""The (dp, sp, tp) device mesh and a rank's place in it,
≡ ``sl_hwgat_tpu/parallel/mesh.py``.

``make_mesh`` builds a ``torch.distributed`` ``DeviceMesh`` with the dims
``AXES`` over the ranks of the default process group (which the caller has
joined, ``train/dist.py::initialize``). ``Layout`` is what the parallel
layer reads off it: the mesh's sizes, this rank's coordinates, the process
group of each dim, and the group over which gradients are summed: the
ranks that share this rank's tp coordinate (dp × sp when the frames are
sharded, dp alone when every sp rank holds all frames).

``activate(layout)`` makes a layout the current one for the model hooks
(``kernel_sharding``, ``edge_partition``, the models' sp and tp branches);
``active()`` returns it, or None outside any sharded step.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np

AXES = ("dp", "sp", "tp")
_GROUPS: dict = {}
_ACTIVE = None


def mesh_shape_for(n_devices: int) -> tuple[int, int, int]:
    """The default (dp, sp, tp) factorization of ``n_devices``: tp 2 when n
    is even, then sp 2 when what is left is even, dp the rest (JAX's)."""
    tp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    rem = n_devices // tp
    sp = 2 if rem % 2 == 0 and rem >= 2 else 1
    dp = rem // sp
    return (dp, sp, tp)


def make_mesh(shape: tuple[int, int, int] | None, device_type: str):
    """A ``DeviceMesh`` of ``shape`` (None: ``mesh_shape_for`` the world
    size) with dims ``AXES`` on ``device_type`` ("cuda" or "cpu"), over the
    default process group. The mesh must hold every rank exactly once."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    shape = tuple(shape) if shape is not None else mesh_shape_for(world)
    if len(shape) != 3 or int(np.prod(shape)) != world:
        raise ValueError(f"mesh {shape} does not hold the {world} ranks exactly once")
    return init_device_mesh(device_type, shape, mesh_dim_names=AXES)


class Layout:
    """A rank's place in a (dp, sp, tp) mesh, its process groups, and how a
    step uses them: ``shard_sequence`` splits the frames over sp (else the sp
    ranks repeat each other's work), ``use_tp`` splits the heads and the FFN
    over tp (else the tp ranks repeat each other's work).

    Build it on every rank at once: the gradient group is a new process
    group, and every rank creates every such group in the same order."""

    def __init__(self, mesh, *, shard_sequence: bool = True, use_tp: bool = True):
        import torch.distributed as dist

        self.mesh = mesh
        ranks = mesh.mesh.numpy().reshape(tuple(mesh.shape))
        self.sizes = dict(zip(AXES, ranks.shape))
        here = np.argwhere(ranks == dist.get_rank())
        if len(here) != 1:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh once")
        self.coords = dict(zip(AXES, (int(c) for c in here[0])))
        self.groups = {axis: mesh.get_group(axis) for axis in AXES}
        self.shard_sequence = bool(shard_sequence)
        self.use_tp = bool(use_tp)
        self.grad_group = _grad_group(ranks, self.coords, self.shard_sequence)
        # the prune scalar of each MSA module for the forward that runs, the
        # same on every rank (set by the sharded train step)
        self.prune_scalars: dict | None = None

    @property
    def dp(self) -> int:
        return self.sizes["dp"]

    @property
    def sp(self) -> int:
        """The number of frame shards (1 when the frames are not split)."""
        return self.sizes["sp"] if self.shard_sequence else 1

    @property
    def tp(self) -> int:
        """The number of head shards (1 when the heads are not split)."""
        return self.sizes["tp"] if self.use_tp else 1

    def rank(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]

    def rows(self, batch: int) -> tuple[int, int]:
        """[lo, hi) of this rank's rows of a global batch of ``batch``."""
        if batch % self.dp:
            raise ValueError(f"batch {batch} does not split over dp {self.dp}")
        per = batch // self.dp
        return self.rank("dp") * per, (self.rank("dp") + 1) * per

    def frames(self, frames: int) -> tuple[int, int]:
        """[lo, hi) of this rank's frames of a clip of ``frames``."""
        if frames % self.sp:
            raise ValueError(f"{frames} frames do not split over sp {self.sp}")
        per = frames // self.sp
        lo = self.rank("sp") * per if self.sp > 1 else 0
        return lo, lo + per

    def own_frames(self, x):
        """This rank's frames of (B, F, …) clips."""
        lo, hi = self.frames(x.shape[1])
        return x[:, lo:hi]


def _grad_group(ranks: np.ndarray, coords: dict, shard_sequence: bool):
    """The group of the ranks with this rank's tp coordinate (and, without
    ``shard_sequence``, its sp coordinate too), created once per layout of
    the ranks."""
    import torch.distributed as dist

    key = (ranks.shape, ranks.tobytes(), shard_sequence)
    if key not in _GROUPS:
        groups = {}
        dp, sp, tp = ranks.shape
        for t in range(tp):
            if shard_sequence:
                groups[(None, t)] = dist.new_group(ranks[:, :, t].reshape(-1).tolist())
            else:
                for s in range(sp):
                    groups[(s, t)] = dist.new_group(ranks[:, s, t].reshape(-1).tolist())
        _GROUPS[key] = groups
    s = None if shard_sequence else coords["sp"]
    return _GROUPS[key][(s, coords["tp"])]


@contextmanager
def activate(layout: Layout):
    """Within this context the models run their sharded branches on
    ``layout``."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = layout
    try:
        yield layout
    finally:
        _ACTIVE = prev


def active() -> Layout | None:
    """The layout of the sharded step that is running, or None."""
    return _ACTIVE
