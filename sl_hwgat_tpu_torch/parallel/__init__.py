"""The parallel layer of the port: dp, sp and tp training over
``torch.distributed``, ≡ ``sl_hwgat_tpu/parallel/``.

- ``mesh``: the (dp, sp, tp) ``DeviceMesh`` and a rank's ``Layout`` in it;
- ``comm``: the collectives as autograd Functions (gloo and NCCL);
- ``sharding``: ``TP_RULES``, state_dict sharding and gathering, the
  sharded train and eval steps;
- ``kernel_sharding``: HWGATE's window attention (K1/K2, K7) on a rank's
  own units;
- ``edge_partition``: WGATE's and GATE's banded attention (K8) over frames
  split across ranks, behind a halo exchange;
- ``dryrun``: spawning CPU or shared-card ranks, the step workers, and
  ``dryrun_multichip``.

The batch is split over dp, the frames over sp, the heads over tp
(BASELINE.json config 5 is the sp halo). Every collective is ``all_reduce``,
``all_gather`` or ``broadcast``, which gloo runs on CUDA tensors too, so
ranks that share one card run the layer as ranks with a card each do.
"""

from sl_hwgat_tpu_torch.parallel.mesh import AXES, Layout, make_mesh, mesh_shape_for
from sl_hwgat_tpu_torch.parallel.sharding import (
    TP_RULES,
    local_batch,
    make_sharded_steps,
    shard_state_dict,
    unshard_state_dict,
)

__all__ = [
    "AXES",
    "Layout",
    "make_mesh",
    "mesh_shape_for",
    "TP_RULES",
    "local_batch",
    "shard_state_dict",
    "unshard_state_dict",
    "make_sharded_steps",
]
