"""Window attention on a rank's own units, ≡
``sl_hwgat_tpu/parallel/kernel_sharding.py`` (``call_sharded``,
``call_factored``).

The fused kernels (K1/K2, and K7 between two ``torch.bmm``) are a map over
units with no traffic between them, so a rank simply runs them on the units
it holds. Inside a sharded step (``mesh.activate``), HWGATE's and HGATE's
``WindowedMSA`` runs its usual call on the (b, f, nW, h) units of the rank
(HGATE: nW = 1, 58-token units):
the rows of its dp shard, the temporal groups of its sp shard and the
heads of its tp shard, in that order, so no unit moves.

The dual-mask (shifted-block) selector is the one subtlety: the last
temporal group of every clip attends under the shift-masked adjacency, and
only the last sp rank holds a clip's last group. Once a rank holds more
than one clip, a scalar ``unit_offset`` cannot express that, so the
selector is computed here from the rank's global group offset
(``rank_sel``) and passed as ``sel`` (as the JAX ``call_factored`` does).
``local_sel`` and ``rank_units`` are the pure functions behind it, which
the tests use with no process group.

The JAX ``call_wide`` (the feature-major stream's split) has no
counterpart: that stream is a TPU layout the port does not run.
"""

from __future__ import annotations

import torch

from sl_hwgat_tpu_torch.parallel import mesh as mesh_lib


def local_sel(tiles: int, stack: int, units_per_group: int, groups: int,
              group_offset: int, groups_total: int, device=None) -> torch.Tensor:
    """(tiles,) int32 selector of a rank's supertiles: units are ordered
    (clip, group, unit-in-group) with ``groups`` local groups of
    ``units_per_group`` units per clip, the rank's first group is the clip's
    group ``group_offset``, and 1 marks a supertile in the clip's last group
    (``groups_total - 1``). With offset 0 and all groups it is
    ``ops.window_attention.make_sel``."""
    starts = torch.arange(tiles, dtype=torch.int64, device=device) * stack
    group = group_offset + (starts // units_per_group) % groups
    return (group == groups_total - 1).to(torch.int32)


def rank_units(x: torch.Tensor, *, batch: int, groups: int, windows: int, heads: int,
               shape: tuple, coords: tuple) -> torch.Tensor:
    """The units of the rank at ``coords`` (dp, sp, tp) of a mesh of
    ``shape``, out of the global (U, N, dh) units in (b, f, nW, h) order:
    its rows, its temporal groups and its heads, in the same order."""
    dp, sp, tp = shape
    d, s, t = coords
    u = x.reshape(batch, groups, windows, heads, *x.shape[1:])
    u = u[d * batch // dp:(d + 1) * batch // dp, s * groups // sp:(s + 1) * groups // sp, :,
          t * heads // tp:(t + 1) * heads // tp]
    return u.reshape(-1, *x.shape[1:])


def rank_sel(tiles: int, stack: int, units_per_group: int, groups: int,
             device=None) -> torch.Tensor | None:
    """The selector of this rank's ``tiles`` supertiles inside a step that
    splits the frames over sp ranks (its ``groups`` local groups follow the
    groups of the sp ranks before it), or None elsewhere: the kernels'
    own selector from group 0 is then the right one."""
    layout = mesh_lib.active()
    if layout is None or layout.sp == 1:
        return None
    return local_sel(tiles, stack, units_per_group, groups, layout.rank("sp") * groups,
                     groups * layout.sp, device=device)
