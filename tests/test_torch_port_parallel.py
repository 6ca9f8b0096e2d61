"""The port's parallel layer without processes, against the JAX package's.

- ``mesh_shape_for`` equals JAX's for 1..16 devices;
- state_dict sharding: ``shard_tensor`` → ``merge_state_dicts`` is bit
  for bit, and a tp rank's ``attn.qkv`` rows are its heads' rows of q, k
  and v;
- per-rank window attention (``kernel_sharding.rank_units``,
  ``local_sel``): the plain version on each rank's units with its selector,
  put back together, is bit for bit the unsharded call at meshes (2,1,1),
  (1,2,1) and (1,2,2), dual mask and pruning included, and within 1e-5 of
  the JAX ``kernel_sharding.call_sharded`` / ``call_factored`` (Pallas in
  interpret mode on the virtual CPU mesh), at the shapes of
  ``tests/test_kernel_sharding.py``;
- ``Loader.row_slice`` reads a rank's rows of the global batches, as the
  JAX ``Loader`` does;
- the sharded checkpoint of one process (``--ckpt-backend orbax``): the
  round trip is bit for bit, and resume and ``Predictor.from_checkpoint``
  read the directory;
- a mesh that does not divide, or a model without the asked-for path, is
  refused at setup (the GCNs also at frame counts off their stride-2
  blocks' grid or below their temporal halo), and HGATE's, the
  Transformer's and the GCNs' splits are accepted;
- ``TP_RULES`` give each model's names the kind its layers need, from its
  own rules only; the Transformer's shard → merge is bit for bit; its
  attention dropout over split heads is the full-width draw;
- HGATE's shifted-block MSA on each sp rank's groups (58-token units, one
  and two heads) under a tail plane far from the adjacency, put together,
  is the unsharded call bit for bit (the whole model's logits move by only
  about 1e-4 with the tail, inside the sharded tests' bars).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from sl_hwgat_tpu import graphs as jax_graphs
from sl_hwgat_tpu.data import dataset as jax_dataset
from sl_hwgat_tpu.parallel import kernel_sharding as jax_ks
from sl_hwgat_tpu.parallel.mesh import mesh_shape_for as jax_mesh_shape_for

from sl_hwgat_tpu_torch.constants import DATASET_PARAMS
from sl_hwgat_tpu_torch.data import dataset
from sl_hwgat_tpu_torch.models import build_model
from sl_hwgat_tpu_torch.parallel import kernel_sharding, mesh_shape_for
from sl_hwgat_tpu_torch.parallel.sharding import merge_state_dicts, shard_tensor, tp_kind
from sl_hwgat_tpu_torch.ops.window_attention import window_attention
from sl_hwgat_tpu_torch.train import checkpoint as ckpt_lib
from sl_hwgat_tpu_torch.train.loop import make_steps
from sl_hwgat_tpu_torch.train.state import TrainState, make_optimizer

ADJ32 = jax_graphs.windowed_block_adj(2)[0]
DS = {"num_class": 6, "src_len": 16}
SMALL = dict(embed_dim=32, depths=(1, 1), num_heads=(2, 2), drop_rate=0.0)


def test_mesh_shape_for_equals_jax():
    for n in range(1, 17):
        assert mesh_shape_for(n) == jax_mesh_shape_for(n), n


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_then_merge_is_bit_for_bit(tp):
    model = build_model("HWGATE", DS, 2, device="cpu", embed_dim=32, depths=(1, 1),
                        num_heads=(4, 4))
    full = model.state_dict()
    pieces = [{k: shard_tensor(v, tp_kind(k), tp, t) for k, v in full.items()}
              for t in range(tp)]
    back = merge_state_dicts(pieces)
    assert back.keys() == full.keys()
    for k, v in full.items():
        assert torch.equal(back[k], v), k
    # a tp rank's qkv rows: its heads' rows of each of q, k and v
    w = full["layers.0.blocks.0.attn.qkv.weight"]  # (3·h·dh, d), h = 4, dh = 8
    for t in range(tp):
        got = pieces[t]["layers.0.blocks.0.attn.qkv.weight"]
        heads = range(t * 4 // tp, (t + 1) * 4 // tp)
        want = torch.cat([w[part * 32 + h * 8:part * 32 + (h + 1) * 8]
                          for part in range(3) for h in heads])
        assert torch.equal(got, want)
        # proj and fc2 hold their input columns, fc1 its output rows
        proj = full["layers.0.blocks.0.attn.proj.weight"]
        assert torch.equal(pieces[t]["layers.0.blocks.0.attn.proj.weight"],
                           proj[:, t * 32 // tp:(t + 1) * 32 // tp])
        assert torch.equal(pieces[t]["layers.0.blocks.0.attn.proj.bias"],
                           full["layers.0.blocks.0.attn.proj.bias"])
        fc1 = full["layers.0.blocks.0.ff.fc1.weight"]
        assert torch.equal(pieces[t]["layers.0.blocks.0.ff.fc1.weight"],
                           fc1[t * 64 // tp:(t + 1) * 64 // tp])
    split = {k for k in full if tp_kind(k) is not None}
    # per block: qkv weight and bias, proj weight, fc1 weight and bias, fc2 weight
    assert len(split) == 2 * 6


# the dual-mask shapes of tests/test_kernel_sharding.py: b = 8 clips, f = 4
# temporal groups, 8 units a group (4 windows × 2 heads)
B, F, NW, H = 8, 4, 4, 2
PER_F = NW * H


def _inputs():
    r = np.random.default_rng(2)
    q, k, v = (r.normal(size=(B * F * PER_F, 32, 16)).astype(np.float32) for _ in range(3))
    tail = ADJ32 * (np.random.default_rng(3).random(ADJ32.shape) > 0.3)
    return q, k, v, tail


def _jax_sharded(q, k, v, tail, shape):
    dp, sp, tp = shape
    kw = dict(scale=0.25, stack=4, tail_adj=tail, prune_u=0.3)
    if tp == 1:
        devs = np.array(jax.devices("cpu")[:dp * sp]).reshape(dp, sp)
        with jax_ks.sharded_window_attention(Mesh(devs, ("dp", "sp"))):
            out = jax_ks.call_sharded(*(jnp.asarray(t) for t in (q, k, v)), ADJ32,
                                      units_per_group=PER_F, groups=F, **kw)
        return np.asarray(out)
    # tp splits the heads of the factored (H, G, N, dh) layout
    devs = np.array(jax.devices("cpu")[:dp * sp * tp]).reshape(dp, sp, tp)
    q4, k4, v4 = (jnp.asarray(t.reshape(-1, H, 32, 16).transpose(1, 0, 2, 3)) for t in (q, k, v))
    with jax_ks.sharded_window_attention(Mesh(devs, ("dp", "sp", "tp"))):
        out = jax_ks.call_factored(q4, k4, v4, ADJ32, units_per_group=NW, groups=F, **kw)
    assert out is not None
    return np.asarray(out).transpose(1, 0, 2, 3).reshape(q.shape)


@pytest.mark.parametrize("shape", [(2, 1, 1), (1, 2, 1), (1, 2, 2)])
def test_rank_units_put_together_are_the_unsharded_call(shape):
    q, k, v, tail = _inputs()
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    want = window_attention(tq, tk, tv, ADJ32, scale=0.25, stack=4, tail_adj=tail,
                            units_per_group=PER_F, groups=F, prune_u=0.3)
    dp, sp, tp = shape
    got = torch.empty_like(want).reshape(B, F, NW, H, 32, 16)
    geometry = dict(batch=B, groups=F, windows=NW, heads=H, shape=shape)
    for d in range(dp):
        for s in range(sp):
            for t in range(tp):
                units = [kernel_sharding.rank_units(x, coords=(d, s, t), **geometry)
                         for x in (tq, tk, tv)]
                per_group, groups = NW * H // tp, F // sp
                sel = kernel_sharding.local_sel(units[0].shape[0] // 4, 4, per_group, groups,
                                                s * groups, F)
                out = window_attention(*units, ADJ32, scale=0.25, stack=4, tail_adj=tail,
                                       units_per_group=per_group, groups=groups, sel=sel,
                                       prune_u=0.3)
                got[d * B // dp:(d + 1) * B // dp, s * groups:(s + 1) * groups, :,
                    t * H // tp:(t + 1) * H // tp] = out.reshape(B // dp, groups, NW, H // tp,
                                                                 32, 16)
    got = got.reshape(want.shape)
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), _jax_sharded(q, k, v, tail, shape), atol=1e-5)


def test_local_sel_is_make_sel_unsharded():
    from sl_hwgat_tpu_torch.ops.window_attention import make_sel

    assert torch.equal(kernel_sharding.local_sel(64, 4, 8, 4, 0, 4), make_sel(64, 4, 8, 4))
    # the last sp rank of two holds every clip's last group
    sel = kernel_sharding.local_sel(16, 4, 8, 2, 2, 4)
    assert sel.tolist() == [0, 0, 1, 1] * 4


def test_row_slice_reads_a_ranks_rows_as_jax_does():
    r = np.random.default_rng(0)
    ids = [f"v{i}" for i in range(10)]
    data = {i: r.random((6, 3, 2)).astype(np.float32) for i in ids}
    labels = {i: n % 3 for n, i in enumerate(ids)}

    def batches(mod, row_slice):
        ds = mod.KeypointDataset(ids, data, labels, None, seed=5)
        loader = mod.Loader(ds, batch_size=4, shuffle=True, num_workers=1, seed=5)
        loader.row_slice = row_slice
        try:
            return list(loader.epoch(1))
        finally:
            if hasattr(loader, "close"):  # the JAX Loader has no pool to shut
                loader.close()

    full = batches(dataset, None)
    part = batches(dataset, (1, 3))
    want = batches(jax_dataset, (1, 3))
    assert len(full) == len(part) == 3
    for (x, y, v), (px, py, pv), (jx, jy, jv) in zip(full, part, want):
        np.testing.assert_array_equal(px, x[1:3])
        np.testing.assert_array_equal(py, y[1:3])
        np.testing.assert_array_equal(pv, v[1:3])
        np.testing.assert_array_equal(px, jx)
        np.testing.assert_array_equal(pv, jv)
    assert part[-1][2].tolist() == [1.0, 0.0]  # the padded rows stay padded


SYNTH = DATASET_PARAMS["SYNTH"]


def _trained_state():
    model = build_model("HWGATE", SYNTH, 2, device="cpu", seed=3, **SMALL)
    opt = make_optimizer("adamw", 5e-4, model.parameters())
    step, _ = make_steps(model, opt)
    r = np.random.default_rng(1)
    x = torch.from_numpy(r.normal(size=(2, SYNTH["src_len"], 64, 2)).astype(np.float32))
    step(x, torch.tensor([1, 4]), torch.ones(2), 0, 0, 0)
    return TrainState(model, opt, epoch=3, history={"train_loss": [1.0], "val_loss": [2.0],
                                                    "train_acc": [0.5], "val_acc": [0.25]}), x


def test_one_process_sharded_checkpoint_round_trip(tmp_path):
    state, x = _trained_state()
    path = str(tmp_path / "run_best_loss.ckpt")
    ckpt_lib.save_checkpoint(path, state, 5e-4, backend="orbax")
    assert (tmp_path / "run_best_loss.ckpt").is_dir()
    assert (tmp_path / "run_best_loss.ckpt.meta").is_file()
    payload = ckpt_lib.read_checkpoint(path)
    assert payload["epoch"] == 3 and payload["val_loss_list"] == [2.0]
    for k, v in state.model.state_dict().items():
        assert torch.equal(payload["model_state_dict"][k], v), k
    want = state.optimizer.state_dict()
    got = payload["optimizer_state_dict"]
    assert got["param_groups"] == want["param_groups"]
    for i, fields in want["state"].items():
        for name, t in fields.items():
            assert torch.equal(got["state"][i][name], t), (i, name)
    # resume into a fresh run, and serve from the directory
    fresh = TrainState(build_model("HWGATE", SYNTH, 2, device="cpu", seed=9, **SMALL), None)
    fresh.optimizer = make_optimizer("adamw", 5e-4, fresh.model.parameters())
    ckpt_lib.resume_from(fresh, path)
    assert fresh.epoch == 4
    for (n, a), b in zip(state.model.named_parameters(), fresh.model.parameters()):
        assert torch.equal(a, b), n
    for a, b in zip(state.optimizer.state.values(), fresh.optimizer.state.values()):
        assert all(torch.equal(a[f], b[f]) for f in a)
    from sl_hwgat_tpu_torch.serve import Predictor

    pred = Predictor.from_checkpoint(path, model_type="HWGATE", dataset="SYNTH", device="cpu",
                                     **SMALL)
    state.model.eval()
    with torch.no_grad():
        want_logits = state.model(x)
        got_logits = pred.model(x)
    assert torch.equal(got_logits, want_logits)


def test_sharded_checkpoint_reads_into_a_live_model(tmp_path):
    """``read_checkpoint_sharded`` writes the stored tensors into a model and
    an optimizer that has taken no step, in place."""
    state, _ = _trained_state()
    path = str(tmp_path / "ck")
    ckpt_lib.save_checkpoint_sharded(path, state.model, state.optimizer, 3, 5e-4, state.history)
    model = build_model("HWGATE", SYNTH, 2, device="cpu", seed=9, **SMALL)
    opt = make_optimizer("adamw", 5e-4, model.parameters())
    meta = ckpt_lib.read_checkpoint_sharded(path, model, opt)
    assert meta["epoch"] == 3
    for (n, a), b in zip(state.model.state_dict().items(), model.state_dict().values()):
        assert torch.equal(a, b), n
    for a, b in zip(state.optimizer.state.values(), opt.state.values()):
        assert all(torch.equal(a[f], b[f]) for f in a)


@pytest.mark.parametrize("name, sp, tp, frames, match", [
    ("STGCN", 1, 2, None, "no tp path"),
    ("STGCN", 2, 1, 36, "stride-2 blocks' grid"),
    ("DecoupledGCN", 4, 1, 48, "fewer than the halo"),
    ("DecoupledGCN", 1, 2, None, "no tp path"),
    ("WGATE", 1, 2, None, "no tp path"),
    ("HWGATE", 1, 4, None, "heads do not split"),
    ("HWGATE", 2, 1, 12, "temporal patch"),
    ("HWGATE", 4, 1, 18, "do not split over sp"),
    ("HGATE", 1, 4, None, "2 heads do not split"),
    ("HGATE", 2, 1, 12, "temporal patch"),
    ("Transformer", 1, 4, None, "3 heads do not split"),
    ("Transformer", 1, 3, None, "FFN of 64 does not split"),
    ("Transformer", 4, 1, 18, "do not split over sp"),
])
def test_meshes_that_do_not_divide_are_refused(name, sp, tp, frames, match):
    overrides = {"HWGATE": dict(SMALL, num_heads=(2, 2)), "WGATE": dict(embed_dim=32, depths=1,
                                                                         num_heads=2),
                 "HGATE": dict(SMALL, num_heads=(2, 4)),
                 "Transformer": dict(d_model=36, nhead=3, dim_feedforward=64,
                                     num_encoder_layers=1)}
    model = build_model(name, DS, 2, device="cpu", **overrides.get(name, {}))
    with pytest.raises(ValueError, match=match):
        model.check_split(sp, tp, frames)


def test_dropout_shards_are_the_full_width_draw_and_keep_the_rate():
    """The FFN's hidden units split over tp take their columns of one
    full-width mask: tp ranks that share a generator stay in step, their
    shards' masks differ, and the keep rate is dropout's."""
    from sl_hwgat_tpu_torch.models.common import dropout, dropout_shard
    from sl_hwgat_tpu_torch.parallel.sharding import rank_seed

    x = torch.ones(64, 32, 48)
    shards = [dropout_shard(x, 0.1, True, torch.Generator().manual_seed(7), t, 2)
              for t in range(2)]
    full = dropout(torch.ones(64, 32, 96), 0.1, True, torch.Generator().manual_seed(7))
    assert torch.equal(torch.cat(shards, -1), full)
    assert not torch.equal(shards[0] != 0, shards[1] != 0)
    keep = (full != 0).double().mean().item()
    assert abs(keep - 0.9) < 4 * (0.9 * 0.1 / full.numel()) ** 0.5
    # the dropout seeds part by dp and sp coordinate, and by microbatch
    seeds = {rank_seed(0, 1, 2, micro, dp, sp) for micro in (None, 0) for dp in range(2)
             for sp in range(2)}
    assert len(seeds) == 8


@pytest.mark.parametrize("name, sp, tp, frames", [
    ("HGATE", 2, 2, 16), ("HGATE", 4, 1, 16), ("Transformer", 1, 2, 16),
    ("Transformer", 2, 2, 32), ("STGCN", 2, 1, 32), ("STGCN", 4, 1, 192),
    ("DecoupledGCN", 4, 1, 64),
])
def test_meshes_that_divide_are_accepted(name, sp, tp, frames):
    overrides = {"HGATE": dict(SMALL, num_heads=(2, 4)),
                 "Transformer": dict(d_model=32, nhead=2, dim_feedforward=64,
                                     num_encoder_layers=1)}
    build_model(name, DS, 2, device="cpu", **overrides.get(name, {})).check_split(sp, tp,
                                                                                  frames)


# the state_dict names a tp rank holds a slice of, by the last two parts of
# the name, and the rules (by index in TP_RULES) each model's names may match
TP_NAMES = {
    "block": ({"qkv.weight": "qkv", "qkv.bias": "qkv", "proj.weight": "cols",
               "fc1.weight": "rows", "fc1.bias": "rows", "fc2.weight": "cols"}, range(0, 4)),
    "transformer": ({"self_attn.in_proj_weight": "qkv", "self_attn.in_proj_bias": "qkv",
                     "out_proj.weight": "cols", "linear1.weight": "rows",
                     "linear1.bias": "rows", "linear2.weight": "cols"}, range(4, 8)),
}


@pytest.mark.parametrize("name, family", [
    ("HWGATE", "block"), ("HGATE", "block"), ("WGATE", "block"), ("GATE", "block"),
    ("Transformer", "transformer"), ("STGCN", None), ("DecoupledGCN", None),
])
def test_tp_rules_give_each_models_names_their_kind(name, family):
    """Each name gets the kind its layer needs, from its own model's rules
    only: no block rule catches the Transformer's ``self_attn.out_proj``,
    and no Transformer rule a block's or a GCN's name."""
    import re

    from sl_hwgat_tpu_torch.parallel.sharding import TP_RULES

    kinds, own = TP_NAMES[family] if family else ({}, range(0))
    model = build_model(name, DS, 2, device="cpu")
    for key in model.state_dict():
        tail = ".".join(key.split(".")[-2:])
        assert tp_kind(key) == kinds.get(tail), key
        matched = [i for i, (pattern, _) in enumerate(TP_RULES) if re.match(pattern, key)]
        assert all(i in own for i in matched), (key, matched)


@pytest.mark.parametrize("tp", [2, 4])
def test_transformer_shard_then_merge_is_bit_for_bit(tp):
    model = build_model("Transformer", DS, 2, device="cpu", d_model=32, nhead=4,
                        dim_feedforward=64, num_encoder_layers=2)
    full = model.state_dict()
    pieces = [{k: shard_tensor(v, tp_kind(k), tp, t) for k, v in full.items()}
              for t in range(tp)]
    back = merge_state_dicts(pieces)
    assert back.keys() == full.keys()
    for k, v in full.items():
        assert torch.equal(back[k], v), k
    base = "transformer_encoder.layers.1"
    w = full[f"{base}.self_attn.in_proj_weight"]  # (3·h·dh, d), h = 4, dh = 8
    for t in range(tp):
        heads = range(t * 4 // tp, (t + 1) * 4 // tp)
        want = torch.cat([w[part * 32 + h * 8:part * 32 + (h + 1) * 8]
                          for part in range(3) for h in heads])
        assert torch.equal(pieces[t][f"{base}.self_attn.in_proj_weight"], want)
        assert torch.equal(pieces[t][f"{base}.self_attn.out_proj.weight"],
                           full[f"{base}.self_attn.out_proj.weight"][:, t * 32 // tp:
                                                                     (t + 1) * 32 // tp])
        assert torch.equal(pieces[t][f"{base}.linear1.bias"],
                           full[f"{base}.linear1.bias"][t * 64 // tp:(t + 1) * 64 // tp])
        assert torch.equal(pieces[t][f"{base}.linear2.weight"],
                           full[f"{base}.linear2.weight"][:, t * 64 // tp:(t + 1) * 64 // tp])
        assert torch.equal(pieces[t][f"{base}.linear2.bias"], full[f"{base}.linear2.bias"])


def test_attention_dropout_shards_over_heads_are_the_full_draw():
    """The Transformer's attention dropout under tp: each rank keeps its
    heads of one mask drawn at the full head count, so the tp ranks' masks
    put together are the unsharded model's draw."""
    from sl_hwgat_tpu_torch.models.common import dropout, dropout_shard

    a = torch.rand(3, 2, 16, 16, generator=torch.Generator().manual_seed(1))
    full = dropout(torch.cat([a, a], 1), 0.1, True, torch.Generator().manual_seed(7))
    shards = [dropout_shard(a, 0.1, True, torch.Generator().manual_seed(7), t, 2, dim=1)
              for t in range(2)]
    assert torch.equal(torch.cat(shards, 1), full)
    assert not torch.equal(shards[0] != 0, shards[1] != 0)


@pytest.mark.parametrize("heads", [1, 2])
def test_hgate_units_of_each_sp_rank_put_together_are_the_unsharded_call(monkeypatch, heads):
    """HGATE's shifted-block MSA on each sp rank's temporal groups (58-token
    units; one head gives one unit a supertile) under a tail plane far from
    the adjacency: only the last sp rank's last group of each clip attends
    under it, so the ranks' outputs put together are the unsharded call's."""
    from types import SimpleNamespace

    from sl_hwgat_tpu_torch.graphs.adjacency import hgate_block_adj
    from sl_hwgat_tpu_torch.models.hwgate import WindowedMSA
    from sl_hwgat_tpu_torch.parallel import mesh as mesh_lib

    adj = hgate_block_adj()
    tail = adj * (np.random.default_rng(5).random(adj.shape) > 0.5)
    torch.manual_seed(0)
    msa = WindowedMSA(16 * heads, heads, adj, tail_adj=tail, prune=False).eval()
    clips, groups = 3, 4
    x = torch.randn(clips * groups, 58, 16 * heads)
    with torch.no_grad():
        want = msa(x, 1, groups).reshape(clips, groups, 58, -1)
        got = []
        for rank in range(2):
            layout = SimpleNamespace(sp=2, rank=lambda axis, r=rank: r)
            monkeypatch.setattr(mesh_lib, "active", lambda layout=layout: layout)
            mine = x.reshape(clips, groups, 58, -1)[:, rank * 2:(rank + 1) * 2]
            got.append(msa(mine.reshape(clips * 2, 58, -1), 1, 2).reshape(clips, 2, 58, -1))
    assert torch.equal(torch.cat(got, 1), want)
    # the tail plane matters: every group under the plain adjacency differs
    msa.tail_adj = None
    with torch.no_grad():
        plain = msa(x, 1, groups).reshape(clips, groups, 58, -1)
    assert not torch.allclose(plain[:, -1], want[:, -1], atol=1e-3)
    assert torch.equal(plain[:, :-1], want[:, :-1])
