"""Multi-process runs of the parallel layer: ``spawn``, the step worker
and ``dryrun_multichip``, ≡ ``__graft_entry__.py::dryrun_multichip``.

``spawn(fn, n, *args)`` starts n ranks with ``torch.multiprocessing``'s
spawn method (a parent that has CUDA up cannot fork), each calling
``fn(rank, n, init_method, *args)`` with a fresh ``file://`` rendezvous;
the join has a timeout, and a rank's exception fails the run (it is raised
in the parent). The workers live here, not in test modules: a spawned child
imports its target's module, and the port imports no JAX.

``step_worker`` runs one sharded job described by a dict (model, weights,
batch, mesh, steps) and writes what each rank saw to ``job["out"]``, for
the tests and ``chip_smoke.py`` to hold against the unsharded steps.

``dryrun_multichip(n)`` spawns n gloo ranks on the CPU and runs the JAX
dryrun's sub-checks but the feature-major one (a TPU layout the port does
not run): the flagship HWGATE's train and eval step at
``mesh_shape_for(n)`` (embed 128, depths (2,2,4), heads (2,4,8), 192
frames, 2002 classes, prune, dropout, remat), (b) ``grad_accum=2``, (c) a
sharded checkpoint round trip, WGATE's halo step and (a) GATE's halo step.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

JOIN_TIMEOUT = 1800.0


def _entry(rank, fn, world, init_method, backend, device, args):
    from sl_hwgat_tpu_torch.train import dist as dist_lib

    if device == "cpu":
        torch.set_num_threads(1)
    dist_lib.initialize(backend, init_method, world, rank, device=device)
    try:
        fn(rank, world, *args)
    finally:
        dist_lib.shutdown()


def spawn(fn, world_size: int, *args, backend: str = "gloo", device: str = "cpu") -> None:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned ranks
    joined into one process group (``backend``; ``device`` "cpu" or a CUDA
    device the ranks share). Raises the first rank's exception, or
    ``TimeoutError`` (after ending every rank) when they outlast
    ``JOIN_TIMEOUT`` seconds."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="sl_hwgat_rdv_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        ctx = mp.start_processes(_entry, args=(fn, world_size, init_method, backend, device,
                                               args),
                                 nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + JOIN_TIMEOUT
        try:
            while not ctx.join(timeout=max(1.0, min(30.0, deadline - time.monotonic()))):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks outlasted {JOIN_TIMEOUT} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)


def _launch_counts() -> dict:
    from sl_hwgat_tpu_torch.ops import banded_attention, hybrid_attention, window_attention

    return {"window_attention": window_attention.window_attention.launches,
            "window_attention_bwd": window_attention.window_attention_bwd.launches,
            "masked_softmax": hybrid_attention.masked_softmax.launches,
            "masked_softmax_bwd": hybrid_attention.masked_softmax_bwd.launches,
            "banded_attention": banded_attention.banded_attention.launches,
            "banded_attention_bwd": banded_attention.banded_attention_bwd.launches}


def _synced(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def step_worker(rank: int, world: int, job: dict) -> None:
    """One sharded job on this rank. ``job`` keys: ``model``, ``dataset``
    (a dataset-params dict), ``input_dim``, ``overrides``, ``state`` (path
    of the unsharded state_dict), ``batch`` (path of the global (x, y,
    valid)), ``mesh``, ``device``, ``dtype`` ("float32"/"float64"),
    ``steps`` (in order, of "logits": the eval-mode logits of the global
    batch; "train": one train step, its (loss, correct, seen) and its
    gradients; "eval": the eval step; "params": the state_dict; "repeats":
    ``job["repeats"]`` more train steps, timed), and optional ``seed``,
    ``grad_accum``, ``shard_sequence``, ``use_tp``, ``lr``. Every rank
    writes ``{out}.{rank}`` (its kernel launches and host ms by step); rank
    0 also writes ``out`` with the results, gathered into the unsharded
    layout."""
    from sl_hwgat_tpu_torch.models import build_model
    from sl_hwgat_tpu_torch.parallel import mesh as mesh_lib
    from sl_hwgat_tpu_torch.parallel.sharding import (
        local_batch,
        make_sharded_steps,
        sharded_logits,
        unshard_state_dict,
    )
    from sl_hwgat_tpu_torch.train.state import make_optimizer

    device = torch.device(job["device"])
    dtype = getattr(torch, job.get("dtype", "float32"))
    mesh = mesh_lib.make_mesh(job["mesh"], device.type)
    model = build_model(job["model"], job["dataset"], job.get("input_dim", 2), device=device,
                        **job.get("overrides", {}))
    model.load_state_dict(torch.load(job["state"], map_location=device))
    model.to(dtype)
    optimizer = make_optimizer("adamw", job.get("lr", 5e-4), model.parameters())
    train_step, eval_step = make_sharded_steps(
        model, optimizer, mesh, shard_sequence=job.get("shard_sequence", True),
        use_tp=job.get("use_tp", True), grad_accum=job.get("grad_accum", 1))
    layout = train_step.layout
    batch = torch.load(job["batch"])
    x, y, valid = (t.to(device) for t in batch)
    rows = local_batch(x.to(dtype), y, valid, layout, shard_sequence=False)
    seed = job.get("seed", 0)
    results, launches, host_ms = {}, {}, {}

    def timed(name, fn):
        _synced(device)
        before = _launch_counts()
        t0 = time.perf_counter()
        out = fn()
        _synced(device)
        host_ms[name] = (time.perf_counter() - t0) * 1e3
        after = _launch_counts()
        launches[name] = {k: after[k] - before[k] for k in after}
        return out

    for what in job["steps"]:
        if what == "logits":
            results["logits"] = timed("logits", lambda: sharded_logits(model, layout, rows[0]))
        elif what == "train":
            out = timed("train", lambda: train_step(*rows, seed, 0, 0))
            results["train"] = torch.stack([t.double() for t in out])
            grads = {n: p.grad for n, p in model.named_parameters()}
            results["grads"] = unshard_state_dict(grads, layout)
        elif what == "repeats":
            for i in range(job["repeats"]):
                timed(f"repeat{i}", lambda: train_step(*rows, seed, 0, 1 + i))
        elif what == "eval":
            out = timed("eval", lambda: eval_step(*rows, 1))
            results["eval"] = torch.stack([t.double() for t in out[:3]])
            results["eval_argmax"] = out[3]
        elif what == "params":
            results["params"] = unshard_state_dict(
                {n: t.detach() for n, t in model.state_dict().items()}, layout)
        else:
            raise ValueError(f"unknown step {what!r}")
    mine = {"launches": launches, "host_ms": host_ms, "coords": layout.coords}
    torch.save(mine, f"{job['out']}.{rank}")
    if rank == 0:
        torch.save(_to_cpu(results), job["out"])


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    return tree


def jobs_worker(rank: int, world: int, jobs: list) -> None:
    """``step_worker`` for each of ``jobs`` in turn, in one process group."""
    for job in jobs:
        step_worker(rank, world, job)


def run_jobs(jobs: list, world_size: int, *, backend: str = "gloo") -> list[tuple[dict, list[dict]]]:
    """``step_worker`` for each of ``jobs`` (one device) on ``world_size``
    ranks, one spawn → for each job (rank 0's results, each rank's launches
    and host ms)."""
    spawn(jobs_worker, world_size, jobs, backend=backend, device=jobs[0]["device"])
    return [(torch.load(job["out"]), [torch.load(f"{job['out']}.{r}")
                                      for r in range(world_size)]) for job in jobs]


def halo_worker(rank: int, world: int, job: dict) -> None:
    """``call_sharded_banded`` on this rank's frames of the (P, F·V, dh)
    planes ``job["qkv"]`` (a path), mesh (1, world, 1), with the gradient
    of sum(o·cos o); rank 0 writes the gathered output and dq, dk, dv to
    ``job["out"]``."""
    from sl_hwgat_tpu_torch.parallel import edge_partition
    from sl_hwgat_tpu_torch.parallel import mesh as mesh_lib
    from sl_hwgat_tpu_torch.parallel.comm import gather_rows

    device = torch.device(job["device"])
    layout = mesh_lib.Layout(mesh_lib.make_mesh((1, world, 1), device.type))
    q, k, v, band = torch.load(job["qkv"])
    nv = band.shape[1]
    f0, f1 = layout.frames(q.shape[1] // nv)
    local = [t[:, f0 * nv:f1 * nv].to(device).requires_grad_() for t in (q, k, v)]
    with mesh_lib.activate(layout):
        out = edge_partition.call_sharded_banded(*local, band.numpy(), scale=job["scale"])
    torch.sum(out * torch.cos(out)).backward()
    group = layout.group("sp")
    results = {name: gather_rows(t.transpose(0, 1).contiguous(), group).transpose(0, 1)
               for name, t in (("out", out), ("dq", local[0].grad), ("dk", local[1].grad),
                               ("dv", local[2].grad))}
    if rank == 0:
        torch.save(_to_cpu(results), job["out"])


def runs_worker(rank: int, world: int, jobs: list) -> None:
    """``run_worker`` for each of ``jobs`` in turn, in one process group."""
    for job in jobs:
        run_worker(rank, world, job)


def run_worker(rank: int, world: int, job: dict) -> None:
    """``train.dist.run_distributed`` on this rank for a ``RunConfig`` made
    of ``job["config"]`` (its fields) and ``job["overrides"]``, at mesh
    ``job["mesh"]``. Every rank writes ``{out}.{rank}``: the metrics, the
    history, the dataset rows it read (epoch, split size, index) and the
    model's state after each epoch, gathered into the unsharded layout."""
    from sl_hwgat_tpu_torch.configs import RunConfig
    from sl_hwgat_tpu_torch.data import dataset
    from sl_hwgat_tpu_torch.parallel import mesh as mesh_lib
    from sl_hwgat_tpu_torch.parallel.sharding import unshard_state_dict
    from sl_hwgat_tpu_torch.train import loop
    from sl_hwgat_tpu_torch.train.dist import run_distributed

    cfg = RunConfig(**job["config"])
    cfg.overrides = dict(job.get("overrides", {}))
    reads, states, made = [], {}, []
    real_get, real_init = dataset.KeypointDataset.get, loop.init_state

    def counted_get(self, index, epoch=0):  # which rows this rank transformed
        reads.append((epoch, len(self.ids), int(index)))
        return real_get(self, index, epoch)

    def kept_init(c):  # the run's state, to read its model after each epoch
        made.append(real_init(c))
        return made[-1]

    def progress(epoch, metrics):
        sd = {k: v.detach() for k, v in made[0].model.state_dict().items()}
        states[epoch] = _to_cpu(unshard_state_dict(sd, layout))

    layout = mesh_lib.Layout(mesh_lib.make_mesh(job["mesh"], torch.device(cfg.device).type))
    dataset.KeypointDataset.get, loop.init_state = counted_get, kept_init
    try:
        metrics, state = run_distributed(cfg, job["mesh"], progress=progress)
    finally:
        dataset.KeypointDataset.get, loop.init_state = real_get, real_init
    torch.save({"metrics": metrics, "history": state.history, "reads": reads,
                "states": states}, f"{job['out']}.{rank}")


def _dryrun_worker(rank: int, world: int, workdir: str) -> None:
    from sl_hwgat_tpu_torch.models.gate import GATE
    from sl_hwgat_tpu_torch.models.hwgate import HWGATE
    from sl_hwgat_tpu_torch.models.wgate import WGATE
    from sl_hwgat_tpu_torch.parallel import make_mesh, make_sharded_steps, mesh_shape_for
    from sl_hwgat_tpu_torch.parallel.sharding import unshard_state_dict
    from sl_hwgat_tpu_torch.train.checkpoint import (read_checkpoint_sharded,
                                                     save_checkpoint_sharded)
    from sl_hwgat_tpu_torch.train.state import make_optimizer

    shape = mesh_shape_for(world)
    mesh = make_mesh(shape, "cpu")
    dp = shape[0]
    batch = max(2, dp)
    frames = 192
    r = np.random.default_rng(0)
    valid = torch.ones(batch)

    def flagship():
        g = torch.Generator().manual_seed(0)
        return HWGATE(kp_dim=2, temporal_dim=frames, num_classes=2002, embed_dim=128,
                      depths=(2, 2, 4), num_heads=(2, 4, 8), drop_rate=0.1, prune_attn=True,
                      remat=True, generator=g)

    def rows_of(layout, *tensors):
        lo, hi = layout.rows(batch)
        return [t[lo:hi] for t in tensors]

    x = torch.from_numpy(r.normal(size=(batch, frames, 64, 2)).astype(np.float32))
    y = torch.from_numpy(r.integers(0, 2002, size=batch)).long()
    model = flagship()
    opt = make_optimizer("adamw", 5e-4, model.parameters())
    train, evaluate = make_sharded_steps(model, opt, mesh)
    args = rows_of(train.layout, x, y, valid)
    loss, _, _ = train(*args, 0, 0, 0)
    eval_loss = evaluate(*args, 1)[0]

    # (b) gradient accumulation through the sharded step
    ga_model = flagship()
    ga_train, _ = make_sharded_steps(ga_model, make_optimizer("adamw", 5e-4,
                                                              ga_model.parameters()),
                                     mesh, grad_accum=2)
    ga_loss = ga_train(*args, 0, 0, 0)[0]

    # (c) sharded checkpoint round trip of the live sharded state
    ck = os.path.join(workdir, "step0")
    hist = {"train_loss": [float(loss)], "val_loss": [float(eval_loss)],
            "train_acc": [0.0], "val_acc": [0.0]}
    save_checkpoint_sharded(ck, model, opt, epoch=0, lr=5e-4, history=hist, mesh=train.layout)
    twin = flagship()
    twin_opt = make_optimizer("adamw", 5e-4, twin.parameters())
    make_sharded_steps(twin, twin_opt, mesh)
    meta = read_checkpoint_sharded(ck, twin, twin_opt, mesh=train.layout)
    want = unshard_state_dict(model.state_dict(), train.layout)
    got = unshard_state_dict(twin.state_dict(), train.layout)
    if any(not torch.equal(want[k], got[k]) for k in want) or meta["epoch"] != 0:
        raise RuntimeError("sharded checkpoint round trip mismatch")

    # WGATE's and (a) GATE's halo steps
    losses = {}
    for name, cls, kps, kw in (("WGATE", WGATE, 64, dict(window_size=16)),
                               ("GATE", GATE, 29, {})):
        m = cls(kp_dim=2, temporal_dim=32, num_classes=16, embed_dim=64, depths=2, num_heads=4,
                drop_rate=0.1, generator=torch.Generator().manual_seed(0), **kw)
        step, _ = make_sharded_steps(m, make_optimizer("adamw", 5e-4, m.parameters()), mesh,
                                     use_tp=False)
        xb = torch.from_numpy(r.normal(size=(batch, 32, kps, 2)).astype(np.float32))
        yb = torch.from_numpy(r.integers(0, 16, size=batch)).long()
        losses[name] = float(step(*rows_of(step.layout, xb, yb, valid), 0, 0, 0)[0])
    values = [float(loss), float(eval_loss), float(ga_loss), *losses.values()]
    if not np.all(np.isfinite(values)):
        raise RuntimeError(f"non-finite dryrun losses {values}")
    if rank == 0:
        print(f"dryrun_multichip OK: mesh {shape}, flagship(embed128/depths224/f192/remat/"
              f"prune/dropout) train loss {float(loss):.4f}, eval loss {float(eval_loss):.4f}; "
              f"subchecks: WGATE-halo loss {losses['WGATE']:.4f}, GATE-halo loss "
              f"{losses['GATE']:.4f}, grad-accum2 loss {float(ga_loss):.4f}, "
              f"sharded-checkpoint-roundtrip ok", flush=True)


def dryrun_multichip(n_devices: int) -> None:
    """The JAX dryrun's checks on ``n_devices`` gloo CPU ranks."""
    with tempfile.TemporaryDirectory(prefix="sl_hwgat_dryrun_") as tmp:
        spawn(_dryrun_worker, n_devices, tmp)


if __name__ == "__main__":
    import sys

    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
