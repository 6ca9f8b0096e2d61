"""The port's command line, with the JAX package's flags
(``sl_hwgat_tpu/cli.py``, reference `hwgat/main.py:7-85`):

    python main_torch.py -m {train|test|load} -d <dataset> --model <name>
        [-t time] [-px postfix] [-mw weights] [-k topk] [-c device] ...

Modes: ``train`` a fresh run; ``load`` resumes ``{save_model_path}_{postfix}
.ckpt``, or transfers the weights of ``-mw`` (a port or JAX ``.ckpt``, or a
``.pt``) into a fresh run; ``test`` evaluates only. Every mode ends with the
final top-k table over the three splits and the confusion CSV.

``-c`` keeps the reference's meaning: a CUDA device index (the default "0"
is ``cuda:0``), or ``cpu`` to ask for the CPU. There is no fallback: without
a card a run raises unless it was given ``-c cpu``. ``--prng`` is accepted
and ignored (the port draws its dropout masks and prune scalars from a
``torch.Generator`` seeded per step); ``--ckpt-backend orbax`` writes the
sharded checkpoint directories of ``train/checkpoint.py`` (the flag keeps
the JAX package's name), which resume, transfer and test read back.
"""

from __future__ import annotations

import argparse

import numpy as np


def parser(argv=None) -> argparse.Namespace:
    """The parsed flags of ``argv`` (default ``sys.argv[1:]``)."""
    p = argparse.ArgumentParser()
    p.add_argument("-d", "--dataset", type=str, required=True)
    p.add_argument("-m", "--mode", type=str, default="test", help="train, test, load")
    p.add_argument("-t", "--time", type=str, default="none")
    p.add_argument("-px", "--postfix", type=str, default="none")
    p.add_argument("-model", "--model", type=str, required=True)
    p.add_argument("-c", "--device", type=str, default="0",
                   help="CUDA device index (0 = cuda:0), or 'cpu'")
    p.add_argument("-ft", "--feature_type", type=str, default="keypoints")
    p.add_argument("-mw", "--model_weights", type=str, default="none")
    p.add_argument("-k", "--topk", type=int, default=1)
    p.add_argument("--epochs", type=int, default=None, help="override epoch count")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None,
                   help="override the base learning rate (default 5e-4)")
    p.add_argument("--t-max", type=int, default=None,
                   help="cosine schedule period (default 20; the schedule is periodic, "
                        "so set T_max=epochs for a single decay)")
    p.add_argument("--trace", type=str, default=None,
                   help="write a torch.profiler Chrome trace of the run into this directory")
    p.add_argument("--ckpt-backend", type=str, default="pickle",
                   choices=["pickle", "orbax"],
                   help="checkpoint format: 'pickle' is the port's torch.save file; "
                        "'orbax' the sharded torch.distributed.checkpoint directory")
    p.add_argument("--attn-dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="attention type of HWGATE and HGATE (bfloat16 under f32 projections)")
    p.add_argument("--compute-dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="mixed precision: bfloat16 runs every projection, the FFN and the "
                        "attention in bf16 (parameters, LayerNorm, head and loss stay f32)")
    p.add_argument("--stream-dtype", type=str, default="auto",
                   choices=["auto", "float32", "bfloat16"],
                   help="HWGATE's residual-stream type between blocks (auto: the compute "
                        "dtype)")
    p.add_argument("--remat", action="store_true",
                   help="recompute HWGATE's or HGATE's blocks in the backward pass")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="gradient-accumulation microbatches per optimizer update")
    p.add_argument("--attn-impl", type=str, default="auto",
                   choices=["auto", "stacked", "pallas", "hybrid",
                            "pallas_banded", "pallas_packed", "banded",
                            "compact", "ell"],
                   help="attention path: auto/pallas/stacked (the fused window-attention "
                        "kernels), hybrid (GEMMs around the masked-softmax kernels); "
                        "banded/compact/pallas_banded/pallas_packed select WGATE's and "
                        "GATE's banded attention (one function), ell its edge-space "
                        "gather/scatter form")
    p.add_argument("--prng", type=str, default="auto",
                   choices=["auto", "threefry2x32", "rbg", "unsafe_rbg"],
                   help="accepted for the JAX package's command line; ignored")
    return p.parse_args(argv)


def device_of(flag: str) -> str:
    """``-c``'s value as a torch device name: an index n is ``cuda:n``."""
    return f"cuda:{flag}" if flag.isdigit() else flag


def run(cfg, progress=True):
    """The whole train/test flow of a ``RunConfig`` → (results, state):
    results maps each split to its (loss, top-k accuracy)."""
    from sl_hwgat_tpu_torch.data.dataset import get_loaders
    from sl_hwgat_tpu_torch.models import MODEL_REGISTRY
    from sl_hwgat_tpu_torch.train import checkpoint as ckpt_lib
    from sl_hwgat_tpu_torch.train.loop import (
        EarlyStopper,
        evaluate,
        init_state,
        make_steps,
        predictions_plus_true,
        run_epochs,
    )
    from sl_hwgat_tpu_torch.train.reporting import gen_cm_w, read_class_map, show_final_result

    np.random.seed(cfg.seed)
    if cfg.model_type not in MODEL_REGISTRY:
        raise SystemExit(f"unknown model '{cfg.model_type}'; choose from: "
                         f"{', '.join(sorted(MODEL_REGISTRY))}")
    state = init_state(cfg)
    print("total trainable params :", sum(p.numel() for p in state.model.parameters()))
    train_step, eval_step = make_steps(
        state.model, state.optimizer, cfg.criterion_type,
        grad_accum=cfg.grad_accum if cfg.mode in ("train", "load") else 1)

    if cfg.mode in ("train", "load"):
        loaders = get_loaders(cfg, cfg.train_transform(), cfg.eval_transform())
        try:
            cfg.ensure_out_folder()
            ckpt_lib.save_experiment_snapshot(cfg)
            if cfg.mode == "load":
                if cfg.model_weights:
                    ckpt_lib.load_pretrained_into(state, cfg.model_weights)
                else:
                    ckpt_lib.resume_from(state, f"{cfg.save_model_path}_{cfg.postfix}.ckpt")
            stopper = EarlyStopper(cfg.early_stopping_step, 0) if cfg.early_stopping else None

            def report(epoch, metrics):
                if progress:
                    print(
                        f"epoch {epoch:4d} | tr_ls {metrics['train_loss']:5.2f} "
                        f"tr_ac {metrics['train_acc']:.4f} | v_ls {metrics['val_loss']:5.2f} "
                        f"v_ac {metrics['val_acc']:.4f} | min_v_ls {metrics['best_val_loss']:.4f}"
                    )

            state = run_epochs(cfg, state, train_step, eval_step, loaders[0], loaders[1],
                               early_stopper=stopper, progress=report)
        finally:
            for loader in loaders:
                loader.close()

    # final evaluation on the best checkpoint (≡ main.py:74-85)
    cfg.mode = "test"
    loaders = get_loaders(cfg, cfg.eval_transform(), cfg.eval_transform())
    try:
        best = f"{cfg.save_model_path}_{cfg.postfix}.ckpt"
        try:
            state.model.load_state_dict(ckpt_lib.read_checkpoint(best)["model_state_dict"])
        except FileNotFoundError:
            if cfg.model_weights:
                ckpt_lib.load_pretrained_into(state, cfg.model_weights)
            else:
                print(f"[cli] no checkpoint at {best}; evaluating current weights")
        results = {split: evaluate(eval_step, state, loader, k=cfg.topk)
                   for split, loader in zip(("train", "val", "test"), loaders)}
        show_final_result(results, cfg.topk)
        try:
            class_map = read_class_map(cfg.data.class_map_path)
            y_pred, y_true = predictions_plus_true(eval_step, state, loaders[2])
            cfg.ensure_out_folder()
            gen_cm_w(y_true, y_pred, class_map, cfg.save_cm_path)
        except FileNotFoundError:
            pass
    finally:
        for loader in loaders:
            loader.close()
    return results, state


def main(argv=None):
    from sl_hwgat_tpu_torch.configs import RunConfig

    args = parser(argv)
    cfg = RunConfig(
        dataset=args.dataset,
        model_type=args.model,
        mode=args.mode,
        feature_type=args.feature_type,
        time=args.time,
        postfix=args.postfix,
        model_weights=args.model_weights,
        topk=args.topk,
        device=device_of(args.device),
        ckpt_backend=args.ckpt_backend,
    )
    if args.epochs is not None:
        cfg.epochs = args.epochs
    if args.batch_size is not None:
        cfg.batch_size = args.batch_size
    if args.lr is not None:
        cfg.lr = args.lr
    if args.t_max is not None:
        cfg.scheduler_t_max = args.t_max
    cfg.grad_accum = args.grad_accum
    # the model flags become constructor overrides as in the JAX package
    # (`cli.py:231-245`)
    if args.attn_dtype != "float32" and cfg.model_type in ("HWGATE", "HGATE"):
        cfg.overrides = dict(cfg.overrides, attn_dtype=args.attn_dtype)
    if args.compute_dtype != "float32" and cfg.model_type in ("HWGATE", "HGATE", "WGATE", "GATE",
                                                              "Transformer"):
        cfg.overrides = dict(cfg.overrides, compute_dtype=args.compute_dtype)
    if args.attn_impl != "auto" and cfg.model_type in ("HWGATE", "HGATE"):
        cfg.overrides = dict(cfg.overrides, attn_impl=args.attn_impl)
    if args.stream_dtype != "auto" and cfg.model_type == "HWGATE":
        cfg.overrides = dict(cfg.overrides, stream_dtype=args.stream_dtype)
    if (args.attn_impl in ("pallas_banded", "pallas_packed", "banded", "compact", "ell")
            and cfg.model_type in ("WGATE", "GATE")):
        cfg.overrides = dict(cfg.overrides, attn_impl=args.attn_impl)
    if args.remat and cfg.model_type in ("HWGATE", "HGATE"):
        cfg.overrides = dict(cfg.overrides, remat=True)
    print(cfg.dataset)
    print("Model Name:-", cfg.save_model_path)
    print("Running Mode:-", cfg.mode)
    if args.trace:
        from sl_hwgat_tpu_torch.utils.profiling import trace

        with trace(args.trace):
            run(cfg)
    else:
        run(cfg)


if __name__ == "__main__":
    main()
