"""The headline kernel metric of the port: fused window attention, edges/s.

    python -m sl_hwgat_tpu_torch.bench.run [--units N] [--device cpu]

Counterpart of the kernel half of ``bench.py``: it starts
``python -m sl_hwgat_tpu_torch.bench.kernel`` in a child process under a
timeout for the window-attention kernel K1 with bf16 in and out
(``pallas_obf16``), then a second child for ``pair_tscore_bf16``, which
times K1 on prepacked supertiles and its ``torch.bmm`` shape calibration in
turns and gives the median of the per-pair ratios (``bench.py``'s paired
estimator: two separate children drift apart by 10%). The last line of
standard output is

    {"metric": "fused_window_attention_edges_per_sec", "value": ...,
     "unit": "edges/s", "vs_baseline": ..., "vs_calib": ...}

``value`` and ``vs_baseline`` (the share of the H100 bound,
``utils/profiling.py``, the kernel reaches: bound time over measured time)
come from the ``pallas_obf16`` child; ``vs_calib`` is the paired child's
``ratio_vs_calib`` (calibration time over kernel time), with its
``ratio_min``/``ratio_max`` on standard error. ``bench.py`` falls back to
the f32 kernel; here every configuration runs the same K1, so no child
falls back to another: if either prints no line, the run fails and prints
no metric.

Then ``bench.py``'s two step lines (`bench.py:148-199`): children of
``python -m sl_hwgat_tpu_torch.bench.step bf16 16`` time HWGATE's train and
eval steps at FDMSE-ISL, and standard error gets

    {"metric": "hwgate_train_step_clips_per_sec", "value": ..., "unit": "clips/s",
     "vs_step_roofline": ..., "roofline_clips_per_sec": ..., "mfu": ..., ...}

and the same for ``hwgate_eval_step_clips_per_sec``: the share of the
analytic step roofline (``utils/profiling.py::hwgate_step_roofline`` at the
card's peaks) that the measured clips/s reach, and ``mfu``, the roofline's
counted FLOPs over the step's seconds times the bf16 peak. There is no
recorded fallback: a step child that fails or times out fails the run, with
a message and no number. ``BENCH_SKIP_STEP=1`` skips the step lines, as in
``bench.py``; so does ``--device cpu``, which checks the kernel children's
plumbing on host times (a full-size step on the CPU takes minutes).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

CONFIG, IMPL, PAIR = "fused_bf16_obf16", "pallas_obf16", "pair_tscore_bf16"
UNITS = 12288
STEP_BATCH = 16
CHILD_TIMEOUT_S = 600.0  # one child's build of the kernels and its measurement
REPO_ROOT = Path(__file__).resolve().parents[2]


def run_child(impl: str, units: int, device: str) -> dict | None:
    """The JSON line of ``bench.kernel <impl> <units>``, or None (the
    reason on standard error) if the child fails or times out."""
    return _child(["sl_hwgat_tpu_torch.bench.kernel", impl, str(units), "--device", device],
                  impl)


def run_step_child(step: str, device: str) -> dict | None:
    """The JSON line of ``bench.step bf16 16 --step <step>`` (HWGATE), or
    None (the reason on standard error)."""
    return _child(["sl_hwgat_tpu_torch.bench.step", "bf16", str(STEP_BATCH), "--step", step,
                   "--device", device], f"{step} step")


def step_line(step: str, rec: dict) -> dict:
    """``bench.py``'s step line of a ``bench.step`` record, against the
    roofline of the same step at the card's bf16 peaks."""
    from sl_hwgat_tpu_torch.utils.profiling import PEAK_FLOPS, hwgate_step_roofline

    roof = hwgate_step_roofline(rec["batch"], train=step == "train", dtype="bfloat16")
    seconds = rec["time_us"] / 1e6
    return {
        "metric": f"hwgate_{step}_step_clips_per_sec",
        "value": rec["clips_per_sec"],
        "unit": "clips/s",
        "vs_step_roofline": rec["clips_per_sec"] / roof["clips_per_sec"],
        "roofline_clips_per_sec": roof["clips_per_sec"],
        "mfu": roof["flops"] / (seconds * PEAK_FLOPS["bfloat16"]),
        "step_ms_median_min_max": [rec["time_us"] / 1e3, rec["time_us_min"] / 1e3,
                                   rec["time_us_max"] / 1e3],
        "card_ms": rec.get("card_ms"),
        "device": rec["device"],
    }


def _child(args: list, what: str) -> dict | None:
    cmd = [sys.executable, "-m", *args]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO_ROOT), env.get("PYTHONPATH")) if p)
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=CHILD_TIMEOUT_S, env=env,
                             cwd=REPO_ROOT)
    except subprocess.TimeoutExpired:
        print(f"# bench.run: {what} timed out after {CHILD_TIMEOUT_S} s", file=sys.stderr)
        return None
    for line in reversed(out.stdout.splitlines()):
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                break
    tail = out.stderr.strip().splitlines()[-3:]
    print(f"# bench.run: {what} failed (rc={out.returncode}): {tail}", file=sys.stderr)
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--units", type=int, default=UNITS)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("bench.run: no CUDA device (pass --device cpu for host times)",
                  file=sys.stderr)
            return 1

    rec = run_child(IMPL, args.units, args.device)
    if rec is None:
        print(f"bench.run: the kernel child ({IMPL}) printed no line", file=sys.stderr)
        return 1
    pair = run_child(PAIR, args.units, args.device)
    if pair is None:
        print(f"bench.run: the paired calibration child ({PAIR}) printed no line",
              file=sys.stderr)
        return 1

    steps = []
    if args.device == "cuda" and os.environ.get("BENCH_SKIP_STEP") != "1":
        for step in ("train", "eval"):
            step_rec = run_step_child(step, args.device)
            if step_rec is None:
                print(f"bench.run: the {step}-step child printed no line", file=sys.stderr)
                return 1
            steps.append(step_line(step, step_rec))

    seconds = rec["time_us"] / 1e6
    for line in steps:
        print(json.dumps(line), file=sys.stderr)
    print(f"# config={CONFIG} impl={IMPL} time={rec['time_us']:.1f}us "
          f"[{rec['time_us_min']:.1f}, {rec['time_us_max']:.1f}] over {rec['n_repeats']} "
          f"repeats, bound {rec['bound_us']:.1f}us ({rec['bound_by']}), vs_calib "
          f"{pair['ratio_vs_calib']} [{pair['ratio_min']}, {pair['ratio_max']}] ({PAIR}: "
          f"calib {pair['calib_time_us']:.1f}us), device {rec['device']}", file=sys.stderr)
    print(json.dumps({
        "metric": "fused_window_attention_edges_per_sec",
        "value": rec["edges"] / seconds,
        "unit": "edges/s",
        "vs_baseline": rec["bound_us"] / rec["time_us"],
        "vs_calib": pair["ratio_vs_calib"],
        "config": CONFIG,
        "device": rec["device"],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
