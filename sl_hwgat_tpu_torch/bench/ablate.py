"""Where the time of the window-attention kernels for wide units goes.

    python -m sl_hwgat_tpu_torch.bench.ablate

Builds variants of ``csrc/window_attention_{fwd,bwd}.cu`` (with
``csrc/window_attention_wide.cuh``) that each leave one phase out, under
``build/ablate/<variant>/``, and prints one JSON line: the card's time
(``profiling.device_seconds``) of K1 and K2 at HGATE's batch-16 call (3072
units of 58 tokens × dh 64, single mask, no pruning), f32 and bf16 in and
out, for each variant. A variant's output is wrong by design; only its time
is read. The variants:

- ``full``: the kernels as they are;
- ``no_scores``: the kept scores are not computed (a stand-in value each);
- ``no_softmax``: the softmax after the scores is skipped;
- ``no_av``: K1's A·V product is skipped (bf16 and f32 alike);
- ``no_qk_staging``: K1 writes ones in place of the scaled q and k tiles.

The time a phase takes is about ``full`` minus its variant's. It needs a card
and ``nvcc``, as ``chip_smoke.py`` does.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys

import numpy as np
import torch

from sl_hwgat_tpu_torch.graphs.adjacency import hgate_block_adj
from sl_hwgat_tpu_torch.ops import _build
from sl_hwgat_tpu_torch.ops import window_attention as wa
from sl_hwgat_tpu_torch.utils import profiling

UNITS, TOKENS, DH, SCALE = 3072, 58, 64, 0.125
ABLATE_DIR = _build.BUILD_DIR.parent / "ablate"
HEADER, FWD = "window_attention_wide.cuh", "window_attention_fwd.cu"
# variant: {file: [(text, replacement)]}
VARIANTS = {
    "full": {},
    # kept scores stand in for the dot products (nonzero, so the path stays the same)
    "no_scores": {HEADER: [(
        "        const float raw = kk >= 0 ? dot_row(qs + (r0 + g + 8 * h) * S, ks + kk * S) : 0.f;",
        "        const float raw = kk >= 0 ? 1.f + kk : 0.f;")]},
    # the row maxima stay live, so the scores are still computed
    "no_softmax": {HEADER: [(
        "    const bool vanish = (r0 + g >= n || m[0] > kNeg + 104.f) &&",
        "    zero(s);\n    s[0][0] = m[0] + m[1];\n    if (n > 0) return pass;\n"
        "    const bool vanish = (r0 + g >= n || m[0] > kNeg + 104.f) &&")]},
    "no_av": {FWD: [
        ("    strip_ab(p, vs, lane, acc);\n", "    zero(acc);\n    acc[0][0] = __uint_as_float(p[0][0]);\n"),
        ("    tile_product<false>(qs, vs, r0, lane, acc);\n",
         "    for (int i = 0; i < 4; ++i)\n      for (int c = 0; c < 8; ++c) acc[i][c] = qs[i];\n")]},
    # ones in place of the scaled q and k, written without reading them
    "no_qk_staging": {FWD: [(
        "  stage_f32(q + base, qs, n, tid, round_to<T>(scale));\n"
        "  stage_f32(k + base, ks, n, tid, 1.f);\n",
        "  for (int i = tid; i < 2 * kTileElems<float>; i += kThreads) qs[i] = 1.f;\n")]},
}


def build_variant(name: str, edits: dict) -> list[subprocess.Popen]:
    """Copy the sources into ``build/ablate/<name>``, apply ``edits`` and
    start nvcc on both kernels; returns the two processes."""
    out = ABLATE_DIR / name
    out.mkdir(parents=True, exist_ok=True)
    for path in _build.CSRC_DIR.iterdir():
        shutil.copy(path, out / path.name)
    for fname, replacements in edits.items():
        text = (out / fname).read_text()
        for old, new in replacements:
            if old not in text:
                raise ValueError(f"{name}: {fname} no longer holds {old.strip()[:60]!r}")
            text = text.replace(old, new)
        (out / fname).write_text(text)
    return [subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                              str(out / f"lib{src}.so"), str(out / f"{src}.cu")],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for src in (wa.KERNEL, wa.KERNEL_BWD)]


def entry(name: str, src: str):
    fn = getattr(ctypes.CDLL(str(ABLATE_DIR / name / f"lib{src}.so")), src)
    fn.restype = ctypes.c_int
    fn.argtypes = [_build._CTYPES[t] for t in wa._ARGTYPES[src]]
    return fn


def main() -> int:
    if not torch.cuda.is_available():
        print("bench.ablate: no CUDA device", file=sys.stderr)
        return 1
    jobs = {name: build_variant(name, edits) for name, edits in VARIANTS.items()}
    for name, procs in jobs.items():
        for proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                print(f"bench.ablate: {name} failed to build\n{err[-3000:]}", file=sys.stderr)
                return 1
    masks = wa.device_masks(hgate_block_adj(), None, "cuda")
    rng = np.random.default_rng(0)
    times = {}
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        q, k, v, do = (torch.from_numpy(rng.normal(size=(UNITS, TOKENS, DH)).astype(np.float32))
                       .cuda().to(dtype) for _ in range(4))
        o, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
        stream = torch.cuda.current_stream().cuda_stream
        mode = (SCALE, 1, 0, 2, 0, 0, 0, stream)  # scale, zero quirk, single mask, stack 2
        for name in VARIANTS:
            fwd, bwd = entry(name, wa.KERNEL), entry(name, wa.KERNEL_BWD)
            calls = {
                "fwd": lambda: fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                   masks.data_ptr(), None, None, UNITS, TOKENS, DH, code, code,
                                   *mode),
                "bwd": lambda: bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                   dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), masks.data_ptr(),
                                   None, None, UNITS, TOKENS, DH, code, *mode),
            }
            for kind, call in calls.items():
                if call() != 0:
                    raise RuntimeError(f"{name} {kind}: launch failed")
                torch.cuda.synchronize()
                times[f"{name}/{kind}/{str(dtype).split('.')[1]}"] = \
                    profiling.device_seconds(call, calls=20) * 1e3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(json.dumps({"device_ms": times, "shape": [UNITS, TOKENS, DH],
                      "nvidia_smi": smi.stdout.strip().splitlines()[0]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
