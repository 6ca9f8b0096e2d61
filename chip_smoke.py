"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure ends the run non-zero):

1. device   — the card (nvidia-smi name and power limit), torch and CUDA.
2. build    — nvcc builds every CUDA source of the port (sm_90a) into build/,
              one process per source, all at once; every instantiation of
              the K1/K2 kernels for units of up to 64 tokens must take at
              most 128 registers and spill nothing, and no instantiation of
              K7's forward, K8's forward or backward, K1, K2, the tile
              products, the layout kernels (forward and backward),
              softmax_probe or relayout may spill.
3. kernel   — the forward window-attention kernel against its plain PyTorch
              version at the flagship shape (12288 units × 32 tokens × dh 64)
              and at HGATE's (3072 units × 58 tokens × dh 64, two units to a
              64-token padded supertile), and at 96 units of 17, 33, 48 and
              64 tokens under seeded random adjacencies: single and dual
              mask, prune off and u = 0.3, f32 and bf16.
4. backward — the backward kernel against its plain version at the same shapes
              and cases, with a seeded output gradient; the autograd
              Function's gradients equal a direct call of the kernel.
5. forward  — HWGATE at the FDMSE-ISL geometry (192 frames, 2002 classes,
              embed 128, depths (2,2,4), heads (2,4,8)), batch 16, f32 and
              bf16: logits through the kernel against logits through the plain
              attention, and exactly 8 kernel launches per forward.
6. serve    — main path 1: a checkpoint → Predictor.from_checkpoint →
              warmup → 48 raw clips (F_i from 96 to 384 frames) submitted from
              4 threads through BatchingQueue; every row must equal
              predict_logits of its clip. Launch counts are reset just before
              and read just after this phase.
7. train    — HWGATE at FDMSE-ISL, batch 16, f32 and bf16: one step's
              parameter gradients through the kernels against those through
              the plain attention (dropout 0, the same prune generator), every
              parameter's gradient nonzero, 8 forward and 8 backward launches
              per step; ten AdamW steps on one batch lower the loss; a step's
              train-mode loss repeats from its seed.
8. synth    — main path 2: SYNTH written to a temp dir → Loader with the
              train transforms (batch 16) → 2 × train_epoch → evaluate, at
              full width. Launch counts are reset just before and read just
              after this phase: 8 backward launches per train step.
8b. cli     — main path 12, the port's command line: SYNTH written to a temp
              dir, then cli.run at full width, batch 16: train (--epochs 1,
              two epochs), load (--epochs 2, resumed after the best-loss
              checkpoint), test -k 5; the counts are set to 0 just before
              and read just after each run and must be exactly 8 K1 launches
              per train step and eval batch and 8 K2 launches per train step;
              the history holds 3 epochs after load; the artifacts (the
              checkpoints, the two curve PNGs, cm_list_w.csv, config.pkl and
              the source snapshot) exist; the best checkpoint served through
              Predictor.from_checkpoint gives cli.run's logits (the f32 bar).
              Then python3 main_torch.py -m test ... -px best_loss -k 5 as its
              own process prints the final table, which must be cli.run's
              test-mode results (each number within its last printed
              decimal), with no fallback to the current weights; two-epoch
              train runs with and without --remat, f32 and bf16, on clips
              written under FDMSE-ISL's name (192 frames, its 2002-class
              head; 16 K1 and 8 K2 launches per train step with remat), and
              one step's gradients with remat equal to those without it bit
              for bit; one --attn-dtype bfloat16 step against the plain
              attention (the bf16 gradient bar). Its last line gives each
              train epoch's seconds, clips/s and loader wait, and the warm
              epochs' median, beside the nvidia-smi name and power limit.
8c. baselines — STGCN, DecoupledGCN and Transformer at FDMSE-ISL (192 frames,
              2002 classes, 29 joints), batch 16, random weights from seed 0:
              eval logits on the card against the same weights on the CPU
              (f32, atol 2e-4 / rtol 1e-4), one bf16 eval forward of the
              Transformer within 0.15 of its f32 logits' largest (the JAX
              package's bf16 bar; the GCNs run f32 only), 3 AdamW steps with
              finite losses and every BatchNorm running statistic moved, and
              no kernel launch of the port.
8d. cli baselines — for each of the three, cli.run on SYNTH at full width,
              batch 16: train (two epochs; STGCN with the nadam optimizer),
              then test -px best_loss -k 5 in a run of its own.
9. banded   — the banded forward and backward kernels against their plain
              versions at WGATE's (512 planes × 192 frames × 16 joints) and
              GATE's (128 × 192 × 29) batch-16 shapes, dh 16, f32 and bf16,
              under the models' identity ±1-frame band and under a
              non-diagonal band (the spatial plane as prev/next), a second
              backward call equal to the first bit for bit; the autograd
              Function's gradients equal a direct backward call.
10. banded forward — WGATE and GATE at FDMSE-ISL (192 frames, 2002 classes,
              embed 128, 8 blocks, 8 heads), batch 16, f32 and bf16: logits
              through the kernel against the plain attention, 8 launches per
              forward.
11. banded serve — main path 3: for each of WGATE and GATE, a checkpoint →
              Predictor.from_checkpoint → a 24-clip burst from 4 threads
              through BatchingQueue (GATE through the 29-joint transform);
              every row equals predict_logits; counts reset just before and
              read just after each burst.
12. banded train — WGATE and GATE at FDMSE-ISL, batch 16, f32 and bf16: one
              step's gradients through the kernels against the plain
              attention (dropout 0), all nonzero, 8 + 8 launches per step,
              the step repeating bit for bit from its seed; main path 4: ten
              AdamW steps through make_steps lower the loss, with the counts
              reset just before and read just after.
13. masked softmax — the hybrid attention's masked-softmax kernels (K7)
              against their plain versions at HWGATE's (12288 × 32 × 32) and
              HGATE's (3072 × 58 × 58) f32 scores: single and dual mask, prune
              off and 0.3 (HWGATE), P in f32 and bf16; the hybrid attention
              through K7 against the fused kernel (one function); the
              autograd Function's gradient equals a direct backward call.
              Then K7 on bf16 scores (the JAX package's PALLAS_HYBRID_S_BF16
              path: those f32 scores rounded to bf16) at both shapes, single
              mask and dual mask with pruning at 0.3: P in bf16 and f32
              within 4e-3, dS in bf16 within 4e-3 + 1e-2·|x| of the plain
              versions; the hybrid attention with bf16 scores against the
              same call through the plain masked softmax (4e-3); the
              Function's bf16 gradient equals a direct backward call.
    edge cases — the banded kernels under a full band (V = 32, 96 edges a
              row, 64 planes × 37 frames: not a multiple of the frames a
              block) and at GATE's 29 joints in one-frame clips, the backward
              repeating bit for bit; K7 forward and backward at 37 units of
              58 and of 33 tokens (stack 1), dual mask through a seeded sel,
              prune 0.3; K1 and K2 at 96 units of 32 tokens × dh 32, single
              and dual mask, prune 0.3; f32 and bf16, the bars above.
14. windowed forward — HWGATE with attn_impl="hybrid", and HGATE on its
              default (K1/K2 at 58 tokens) and hybrid paths, at FDMSE-ISL,
              batch 16, f32 and bf16: logits against the plain path, 8
              launches per forward and none of the other path's kernels.
15. windowed serve — main paths 5-7: each of the three served from a
              checkpoint through a 24-clip burst (HGATE through the 29-joint
              transform); rows equal predict_logits; counts reset just before
              and read just after each burst.
16. windowed train — the three paths, f32 and bf16: one step's gradients
              against the plain path, all nonzero, 8 + 8 launches; main paths
              8-10: ten AdamW steps lower the loss, counts reset just before
              and read just after.
16b. hybrid bf16 scores — main path 10b: HWGATE and HGATE hybrid, bf16,
              hybrid_scores_dtype="bfloat16", at FDMSE-ISL, batch 16: eval
              logits against the plain path (0.05) and unlike the
              f32-score model's; one step's gradients against the plain path
              (2e-2 of each norm); counts set to 0 just before and read just
              after: exactly 8 K7 forwards a forward, 8 backwards a step, no
              K1/K2. Eval forward and train step ms with f32 and with bf16
              scores in turns; at HWGATE's call (12288 × 32 × 64, bf16) the
              hybrid attention on the parent's f32 products, on bf16
              products, and on bf16 products and scores, forward and
              forward + backward, and each product alone, card ms in turns.
17. timings  — CUDA-event medians of every kernel, its plain version and its
              library yardstick (masked scaled_dot_product_attention, or
              torch.softmax over masked scores for K7; timed, never called by
              the port), for K1/K2 at 32 and 58 tokens, K7 (also on bf16
              scores) and K8/K9 also the card's time of the kernel and of the
              yardstick; the hybrid attention
              against the fused kernels per call; the eval forward and the
              train step of each model and path; a torch.profiler table of
              one eval forward and one train step of each, the bf16 hybrid
              paths also with bf16 scores (annotated ranges left out).
18. probes   — the kernel bench's three probe kernels (stream_probe,
              relayout, tile_matmul) against their plain versions at the
              bench's shapes (12288 units × 32 × 64), f32 and bf16, every mode
              and layout (relayout bit for bit: the bench's transposes and
              gathers, the banded planes, ragged sizes and an unaligned
              input, in both element widths); K10 (banded_packed_mm) at
              WGATE's and GATE's batch-16 shapes; the layout kernel
              (window_attention_into, every instantiation, single mask, dual
              mask with pruning, a given sel) against its plain version and
              bit for bit against K1, and softmax_blocks against its plain
              version; the backward layout kernel (window_attention_bwd_into,
              f32 and bf16, on transposed supertiles and widened planes, the
              same masks) against its plain version and bit for bit against
              K2; every forward entry in TPU layouts (the fused probes,
              pallas_t*, pallas_widepre, pair_tscore) one launch of the
              layout kernel and no other, bit for bit against K1 on plainly
              permuted inputs and within the bar of its plain version; the
              gradient entries (pallas_tbwd, pallas_tsbwd, pallas_widebwd)
              one launch of each layout kernel and no other, bit for bit
              against K1 + K2 on plainly permuted inputs; softmax_only one
              launch of softmax_probe, bit for bit against K7 on the
              gathered blocks. The bf16 dv check anchored on float64: on
              this phase's draw (seed 0) and seeds 18 and 21 in its manner
              (bench.rounding.draw: q, k, v, dO unit normal, 12288 × 32 × 64
              bf16), single mask and dual mask with pruning at 0.3, dV of K2,
              of the backward layout kernel (transposed supertiles, widened
              planes) and of the plain version each within 4e-3 +
              1e-2·|dv64| + Σᵢ ulp_bf16(A64ᵢⱼ)·|dOᵢ| of dV in float64 from
              the float64 A (bench.rounding.dv_float64). Then main path 11:
              the bench's measure() over
              entries of every family and K10 (the layout kernel's five
              instantiations, a gradient entry and hybrid_bf16's K7 among
              them), counts reset just before and read just after.
19. bench    — python -m sl_hwgat_tpu_torch.bench.kernel <impl> for one entry
              of each family and K10 (one after another), then
              python -m sl_hwgat_tpu_torch.bench.run; each prints its line,
              and the run's vs_calib must be its paired child's ratio. Then
              kernel, plain, bound and library ms of the probe kernels: the
              layout kernel on one entry of each instantiation, tsw and the
              paired entry (library: masked SDPA, token-major), softmax_probe
              (library: torch.softmax over the masked blocks), the backward
              layout kernel alone (library: masked SDPA's backward alone,
              token-major) and the gradient entries beside masked SDPA's
              forward, the same loss and its backward, with one entry's
              profile (the two layout kernels beside the loss's passes).

20. step bench — the port's bench entry points as a user runs them:
              bench.step's train and eval lines (repeats 3, batch 16) for
              HWGATE (bf16, f32, and bf16 with attn_impl="hybrid"), HGATE,
              WGATE, GATE and Transformer (bf16), STGCN and DecoupledGCN
              (f32), then bench.serve's line (HWGATE bf16: buckets 1-64 and
              128 requests from 32 clients through BatchingQueue), each
              printed as it is with finite numbers, every request answered;
              bench.run's two HWGATE step lines (phase 19's run, with
              vs_step_roofline and mfu) beside them; the launch counts set
              to 0 just before and read just after; the attention's
              (K1 + K2) / K1 card ratio of phase 17 beside the roofline's
              constant. Phase 17's profile covers the three baselines too.
21. ell      — WGATE and GATE with attn_impl="ell" (the edge-space gather/
              scatter attention, plain torch) at FDMSE-ISL, full width, batch
              16: f32 logits against the same weights on the banded kernels
              (the f32 logit bar), one f32 step's gradients against theirs
              (the f32 gradient bar), no banded launch on the ELL path, a
              Predictor bucket-16 call against the banded Predictor's, peak
              memory; the kernel bench's ell* entries beside K8's
              banded_packed* entries and masked SDPA on the same shapes.
22. data tools — main path 13: synthetic 192-frame mediapipe keypoint clips
              (16 classes × 6) → fdmse_meta → generate_meta → preprocess into
              a pickle store and a clip store under FDMSE-ISL (64 / 16 / 16
              clips); the native reader's clips equal the pickle store's bit
              for bit; a clip read's µs through each reader and the pickle's
              copy, on one thread and on 8; cli.run trains HWGATE two
              epochs from each store in turns (clip store, then pickle) and
              tests it from each (counts reset just before and read just
              after each run, exactly 8 K1 launches per step and eval batch,
              8 K2 per step); each store's warm epoch, and its train loader's
              epoch alone (same turns).
23. export   — main path 14: HWGATE bf16, HWGATE hybrid bf16 (f32 scores,
              and bf16 scores: bit for bit or the phase fails) and WGATE f32
              exported at bucket 16 (Predictor.export_program), loaded in a
              fresh python3 by Predictor.load_exported with no module of the
              port's models, of jax or of sl_hwgat_tpu imported; one call
              launches exactly 8 K1, 8 K7 or 8 K8 forwards and no other
              kernel; logits against Predictor.forward's (bit for bit, else
              within the model's bar with the first differing submodule
              named); card and host ms of both.
24. parallel — the parallel layer (dp, sp, tp over torch.distributed): four
              ranks sharing cuda:0 over gloo run HWGATE at FDMSE-ISL (batch
              16, f32 and bf16, prune on, dropout 0) at mesh (1, 2, 2), its
              eval logits, one train step and the eval step against the
              single-process steps on the card (the logit and gradient bars),
              and one attn_impl="hybrid" eval forward; WGATE and GATE (f32)
              at (2, 2, 1) with K8 on each rank's halo-extended planes; every
              rank launching exactly 8 K1 a forward, 8 K2 a step, 8 K7 a
              hybrid forward, 8 K8 forwards and 8 backwards a step (counts
              from 0 in each rank, read after each step). Then
              run_distributed on 2 ranks at (2, 1, 1) over SYNTH (2 epochs,
              batch 16) with each checkpoint backend: the ranks agree, each
              reads 8 rows of every batch, rank 0's checkpoint is its epoch's
              weights bit for bit and serves their logits through
              Predictor.from_checkpoint; and one HWGATE f32 step in a
              one-rank NCCL group, bit for bit the single-process step.
              Prints host ms per sharded step beside the nvidia-smi name and
              power limit. Gloo ranks that share a card show the functions
              right and the launches per rank, not scaling. In the same spawn:
              the Transformer f32 at (1, 2, 2) (its frames over sp, the keys
              gathered; heads over tp): logits and one train step; STGCN and
              DecoupledGCN f32 at (2, 2, 1) (temporal halo, frame means, dp ×
              sp BatchNorm statistics), dropout and DropGraph on: logits, one
              train step and the eval step; each against the single-process
              steps at the same bars, with no kernel launch.
25. scaling  — python -m sl_hwgat_tpu_torch.bench.scaling's measure() and
              measure_banded(), both in one spawn a scale: n = 1 over NCCL,
              then n = 2 as gloo ranks sharing cuda:0 (shared_card: their
              lines enter no scaling_efficiency line); each rank exactly 40
              K1 launches (12288 units of 32 × 64, f32) and 40 K8 (128 planes
              × 96 frames × 29 joints, dh 16, behind the halo exchange at n =
              2); each rank's last K1 output bit for bit the single-process
              K1 on its units, its last K8 output within 1e-5 of its rows of
              the unsharded K8 calls. The records carry host and card µs per
              op beside the nvidia-smi name and power limit.

The last lines are the kernels line, the nvidia-smi line and
{"ok": true, "device": {...}}. Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import functools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

# the least time of a call on an H100 SXM: bytes over its memory rate, or
# operations over the type's peak (f32 CUDA cores, bf16 dense tensor cores)
from sl_hwgat_tpu_torch.utils.profiling import bound as h100_bound
from sl_hwgat_tpu_torch.utils.profiling import device_seconds

SEED = 0
UNITS, TOKENS, HEAD_DIM = 12288, 32, 64  # 16·96·4·2 = 16·48·4·4 = 16·24·4·8
# (units, tokens, head dim) of one windowed attention call at batch 16:
# HWGATE's 32-token windows, HGATE's 58-token whole skeletons (16·96·2 =
# 16·48·4 = 16·24·8 units of 29 joints × 2 frames)
WINDOW_SHAPE = {"HWGATE": (UNITS, TOKENS, HEAD_DIM), "HGATE": (3072, 58, HEAD_DIM)}
TOL = {"float32": 1e-5, "bfloat16": 4e-3}
# backward kernel vs plain: |got - want| <= atol + rtol·|want| (one bf16 ulp is 2^-8)
BWD_TOL = {"float32": dict(atol=2e-5, rtol=0.0), "bfloat16": dict(atol=4e-3, rtol=1e-2)}
LOGIT_TOL = {"float32": dict(atol=2e-4, rtol=1e-4), "bfloat16": dict(atol=0.05, rtol=0.05)}
# model gradients, kernels vs plain attention: max abs error (f32) and
# ‖g − g′‖/‖g′‖ per parameter (bf16) (tests/test_pallas_attention.py:380)
GRAD_ATOL_F32, GRAD_REL_BF16 = 5e-4, 2e-2
LR = 5e-4


def ms_bound(nbytes: float, flops: float, dtype_name: str) -> tuple[float, str]:
    """(least ms on an H100 SXM, "bytes" or "operations") of a call that
    moves ``nbytes`` and does ``flops`` operations in ``dtype_name``."""
    seconds, by = h100_bound(nbytes, flops, dtype_name)
    return seconds * 1e3, by


def ptxas_kernels(log: str) -> dict:
    """{kernel: {"registers": n, "spill_bytes": stores + loads,
    "static_smem_bytes": n}} of every entry function in nvcc's ``-Xptxas -v``
    output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m and name:
            out[name]["static_smem_bytes"] = int(m.group(1))
    return out


# K1/K2 for units of up to 64 tokens: what the kernels line says of them
WIDE_DESIGN = ("units of up to 64 tokens (HGATE's 58): one 4-warp block per unit, 16 query rows "
               "a warp; scores and softmax on the mma.sync accumulator layout, shared by K1 and "
               "K2 (window_attention_wide.cuh); scores as exact f32 FMA chains in the plain "
               "GEMM's order in both types, only the kept ones where a row keeps at most 8 keys "
               "(a compacted softmax); the other bf16 products on the tensor cores (mma.sync "
               "m16n8k16, f32 sums, ldmatrix), f32 ones exact on the CUDA cores in register tiles")


def wide_ptxas(report: dict) -> dict:
    """ptxas's registers and spills of every wide K1/K2 instantiation built in
    this run; fails unless each takes at most 128 registers and spills
    nothing."""
    wide = {name: r for src in ("window_attention_fwd", "window_attention_bwd") if src in report
            for name, r in ptxas_kernels(report[src]["log"]).items() if "_wide_kernel" in name}
    expected = 4 * ("window_attention_fwd" in report) + 2 * ("window_attention_bwd" in report)
    if len(wide) != expected:
        raise AssertionError(f"ptxas reported {len(wide)} wide K1/K2 kernels, not {expected}")
    for name, r in wide.items():
        if not (r.get("registers", 256) <= 128 and r.get("spill_bytes", 1) == 0):
            raise AssertionError(f"{name}: {r} (at most 128 registers and no spills)")
    return wide


# the kernels redesigned since the first designs: K7's forward and K8's
# backward, then K2 at 32 tokens and K8's forward, then K1 at 32 tokens and
# the tile products, then the fused probes (the layout kernel) and
# softmax_only (softmax_probe), then the gradient entries (the backward
# layout kernel) and relayout's transpose, then K7's forward again with its
# backward (spans staged by bulk copies); their sources and what the
# kernels line says of their design. The build phase fails if any of their
# instantiations spills.
REDESIGNED = {
    "window_attention_fwd": (
        "32-token units (HWGATE): one warp per unit (4 a block), q and v staged by cp.async in "
        "16-byte chunks in the warp's own shared memory (rows padded by 16 bytes), k as f32 "
        "rows (bf16 converted, every 16-byte load in flight first); a lane per query row for "
        "the scores, prune, mask and softmax through attention_row, the routine K2 recomputes "
        "A with (f32 FMA chains over d, sums in j order, so A and the prune decisions are K2's "
        "bit for bit); A V on two 16-row strips: f32 in 4 x 8 register tiles over a swizzled "
        "T(A) tile (sums over j ascending from 0: the lane-per-column design's bits), bf16 on "
        "mma.sync m16n8k16 (T(A) by ldmatrix, V by ldmatrix.trans, f32 sums) with O through "
        "shared memory and out in 16-byte chunks. Units of up to 64 tokens: the wide design "
        "(wide_design)"),
    "tile_matmul": (
        "bf16 inputs: a block per tile, a warp per 16-row strip; X, Y, Z staged in bf16 by "
        "16-byte cp.async (element-wise along the unit stride for other views), rows padded "
        "by 16 bytes, rows past the tile and depths past K zero; S on mma.sync m16n8k16 with "
        "f32 sums, 64 columns at a time, rounded to bf16 in registers and fed back as the A "
        "operand of O += S Z (Z by ldmatrix.trans); O through shared memory, out in 16-byte "
        "chunks. f32 inputs: exact f32 FMAs, a block of 256 threads per 128-row slice, X and "
        "64-row chunks of Y staged depth-major, 8 x 4 register tiles of S (three 16-byte loads "
        "a depth step), S chunks transposed through shared memory, O in 8 x C/16 register "
        "tiles; every sum over its index ascending from 0"),
    "masked_softmax_fwd": (
        "every score and P type: a grid of the resident blocks, each walking spans of rows "
        "(whole passes of its 8 warps, about 24 KB of scores and P: 192 rows at 32 tokens, "
        "96 at 58, with bf16 S and P) "
        "through two input stages in shared memory, each span's scores brought by one 1-D "
        "bulk copy (cp.async.bulk, issued by one thread, completion on an mbarrier), the "
        "next span's in flight under this one's rows, which write P into one of two output "
        "stages stored back by one bulk copy (whole 32-byte sectors); the threads store the "
        "entries of a span's first and last 16-byte chunk where another span shares it "
        "(33-token units, a tensor off a 16-byte boundary), loads take the chunks whole; "
        "the row masks staged in shared memory; HWGATE's 32 and HGATE's 58 tokens compiled "
        "as constants, the rows of whole aligned spans without a guard on each row. Rows: a "
        "row per 8 lanes (16 for n > 32), four columns a lane by a map n alone fixes (quads for n % 4 == 0, pairs for "
        "HGATE's 58, l + Lc for odd n), reductions over the lane's columns then 3 (4) xor "
        "shuffles, P = exp times one reciprocal of the sum, through the row routine "
        "(masked_softmax_common.cuh) K7's backward recomputes A with, so P is the earlier "
        "design's bit for bit"),
    "masked_softmax_bwd": (
        "the forward's design (masked_softmax_common.cuh) but for f32 scores with f32 dP: "
        "staged_spans, a span of S and of dP (about 24 KB with dS: 128 rows at 32 tokens, 64 "
        "at 58, with bf16 S and dP) "
        "brought by two bulk copies on one mbarrier, dS = A o (dP - rowsum(dP o A)) o pass "
        "in f32 with A from the shared row routine, into an output stage stored back by one "
        "bulk copy; f32 scores with f32 dP the direct design (a block of 128/n units, each "
        "lane's columns read and written in device memory); dS bit for bit the earlier "
        "design's"),
    "banded_attention_bwd": (
        "a block of ceil((128/V + 2)·V / 32) warps owns 128/V frames of a plane: q, dO of its "
        "frames ±1 and k, v of its frames ±2 staged in q's type by cp.async, 16-byte chunks "
        "swizzled per row (no bank conflicts for 8 consecutive rows); row phase, one thread "
        "per staged query row in one round: each edge's score and dP once, A and dS cached "
        "in shared memory by edge rank (f32 dots in d order on the CUDA cores, max then sum "
        "in (plane, joint) order as the forward), dQ of its own rows; column phase: dK then "
        "dV of each own key row gathered from the cache (no atomics); rows with more edges "
        "than the cache's 32 recompute the rest from the kept (max, sum, D)"),
    "window_attention_bwd": (
        "32-token units (HWGATE): one warp per unit (4 a block in f32, 1 in bf16), its rows "
        "staged by cp.async in the warp's own shared memory; row phase, a lane per query row: "
        "A and its pass bits from K1's attention_row (f32 keys, sums in j order, so prune "
        "decisions match the forward's), dA and dS; then 16-row strips. f32: K and V staged, "
        "dA as FMA chains over d, dQ, dV and dK in 4 x 8 register tiles from swizzled T(A) and "
        "dS tiles, dO then Q staged over K's rows (sums over m ascending from 0: the "
        "one-lane-per-row design's bits). bf16: q, k, v, dO staged; dA, dQ, dV and dK on "
        "mma.sync m16n8k16 (f32 sums, ldmatrix, .trans for the transposed operands), A meeting "
        "dA on the accumulator layout through a shared f32 tile. Units of up to 64 tokens: the "
        "wide design (wide_design)"),
    "window_attention_layout": (
        "K1's forward at 32-token units (dh 64) on strided views of the TPU layouts, no "
        "relayout: a warp per unit, 4 a block; each operand a view whose units are "
        "(a, b, s) leading axes, token-major (features contiguous, a row stride) or "
        "transposed (tokens contiguous, a feature stride); rows staged as K1 stages them, "
        "columns by cp.async as dh rows of 32 tokens padded by 16 bytes, lane i reading "
        "token i (its query row straight into registers; k as f32 rows, each lane starting "
        "at another 4-feature chunk: no bank conflicts); attention_row and K1's A V (bf16 "
        "mma.sync, V^T by ldmatrix where V is transposed; f32 4 x 8 register tiles after V's "
        "columns become rows), so o is K1's bit for bit; o through shared memory, 16-byte "
        "stores along rows or tokens (f32 O^T chunks swizzled by the feature quad). "
        "Instantiations: all transposed (f32, bf16), q rows (bf16), q and k rows (bf16), all "
        "rows (bf16)"),
    "softmax_probe": (
        "softmax_only in one pass: a block of 8 warps a (SN, DH) tile; the 64 rows of its two "
        "diagonal 32 x 32 unit blocks through K7's row routine (masked_softmax_common.cuh: a "
        "row per 8 lanes, four columns a lane, 16-byte loads and stores), so P is K7's bit "
        "for bit; the rest of the tile zero-filled with 16-byte stores, consecutive threads "
        "on consecutive chunks"),
    "window_attention_layout_bwd": (
        "K2's backward at 32-token units (dh 64) on strided views of the TPU layouts, no "
        "relayout: a warp per unit, 2 a block; every operand transposed (a feature's 32 "
        "tokens contiguous: the transposed units and supertiles, the widened planes), staged "
        "by cp.async as dh rows of 32 tokens padded by 16 bytes; K2's row and product phases "
        "(window_attention_bwd_unit.cuh, shared with K2), so dq, dk, dv are K2's bit for bit. "
        "bf16: k also as f32 rows for attention_row, query row i straight from q's columns, "
        "every mma.sync fragment by ldmatrix on the transposed tiles (plain where K2 uses "
        ".trans and the reverse: K2's registers), each 16-row strip out through a 2 KB "
        "swizzled tile by stmatrix .trans and 16-byte stores along tokens, 28 KB a warp. f32: "
        "columns turned into f32 rows in place (k, v, then dO, then q), the query and dO rows "
        "read straight from the columns, dS^T beside dS so that dQ runs on transposed "
        "register tiles too, 4 tokens a lane stored as one 16-byte chunk, 22 KB a warp"),
    "relayout": (
        "innermost axis moves, both axes a multiple of 16 bytes of elements and aligned: a "
        "lane transposes 8 x 8 (2-byte) or 4 x 4 (4-byte) blocks in registers (prmt pairs "
        "rows into 32-bit words; then only register names change), 16-byte loads along the "
        "input's rows and 16-byte stores along the output's, 16 words in flight a thread; a "
        "warp a 64 x 64 (64 x 32) tile, lanes split between the axes by their block counts, "
        "a grid-stride loop over as many 256-thread blocks as the card holds, 32-bit "
        "indices, no shared memory; other sizes: 32 x 32 tiles through shared memory. "
        "Innermost axis stays: a row gather in 16-byte words"),
    "banded_attention_fwd": (
        "a block of 128 threads owns 128/V frames of a plane (8 at V = 16, 4 at 29): q of its "
        "frames and k, v of its frames ±1 staged in q's type by cp.async, 16-byte chunks "
        "swizzled per row; a thread per query row computes each edge's score once (f32 dot in d "
        "order), caching the scores, then exp(s − max), in shared memory by edge rank; A·V "
        "reads each term once; max then sum in (plane, joint) order as before, so o is the "
        "earlier design's bit for bit; rows with more edges than the cache's 32 recompute the "
        "rest"),
}


def redesigned_ptxas(report: dict) -> dict:
    """{source: ptxas's registers, spills and static shared memory of each
    instantiation} of the REDESIGNED sources built in this run; fails on a
    spill."""
    out = {src: ptxas_kernels(report[src]["log"]) for src in REDESIGNED if src in report}
    for src, kernels in out.items():
        if not kernels:
            raise AssertionError(f"ptxas reported no kernel of {src}")
        for name, r in kernels.items():
            if r.get("spill_bytes", 1) != 0:
                raise AssertionError(f"{src}: {name} spills: {r}")
    return out


# (rows, depth, columns, mode) of the tile products' main cases
TILE_BLOCKS = {"matmul_only": (128, 64, 64, 0), "sn256": (256, 64, 64, 0),
               "K10/WGATE": (128, 16, 16, 0), "K10/GATE": (116, 16, 16, 0),
               "dot1": (128, 64, 64, 1)}


def redesigned_blocks() -> dict:
    """{source: {case: ...}}: one block of each REDESIGNED kernel at the main
    paths' shapes, as its launcher sizes it: K7's rows a span (f32 scores:
    a block) and dynamic shared memory by score and P (dP) type (256
    threads a block), K8's
    dynamic shared memory and threads (under each model's band and the
    non-diagonal one), K1's and K2's at 32 tokens by head dim and type, the
    tile products' by case and input type, the layout kernel's by type and
    operand forms (bit 0 q … bit 3 o, 1 = transposed), softmax_probe's, the
    backward layout kernel's by type (every operand transposed), and
    relayout's block transpose's threads and warp tile by element width."""
    import ctypes

    from sl_hwgat_tpu_torch.ops import _build
    from sl_hwgat_tpu_torch.ops.banded_attention import edges_per_row

    first, second = ctypes.c_int(), ctypes.c_int()

    def block(fn, names, *args):
        fn.restype = ctypes.c_int
        if fn(*args, ctypes.byref(first), ctypes.byref(second)) != 0:
            raise AssertionError(f"{fn.__name__}{args}: refused")
        return dict(zip(names, (first.value, second.value)))

    softmax = {src: getattr(_build.load(src), f"{src}_block")
               for src in ("masked_softmax_fwd", "masked_softmax_bwd")}
    window = _build.load("window_attention_bwd").window_attention_bwd_block
    window_fwd = _build.load("window_attention_fwd").window_attention_fwd_block
    tiles = _build.load("tile_matmul").tile_matmul_block
    layout = _build.load("window_attention_layout").window_attention_layout_block
    softmax_probe = _build.load("softmax_probe").softmax_probe_block
    layout_bwd = _build.load("window_attention_layout_bwd").window_attention_layout_bwd_block
    relayout = _build.load("relayout").relayout_block
    out = {src: {f"{m}/s_{sn}/{'p' if src.endswith('fwd') else 'dp'}_{on}":
                 block(fn, ("span_rows", "dynamic_smem_bytes"), n, sc, oc)
                 for m, (_, n, _) in WINDOW_SHAPE.items()
                 for sc, sn in enumerate(("float32", "bfloat16"))
                 for oc, on in enumerate(("float32", "bfloat16"))}
           for src, fn in softmax.items()}
    out.update({
           "window_attention_bwd": {
               f"dh{dh}/{name}": block(window, ("dynamic_smem_bytes", "threads"), dh, code)
               for dh in (32, 64) for code, name in enumerate(("float32", "bfloat16"))},
           "window_attention_fwd": {
               f"dh{dh}/{name}": block(window_fwd, ("dynamic_smem_bytes", "threads"), dh, code)
               for dh in (32, 64) for code, name in enumerate(("float32", "bfloat16"))},
           "tile_matmul": {
               f"{case}/{name}": block(tiles, ("dynamic_smem_bytes", "threads"), *shape, code)
               for case, shape in TILE_BLOCKS.items()
               for code, name in enumerate(("float32", "bfloat16"))},
           "window_attention_layout": {
               f"{name}/forms{forms:04b}": block(layout, ("dynamic_smem_bytes", "threads"), code,
                                                  forms)
               for code, name, forms in ((0, "float32", 0b1111), (1, "bfloat16", 0b1111),
                                         (1, "bfloat16", 0b1110), (1, "bfloat16", 0b1100),
                                         (1, "bfloat16", 0b0000))},
           "softmax_probe": {"softmax_only": block(softmax_probe, ("tiles", "threads"))},
           "window_attention_layout_bwd": {
               f"{name}/forms1111111": block(layout_bwd, ("dynamic_smem_bytes", "threads"), code,
                                             0b1111111)
               for code, name in enumerate(("float32", "bfloat16"))},
           "relayout": {f"{width}-byte": block(relayout, ("threads", "warp_tile_elements"), width)
                        for width in (2, 4)}})
    for src in ("banded_attention_fwd", "banded_attention_bwd"):
        fn = getattr(_build.load(src), f"{src}_block")
        out[src] = {}
        for model, kinds in banded_bands().items():
            for kind, band in kinds.items():
                for code, name in enumerate(("float32", "bfloat16")):
                    out[src][f"{model}/{kind}/{name}"] = block(
                        fn, ("dynamic_smem_bytes", "threads"), band.shape[1], code,
                        edges_per_row(band))
    return out


_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line; ``elapsed_s``: seconds since the script
    started, so a phase's time is the difference to the line before."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - _START}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = 30, inner: int = 10, warmup: int = 5) -> float:
    """Median milliseconds of one call of ``fn`` on the current stream, by CUDA
    events around ``inner`` back-to-back calls: with one call per sample, the
    host's time to prepare the launch into an empty queue would be counted as
    device time."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def attention_inputs(dtype, model: str = "HWGATE"):
    """Seeded q, k, v of one of ``model``'s attention calls on the card; v at
    0.2 scale keeps |o| < 1, where one bf16 ulp (2^-8) sits inside the 4e-3
    bar."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn(*WINDOW_SHAPE[model], generator=g, device="cuda") for _ in range(3))
    return q.to(dtype), k.to(dtype), (v * 0.2).to(dtype)


def output_grad(dtype, model: str = "HWGATE"):
    """Seeded gradient of the output of one of ``model``'s attention calls."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    return torch.randn(*WINDOW_SHAPE[model], generator=g, device="cuda").to(dtype)


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[1]


def masks(model: str = "HWGATE"):
    """(adj, tail_adj) of ``model``'s windowed attention."""
    from sl_hwgat_tpu_torch.graphs.adjacency import hgate_block_adj, windowed_block_adj
    from sl_hwgat_tpu_torch.models.hwgate import shift_tail_mask

    if model == "HGATE":
        adj = hgate_block_adj()
        return adj, adj * shift_tail_mask(29, 2, 1)
    adj = windowed_block_adj(2)[0]
    return adj, adj * shift_tail_mask(16, 2, 1)


def attention_kwargs(dual: bool, prune_u, tail, model: str = "HWGATE"):
    import torch

    if model == "HGATE":  # 58 tokens padded to 64, two units to a supertile
        kw = dict(scale=HEAD_DIM**-0.5, stack=2, pad_tokens=64)
    else:
        kw = dict(scale=HEAD_DIM**-0.5, stack=4)
    if prune_u is not None:
        kw["prune_u"] = torch.full((1,), prune_u, device="cuda")
    if dual:  # stage 0 at batch 16: 96 temporal groups of nW·h = 8 (HGATE: h = 2) units
        kw.update(tail_adj=tail, units_per_group=8 if model == "HWGATE" else 2, groups=96)
    return kw


# Unit sizes that the wide K1/K2 kernels cut into 16-row strips otherwise
# than HGATE's 58, checked beside it at WIDE_UNITS units each.
WIDE_TOKENS, WIDE_UNITS = (17, 33, 48, 64), 96


def wide_unit_masks(n: int):
    """A seeded random symmetric (n, n) adjacency with self-loops, about 7
    kept keys a row, so that some warps of the wide kernels take their
    compacted path (rows of at most 8 keys) and others the dense one; and a
    tail plane keeping a random symmetric part of it."""
    import numpy as np

    rng = np.random.default_rng(SEED + n)
    eye = np.eye(n, dtype=bool)
    a = rng.random((n, n)) < 3.0 / n
    adj = a | a.T | eye
    t = rng.random((n, n)) < 0.5
    return adj.astype(np.float32), (adj & (t | t.T | eye)).astype(np.float32)


def wide_unit_cases(dtype):
    """(case, q, k, v, dO, adj, kwargs) of the wide kernels at every
    WIDE_TOKENS size, HGATE's arguments (two units to a 64-token padded
    supertile): single and dual mask, prune off and u = 0.3."""
    import torch

    for n in WIDE_TOKENS:
        adj, tail = wide_unit_masks(n)
        g = torch.Generator(device="cuda").manual_seed(SEED + n)
        q, k, v, do = (torch.randn(WIDE_UNITS, n, HEAD_DIM, generator=g, device="cuda")
                       for _ in range(4))
        q, k, v, do = q.to(dtype), k.to(dtype), (v * 0.2).to(dtype), do.to(dtype)
        for dual in (False, True):
            for prune_u in (None, 0.3):
                kw = dict(scale=HEAD_DIM**-0.5, stack=2, pad_tokens=64)
                if prune_u is not None:
                    kw["prune_u"] = torch.full((1,), prune_u, device="cuda")
                if dual:
                    kw.update(tail_adj=tail, units_per_group=2, groups=4)
                case = (f"HGATE/{dtype_name(dtype)}/n{n}/{'dual' if dual else 'single'}/"
                        f"prune={prune_u}")
                yield case, q, k, v, do, adj, kw


def stack1_cases(dtype):
    """(case, q, k, v, dO, kwargs) of K1/K2 at HGATE's 58-token units with
    one unit a supertile: what a shifted block runs with one head a rank
    (stage 0 of the defaults at tp 2, 16 clips × 48 temporal groups of
    one unit at sp 2), single and dual mask; "sel" is the last sp rank's
    selector (its last group is the clip's last), "sel0" the first rank's
    (no group of it is)."""
    from sl_hwgat_tpu_torch.parallel.kernel_sharding import local_sel

    units, groups = 16 * 48, 48
    q, k, v = (t[:units] for t in attention_inputs(dtype, "HGATE"))
    do = output_grad(dtype, "HGATE")[:units]
    _, tail = masks("HGATE")
    base = dict(scale=HEAD_DIM**-0.5, stack=1, pad_tokens=64)
    dual = dict(base, tail_adj=tail, units_per_group=1, groups=groups)
    cases = {"single": base, "dual": dual,
             "sel": dict(dual, sel=local_sel(units, 1, 1, groups, groups, 2 * groups, "cuda")),
             "sel0": dict(dual, sel=local_sel(units, 1, 1, groups, 0, 2 * groups, "cuda"))}
    for mask, kw in cases.items():
        yield f"HGATE/{dtype_name(dtype)}/stack1/{mask}", q, k, v, do, kw


def case_prefix(model: str) -> str:
    """The prefix of ``model``'s cases in the kernel phases' error keys."""
    return "" if model == "HWGATE" else f"{model}/"


def phase_kernel(model: str = "HWGATE"):
    import torch

    from sl_hwgat_tpu_torch.ops.window_attention import plain_window_attention, window_attention

    adj, tail = masks(model)
    errors = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        q, k, v = attention_inputs(dtype, model)
        for dual in (False, True):
            for prune_u in (None, 0.3):
                kw = attention_kwargs(dual, prune_u, tail, model)
                got = window_attention(q, k, v, adj, out_dtype=dtype, **kw)
                want = plain_window_attention(q, k, v, adj, out_dtype=dtype, **kw)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                case = f"{case_prefix(model)}{name}/{'dual' if dual else 'single'}/prune={prune_u}"
                errors[case] = err
                if not err <= TOL[name]:
                    raise AssertionError(f"kernel vs plain {case}: max abs err {err} > {TOL[name]}")
        if model == "HGATE":
            cases = [(c, q, k, v, a, kw) for c, q, k, v, _, a, kw in wide_unit_cases(dtype)]
            cases += [(c, q, k, v, adj, kw) for c, q, k, v, _, kw in stack1_cases(dtype)]
            for case, q, k, v, adj_n, kw in cases:
                got = window_attention(q, k, v, adj_n, out_dtype=dtype, **kw)
                want = plain_window_attention(q, k, v, adj_n, out_dtype=dtype, **kw)
                torch.cuda.synchronize()
                errors[case] = err = (got.float() - want.float()).abs().max().item()
                if not err <= TOL[name]:
                    raise AssertionError(f"kernel vs plain {case}: max abs err {err} > {TOL[name]}")
    units, tokens, head_dim = WINDOW_SHAPE[model]
    emit("kernel", model=model, units=units, tokens=tokens, head_dim=head_dim, tolerance=TOL,
         unit_sizes=list(WIDE_TOKENS) if model == "HGATE" else None, max_abs_err=errors)
    return errors


def check_gradients(detail: dict, case: str, got, want, dtype) -> float:
    """Hold the kernel's (dq, dk, dv) against the plain version's at
    BWD_TOL; record each max abs error under ``detail[case]``; return the
    largest."""
    import torch

    torch.cuda.synchronize()
    tol = BWD_TOL[dtype_name(dtype)]
    detail[case] = {}
    for grad, g, w in zip(("dq", "dk", "dv"), got, want):
        diff = (g.float() - w.float()).abs()
        excess = (diff - tol["atol"] - tol["rtol"] * w.float().abs()).max().item()
        detail[case][grad] = diff.max().item()
        if g.dtype != dtype or not excess <= 0:
            raise AssertionError(f"backward kernel vs plain {case} {grad}: max abs "
                                 f"err {detail[case][grad]} over {tol}")
    return max(detail[case].values())


def phase_backward(model: str = "HWGATE"):
    import torch

    from sl_hwgat_tpu_torch.ops.window_attention import (
        plain_window_attention_bwd,
        window_attention,
        window_attention_bwd,
    )

    adj, tail = masks(model)
    errors, detail = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        q, k, v = attention_inputs(dtype, model)
        do = output_grad(dtype, model)
        for dual in (False, True):
            for prune_u in (None, 0.3):
                kw = attention_kwargs(dual, prune_u, tail, model)
                got = window_attention_bwd(q, k, v, do, adj, **kw)
                want = plain_window_attention_bwd(q, k, v, do, adj, **kw)
                case = f"{case_prefix(model)}{name}/{'dual' if dual else 'single'}/prune={prune_u}"
                errors[case] = check_gradients(detail, case, got, want, dtype)
        if model == "HGATE":
            cases = list(wide_unit_cases(dtype))
            cases += [(c, q, k, v, do, adj, kw) for c, q, k, v, do, kw in stack1_cases(dtype)]
            for case, q, k, v, do, adj_n, kw in cases:
                got = window_attention_bwd(q, k, v, do, adj_n, **kw)
                want = plain_window_attention_bwd(q, k, v, do, adj_n, **kw)
                errors[case] = check_gradients(detail, case, got, want, dtype)
    # the autograd Function's gradients are the kernel's
    q, k, v = (t.detach().requires_grad_() for t in attention_inputs(torch.float32, model))
    do = output_grad(torch.float32, model)
    kw = attention_kwargs(True, 0.3, tail, model)
    window_attention(q, k, v, adj, **kw).backward(do)
    direct = window_attention_bwd(q.detach(), k.detach(), v.detach(), do, adj, **kw)
    if not all(torch.equal(t.grad, d) for t, d in zip((q, k, v), direct)):
        raise AssertionError("autograd gradients differ from a direct backward kernel call")
    units, tokens, head_dim = WINDOW_SHAPE[model]
    emit("backward", model=model, units=units, tokens=tokens, head_dim=head_dim,
         tolerance=BWD_TOL, max_abs_err=detail, autograd_equals_kernel=True)
    return errors


@contextmanager
def plain_attention_in_model():
    """Run HWGATE's and HGATE's attention through the plain version of the
    fused kernel instead of the kernel."""
    from sl_hwgat_tpu_torch.models import hwgate
    from sl_hwgat_tpu_torch.ops.window_attention import plain_window_attention

    kernel = hwgate.window_attention
    hwgate.window_attention = plain_window_attention
    try:
        yield
    finally:
        hwgate.window_attention = kernel


def flagship(compute_dtype: str, **overrides):
    from sl_hwgat_tpu_torch.constants import DATASET_PARAMS
    from sl_hwgat_tpu_torch.models import build_model

    return build_model("HWGATE", DATASET_PARAMS["FDMSE-ISL"], 2, device="cuda", seed=SEED,
                       compute_dtype=compute_dtype, **overrides)


def eval_batch(batch: int = 16):
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    return torch.rand(batch, 192, 64, 2, generator=g, device="cuda")


def phase_forward():
    import torch

    from sl_hwgat_tpu_torch.ops.window_attention import window_attention

    x = eval_batch()
    out = {}
    for cdt in ("float32", "bfloat16"):
        model = flagship(cdt)
        with torch.inference_mode():
            before = window_attention.launches
            got = model(x)
            torch.cuda.synchronize()
            launches = window_attention.launches - before
            with plain_attention_in_model():
                want = model(x)
            torch.cuda.synchronize()
        if launches != 8:
            raise AssertionError(f"{cdt} forward launched the kernel {launches} times, not 8")
        if got.shape != (16, 2002) or not torch.isfinite(got).all():
            raise AssertionError(f"{cdt} logits: shape {tuple(got.shape)} or non-finite values")
        torch.testing.assert_close(got, want, **LOGIT_TOL[cdt])
        out[cdt] = {"max_abs_diff": (got - want).abs().max().item(),
                    "launches_per_forward": launches}
    emit("forward", batch=16, frames=192, classes=2002, tolerance=LOGIT_TOL, results=out)


def burst(pred, clips):
    """Submit ``clips`` from 4 client threads through a BatchingQueue; returns
    (rows, queue stats, seconds)."""
    from sl_hwgat_tpu_torch.serve import BatchingQueue

    t0 = time.perf_counter()
    q = BatchingQueue(pred, max_batch=16, max_wait_ms=5.0)
    futures: list = [None] * len(clips)

    def client(ids):
        for i in ids:
            futures[i] = q.submit(clips[i])

    threads = [threading.Thread(target=client, args=(range(c, len(clips), 4),)) for c in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        if t.is_alive():
            raise AssertionError("a client thread did not finish")
    rows = [f.result(timeout=600) for f in futures]
    q.close()
    return rows, q.stats, time.perf_counter() - t0


def phase_serve(workdir: Path):
    import numpy as np
    import torch

    from sl_hwgat_tpu_torch.ops.window_attention import window_attention
    from sl_hwgat_tpu_torch.serve import Predictor
    from sl_hwgat_tpu_torch.weights import save_state_dict

    ckpt = workdir / "hwgate_fdmse_isl.pt"
    save_state_dict(str(ckpt), flagship("float32"))
    rng = np.random.default_rng(SEED)
    clips = [rng.random((int(f), 543, 4)).astype(np.float32)
             for f in rng.integers(96, 385, size=48)]
    t0 = time.perf_counter()
    pred = Predictor.from_checkpoint(str(ckpt), model_type="HWGATE", dataset="FDMSE-ISL")
    pred.warmup(clips[0])
    setup_s = time.perf_counter() - t0

    window_attention.launches = 0
    rows, stats, serve_s = burst(pred, clips)
    launches = window_attention.launches

    if launches != 8 * stats["batches"]:
        raise AssertionError(f"{launches} launches for {stats['batches']} batches")
    errs = []
    for clip, row in zip(clips, rows):
        want = pred.predict_logits([clip])[0]
        errs.append(float(np.abs(row - want).max()))
        if not (row.shape == (2002,) and np.isfinite(row).all() and errs[-1] <= 2e-4):
            raise AssertionError(f"served row differs from predict_logits by {errs[-1]}")
    pred.close()
    emit("serve", requests=stats["requests"], batches=stats["batches"],
         batch_sizes=stats["batch_sizes"], launches=launches, max_abs_err=max(errs),
         setup_s=setup_s, serve_s=serve_s, clips_per_s=len(clips) / serve_s)
    torch.cuda.synchronize()
    return launches


def train_batch(batch: int = 16):
    """A seeded FDMSE-ISL train batch (x, y, valid) on the card."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    x = torch.rand(batch, 192, 64, 2, generator=g, device="cuda")
    y = torch.randint(0, 2002, (batch,), generator=g, device="cuda")
    return x, y, torch.ones(batch, device="cuda")


def one_step_grads(model, x, y, valid, seed: int):
    """(loss, {name: grad}) of one train-mode forward/backward."""
    import torch

    from sl_hwgat_tpu_torch.train.losses import per_sample, smoothed_cross_entropy

    model.train()
    model.zero_grad(set_to_none=True)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    logits = model(x, gen)
    loss = torch.sum(per_sample(smoothed_cross_entropy, logits, y) * valid) / valid.sum()
    loss.backward()
    return loss.item(), {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def grad_errors(case: str, cdt: str, grads: dict, plain: dict, zero_ok: str | None = None
                ) -> dict:
    """Per parameter, the gradient through the kernels against the plain
    path's: max abs error (f32) or ‖g − g′‖/‖g′‖ (bf16), each held to its bar;
    every gradient through the kernels must be nonzero, but those whose names
    match ``zero_ok`` (gradients that are zero in exact arithmetic)."""
    zero = [k for k, g in grads.items() if not (g.abs().max().item() > 0)
            and not (zero_ok and re.search(zero_ok, k))]
    if zero:
        raise AssertionError(f"{case}: zero gradients through the kernels: {zero}")
    worst = {}
    for k, g in grads.items():
        w = plain[k]
        if cdt == "float32":
            worst[k] = (g - w).abs().max().item()
            ok = worst[k] <= GRAD_ATOL_F32
        else:
            worst[k] = ((g - w).norm() / w.norm()).item()
            ok = worst[k] <= GRAD_REL_BF16
        if not ok:
            raise AssertionError(f"{case} gradient of {k}: kernels vs plain {worst[k]}")
    return worst


def phase_train():
    import torch

    from sl_hwgat_tpu_torch.ops.window_attention import window_attention, window_attention_bwd
    from sl_hwgat_tpu_torch.train.loop import make_steps, step_seed
    from sl_hwgat_tpu_torch.train.state import make_optimizer

    x, y, valid = train_batch()
    out = {}
    for cdt in ("float32", "bfloat16"):
        # one step, kernels against plain attention: dropout 0, one prune generator
        model = flagship(cdt, drop_rate=0.0)
        fwd0, bwd0 = window_attention.launches, window_attention_bwd.launches
        loss, grads = one_step_grads(model, x, y, valid, seed=SEED)
        torch.cuda.synchronize()
        launches = (window_attention.launches - fwd0, window_attention_bwd.launches - bwd0)
        if launches != (8, 8):
            raise AssertionError(f"{cdt} step launched (fwd, bwd) = {launches}, not (8, 8)")
        with plain_attention_in_model():
            plain_loss, plain = one_step_grads(model, x, y, valid, seed=SEED)
        qkv = [k for k in grads if k.endswith("attn.qkv.weight")]
        worst = grad_errors(cdt, cdt, grads, plain)
        del grads, plain

        # ten AdamW steps on one batch, dropout and pruning on
        model = flagship(cdt)
        opt = make_optimizer("adamw", LR, model.parameters())
        train_step, _ = make_steps(model, opt)
        losses = [train_step(x, y, valid, SEED, 0, step)[0].item() for step in range(10)]
        if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"{cdt} AdamW losses: {losses}")
        # a step's train-mode randomness repeats from its seed
        model.train()
        with torch.no_grad():
            a, b = (model(x, torch.Generator(device="cuda").manual_seed(step_seed(SEED, 0, 3)))
                    for _ in range(2))
        if not torch.equal(a, b):
            raise AssertionError(f"{cdt}: the same step seed gave different logits")
        out[cdt] = {"loss_kernels": loss, "loss_plain": plain_loss,
                    "launches_per_step": {"fwd": launches[0], "bwd": launches[1]},
                    "grad_err_worst": max(worst.values()),
                    "grad_err_worst_param": max(worst, key=worst.get),
                    "grad_err_metric": "max abs" if cdt == "float32" else "rel norm",
                    "qkv_weight_grads_nonzero": len(qkv), "adamw_losses": losses}
        del model, opt
        torch.cuda.empty_cache()
    emit("train", batch=16, frames=192, classes=2002, lr=LR,
         tolerance={"float32": GRAD_ATOL_F32, "bfloat16": GRAD_REL_BF16}, results=out)


def phase_synth(workdir: Path):
    """Main path 2: SYNTH through the loader, train_epoch and evaluate."""
    import numpy as np
    import torch

    from sl_hwgat_tpu_torch import configs
    from sl_hwgat_tpu_torch.constants import DATASET_PARAMS
    from sl_hwgat_tpu_torch.data.dataset import KeypointDataset, Loader, load_artifacts
    from sl_hwgat_tpu_torch.data.synthetic import write_synthetic_dataset
    from sl_hwgat_tpu_torch.models import build_model
    from sl_hwgat_tpu_torch.ops.window_attention import window_attention, window_attention_bwd
    from sl_hwgat_tpu_torch.train.loop import evaluate, make_steps, train_epoch
    from sl_hwgat_tpu_torch.train.state import (
        TrainState,
        cosine_annealing_lr,
        make_optimizer,
        set_lr,
    )

    ds = DATASET_PARAMS["SYNTH"]
    write_synthetic_dataset(str(workdir), seed=SEED)
    splits, classes, data_map = load_artifacts(str(workdir), "SYNTH")
    train = Loader(KeypointDataset(splits["train"], data_map, classes,
                                   configs.build_train_transform(ds["src_len"]), seed=SEED),
                   16, shuffle=True, num_workers=4, seed=SEED)
    val = Loader(KeypointDataset(splits["val"], data_map, classes,
                                 configs.build_eval_transform(ds["src_len"]), seed=SEED),
                 16, num_workers=4, seed=SEED)
    model = build_model("HWGATE", ds, 2, device="cuda", seed=SEED)
    opt = make_optimizer("adamw", LR, model.parameters())
    state = TrainState(model, opt)
    train_step, eval_step = make_steps(model, opt)

    window_attention.launches = window_attention_bwd.launches = 0
    t0 = time.perf_counter()
    try:
        epochs = []
        for epoch in (0, 1):
            set_lr(opt, cosine_annealing_lr(epoch, LR))
            epochs.append(train_epoch(train_step, state, train, SEED, epoch))
        val_loss, val_acc = evaluate(eval_step, state, val, k=5)
    finally:
        train.close()
        val.close()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"fwd": window_attention.launches, "bwd": window_attention_bwd.launches}

    steps = 2 * len(train)
    if launches != {"fwd": 8 * (steps + len(val)), "bwd": 8 * steps}:
        raise AssertionError(f"SYNTH: launches {launches} for {steps} train and "
                             f"{len(val)} eval steps")
    if not all(np.isfinite([*(e[0] for e in epochs), val_loss])):
        raise AssertionError(f"SYNTH: non-finite losses {epochs}, {val_loss}")
    emit("synth", train_clips=len(train.dataset), batch=16, train_steps=steps,
         eval_steps=len(val), launches=launches,
         epochs=[{"loss": e[0], "acc": e[1]} for e in epochs],
         val_loss=val_loss, val_top5=val_acc, seconds=seconds)
    return launches


# ---------------------------------------------------------------------------
# The command line (phase 8b): train, load and test through cli.run.

CLI_TAG = "smoke"


# The CLI's speed runs: clips written by data/synthetic.py under the
# FDMSE-ISL name, so the run has that dataset's shapes (192 frames, the
# 2002-class head); cut to 64 train, 16 val and 16 test clips, since the
# train transform (HandCorrection's splines) takes tens of host ms a clip.
SPEED_DATASET = "FDMSE-ISL"
SPEED_CLIPS_PER_CLASS = 6  # 4 train, 1 val, 1 test for each of 16 classes
SPEED_EPOCHS = 1  # --epochs 1: epochs 0-1, the last one warm


def cli_config(workdir: Path, mode: str, epochs: int, time_tag: str = CLI_TAG,
               dataset: str = "SYNTH", n_workers: int = 4, **overrides):
    """A RunConfig of ``dataset`` at full width, batch 16, under ``workdir``."""
    from sl_hwgat_tpu_torch.configs import RunConfig

    cfg = RunConfig(dataset=dataset, model_type="HWGATE", mode=mode, time=time_tag,
                    input_root=str(workdir / "input"), output_root=str(workdir / "output"),
                    device="cuda")
    cfg.epochs, cfg.batch_size, cfg.n_workers = epochs, 16, n_workers
    cfg.overrides = dict(overrides)
    return cfg


class WaitTimedLoader:
    """A loader whose ``epoch`` iterator adds the host seconds spent waiting
    for each batch (the transforms not yet done) to ``wait``."""

    def __init__(self, inner):
        self.inner, self.dataset, self.wait = inner, inner.dataset, 0.0

    def epoch(self, epoch: int = 0):
        batches = self.inner.epoch(epoch)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            self.wait += time.perf_counter() - t0
            if batch is None:
                return
            yield batch


@contextmanager
def timed_train_epochs(record: list, run: str):
    """Record each train epoch's seconds, clips and loader wait under ``run``
    while the block runs (run_epochs calls loop.train_epoch by name)."""
    import torch

    from sl_hwgat_tpu_torch.train import loop

    inner = loop.train_epoch

    def timed(train_step, state, loader, seed, epoch):
        waited = WaitTimedLoader(loader)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(train_step, state, waited, seed, epoch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        record.append({"run": run, "epoch": epoch, "seconds": seconds,
                       "loader_wait_s": waited.wait, "clips": len(loader.dataset),
                       "clips_per_s": len(loader.dataset) / seconds})
        return out

    loop.train_epoch = timed
    try:
        yield
    finally:
        loop.train_epoch = inner


def cli_run(cfg, expect_train_steps: int, expect_eval_batches: int, per_step_fwd: int = 8):
    """cli.run(cfg) with the launch counts set to 0 just before and read just
    after; they must be exact."""
    import torch

    from sl_hwgat_tpu_torch import cli
    from sl_hwgat_tpu_torch.ops.window_attention import window_attention, window_attention_bwd

    mode = cfg.mode  # run() ends in test mode
    window_attention.launches = window_attention_bwd.launches = 0
    t0 = time.perf_counter()
    results, state = cli.run(cfg, progress=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"fwd": window_attention.launches, "bwd": window_attention_bwd.launches}
    want = {"fwd": per_step_fwd * expect_train_steps + 8 * expect_eval_batches,
            "bwd": 8 * expect_train_steps}
    if launches != want:
        raise AssertionError(f"cli {mode}: launches {launches}, expected {want} for "
                             f"{expect_train_steps} train steps and {expect_eval_batches} "
                             "eval batches")
    for split, (loss, acc) in results.items():
        if not (math.isfinite(loss) and 0.0 <= acc <= 1.0):
            raise AssertionError(f"cli {mode}: {split} loss {loss}, accuracy {acc}")
    return results, state, launches, seconds


def table_agrees(rows: list, results: dict) -> bool:
    """Whether show_final_result's two rows print ``results``: each printed
    number within its last decimal's rounding (5e-5) of cli.run's value."""
    if len(rows) != 2 or not (rows[0].startswith("train acc") and rows[1].startswith("train loss")):
        return False
    printed = [[float(w) for w in row.replace("|", " ").split()[2::3]] for row in rows]
    want = [[results[s][1] for s in ("train", "val", "test")],
            [results[s][0] for s in ("train", "val", "test")]]
    return all(abs(p - v) <= 5e-5 + 1e-6 for pr, wr in zip(printed, want)
               for p, v in zip(pr, wr))


def write_speed_dataset(root: Path) -> None:
    """SPEED_DATASET's files: synthetic clips of 120-260 frames (resampled to
    192), and a class map of the dataset's 2002 classes for the confusion
    CSV."""
    from sl_hwgat_tpu_torch.constants import DATASET_PARAMS
    from sl_hwgat_tpu_torch.data.synthetic import write_synthetic_dataset

    write_synthetic_dataset(str(root), SPEED_DATASET, clips_per_class=SPEED_CLIPS_PER_CLASS,
                            frames=(120, 260), seed=SEED)
    with open(root / SPEED_DATASET / f"class_map_{SPEED_DATASET}.csv", "w", newline="") as f:
        f.write("class,word\n" + "".join(
            f"{c},word{c}\n" for c in range(DATASET_PARAMS[SPEED_DATASET]["num_class"])))


def phase_cli(workdir: Path, repo: Path) -> dict:
    """Main path 12: the port's command line on SYNTH at full width, batch 16:
    cli.run train (2 epochs), load (one more), test -k 5, then main_torch.py
    -m test as a process; the best checkpoint served through Predictor;
    two-epoch runs with and without --remat (f32, bf16) on SPEED_DATASET's
    shapes, and one --attn-dtype bfloat16 step. Returns the launches of the
    three first cli.run calls."""
    import torch

    from sl_hwgat_tpu_torch.data.dataset import get_loaders, load_artifacts
    from sl_hwgat_tpu_torch.data.synthetic import write_synthetic_dataset
    from sl_hwgat_tpu_torch.ops.window_attention import window_attention, window_attention_bwd
    from sl_hwgat_tpu_torch.serve import Predictor
    from sl_hwgat_tpu_torch.train.checkpoint import read_checkpoint
    from sl_hwgat_tpu_torch.train.loop import init_state, make_steps

    write_synthetic_dataset(str(workdir / "input"), seed=SEED)
    splits, _, _ = load_artifacts(str(workdir / "input"), "SYNTH")
    batches = {k: -(-len(v) // 16) for k, v in splits.items()}
    # per epoch: the train steps and one pass over val; at the end: train,
    # val and test once each, and test again for the confusion CSV
    final = batches["train"] + batches["val"] + 2 * batches["test"]
    epochs_timed: list = []
    out, total = {}, {"fwd": 0, "bwd": 0}

    # 1. train (--epochs 1: epochs 0 and 1), load (--epochs 2), test -k 5
    cfg = cli_config(workdir, "train", 1)
    with timed_train_epochs(epochs_timed, "train"):
        _, state, launches, seconds = cli_run(cfg, 2 * batches["train"],
                                              2 * batches["val"] + final)
    out["train"] = {"launches": launches, "seconds": seconds, "history": state.history}
    best = f"{cfg.save_model_path}_best_loss.ckpt"
    start = read_checkpoint(best)["epoch"] + 1
    cfg = cli_config(workdir, "load", 2)
    with timed_train_epochs(epochs_timed, "load"):
        _, state, launches, seconds = cli_run(cfg, (3 - start) * batches["train"],
                                              (3 - start) * batches["val"] + final)
    history = state.history
    if any(len(v) != 3 for v in history.values()):
        raise AssertionError(f"cli load: history {history}, not 3 epochs")
    out["load"] = {"launches": launches, "seconds": seconds, "resumed_at": start,
                   "history": state.history}
    for run_launches in (out["train"]["launches"], launches):
        for kind in total:
            total[kind] += run_launches[kind]
    cfg = cli_config(workdir, "test", 2)
    cfg.topk = 5
    results, state, launches, seconds = cli_run(cfg, 0, final)
    for kind in total:
        total[kind] += launches[kind]
    out["test"] = {"launches": launches, "seconds": seconds, "results": results}
    folder = Path(cfg.out_folder)
    names = sorted(p.name for p in folder.iterdir())
    need = {"model_best_loss.ckpt", "loss_curve.png", "acc_curve.png", "cm_list_w.csv",
            "config.pkl", "hwgate.py", "configs.py", "transforms.py"}
    if max(history["val_acc"]) > 0:  # the best-acc trigger fired
        need.add("model_best_acc.ckpt")
    if not need <= set(names):
        raise AssertionError(f"cli artifacts: {names}, missing {sorted(need - set(names))}")
    out["artifacts"] = names

    # the best checkpoint served: Predictor's logits are cli.run's
    loaders = get_loaders(cfg, cfg.eval_transform(), cfg.eval_transform())
    try:
        x = torch.from_numpy(next(iter(loaders[2].epoch(0)))[0]).cuda()
    finally:
        for loader in loaders:
            loader.close()
    pred = Predictor.from_checkpoint(best, model_type="HWGATE", dataset="SYNTH")
    with torch.no_grad():
        served, want = pred.forward(x.cpu().numpy()), state.model.eval()(x)
    torch.testing.assert_close(served, want, **LOGIT_TOL["float32"])
    out["served_max_abs_diff"] = (served - want).abs().max().item()
    pred.close()

    # 2. main_torch.py -m test as its own process
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(repo / "main_torch.py"), "-m", "test", "-d",
                           "SYNTH", "--model", "HWGATE", "-t", CLI_TAG, "-px", "best_loss",
                           "-k", "5"], cwd=workdir, capture_output=True, text=True,
                          timeout=600)
    lines = proc.stdout.splitlines()
    table = [i for i, ln in enumerate(lines) if ln == "=" * 89]
    if (proc.returncode != 0 or len(table) != 2 or any("[cli] no checkpoint" in ln for ln in lines)
            or not table_agrees(lines[table[0] + 1:table[1]], results)):
        raise AssertionError(f"main_torch.py -m test: rc {proc.returncode}, table against "
                             f"cli.run's results {results}\n{proc.stdout[-2000:]}"
                             f"\n{proc.stderr[-3000:]}")
    out["main_torch"] = {"rc": proc.returncode, "seconds": time.perf_counter() - t0,
                         "table": lines[table[0]:table[1] + 1]}

    # 3. --remat: SPEED_EPOCHS + 1 epochs through cli.run on SPEED_DATASET's
    # shapes (K1 twice per train step) in turns with the same run without it,
    # f32 and bf16, with the CLI's 8 loader workers, so the warm epochs
    # compare; and one step's gradients bit for bit those without remat, on a
    # SYNTH train batch
    write_speed_dataset(workdir / "input")
    speed_splits, _, _ = load_artifacts(str(workdir / "input"), SPEED_DATASET)
    speed = {k: -(-len(v) // 16) for k, v in speed_splits.items()}
    speed_final = speed["train"] + speed["val"] + 2 * speed["test"]
    tcfg = cli_config(workdir, "train", 0)
    loaders = get_loaders(tcfg, tcfg.train_transform(), tcfg.eval_transform())
    try:
        x, y, valid = next(iter(loaders[0].epoch(0)))
    finally:
        for loader in loaders:
            loader.close()
    x, valid = torch.from_numpy(x).cuda(), torch.from_numpy(valid).cuda()
    y = torch.from_numpy(y).long().cuda()
    out["remat"] = {}
    for cdt in ("float32", "bfloat16"):
        for remat in (False, True):
            run = f"{'remat' if remat else 'plain'}_{cdt}"
            rcfg = cli_config(workdir, "train", SPEED_EPOCHS, run, dataset=SPEED_DATASET,
                              n_workers=8, remat=remat, compute_dtype=cdt)
            with timed_train_epochs(epochs_timed, run):
                _, rstate, launches, seconds = cli_run(
                    rcfg, (SPEED_EPOCHS + 1) * speed["train"],
                    (SPEED_EPOCHS + 1) * speed["val"] + speed_final,
                    per_step_fwd=16 if remat else 8)
            out["remat"][run] = {"launches": launches, "seconds": seconds}
            del rstate
        model = init_state(cli_config(workdir, "train", 0, remat=True, compute_dtype=cdt)).model
        window_attention.launches = window_attention_bwd.launches = 0
        loss, grads = one_step_grads(model, x, y, valid, seed=SEED)
        torch.cuda.synchronize()
        step = (window_attention.launches, window_attention_bwd.launches)
        if step != (16, 8):
            raise AssertionError(f"remat {cdt} step launched (fwd, bwd) = {step}, not (16, 8)")
        model.remat = False
        plain_loss, plain = one_step_grads(model, x, y, valid, seed=SEED)
        differ = [k for k in grads if not torch.equal(grads[k], plain[k])]
        if loss != plain_loss or differ:
            raise AssertionError(f"remat {cdt}: loss {loss} vs {plain_loss}, gradients "
                                 f"not bit for bit: {differ[:5]}")
        out["remat"][f"remat_{cdt}"].update(step_launches={"fwd": step[0], "bwd": step[1]},
                                            grads_bit_for_bit=len(grads), loss=loss)
        del model, grads, plain
        torch.cuda.empty_cache()

    # 4. --attn-dtype bfloat16: one step, kernels against the plain attention
    acfg = cli_config(workdir, "train", 0, "attn_bf16", attn_dtype="bfloat16", drop_rate=0.0)
    model = init_state(acfg).model
    window_attention.launches = window_attention_bwd.launches = 0
    loss, grads = one_step_grads(model, x, y, valid, seed=SEED)
    torch.cuda.synchronize()
    step = (window_attention.launches, window_attention_bwd.launches)
    if step != (8, 8) or not math.isfinite(loss):
        raise AssertionError(f"attn bf16 step: launches {step}, loss {loss}")
    with plain_attention_in_model():
        plain_loss, plain = one_step_grads(model, x, y, valid, seed=SEED)
    worst = grad_errors("attn_dtype bf16", "bfloat16", grads, plain)
    out["attn_bf16"] = {"loss": loss, "plain_loss": plain_loss, "step_launches": list(step),
                        "grad_err_worst": max(worst.values()), "grad_err_metric": "rel norm"}
    del model, grads, plain
    torch.cuda.empty_cache()

    emit("cli", batch=16, dataset="SYNTH", batches=batches, launches=total, results=out)
    warm = {}
    for run in out["remat"]:
        epochs = [e for e in epochs_timed if e["run"] == run and e["epoch"] > 0]
        seconds = sorted(e["seconds"] for e in epochs)
        warm[run] = {"median_s": statistics.median(seconds), "min_s": seconds[0],
                     "max_s": seconds[-1], "samples": len(seconds),
                     "loader_wait_share": sum(e["loader_wait_s"] for e in epochs) / sum(seconds),
                     "train_clips_per_s": len(speed_splits["train"]) / statistics.median(seconds)}
    emit("cli_speed", nvidia_smi=nvidia_smi(), dataset=SPEED_DATASET, batch=16,
         train_clips=len(speed_splits["train"]), loader_workers=8, train_epochs=epochs_timed,
         warm_epochs=warm)
    return total


# ---------------------------------------------------------------------------
# The reference's baselines, STGCN, DecoupledGCN and Transformer (phases 8c,
# 8d), and the step and serving benches (phase 20).

BASELINES = ("STGCN", "DecoupledGCN", "Transformer")
F32_ONLY = ("STGCN", "DecoupledGCN")  # no compute_dtype, as in the JAX package
# the JAX package's bar of bf16 compute against f32 (tests/test_transformer_parity.py:40)
BF16_SHARE = 0.15


def baseline_model(name: str, compute_dtype: str = "float32", device: str = "cuda"):
    from sl_hwgat_tpu_torch.constants import DATASET_PARAMS
    from sl_hwgat_tpu_torch.models import build_model

    overrides = {} if compute_dtype == "float32" else {"compute_dtype": compute_dtype}
    return build_model(name, DATASET_PARAMS["FDMSE-ISL"], 2, device=device, seed=SEED,
                       **overrides)


def model_path_kernels() -> dict:
    """The models' kernel wrappers by name, each a function with a
    ``launches`` count."""
    from sl_hwgat_tpu_torch.ops import banded_attention, hybrid_attention, window_attention

    return {"window_attention": window_attention.window_attention,
            "window_attention_bwd": window_attention.window_attention_bwd,
            "banded_attention": banded_attention.banded_attention,
            "banded_attention_bwd": banded_attention.banded_attention_bwd,
            "masked_softmax": hybrid_attention.masked_softmax,
            "masked_softmax_bwd": hybrid_attention.masked_softmax_bwd}


def kernel_launches() -> dict:
    return {name: fn.launches for name, fn in model_path_kernels().items()}


def calibrate_batch_norm(model, x) -> None:
    """Set every BatchNorm's running statistics to those of one train-mode
    forward of ``x`` (momentum None for it: a cumulative average over one
    batch), as a trained model's would be. With the init statistics (0, 1)
    DecoupledGCN's eval logits reach 4.8e4 at FDMSE-ISL (on an H100), where
    f32 on the card and on the CPU each sit about 0.05 from float64 (4e-7 to
    9e-7 of the logits' norm), past any absolute bar."""
    import torch

    norms = [m for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    for m in norms:
        m.reset_running_stats()
        m.momentum = None
    with torch.no_grad():
        model.train()(x, torch.Generator(device=x.device).manual_seed(SEED))
    for m in norms:
        m.momentum = 0.1
    model.eval()


def phase_baselines() -> dict:
    """Phase 8c: STGCN, DecoupledGCN and Transformer at FDMSE-ISL (192 frames,
    2002 classes, 29 joints), batch 16, random weights from SEED (the GCNs'
    BatchNorm statistics calibrated on the batch: ``calibrate_batch_norm``):
    eval logits on the card against the same weights on the CPU (f32, the
    logit bar), one bf16 eval forward of the Transformer against its f32
    logits (the JAX package's bf16 bar: within 0.15 of the largest logit),
    and 3 AdamW steps through make_steps with finite losses and every
    BatchNorm running statistic moved. None of them launches a kernel of
    the port."""
    import torch

    from sl_hwgat_tpu_torch.train.loop import make_steps
    from sl_hwgat_tpu_torch.train.state import make_optimizer

    out = {}
    reset_launches(*model_path_kernels().values())
    for name in BASELINES:
        x = banded_batch(name)
        model = baseline_model(name)
        if name in F32_ONLY:
            calibrate_batch_norm(model, x)
        cpu = baseline_model(name, device="cpu")
        cpu.load_state_dict(model.state_dict())
        with torch.no_grad():
            got, want = model(x).cpu(), cpu(x.cpu())
        torch.testing.assert_close(got, want, **LOGIT_TOL["float32"])
        rec = {"card_vs_cpu_max_abs_err": (got - want).abs().max().item(),
               "max_abs_logit": want.abs().max().item()}
        del cpu
        if name not in F32_ONLY:
            bf16 = baseline_model(name, "bfloat16")
            bf16.load_state_dict(model.state_dict())
            with torch.no_grad():
                low = bf16(x).float().cpu()
            err = (low - got).abs().max().item()
            if not (torch.isfinite(low).all() and err < BF16_SHARE * (got.abs().max().item()
                                                                    + 1e-3)):
                raise AssertionError(f"{name} bf16 logits {err} from f32")
            rec["bf16_vs_f32_max_abs_err"] = err
            del bf16
        xt, yt, valid = banded_batch(name, train=True)
        stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
        train_step, _ = make_steps(model, make_optimizer("adamw", LR, model.parameters()))
        losses = [float(train_step(xt, yt, valid, SEED, 0, step)[0]) for step in range(3)]
        still = [k for k, v in stats.items() if torch.equal(v, model.state_dict()[k])]
        if not all(math.isfinite(v) for v in losses) or still:
            raise AssertionError(f"{name} train: losses {losses}, statistics that did not "
                                 f"move: {still[:5]}")
        rec.update(train_losses=losses, running_stats_moved=len(stats))
        out[name] = rec
        del model, train_step
        torch.cuda.empty_cache()
    launches = kernel_launches()
    if any(launches.values()):
        raise AssertionError(f"the baselines launched kernels of the port: {launches}")
    emit("baselines", batch=16, dataset="FDMSE-ISL", results=out)
    return out


def phase_cli_baselines(workdir: Path) -> dict:
    """Phase 8d: for each baseline, cli.run on SYNTH at full width, batch 16:
    train (--epochs 1: two epochs; STGCN with the nadam optimizer), then
    test -px best_loss -k 5 in a run of its own, whose results equal the
    train run's final test (the same checkpoint, eval mode)."""
    from sl_hwgat_tpu_torch import cli
    from sl_hwgat_tpu_torch.configs import RunConfig
    from sl_hwgat_tpu_torch.data.synthetic import write_synthetic_dataset
    from sl_hwgat_tpu_torch.train.checkpoint import read_checkpoint

    write_synthetic_dataset(str(workdir / "input"), seed=SEED)
    out = {}
    for name in BASELINES:
        optimizer = "nadam" if name == "STGCN" else "adamw"

        def config(mode):
            cfg = RunConfig(dataset="SYNTH", model_type=name, mode=mode, time=CLI_TAG,
                            input_root=str(workdir / "input"),
                            output_root=str(workdir / "output"), device="cuda")
            cfg.epochs, cfg.batch_size, cfg.n_workers = 1, 16, 4
            cfg.optimizer_type = optimizer
            return cfg

        t0 = time.perf_counter()
        trained, state = cli.run(config("train"), progress=True)
        seconds = time.perf_counter() - t0
        cfg = config("test")
        cfg.postfix, cfg.topk = "best_loss", 5
        tested, _ = cli.run(cfg, progress=True)
        best = read_checkpoint(f"{cfg.save_model_path}_best_loss.ckpt")
        for split, (loss, acc) in tested.items():
            if not (math.isfinite(loss) and 0.0 <= acc <= 1.0):
                raise AssertionError(f"cli {name} test: {split} loss {loss}, accuracy {acc}")
        if len(state.history["train_loss"]) != 2 or "optimizer_state_dict" not in best:
            raise AssertionError(f"cli {name}: history {state.history}")
        out[name] = {"optimizer": optimizer, "train_seconds": seconds,
                     "history": state.history, "test_k5": tested, "train_k1": trained}
        del state
    emit("cli_baselines", dataset="SYNTH", batch=16, results=out)
    return out


# (model, dtype, extra flags) of the step bench, each run as train and eval;
# bf16 where the model has a compute_dtype
STEP_BENCH = (("HWGATE", "bf16", {}), ("HWGATE", "f32", {}),
              ("HWGATE", "bf16", {"attn_impl": "hybrid"}), ("HGATE", "bf16", {}),
              ("WGATE", "bf16", {}), ("GATE", "bf16", {}), ("Transformer", "bf16", {}),
              ("STGCN", "f32", {}), ("DecoupledGCN", "f32", {}))
STEP_REPEATS = 3


def finite_numbers(line: dict, keys) -> bool:
    return all(isinstance(line.get(k), (int, float)) and math.isfinite(line[k]) for k in keys)


def phase_step_bench(bench_steps: list, kernel_times: dict) -> dict:
    """Phase 20: bench.step's train and eval lines of every model (STEP_BENCH,
    --repeats 3) and bench.serve's line, each printed as it is and required
    to parse with finite numbers; bench.run's two HWGATE step lines (from
    phase 19's run) beside them. The launch counts are set to 0 just before
    and read just after the step benches. The attention's train/eval ratio
    of the roofline, (K1 + K2) / K1 at 32 tokens, is re-read from this run's
    card times."""
    import torch

    from sl_hwgat_tpu_torch.bench import serve as serve_bench
    from sl_hwgat_tpu_torch.bench import step as step_bench
    from sl_hwgat_tpu_torch.utils.profiling import ATTN_TRAIN_RATIO

    keys = ("time_us", "time_us_min", "time_us_max", "clips_per_sec", "card_ms")
    lines = []
    reset_launches(*model_path_kernels().values())
    for model, dtype, flags in STEP_BENCH:
        for step in ("train", "eval"):
            line = step_bench.measure(model, dtype, 16, step, STEP_REPEATS, "cuda", **flags)
            print(json.dumps(line), flush=True)
            if not finite_numbers(line, keys) or line["n_repeats"] != STEP_REPEATS:
                raise AssertionError(f"bench.step {model} {step} {dtype}: {line}")
            lines.append(line)
            torch.cuda.empty_cache()
    serve = serve_bench.measure()
    print(json.dumps(serve), flush=True)
    launches = kernel_launches()
    queue_keys = ("clips_per_sec_b16", "clips_per_sec_bmax", "queue_clips_per_sec",
                  "queue_p50_ms", "queue_p99_ms", "queue_speedup_vs_serial_b1")
    if (not finite_numbers(serve, queue_keys) or serve["queue_answered"] != 128
            or sum(serve["queue_batch_sizes"]) != 128
            or not all(math.isfinite(v) for v in serve["per_bucket_ms"].values())):
        raise AssertionError(f"bench.serve: {serve}")
    for line in bench_steps:
        if not finite_numbers(line, ("value", "vs_step_roofline", "roofline_clips_per_sec",
                                     "mfu")):
            raise AssertionError(f"bench.run step line: {line}")
    ratio = {}
    for dt in ("float32", "bfloat16"):
        k1, k2 = (kernel_times[kind][dt]["cases"]["single"]["device_ms"]
                  for kind in ("fwd", "bwd"))
        ratio[dt] = {"k1_card_ms": k1, "k2_card_ms": k2, "measured": (k1 + k2) / k1,
                     "roofline_constant": ATTN_TRAIN_RATIO[dt]}
    summary = {line["impl"] + "".join(f"/{v}" for k, v in line["overrides"].items()
                                      if k == "attn_impl"):
               {"clips_per_sec": line["clips_per_sec"], "host_ms": line["time_us"] / 1e3,
                "card_ms": line["card_ms"], "card_share": line["card_ms"] * 1e3 / line["time_us"]}
               for line in lines}
    emit("step_bench", nvidia_smi=nvidia_smi(), batch=16, repeats=STEP_REPEATS,
         summary=summary, launches=launches, bench_run_step_lines=bench_steps,
         attn_train_ratio=ratio,
         serve={k: serve[k] for k in ("per_bucket_ms", *queue_keys, "queue_batches")})
    return launches


# ---------------------------------------------------------------------------
# The banded models, WGATE and GATE (phases 9-12).

BANDED_MODELS = ("WGATE", "GATE")
# (planes, frames, joints) of one attention call at batch 16: WGATE's 16·4
# windows × 8 heads over 192 frames of 16 joints; GATE's 16 clips × 8 heads
# over 192 frames of 29 joints. dh = 128 / 8 = 16.
BANDED_SHAPE = {"WGATE": (512, 192, 16), "GATE": (128, 192, 29)}
BANDED_DH = 16
BANDED_SCALE = BANDED_DH**-0.5
NUM_KPS = {"WGATE": 64, "GATE": 29, "HWGATE": 64, "HGATE": 29, "STGCN": 29, "DecoupledGCN": 29,
           "Transformer": 29}


def banded_bands() -> dict:
    """{model: {"identity": the model's band (K8's case), "spatial": the
    spatial plane as prev/next too (K9's general case)}}."""
    import numpy as np

    from sl_hwgat_tpu_torch.graphs.adjacency import additive_mask, window_adj
    from sl_hwgat_tpu_torch.graphs.skeleton import BODY29_EDGES, edges_to_dense
    from sl_hwgat_tpu_torch.models.wgate import make_band

    spatial = {"WGATE": window_adj(window_size=16),
               "GATE": edges_to_dense(BODY29_EDGES, 29, self_loops=False)}
    return {m: {"identity": make_band(a), "spatial": np.stack([additive_mask(a)] * 3)}
            for m, a in spatial.items()}


def banded_inputs(model: str, dtype):
    """Seeded q, k, v, dO of one attention call of ``model`` on the card. v
    and dO at 0.2 scale: a probability that rounds to the other side of a
    bf16 step in the kernel and in the plain version (their f32 scores sum
    in different orders) moves dV by one step of A times dO, 2^-8·|dO|,
    which stays inside the 4e-3 bar only for |dO| < 1."""
    import torch

    planes, frames, joints = BANDED_SHAPE[model]
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    q, k, v, do = (torch.randn(planes, frames * joints, BANDED_DH, generator=g, device="cuda")
                   for _ in range(4))
    return q.to(dtype), k.to(dtype), (v * 0.2).to(dtype), (do * 0.2).to(dtype)


def banded_bwd_errors(case: str, got, want, dtype) -> dict:
    """{grad: max abs error} of the banded backward kernel's (dq, dk, dv)
    against the plain version's; raises where an entry is over BWD_TOL or a
    gradient is not in ``dtype``."""
    import torch

    torch.cuda.synchronize()
    tol = BWD_TOL[dtype_name(dtype)]
    errors = {}
    for grad, g_, w in zip(("dq", "dk", "dv"), got, want):
        diff = (g_.float() - w.float()).abs()
        excess = diff - tol["atol"] - tol["rtol"] * w.float().abs()
        errors[grad] = diff.max().item()
        if g_.dtype != dtype or not excess.max().item() <= 0:
            at = int(excess.argmax())
            raise AssertionError(
                f"banded backward vs plain {case} {grad}: max abs err {errors[grad]}, worst "
                f"excess at {at}: got {g_.flatten()[at].item()}, want {w.flatten()[at].item()}, "
                f"{int((excess > 0).sum())} entries over {tol}")
    return errors


def phase_banded():
    import torch

    from sl_hwgat_tpu_torch.ops.banded_attention import (
        banded_attention,
        banded_attention_bwd,
        plain_banded_attention,
        plain_banded_attention_bwd,
    )

    bands = banded_bands()
    fwd_errors, bwd_errors = {}, {}
    for model in BANDED_MODELS:
        for dtype in (torch.float32, torch.bfloat16):
            name = dtype_name(dtype)
            q, k, v, do = banded_inputs(model, dtype)
            for kind, band in bands[model].items():
                case = f"{model}/{kind}/{name}"
                got = banded_attention(q, k, v, band, scale=BANDED_SCALE)
                want = plain_banded_attention(q, k, v, band, scale=BANDED_SCALE)
                torch.cuda.synchronize()
                fwd_errors[case] = (got - want).abs().max().item()
                if not (got.dtype == torch.float32 and fwd_errors[case] <= TOL[name]):
                    raise AssertionError(f"banded kernel vs plain {case}: max abs err "
                                         f"{fwd_errors[case]} > {TOL[name]}")
                got = banded_attention_bwd(q, k, v, do, band, scale=BANDED_SCALE)
                want = plain_banded_attention_bwd(q, k, v, do, band, scale=BANDED_SCALE)
                bwd_errors[case] = banded_bwd_errors(case, got, want, dtype)
                # gather, no atomics: a second call gives the same bits
                again = banded_attention_bwd(q, k, v, do, band, scale=BANDED_SCALE)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"banded backward {case}: a second call differs")
                del got, want, again
            del q, k, v, do
            torch.cuda.empty_cache()
    # the autograd Function's gradients are the backward kernel's
    band = bands["GATE"]["identity"]
    q, k, v, do = banded_inputs("GATE", torch.float32)
    leaves = tuple(t.detach().requires_grad_() for t in (q, k, v))
    banded_attention(*leaves, band, scale=BANDED_SCALE).backward(do)
    direct = banded_attention_bwd(q, k, v, do, band, scale=BANDED_SCALE)
    if not all(torch.equal(t.grad, d) for t, d in zip(leaves, direct)):
        raise AssertionError("banded autograd gradients differ from a direct backward call")
    emit("banded", shapes={m: [*BANDED_SHAPE[m], BANDED_DH] for m in BANDED_MODELS},
         tolerance={"fwd": TOL, "bwd": BWD_TOL}, fwd_max_abs_err=fwd_errors,
         bwd_max_abs_err=bwd_errors, autograd_equals_kernel=True,
         bwd_repeats_bit_for_bit=True)
    return fwd_errors, {c: max(e.values()) for c, e in bwd_errors.items()}


@contextmanager
def plain_banded_in_models():
    """Run WGATE's and GATE's attention through the plain versions of both
    kernels: the plain forward, and as its gradient the plain backward, which
    rounds where the backward kernel rounds (torch autograd of the plain
    forward would not round dS to bf16)."""
    import torch

    from sl_hwgat_tpu_torch.models import wgate
    from sl_hwgat_tpu_torch.ops.banded_attention import (
        plain_banded_attention,
        plain_banded_attention_bwd,
    )

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, band, scale, out_dtype):
            ctx.save_for_backward(q, k, v)
            ctx.band, ctx.scale = band, scale
            return plain_banded_attention(q, k, v, band, scale=scale, out_dtype=out_dtype)

        @staticmethod
        def backward(ctx, do):
            grads = plain_banded_attention_bwd(*ctx.saved_tensors, do, ctx.band, scale=ctx.scale)
            return (*grads, None, None, None)

    kernel = wgate.banded_attention
    wgate.banded_attention = lambda q, k, v, band, *, scale, out_dtype=None: Plain.apply(
        q, k, v, band, scale, out_dtype)
    try:
        yield
    finally:
        wgate.banded_attention = kernel


def banded_model(name: str, compute_dtype: str, **overrides):
    from sl_hwgat_tpu_torch.constants import DATASET_PARAMS
    from sl_hwgat_tpu_torch.models import build_model

    return build_model(name, DATASET_PARAMS["FDMSE-ISL"], 2, device="cuda", seed=SEED,
                       compute_dtype=compute_dtype, **overrides)


def banded_batch(name: str, batch: int = 16, train: bool = False):
    """A seeded FDMSE-ISL batch of ``name``'s joints: x, or (x, y, valid)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + (3 if train else 1))
    x = torch.rand(batch, 192, NUM_KPS[name], 2, generator=g, device="cuda")
    if not train:
        return x
    y = torch.randint(0, 2002, (batch,), generator=g, device="cuda")
    return x, y, torch.ones(batch, device="cuda")


def phase_banded_forward():
    import torch

    from sl_hwgat_tpu_torch.ops.banded_attention import banded_attention

    out = {}
    for name in BANDED_MODELS:
        x = banded_batch(name)
        for cdt in ("float32", "bfloat16"):
            model = banded_model(name, cdt)
            with torch.inference_mode():
                before = banded_attention.launches
                got = model(x)
                torch.cuda.synchronize()
                launches = banded_attention.launches - before
                with plain_banded_in_models():
                    want = model(x)
                torch.cuda.synchronize()
            if launches != 8:
                raise AssertionError(f"{name} {cdt} forward launched {launches} times, not 8")
            if got.shape != (16, 2002) or not torch.isfinite(got).all():
                raise AssertionError(f"{name} {cdt} logits: shape {tuple(got.shape)} or "
                                     "non-finite values")
            torch.testing.assert_close(got, want, **LOGIT_TOL[cdt])
            out[f"{name}/{cdt}"] = {"max_abs_diff": (got - want).abs().max().item(),
                                    "launches_per_forward": launches}
            del model
    emit("banded_forward", batch=16, frames=192, classes=2002, tolerance=LOGIT_TOL,
         results=out)


def phase_banded_serve(workdir: Path) -> int:
    """Main path 3: serving WGATE and GATE; returns the forward launches."""
    import numpy as np
    import torch

    from sl_hwgat_tpu_torch.ops.banded_attention import banded_attention
    from sl_hwgat_tpu_torch.serve import Predictor
    from sl_hwgat_tpu_torch.weights import save_state_dict

    rng = np.random.default_rng(SEED + 1)
    clips = [rng.random((int(f), 543, 4)).astype(np.float32)
             for f in rng.integers(96, 385, size=24)]
    out, total = {}, 0
    for name in BANDED_MODELS:
        ckpt = workdir / f"{name.lower()}_fdmse_isl.pt"
        save_state_dict(str(ckpt), banded_model(name, "float32"))
        t0 = time.perf_counter()
        pred = Predictor.from_checkpoint(str(ckpt), model_type=name, dataset="FDMSE-ISL")
        pred.warmup(clips[0])
        setup_s = time.perf_counter() - t0

        banded_attention.launches = 0
        rows, stats, serve_s = burst(pred, clips)
        launches = banded_attention.launches

        if launches != 8 * stats["batches"]:
            raise AssertionError(f"{name}: {launches} launches for {stats['batches']} batches")
        errs = []
        for clip, row in zip(clips, rows):
            want = pred.predict_logits([clip])[0]
            errs.append(float(np.abs(row - want).max()))
            if not (row.shape == (2002,) and np.isfinite(row).all() and errs[-1] <= 2e-4):
                raise AssertionError(f"{name}: served row differs from predict_logits by "
                                     f"{errs[-1]}")
        kps = pred.preprocess(clips[0]).shape[1]
        if kps != NUM_KPS[name]:
            raise AssertionError(f"{name} served {kps}-joint clips")
        pred.close()
        out[name] = {"requests": stats["requests"], "batches": stats["batches"],
                     "batch_sizes": stats["batch_sizes"], "launches": launches,
                     "joints": kps, "max_abs_err": max(errs), "setup_s": setup_s,
                     "serve_s": serve_s, "clips_per_s": len(clips) / serve_s}
        total += launches
        del pred
        torch.cuda.empty_cache()
    emit("banded_serve", results=out)
    return total


def phase_banded_train() -> dict:
    """Gradients against the plain attention, then main path 4: ten AdamW
    steps per model and type. Returns the launches of the AdamW runs."""
    import torch

    from sl_hwgat_tpu_torch.ops.banded_attention import banded_attention, banded_attention_bwd
    from sl_hwgat_tpu_torch.train.loop import make_steps
    from sl_hwgat_tpu_torch.train.state import make_optimizer

    out, total = {}, {"fwd": 0, "bwd": 0}
    for name in BANDED_MODELS:
        x, y, valid = banded_batch(name, train=True)
        for cdt in ("float32", "bfloat16"):
            model = banded_model(name, cdt, drop_rate=0.0)
            fwd0, bwd0 = banded_attention.launches, banded_attention_bwd.launches
            loss, grads = one_step_grads(model, x, y, valid, seed=SEED)
            torch.cuda.synchronize()
            launches = (banded_attention.launches - fwd0, banded_attention_bwd.launches - bwd0)
            if launches != (8, 8):
                raise AssertionError(f"{name} {cdt} step launched (fwd, bwd) = {launches}")
            loss2, grads2 = one_step_grads(model, x, y, valid, seed=SEED)
            if loss2 != loss or not all(torch.equal(grads[k], grads2[k]) for k in grads):
                raise AssertionError(f"{name} {cdt}: a step does not repeat bit for bit")
            del grads2
            with plain_banded_in_models():
                plain_loss, plain = one_step_grads(model, x, y, valid, seed=SEED)
            worst = grad_errors(f"{name} {cdt}", cdt, grads, plain)
            del grads, plain, model

            model = banded_model(name, cdt)
            opt = make_optimizer("adamw", LR, model.parameters())
            train_step, _ = make_steps(model, opt)
            banded_attention.launches = banded_attention_bwd.launches = 0
            losses = [train_step(x, y, valid, SEED, 0, step)[0].item() for step in range(10)]
            torch.cuda.synchronize()
            run = {"fwd": banded_attention.launches, "bwd": banded_attention_bwd.launches}
            if run != {"fwd": 80, "bwd": 80}:
                raise AssertionError(f"{name} {cdt}: ten steps launched {run}")
            if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
                raise AssertionError(f"{name} {cdt} AdamW losses: {losses}")
            for kind in total:
                total[kind] += run[kind]
            out[f"{name}/{cdt}"] = {
                "loss_kernels": loss, "loss_plain": plain_loss,
                "launches_per_step": {"fwd": launches[0], "bwd": launches[1]},
                "step_repeats_bit_for_bit": True,
                "grad_err_worst": max(worst.values()),
                "grad_err_worst_param": max(worst, key=worst.get),
                "grad_err_metric": "max abs" if cdt == "float32" else "rel norm",
                "params_with_grad": len(worst), "adamw_losses": losses, "adamw_launches": run}
            del model, opt, train_step
            torch.cuda.empty_cache()
    emit("banded_train", batch=16, frames=192, classes=2002, lr=LR,
         tolerance={"float32": GRAD_ATOL_F32, "bfloat16": GRAD_REL_BF16}, results=out)
    return total


# ---------------------------------------------------------------------------
# The hybrid attention (K7) and HGATE (phases 14-17).

# (model, attn_impl) of the windowed paths this section drives: HWGATE's
# hybrid attention, and HGATE on its default (fused K1/K2 at 58 tokens) and
# hybrid paths.
WINDOWED_PATHS = (("HWGATE", "hybrid"), ("HGATE", "auto"), ("HGATE", "hybrid"))


def scores_of(q, k, scale: float):
    """The hybrid path's f32 scores (q·T(scale))·kᵀ of (U, N, dh) units."""
    import torch

    scaled = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    return torch.bmm(scaled.float(), k.float().transpose(1, 2))


def softmax_kwargs(kw: dict) -> dict:
    """The masked softmax's arguments out of the attention's."""
    return {k: v for k, v in kw.items() if k not in ("scale", "pad_tokens")}


def zero_quirk_flips(q, k, scale: float, units: list) -> dict:
    """{unit: [row, column, S of the bf16 products, S of the f32 GEMM,
    S in float64]} of ``units`` of bf16 q, k where the hybrid path's scores
    (bf16 products, f32 sums on the tensor cores) and the f32 GEMM's (the
    order K1 sums in) take different zero-quirk decisions and the hybrid's
    is float64's (S == 0 in both or in neither): a score that f32 rounding
    sends to exactly 0 in one order, masked there only. A unit without such
    an entry is left out."""
    import torch

    # the products over all units, as the attention calls them (cuBLAS picks
    # its kernel, hence its order of sums, by the batch), then the units
    idx = torch.tensor(units, device=q.device)
    scaled = q * torch.tensor(scale, dtype=q.dtype)
    kt = k.transpose(1, 2)
    s_hybrid = torch.bmm(scaled, kt, out_dtype=torch.float32)[idx]
    s_gemm = torch.bmm(scaled.float(), kt.float())[idx]
    s64 = torch.bmm(scaled[idx].double(), kt[idx].double())
    flip = ((s_hybrid == 0) != (s_gemm == 0)) & ((s_hybrid == 0) == (s64 == 0))
    out = {}
    for i, r, c in flip.nonzero().tolist():
        out.setdefault(units[i], []).append(
            [r, c, s_hybrid[i, r, c].item(), s_gemm[i, r, c].item(), s64[i, r, c].item()])
    return out


def float64_scores_attention(q, k, v, adj, kw: dict):
    """The hybrid attention's function with its scores taken in float64 (and
    then to f32, as the masked softmax reads them; a nonzero float64 score
    stays nonzero) and P stored in v's type, O = P·V in float64: the
    reference a unit is held to where its zero-quirk decision flips."""
    import torch

    from sl_hwgat_tpu_torch.ops.hybrid_attention import plain_masked_softmax

    scaled = q * torch.tensor(kw["scale"], dtype=q.dtype)
    s64 = torch.bmm(scaled.double(), k.double().transpose(1, 2))
    p = plain_masked_softmax(s64.float(), adj, p_dtype=v.dtype, **softmax_kwargs(kw))
    return torch.bmm(p.double(), v.double())


# the units that phase 13 may pass on a zero-quirk flip, over all its cases:
# one HWGATE unit of its bf16 draw has such a score (PERF.md §7)
MAX_ZERO_QUIRK_UNITS = 1


def exempted_units(flips: dict) -> int:
    """The distinct units of ``flips`` ({case: {"units": {unit: ...}}}):
    one flipped score counts once, whichever mask cases it shows in."""
    return len({u for f in flips.values() for u in f["units"]})


def phase_masked_softmax():
    """K7 forward and backward against their plain versions at HWGATE's
    (12288 × 32 × 32) and HGATE's (3072 × 58 × 58) scores, and the hybrid
    attention through K7 against the fused kernel K1 (one function), unit
    by unit. On bf16 inputs the hybrid's scores are bf16 products summed
    on the tensor cores, K1's the f32 GEMM's order: a unit over the bar
    passes only where ``zero_quirk_flips`` finds a score that one order
    rounds to exactly 0 and float64 takes the hybrid's side, and the unit
    is within the bar of ``float64_scores_attention``; at most
    ``MAX_ZERO_QUIRK_UNITS`` distinct units over all cases may pass so."""
    import torch

    from sl_hwgat_tpu_torch.ops.hybrid_attention import (
        hybrid_window_attention,
        masked_softmax,
        masked_softmax_bwd,
        plain_masked_softmax,
        plain_masked_softmax_bwd,
    )
    from sl_hwgat_tpu_torch.ops.window_attention import window_attention

    fwd_err, bwd_err, hybrid_err, hybrid_flips = {}, {}, {}, {}
    for model in ("HWGATE", "HGATE"):
        adj, tail = masks(model)
        for dtype in (torch.float32, torch.bfloat16):
            name = dtype_name(dtype)
            q, k, v = attention_inputs(dtype, model)
            g = torch.Generator(device="cuda").manual_seed(SEED + 5)
            for dual in (False, True):
                # HGATE trains without pruning
                for prune_u in ((None, 0.3) if model == "HWGATE" else (None,)):
                    kw = attention_kwargs(dual, prune_u, tail, model)
                    skw = softmax_kwargs(kw)
                    case = f"{model}/{'dual' if dual else 'single'}/prune={prune_u}/{name}"
                    s = scores_of(q, k, kw["scale"])
                    got = masked_softmax(s, adj, p_dtype=dtype, **skw)
                    want = plain_masked_softmax(s, adj, p_dtype=dtype, **skw)
                    torch.cuda.synchronize()
                    fwd_err[case] = (got.float() - want.float()).abs().max().item()
                    if got.dtype != dtype or not fwd_err[case] <= TOL[name]:
                        raise AssertionError(f"masked softmax vs plain {case}: max abs err "
                                             f"{fwd_err[case]} > {TOL[name]}")
                    dp = (torch.randn(s.shape, generator=g, device="cuda") * 0.2).to(dtype)
                    got = masked_softmax_bwd(s, dp, adj, **skw)
                    want = plain_masked_softmax_bwd(s, dp, adj, **skw)
                    torch.cuda.synchronize()
                    tol = BWD_TOL[name]
                    diff = (got - want).abs()
                    bwd_err[case] = diff.max().item()
                    excess = (diff - tol["atol"] - tol["rtol"] * want.abs()).max().item()
                    if got.dtype != torch.float32 or not excess <= 0:
                        raise AssertionError(f"masked softmax backward vs plain {case}: max abs "
                                             f"err {bwd_err[case]} over {tol}")
                    got = hybrid_window_attention(q, k, v, adj, **kw)
                    want = window_attention(q, k, v, adj, **kw)
                    torch.cuda.synchronize()
                    unit_err = (got - want).abs().amax(dim=(1, 2))
                    hybrid_err[case] = unit_err.max().item()
                    over = (unit_err > TOL[name]).nonzero().flatten().tolist()
                    if over and dtype == torch.bfloat16:
                        flips = zero_quirk_flips(q, k, kw["scale"], over)
                        anchored = float64_scores_attention(q, k, v, adj, kw)
                        flip_err = {u: (got[u] - anchored[u]).abs().max().item() for u in flips}
                        hybrid_flips[case] = {"units": flips, "max_abs_err_float64": flip_err}
                        over = [u for u in over if not flip_err.get(u, 1.0) <= TOL[name]]
                        exempted = exempted_units(hybrid_flips)
                        if exempted > MAX_ZERO_QUIRK_UNITS:
                            raise AssertionError(
                                f"hybrid vs fused attention: {exempted} units pass on a "
                                f"zero-quirk flip, more than {MAX_ZERO_QUIRK_UNITS}: "
                                f"{hybrid_flips}")
                    if over:
                        raise AssertionError(f"hybrid vs fused attention {case}: max abs err "
                                             f"{hybrid_err[case]} > {TOL[name]} at units "
                                             f"{over[:8]}")
                    del s, dp, got, want
            del q, k, v
    # the autograd Function's gradient is the backward kernel's
    adj, tail = masks("HGATE")
    q, k, _ = attention_inputs(torch.float32, "HGATE")
    kw = softmax_kwargs(attention_kwargs(True, None, tail, "HGATE"))
    s = scores_of(q, k, HEAD_DIM**-0.5).requires_grad_()
    dp = torch.randn(s.shape, generator=torch.Generator(device="cuda").manual_seed(SEED),
                     device="cuda")
    masked_softmax(s, adj, **kw).backward(dp)
    if not torch.equal(s.grad, masked_softmax_bwd(s.detach(), dp, adj, **kw)):
        raise AssertionError("masked softmax autograd differs from a direct backward call")
    emit("masked_softmax", scores={m: [u, n, n] for m, (u, n, _) in WINDOW_SHAPE.items()},
         tolerance={"fwd": TOL, "bwd": BWD_TOL, "hybrid_vs_fused": TOL},
         fwd_max_abs_err=fwd_err, bwd_max_abs_err=bwd_err, hybrid_vs_fused_max_abs_err=hybrid_err,
         hybrid_vs_fused_zero_quirk_flips=hybrid_flips,
         hybrid_vs_fused_exempted_units=exempted_units(hybrid_flips),
         max_exempted_units=MAX_ZERO_QUIRK_UNITS, autograd_equals_kernel=True)
    return fwd_err, bwd_err


# K7's bf16-score cases (the JAX package's PALLAS_HYBRID_S_BF16 path): the
# single mask, and the dual mask with pruning
BF16_SCORE_CASES = (("single", False, None), ("dual", True, 0.3))


def phase_masked_softmax_bf16_scores():
    """K7 with bf16 scores (P in bf16 and f32) and its backward (dP in bf16,
    dS in bf16) against their plain versions at HWGATE's and HGATE's
    scores (the f32 products of phase 13's bf16 inputs, rounded to bf16),
    single mask and dual mask with pruning; the hybrid attention with bf16
    scores against the same call through the plain masked softmax; the
    autograd Function's bf16 gradient equals a direct backward call.
    Returns the max abs errors by case (keys ending in "bf16_scores")."""
    import torch

    from sl_hwgat_tpu_torch.ops import hybrid_attention
    from sl_hwgat_tpu_torch.ops.hybrid_attention import (
        hybrid_window_attention,
        masked_softmax,
        masked_softmax_bwd,
        plain_masked_softmax,
        plain_masked_softmax_bwd,
    )

    bf16 = torch.bfloat16
    fwd_err, bwd_err, hybrid_err = {}, {}, {}
    for model in ("HWGATE", "HGATE"):
        adj, tail = masks(model)
        q, k, v = attention_inputs(bf16, model)
        g = torch.Generator(device="cuda").manual_seed(SEED + 5)
        for mask, dual, prune_u in BF16_SCORE_CASES:
            kw = attention_kwargs(dual, prune_u, tail, model)
            skw = softmax_kwargs(kw)
            case = f"{model}/{mask}/prune={prune_u}"
            s = scores_of(q, k, kw["scale"]).to(bf16)
            for p_dtype in (bf16, torch.float32):
                name = f"{case}/p={dtype_name(p_dtype)}/bf16_scores"
                got = masked_softmax(s, adj, p_dtype=p_dtype, **skw)
                want = plain_masked_softmax(s, adj, p_dtype=p_dtype, **skw)
                torch.cuda.synchronize()
                fwd_err[name] = (got.float() - want.float()).abs().max().item()
                if got.dtype != p_dtype or not fwd_err[name] <= TOL["bfloat16"]:
                    raise AssertionError(f"masked softmax vs plain {name}: max abs err "
                                         f"{fwd_err[name]} > {TOL['bfloat16']}")
            dp = (torch.randn(s.shape, generator=g, device="cuda") * 0.2).to(bf16)
            got = masked_softmax_bwd(s, dp, adj, **skw)
            want = plain_masked_softmax_bwd(s, dp, adj, **skw)
            torch.cuda.synchronize()
            tol = BWD_TOL["bfloat16"]
            diff = (got.float() - want.float()).abs()
            name = f"{case}/bf16_scores"
            bwd_err[name] = diff.max().item()
            excess = (diff - tol["atol"] - tol["rtol"] * want.float().abs()).max().item()
            if got.dtype != bf16 or want.dtype != bf16 or not excess <= 0:
                raise AssertionError(f"masked softmax backward vs plain {name}: max abs err "
                                     f"{bwd_err[name]} over {tol} ({got.dtype})")
            got = hybrid_window_attention(q, k, v, adj, scores_dtype=bf16, **kw)
            kernel = hybrid_attention.masked_softmax
            hybrid_attention.masked_softmax = plain_masked_softmax
            try:
                want = hybrid_window_attention(q, k, v, adj, scores_dtype=bf16, **kw)
            finally:
                hybrid_attention.masked_softmax = kernel
            torch.cuda.synchronize()
            hybrid_err[name] = (got - want).abs().max().item()
            if not hybrid_err[name] <= TOL["bfloat16"]:
                raise AssertionError(f"hybrid attention, bf16 scores, kernel vs plain {name}: "
                                     f"max abs err {hybrid_err[name]}")
            del s, dp, got, want
        del q, k, v
    adj, tail = masks("HGATE")
    q, k, _ = attention_inputs(bf16, "HGATE")
    kw = softmax_kwargs(attention_kwargs(True, 0.3, tail, "HGATE"))
    s = scores_of(q, k, HEAD_DIM**-0.5).to(bf16).requires_grad_()
    dp = torch.randn(s.shape, generator=torch.Generator(device="cuda").manual_seed(SEED),
                     device="cuda").to(bf16)
    masked_softmax(s, adj, p_dtype=bf16, **kw).backward(dp)
    if s.grad.dtype != bf16 or not torch.equal(s.grad,
                                               masked_softmax_bwd(s.detach(), dp, adj, **kw)):
        raise AssertionError("masked softmax autograd (bf16 scores) differs from a direct "
                             "backward call")
    emit("masked_softmax_bf16_scores",
         scores={m: [u, n, n] for m, (u, n, _) in WINDOW_SHAPE.items()},
         tolerance={"fwd": TOL["bfloat16"], "bwd": BWD_TOL["bfloat16"],
                    "hybrid_vs_plain": TOL["bfloat16"]},
         fwd_max_abs_err=fwd_err, bwd_max_abs_err=bwd_err,
         hybrid_vs_plain_max_abs_err=hybrid_err, autograd_equals_kernel=True)
    return fwd_err, bwd_err


# Cases at the edges of the kernels' contracts: the banded kernels under a
# full band (every bit of the three planes, V = 32: 96 edges a row) over a
# frame count that is not a multiple of the frames per block, and GATE's 29
# joints in one-frame clips; K7 at a ragged unit count (stack 1) under the
# dual mask through a seeded `sel`, with pruning, at HGATE's 58 tokens and
# at 33 (odd: rows and units not 16-byte aligned), on f32 and on bf16 scores
# (bf16 ones also one entry off a 16-byte boundary: every span of the
# staged kernels then has a head, the 33-token ones a tail too, and the
# ragged last span at 37 units); K1 and K2 at 32-token
# units with head dim 32, which no model's main path takes.
EDGE_BANDED = {"full_band": (64, 37, 32), "one_frame": (128, 1, 29)}  # planes, frames, joints
EDGE_UNITS, EDGE_TOKENS = 37, (58, 33)
EDGE_WINDOW = (96, TOKENS, 32)  # units, tokens, head dim


def phase_edge_cases():
    """The banded kernels and K7 against their plain versions at the cases
    above, f32 and bf16, with the main phases' bars and input scales; the
    banded backward also repeats bit for bit. Returns the max abs errors by
    kernel and case."""
    import numpy as np
    import torch

    from sl_hwgat_tpu_torch.ops.banded_attention import (
        banded_attention,
        banded_attention_bwd,
        plain_banded_attention,
        plain_banded_attention_bwd,
    )
    from sl_hwgat_tpu_torch.ops.hybrid_attention import (
        masked_softmax,
        masked_softmax_bwd,
        plain_masked_softmax,
        plain_masked_softmax_bwd,
    )

    from sl_hwgat_tpu_torch.ops.window_attention import (
        plain_window_attention,
        plain_window_attention_bwd,
        window_attention,
        window_attention_bwd,
    )

    errors = {"banded_fwd": {}, "banded_bwd": {}, "softmax_fwd": {}, "softmax_bwd": {},
              "window_fwd": {}, "window_bwd": {}}
    bands = {"full_band": np.zeros((3, 32, 32), np.float32),
             "one_frame": banded_bands()["GATE"]["identity"]}
    for label, (planes, frames, joints) in EDGE_BANDED.items():
        band = bands[label]
        g = torch.Generator(device="cuda").manual_seed(SEED + 6)
        base = [torch.randn(planes, frames * joints, BANDED_DH, generator=g, device="cuda")
                for _ in range(4)]
        for dtype in (torch.float32, torch.bfloat16):
            name = dtype_name(dtype)
            case = f"{label}/{name}"
            q, k = base[0].to(dtype), base[1].to(dtype)
            v, do = (base[2] * 0.2).to(dtype), (base[3] * 0.2).to(dtype)
            got = banded_attention(q, k, v, band, scale=BANDED_SCALE)
            want = plain_banded_attention(q, k, v, band, scale=BANDED_SCALE)
            torch.cuda.synchronize()
            errors["banded_fwd"][case] = (got - want).abs().max().item()
            if not errors["banded_fwd"][case] <= TOL[name]:
                raise AssertionError(f"banded kernel vs plain {case}: max abs err "
                                     f"{errors['banded_fwd'][case]} > {TOL[name]}")
            got = banded_attention_bwd(q, k, v, do, band, scale=BANDED_SCALE)
            want = plain_banded_attention_bwd(q, k, v, do, band, scale=BANDED_SCALE)
            errors["banded_bwd"][case] = max(banded_bwd_errors(case, got, want, dtype).values())
            again = banded_attention_bwd(q, k, v, do, band, scale=BANDED_SCALE)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"banded backward {case}: a second call differs")
    for n in EDGE_TOKENS:
        adj, tail = masks("HGATE") if n == 58 else wide_unit_masks(n)
        g = torch.Generator(device="cuda").manual_seed(SEED + 7)
        q, k = (torch.randn(EDGE_UNITS, n, HEAD_DIM, generator=g, device="cuda")
                for _ in range(2))
        sel = (torch.rand(EDGE_UNITS, generator=g, device="cuda") < 0.5).int()
        dp = torch.randn(EDGE_UNITS, n, n, generator=g, device="cuda") * 0.2
        kw = dict(stack=1, tail_adj=tail, units_per_group=1, groups=2, sel=sel,
                  prune_u=torch.full((1,), 0.3, device="cuda"))
        for dtype, scores in ((torch.float32, "f32"), (torch.bfloat16, "f32"),
                              (torch.bfloat16, "bf16"), (torch.bfloat16, "bf16_offset")):
            name = dtype_name(dtype)
            case = f"{EDGE_UNITS}x{n}/{name}" + ("" if scores == "f32" else f"/{scores}_scores")
            s = scores_of(q.to(dtype), k.to(dtype), HEAD_DIM**-0.5)
            if scores != "f32":
                s = s.to(dtype)
            if scores == "bf16_offset":  # one entry off a 16-byte boundary
                s = torch.empty(s.numel() + 1, dtype=dtype, device="cuda")[1:].view(
                    s.shape).copy_(s)
            got = masked_softmax(s, adj, p_dtype=dtype, **kw)
            want = plain_masked_softmax(s, adj, p_dtype=dtype, **kw)
            torch.cuda.synchronize()
            errors["softmax_fwd"][case] = (got.float() - want.float()).abs().max().item()
            if got.dtype != dtype or not errors["softmax_fwd"][case] <= TOL[name]:
                raise AssertionError(f"masked softmax vs plain {case}: max abs err "
                                     f"{errors['softmax_fwd'][case]} > {TOL[name]}")
            got = masked_softmax_bwd(s, dp.to(dtype), adj, **kw)
            want = plain_masked_softmax_bwd(s, dp.to(dtype), adj, **kw)
            torch.cuda.synchronize()
            tol = BWD_TOL[name]
            diff = (got.float() - want.float()).abs()
            errors["softmax_bwd"][case] = diff.max().item()
            if got.dtype != s.dtype or not (diff - tol["atol"] - tol["rtol"] * want.float().abs()
                                            ).max().item() <= 0:
                raise AssertionError(f"masked softmax backward vs plain {case}: max abs err "
                                     f"{errors['softmax_bwd'][case]} over {tol} ({got.dtype})")
    adj, tail = masks()
    g = torch.Generator(device="cuda").manual_seed(SEED + 8)
    base = [torch.randn(*EDGE_WINDOW, generator=g, device="cuda") for _ in range(4)]
    detail = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        q, k, v, do = base[0].to(dtype), base[1].to(dtype), (base[2] * 0.2).to(dtype), \
            base[3].to(dtype)
        for dual in (False, True):
            kw = dict(scale=EDGE_WINDOW[2]**-0.5, stack=4, prune_u=torch.full((1,), 0.3,
                                                                              device="cuda"))
            if dual:
                kw.update(tail_adj=tail, units_per_group=8, groups=2)
            case = f"dh{EDGE_WINDOW[2]}/{name}/{'dual' if dual else 'single'}/prune=0.3"
            got = window_attention(q, k, v, adj, out_dtype=dtype, **kw)
            want = plain_window_attention(q, k, v, adj, out_dtype=dtype, **kw)
            torch.cuda.synchronize()
            errors["window_fwd"][case] = (got.float() - want.float()).abs().max().item()
            if not errors["window_fwd"][case] <= TOL[name]:
                raise AssertionError(f"kernel vs plain {case}: max abs err "
                                     f"{errors['window_fwd'][case]} > {TOL[name]}")
            errors["window_bwd"][case] = check_gradients(
                detail, case, window_attention_bwd(q, k, v, do, adj, **kw),
                plain_window_attention_bwd(q, k, v, do, adj, **kw), dtype)
    emit("edge_cases", banded={k: [*v, BANDED_DH] for k, v in EDGE_BANDED.items()},
         masked_softmax={"units": EDGE_UNITS, "tokens": list(EDGE_TOKENS), "stack": 1,
                         "dual_mask": "sel", "prune_u": 0.3,
                         "scores": ["f32", "bf16", "bf16 one entry off 16 bytes"]},
         window_attention={"shape": list(EDGE_WINDOW), "stack": 4, "prune_u": 0.3},
         tolerance={"fwd": TOL, "bwd": BWD_TOL}, max_abs_err=errors,
         banded_bwd_repeats_bit_for_bit=True)
    return errors


def path_kernels(impl: str):
    """((forward, backward) counters of the kernels ``impl`` runs, the same
    pair of the other path), each a function with a ``launches`` count."""
    from sl_hwgat_tpu_torch.ops.hybrid_attention import masked_softmax, masked_softmax_bwd
    from sl_hwgat_tpu_torch.ops.window_attention import window_attention, window_attention_bwd

    fused, hybrid = (window_attention, window_attention_bwd), (masked_softmax, masked_softmax_bwd)
    return (hybrid, fused) if impl == "hybrid" else (fused, hybrid)


def reset_launches(*counters) -> None:
    for c in counters:
        c.launches = 0


@contextmanager
def plain_path(impl: str):
    """Run a windowed model's attention through the plain versions: the
    plain fused attention ("auto"), or the plain masked softmax between the
    same GEMMs ("hybrid"); torch differentiates both."""
    from sl_hwgat_tpu_torch.ops import hybrid_attention

    if impl != "hybrid":
        with plain_attention_in_model():
            yield
        return
    kernel = hybrid_attention.masked_softmax
    hybrid_attention.masked_softmax = hybrid_attention.plain_masked_softmax
    try:
        yield
    finally:
        hybrid_attention.masked_softmax = kernel


def windowed_model(name: str, impl: str, compute_dtype: str, **overrides):
    from sl_hwgat_tpu_torch.constants import DATASET_PARAMS
    from sl_hwgat_tpu_torch.models import build_model

    return build_model(name, DATASET_PARAMS["FDMSE-ISL"], 2, device="cuda", seed=SEED,
                       attn_impl=impl, compute_dtype=compute_dtype, **overrides)


def phase_windowed_forward():
    import torch

    out = {}
    for name, impl in WINDOWED_PATHS:
        x = banded_batch(name)
        (fwd, _), (other, _) = path_kernels(impl)
        for cdt in ("float32", "bfloat16"):
            model = windowed_model(name, impl, cdt)
            with torch.inference_mode():
                reset_launches(fwd, other)
                got = model(x)
                torch.cuda.synchronize()
                launches, other_launches = fwd.launches, other.launches
                with plain_path(impl):
                    want = model(x)
                torch.cuda.synchronize()
            case = f"{name}/{impl}/{cdt}"
            if launches != 8 or other_launches != 0:
                raise AssertionError(f"{case} forward launched {launches} times (the other "
                                     f"path's kernel {other_launches}), not 8 (0)")
            if got.shape != (16, 2002) or not torch.isfinite(got).all():
                raise AssertionError(f"{case} logits: shape {tuple(got.shape)} or non-finite")
            torch.testing.assert_close(got, want, **LOGIT_TOL[cdt])
            out[case] = {"max_abs_diff": (got - want).abs().max().item(),
                         "launches_per_forward": launches, "other_path_launches": other_launches}
            del model
    emit("windowed_forward", batch=16, frames=192, classes=2002, tolerance=LOGIT_TOL,
         results=out)


def phase_windowed_serve(workdir: Path) -> dict:
    """Main paths 5-7: serving HWGATE hybrid, HGATE and HGATE hybrid; returns
    the forward launches by kernel."""
    import numpy as np
    import torch

    from sl_hwgat_tpu_torch.serve import Predictor
    from sl_hwgat_tpu_torch.weights import save_state_dict

    rng = np.random.default_rng(SEED + 2)
    clips = [rng.random((int(f), 543, 4)).astype(np.float32)
             for f in rng.integers(96, 385, size=24)]
    out, total = {}, {}
    for name, impl in WINDOWED_PATHS:
        ckpt = workdir / f"{name.lower()}_{impl}_fdmse_isl.pt"
        save_state_dict(str(ckpt), windowed_model(name, impl, "float32"))
        t0 = time.perf_counter()
        pred = Predictor.from_checkpoint(str(ckpt), model_type=name, dataset="FDMSE-ISL",
                                         attn_impl=impl)
        pred.warmup(clips[0])
        setup_s = time.perf_counter() - t0
        (fwd, _), (other, _) = path_kernels(impl)

        reset_launches(fwd, other)
        rows, stats, serve_s = burst(pred, clips)
        launches, other_launches = fwd.launches, other.launches

        case = f"{name}/{impl}"
        if launches != 8 * stats["batches"] or other_launches != 0:
            raise AssertionError(f"{case}: {launches} launches ({other_launches} of the other "
                                 f"path) for {stats['batches']} batches")
        errs = []
        for clip, row in zip(clips, rows):
            want = pred.predict_logits([clip])[0]
            errs.append(float(np.abs(row - want).max()))
            if not (row.shape == (2002,) and np.isfinite(row).all() and errs[-1] <= 2e-4):
                raise AssertionError(f"{case}: served row differs from predict_logits by "
                                     f"{errs[-1]}")
        kps = pred.preprocess(clips[0]).shape[1]
        if kps != NUM_KPS[name]:
            raise AssertionError(f"{case} served {kps}-joint clips")
        pred.close()
        out[case] = {"requests": stats["requests"], "batches": stats["batches"],
                     "batch_sizes": stats["batch_sizes"], "kernel": fwd.__name__,
                     "launches": launches, "joints": kps, "max_abs_err": max(errs),
                     "setup_s": setup_s, "serve_s": serve_s, "clips_per_s": len(clips) / serve_s}
        total[fwd.__name__] = total.get(fwd.__name__, 0) + launches
        del pred
        torch.cuda.empty_cache()
    emit("windowed_serve", results=out)
    return total


def phase_windowed_train() -> dict:
    """Gradients against the plain path, then main paths 8-10: ten AdamW
    steps per path and type. Returns the launches of the AdamW runs by
    kernel."""
    import torch

    from sl_hwgat_tpu_torch.train.loop import make_steps
    from sl_hwgat_tpu_torch.train.state import make_optimizer

    out, total = {}, {}
    for name, impl in WINDOWED_PATHS:
        x, y, valid = banded_batch(name, train=True)
        (fwd, bwd), (ofwd, obwd) = path_kernels(impl)
        for cdt in ("float32", "bfloat16"):
            case = f"{name}/{impl}/{cdt}"
            model = windowed_model(name, impl, cdt, drop_rate=0.0)
            reset_launches(fwd, bwd, ofwd, obwd)
            loss, grads = one_step_grads(model, x, y, valid, seed=SEED)
            torch.cuda.synchronize()
            launches = (fwd.launches, bwd.launches, ofwd.launches + obwd.launches)
            if launches != (8, 8, 0):
                raise AssertionError(f"{case} step launched (fwd, bwd, other path) = {launches}")
            with plain_path(impl):
                plain_loss, plain = one_step_grads(model, x, y, valid, seed=SEED)
            worst = grad_errors(case, cdt, grads, plain)
            del grads, plain, model

            model = windowed_model(name, impl, cdt)
            opt = make_optimizer("adamw", LR, model.parameters())
            train_step, _ = make_steps(model, opt)
            reset_launches(fwd, bwd, ofwd, obwd)
            losses = [train_step(x, y, valid, SEED, 0, step)[0].item() for step in range(10)]
            torch.cuda.synchronize()
            run = {"fwd": fwd.launches, "bwd": bwd.launches,
                   "other_path": ofwd.launches + obwd.launches}
            if run != {"fwd": 80, "bwd": 80, "other_path": 0}:
                raise AssertionError(f"{case}: ten steps launched {run}")
            if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
                raise AssertionError(f"{case} AdamW losses: {losses}")
            for c, n in ((fwd, run["fwd"]), (bwd, run["bwd"])):
                total[c.__name__] = total.get(c.__name__, 0) + n
            out[case] = {"loss_kernels": loss, "loss_plain": plain_loss,
                         "launches_per_step": {"fwd": launches[0], "bwd": launches[1]},
                         "grad_err_worst": max(worst.values()),
                         "grad_err_worst_param": max(worst, key=worst.get),
                         "grad_err_metric": "max abs" if cdt == "float32" else "rel norm",
                         "params_with_grad": len(worst), "adamw_losses": losses,
                         "adamw_launches": run}
            del model, opt, train_step
            torch.cuda.empty_cache()
    emit("windowed_train", batch=16, frames=192, classes=2002, lr=LR,
         tolerance={"float32": GRAD_ATOL_F32, "bfloat16": GRAD_REL_BF16}, results=out)
    return total


# the model option of the hybrid path's bf16 scores (PALLAS_HYBRID_S_BF16=1)
BF16_SCORES = {"hybrid_scores_dtype": "bfloat16"}


def in_turns_ms(calls: dict, timer, rounds: int = 2) -> dict:
    """{name: [ms, ...]} of ``calls`` timed in turns (a, b, c, c, b, a, ...)
    by ``timer`` (a function of a call, in ms)."""
    names, times = list(calls), {n: [] for n in calls}
    for i in range(rounds):
        for n in (names if i % 2 == 0 else names[::-1]):
            times[n].append(timer(calls[n]))
    return times


def product_gradients() -> dict:
    """The bf16 products' gradients (``_Bf16Product``) held against an
    independent one: dq, dk, dv of ``hybrid_window_attention`` on bf16 q, k,
    v at HWGATE's and HGATE's calls, f32 and bf16 scores, single mask and
    dual mask with pruning, against the same attention whose two products
    carry the path's values (the output asserted bit for bit) with the
    derivative torch gives ``torch.bmm`` on f32 copies of the operands; K7
    and its backward on both sides. Bar: 4e-3 + 1e-2·|x| (``BWD_TOL``).
    Returns {case: {"q"|"k"|"v": worst ratio to the bar}}."""
    import torch

    from sl_hwgat_tpu_torch.ops.hybrid_attention import hybrid_window_attention, masked_softmax

    class Product(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, b, value):
            ctx.save_for_backward(a, b)
            return value.clone()

        @staticmethod
        def backward(ctx, g):
            a, b = ctx.saved_tensors
            with torch.enable_grad():
                a32, b32 = (x.detach().float().requires_grad_() for x in (a, b))
                da, db = torch.autograd.grad(torch.bmm(a32, b32), (a32, b32), g.float())
            return da.to(a.dtype), db.to(b.dtype), None

    def product(a, b, out_dtype):
        value = torch.bmm(a.detach(), b.detach(), out_dtype=torch.float32).to(out_dtype)
        return Product.apply(a, b, value)

    def reference(q, k, v, adj, s_dtype, kw):
        scaled = q * torch.tensor(kw["scale"], dtype=q.dtype)
        p = masked_softmax(product(scaled, k.transpose(1, 2), s_dtype), adj, p_dtype=v.dtype,
                           **softmax_kwargs(kw))
        return product(p, v, torch.float32)

    bf16, tol = torch.bfloat16, BWD_TOL["bfloat16"]
    ratios = {}
    for model in ("HWGATE", "HGATE"):
        adj, tail = masks(model)
        q, k, v = attention_inputs(bf16, model)
        do = output_grad(torch.float32, model)
        for mask, dual, prune_u in BF16_SCORE_CASES:
            kw = attention_kwargs(dual, prune_u, tail, model)
            for s_dtype in (torch.float32, bf16):
                case = f"{model}/{mask}/prune={prune_u}/scores={dtype_name(s_dtype)}"
                got_leaves, ref_leaves = ([x.detach().requires_grad_() for x in (q, k, v)]
                                          for _ in range(2))
                got = hybrid_window_attention(*got_leaves, adj, scores_dtype=s_dtype, **kw)
                want = reference(*ref_leaves, adj, s_dtype, kw)
                if "_Bf16Product" not in type(got.grad_fn).__name__:
                    raise AssertionError(f"bf16 product gradients {case}: the output's gradient "
                                         f"is {type(got.grad_fn).__name__}")
                if not torch.equal(got, want):
                    raise AssertionError(f"bf16 product gradients {case}: the reference's "
                                         f"output is not the path's bit for bit")
                got.backward(do)
                want.backward(do)
                torch.cuda.synchronize()
                ratios[case] = {}
                for name, a, b in zip("qkv", got_leaves, ref_leaves):
                    want_grad = b.grad.float()
                    bar = tol["atol"] + tol["rtol"] * want_grad.abs()
                    ratios[case][name] = ((a.grad.float() - want_grad).abs() / bar).max().item()
                    if a.grad.dtype != bf16 or not ratios[case][name] <= 1.0:
                        raise AssertionError(f"bf16 product gradients {case}: d{name} at "
                                             f"{ratios[case][name]} of the bar {tol} "
                                             f"({a.grad.dtype})")
                del got, want, got_leaves, ref_leaves
        del q, k, v, do
    torch.cuda.empty_cache()
    return ratios


def phase_hybrid_bf16_scores() -> dict:
    """Main path 10b, the hybrid path with bf16 scores: HWGATE and HGATE with
    attn_impl="hybrid", bf16, hybrid_scores_dtype="bfloat16" at FDMSE-ISL,
    full width, batch 16: eval logits against the plain path (the bf16
    logit bar) and not equal to the f32-score model's, one train step's
    gradients against the plain path (the bf16 gradient bar), the counts set
    to 0 just before and read just after each: exactly 8 K7 forwards a
    forward, 8 K7 backwards a step, no K1/K2. Then, timed in turns: each
    model's eval forward and train step with f32 and with bf16 scores (CUDA
    events); then ``product_gradients``. Returns K7's launches of the eval
    and step runs."""
    import torch

    out, total = {}, {"masked_softmax": 0, "masked_softmax_bwd": 0}
    (fwd, bwd), (ofwd, obwd) = path_kernels("hybrid")
    for name in ("HWGATE", "HGATE"):
        case = f"{name}/hybrid/bfloat16/bf16_scores"
        x = banded_batch(name)
        xt, yt, valid = banded_batch(name, train=True)
        model = windowed_model(name, "hybrid", "bfloat16", **BF16_SCORES)
        f32_scores = windowed_model(name, "hybrid", "bfloat16")
        with torch.inference_mode():
            reset_launches(fwd, bwd, ofwd, obwd)
            got = model(x)
            torch.cuda.synchronize()
            launches = (fwd.launches, bwd.launches, ofwd.launches + obwd.launches)
            total["masked_softmax"] += fwd.launches
            with plain_path("hybrid"):
                want = model(x)
            other = f32_scores(x)
        if launches != (8, 0, 0):
            raise AssertionError(f"{case} forward launched (K7 fwd, bwd, K1/K2) = {launches}")
        if got.shape != (16, 2002) or not torch.isfinite(got).all():
            raise AssertionError(f"{case} logits: shape {tuple(got.shape)} or non-finite")
        torch.testing.assert_close(got, want, **LOGIT_TOL["bfloat16"])
        if torch.equal(got, other):
            raise AssertionError(f"{case}: logits equal the f32-score model's bit for bit")
        step_model = windowed_model(name, "hybrid", "bfloat16", drop_rate=0.0, **BF16_SCORES)
        reset_launches(fwd, bwd, ofwd, obwd)
        loss, grads = one_step_grads(step_model, xt, yt, valid, seed=SEED)
        torch.cuda.synchronize()
        step_launches = (fwd.launches, bwd.launches, ofwd.launches + obwd.launches)
        total["masked_softmax"] += fwd.launches
        total["masked_softmax_bwd"] += bwd.launches
        if step_launches != (8, 8, 0):
            raise AssertionError(f"{case} step launched (fwd, bwd, K1/K2) = {step_launches}")
        with plain_path("hybrid"):
            plain_loss, plain = one_step_grads(step_model, xt, yt, valid, seed=SEED)
        worst = grad_errors(case, "bfloat16", grads, plain)
        del grads, plain, step_model
        models = {"f32_scores": f32_scores, "bf16_scores": model}
        with torch.inference_mode():
            forward_ms = in_turns_ms({n: (lambda m=m: m(x)) for n, m in models.items()},
                                     lambda c: cuda_ms(c, runs=10, inner=1))
        step_ms = in_turns_ms(models, lambda m: train_step_ms(m, xt, yt, valid, steps=5))
        out[case] = {"logit_max_abs_diff": (got - want).abs().max().item(),
                     "logit_diff_to_f32_scores": (got - other).abs().max().item(),
                     "launches_per_forward": launches[0],
                     "launches_per_step": {"fwd": step_launches[0], "bwd": step_launches[1]},
                     "loss_kernels": loss, "loss_plain": plain_loss,
                     "grad_err_worst": max(worst.values()),
                     "grad_err_worst_param": max(worst, key=worst.get),
                     "forward_ms_in_turns": forward_ms, "train_step_ms_in_turns": step_ms}
        del model, f32_scores, models, got, want, other
        torch.cuda.empty_cache()

    gradients = product_gradients()
    emit("hybrid_bf16_scores", batch=16, frames=192, classes=2002,
         tolerance={"logits": LOGIT_TOL["bfloat16"], "grad_rel_norm": GRAD_REL_BF16,
                    "product_gradients": BWD_TOL["bfloat16"]},
         results=out, product_gradient_ratio_to_bar=gradients,
         product_gradient_worst_ratio=max(max(r.values()) for r in gradients.values()),
         attention_shapes={m: list(WINDOW_SHAPE[m]) for m in ("HWGATE", "HGATE")},
         launches=total, nvidia_smi=nvidia_smi(),
         note="forward_ms_in_turns / train_step_ms_in_turns: CUDA events (median of 10 "
              "forwards, of 5 steps after 3), f32-score and bf16-score models in turns; "
              "product_gradient_ratio_to_bar: |d - d_ref| / (4e-3 + 1e-2·|d_ref|), worst "
              "entry, d_ref through torch's derivative of bmm on f32 operands")
    return total


# Operations per score entry of the masked softmax (f32, CUDA cores):
# forward the prune softmax (max, subtract, exp, sum, divide, compare), the
# mask (select, compare) and the softmax (max, subtract, exp, sum, divide);
# backward the same plus the product, the row sum, the difference, the
# product and the gate.
SOFTMAX_OPS = {"fwd": 13, "bwd": 18}


def softmax_bound(kind: str, dtype_name: str, model: str,
                  scores: str = "float32") -> tuple[float, str]:
    """(least ms on an H100 SXM, what bounds it) for one masked-softmax call
    at ``model``'s scores: S (``scores``) read and P (v's type) written
    once; the backward reads S and dP (P's type) and writes dS (S's type)
    once."""
    units, tokens, _ = WINDOW_SHAPE[model]
    entries = units * tokens * tokens
    elem = 4 if dtype_name == "float32" else 2
    s_elem = 4 if scores == "float32" else 2
    nbytes = entries * (s_elem + elem if kind == "fwd" else 2 * s_elem + elem)
    return ms_bound(nbytes, entries * SOFTMAX_OPS[kind], "float32")


def phase_windowed_timings() -> dict:
    """K1/K2 at HGATE's 58-token units and K7 at both models' scores: kernel,
    plain, bound and library ms; the hybrid attention against the fused
    kernels per call; eval forward and train step of every windowed path."""
    import torch

    from sl_hwgat_tpu_torch.ops.attention import masked_scores, unit_allowed
    from sl_hwgat_tpu_torch.ops.hybrid_attention import (
        hybrid_window_attention,
        masked_softmax,
        masked_softmax_bwd,
        plain_masked_softmax,
        plain_masked_softmax_bwd,
    )
    from sl_hwgat_tpu_torch.ops.window_attention import (
        plain_window_attention,
        plain_window_attention_bwd,
        window_attention,
        window_attention_bwd,
    )

    wide = {"fwd": {}, "bwd": {}}
    softmax = {"fwd": {}, "bwd": {}}
    versus = {}
    for model in ("HWGATE", "HGATE"):
        adj, tail = masks(model)
        additive = torch.where(torch.from_numpy(adj) != 0, 0.0, -1e4).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            name = dtype_name(dtype)
            key = f"{model}/{name}"
            q, k, v = attention_inputs(dtype, model)
            do = output_grad(dtype, model)
            kw = attention_kwargs(False, None, tail, model)
            skw = softmax_kwargs(kw)
            if model == "HGATE":  # K1/K2 at 58-token units
                fwd, bwd = {}, {}
                for dual in (False, True):
                    dkw = attention_kwargs(dual, None, tail, model)
                    case = "dual" if dual else "single"
                    def k1():
                        return window_attention(q, k, v, adj, out_dtype=dtype, **dkw)

                    def k2():
                        return window_attention_bwd(q, k, v, do, adj, **dkw)

                    fwd[case] = {
                        "ms": cuda_ms(k1), "device_ms": device_seconds(k1) * 1e3,
                        "plain_ms": cuda_ms(lambda: plain_window_attention(
                            q, k, v, adj, out_dtype=dtype, **dkw), runs=10)}
                    bwd[case] = {
                        "ms": cuda_ms(k2), "device_ms": device_seconds(k2) * 1e3,
                        "plain_ms": cuda_ms(lambda: plain_window_attention_bwd(
                            q, k, v, do, adj, **dkw), runs=5)}
                mask = additive.to(dtype)[None, None]
                library = sdpa_ms(q, k, v, do, mask)
                library_device = sdpa_ms(q, k, v, do, mask, timer=device_seconds)
                for kind, cases, lib, lib_device in (("fwd", fwd, library[0], library_device[0]),
                                                     ("bwd", bwd, library[1], library_device[1])):
                    bound_ms, bound_by = bound(kind, name, model)
                    wide[kind][key] = {"cases": cases, "library_ms": lib,
                                       "library_device_ms": lib_device, "bound_ms": bound_ms,
                                       "bound_by": bound_by}
            # K7, single mask (the library call's function), with the library
            # yardstick: one softmax call over the already-masked scores, and
            # the softmax backward of its output
            s = scores_of(q, k, kw["scale"])
            dp = (torch.randn(s.shape, generator=torch.Generator(device="cuda").manual_seed(SEED),
                              device="cuda") * 0.2).to(dtype)
            masked = masked_scores(s, unit_allowed(adj, None, None, s.shape[0], kw["stack"],
                                                   s.device), zero_quirk=True, prune_u=None)
            p32 = torch.softmax(masked, -1)
            dp32 = dp.float()
            kernel = {"fwd": lambda: masked_softmax(s, adj, p_dtype=dtype, **skw),
                      "bwd": lambda: masked_softmax_bwd(s, dp, adj, **skw)}
            library = {"fwd": lambda: torch.softmax(masked, -1),
                       "bwd": lambda: torch.ops.aten._softmax_backward_data(
                           dp32, p32, -1, torch.float32)}
            plain = {"fwd": lambda: plain_masked_softmax(s, adj, p_dtype=dtype, **skw),
                     "bwd": lambda: plain_masked_softmax_bwd(s, dp, adj, **skw)}
            for kind in ("fwd", "bwd"):
                bound_ms, bound_by = softmax_bound(kind, name, model)
                softmax[kind][key] = {
                    "ms": cuda_ms(kernel[kind]), "device_ms": device_seconds(kernel[kind]) * 1e3,
                    "plain_ms": cuda_ms(plain[kind], runs=10),
                    "library_ms": cuda_ms(library[kind]),
                    "library_device_ms": device_seconds(library[kind]) * 1e3,
                    "bound_ms": bound_ms, "bound_by": bound_by}
            if dtype == torch.bfloat16:
                # K7 on bf16 scores (P, dP and dS in bf16) beside torch.softmax
                # over the same masked bf16 scores and its backward
                sb, mb = s.to(dtype), masked.to(dtype)
                pb = torch.softmax(mb, -1)
                kernel = {"fwd": lambda: masked_softmax(sb, adj, p_dtype=dtype, **skw),
                          "bwd": lambda: masked_softmax_bwd(sb, dp, adj, **skw)}
                library = {"fwd": lambda: torch.softmax(mb, -1),
                           "bwd": lambda: torch.ops.aten._softmax_backward_data(
                               dp, pb, -1, dtype)}
                plain = {"fwd": lambda: plain_masked_softmax(sb, adj, p_dtype=dtype, **skw),
                         "bwd": lambda: plain_masked_softmax_bwd(sb, dp, adj, **skw)}
                for kind in ("fwd", "bwd"):
                    bound_ms, bound_by = softmax_bound(kind, name, model, scores=name)
                    softmax[kind][f"{model}/bf16_scores"] = {
                        "ms": cuda_ms(kernel[kind]),
                        "device_ms": device_seconds(kernel[kind]) * 1e3,
                        "plain_ms": cuda_ms(plain[kind], runs=10),
                        "library_ms": cuda_ms(library[kind]),
                        "library_device_ms": device_seconds(library[kind]) * 1e3,
                        "bound_ms": bound_ms, "bound_by": bound_by}
                del sb, mb, pb
            del s, dp, masked, p32, dp32
            # the whole hybrid attention against the fused kernels, per call,
            # shifted blocks' dual mask (the models' larger share)
            dkw = attention_kwargs(True, None, tail, model)
            leaves = tuple(t.detach().requires_grad_() for t in (q, k, v))

            def both(fn):
                return lambda: torch.autograd.grad(fn(*leaves, adj, **dkw), leaves, do)

            with torch.no_grad():
                versus[key] = {
                    "hybrid_fwd_ms": cuda_ms(lambda: hybrid_window_attention(q, k, v, adj, **dkw)),
                    "fused_fwd_ms": cuda_ms(lambda: window_attention(q, k, v, adj, **dkw))}
            versus[key]["hybrid_fwd_bwd_ms"] = cuda_ms(both(hybrid_window_attention), runs=20)
            versus[key]["fused_fwd_bwd_ms"] = cuda_ms(both(window_attention), runs=20)
            del q, k, v, do, leaves
            torch.cuda.empty_cache()
    emit("windowed_timings", shapes={m: list(s) for m, s in WINDOW_SHAPE.items()},
         window_attention=wide, masked_softmax=softmax, hybrid_vs_fused=versus,
         note="K1/K2 library_ms: scaled_dot_product_attention per 58-token unit with the "
              "adjacency as an additive mask (backward as fwd+bwd minus fwd); device_ms and "
              "library_device_ms: the card's time with its queue kept full "
              "(profiling.device_seconds), which the events' ms exceed where the wrapper's "
              "host path outlasts the kernel; masked_softmax "
              "library_ms: torch.softmax over the already-masked f32 scores (backward: "
              "aten._softmax_backward_data of its output; <model>/bf16_scores: the same on "
              "the masked scores in bf16, its P and dS in bf16); timed only. "
              "hybrid_vs_fused: one attention call (dual mask, f32 output), forward and "
              "forward+backward")

    results = {}
    for name, impl in WINDOWED_PATHS:
        for cdt in ("float32", "bfloat16"):
            model = windowed_model(name, impl, cdt)
            with torch.inference_mode():
                x = banded_batch(name)
                ms = cuda_ms(lambda: model(x), runs=20, inner=1)
            step_ms = train_step_ms(model, *banded_batch(name, train=True))
            results[f"{name}/{impl}/{cdt}"] = {
                "forward_ms": ms, "clips_per_s": 16 / ms * 1e3, "train_step_ms": step_ms,
                "train_clips_per_s": 16 / step_ms * 1e3}
            del model
            torch.cuda.empty_cache()
    emit("windowed_eval_train", batch=16, frames=192, results=results)
    return {"window_attention": wide, "masked_softmax": softmax}


# Per unit: tensors of N × HEAD_DIM that a call reads and writes once, and
# N × N × HEAD_DIM products it does. forward: q, k, v → o; S = QKᵀ, O = AV.
# backward: q, k, v, dO → dq, dk, dv; S, dA = dO Vᵀ, dV = Aᵀ dO, dQ = dS K,
# dK = dSᵀ Q.
WORK = {"fwd": (4, 2), "bwd": (7, 5)}


def bound(kind: str, dtype_name: str, model: str = "HWGATE") -> tuple[float, str]:
    """(least ms on an H100 SXM, what bounds it) for one call at ``model``'s
    shape: bytes over the memory rate or operations over the peak rate of
    the type (f32: CUDA cores; bf16: dense tensor cores). The padding of
    HGATE's units is not work: 58 tokens, not 64."""
    units, tokens, head_dim = WINDOW_SHAPE[model]
    tensors, products = WORK[kind]
    elem = 4 if dtype_name == "float32" else 2
    return ms_bound(tensors * units * tokens * head_dim * elem,
                    products * 2 * tokens * tokens * head_dim * units, dtype_name)


def sdpa_ms(q, k, v, do, mask, scale: float = HEAD_DIM**-0.5, runs: int = 30,
            backends=None, timer=None):
    """(forward ms, backward ms) of masked scaled_dot_product_attention on the
    same units, the backward as (forward + backward) − forward. Timed only.
    ``backends``: the SDPA backends it may use (default: PyTorch's choice).
    ``timer``: ``cuda_ms`` (the default, CUDA events around back-to-back
    calls) or ``device_seconds`` (the card's time with its queue kept full)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    qg, kg, vg = (t[:, None].detach().requires_grad_() for t in (q, k, v))
    do4 = do[:, None]

    def fwd():
        return F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, scale=scale)

    def ms(fn, n):
        return cuda_ms(fn, runs=n) if timer is None else timer(fn) * 1e3

    with sdpa_kernel(backends) if backends else nullcontext():
        with torch.no_grad():
            fwd_ms = ms(fwd, runs)
        grad_fwd_ms = ms(fwd, runs)
        both_ms = ms(lambda: torch.autograd.grad(fwd(), (qg, kg, vg), do4),
                     max(runs * 2 // 3, 5))
    return fwd_ms, both_ms - grad_fwd_ms


def train_step_ms(model, x, y, valid, steps: int = 10) -> float:
    """Median ms of one train step of ``model`` on a batch (forward,
    backward, AdamW), by CUDA events around each step."""
    import torch

    from sl_hwgat_tpu_torch.train.loop import make_steps
    from sl_hwgat_tpu_torch.train.state import make_optimizer

    train_step, _ = make_steps(model, make_optimizer("adamw", LR, model.parameters()))
    for step in range(3):
        train_step(x, y, valid, SEED, 0, step)
    times = []
    for step in range(3, 3 + steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        train_step(x, y, valid, SEED, 0, step)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_timings():
    import torch

    from sl_hwgat_tpu_torch.ops.window_attention import (
        plain_window_attention,
        plain_window_attention_bwd,
        window_attention,
        window_attention_bwd,
    )

    adj, tail = masks()
    additive = torch.where(torch.from_numpy(adj) != 0, 0.0, -1e4).cuda()
    kernels = {"fwd": {}, "bwd": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = dtype_name(dtype)
        q, k, v = attention_inputs(dtype)
        do = output_grad(dtype)
        fwd, bwd = {}, {}
        for dual in (False, True):
            kw = attention_kwargs(dual, None, tail)
            case = "dual" if dual else "single"

            def k1():
                return window_attention(q, k, v, adj, out_dtype=dtype, **kw)

            def k2():
                return window_attention_bwd(q, k, v, do, adj, **kw)

            fwd[case] = {
                "ms": cuda_ms(k1), "device_ms": device_seconds(k1) * 1e3,
                "plain_ms": cuda_ms(
                    lambda: plain_window_attention(q, k, v, adj, out_dtype=dtype, **kw), runs=20),
            }
            bwd[case] = {
                "ms": cuda_ms(k2), "device_ms": device_seconds(k2) * 1e3,
                "plain_ms": cuda_ms(
                    lambda: plain_window_attention_bwd(q, k, v, do, adj, **kw), runs=10),
            }
        mask = additive.to(dtype)[None, None]
        library = sdpa_ms(q, k, v, do, mask)
        library_device = sdpa_ms(q, k, v, do, mask, timer=device_seconds)
        for kind, cases, lib, lib_device in (("fwd", fwd, library[0], library_device[0]),
                                             ("bwd", bwd, library[1], library_device[1])):
            bound_ms, bound_by = bound(kind, name)
            kernels[kind][name] = {"cases": cases, "library_ms": lib,
                                   "library_device_ms": lib_device, "bound_ms": bound_ms,
                                   "bound_by": bound_by}
    emit("timings", shape=[UNITS, TOKENS, HEAD_DIM], kernels=kernels,
         note="library_ms: scaled_dot_product_attention with the plain adjacency as an "
              "additive mask (its backward as fwd+bwd minus fwd), timed only; device_ms and "
              "library_device_ms: the card's time with its queue kept full "
              "(profiling.device_seconds)")

    results = {}
    for name in ("HWGATE", *BANDED_MODELS):
        for cdt in ("float32", "bfloat16"):
            model = build(name, cdt)
            with torch.inference_mode():
                x = banded_batch(name) if name in BANDED_MODELS else eval_batch()
                ms = cuda_ms(lambda: model(x), runs=20, inner=1)  # one request's forward
            batch = banded_batch(name, train=True) if name in BANDED_MODELS else train_batch()
            step_ms = train_step_ms(model, *batch)
            key = cdt if name == "HWGATE" else f"{name}/{cdt}"
            results[key] = {"forward_ms": ms, "clips_per_s": 16 / ms * 1e3,
                            "train_step_ms": step_ms, "train_clips_per_s": 16 / step_ms * 1e3}
            del model
            torch.cuda.empty_cache()
    emit("eval_train", batch=16, frames=192, results=results)
    return kernels


def build(name: str, cdt: str):
    """The FDMSE-ISL model ``name`` on the card, seeded."""
    if name in BASELINES:
        return baseline_model(name, cdt)
    return flagship(cdt) if name == "HWGATE" else banded_model(name, cdt)


def dense_band_mask(band, frames: int):
    """The (F·V, F·V) additive block-tridiagonal mask of ``band`` that the
    reference's dense attention applies (`WGATE.py:94-104`)."""
    import numpy as np

    nv = band.shape[1]
    m = np.full((frames * nv, frames * nv), -1e4, np.float32)
    for f in range(frames):
        for p, g in ((0, f - 1), (1, f), (2, f + 1)):
            if 0 <= g < frames:
                m[f * nv:(f + 1) * nv, g * nv:(g + 1) * nv] = band[p]
    return m


def banded_bound(kind: str, dtype_name: str, model: str, band) -> tuple[float, str]:
    """(least ms on an H100 SXM, what bounds it) for one banded call at
    ``model``'s shape: q, k, v (and dO) read once and o (f32) or dq, dk, dv
    written once, against the operations this band's edges need (per edge
    two dh-long dots forward, five backward)."""
    planes, frames, joints = BANDED_SHAPE[model]
    elems = planes * frames * joints * BANDED_DH
    elem = 4 if dtype_name == "float32" else 2
    nbytes = elems * (3 * elem + 4) if kind == "fwd" else 7 * elems * elem
    e = band == 0
    edges = planes * (frames * int(e[1].sum()) + (frames - 1) * int(e[0].sum() + e[2].sum()))
    return ms_bound(nbytes, edges * 2 * BANDED_DH * (2 if kind == "fwd" else 5), dtype_name)


def phase_banded_timings() -> dict:
    """Kernel, plain, bound and library ms of the banded kernels at WGATE's
    and GATE's shapes; the kernels under the non-diagonal band beside."""
    import torch
    from torch.nn.attention import SDPBackend

    from sl_hwgat_tpu_torch.ops.banded_attention import (
        banded_attention,
        banded_attention_bwd,
        plain_banded_attention,
        plain_banded_attention_bwd,
    )

    bands = banded_bands()
    out = {"fwd": {}, "bwd": {}}
    for model in BANDED_MODELS:
        band, spatial = bands[model]["identity"], bands[model]["spatial"]
        dense = torch.from_numpy(dense_band_mask(band, BANDED_SHAPE[model][1])).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            name = dtype_name(dtype)
            q, k, v, do = banded_inputs(model, dtype)
            kw = dict(scale=BANDED_SCALE)
            kernel = {
                "fwd": lambda b: lambda: banded_attention(q, k, v, b, **kw),
                "bwd": lambda b: lambda: banded_attention_bwd(q, k, v, do, b, **kw)}
            plain = {
                "fwd": (lambda: plain_banded_attention(q, k, v, band, **kw), 10),
                "bwd": (lambda: plain_banded_attention_bwd(q, k, v, do, band, **kw), 5)}
            # the reference's dense masked attention over the whole F·V
            # sequence, through the memory-efficient backend: the dense score
            # matrix alone would take 15-19 GB
            sdpa = dict(scale=BANDED_SCALE, runs=5, backends=[SDPBackend.EFFICIENT_ATTENTION])
            mask = dense.to(dtype)[None, None]
            library = sdpa_ms(q, k, v, do, mask, **sdpa)
            library_device = sdpa_ms(q, k, v, do, mask, **sdpa, timer=functools.partial(
                device_seconds, calls=2, repeats=3))
            for i, kind in enumerate(("fwd", "bwd")):
                bound_ms, bound_by = banded_bound(kind, name, model, band)
                identity, nondiagonal = kernel[kind](band), kernel[kind](spatial)
                out[kind][f"{model}/{name}"] = {
                    "ms": cuda_ms(identity), "device_ms": device_seconds(identity) * 1e3,
                    "nondiagonal_band_ms": cuda_ms(nondiagonal),
                    "nondiagonal_band_device_ms": device_seconds(nondiagonal) * 1e3,
                    "plain_ms": cuda_ms(plain[kind][0], runs=plain[kind][1]),
                    "library_ms": library[i], "library_device_ms": library_device[i],
                    "bound_ms": bound_ms, "bound_by": bound_by}
            del q, k, v, do
            torch.cuda.empty_cache()
    emit("banded_timings", shapes={m: [*BANDED_SHAPE[m], BANDED_DH] for m in BANDED_MODELS},
         kernels=out,
         note="library_ms: scaled_dot_product_attention (memory-efficient backend) over the "
              "whole F·V sequence with the dense block-tridiagonal additive mask (its backward "
              "as fwd+bwd minus fwd), timed only; nondiagonal_band_ms: the kernel under the "
              "spatial plane as prev/next; *device_ms: the card's time with its queue kept "
              "full (profiling.device_seconds)")
    return out


def device_table(prof, top: int = 12) -> dict:
    """Device time of a profiled region, summed by kernel name. Ranges that
    code annotated (``Optimizer.step#AdamW.step``) span kernels already
    counted and are left out."""
    import torch

    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0)
        if (dev_us and ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    return {"device_ms": total / 1e3,
            "top": [{"kernel": k[:90], "ms": us / 1e3, "calls": c,
                     "share": us / total if total else None}
                    for us, k, c in rows[:top]]}


def phase_profile():
    """Device time by kernel of one eval forward and of one train step, in
    f32 and bf16 (STGCN and DecoupledGCN: f32), of every model and windowed
    path, and in bf16 of the hybrid paths with bf16 scores, with the wall
    time of the profiled step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sl_hwgat_tpu_torch.train.loop import make_steps
    from sl_hwgat_tpu_torch.train.state import make_optimizer

    out = {}
    cases = ([(m, None, {}) for m in ("HWGATE", *BANDED_MODELS, *BASELINES)]
             + [(m, impl, {}) for m, impl in WINDOWED_PATHS]
             + [(m, "hybrid", BF16_SCORES) for m in ("HWGATE", "HGATE")])
    for name, impl, extra in cases:
        # banded_batch("HWGATE") is eval_batch() / train_batch(): same seeds and shapes
        x = banded_batch(name)
        xt, yt, valid = banded_batch(name, train=True)
        cdts = ("float32",) if name in F32_ONLY else ("bfloat16",) if extra else \
            ("float32", "bfloat16")
        for cdt in cdts:
            if impl is None:
                key = cdt if name == "HWGATE" else f"{name}/{cdt}"
                model = build(name, cdt)
            else:
                key = f"{name}/{impl}/{cdt}" + ("/bf16_scores" if extra else "")
                model = windowed_model(name, impl, cdt, **extra)
            with torch.inference_mode():
                model(x)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    model(x)
                    torch.cuda.synchronize()
            out[f"eval/{key}"] = device_table(prof)
            train_step, _ = make_steps(model, make_optimizer("adamw", LR, model.parameters()))
            for step in range(2):
                train_step(xt, yt, valid, SEED, 0, step)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                train_step(xt, yt, valid, SEED, 0, 2)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            out[f"train/{key}"] = {**device_table(prof), "wall_ms_profiled": wall_ms}
            del model, train_step
            torch.cuda.empty_cache()
    emit("profile", batch=16, results=out)


# --- the kernel bench (phases 18-19) ---------------------------------------

PROBE_TILES = UNITS // 4  # the bench's 128-token supertiles
# the bench entries the main path measures: one or two of each family, K10
BENCH_PATH = ("floor_purecopy_bf16", "dmaflr_3stream", "mix_floor", "tsw_floor",
              "xrelay_s0pallas_bf16", "xstrided_s2_bf16", "matmul_only", "matmul_only_bf16",
              "floor_sn256_bf16", "tmq_mm", "mm_nt_bf16", "banded_packed_mm",
              "banded_packed_mm_bf16", "pallas_obf16", "tmq_fused", "tlay_fused", "mix_fused",
              "tmx_fused", "lp_fused_bf16", "pallas_tbwd_bf16", "softmax_only", "hybrid_bf16")
# the subprocess runs of the bench's entry point: one of each family, and K10
BENCH_CLI = ("floor_purecopy_bf16", "xrelay_s0pallas_bf16", "matmul_only_bf16",
             "banded_packed_mm_bf16", "tmq_fused", "softmax_only")
# the forward entries in TPU layouts timed beside their plain versions: one
# of each instantiation, tsw's widened planes and the paired entry's kernel
LAYOUT_TIMED = ("tmq_fused", "tlay_fused", "mix_fused", "tmx_fused", "lp_fused_bf16", "tsw_fused",
                "pair_tscore_bf16")
# the gradient entries in TPU layouts: each layout kernel once a call
LAYOUT_BWD_ENTRIES = ("pallas_tbwd_bf16", "pallas_tsbwd_bf16", "pallas_widebwd_bf16")
K10_SHAPES = {"WGATE": (512, 192, 16), "GATE": (128, 192, 29)}  # planes, frames, joints


def probe_counts() -> dict:
    from sl_hwgat_tpu_torch.ops import probes

    return dict(probes.LAUNCHES)


def launched(kernel: str, fn):
    """fn(), which must launch ``kernel`` at least once."""
    from sl_hwgat_tpu_torch.ops import probes

    before = probes.LAUNCHES[kernel]
    out = fn()
    if probes.LAUNCHES[kernel] <= before:
        raise AssertionError(f"{kernel} was not launched")
    return out


def check(errors: dict, case: str, got, want, *, atol: float = 0.0, rtol: float = 0.0):
    """Record max |got − want| under ``case``; fail where it exceeds
    atol + rtol·|want|."""
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{case}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} "
                             f"{want.dtype}")
    diff = (got.float() - want.float()).abs()
    errors[case] = diff.max().item()
    excess = (diff - atol - rtol * want.float().abs()).max().item()
    if not excess <= 0:
        raise AssertionError(f"{case}: max abs err {errors[case]} (atol {atol}, rtol {rtol})")


def tile_bar(want) -> float:
    """The tile products' bar: 1e-5·max|O| in f32, 4e-3·max|O| for bf16
    inputs (S is rounded to bf16 between the products; another summation
    order can flip one rounding)."""
    return want.float().abs().max().item()


def k10_inputs(model: str, dtype):
    import torch

    planes, frames, joints = K10_SHAPES[model]
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    return [torch.randn(planes, frames * joints, BANDED_DH, generator=g, device="cuda").to(dtype)
            for _ in range(3)]


@contextmanager
def plain_relayouts():
    """The layout maps through plain permutes instead of the relayout kernel."""
    from sl_hwgat_tpu_torch.ops import layouts, probes

    kernel = layouts.relayout
    layouts.relayout = probes.plain_relayout
    try:
        yield
    finally:
        layouts.relayout = kernel


# the layout kernel's instantiations: operand forms by layout, and the
# input types the bench gives them
LAYOUT_KERNEL_CASES = {"t": ("float32", "bfloat16"), "mix": ("bfloat16",),
                       "tmx": ("bfloat16",), "pairs": ("bfloat16",)}


def layout_case(case: str, q, k, v):
    """((q, k, v) views, out view, a function giving out's token-major
    units) of token-major (U, 32, 64) q, k, v laid out as ``case``: "t"
    transposed supertiles (every operand token-contiguous), "mix"/"tmx" the
    mixed probes' streams (o transposed), "pairs" lane pairs (every operand
    feature-contiguous)."""
    import torch

    from sl_hwgat_tpu_torch.ops import layouts

    u, n, dh = q.shape
    if case in layouts.STREAM_SETS:
        views = layouts.stream_set_views(case, *layouts.stream_set(case, q, k, v))
        out = torch.empty((u // 4, dh, 4 * n), dtype=q.dtype, device=q.device)
        return views, layouts.t_view(out), lambda: layouts.t_to_units(out, 4)
    if case == "t":
        out = torch.empty((u // 4, dh, 4 * n), dtype=q.dtype, device=q.device)
        return ([layouts.t_view(layouts.units_to_t(x, 4)) for x in (q, k, v)],
                layouts.t_view(out), lambda: layouts.t_to_units(out, 4))
    out = torch.empty((u // 8, 4 * n, 2 * dh), dtype=q.dtype, device=q.device)
    return ([layouts.pair_view(layouts.pack2(x.reshape(-1, 4 * n, dh))) for x in (q, k, v)],
            layouts.pair_view(out), lambda: layouts.unpack2(out).reshape(u, n, dh))


# the backward layout kernel's instantiations: the layouts it is held on,
# and their types
LAYOUT_BWD_CASES = {"t": ("float32", "bfloat16"), "wide": ("bfloat16",)}


def layout_bwd_maps(case: str, units: int):
    """(token-major (U, 32, 64) → layout storage, storage → unit view) of
    the transposed supertiles ("t") or the widened planes of 8 heads
    ("wide")."""
    from sl_hwgat_tpu_torch.ops import layouts

    if case == "t":
        return (lambda x: layouts.units_to_t(x, 4)), layouts.t_view
    tiles = units // 4

    def lay(x):
        return layouts.widen(x.reshape(tiles, 4 * TOKENS, HEAD_DIM), 8)

    return lay, (lambda x: layouts.wide_view(x, 4 * TOKENS))


def layout_bwd_reference(impl: str, p):
    """A gradient entry's output through K1 and K2 on token-major units taken
    by plain permutes (reshape copies of the entry's views): the same loss,
    its gradient back through the copies into the layout, and for
    pallas_widebwd_bf16 o + the gradient with o put in the layout."""
    import torch

    from sl_hwgat_tpu_torch.bench import kernel as bench
    from sl_hwgat_tpu_torch.ops import window_attention as window_mod

    kt, vt = p.consts
    with torch.enable_grad():
        leaf = p.state.detach().requires_grad_(True)
        units = [p.view(x).reshape(-1, TOKENS, HEAD_DIM).contiguous() for x in (leaf, kt, vt)]
        o = window_mod.window_attention(*units, bench.window_adj(), scale=bench.SCALE, stack=4,
                                        out_dtype=torch.bfloat16)
        (grad,) = torch.autograd.grad((o.float() ** 2).sum(), leaf)
    if impl != "pallas_widebwd_bf16":
        return grad
    o_layout = torch.empty_like(p.state)
    p.view(o_layout).copy_(o.detach().view(p.view(o_layout).shape))
    return o_layout + grad


def unaligned_relayout(randn, dtype):
    """(relayout's C entry point on a (3, 64, 64) transpose whose input starts
    2 bytes past 16-byte alignment, the plain permute of the same input)."""
    import torch

    from sl_hwgat_tpu_torch.ops import probes

    flat = randn(1 + 3 * 64 * 64, dtype=dtype)
    x = flat[1:].view(3, 64, 64)
    out = torch.empty(3, 64, 64, dtype=dtype, device="cuda")
    fn = probes._build.function(probes.KERNEL_RELAYOUT, probes._ARGTYPES[probes.KERNEL_RELAYOUT])
    err = fn(x.data_ptr(), out.data_ptr(), 1, 3, 64, 64, 0, 1, 3, 2, x.element_size(),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise AssertionError(f"relayout refused an unaligned input: cudaError {err}")
    return out, probes.plain_relayout(x, (0, 2, 1))


def launched_of(kernel: str, fn):
    """fn(), which must launch ``kernel`` of the bench's counters once."""
    from sl_hwgat_tpu_torch.bench import kernel as bench

    out, counts = bench.launches_of(fn)
    if counts.get(kernel) != 1:
        raise AssertionError(f"{kernel} was not launched once: {counts}")
    return out


# The float64-anchored bf16 dv check: phase 18's draw (its generator's seed,
# in bench/rounding.py's manner) and seeds 18 and 21, the draws where K2-32
# and its plain version part by one T(A) rounding flip
DV_FLOAT64_SEEDS = (SEED, 18, 21)


def dv_float64_check(adj, masks_: dict) -> dict:
    """Each side's bf16 dV (K2-32, the backward layout kernel on the
    transposed supertiles and the widened planes, the plain version) against
    dV in float64 from the float64 A under the same mask decisions
    (``bench.rounding.dv_float64``), entry by entry at 4e-3 + 1e-2·|dv64| +
    Σᵢ ulp_bf16(A64ᵢⱼ)·|dOᵢ|, on the draws of ``DV_FLOAT64_SEEDS`` (12288 ×
    32 × 64, bf16) under the single mask and the dual mask with pruning at
    u = 0.3. Returns the worst ratio to the bound by draw, mask and side;
    fails if any exceeds 1. The kernel-against-plain bar (phase 4's draw,
    above) is kept as it is."""
    import torch

    from sl_hwgat_tpu_torch.bench import kernel as bench
    from sl_hwgat_tpu_torch.bench import rounding
    from sl_hwgat_tpu_torch.ops import window_attention as window_mod

    out = {}
    for seed in DV_FLOAT64_SEEDS:
        q, k, v, do = rounding.draw(UNITS, seed)
        stores = {}
        with plain_relayouts():
            for case in LAYOUT_BWD_CASES:
                lay, view = layout_bwd_maps(case, UNITS)
                stores[case] = (view, [lay(x) for x in (q, k, v, do)])
        for mask in ("single", "dual_prune"):
            kw = dict(scale=bench.SCALE, stack=4, **masks_[mask])
            dv64, slack = rounding.dv_float64(q, k, do, adj, kw)
            sides = {"K2": window_mod.window_attention_bwd(q, k, v, do, adj, **kw)[2],
                     "plain": window_mod.plain_window_attention_bwd(q, k, v, do, adj, **kw)[2]}
            for case, (view, xs) in stores.items():
                grads = [torch.empty_like(xs[0]) for _ in range(3)]
                window_mod.window_attention_bwd_into(*(view(x) for x in xs), adj,
                                                     dq=view(grads[0]), dk=view(grads[1]),
                                                     dv=view(grads[2]), **kw)
                sides[f"layout_bwd/{case}"] = view(grads[2]).reshape(-1, TOKENS, HEAD_DIM)
            torch.cuda.synchronize()
            for side, dv in sides.items():
                ratio = rounding.dv_bound_ratio(dv, dv64, slack)
                out[f"seed{seed}/{mask}/{side}"] = ratio
                if not ratio <= 1.0:
                    raise AssertionError(f"bf16 dv against float64, seed {seed}, {mask}, {side}: "
                                         f"{ratio} of the bound")
            del dv64, slack, sides
        del q, k, v, do, stores
        torch.cuda.empty_cache()
    return out


def phase_probes() -> dict:
    """Phase 18: the three probe kernels against their plain versions at the
    bench's shapes, f32 and bf16, every mode and layout; K10 at WGATE's and
    GATE's batch-16 shapes; the layout kernels against their plain versions
    and bit for bit against K1 and K2; every entry in TPU layouts one launch
    of each layout kernel it needs and bit for bit against K1 (and K2) on
    token-major inputs taken by plain permutes; softmax_only through
    softmax_probe bit for bit against K7."""
    import torch

    from sl_hwgat_tpu_torch.bench import kernel as bench
    from sl_hwgat_tpu_torch.ops import hybrid_attention, probes
    from sl_hwgat_tpu_torch.ops.banded_attention import banded_packed_mm, plain_banded_packed_mm

    errors = {name: {} for name in (*probes.KERNELS, "fused", "softmax_only")}
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    t, sn, dh = PROBE_TILES, 128, HEAD_DIM
    stream, relay, mm = probes.KERNELS
    f32, bf16 = torch.float32, torch.bfloat16
    for dt in (f32, bf16):
        name = dtype_name(dt)
        x = randn(t, sn, dh, dtype=dt)
        for out in (f32, bf16):  # copy with a type change
            check(errors[stream], f"copy/{name}->{dtype_name(out)}",
                  launched(stream, lambda: probes.stream_copy(x, out)),
                  probes.plain_stream_copy(x, out))
        y, z = randn(t, sn, dh, dtype=dt), randn(t, sn, dh, dtype=dt)
        packed = torch.stack([x, y, z])
        for case, args in (("sum3", (x, y, z)), ("sum3_packed", tuple(packed))):
            check(errors[stream], f"{case}/{name}", launched(stream, lambda: probes.stream_sum3(*args)),
                  probes.plain_stream_sum3(*args))
        # the floors: (SN, DH) tiles in two layouts; model-wide blocks of TG = 16
        xt, yt = randn(t, dh, sn, dtype=dt), randn(t, dh, sn, dtype=dt)
        th = t // 8
        wide = [randn(8, dh, th * sn, dtype=dt) for _ in range(3)]
        tile = dict(view=(t, 1, sn * dh), group_cols=sn * dh)
        floors = {"mix": (xt, x, dict(y=yt, **tile)), "tmx": (xt, x, dict(b=y, **tile)),
                  "tsw": (wide[0], wide[1], dict(b=wide[2], view=(8, dh, th * sn),
                                                  group_cols=16 * sn))}
        for case, (fx, fa, kw) in floors.items():
            got = launched(stream, lambda: probes.stream_floor(fx, fa, out_dtype=dt, **kw))
            want = probes.plain_stream_floor(fx, fa, out_dtype=dt, **kw)
            # f32 sums of 8192+ terms in another order: one output ulp, or
            # 1e-5·max|o| where a sum nearly cancels
            check(errors[stream], f"floor_{case}/{name}", got, want,
                  atol=1e-5 * want.float().abs().max().item(),
                  rtol=2.0**-7 if dt == bf16 else 1e-5)
        # relayouts, bit for bit: row gathers and transposes at the bench's
        # sizes (its tiles both ways, the supertiles, the widened planes,
        # GATE's and the packedpre entries' banded planes both ways), sizes
        # that end inside a block transpose's tile, sizes it does not take
        # (the shared-memory tiles), and an input 2 bytes past 16-byte
        # alignment (the C entry point: the wrapper takes aligned tensors)
        for shape, perm in (((6144, 32, 2, dh), (0, 2, 1, 3)), ((6144, 32, 2, dh), (2, 0, 1, 3)),
                            ((1536, 32, 8, dh), (0, 2, 1, 3)), ((1536, 32, 8, dh), (2, 0, 1, 3)),
                            ((t, sn, dh), (0, 2, 1)), ((t, dh, sn), (0, 2, 1)),
                            ((t, dh, 4, 32), (0, 2, 3, 1)), ((t, 4, 32, dh), (0, 3, 1, 2)),
                            ((8, th, sn, dh), (0, 3, 1, 2)), ((8, dh, th, sn), (0, 2, 3, 1)),
                            ((128, 5568, 16), (0, 2, 1)), ((128, 6144, 16), (0, 2, 1)),
                            ((128, 16, 6144), (0, 2, 1)), ((5, 40, 24), (0, 2, 1)),
                            ((3, 8, 200), (0, 2, 1)), ((6, 10, 16, 24), (0, 3, 1, 2)),
                            ((2, 36, 12), (0, 2, 1)), ((7, 33, 5, 3), (3, 1, 0, 2)),
                            ((7, 33, 5, 3), (1, 0, 2, 3)), ((3, 5, 7), (2, 0, 1))):
            a = randn(*shape, dtype=dt)
            check(errors[relay], f"{'x'.join(map(str, shape))}/{perm}/{name}",
                  launched(relay, lambda: probes.relayout(a, perm)), probes.plain_relayout(a, perm))
        check(errors[relay], f"unaligned/3x64x64/(0, 2, 1)/{name}", *unaligned_relayout(randn, dt))
        # tile products in the probes' layouts
        x128 = randn(t, sn, 128, dtype=dt)
        first = x.view(t // 16, 16, sn, dh)[:, :1].expand(-1, 16, -1, -1)
        tr = randn(t, dh, sn, dtype=dt).view(1, t, dh, sn).transpose(2, 3)
        out_t = torch.empty(t, dh, sn, dtype=dt, device="cuda")
        x256 = x.view(1, t // 2, 256, dh)
        cases = {
            "matmul_only": ((x[None], x[None], x[None]), {}, f32),
            "matmul_k128": ((x128[None], x128[None], x128[None]), {}, f32),
            "sn256": ((x256, x256, x256), {}, dt),
            "dot1": ((x[None], x[None]), {"cols": dh}, f32),
            "bigm": ((x.view(t // 16, 16, sn, dh), first), {"cols": dh}, f32),
            "transposed": ((tr, tr, tr), {"out": out_t.view(1, t, dh, sn).transpose(2, 3)}, dt),
        }
        for case, (ops, kw, out_dtype) in cases.items():
            got = launched(mm, lambda: probes.tile_matmul(*ops, out_dtype=out_dtype, **kw))
            if "out" in kw:
                got = out_t.clone()
            want = probes.plain_tile_matmul(*ops, cols=kw.get("cols"), out_dtype=out_dtype)
            want = want.reshape(got.shape) if "out" not in kw else \
                want.view(t, sn, dh).transpose(1, 2).contiguous()
            scale = 4e-3 if dt == bf16 else 1e-5
            check(errors[mm], f"{case}/{name}", got, want, atol=scale * tile_bar(want))
        # K10 at WGATE's and GATE's batch-16 shapes
        for model, (_, _, joints) in K10_SHAPES.items():
            q, k, v = k10_inputs(model, dt)
            for out_dtype in {f32, dt}:
                got = launched(mm, lambda: banded_packed_mm(q, k, v, joints=joints,
                                                            out_dtype=out_dtype))
                want = plain_banded_packed_mm(q, k, v, joints=joints, out_dtype=out_dtype)
                scale = 4e-3 if dt == bf16 else 1e-5
                check(errors[mm], f"K10/{model}/{name}->{dtype_name(out_dtype)}", got, want,
                      atol=scale * tile_bar(want))
        del x, y, z, packed, xt, yt, wide, x128, first, tr, out_t
        torch.cuda.empty_cache()

    # the layout kernel and softmax_blocks against their plain versions
    # (1e-5 in f32, 4e-3·max|O| in bf16; 1e-5), the layout kernel also bit
    # for bit against K1 on the token-major units: every instantiation,
    # single mask, dual mask with pruning, and an explicit sel
    from sl_hwgat_tpu_torch.ops import layouts
    from sl_hwgat_tpu_torch.ops import window_attention as window_mod

    layout = window_mod.KERNEL_LAYOUT
    errors[layout], errors[hybrid_attention.KERNEL_BLOCKS] = {}, {}
    adj = bench.window_adj()
    units = UNITS  # the bench's shapes: 3072 supertiles, 384 temporal groups of 32 units
    masks = {"single": {}, "dual_prune": dict(tail_adj=bench.dual_tail(adj), units_per_group=32,
                                              groups=3, prune_u=0.3),
             "sel": dict(tail_adj=bench.dual_tail(adj), units_per_group=32, groups=3,
                         sel=(torch.arange(units // 4, device="cuda") % 3 == 1).int())}
    for case, dtypes in LAYOUT_KERNEL_CASES.items():
        for dt in (getattr(torch, name) for name in dtypes):
            q, k, v = (randn(units, TOKENS, HEAD_DIM, dtype=dt) for _ in range(3))
            for mask, kw in masks.items():
                kw = dict(scale=bench.SCALE, stack=4, **kw)
                views, out, back = layout_case(case, q, k, v)
                launched_layout = window_mod.window_attention_into.launches
                window_mod.window_attention_into(*views, adj, out=out, **kw)
                if window_mod.window_attention_into.launches != launched_layout + 1:
                    raise AssertionError(f"{case}: the layout kernel was not launched once")
                got = back()
                name = f"{case}/{mask}/{dtype_name(dt)}"
                want = window_mod.plain_window_attention(q, k, v, adj, out_dtype=dt, **kw)
                check(errors[layout], name, got, want,
                      atol=(4e-3 * tile_bar(want)) if dt == bf16 else 1e-5)
                check(errors[layout], f"K1/{name}", got,
                      window_mod.window_attention(q, k, v, adj, out_dtype=dt, **kw))
    # the backward layout kernel bit for bit against K2 on the token-major
    # units and against its plain version (2e-5 in f32, 4e-3 + 1e-2·|x| in
    # bf16) on phase 4's seeded inputs (attention_inputs, output_grad: the
    # data K2 is held on at the same bar): each instantiation (every operand
    # transposed, f32 and bf16) on the transposed supertiles and, in bf16,
    # the widened planes, under the masks above; layouts by plain permutes
    layout_bwd = window_mod.KERNEL_LAYOUT_BWD
    errors[layout_bwd] = {}
    for case, dtypes in LAYOUT_BWD_CASES.items():
        lay, view = layout_bwd_maps(case, units)
        for dt in (getattr(torch, name) for name in dtypes):
            q, k, v = attention_inputs(dt)
            do = output_grad(dt)
            with plain_relayouts():
                stores = [lay(x) for x in (q, k, v, do)]
            for mask, kw in masks.items():
                kw = dict(scale=bench.SCALE, stack=4, **kw)
                grads = [torch.empty_like(stores[0]) for _ in range(3)]
                launched_bwd = window_mod.window_attention_bwd_into.launches
                window_mod.window_attention_bwd_into(*(view(x) for x in stores), adj,
                                                     dq=view(grads[0]), dk=view(grads[1]),
                                                     dv=view(grads[2]), **kw)
                if window_mod.window_attention_bwd_into.launches != launched_bwd + 1:
                    raise AssertionError(f"{case}: the backward layout kernel was not launched once")
                want = window_mod.plain_window_attention_bwd(q, k, v, do, adj, **kw)
                k2 = window_mod.window_attention_bwd(q, k, v, do, adj, **kw)
                name = f"{case}/{mask}/{dtype_name(dt)}"
                for part, grad, w, w2 in zip(("dq", "dk", "dv"), grads, want, k2):
                    got = view(grad).reshape(-1, TOKENS, HEAD_DIM)
                    check(errors[layout_bwd], f"K2/{name}/{part}", got, w2)
                    check(errors[layout_bwd], f"{name}/{part}", got, w, **BWD_TOL[dtype_name(dt)])
                del grads, want, k2
            del do, stores
            torch.cuda.empty_cache()
    dv_float64 = dv_float64_check(adj, masks)
    x = randn(t, sn, dh)
    blocks = hybrid_attention.KERNEL_BLOCKS
    check(errors[blocks], "softmax_only_tiles",
          launched_of(blocks, lambda: hybrid_attention.softmax_blocks(x, adj)),
          hybrid_attention.plain_softmax_blocks(x, adj), atol=1e-5)
    del q, k, v, x
    torch.cuda.empty_cache()

    # the forward entries in TPU layouts: one launch of the layout kernel, no
    # relayout, o bit for bit K1's on the views' units taken by plain
    # permutes (reshape copies), and within the bar of its plain version
    for impl in bench.LAYOUT_ENTRIES:
        p = bench.inputs(impl, UNITS, device="cuda")
        with torch.no_grad():
            _, counts = bench.launches_of(lambda: p.body(p.state))
            if counts != {layout: 1}:
                raise AssertionError(f"{impl}: launched {counts}, not the layout kernel once")
            ((q, k, v, adj_), kw), = p.into_call
            kw = dict(kw)
            o = kw.pop("out").reshape(-1, TOKENS, HEAD_DIM)
            units_ = [z.reshape(-1, TOKENS, HEAD_DIM).contiguous() for z in (q, k, v)]
            want = window_mod.window_attention(*units_, adj_, out_dtype=o.dtype, **kw)
            plain = window_mod.plain_window_attention(*units_, adj_, out_dtype=o.dtype, **kw)
        check(errors["fused"], impl, o, want)
        check(errors[layout], f"plain/{impl}", o, plain,
              atol=(4e-3 * tile_bar(plain)) if o.dtype == bf16 else 1e-5)
        del p, q, k, v, o, units_, want, plain
    # the gradient entries in TPU layouts: one launch of each layout kernel
    # and no other, bit for bit against K1 and K2 on plainly permuted inputs
    for impl in LAYOUT_BWD_ENTRIES:
        p = bench.inputs(impl, UNITS, device="cuda")
        with torch.no_grad():
            got, counts = bench.launches_of(lambda: p.body(p.state))
        if counts != {layout: 1, layout_bwd: 1}:
            raise AssertionError(f"{impl}: launched {counts}, not each layout kernel once")
        check(errors["fused"], impl, got, layout_bwd_reference(impl, p))
        del p, got
    torch.cuda.empty_cache()
    # softmax_only: one launch of softmax_probe, P bit for bit K7's on the
    # gathered unit blocks
    p = bench.inputs("softmax_only", UNITS, device="cuda")
    with torch.no_grad():
        got, counts = bench.launches_of(lambda: p.body(p.state))
        if counts != {blocks: 1}:
            raise AssertionError(f"softmax_only: launched {counts}, not {blocks} once")
        want = hybrid_attention.plain_softmax_blocks(
            p.state.reshape(t, sn, dh), adj, softmax=hybrid_attention.masked_softmax)
    check(errors["softmax_only"], "softmax_only", got, want.reshape(got.shape))
    del p, got, want
    torch.cuda.empty_cache()
    emit("probes", tiles=[t, sn, dh], k10_shapes={m: list(s) for m, s in K10_SHAPES.items()},
         max_abs_err=errors, launches=probe_counts(), dv_float64=dv_float64,
         dv_float64_worst_ratio=max(dv_float64.values()),
         note="stream and relayout bit for bit; floors one output ulp; tile products and K10 "
              "1e-5 / 4e-3 x max|O|; the layout kernel 1e-5 / 4e-3 x max|O| against its plain "
              "version and bit for bit against K1; the backward layout kernel 2e-5 / 4e-3 + "
              "1e-2 |x| against its plain version and bit for bit against K2; softmax_blocks "
              "1e-5 against its plain version; every forward entry in TPU layouts bit for bit "
              "against K1 and every gradient entry against K1 + K2 on plainly permuted inputs; "
              "softmax_only bit for bit against K7 on the gathered blocks; dv_float64: the "
              "worst |dv - dv64| / (4e-3 + 1e-2 |dv64| + sum_i ulp_bf16(A64_ij) |dO_i|) of "
              "K2-32, the backward layout kernel and the plain version, by draw and mask")
    errors["dv_float64"] = dv_float64
    return errors


def phase_bench_path() -> dict:
    """Main path 11: the kernel bench's ``measure`` (what its command line
    runs) over one or two entries of each family and K10, counts reset just
    before and read just after; every one of the three probe kernels, K1,
    the layout kernel (each of its instantiations), the backward layout
    kernel (``pallas_tbwd_bf16``), softmax_probe and K7 (``hybrid_bf16``)
    launched."""
    import torch

    from sl_hwgat_tpu_torch.bench import kernel as bench

    bench.reset_launches()
    records = {}
    for impl in BENCH_PATH:
        rec = bench.measure(impl, UNITS, repeats=3, inner=5)
        records[impl] = {k: rec[k] for k in ("time_us", "device_us", "bound_us", "bound_by",
                                             "launches")}
    counts = bench.launches()
    from sl_hwgat_tpu_torch.ops import hybrid_attention, probes, window_attention

    for kernel in (*probes.KERNELS, window_attention.KERNEL, window_attention.KERNEL_LAYOUT,
                   window_attention.KERNEL_LAYOUT_BWD, hybrid_attention.KERNEL_BLOCKS,
                   hybrid_attention.KERNEL):
        if not counts.get(kernel):
            raise AssertionError(f"the bench path never launched {kernel}")
    torch.cuda.empty_cache()
    emit("bench_path", units=UNITS, entries=records, launches=counts)
    return counts


def phase_bench_cli(repo: Path) -> list:
    """Phase 19: ``python -m sl_hwgat_tpu_torch.bench.kernel <impl>`` for one
    entry of each family and K10, one child after another so that each has
    the card to itself, then ``python -m sl_hwgat_tpu_torch.bench.run``;
    each must print its line, the run's must come from ``pallas_obf16``, and
    its ``vs_calib`` must be the ``pair_tscore_bf16`` child's paired ratio.
    Returns bench.run's two HWGATE step lines (printed as they are)."""
    lines, seconds = {}, {}
    for impl in BENCH_CLI:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "sl_hwgat_tpu_torch.bench.kernel", impl, str(UNITS),
             "--repeats", "1"], cwd=repo, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"bench.kernel {impl} exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        if rec["impl"] != impl or rec["device"]["platform"] != "gpu" or "bound_us" not in rec:
            raise AssertionError(f"bench.kernel {impl}: unexpected line {rec}")
        lines[impl] = {k: rec[k] for k in ("time_us", "spread_pct", "device_us", "bound_us",
                                           "bound_by")}
        seconds[impl] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "sl_hwgat_tpu_torch.bench.run"], cwd=repo,
                         capture_output=True, text=True, timeout=900)
    seconds["bench.run"] = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"bench.run exited {run.returncode}: {run.stderr[-2000:]}")
    metric = json.loads(run.stdout.strip().splitlines()[-1])
    for key in ("metric", "value", "unit", "vs_baseline"):
        if key not in metric:
            raise AssertionError(f"bench.run: no {key} in {metric}")
    if metric["config"] != "fused_bf16_obf16":
        raise AssertionError(f"bench.run measured {metric['config']}, not fused_bf16_obf16")
    # vs_calib is the paired child's median ratio, inside its [min, max]
    note = run.stderr.strip().splitlines()[-1:]
    paired = re.search(r"vs_calib (\S+) \[(\S+), (\S+)\] \(pair_tscore_bf16:", note[0] if note
                       else "")
    if paired is None:
        raise AssertionError(f"bench.run named no paired calibration: {note}")
    ratio, low, high = map(float, paired.groups())
    if not (metric["vs_calib"] == ratio and low <= ratio <= high):
        raise AssertionError(f"bench.run: vs_calib {metric['vs_calib']} is not the paired "
                             f"child's ratio {ratio} [{low}, {high}]")
    steps = [json.loads(ln) for ln in run.stderr.splitlines() if ln.startswith("{")]
    if [line.get("metric") for line in steps] != ["hwgate_train_step_clips_per_sec",
                                                  "hwgate_eval_step_clips_per_sec"]:
        raise AssertionError(f"bench.run: step lines {steps}")
    for line in steps:
        print(json.dumps(line), flush=True)
    emit("bench_cli", lines=lines, run=metric, run_note=note, seconds=seconds,
         vs_calib_from="pair_tscore_bf16", vs_calib_range=[low, high])
    return steps


def phase_probe_timings() -> dict:
    """Kernel, plain, bound and library ms of the three probe kernels at the
    bench's shapes: the bf16 copy (library ``Tensor.copy_``), the relayout
    (library ``permute(...).contiguous()``, which is also the plain
    version), the tile products (library: two ``torch.bmm``) and K10 at
    WGATE's and GATE's shapes; beside the CUDA-event ms, the kernel's and
    the library call's device ms (``profiling.device_seconds``) and the
    wrapper's host ms per call."""
    import torch

    from sl_hwgat_tpu_torch.ops import probes
    from sl_hwgat_tpu_torch.ops.banded_attention import (
        banded_packed_mm,
        packed_frames_per_tile,
        plain_banded_packed_mm,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED)
    t, sn, dh = PROBE_TILES, 128, HEAD_DIM
    f32, bf16 = torch.float32, torch.bfloat16
    out = {}

    def host_ms(fn, calls: int = 100) -> float:
        """Host ms per call of ``fn`` with the card's queue never empty: what
        the wrapper's host path costs a launch."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        seconds = time.perf_counter() - t0
        torch.cuda.synchronize()
        return seconds / calls * 1e3

    def row(fn, plain, library, nbytes, flops, dtype, plain_runs=30):
        """CUDA-event ms of the kernel, its plain version and the library
        call; the kernel's and the library call's device ms (the card's
        queue kept full: without the host's launch gaps, which the events of
        a short kernel include) and the wrapper's host ms."""
        bound_ms, by = ms_bound(nbytes, flops, dtype)
        return {"ms": cuda_ms(fn), "device_ms": device_seconds(fn) * 1e3, "host_ms": host_ms(fn),
                "plain_ms": cuda_ms(plain, runs=plain_runs),
                "library_ms": cuda_ms(library) if library else None,
                "library_device_ms": device_seconds(library) * 1e3 if library else None,
                "bound_ms": bound_ms, "bound_by": by}

    # stream_probe
    x = torch.randn(t, sn, dh, generator=g, device="cuda").to(bf16)
    y, z = (torch.randn(t, sn, dh, generator=g, device="cuda").to(bf16) for _ in range(2))
    xt, yt = (torch.randn(t, dh, sn, generator=g, device="cuda").to(bf16) for _ in range(2))
    dst = torch.empty_like(x)
    dst32 = torch.empty(x.shape, device="cuda")
    n = x.nbytes
    tile = dict(view=(t, 1, sn * dh), group_cols=sn * dh, out_dtype=bf16)
    out["stream_probe"] = {
        "copy_bf16": row(lambda: probes.stream_copy(x, bf16),
                         lambda: probes.plain_stream_copy(x, bf16), lambda: dst.copy_(x), 2 * n,
                         0, "bfloat16"),
        "copy_bf16_to_f32": row(lambda: probes.stream_copy(x, f32),
                                lambda: probes.plain_stream_copy(x, f32),
                                lambda: dst32.copy_(x), 3 * n, 0, "bfloat16"),
        "sum3_bf16": row(lambda: probes.stream_sum3(x, y, z),
                         lambda: probes.plain_stream_sum3(x, y, z), None, 4 * n, 0, "bfloat16"),
        "floor_mix_bf16": row(lambda: probes.stream_floor(xt, x, y=yt, **tile),
                              lambda: probes.plain_stream_floor(xt, x, y=yt, **tile), None, 4 * n,
                              0, "bfloat16"),
    }
    # relayout: the bench's gathers and transposes (its tiles both ways, f32
    # too, and the packedpre entries' banded planes both ways)
    r0 = torch.randn(6144, 32, 2, dh, generator=g, device="cuda").to(bf16)
    x32 = torch.randn(t, sn, dh, generator=g, device="cuda")
    planes = torch.randn(128, 6144, 16, generator=g, device="cuda").to(bf16)
    packed = torch.randn(128, 16, 6144, generator=g, device="cuda").to(bf16)
    out["relayout"] = {
        "xrelay_s0_bf16": row(lambda: probes.relayout(r0, (0, 2, 1, 3)),
                              lambda: probes.plain_relayout(r0, (0, 2, 1, 3)),
                              lambda: r0.permute(0, 2, 1, 3).contiguous(), 2 * r0.nbytes, 0,
                              "bfloat16"),
        "xstrided_s0_bf16": row(lambda: probes.relayout(r0, (2, 0, 1, 3)),
                                lambda: probes.plain_relayout(r0, (2, 0, 1, 3)),
                                lambda: r0.permute(2, 0, 1, 3).contiguous(), 2 * r0.nbytes, 0,
                                "bfloat16"),
        "transpose_bf16": row(lambda: probes.relayout(x, (0, 2, 1)),
                              lambda: probes.plain_relayout(x, (0, 2, 1)),
                              lambda: x.permute(0, 2, 1).contiguous(), 2 * n, 0, "bfloat16"),
        "transpose_back_bf16": row(lambda: probes.relayout(xt, (0, 2, 1)),
                                   lambda: probes.plain_relayout(xt, (0, 2, 1)),
                                   lambda: xt.permute(0, 2, 1).contiguous(), 2 * n, 0,
                                   "bfloat16"),
        "transpose_f32": row(lambda: probes.relayout(x32, (0, 2, 1)),
                             lambda: probes.plain_relayout(x32, (0, 2, 1)),
                             lambda: x32.permute(0, 2, 1).contiguous(), 2 * x32.nbytes, 0,
                             "float32"),
        "pack_plane_bf16": row(lambda: probes.relayout(planes, (0, 2, 1)),
                               lambda: probes.plain_relayout(planes, (0, 2, 1)),
                               lambda: planes.permute(0, 2, 1).contiguous(), 2 * planes.nbytes,
                               0, "bfloat16"),
        "unpack_plane_bf16": row(lambda: probes.relayout(packed, (0, 2, 1)),
                                 lambda: probes.plain_relayout(packed, (0, 2, 1)),
                                 lambda: packed.permute(0, 2, 1).contiguous(), 2 * packed.nbytes,
                                 0, "bfloat16"),
    }
    del r0, y, z, xt, yt, dst, dst32, x32, planes, packed
    # tile_matmul: matmul_only's products, then K10
    mm = {}
    for dt in (f32, bf16):
        a = torch.randn(t, sn, dh, generator=g, device="cuda").to(dt)
        a4 = a[None]
        flops = t * 4.0 * sn * sn * dh
        mm[f"matmul_only/{dtype_name(dt)}"] = row(
            lambda: probes.tile_matmul(a4, a4, a4), lambda: probes.plain_tile_matmul(a4, a4, a4),
            lambda: torch.bmm(torch.bmm(a, a.transpose(1, 2)), a), a.nbytes + t * sn * dh * 4,
            flops, dtype_name(dt), plain_runs=10)
        for model, (planes, frames, joints) in K10_SHAPES.items():
            q, k, v = k10_inputs(model, dt)
            rows = packed_frames_per_tile(joints) * joints  # 128 or 116 tokens a tile
            qb, kb, vb = (u.view(-1, rows, BANDED_DH) for u in (q, k, v))
            flops = qb.shape[0] * 4.0 * rows * rows * BANDED_DH
            mm[f"K10/{model}/{dtype_name(dt)}"] = row(
                lambda: banded_packed_mm(q, k, v, joints=joints),
                lambda: plain_banded_packed_mm(q, k, v, joints=joints),
                lambda: torch.bmm(torch.bmm(qb, kb.transpose(1, 2)), vb),
                3 * q.nbytes + q.numel() * 4, flops, dtype_name(dt), plain_runs=10)
            del q, k, v, qb, kb, vb
        del a, a4
    out["tile_matmul"] = mm
    # the layout kernel on the bench's forward entries in TPU layouts, and
    # softmax_probe on softmax_only's tiles. Library yardsticks, timed only:
    # masked SDPA on the same q, k, v token-major (no layout: it cannot
    # read them) in the entry's type; torch.softmax over the masked unit
    # blocks (it writes P of the blocks, not the 100.7 MB output tile)
    from sl_hwgat_tpu_torch.bench import kernel as bench
    from sl_hwgat_tpu_torch.ops import hybrid_attention
    from sl_hwgat_tpu_torch.ops import window_attention as window_mod
    from sl_hwgat_tpu_torch.ops.attention import masked_scores, unit_allowed

    adj = bench.window_adj()
    d = bench.draws("tmq_fused", UNITS)
    sdpa = {}
    for dt in (f32, bf16):
        q, k, v = (torch.from_numpy(d[name]).cuda().to(dt)[:, None] for name in "qkv")
        additive = torch.where(torch.from_numpy(adj) != 0, 0.0, -1e4).cuda().to(dt)[None, None]

        def library():
            return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=additive,
                                                                    scale=bench.SCALE)

        with torch.no_grad():
            sdpa[dt] = {"library_ms": cuda_ms(library),
                        "library_device_ms": device_seconds(library) * 1e3}
        del q, k, v, additive
    layout = {}
    for impl in LAYOUT_TIMED:
        p = bench.inputs(impl, UNITS, device="cuda")
        with torch.no_grad():
            p.body(p.state)
        ((qv, kv, vv, adj_), kw), = p.into_call
        kw = dict(kw)
        o = kw.pop("out")
        units = [z.reshape(-1, TOKENS, HEAD_DIM) for z in (qv, kv, vv)]
        dt = p.state.dtype
        nbytes = p.state.nbytes + sum(c.nbytes for c in p.consts) + o.nbytes  # tlay: q = k = v
        with torch.no_grad():
            layout[impl] = {**row(lambda: p.body(p.state),
                                  lambda: window_mod.plain_window_attention(
                                      *units, adj_, out_dtype=o.dtype, **kw),
                                  None, nbytes, p.flops, dtype_name(dt), plain_runs=5),
                            **sdpa[dt]}
        del p, o, units
        torch.cuda.empty_cache()
    out[window_mod.KERNEL_LAYOUT] = layout
    p = bench.inputs("softmax_only", UNITS, device="cuda")
    x3 = p.state.reshape(-1, 128, HEAD_DIM)
    blocks = torch.stack([x3[:, :TOKENS, :TOKENS], x3[:, TOKENS:2 * TOKENS, TOKENS:2 * TOKENS]],
                         1).reshape(-1, TOKENS, TOKENS)
    masked = masked_scores(blocks, unit_allowed(adj, None, None, blocks.shape[0], 2, "cuda"),
                           zero_quirk=True, prune_u=None)
    with torch.no_grad():
        out[hybrid_attention.KERNEL_BLOCKS] = {"softmax_only": row(
            lambda: hybrid_attention.softmax_blocks(x3, adj),
            lambda: hybrid_attention.plain_softmax_blocks(x3, adj),
            lambda: torch.softmax(masked, -1), blocks.nbytes + x3.nbytes, 0, "float32")}
    del p, x3, blocks, masked
    torch.cuda.empty_cache()
    out[window_mod.KERNEL_LAYOUT_BWD] = layout_bwd_timings(row, d)
    emit("probe_timings", kernels=out,
         note="library_ms, timed only: Tensor.copy_ into a preallocated tensor (stream), "
              "permute(...).contiguous() (relayout; also its plain version), two torch.bmm "
              "calls (tile products and K10; f32 sums, the operands' type out, so in bf16 "
              "S and O are bf16); window_attention_layout: masked "
              "scaled_dot_product_attention on the entry's q, k, v token-major, in its type "
              "(it reads no TPU layout); softmax_probe: torch.softmax over the masked unit "
              "blocks (P of the blocks only: it writes no zeros); window_attention_layout_bwd: "
              "masked SDPA's backward alone ((fwd + bwd) - fwd) on the same units token-major, "
              "and for the gradient entries masked SDPA's forward, the same loss and its "
              "backward. Bounds: each input byte read once and each output byte written once "
              "(softmax_probe: the two blocks read, the whole tile written; a gradient entry: "
              "the two layout kernels' 11 streams)")
    return out


def layout_bwd_timings(row, d) -> dict:
    """The backward layout kernel alone on the gradient entries' (U, dh, N)
    transposed units at the bench's 12288 units, f32 and bf16: card, events
    and host ms, its plain version, K2 on the same units token-major, its
    bound (7 streams once) and masked SDPA's backward alone on the same units
    token-major ((fwd + bwd) − fwd, timed only). Then each gradient entry's
    card and events ms beside the like-for-like library call (masked SDPA's
    forward, the same loss, its backward, token-major bf16) and the two
    layout kernels' bound (11 streams), and a profile of one entry's calls:
    the two layout kernels' card time beside the loss's torch passes."""
    import torch

    from sl_hwgat_tpu_torch.bench import kernel as bench
    from sl_hwgat_tpu_torch.ops import layouts
    from sl_hwgat_tpu_torch.ops import window_attention as window_mod

    adj = bench.window_adj()
    kw = dict(scale=bench.SCALE, stack=4)
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    additive = torch.where(torch.from_numpy(adj) != 0, 0.0, -1e4).cuda()
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.from_numpy(d[name]).cuda().to(dt) for name in "qkv")
        do = torch.randn(q.shape, generator=g, device="cuda").to(dt)
        stores = [x.transpose(1, 2).contiguous() for x in (q, k, v, do)]  # (U, dh, N)
        grads = [torch.empty_like(stores[0]) for _ in range(3)]
        views = [layouts.t_view(x) for x in stores]
        dviews = dict(zip(("dq", "dk", "dv"), (layouts.t_view(x) for x in grads)))

        def kernel():
            return window_mod.window_attention_bwd_into(*views, adj, **dviews, **kw)

        with torch.no_grad():
            timings = row(kernel, lambda: window_mod.plain_window_attention_bwd(
                q, k, v, do, adj, **kw), None, 7 * q.nbytes, _win_bwd_flops(q), dtype_name(dt),
                plain_runs=5)
            timings["k2_device_ms"] = device_seconds(
                lambda: window_mod.window_attention_bwd(q, k, v, do, adj, **kw)) * 1e3
        mask = additive.to(dt)[None, None]
        lib = sdpa_ms(q, k, v, do, mask, scale=bench.SCALE)
        lib_device = sdpa_ms(q, k, v, do, mask, scale=bench.SCALE, timer=device_seconds)
        timings.update(library_ms=lib[1], library_device_ms=lib_device[1],
                       library_fwd_ms=lib[0], library_fwd_device_ms=lib_device[0])
        out[dtype_name(dt)] = timings
        del q, k, v, do, stores, grads, views, dviews
        torch.cuda.empty_cache()

    # the gradient entries, and masked SDPA's forward + the same loss + its
    # backward on the same q, k, v token-major (bf16)
    entries = {}
    q, k, v = (torch.from_numpy(d[name]).cuda().to(torch.bfloat16)[:, None] for name in "qkv")
    mask = additive.to(torch.bfloat16)[None, None]

    def sdpa_entry():
        with torch.enable_grad():
            leaf = q.detach().requires_grad_(True)
            o = torch.nn.functional.scaled_dot_product_attention(leaf, k, v, attn_mask=mask,
                                                                 scale=bench.SCALE)
            return torch.autograd.grad((o.float() ** 2).sum(), leaf)[0]

    entries["library"] = {"ms": cuda_ms(sdpa_entry, runs=10),
                          "device_ms": device_seconds(sdpa_entry) * 1e3,
                          "what": "masked SDPA forward, (o.float()**2).sum(), its backward"}
    del q, k, v
    for impl in LAYOUT_BWD_ENTRIES:
        p = bench.inputs(impl, UNITS, device="cuda")
        bound_ms, by = ms_bound(11 * p.state.nbytes, _win_bwd_flops(p.state, 7), "bfloat16")
        with torch.no_grad():
            entries[impl] = {"ms": cuda_ms(lambda: p.body(p.state), runs=10),
                             "device_ms": device_seconds(lambda: p.body(p.state)) * 1e3,
                             "bound_ms": bound_ms, "bound_by": by}
            if impl == LAYOUT_BWD_ENTRIES[0]:
                calls = 5
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CPU,
                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                    for _ in range(calls):
                        p.body(p.state)
                    torch.cuda.synchronize()
                entries[f"profile/{impl}"] = {"calls": calls, **device_table(prof)}
        del p
        torch.cuda.empty_cache()
    out["entries"] = entries
    return out


def _win_bwd_flops(x, products: int = 5) -> float:
    """Operations of ``products`` 32 × 32 × 64 products on each of x's units
    of 32 tokens × dh 64: 5 for the backward (the recomputed scores, dA, dQ,
    dV, dK), 7 for a forward and backward."""
    return x.numel() // (TOKENS * HEAD_DIM) * products * 2.0 * TOKENS * TOKENS * HEAD_DIM


def probe_entry(name: str, replaces: str, launches: int, timings: dict, top: str,
                errors: dict) -> dict:
    """One entry of the kernels line for a probe kernel: the ``top`` case's
    numbers at the top level, the others under their case."""
    entry = {"name": name, "route": "cuda", "source": f"sl_hwgat_tpu_torch/csrc/{name}.cu",
             "replaces": replaces, "launches": launches}
    for case, t in timings.items():
        if case == top:
            entry.update(t, kernel_ms=t["ms"], max_abs_err=max(errors.values()))
        else:
            entry[case] = t
    return entry


STREAM_REPLACES = ("bench_kernel.py:450 (floor_copy, floor_slab, floor_pure*), :515 (tlay_copy), "
                   ":593 (mix_floor), :685 (tmx_floor), :805 (tmq_floor), :951 (tsw_floor), "
                   ":1045 (dmaflr_hbm), :1066 (dmaflr_3stream), :1090 (dmaflr_qkvpack), "
                   ":1181 (xstrided_ref)")
RELAYOUT_REPLACES = "bench_kernel.py:1138 (xrelay_s0pallas, xrelay_s2pallas), :1201 (xstrided_s0, xstrided_s2)"
MATMUL_REPLACES = ("bench_kernel.py:381 (mm_*), :450 (floor_dot1slim, floor_bigm, floor_sn256), "
                   ":515 (tlay_mm), :593 (mix_mm), :685 (tmx_mm), :805 (tmq_mm, tmq_bmm), "
                   ":1248 (matmul_only, matmul_k128, matmul_only_bf16); "
                   "sl_hwgat_tpu/ops/pallas_banded.py:395 (_fwd_kernel_packed_mm, K10)")
LAYOUT_BWD_REPLACES = ("sl_hwgat_tpu/ops/pallas_attention.py:386 (_bwd_kernel_t), :704 "
                       "(_bwd_kernel_ts), :466 (_bwd_kernel_ts_batched), :526 (_bwd_kernel_wide), "
                       ":598 (_bwd_kernel_wide_batched); bench_kernel.py:249-305 "
                       "(pallas_tbwd_bf16, pallas_tsbwd_bf16, pallas_widebwd_bf16)")
LAYOUT_REPLACES = ("sl_hwgat_tpu/ops/pallas_attention.py:356 (_fwd_kernel_t), :676 "
                   "(_fwd_kernel_ts), :447 (_fwd_kernel_ts_batched), :489 (_fwd_kernel_wide), "
                   ":571 (_fwd_kernel_wide_batched); bench_kernel.py:515 (tlay_fused), :593 "
                   "(mix_fused), :685 (tmx_fused), :805 (tmq_fused, tmq_bfused), :951 "
                   "(tsw_fused, tsw_bstack, tsw_1_fused), :1012 (lp_fused_bf16)")


# ---------------------------------------------------------------------------
# This slice's paths (phases 21-23): WGATE's and GATE's ELL attention, the
# data tools with the native clip store, and the exported serving programs.

# the kernel bench's ELL entries and the banded entries on the same shapes
ELL_BENCH = ("ell_bf16", "ell_bwd", "ell_bwd_bf16", "ell")
ELL_BESIDE = ("banded_packed_bf16", "banded_packed_bwd", "banded_packed_bwd_bf16")


def peak_mb() -> float:
    import torch

    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**20


def phase_ell(workdir: Path) -> dict:
    """WGATE and GATE with attn_impl="ell" at FDMSE-ISL, full width, batch 16:
    f32 logits against the same weights under "auto" (K8) at the f32 logit
    bar, one f32 step's gradients against "auto"'s at the gradient bar, no
    launch of the banded kernels on the ELL path, a Predictor bucket-16 call
    against the "auto" Predictor's; ell_graph_attention against K8 on the
    kernel bench's planes (f32 and bf16, the kernel bars); then the kernel
    bench's four ell* entries (bench.kernel.measure, the card) beside K8's
    banded_packed entries and masked SDPA on the same shapes; peak memory of
    each."""
    import numpy as np
    import torch
    from torch.nn.attention import SDPBackend

    from sl_hwgat_tpu_torch.bench import kernel as bench
    from sl_hwgat_tpu_torch.ops.banded_attention import banded_attention, banded_attention_bwd
    from sl_hwgat_tpu_torch.ops.sparse_attention import ell_graph_attention
    from sl_hwgat_tpu_torch.serve import Predictor
    from sl_hwgat_tpu_torch.weights import save_state_dict

    rng = np.random.default_rng(SEED + 5)
    clips = [rng.random((int(f), 543, 4)).astype(np.float32)
             for f in rng.integers(96, 385, size=16)]
    models = {}
    for name in BANDED_MODELS:
        x = banded_batch(name)
        xt, y, valid = banded_batch(name, train=True)
        auto = banded_model(name, "float32", drop_rate=0.0)
        ell = banded_model(name, "float32", drop_rate=0.0, attn_impl="ell")
        ell.load_state_dict(auto.state_dict())
        with torch.inference_mode():
            want = auto(x)
            reset_launches(banded_attention, banded_attention_bwd)
            torch.cuda.reset_peak_memory_stats()
            got = ell(x)
            fwd_peak = peak_mb()
            with_k8 = banded_attention.launches
        if with_k8 or got.shape != (16, 2002) or not torch.isfinite(got).all():
            raise AssertionError(f"{name} ell forward: {with_k8} banded launches, logits "
                                 f"{tuple(got.shape)}")
        torch.testing.assert_close(got, want, **LOGIT_TOL["float32"])
        with torch.inference_mode():
            ell_ms = cuda_ms(lambda: ell(x), runs=5, inner=2, warmup=1)
            auto_ms = cuda_ms(lambda: auto(x), runs=5, inner=2, warmup=1)
        auto_loss, auto_grads = one_step_grads(auto, xt, y, valid, seed=SEED)
        reset_launches(banded_attention, banded_attention_bwd)
        torch.cuda.reset_peak_memory_stats()
        ell_loss, ell_grads = one_step_grads(ell, xt, y, valid, seed=SEED)
        step_peak = peak_mb()
        step_k8 = (banded_attention.launches, banded_attention_bwd.launches)
        if step_k8 != (0, 0):
            raise AssertionError(f"{name} ell step launched the banded kernels {step_k8}")
        worst = grad_errors(f"{name} ell", "float32", ell_grads, auto_grads)
        del auto_grads, ell_grads

        ckpt = workdir / f"{name.lower()}_ell.pt"
        save_state_dict(str(ckpt), ell)
        preds = {impl: Predictor.from_checkpoint(str(ckpt), model_type=name,
                                                 dataset="FDMSE-ISL", batch_buckets=(16,),
                                                 attn_impl=impl)
                 for impl in ("ell", "auto")}
        reset_launches(banded_attention)
        rows = preds["ell"].predict_logits(clips)
        served_k8 = banded_attention.launches
        ref = preds["auto"].predict_logits(clips)
        if served_k8 or rows.shape != (16, 2002) or not np.isfinite(rows).all():
            raise AssertionError(f"{name} ell Predictor: {served_k8} banded launches, rows "
                                 f"{rows.shape}")
        np.testing.assert_allclose(rows, ref, **LOGIT_TOL["float32"])
        for pred in preds.values():
            pred.close()
        models[name] = {
            "logits_max_abs_diff": (got - want).abs().max().item(),
            "forward_ms": ell_ms, "auto_forward_ms": auto_ms, "forward_peak_mb": fwd_peak,
            "step_loss": ell_loss, "auto_step_loss": auto_loss, "step_peak_mb": step_peak,
            "grad_err_worst": max(worst.values()),
            "grad_err_worst_param": max(worst, key=worst.get), "grad_err_metric": "max abs",
            "banded_launches": {"forward": with_k8, "step": list(step_k8),
                                "served": served_k8},
            "served_rows": int(rows.shape[0]),
            "served_max_abs_diff": float(np.abs(rows - ref).max())}
        del auto, ell, preds, got, want
        torch.cuda.empty_cache()

    # the ELL attention against K8 on the bench's planes (GATE's band)
    d = bench.draws("banded_packed")
    band = bench.banded_band()
    col, valid = bench.ell_tables(bench.BANDED_SHAPE[2], bench.BANDED_SHAPE[3])
    colt, validt = torch.from_numpy(col).long().cuda(), torch.from_numpy(valid).cuda()
    planes = (-1, bench.BANDED_SHAPE[2] * bench.BANDED_SHAPE[3], bench.BANDED_SHAPE[4])
    against_k8 = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.from_numpy(d["b" + n]).cuda().reshape(planes).to(dtype) for n in "qkv")
        with torch.no_grad():
            got = ell_graph_attention(*(t.view(16, 8, *planes[1:]) for t in (q, k, v)), colt,
                                      validt, scale=bench.BANDED_SCALE).reshape(planes)
            want = banded_attention(q, k, v, band, scale=bench.BANDED_SCALE)
        err = (got - want).abs().max().item()
        # bf16: K8 rounds the self block's probabilities to v's type (at most
        # 2^-9 of each weight, weights summing to 1), the ELL form does not
        bar = TOL["float32"] if dtype == torch.float32 else 2.0**-8 * v.abs().max().item()
        if not err <= bar:
            raise AssertionError(f"ell_graph_attention vs K8 {dtype_name(dtype)}: {err} > {bar}")
        against_k8[dtype_name(dtype)] = {"max_abs_err": err, "bar": bar,
                                         "bit_for_bit": torch.equal(got, want)}
        del q, k, v, got, want
    entries = {}
    for impl in (*ELL_BENCH, *ELL_BESIDE):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rec = bench.measure(impl, repeats=3, inner=4)
        entries[impl] = {k: rec.get(k) for k in ("time_us", "device_us", "bound_us", "bound_by",
                                                  "bytes", "flops", "edges", "edges_per_sec",
                                                  "launches")}
        entries[impl]["peak_mb"] = peak_mb()
    # masked SDPA over the whole F·V sequence of the same planes (GATE's band
    # as the dense block-tridiagonal mask; memory-efficient backend), timed only
    dense = torch.from_numpy(dense_band_mask(band, bench.BANDED_SHAPE[2])).cuda()
    sdpa = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.from_numpy(d["b" + n]).cuda().reshape(planes).to(dtype) for n in "qkv")
        do = torch.randn_like(q)
        fwd_ms, bwd_ms = sdpa_ms(q, k, v, do, dense.to(dtype)[None, None],
                                 scale=bench.BANDED_SCALE, runs=5,
                                 backends=[SDPBackend.EFFICIENT_ATTENTION])
        sdpa[dtype_name(dtype)] = {"fwd_ms": fwd_ms, "fwd_bwd_ms": fwd_ms + bwd_ms}
        del q, k, v, do
    torch.cuda.empty_cache()
    ratio = {impl: entries[impl]["device_us"] / entries[beside]["device_us"]
             for impl, beside in (("ell_bf16", "banded_packed_bf16"),
                                  ("ell_bwd", "banded_packed_bwd"),
                                  ("ell_bwd_bf16", "banded_packed_bwd_bf16"))}
    emit("ell", nvidia_smi=nvidia_smi(), batch=16, frames=192, classes=2002,
         tolerance={"logits": LOGIT_TOL["float32"], "grad": GRAD_ATOL_F32}, models=models,
         bench=entries, sdpa_ms=sdpa, ell_over_k8_device=ratio, against_k8=against_k8,
         note="ell_* entries: ell_graph_attention (plain torch, no kernel) at (16, 8, "
              "192·29, 16); banded_packed*: K8 on the same q, k, v; sdpa_ms: masked SDPA "
              "(memory-efficient backend, dense block-tridiagonal mask) on the same planes, "
              "fwd_bwd as one forward and one backward; bare ell is bench_kernel.py's last "
              "branch (stacked_window_attention at 12288 × 32 × 64)")
    return {"models": models, "bench": entries}


# The data tools' run: an FDMSE-ISL video tree (its adapter, fdmse_meta: 5
# train and 1 test video a class, one train video a class carved out for
# val) of 16 classes, each clip a 192-frame mediapipe clip (543 joints × 4),
# preprocessed under the FDMSE-ISL name (192 frames, the 2002-class head;
# the class map padded to the dataset's 2002 words, as the CLI cell's):
# 64 train, 16 val and 16 test clips, the CLI cell's counts (the train
# transform takes about 70 host ms a clip, so 128 train clips cost the
# script another 130 s)
TOOLS_DATASET = "FDMSE-ISL"
TOOLS_CLASSES = 16
TOOLS_FRAMES = 192
TOOLS_EPOCHS = 1  # --epochs 1: epochs 0-1, the last one warm
# the stores' train runs in turns, each store once: one warm epoch a store
TOOLS_ORDER = ("clipstore", "pickle")
TOOLS_LOADER_EPOCHS = 1  # epochs of the train loader alone, a turn


def write_keypoint_tree(root: Path, kp_dir: Path, classes: int = TOOLS_CLASSES) -> str:
    """A video tree (empty files) of ``classes`` classes, its metadata.csv
    through fdmse_meta and generate_meta, and a synthetic mediapipe keypoint
    pickle per clip; returns the metadata path."""
    import pickle

    import numpy as np

    from sl_hwgat_tpu_torch.data.meta_generators import fdmse_meta, generate_meta

    for cls in range(classes):
        for split, n in (("train", 5), ("test", 1)):
            folder = root / split / f"sign{cls:02d}"
            folder.mkdir(parents=True)
            for i in range(n):
                (folder / f"sign{cls:02d}_{split}_{i}.mp4").touch()
    rows, vocab = fdmse_meta(str(root), seed=SEED)
    meta_csv = generate_meta(str(root), rows, vocab)
    kp_dir.mkdir(parents=True)
    rng = np.random.default_rng(SEED + 6)
    base = rng.uniform(0.3, 0.7, size=(1, 543, 4)).astype(np.float32)
    for row in rows:
        drift = np.cumsum(rng.normal(0, 0.005, size=(TOOLS_FRAMES, 1, 4)), axis=0)
        feat = np.clip(base + drift + rng.normal(0, 0.01, size=(TOOLS_FRAMES, 543, 4)),
                       0.02, 0.98).astype(np.float32)
        with open(kp_dir / f"{row[0]}.pkl", "wb") as f:
            pickle.dump({"feat": feat, "num_frames": TOOLS_FRAMES, "vid_width": 640,
                         "vid_height": 480}, f)
    return meta_csv


def clip_read_us(readers: dict, ids: list, rounds: int = 20) -> dict:
    """µs a clip read of each reader, on one thread and on the loader's 8
    threads, the readers in two turns (forward, then backward), medians of
    the turns."""
    from concurrent.futures import ThreadPoolExecutor

    out = {name: {"one_thread": [], "eight_threads": []} for name in readers}
    with ThreadPoolExecutor(max_workers=8) as pool:
        for turn in range(2):
            for name in readers if turn % 2 == 0 else reversed(readers):
                get = readers[name]
                list(pool.map(get, ids))
                t0 = time.perf_counter()
                for _ in range(rounds):
                    for vid in ids:
                        get(vid)
                out[name]["one_thread"].append((time.perf_counter() - t0) / (rounds * len(ids)))
                t0 = time.perf_counter()
                list(pool.map(get, ids * rounds))
                out[name]["eight_threads"].append(
                    (time.perf_counter() - t0) / (rounds * len(ids)))
    return {name: {k: statistics.median(v) * 1e6 for k, v in d.items()}
            for name, d in out.items()}


def loader_epoch_seconds(workdir: Path, store: str, epochs: range) -> list:
    """Seconds of each of ``epochs`` of the train loader alone (get_loaders
    on the store's artifacts, the train transform, 8 threads, no steps)."""
    from sl_hwgat_tpu_torch.data.dataset import get_loaders

    cfg = cli_config(workdir / store, "train", TOOLS_EPOCHS, dataset=TOOLS_DATASET, n_workers=8)
    loaders = get_loaders(cfg, cfg.train_transform(), cfg.eval_transform())
    seconds = []
    try:
        for epoch in epochs:
            t0 = time.perf_counter()
            for _ in loaders[0].epoch(epoch):
                pass
            seconds.append(time.perf_counter() - t0)
    finally:
        for loader in loaders:
            loader.close()
    return seconds


def phase_data_tools(workdir: Path, classes: int = TOOLS_CLASSES,
                     loader_epochs: int = TOOLS_LOADER_EPOCHS) -> dict:
    """Main path 13: the data tools. Synthetic keypoint clips → fdmse_meta →
    generate_meta → preprocess into a pickle store and a clip store; the clip
    store opened by the native reader gives every clip of the pickle store
    bit for bit; cli.run trains HWGATE (two epochs, batch 16) from each
    store in turns (clip store, then pickle), and tests it
    from each, with exact launches (8 K1 per step and eval batch, 8 K2 per
    step). Against each other: the warm train epochs' seconds, the train
    loader's epochs alone (in the same turns) and a clip read."""
    import csv

    import numpy as np
    import torch

    from sl_hwgat_tpu_torch.constants import DATASET_PARAMS
    from sl_hwgat_tpu_torch.data.clipstore import ClipStore
    from sl_hwgat_tpu_torch.data.dataset import load_artifacts
    from sl_hwgat_tpu_torch.data.preprocess import preprocess

    t0 = time.perf_counter()
    meta_csv = write_keypoint_tree(workdir / "FDMSE", workdir / "kp", classes)
    write_s = time.perf_counter() - t0
    roots, prep_s, class_maps = {}, {}, {}
    for store in ("clipstore", "pickle"):
        roots[store] = workdir / store / "input"  # cli_config's input root of workdir / store
        t0 = time.perf_counter()
        data_cfg = preprocess(meta_csv, TOOLS_DATASET, str(workdir / "kp"),
                              input_root=str(roots[store]), store=store)
        prep_s[store] = time.perf_counter() - t0
        class_maps[store] = data_cfg.class_map_path
    splits, classes, data_map = load_artifacts(str(roots["pickle"]), TOOLS_DATASET)
    s_splits, s_classes, clips = load_artifacts(str(roots["clipstore"]), TOOLS_DATASET)
    if clips.backend != "native" or s_splits != splits or s_classes != classes:
        raise AssertionError(f"clip store: backend {clips.backend}, splits or classes differ")
    if sorted(clips.keys()) != sorted(data_map) or not all(
            clips[v].dtype == data_map[v].dtype and np.array_equal(clips[v], data_map[v])
            for v in data_map):
        raise AssertionError("clip store: a clip differs from the pickle store's")
    words = len(set(classes.values()))
    for path in class_maps.values():  # the dataset's other words, for the confusion CSV
        with open(path, "a", newline="") as f:
            csv.writer(f).writerows([c, f"word{c}"] for c in range(
                words, DATASET_PARAMS[TOOLS_DATASET]["num_class"]))
    # the loader's read of a clip: the native reader, numpy's, and the
    # in-memory pickle's copy (KeypointDataset copies an in-memory entry)
    numpy_clips = ClipStore(clips.path, force_numpy=True)
    read_us = clip_read_us({"native": clips.__getitem__, "numpy": numpy_clips.__getitem__,
                            "pickle": lambda vid: data_map[vid].copy()}, list(data_map))
    clips.close()
    numpy_clips.close()
    batches = {k: -(-len(v) // 16) for k, v in splits.items()}
    final = batches["train"] + batches["val"] + 2 * batches["test"]
    runs, epochs, total = [], [], {"fwd": 0, "bwd": 0}
    for turn, store in enumerate(TOOLS_ORDER):
        tag = f"tools_{store}_{turn}"
        cfg = cli_config(workdir / store, "train", TOOLS_EPOCHS, tag, dataset=TOOLS_DATASET,
                         n_workers=8)
        with timed_train_epochs(epochs, f"{store}_{turn}"):
            results, state, launches, seconds = cli_run(
                cfg, (TOOLS_EPOCHS + 1) * batches["train"],
                (TOOLS_EPOCHS + 1) * batches["val"] + final)
        del state
        run = {"store": store, "train": {"launches": launches, "seconds": seconds,
                                         "results": results}}
        launch_runs = [launches]
        if store not in TOOLS_ORDER[:turn]:  # test from each store once
            tcfg = cli_config(workdir / store, "test", TOOLS_EPOCHS, tag,
                              dataset=TOOLS_DATASET, n_workers=8)
            tcfg.topk = 5
            test_results, _, test_launches, test_s = cli_run(tcfg, 0, final)
            run["test"] = {"launches": test_launches, "seconds": test_s,
                           "results": test_results}
            launch_runs.append(test_launches)
        for launched in launch_runs:
            for kind in total:
                total[kind] += launched[kind]
        runs.append(run)
        torch.cuda.empty_cache()
    loader_s = {store: [] for store in ("clipstore", "pickle")}
    for turn, store in enumerate(TOOLS_ORDER):
        first = 1 + turn * loader_epochs
        loader_s[store] += loader_epoch_seconds(workdir, store,
                                                range(first, first + loader_epochs))
    warm = {store: sorted(e["seconds"] for e in epochs
                          if e["run"].startswith(store) and e["epoch"] > 0)
            for store in loader_s}
    wait = {store: sorted(e["loader_wait_s"] for e in epochs
                          if e["run"].startswith(store) and e["epoch"] > 0)
            for store in loader_s}
    emit("data_tools", nvidia_smi=nvidia_smi(), dataset=TOOLS_DATASET,
         clips={k: len(v) for k, v in splits.items()}, frames=TOOLS_FRAMES, batch=16,
         loader_workers=8, order=TOOLS_ORDER, write_s=write_s, preprocess_s=prep_s,
         backend="native", clips_bit_for_bit=len(data_map), read_us_per_clip=read_us,
         runs=runs, train_epochs=epochs,
         warm_epoch_median_s={k: statistics.median(v) for k, v in warm.items()},
         warm_epoch_s=warm, warm_loader_wait_s=wait,
         loader_epoch_median_s={k: statistics.median(v) for k, v in loader_s.items()},
         loader_epoch_s=loader_s, launches=total)
    return total


# (case, model, compute dtype, attn_impl, the kernel its eval forward
# launches, further constructor overrides)
EXPORTS = (("HWGATE/bfloat16", "HWGATE", "bfloat16", "auto", "window_attention_fwd", {}),
           ("HWGATE-hybrid/bfloat16", "HWGATE", "bfloat16", "hybrid", "masked_softmax_fwd", {}),
           ("HWGATE-hybrid/bfloat16/bf16_scores", "HWGATE", "bfloat16", "hybrid",
            "masked_softmax_fwd", BF16_SCORES),
           ("WGATE/float32", "WGATE", "float32", "auto", "banded_attention_fwd", {}))

# run in a fresh python3: load each exported program with Predictor.load_exported,
# count the hand kernels one call launches, time it, keep its logits
EXPORT_CHILD = r"""
import json, statistics, sys, time
import numpy as np
import torch
from sl_hwgat_tpu_torch.serve import Predictor
from sl_hwgat_tpu_torch.ops import banded_attention as b, hybrid_attention as h
from sl_hwgat_tpu_torch.ops import window_attention as w

counters = {w.KERNEL: w.window_attention, w.KERNEL_BWD: w.window_attention_bwd,
            h.KERNEL: h.masked_softmax, h.KERNEL_BWD: h.masked_softmax_bwd,
            b.KERNEL: b.banded_attention, b.KERNEL_BWD: b.banded_attention_bwd}
out = {}
for job in json.loads(sys.argv[1]):
    t0 = time.perf_counter()
    fn = Predictor.load_exported(job["program"])
    load_s = time.perf_counter() - t0
    x = torch.from_numpy(np.load(job["x"])).cuda()
    fn(x)
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    logits = fn(x)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items() if c.launches}
    np.save(job["logits"], logits.float().cpu().numpy())
    ms, host = [], []
    for _ in range(10):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(5):
            fn(x)
        host.append((time.perf_counter() - t0) / 5 * 1e3)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end) / 5)
    out[job["case"]] = {"load_s": load_s, "launches": launches, "ms": statistics.median(ms),
                        "host_ms": statistics.median(host)}
print(json.dumps({
    "results": out,
    "models": [n for n in sys.modules if n.startswith("sl_hwgat_tpu_torch.models")],
    "reference": [n for n in sys.modules if n == "sl_hwgat_tpu" or n.startswith("sl_hwgat_tpu.")],
    "jax": [n for n, m in sys.modules.items() if m is not None and n.split(".")[0] in
            ("jax", "jaxlib", "flax", "optax")],
}))
"""


def forward_host_and_card_ms(fn, x):
    """(events ms, host ms) of one call of ``fn(x)``: CUDA events around 5
    back-to-back calls, and the host's time to return from each (the
    enqueue), medians of 10."""
    import torch

    ms, host = [], []
    fn(x)
    torch.cuda.synchronize()
    for _ in range(10):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(5):
            fn(x)
        host.append((time.perf_counter() - t0) / 5 * 1e3)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end) / 5)
    return statistics.median(ms), statistics.median(host)


def first_differing_module(model, program_path: str, x) -> str | None:
    """The first submodule, in the eager forward's call order, whose output in
    the exported program (``torch.export.unflatten``) differs from eager's."""
    import torch

    program = torch.export.unflatten(torch.export.load(program_path))
    eager, exported = {}, {}

    def keep(store, name):
        def hook(_, __, out):
            if torch.is_tensor(out):
                store.setdefault(name, out.detach().clone())
        return hook

    handles = [m.register_forward_hook(keep(eager, n)) for n, m in model.named_modules() if n]
    handles += [m.register_forward_hook(keep(exported, n))
                for n, m in program.named_modules() if n]
    with torch.no_grad():
        model(x)
        program(x)
    for h in handles:
        h.remove()
    for name, out in eager.items():
        if name in exported and not torch.equal(out, exported[name]):
            return name
    return None


def phase_export(workdir: Path, repo: Path) -> dict:
    """Main path 14: serving export. HWGATE bf16, HWGATE hybrid bf16 (f32
    and bf16 scores) and WGATE f32 at FDMSE-ISL, full width, from a
    checkpoint through
    Predictor.export_program at bucket 16; then a fresh python3 loads each
    with Predictor.load_exported (no module of the port's models, of jax or
    of sl_hwgat_tpu imported), runs it on a batch of 16 preprocessed clips
    with the launches of the hand kernels counted (8 K1, 8 K7 or 8 K8
    forwards a call, no other), and times it; its logits against
    Predictor.forward's on the same batch, bit for bit expected, else within
    the model's bar with the first differing submodule named."""
    import numpy as np
    import torch

    from sl_hwgat_tpu_torch.constants import DATASET_PARAMS
    from sl_hwgat_tpu_torch.models import build_model
    from sl_hwgat_tpu_torch.serve import Predictor
    from sl_hwgat_tpu_torch.weights import save_state_dict

    rng = np.random.default_rng(SEED + 7)
    clips = [rng.random((int(f), 543, 4)).astype(np.float32)
             for f in rng.integers(96, 385, size=16)]
    jobs, cases = [], {}
    for case, name, cdt, impl, kernel, extra in EXPORTS:
        tag = case.replace("/", "_")
        ckpt = workdir / f"{tag}.pt"
        save_state_dict(str(ckpt), build_model(name, DATASET_PARAMS["FDMSE-ISL"], 2,
                                               device="cuda", seed=SEED, compute_dtype=cdt,
                                               attn_impl=impl, **extra))
        pred = Predictor.from_checkpoint(str(ckpt), model_type=name, dataset="FDMSE-ISL",
                                         batch_buckets=(16,), compute_dtype=cdt, attn_impl=impl,
                                         **extra)
        x = np.stack([pred.preprocess(c) for c in clips])
        t0 = time.perf_counter()
        program = pred.export_program(str(workdir / f"{tag}.pt2"), 16, clips[0])
        export_s = time.perf_counter() - t0
        np.save(workdir / f"{tag}_x.npy", x)
        want = pred.forward(x).float().cpu()
        xt = torch.from_numpy(x).cuda()
        with torch.inference_mode():
            fwd_ms, fwd_host_ms = forward_host_and_card_ms(pred.model, xt)
        jobs.append({"case": case, "program": program, "x": str(workdir / f"{tag}_x.npy"),
                     "logits": str(workdir / f"{tag}_logits.npy")})
        cases[case] = {"pred": pred, "want": want, "kernel": kernel, "cdt": cdt,
                       "export_s": export_s, "program_mb": os.path.getsize(program) / 2**20,
                       "forward_ms": fwd_ms, "forward_host_ms": fwd_host_ms}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(repo)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", EXPORT_CHILD, json.dumps(jobs)], cwd=workdir,
                          env=env, capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"load_exported process: rc {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    if child["models"] or child["reference"] or child["jax"]:
        raise AssertionError(f"load_exported imported {child['models']}, {child['reference']}, "
                             f"{child['jax']}")
    out, launches = {}, {}
    for job in jobs:
        case, c = job["case"], cases[job["case"]]
        res = child["results"][case]
        if res["launches"] != {c["kernel"]: 8}:
            raise AssertionError(f"exported {case}: one call launched {res['launches']}, "
                                 f"not 8 of {c['kernel']}")
        launches[c["kernel"]] = launches.get(c["kernel"], 0) + res["launches"][c["kernel"]]
        got = torch.from_numpy(np.load(job["logits"]))
        if got.shape != (16, 2002) or not torch.isfinite(got).all():
            raise AssertionError(f"exported {case}: logits {tuple(got.shape)} or non-finite")
        bit = torch.equal(got, c["want"])
        differs = None
        if not bit and case.endswith("bf16_scores"):
            raise AssertionError(f"exported {case}: logits differ from the eager forward's by "
                                 f"{(got - c['want']).abs().max().item()}")
        if not bit:
            differs = first_differing_module(c["pred"].model, job["program"],
                                             torch.from_numpy(np.load(job["x"])).cuda())
            torch.testing.assert_close(got, c["want"], **LOGIT_TOL[c["cdt"]],
                                       msg=lambda m: f"exported {case} ({differs}): {m}")
        out[case] = {"bit_for_bit": bit, "max_abs_diff": (got - c["want"]).abs().max().item(),
                     "first_differing_module": differs, "launches": res["launches"],
                     "program_ms": res["ms"], "program_host_ms": res["host_ms"],
                     "forward_ms": c["forward_ms"], "forward_host_ms": c["forward_host_ms"],
                     "export_s": c["export_s"], "load_s": res["load_s"],
                     "program_mb": c["program_mb"]}
        c["pred"].close()
    del cases
    torch.cuda.empty_cache()
    emit("export", nvidia_smi=nvidia_smi(), batch=16, frames=192, classes=2002,
         tolerance=LOGIT_TOL, child_s=child_s, results=out,
         note="program_ms / forward_ms: CUDA events around 5 back-to-back calls of the "
              "loaded program (fresh process) / of Predictor's model in this one; *_host_ms: "
              "the host's time to return from one call (its enqueue)")
    return launches


# ---------------------------------------------------------------------------
# The parallel layer (phase 24).

PARALLEL_HWGATE_MESH = (1, 2, 2)
PARALLEL_HGATE_MESH = (1, 2, 2)
PARALLEL_TRANSFORMER_MESH = (2, 1, 2)
PARALLEL_TRANSFORMER_SP_MESH = (1, 2, 2)
PARALLEL_BANDED_MESH = (2, 2, 1)
PARALLEL_GCN_MESH = (2, 2, 1)
PARALLEL_GCNS = ("STGCN", "DecoupledGCN")
PARALLEL_RUN_MESH = (2, 1, 1)
PARALLEL_EPOCHS = 1  # --epochs 1: epochs 0 and 1
# the kernel launches each rank must make in each step of a job, by the kind
# of model, attention and step
PARALLEL_LAUNCHES = {
    "window": {"logits": {"window_attention": 8}, "eval": {"window_attention": 8},
               "train": {"window_attention": 8, "window_attention_bwd": 8}},
    "hybrid": {"logits": {"masked_softmax": 8}},
    "banded": {"logits": {"banded_attention": 8},
               "train": {"banded_attention": 8, "banded_attention_bwd": 8}},
    "none": {"logits": {}, "train": {}, "eval": {}},  # the Transformer
}


def check_parallel_launches(case: str, kind: str, ranks: list) -> None:
    """Every rank launched exactly its kernels in each step of ``case``."""
    for rank in ranks:
        for step, want in PARALLEL_LAUNCHES[kind].items():
            if step not in rank["launches"]:
                continue
            got = {k: v for k, v in rank["launches"][step].items() if v}
            if got != want:
                raise AssertionError(f"parallel {case}, rank {rank['coords']}, {step}: "
                                     f"launched {got}, not {want}")


def parallel_reference(workdir: Path, case: str, model, batch, *, train: bool) -> dict:
    """The single-process steps on the card that a sharded job is held to:
    eval logits, then one train step's loss, gradients and parameters, then
    the eval step. Writes the model's state and the batch for the ranks."""
    import torch

    from sl_hwgat_tpu_torch.train.loop import make_steps
    from sl_hwgat_tpu_torch.train.state import make_optimizer

    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               workdir / f"{case}.state.pt")
    torch.save(tuple(t.cpu() for t in batch), workdir / f"{case}.batch.pt")
    x, y, valid = batch
    ref = {}
    model.eval()
    with torch.no_grad():
        ref["logits"] = model(x).float().cpu()
    if train:
        step, evaluate = make_steps(model, make_optimizer("adamw", LR, model.parameters()))
        ref["loss"] = step(x, y, valid, SEED, 0, 0)[0].item()
        ref["grads"] = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
        ref["params"] = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        ref["eval_loss"] = evaluate(x, y, valid, 1)[0].item()
    return ref


def parallel_job(workdir: Path, case: str, model: str, mesh, steps, overrides, **kw) -> dict:
    from sl_hwgat_tpu_torch.constants import DATASET_PARAMS

    return dict(model=model, dataset=DATASET_PARAMS["FDMSE-ISL"], overrides=overrides,
                state=str(workdir / f"{case}.state.pt"), batch=str(workdir / f"{case}.batch.pt"),
                mesh=mesh, device="cuda:0", steps=steps, seed=SEED,
                out=str(workdir / f"{case}.out.pt"), **kw)


# DecoupledGCN's gradients that are zero in exact arithmetic at its init:
# fc1c's (fc2c's weight is zero), and the temporal gate's bias (at a zero
# conv_ta weight it scales the whole block alike before a BatchNorm); the
# bar holds them all the same
EXACT_ZERO_GRADS = {"DecoupledGCN": r"\.fc1c\.|\.conv_ta\.bias$"}


def check_parallel_step(case: str, cdt: str, got: dict, ref: dict) -> dict:
    """A sharded job's logits, loss, gradients and eval loss against the
    single-process step's, at the models' card bars."""
    import torch

    tol = LOGIT_TOL[cdt]
    out = {"logits_max_abs_err": (got["logits"] - ref["logits"]).abs().max().item()}
    if not torch.allclose(got["logits"], ref["logits"], **tol):
        raise AssertionError(f"parallel {case}: logits {out['logits_max_abs_err']} off")
    if "loss" in ref:
        loss = got["train"][0].item()
        out["loss"], out["loss_single"] = loss, ref["loss"]
        if not math.isclose(loss, ref["loss"], abs_tol=tol["atol"], rel_tol=tol["rtol"]):
            raise AssertionError(f"parallel {case}: loss {loss} against {ref['loss']}")
        grads = {k: g.to(ref["grads"][k].device) for k, g in got["grads"].items()}
        worst = grad_errors(f"parallel {case}", cdt, grads, ref["grads"],
                            EXACT_ZERO_GRADS.get(case.split("/")[0]))
        out["grad_err_worst"] = max(worst.values())
        out["grad_err_worst_param"] = max(worst, key=worst.get)
    if "eval" in got:
        out["eval_loss"], out["eval_loss_single"] = got["eval"][0].item(), ref["eval_loss"]
        if not math.isclose(out["eval_loss"], ref["eval_loss"], abs_tol=tol["atol"],
                            rel_tol=tol["rtol"]):
            raise AssertionError(f"parallel {case}: eval loss {out['eval_loss']} against "
                                 f"{ref['eval_loss']}")
    return out


def phase_parallel(workdir: Path, smi: str) -> dict:
    """Phase 24, the parallel layer on the card: ranks that share cuda:0
    over gloo (the card's machine has one card, and NCCL takes one rank a
    card), so this shows the sharded functions right and launching their
    kernels per rank, not scaling.

    (a) HWGATE at FDMSE-ISL, batch 16, f32 and bf16, prune on, dropout off,
        4 ranks at mesh (1, 2, 2): eval logits, one train step, the eval
        step, against the single-process steps the parent runs first; one
        attn_impl="hybrid" eval forward; HGATE the same at its full width
        (K1/K2 at 58 tokens, one head a rank in stage 0). (b) WGATE and
        GATE at FDMSE-ISL, f32, mesh (2, 2, 1): logits and one train step;
        the Transformer, f32, mesh (2, 1, 2) (tp only): logits and one train
        step, then Predictor.from_checkpoint on its gathered parameters
        serves the single-process model's logits; the Transformer at (1, 2,
        2) (sp and tp): logits and one train step; STGCN and DecoupledGCN,
        f32, at (2, 2, 1) with their dropout and DropGraph on: logits, one
        train step and the eval step (their BatchNorm statistics calibrated
        on the batch: ``calibrate_batch_norm``). (a) and (b) run in one
        spawn. (c) run_distributed on 2 ranks at (2, 1, 1): SYNTH, two
        epochs, batch 16, each checkpoint backend; the ranks' metrics agree,
        each read its rows only, rank 0's checkpoint holds the weights of its
        epoch bit for bit and Predictor.from_checkpoint serves their logits;
        then one HWGATE f32 step in a one-rank NCCL group, bit for bit the
        single-process step. Returns each kernel's launches over the ranks."""
    import torch

    from sl_hwgat_tpu_torch.configs import RunConfig
    from sl_hwgat_tpu_torch.constants import DATASET_PARAMS
    from sl_hwgat_tpu_torch.data.dataset import load_artifacts
    from sl_hwgat_tpu_torch.data.synthetic import write_synthetic_dataset
    from sl_hwgat_tpu_torch.models import build_model
    from sl_hwgat_tpu_torch.parallel.dryrun import run_jobs, runs_worker, spawn
    from sl_hwgat_tpu_torch.serve import Predictor
    from sl_hwgat_tpu_torch.train.checkpoint import read_checkpoint, save_checkpoint
    from sl_hwgat_tpu_torch.train.state import TrainState, make_optimizer

    t0 = time.perf_counter()
    jobs, refs, kinds = [], {}, {}
    batch = train_batch()
    for cdt in ("float32", "bfloat16"):
        case = f"HWGATE/{cdt}"
        name = case.replace("/", "_")
        refs[case] = parallel_reference(workdir, name, flagship(cdt, drop_rate=0.0), batch,
                                        train=True)
        jobs.append(parallel_job(workdir, name, "HWGATE", PARALLEL_HWGATE_MESH,
                                 ["logits", "train", "eval"] + (["repeats"] if cdt == "bfloat16"
                                                                 else []),
                                 dict(compute_dtype=cdt, drop_rate=0.0), repeats=3))
        kinds[case] = "window"
        torch.cuda.empty_cache()
    refs["HWGATE-hybrid/float32"] = parallel_reference(
        workdir, "HWGATE-hybrid", flagship("float32", drop_rate=0.0, attn_impl="hybrid"), batch,
        train=False)
    jobs.append(parallel_job(workdir, "HWGATE-hybrid", "HWGATE", PARALLEL_HWGATE_MESH,
                             ["logits"], dict(attn_impl="hybrid", drop_rate=0.0)))
    kinds["HWGATE-hybrid/float32"] = "hybrid"
    hgate_batch = banded_batch("HGATE", train=True)
    for cdt, impl in (("float32", "auto"), ("bfloat16", "auto"), ("float32", "hybrid")):
        name = "HGATE" + ("-hybrid" if impl == "hybrid" else "")
        case = f"{name}/{cdt}"
        refs[case] = parallel_reference(
            workdir, case.replace("/", "_"), windowed_model("HGATE", impl, cdt, drop_rate=0.0),
            hgate_batch, train=impl == "auto")
        # the eval step in f32 only: the bf16 eval step was trimmed to keep
        # the whole script inside 900 s
        steps = {("float32", "auto"): ["logits", "train", "eval"],
                 ("bfloat16", "auto"): ["logits", "train"]}.get((cdt, impl), ["logits"])
        jobs.append(parallel_job(workdir, case.replace("/", "_"), "HGATE", PARALLEL_HGATE_MESH,
                                 steps, dict(attn_impl=impl, compute_dtype=cdt, drop_rate=0.0)))
        kinds[case] = "hybrid" if impl == "hybrid" else "window"
        torch.cuda.empty_cache()
    tr_batch = banded_batch("Transformer", train=True)
    tr_batch[0][1, 150:] = -1.0  # padded frames: the key padding mask
    tr_model = build_model("Transformer", DATASET_PARAMS["FDMSE-ISL"], 2, device="cuda",
                           seed=SEED, dropout=0.0)
    refs["Transformer/float32"] = parallel_reference(workdir, "Transformer", tr_model, tr_batch,
                                                     train=True)
    jobs.append(parallel_job(workdir, "Transformer", "Transformer", PARALLEL_TRANSFORMER_MESH,
                             ["logits", "train", "params"], dict(dropout=0.0)))
    kinds["Transformer/float32"] = "none"
    # the Transformer over sp and tp: each rank's queries, the clip's keys
    refs["Transformer-sp/float32"] = parallel_reference(
        workdir, "Transformer-sp", build_model("Transformer", DATASET_PARAMS["FDMSE-ISL"], 2,
                                               device="cuda", seed=SEED, dropout=0.0),
        tr_batch, train=True)
    jobs.append(parallel_job(workdir, "Transformer-sp", "Transformer",
                             PARALLEL_TRANSFORMER_SP_MESH, ["logits", "train"],
                             dict(dropout=0.0)))
    kinds["Transformer-sp/float32"] = "none"
    # the GCNs over dp and sp with their dropout and DropGraph on: the masks
    # are the global batch's draws from the single-process step's seed
    for name in PARALLEL_GCNS:
        gcn, gcn_batch = baseline_model(name), banded_batch(name, train=True)
        calibrate_batch_norm(gcn, gcn_batch[0])  # the init statistics' logits reach 1e4
        refs[f"{name}/float32"] = parallel_reference(workdir, name, gcn, gcn_batch, train=True)
        jobs.append(parallel_job(workdir, name, name, PARALLEL_GCN_MESH,
                                 ["logits", "train", "eval"], {}))
        kinds[f"{name}/float32"] = "none"
        torch.cuda.empty_cache()
    for name in BANDED_MODELS:
        refs[f"{name}/float32"] = parallel_reference(
            workdir, name, banded_model(name, "float32", drop_rate=0.0),
            banded_batch(name, train=True), train=True)
        jobs.append(parallel_job(workdir, name, name, PARALLEL_BANDED_MESH, ["logits", "train"],
                                 dict(drop_rate=0.0), use_tp=False))
        kinds[f"{name}/float32"] = "banded"
        torch.cuda.empty_cache()
    reference_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    results = dict(zip(refs, run_jobs(jobs, 4)))
    steps_s = time.perf_counter() - t1
    out, host_ms, totals = {}, {}, {}
    for case, (got, ranks) in results.items():
        check_parallel_launches(case, kinds[case], ranks)
        out[case] = check_parallel_step(case, case.split("/")[1], got, refs[case])
        out[case]["mesh"] = jobs[list(refs).index(case)]["mesh"]
        host_ms[case] = {step: max(r["host_ms"][step] for r in ranks)
                         for step in ranks[0]["host_ms"]}
        for rank in ranks:
            for step, counts in rank["launches"].items():
                for kernel, n in counts.items():
                    totals[kernel] = totals.get(kernel, 0) + n

    # the Transformer's tp-sharded parameters, gathered, served from a
    # checkpoint: the single-process model's logits on the same weights
    params = results["Transformer/float32"][0]["params"]
    tr_model.load_state_dict(params)
    tr_path = str(workdir / "transformer_tp_best_loss.ckpt")
    save_checkpoint(tr_path, TrainState(tr_model, make_optimizer("adamw", LR,
                                                                 tr_model.parameters())), LR)
    pred = Predictor.from_checkpoint(tr_path, model_type="Transformer", dataset="FDMSE-ISL")
    tr_model.eval()
    with torch.no_grad():
        served, want = pred.model(tr_batch[0]), tr_model(tr_batch[0])
    if not torch.equal(served, want):
        raise AssertionError(f"the served tp-sharded Transformer checkpoint's logits are not "
                             f"the model's ({(served - want).abs().max().item()})")
    out["Transformer/float32"]["served_logits_equal"] = True
    del pred, tr_model

    # (c) run_distributed, each backend, then a one-rank NCCL step
    t2 = time.perf_counter()
    write_synthetic_dataset(str(workdir / "input"))
    configs = [dict(dataset="SYNTH", model_type="HWGATE", mode="train", time=f"dist_{b}",
                    input_root=str(workdir / "input"), output_root=str(workdir / "out"),
                    device="cuda:0", epochs=PARALLEL_EPOCHS, batch_size=16, n_workers=2,
                    ckpt_backend=b) for b in ("pickle", "orbax")]
    runs = [dict(config=c, mesh=PARALLEL_RUN_MESH, out=str(workdir / f"run_{c['ckpt_backend']}"))
            for c in configs]
    spawn(runs_worker, 2, runs, device="cuda:0")
    run_out = {}
    for config, run in zip(configs, runs):
        r0, r1 = (torch.load(f"{run['out']}.{r}", weights_only=False) for r in range(2))
        if r0["metrics"] != r1["metrics"] or r0["history"] != r1["history"]:
            raise AssertionError(f"run_distributed {config['ckpt_backend']}: the ranks' metrics "
                                 f"differ: {r0['metrics']} / {r1['metrics']}")
        cfg = RunConfig(**config)
        n_train = len(load_artifacts(cfg.input_root, cfg.dataset)[0]["train"])
        reads = [len([i for e, n, i in got["reads"] if e == 0 and n == n_train])
                 for got in (r0, r1)]
        if reads != [-(-n_train // 16) * 8] * 2:  # 8 rows of each batch of 16, a rank
            raise AssertionError(f"run_distributed: the ranks read {reads} train clips of "
                                 f"epoch 0, not their rows of every batch")
        path = f"{cfg.save_model_path}_best_loss.ckpt"
        saved = read_checkpoint(path)
        weights = r0["states"][saved["epoch"]]
        if any(not torch.equal(saved["model_state_dict"][k], v) for k, v in weights.items()):
            raise AssertionError(f"run_distributed {config['ckpt_backend']}: the checkpoint "
                                 f"is not the weights of epoch {saved['epoch']}")
        pred = Predictor.from_checkpoint(path, model_type="HWGATE", dataset="SYNTH")
        model = build_model("HWGATE", cfg.dataset_params, 2, device="cuda")
        model.load_state_dict(weights)
        clips = torch.rand(4, 32, 64, 2, generator=torch.Generator().manual_seed(SEED)).cuda()
        with torch.no_grad():
            served, want = pred.model(clips), model(clips)
        if not torch.equal(served, want):
            raise AssertionError(f"run_distributed {config['ckpt_backend']}: the served logits "
                                 f"are not the trained weights' "
                                 f"({(served - want).abs().max().item()})")
        run_out[config["ckpt_backend"]] = {
            "history": r0["history"], "checkpoint_epoch": saved["epoch"],
            "is_directory": os.path.isdir(path), "train_clips_read_epoch0": reads}
        del pred, model
    nccl_case = "HWGATE/float32"
    nccl_job = dict(jobs[0], steps=["train", "params"], out=str(workdir / "nccl.out.pt"),
                    mesh=(1, 1, 1))
    (nccl, nccl_ranks), = run_jobs([nccl_job], 1, backend="nccl")
    check_parallel_launches("nccl", "window", nccl_ranks)
    ref = refs[nccl_case]
    same = (nccl["train"][0].item() == ref["loss"]
            and all(torch.equal(g.cuda(), ref["grads"][k]) for k, g in nccl["grads"].items())
            and all(torch.equal(v, ref["params"][k]) for k, v in nccl["params"].items()))
    if not same:
        raise AssertionError("the one-rank NCCL step is not the single-process step bit for bit")
    run_s = time.perf_counter() - t2
    emit("parallel", nvidia_smi=smi, ranks_share="cuda:0",
         backend="gloo (a, b, c), nccl (one rank)",
         meshes={"HWGATE": PARALLEL_HWGATE_MESH, "HGATE": PARALLEL_HGATE_MESH,
                 "Transformer": PARALLEL_TRANSFORMER_MESH,
                 "Transformer-sp": PARALLEL_TRANSFORMER_SP_MESH, "banded": PARALLEL_BANDED_MESH,
                 "GCNs": PARALLEL_GCN_MESH, "run_distributed": PARALLEL_RUN_MESH},
         tolerance={"logits": LOGIT_TOL, "grads": {"float32": GRAD_ATOL_F32,
                                                   "bfloat16": GRAD_REL_BF16}},
         results=out, host_ms_per_step=host_ms, launches_per_rank={
             case: {step: {k: n for k, n in counts.items() if n}
                    for step, counts in results[case][1][0]["launches"].items()}
             for case in results},
         launches_total=totals, run_distributed=run_out,
         nccl_one_rank={"bit_for_bit": True, "host_ms": nccl_ranks[0]["host_ms"]},
         seconds={"references": reference_s, "sharded_steps": steps_s, "runs": run_s,
                  "phase": time.perf_counter() - t0})
    return totals


# ---------------------------------------------------------------------------
# The scaling bench (phase 25).

SCALING_OPS = (("window", dict(units=12288, inner=10, outer=3)),
               ("banded", dict(frames=96, inner=10, outer=3)))
SCALING_CALLS = 40  # inner · (outer + 1) applications a rank and op
SCALING_TOL = 1e-5  # K8 ranks vs unsharded, K1 and K8 vs their plain versions


def phase_scaling(workdir: Path, smi: str) -> dict:
    """Phase 25: the scaling bench (``bench.scaling``) as ``measure(n)`` and
    ``measure_banded(n)`` run it, both ops in one spawn a scale: n = 1 over
    NCCL (a card a rank), then n = 2 as gloo ranks sharing cuda:0 (their
    lines say ``shared_card``; no scaling_efficiency line comes from them).
    Each rank launches exactly 40 K1 and 40 K8; its last K1 output is bit
    for bit the same units' 40 K1 calls in this process, its last K8 output
    within 1e-5 of its frames of the unsharded K8 calls on the ranks'
    frames joined. The first of those K1 calls (each rank's units) and of
    those K8 calls (the joined frames: 96 and 192) are held against their
    plain versions on the same inputs, within 1e-5. Returns each kernel's
    launches over the ranks and its largest error against its plain
    version."""
    import torch

    from sl_hwgat_tpu_torch.bench import scaling
    from sl_hwgat_tpu_torch.ops.banded_attention import banded_attention, plain_banded_attention
    from sl_hwgat_tpu_torch.ops.window_attention import plain_window_attention, window_attention

    def against_plain(name, got, want):
        err = (got - want).abs().max().item()
        if not err <= SCALING_TOL:
            raise AssertionError(f"scaling n={n}: {name} is {err} off its plain version "
                                 f"(> {SCALING_TOL})")
        return err

    t0 = time.perf_counter()
    records, checks = [], {}
    totals = {"window_attention": 0, "banded_attention": 0}
    plain_errors = {"window_attention": 0.0, "banded_attention": 0.0}
    for n in (1, 2):
        out_dir = workdir / f"n{n}"
        out_dir.mkdir()
        window, banded = scaling.run(n, list(SCALING_OPS), "cuda", str(out_dir))
        want_backend = ("nccl", False) if n <= torch.cuda.device_count() else ("gloo", True)
        for rec in (window, banded):
            if (rec["backend"], rec["shared_card"]) != want_backend:
                raise AssertionError(f"scaling n={n}: backend {rec['backend']}, shared "
                                     f"{rec['shared_card']}, not {want_backend}")
            if rec["launches_per_rank"] != [SCALING_CALLS] * n:
                raise AssertionError(f"scaling n={n} {rec.get('op', 'window')}: launches "
                                     f"{rec['launches_per_rank']}, not {SCALING_CALLS} a rank")
            if not (math.isfinite(rec["time_us"]) and rec["device_us"] > 0):
                raise AssertionError(f"scaling n={n}: times {rec}")
        totals["window_attention"] += sum(window["launches_per_rank"])
        totals["banded_attention"] += sum(banded["launches_per_rank"])
        records += [window, banded]
        adj, band = scaling.window_adj(), scaling.band()
        units = SCALING_OPS[0][1]["units"]
        k1_plain_err = 0.0
        for r in range(n):  # each rank's K1 units again, in this process
            q, k, v = (t.cuda() for t in scaling.window_inputs(units, r))
            kw = dict(scale=scaling.SCALE, stack=scaling.STACK)
            y = q
            with torch.no_grad():
                for call in range(SCALING_CALLS):
                    y = window_attention(y, k, v, adj, **kw)
                    if call == 0:
                        k1_plain_err = max(k1_plain_err, against_plain(
                            f"rank {r}'s first K1", y, plain_window_attention(q, k, v, adj, **kw)))
            got = torch.load(out_dir / f"0.{r}")["out"].cuda()
            if not torch.equal(got, y):
                raise AssertionError(f"scaling n={n}: rank {r}'s K1 output is not the "
                                     f"single-process K1's ({(got - y).abs().max().item()})")
        del q, k, v, y, got
        frames = SCALING_OPS[1][1]["frames"]
        q, k, v = (torch.cat(ts, 1).cuda()
                   for ts in zip(*(scaling.banded_inputs(frames, r) for r in range(n))))
        y = q
        with torch.no_grad():
            for call in range(SCALING_CALLS):
                y = banded_attention(y, k, v, band, scale=scaling.BANDED_SCALE)
                if call == 0:
                    k8_plain_err = against_plain("the first K8", y, plain_banded_attention(
                        q, k, v, band, scale=scaling.BANDED_SCALE))
        rows = frames * band.shape[1]
        err = max((torch.load(out_dir / f"1.{r}")["out"].cuda() - y[:, r * rows:(r + 1) * rows])
                  .abs().max().item() for r in range(n))
        if not err <= SCALING_TOL:
            raise AssertionError(f"scaling n={n}: the ranks' K8 outputs are {err} off the "
                                 f"unsharded K8's")
        checks[n] = {"k1_bit_for_bit": True, "k8_max_abs_err": err,
                     "k1_vs_plain_max_abs_err": k1_plain_err,
                     "k8_vs_plain_max_abs_err": k8_plain_err}
        plain_errors["window_attention"] = max(plain_errors["window_attention"], k1_plain_err)
        plain_errors["banded_attention"] = max(plain_errors["banded_attention"], k8_plain_err)
        del q, k, v, y
        torch.cuda.empty_cache()
    efficiency = [line for op in ("window", "banded_halo")
                  for line in scaling.efficiency_lines([r for r in records
                                                        if r.get("op", "window") == op])]
    if efficiency:  # the n = 2 points share the card: no scaling line
        raise AssertionError(f"scaling: efficiency lines from shared-card points {efficiency}")
    emit("scaling", nvidia_smi=smi, records=records, checks=checks, launches_total=totals,
         seconds=time.perf_counter() - t0)
    return totals, plain_errors


def kernel_entry(kind: str, name: str, replaces: str, launches: int, timings: dict,
                 errors: dict) -> dict:
    """One entry of the kernels line: HWGATE's f32 numbers at the top level
    (the serving path's type), bf16 under "bfloat16", HGATE's 58-token units
    under "HGATE/<dtype>"; single-mask times (the function the masked-SDPA
    yardstick computes too), dual-mask beside."""
    entry = {"name": name, "route": "cuda", "source": f"sl_hwgat_tpu_torch/csrc/{name}.cu",
             "replaces": replaces, "launches": launches}
    for dt, t in timings[kind].items():
        single, dual = t["cases"]["single"], t["cases"]["dual"]
        fields = {
            "ms": single["ms"], "kernel_ms": single["ms"], "plain_ms": single["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "max_abs_err": max(e for c, e in errors.items() if c.startswith(dt)),
            "dual_mask_ms": dual["ms"], "dual_mask_plain_ms": dual["plain_ms"],
        }
        if "device_ms" in single:
            fields.update(device_ms=single["device_ms"], dual_mask_device_ms=dual["device_ms"],
                          library_device_ms=t["library_device_ms"])
        if dt == "float32":
            entry.update(fields)
        else:
            entry[dt] = fields
    return entry


def case_entry(kind: str, name: str, replaces: str, launches: int, timings: dict,
               errors: dict, top: str) -> dict:
    """One entry of the kernels line from timings by "<model>/<dtype>" case:
    the ``top`` case's numbers at the top level (the serving path's model and
    type), the others under their case; max_abs_err over the error cases of
    that model and type (errors keyed "<model>/.../<dtype>")."""
    entry = {"name": name, "route": "cuda", "source": f"sl_hwgat_tpu_torch/csrc/{name}.cu",
             "replaces": replaces, "launches": launches}
    for case, t in timings[kind].items():
        model, dt = case.split("/")
        fields = {"ms": t["ms"], "kernel_ms": t["ms"], **t,
                  "max_abs_err": max(e for c, e in errors.items()
                                     if c.startswith(model + "/") and c.endswith(dt))}
        if case == top:
            entry.update(fields)
        else:
            entry[case] = fields
    return entry


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    if not (repo / "sl_hwgat_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: the sl_hwgat_tpu_torch package is not beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi()
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    from sl_hwgat_tpu_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build()
    emit("build", seconds=time.perf_counter() - t0,
         sources={n: {"seconds": r["seconds"],
                      "ptxas": [ln.strip() for ln in r["log"].splitlines()
                                if "registers" in ln or "spill" in ln]}
                  for n, r in report.items()})
    wide_kernels = wide_ptxas(report)
    emit("build_wide_kernels", ptxas=wide_kernels)
    redesigned = redesigned_ptxas(report)
    emit("build_redesigned_kernels", ptxas=redesigned)

    fwd_errors = phase_kernel()
    bwd_errors = phase_backward()
    fwd_errors.update(phase_kernel("HGATE"))
    bwd_errors.update(phase_backward("HGATE"))
    phase_forward()
    with tempfile.TemporaryDirectory() as tmp:
        serve_launches = phase_serve(Path(tmp))
    phase_train()
    with tempfile.TemporaryDirectory() as tmp:
        train_launches = phase_synth(Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        cli_launches = phase_cli(Path(tmp), repo)
    phase_baselines()
    with tempfile.TemporaryDirectory() as tmp:
        phase_cli_baselines(Path(tmp))
    banded_fwd_errors, banded_bwd_errors = phase_banded()
    phase_banded_forward()
    with tempfile.TemporaryDirectory() as tmp:
        banded_serve_launches = phase_banded_serve(Path(tmp))
    banded_train_launches = phase_banded_train()
    softmax_fwd_errors, softmax_bwd_errors = phase_masked_softmax()
    for errors, more in zip((softmax_fwd_errors, softmax_bwd_errors),
                            phase_masked_softmax_bf16_scores()):
        errors.update(more)
    edge_errors = phase_edge_cases()
    phase_windowed_forward()
    with tempfile.TemporaryDirectory() as tmp:
        windowed_serve_launches = phase_windowed_serve(Path(tmp))
    windowed_train_launches = phase_windowed_train()
    bf16_scores_launches = phase_hybrid_bf16_scores()
    timings = phase_timings()
    banded_timings = phase_banded_timings()
    windowed_timings = phase_windowed_timings()
    for kind in ("fwd", "bwd"):
        timings[kind].update(windowed_timings["window_attention"][kind])
    phase_profile()
    probe_errors = phase_probes()
    bench_launches = phase_bench_path()
    bench_steps = phase_bench_cli(repo)
    probe_timings = phase_probe_timings()
    step_launches = phase_step_bench(bench_steps, timings)
    with tempfile.TemporaryDirectory() as tmp:
        phase_ell(Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        tools_launches = phase_data_tools(Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        export_launches = phase_export(Path(tmp), repo)
    with tempfile.TemporaryDirectory() as tmp:
        parallel_launches = phase_parallel(Path(tmp), smi)
    with tempfile.TemporaryDirectory() as tmp:
        scaling_launches, scaling_errors = phase_scaling(Path(tmp), smi)

    from sl_hwgat_tpu_torch.bench import kernel as bench
    from sl_hwgat_tpu_torch.ops import banded_attention, hybrid_attention, probes, window_attention

    # launches of the main paths: the serving bursts and the AdamW/SYNTH runs
    served, trained = windowed_serve_launches, windowed_train_launches
    fwd = kernel_entry("fwd", window_attention.KERNEL,
                       "sl_hwgat_tpu/ops/pallas_attention.py:241 (_fwd_kernel), :228 "
                       "(_fwd_kernel_batched)",
                       serve_launches + served["window_attention"], timings, fwd_errors)
    fwd["hgate_serve_launches"] = served["window_attention"]
    fwd["train_launches"] = train_launches["fwd"] + trained["window_attention"]
    fwd["cli_launches"] = cli_launches["fwd"]
    fwd["bench_launches"] = bench_launches[window_attention.KERNEL]
    fwd["step_bench_launches"] = step_launches["window_attention"]
    fwd["data_tools_launches"] = tools_launches["fwd"]
    fwd["export_launches"] = export_launches[window_attention.KERNEL]
    fwd["parallel_launches"] = parallel_launches["window_attention"]
    fwd["scaling_launches"] = scaling_launches["window_attention"]
    fwd["scaling_max_abs_err"] = scaling_errors["window_attention"]
    fwd["wide_design"] = WIDE_DESIGN
    fwd["wide_ptxas"] = {n: r for n, r in wide_kernels.items() if "fwd" in n}
    fwd["edge_cases_max_abs_err"] = edge_errors["window_fwd"]
    blocks = redesigned_blocks()
    fwd.update(design=REDESIGNED[window_attention.KERNEL],
               ptxas=redesigned.get(window_attention.KERNEL),
               block=blocks[window_attention.KERNEL])
    bwd = kernel_entry("bwd", window_attention.KERNEL_BWD,
                       "sl_hwgat_tpu/ops/pallas_attention.py:295 (_bwd_kernel)",
                       train_launches["bwd"] + trained["window_attention_bwd"], timings,
                       bwd_errors)
    bwd["hgate_train_launches"] = trained["window_attention_bwd"]
    bwd["cli_launches"] = cli_launches["bwd"]
    bwd["step_bench_launches"] = step_launches["window_attention_bwd"]
    bwd["data_tools_launches"] = tools_launches["bwd"]
    bwd["parallel_launches"] = parallel_launches["window_attention_bwd"]
    bwd["wide_design"] = WIDE_DESIGN
    bwd["wide_ptxas"] = {n: r for n, r in wide_kernels.items() if "bwd" in n}
    bwd["edge_cases_max_abs_err"] = edge_errors["window_bwd"]
    dv_float64 = probe_errors["dv_float64"]
    bwd["dv_float64_worst_ratio"] = max(r for c, r in dv_float64.items() if c.endswith("/K2"))
    bwd.update(design=REDESIGNED[window_attention.KERNEL_BWD],
               ptxas=redesigned.get(window_attention.KERNEL_BWD),
               block=blocks[window_attention.KERNEL_BWD])
    bfwd = case_entry("fwd", banded_attention.KERNEL,
                      "sl_hwgat_tpu/ops/pallas_banded.py:408 (_fwd_kernel_packed); "
                      ":129 (_fwd_kernel)",
                      banded_serve_launches, banded_timings, banded_fwd_errors, "WGATE/float32")
    bfwd["train_launches"] = banded_train_launches["fwd"]
    bfwd["step_bench_launches"] = step_launches["banded_attention"]
    bfwd["export_launches"] = export_launches[banded_attention.KERNEL]
    bfwd["parallel_launches"] = parallel_launches["banded_attention"]
    bfwd["scaling_launches"] = scaling_launches["banded_attention"]
    bfwd["scaling_max_abs_err"] = scaling_errors["banded_attention"]
    bfwd["edge_cases_max_abs_err"] = edge_errors["banded_fwd"]
    bfwd.update(design=REDESIGNED[banded_attention.KERNEL],
                ptxas=redesigned.get(banded_attention.KERNEL),
                block=blocks[banded_attention.KERNEL])
    bbwd = case_entry("bwd", banded_attention.KERNEL_BWD,
                      "sl_hwgat_tpu/ops/pallas_banded.py:427 (_bwd_kernel_packed); "
                      ":146 (_bwd_kernel)",
                      banded_train_launches["bwd"], banded_timings, banded_bwd_errors,
                      "WGATE/float32")
    bbwd["edge_cases_max_abs_err"] = edge_errors["banded_bwd"]
    bbwd["step_bench_launches"] = step_launches["banded_attention_bwd"]
    bbwd["parallel_launches"] = parallel_launches["banded_attention_bwd"]
    bbwd.update(design=REDESIGNED[banded_attention.KERNEL_BWD],
                ptxas=redesigned.get(banded_attention.KERNEL_BWD),
                block=blocks[banded_attention.KERNEL_BWD])
    softmax_timings = windowed_timings["masked_softmax"]
    sfwd = case_entry("fwd", hybrid_attention.KERNEL,
                      "sl_hwgat_tpu/ops/hybrid_attention.py:46 (_softmax_fwd_kernel)",
                      served["masked_softmax"], softmax_timings, softmax_fwd_errors,
                      "HWGATE/float32")
    sfwd["train_launches"] = trained["masked_softmax"]
    sfwd["step_bench_launches"] = step_launches["masked_softmax"]
    sfwd["export_launches"] = export_launches[hybrid_attention.KERNEL]
    sfwd["parallel_launches"] = parallel_launches["masked_softmax"]
    sfwd["edge_cases_max_abs_err"] = edge_errors["softmax_fwd"]
    # the bf16-score instantiations (timings and errors under "<model>/bf16_scores")
    sfwd["bf16_scores_replaces"] = ("sl_hwgat_tpu/ops/hybrid_attention.py:46 under "
                                    ":172-179 (PALLAS_HYBRID_S_BF16=1, bf16 scores)")
    sfwd["bf16_scores_launches"] = bf16_scores_launches["masked_softmax"]
    sfwd.update(design=REDESIGNED[hybrid_attention.KERNEL],
                ptxas=redesigned.get(hybrid_attention.KERNEL),
                block=blocks[hybrid_attention.KERNEL])
    sbwd = case_entry("bwd", hybrid_attention.KERNEL_BWD,
                      "sl_hwgat_tpu/ops/hybrid_attention.py:61 (_softmax_bwd_kernel)",
                      trained["masked_softmax_bwd"], softmax_timings, softmax_bwd_errors,
                      "HWGATE/float32")
    sbwd["edge_cases_max_abs_err"] = edge_errors["softmax_bwd"]
    sbwd["step_bench_launches"] = step_launches["masked_softmax_bwd"]
    sbwd["bf16_scores_replaces"] = ("sl_hwgat_tpu/ops/hybrid_attention.py:61 under "
                                    ":172-179, dS in bf16 (:144)")
    sbwd["bf16_scores_launches"] = bf16_scores_launches["masked_softmax_bwd"]
    sbwd.update(design=REDESIGNED[hybrid_attention.KERNEL_BWD],
                ptxas=redesigned.get(hybrid_attention.KERNEL_BWD),
                block=blocks[hybrid_attention.KERNEL_BWD])
    stream, relay, mm = probes.KERNELS
    new = [probe_entry(stream, STREAM_REPLACES, bench_launches[stream],
                       probe_timings[stream], "copy_bf16", probe_errors[stream]),
           probe_entry(relay, RELAYOUT_REPLACES, bench_launches[relay],
                       probe_timings[relay], "xrelay_s0_bf16", probe_errors[relay]),
           probe_entry(mm, MATMUL_REPLACES, bench_launches[mm], probe_timings[mm],
                       "matmul_only/float32", probe_errors[mm])]
    for entry in new[1:3]:
        name = entry["name"]
        entry.update(design=REDESIGNED[name], ptxas=redesigned.get(name), block=blocks[name])
    layout, softmax_blocks = window_attention.KERNEL_LAYOUT, hybrid_attention.KERNEL_BLOCKS
    new.append(probe_entry(layout, LAYOUT_REPLACES, bench_launches[layout],
                           probe_timings[layout], "tmq_fused", probe_errors[layout]))
    new[3]["entries_max_abs_err"] = {e: probe_errors["fused"][e] for e in bench.LAYOUT_ENTRIES}
    new.append(probe_entry(softmax_blocks, "bench_kernel.py:1285 (softmax_only)",
                           bench_launches[softmax_blocks], probe_timings[softmax_blocks],
                           "softmax_only", probe_errors[softmax_blocks]))
    new[4]["softmax_only_max_abs_err"] = probe_errors["softmax_only"]["softmax_only"]
    layout_bwd = window_attention.KERNEL_LAYOUT_BWD
    new.append(probe_entry(layout_bwd, LAYOUT_BWD_REPLACES, bench_launches[layout_bwd],
                           probe_timings[layout_bwd], "bfloat16", probe_errors[layout_bwd]))
    new[5]["entries_max_abs_err"] = {e: probe_errors["fused"][e] for e in LAYOUT_BWD_ENTRIES}
    new[5]["dv_float64_worst_ratio"] = max(r for c, r in dv_float64.items() if "layout_bwd" in c)
    for entry in new[3:]:
        name = entry["name"]
        entry.update(design=REDESIGNED[name], ptxas=redesigned.get(name), block=blocks[name])
    print(json.dumps({"kernels": [fwd, bwd, bfwd, bbwd, sfwd, sbwd, *new]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
