"""Where the time of a kernel goes, by source variants that leave one phase out.

    python -m sl_hwgat_tpu_torch.bench.ablate [wide|banded|softmax|window32|banded_fwd|
                                               window32_fwd|tile|fused|layout|fused_bwd|
                                               relayout|wrappers|hybrid] [--parent DIR]

Builds variants of a kernel's sources that each leave one phase out, under
``build/ablate/<variant>/``, and prints one JSON line of the card's times
(``profiling.device_seconds``) of every variant. A variant's output is wrong
by design; only its time is read. The time a phase takes is about ``full``
minus its variant's. It needs a card and ``nvcc``, as ``chip_smoke.py`` does.

``wide`` (the default): K1 and K2 for wide units
(``csrc/window_attention_{fwd,bwd}.cu`` with ``window_attention_wide.cuh``)
at HGATE's batch-16 call (3072 units of 58 tokens × dh 64, single mask, no
pruning), f32 and bf16 in and out:

- ``full``: the kernels as they are;
- ``no_scores``: the kept scores are not computed (a stand-in value each);
- ``no_softmax``: the softmax after the scores is skipped;
- ``no_av``: K1's A·V product is skipped (bf16 and f32 alike);
- ``no_qk_staging``: K1 writes ones in place of the scaled q and k tiles.

``banded``: the banded backward (``csrc/banded_attention_bwd.cu``) at WGATE's
and GATE's batch-16 calls (512 planes × 192 frames × 16 joints, 128 × 192 ×
29; dh 16), f32 and bf16, under the models' band (K8) and, ``full`` only,
under the spatial plane as prev/next too (K9):

- ``full``: the kernel as it is;
- ``no_column``: the column phase (dK, dV) is skipped;
- ``no_d``: the dP dots are skipped (a stand-in value each, so D and dS
  still flow);
- ``no_scores``: every score dot is replaced by a stand-in value.

The variants follow the source's design, told by a line only that design
holds (``BANDED_DESIGNS``), so the same command ablates the kernel of an
older checkout.

``softmax``: K7's forward and backward (``csrc/masked_softmax_{fwd,bwd}.cu``)
at HWGATE's (12288 × 32 × 32) and HGATE's (3072 × 58 × 58) scores, single
mask, no pruning, scores f32 and bf16 each with P (forward) or dP
(backward) f32 and bf16 (the parent's build only where it takes bf16
scores), beside ``torch.softmax`` over the same masked scores in their
type and its backward (``torch.autograd.grad`` of its output, dP in the
scores' type; timed only). The variants follow the source's design
(``SOFTMAX_DESIGNS``); of the staged design (``staged``: each block's spans
of rows staged in shared memory by bulk copies, the output span stored
back by one; the backward on f32 scores and dP keeps the direct kernel,
each lane reading and writing its rows in device memory):

- ``full``: the kernels as they are;
- ``no_softmax``: P is the raw scores, dS the row sum's terms (the loads,
  mask lookups, the backward's row sum and the stores alone);
- ``guarded``: every span through the row loop with a guard on each row
  (otherwise only spans of a partial pass, or of unaligned rows);
- ``no_kN``: every n as an argument (no instantiations for HWGATE's 32
  and HGATE's 58 tokens);
- ``staged_f32_bwd``: the backward on f32 scores and dP staged too;
- ``stages_3``: three input stages instead of two;
- ``bounds_1``: the instantiations of 16 lanes a row (n > 32) free of the
  registers of 4 blocks an SM (ptxas then spills some);
- ``no_rows``: the staging alone (no row is computed);
- ``no_copies``: the rows alone (no bulk copy in or out);
- ``stage_16k``, ``stage_32k``: stages of about 16 or 32 KB of input and
  output instead of 24.

With ``--parent``, ``no_kN`` and ``staged_f32_bwd`` (whose outputs are the
kernels' own) are timed in turns with the parent and ``full`` and held bit
for bit against the parent's. The parent's sources may be of the direct
design (an earlier K7: each lane reads and writes its rows in device
memory), told by its forward's row loop, with ``full`` only.

The JSON line also gives ptxas's registers and spills of every build and
the blocks of 256 threads an SM holds by those registers. With
``--parent``, ``bit_equal_cases`` holds this checkout's P and dS against
the parent's bit for bit, through both checkouts' wrappers, beyond the
timed calls (``softmax_cases``: the dual mask by phase and by ``sel`` with
pruning at both shapes, 37 units of 58 and of 33 tokens, and those scores
one entry off a 16-byte boundary; every score and P / dP type).

``window32``: K2 for HWGATE's 32-token units (``csrc/window_attention_bwd.cu``)
at its batch-16 call (12288 units × 32 tokens × dh 64, no pruning), f32 and
bf16, single mask; with ``--parent``, single and dual mask in turns:

- ``full``: the kernel as it is;
- ``no_column``: the dV, dK and dQ products are skipped;
- ``no_da``: the dO·Vᵀ product is skipped (a stand-in value each, so dS
  still flows);
- ``no_scores``: the scores of ``attention_row`` (``window_attention_common.cuh``,
  which K1 shares) are stand-in values;
- ``eight_warps``: at most 8 warps an SM instead of 12 (the f32 kernel may
  then take 255 registers).

The JSON line of these two modes also gives ptxas's registers and spills
of every variant built.

``banded_fwd``: the banded forward (``csrc/banded_attention_fwd.cu``) at
WGATE's and GATE's batch-16 calls, f32 and bf16 in, f32 out (the models'
call), under the models' band and, ``full`` only, under the spatial plane
as prev/next too (K9):

- ``full``: the kernel as it is;
- ``no_stats``: the max and sum passes over a row's edges are skipped;
- ``no_av``: the A·V products are skipped (the probabilities are still
  computed);
- ``threads_64``, ``threads_256``: blocks of 64 or 256 threads instead of
  128 (each block takes threads / V frames).

``window32_fwd``: K1 for HWGATE's 32-token units (``csrc/window_attention_fwd.cu``)
at the same call as ``window32``, f32 and bf16 in and out, single mask;
with ``--parent``, single and dual mask in turns:

- ``full``: the kernel as it is;
- ``no_scores``: the scores of ``attention_row`` are stand-in values;
- ``no_av``: A.V and its stores are skipped (one value a lane is stored);
- ``warps_1``, ``warps_2``, ``warps_8``: units a block instead of 4.

``tile``: the tile products (``csrc/tile_matmul.cu``) at ``matmul_only``
(3072 tiles of 128 x 64, f32 and bf16 in), ``sn256`` (bf16) and K10 at
WGATE's and GATE's batch-16 calls (f32 and bf16 in, f32 out), beside two
``torch.matmul`` calls computing the same products (timed only):

- ``full``: the kernel as it is;
- ``no_second``: the second product, S.Z, is skipped.

The JSON line of these two modes also gives ptxas's registers and spills.

Like ``banded``, ``window32``, ``banded_fwd``, ``window32_fwd`` and ``tile``
tell the source's design by a line only it holds (``WINDOW32_DESIGNS``,
``BANDED_FWD_DESIGNS``, ``WINDOW32_FWD_DESIGNS``, ``TILE_DESIGNS``).

``fused`` (needs ``--parent``): the kernel bench's forward entries in TPU
layouts (``bench.kernel.LAYOUT_ENTRIES``: the fused probes, the forward
``pallas_t*``/``pallas_widepre_bf16`` entries, the kernel side of
``pair_tscore_bf16``) and ``softmax_only``, each as
``bench.kernel`` builds it in this checkout and in the parent's (its
``bench.kernel`` imported beside this one), timed in turns by their card
ms (``profiling.device_seconds``) and by events around back-to-back calls
(the host's launch gaps included), with ``bit_equal`` and this checkout's
launches per call; then ``window32_fwd`` against the parent (token-major
K1).

``wrappers`` (needs ``--parent``): the eager host path of the three forward
wrappers an eval forward calls (``window_attention``, ``masked_softmax``,
``banded_attention``), this checkout's and the parent's (imported beside
it), at small calls whose kernels take a few µs (64 units of 32 tokens × dh
64; 64 units of 32 × 32 scores; 8 planes of 4 frames × 29 joints × dh 16):
the host's µs a call over 500 back-to-back calls, in turns (12 samples
each), with ``bit_equal``.

``hybrid`` (needs ``--parent``): the kernel bench's ``hybrid``,
``hybrid_bf16``, ``hybrid_bwd`` and ``hybrid_bwd_bf16`` entries (the two
products around K7, forward and gradient) as ``bench.kernel`` builds them
in this checkout and in the parent's, in turns, as ``fused`` times its
entries; then, this checkout only (``this_checkout``), the ``hybrid_bf16``
call with f32 and with bf16 scores and its two products on f32 against
bf16 operands, card ms in turns.

``layout``: the layout kernel (``csrc/window_attention_layout.cu``) on one
bench entry of each instantiation and ``tlay_fused_bf16``, each variant
loaded in turn behind ``window_attention_into`` (``--parent`` is not read):

- ``full``: the kernel as it is;
- ``unbounded``: no minimum of 4 blocks an SM for bf16 (more registers);
- ``unit_u64``: each unit's offset by 64-bit divisions.

``fused_bwd`` (needs ``--parent``): the kernel bench's gradient entries in
TPU layouts (``pallas_tbwd_bf16``, ``pallas_tsbwd_bf16``,
``pallas_widebwd_bf16``) as ``bench.kernel`` builds them in this checkout
and in the parent's, in turns, as ``fused`` times the forward entries.

``relayout``: the relayout kernel (``csrc/relayout.cu``) on the bench's
transposes (its tiles both ways in bf16 and f32, the supertiles, the
widened planes, the packedpre entries' banded planes both ways) and row
gathers (``xrelay_*``, ``xstrided_*``), its C entry point called on the
same tensors; with ``--parent``, the parent's timed in turns, with
``bit_equal``.

``--parent DIR``: DIR holds another checkout of the repository (for
example ``git archive`` of the parent commit). Its ``full`` kernel is built
too and timed in turns with this one (parent, this, this, parent) on the
same inputs, and ``bit_equal`` says whether the two give the same bits.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from sl_hwgat_tpu_torch.graphs.adjacency import (
    additive_mask,
    hgate_block_adj,
    window_adj,
    windowed_block_adj,
)
from sl_hwgat_tpu_torch.graphs.skeleton import BODY29_EDGES, edges_to_dense
from sl_hwgat_tpu_torch.models.wgate import make_band
from sl_hwgat_tpu_torch.ops import _build
from sl_hwgat_tpu_torch.ops import banded_attention as ba
from sl_hwgat_tpu_torch.ops import hybrid_attention as ha
from sl_hwgat_tpu_torch.ops import probes
from sl_hwgat_tpu_torch.ops import window_attention as wa
from sl_hwgat_tpu_torch.ops.attention import masked_scores, unit_allowed
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

BANDED_HEADER, BANDED_BWD = "banded_attention_common.cuh", "banded_attention_bwd.cu"
# (design, a line only its banded_attention_bwd.cu holds, its variants as
# VARIANTS gives them, but each text may occur more than once)
BANDED_DESIGNS = (
    # every score recomputed in each pass and in the column phase
    ("recompute", "    const RowStats st = row_stats(qr, keys, b, nv, scale);\n", {
        "full": {},
        "no_column": {BANDED_BWD: [("  // Column phase: key j of frame f.\n",
                                    "  if (nv > 0) return;\n")]},
        "no_d": {BANDED_BWD: [(
            "        dsum += prob(dot(qr, keys + e) * scale, st) * dot(dor, vals + e);\n",
            "        dsum += 1e-3f * e;\n")]},
        "no_scores": {
            BANDED_HEADER: [("dot(qr, keys + (p * v + j) * kDH)", "(1e-3f * (p * v + j))")],
            BANDED_BWD: [("dot(qr, keys + e)", "(1e-4f * e)"), ("dot(kr, qi)", "(1e-4f * r)")]},
    }),
    # each score and dP once, A and dS cached by edge rank
    ("cache", "      if (e < cap) B.ca[e * stride + r] = s;\n", {
        "full": {},
        "no_column": {BANDED_BWD: [("  float out[kDH];\n  column<T, false>",
                                    "  if (nv > 0) return;\n  float out[kDH];\n"
                                    "  column<T, false>")]},
        "no_d": {BANDED_BWD: [("      const float dp = Staged<T>::dot(dor, B.vs, kr);\n",
                               "      const float dp = 1e-3f * e;\n")]},
        "no_scores": {BANDED_BWD: [(
            "      const float s = Staged<T>::dot(qr, B.ks, kr0 + p * nv + __ffs(bb) - 1) * "
            "B.scale;\n", "      const float s = 1e-3f * e;\n")]},
    }),
)
SOFTMAX_FWD, SOFTMAX_BWD = "masked_softmax_fwd.cu", "masked_softmax_bwd.cu"
SOFTMAX_COMMON = "masked_softmax_common.cuh"


# HWGATE's 32 and HGATE's 58 tokens launched by instantiations of their own,
# in both K7 sources
_SOFTMAX_KN = ("  if (a.n == 32) return launch<TS, TP, 8, kQuads, 32>(a);\n"
               "  if (a.n == 58) return launch<TS, TP, 16, kPairs, 58>(a);\n", "")

# (design, a line only its masked_softmax_fwd.cu holds, its variants; a
# variant edits both sources, the forward's and the backward's). The staged
# backward keeps the direct kernel for f32 scores and dP, so the staged
# design is told first.
SOFTMAX_DESIGNS = (
    # bf16 scores: each block's spans of rows staged in shared memory by
    # bulk copies, P or dS stored back by one
    ("staged", "              load_cols<kLanes, kMap, false>(ss + r * n, R.l, n, kWhole || vec, x);"
               "\n", {
        "full": {},
        "no_softmax": {
            SOFTMAX_FWD: [(
                "            masked_softmax_row<kLanes, kMap>(x, R.l, n, allowed, prune_u, "
                "zero_quirk, a);\n",
                "            for (int c = 0; c < kPer; ++c) a[c] = x[c] + (allowed & 1);\n")],
            SOFTMAX_BWD: [(
                "            const unsigned pass =\n"
                "                masked_softmax_row<kLanes, kMap>(x, R.l, n, allowed, prune_u, "
                "zero_quirk, a);\n",
                "            for (int c = 0; c < kPer; ++c) a[c] = x[c] + (allowed & 1);\n"
                "            const unsigned pass = 0xfu;\n")]},
        # the rows of every span through the guarded loop
        "guarded": {src: [("        if (vec && rows % R.kStep == 0) ", "        if (false) ")]
                    for src in (SOFTMAX_FWD, SOFTMAX_BWD)},
        # every n as an argument (no instantiation for 32 or 58 tokens)
        "no_kN": {src: [_SOFTMAX_KN] for src in (SOFTMAX_FWD, SOFTMAX_BWD)},
        # the backward on f32 scores and dP staged too (not the direct kernel)
        "staged_f32_bwd": {SOFTMAX_BWD: [(
            "  if constexpr (std::is_same<TS, float>::value && std::is_same<TP, float>::value)\n"
            "    return launch_direct<TS, TP, kLanes, kMap>(a);\n"
            "  else return launch_staged<TS, TP, kLanes, kMap, kN>(a);\n",
            "  return launch_staged<TS, TP, kLanes, kMap, kN>(a);\n")]},
        # three input stages (two spans' copies in flight besides this one)
        "stages_3": {SOFTMAX_COMMON: [("constexpr int kInStages = 2;",
                                       "constexpr int kInStages = 3;")]},
        # ptxas free of the registers of 4 blocks an SM at 16 lanes a row
        # (it then spills some instantiations)
        "bounds_1": {SOFTMAX_COMMON: [("constexpr int kMinBlocks = 4;",
                                       "constexpr int kMinBlocks = 1;")]},
        # the staging alone: no rows (the output stage stored as it is)
        "no_rows": {SOFTMAX_COMMON: [("    rows(s0, s1, so, count, first);\n", "")]},
        # the rows alone: no bulk copy in or out (the stages as they are)
        "no_copies": {SOFTMAX_COMMON: [
            ("    barrier_expect(full + st, p0.bulk + p1.bulk);\n",
             "    barrier_expect(full + st, 0u);\n"),
            ("    load_part(buf, in0 + e0, p0, full + st);\n"
             "    if (in1 != nullptr) load_part(buf + L.in1_offset, in1 + e0, p1, full + st);\n",
             ""),
            ("      if (po.bulk > 0u) {\n", "      if (po.bulk > 0u && e0 < 0) {\n")]},
        # stages of two thirds and four thirds the bytes
        **{f"stage_{kb}k": {SOFTMAX_COMMON: [("constexpr int kStageBytes = 24576;",
                                              f"constexpr int kStageBytes = {kb * 1024};")]}
           for kb in (16, 32)},
    }),
    # rows read and written in device memory by each lane (an earlier K7)
    ("direct",
     "    if (r < B.rows()) load_cols<kLanes, kMap>(s + B.offset(r), B.l, n, vec, x);\n",
     {"full": {}}),
)
# Variants whose output is the kernels' own: timed in turns with the parent
# and ``full`` and held bit for bit against the parent's
SOFTMAX_EXACT = ("no_kN", "staged_f32_bwd")
WINDOW_BWD, WINDOW_COMMON = "window_attention_bwd.cu", "window_attention_common.cuh"
BWD_UNIT = "window_attention_bwd_unit.cuh"
# (design, a line only the 32-token K2 of that design holds, its variants)
WINDOW32_DESIGNS = (
    # one warp per unit, a lane per query row, then a lane per column pair
    ("lane", "  column_product<T, DH, false>(k + base, dst, dq + base, lane, scale);\n", {
        "full": {},
        "no_column": {WINDOW_BWD: [(
            "  column_product<T, DH, true>(dout + base, at, dv + base, lane, 1.f);\n"
            "  column_product<T, DH, true>(q + base, dst, dk + base, lane, scale);\n"
            "  column_product<T, DH, false>(k + base, dst, dq + base, lane, scale);\n",
            "  dq[base + lane] = from_float<T>(at[lane] + dst[lane]);\n")]},
        "no_da": {WINDOW_BWD: [("  for (int h = 0; h < DH; h += 32) {\n",
                                "  for (int j = 0; j < kN; ++j) ds[j] = 1e-3f * j;\n"
                                "  for (int h = 0; h < 0; h += 32) {\n")]},
        "no_scores": {WINDOW_COMMON: [("      s[j] = acc;\n", "      s[j] = qr[j] + 1e-3f * j;\n")]},
    }),
    # the same, its row and product phases in window_attention_bwd_unit.cuh
    # (shared with the backward layout kernel)
    ("shared", "  bwd32::products_f32<DH, false>(io, at, dst, dst, kf, lane);\n", {
        "full": {},
        "no_column": {
            WINDOW_BWD: [("  bwd32::products_f32<DH, false>(io, at, dst, dst, kf, lane);\n",
                          "  dq[lane] = at[lane] + dst[lane];\n")],
            BWD_UNIT: [("    io.dq_product(p, acc);\n    io.store_dq(acc, r0, scale);\n",
                        "    io.store_dq(ds, r0, scale);\n"),
                       ("#pragma unroll 1\n  for (int r0 = 0; r0 < kN; r0 += 16) {\n"
                        "    float acc[DH / 8][4];\n    io.dv_product(at, r0, acc);\n",
                        "  if (DH > 0) return;\n#pragma unroll 1\n"
                        "  for (int r0 = 0; r0 < kN; r0 += 16) {\n"
                        "    float acc[DH / 8][4];\n    io.dv_product(at, r0, acc);\n")]},
        "no_da": {BWD_UNIT: [
            ("  for (int h = 0; h < DH; h += 16) {  // dO's row 16 columns at a time\n",
             "  for (int j = 0; j < kN; ++j) ds[j] = 1e-3f * j;\n"
             "  for (int h = 0; h < 0; h += 16) {\n"),
            ("  io.da(0, da[0]);\n  io.da(16, da[1]);\n",
             "  for (int st = 0; st < 2; ++st)\n    for (int j = 0; j < kN / 8; ++j)\n"
             "      for (int c = 0; c < 4; ++c) da[st][j][c] = 1e-3f * (j + c + lane);\n")]},
        "no_scores": {WINDOW_COMMON: [("      s[j] = acc;\n", "      s[j] = qr[j] + 1e-3f * j;\n")]},
        # at most 8 warps an SM instead of 12 (f32: 255 registers a thread)
        "eight_warps": {WINDOW_BWD: [("                                 : 12 / kWarps<T>;",
                                      "                                 : 8 / kWarps<T>;")]},
    }),
    # a lane per query row for A (attention_row), then 16-row strips of
    # register tiles (f32) or tensor-core products (bf16)
    ("strips", "  stage_unit<float, DH, DH>(dout, kf, lane);\n", {
        "full": {},
        "no_column": {WINDOW_BWD: [
            ("  constexpr int kHalves = DH / 32;\n",
             "  if (DH > 0) {\n    dq[lane] = at[lane] + dst[lane];\n    return;\n  }\n"
             "  constexpr int kHalves = DH / 32;\n"),
            ("    uint32_t p[kN / 16][4];\n    wide::to_a_operand(ds, p);\n"
             "    float acc[DH / 8][4];\n    wide::strip_ab<S>(p, kt, lane, acc);\n"
             "    wide::store_strip<DH>(dq, acc, r0, lane, kN, scale);\n",
             "    wide::store_strip<DH>(dq, ds, r0, lane, kN, scale);\n"),
            ("  for (int r0 = 0; r0 < kN; r0 += 16) {\n    float acc[DH / 8][4];\n",
             "  if (DH > 0) return;\n"
             "  for (int r0 = 0; r0 < kN; r0 += 16) {\n    float acc[DH / 8][4];\n")]},
        "no_da": {WINDOW_BWD: [
            ("  for (int h = 0; h < DH; h += 16) {  // dO's row 16 columns at a time\n",
             "  for (int j = 0; j < kN; ++j) ds[j] = 1e-3f * j;\n"
             "  for (int h = 0; h < 0; h += 16) {\n"),
            ("  wide::strip_abt<DH, S>(dot, vt, 0, lane, da[0]);\n"
             "  wide::strip_abt<DH, S>(dot, vt, 16, lane, da[1]);\n",
             "  for (int st = 0; st < 2; ++st)\n    for (int j = 0; j < kN / 8; ++j)\n"
             "      for (int c = 0; c < 4; ++c) da[st][j][c] = 1e-3f * (j + c + lane);\n")]},
        "no_scores": {WINDOW_COMMON: [("      s[j] = acc;\n", "      s[j] = qr[j] + 1e-3f * j;\n")]},
        # at most 8 warps an SM instead of 12 (f32: 255 registers a thread)
        "eight_warps": {WINDOW_BWD: [("                                 : 12 / kWarps<T>;",
                                      "                                 : 8 / kWarps<T>;")]},
    }),
)
WINDOW32_UNITS = 12288
BANDED_FWD = "banded_attention_fwd.cu"
# (design, a line only its banded_attention_fwd.cu holds, its variants)
BANDED_FWD_DESIGNS = (
    # three dots and two exps per edge: the max pass, the sum pass, A.V
    ("recompute", "  const RowStats st = row_stats(qr, keys, b, nv, scale);\n", {
        "full": {},
        "no_stats": {BANDED_FWD: [("  const RowStats st = row_stats(qr, keys, b, nv, scale);\n",
                                   "  const RowStats st{qr[0], 1.f + qr[1] * qr[1]};\n")]},
        "no_av": {BANDED_FWD: [("      if (p == 1) axpy(round_to<T>(a), vals + e, self);\n"
                                "      else axpy(a, vals + e, band);\n",
                                "      self[p] += a;\n")]},
    }),
    # each score once, the scores and then the exps cached by edge rank
    ("cache", "      if (e < cap) cache[e * stride + r] = s;\n", {
        "full": {},
        "no_stats": {BANDED_FWD: [
            ("  float m = -INFINITY;\n  int e = 0;\n#pragma unroll\n  for (int p = 0; p < 3; ++p)\n"
             "    for (uint32_t bb = b(p); bb; bb &= bb - 1, ++e) {\n"
             "      const float s = S::dot(qr, ks, kr0 + p * nv + __ffs(bb) - 1) * scale;\n"
             "      m = fmaxf(m, s);\n      if (e < cap) cache[e * stride + r] = s;\n    }\n",
             "  const float m = qr[0];\n  int e = 0;\n"),
            ("  float sum = 0.f;\n  e = 0;\n#pragma unroll\n  for (int p = 0; p < 3; ++p)\n"
             "    for (uint32_t bb = b(p); bb; bb &= bb - 1, ++e) {\n      float s;\n",
             "  float sum = 1.f + qr[1] * qr[1];\n  e = 0;\n#pragma unroll\n"
             "  for (int p = 0; p < 0; ++p)\n"
             "    for (uint32_t bb = b(p); bb; bb &= bb - 1, ++e) {\n      float s;\n")]},
        "no_av": {BANDED_FWD: [("      if (p == 1) S::axpy(round_to<T>(a), vs, kr, self);\n"
                                "      else S::axpy(a, vs, kr, band);\n",
                                "      self[p] += a;\n")]},
        # other block sizes: 64 and 256 threads (256 / V frames, half the halo)
        **{f"threads_{t}": {BANDED_FWD: [("constexpr int kFwdThreads = 128;",
                                          f"constexpr int kFwdThreads = {t};")]}
           for t in (64, 256)},
    }),
)
WINDOW_FWD = "window_attention_fwd.cu"
# (design, a line only the 32-token K1 of that design holds, its variants)
WINDOW32_FWD_DESIGNS = (
    # a lane per query row (attention_row), then a lane per output column:
    # V and O by 2- or 4-byte accesses, A.V from a padded probability tile
    ("lane", "      vr[j][c] = to_float(v[base + j * DH + c * 32 + lane]);\n", {
        "full": {},
        "no_scores": {WINDOW_COMMON: [("      s[j] = acc;\n", "      s[j] = qr[j] + 1e-3f * j;\n")]},
    }),
    # q staged by cp.async, k as f32 rows, A from attention_row, v over q
    # once the query rows are in registers; A.V in register tiles (f32) or
    # on mma.sync (bf16), 16-byte stores
    ("staged", "  attend_values<DH>(e, sum, ks, vt, o + base, lane);\n", {
        "full": {},
        "no_scores": {WINDOW_COMMON: [("      s[j] = acc;\n", "      s[j] = qr[j] + 1e-3f * j;\n")]},
        # A.V and its stores left out: one value a lane keeps the softmax live
        "no_av": {WINDOW_FWD: [(
            "  attend_values<DH>(e, sum, ks, vt, o + base, lane);\n",
            "  o[base + lane] = from_float<TO>((e[0] + e[kN - 1]) / sum + to_float(vt[lane]));\n")]},
        **{f"warps_{w}": {WINDOW_FWD: [("constexpr int kWarps = 4;", f"constexpr int kWarps = {w};")]}
           for w in (1, 2, 8)},
    }),
)
TILE = "tile_matmul.cu"
# (design, a line only its tile_matmul.cu holds, its variants)
TILE_DESIGNS = (
    # f32 FMAs in 4 x 4 tiles a thread for every type, 64-row slices
    ("simt4x4", "    product_nt(xs, ldx, yz, ldy, k, col0, ms, acc);\n", {"full": {}}),
    # bf16 on mma.sync (S in registers, fed back as the A operand), f32 in
    # 8 x 4 register tiles over depth-major X and Y
    ("mma", "      strip_pz(p, zs + n0 * L.zld + c0, L.zld, lane, acc);\n", {
        "full": {},
        # S Z left out: each S chunk's bits folded into the output
        "no_second": {TILE: [
            ("        strip_pz(p, zs + n0 * L.zld + c0, L.zld, lane, acc);\n",
             "        acc[0][0] += __uint_as_float(p[0][0] ^ p[3][3]) + __bfloat162float(zs[lane]);\n"),
            ("#pragma unroll 4\n    for (int j = 0; j < jn; ++j) {",
             "    acc[0][0] += stt[threadIdx.x] + zs[threadIdx.x];\n"
             "#pragma unroll 4\n    for (int j = 0; j < 0; ++j) {")]},
    }),
)
BANDED_SHAPES = {"WGATE": (512, 192, 16), "GATE": (128, 192, 29)}
BANDED_DH, BANDED_SCALE = 16, 0.25
SOFTMAX_SHAPES = {"HWGATE": (12288, 32), "HGATE": (3072, 58)}


def build_variant(name: str, edits: dict, sources, csrc: Path = _build.CSRC_DIR,
                  count_once: bool = True) -> list[subprocess.Popen]:
    """Copy the sources of ``csrc`` into ``build/ablate/<name>``, apply
    ``edits`` and start nvcc on each of ``sources``; returns the processes."""
    out = ABLATE_DIR / name
    out.mkdir(parents=True, exist_ok=True)
    for path in Path(csrc).iterdir():
        shutil.copy(path, out / path.name)
    for fname, replacements in edits.items():
        text = (out / fname).read_text()
        for old, new in replacements:
            if old not in text or (count_once and text.count(old) != 1):
                raise ValueError(f"{name}: {fname} no longer holds {old.strip()[:60]!r} once")
            text = text.replace(old, new)
        (out / fname).write_text(text)
    return [subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                              str(out / f"lib{src}.so"), str(out / f"{src}.cu")],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for src in sources]


def wait(jobs: dict) -> dict | None:
    """Wait for every build of ``jobs`` ({variant: processes}); {variant:
    ptxas's register and spill lines}, or None (and a message) if one
    failed."""
    ok, ptxas = True, {}
    for name, procs in jobs.items():
        for proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                print(f"bench.ablate: {name} failed to build\n{err[-3000:]}", file=sys.stderr)
                ok = False
            ptxas.setdefault(name, []).extend(
                ln.split(":", 1)[-1].strip() for ln in err.splitlines()
                if "registers" in ln or "spill stores" in ln)
    return ptxas if ok else None


def entry(name: str, src: str, argtypes=None):
    fn = getattr(ctypes.CDLL(str(ABLATE_DIR / name / f"lib{src}.so")), src)
    fn.restype = ctypes.c_int
    fn.argtypes = [_build._CTYPES[t] for t in
                   (argtypes or {**wa._ARGTYPES, **ba._ARGTYPES, **probes._ARGTYPES}[src])]
    return fn


def device_ms(call) -> float:
    if call() != 0:
        raise RuntimeError("launch failed")
    torch.cuda.synchronize()
    return profiling.device_seconds(call, calls=20) * 1e3


def in_turns(calls: dict, rounds: int = 2, timer=device_ms) -> dict:
    """{name: [ms, ...]} of the calls timed in turns by ``timer`` (default
    ``device_ms``, of a C entry): a, b, b, a, ..."""
    names, times = list(calls), {n: [] for n in calls}
    for i in range(rounds):
        for n in (names if i % 2 == 0 else names[::-1]):
            times[n].append(timer(calls[n]))
    return times


def run_wide(parent) -> dict:
    builds = {name: (_build.CSRC_DIR, edits) for name, edits in VARIANTS.items()}
    if parent is not None:
        builds["parent"] = (Path(parent) / "sl_hwgat_tpu_torch" / "csrc", {})
    jobs = {name: build_variant(name, edits, (wa.KERNEL, wa.KERNEL_BWD), csrc)
            for name, (csrc, edits) in builds.items()}
    if not wait(jobs):
        return {}
    masks = wa.device_masks(hgate_block_adj(), None, "cuda")
    rng = np.random.default_rng(0)
    times, pairs, equal = {}, {}, {}
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        q, k, v, do = (torch.from_numpy(rng.normal(size=(UNITS, TOKENS, DH)).astype(np.float32))
                       .cuda().to(dtype) for _ in range(4))
        outs = {name: [torch.empty_like(q) for _ in range(4)] for name in builds}  # o, dq, dk, dv
        stream = torch.cuda.current_stream().cuda_stream
        mode = (SCALE, 1, 0, 2, 0, 0, 0, stream)  # scale, zero quirk, single mask, stack 2
        calls = {}
        for name in builds:
            fwd, bwd = entry(name, wa.KERNEL), entry(name, wa.KERNEL_BWD)
            o, dq, dk, dv = (t.data_ptr() for t in outs[name])
            calls[name] = {
                "fwd": lambda fwd=fwd, o=o: fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o,
                                                masks.data_ptr(), None, None, UNITS, TOKENS, DH,
                                                code, code, *mode),
                "bwd": lambda bwd=bwd, dq=dq, dk=dk, dv=dv: bwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq, dk, dv,
                    masks.data_ptr(), None, None, UNITS, TOKENS, DH, code, *mode),
            }
        for name in VARIANTS:
            for kind, call in calls[name].items():
                times[f"{name}/{kind}/{str(dtype).split('.')[1]}"] = device_ms(call)
        if parent is not None:
            for kind in ("fwd", "bwd"):
                case = f"{kind}/{str(dtype).split('.')[1]}"
                pairs[case], equal[case] = paired(
                    {n: calls[n][kind] for n in ("parent", "full")},
                    {n: outs[n][:1] if kind == "fwd" else outs[n][1:] for n in ("parent", "full")})
    out = {"device_ms": times, "shape": [UNITS, TOKENS, DH]}
    if parent is not None:
        out.update(paired_device_ms=pairs, bit_equal=equal)
    return out


def design_of(csrc: Path, fname: str, designs):
    """(design, variants) of the kernel in ``csrc``/``fname``: the first of
    ``designs`` whose marker line the source holds."""
    text = (Path(csrc) / fname).read_text()
    for design, marker, variants in designs:
        if marker in text:
            return design, variants
    raise ValueError(f"{Path(csrc) / fname}: no known design")


def banded_design(csrc: Path):
    """(design, variants) of the banded backward in ``csrc``."""
    return design_of(csrc, BANDED_BWD, BANDED_DESIGNS)


def banded_bands() -> dict:
    """{model: (the model's band, the spatial plane as all three)}."""
    spatial = {"WGATE": window_adj(window_size=16),
               "GATE": edges_to_dense(BODY29_EDGES, 29, self_loops=False)}
    return {m: (make_band(a), np.stack([additive_mask(a)] * 3)) for m, a in spatial.items()}


def banded_call(fn, design: str, tensors, band, planes, frames, joints, code):
    """A launch of the banded backward ``fn`` of ``design`` on ``tensors``
    (q, k, v, dO, dq, dk, dv)."""
    ptrs = [t.data_ptr() for t in tensors]
    bits = ba._bits(band, "cuda").data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    if design == "recompute":
        return lambda: fn(*ptrs, bits, planes, frames, joints, BANDED_DH, code, BANDED_SCALE,
                          stream)
    return lambda: fn(*ptrs, bits, planes, frames, joints, BANDED_DH, code,
                      ba.edges_per_row(band), BANDED_SCALE, stream)


def run_banded(parent) -> dict:
    fns, _ = variant_builds(BANDED_DESIGNS, parent, BANDED_BWD, ba.KERNEL_BWD)
    if not fns:
        return {}
    design, variants = banded_design(_build.CSRC_DIR)
    rng = np.random.default_rng(0)
    times, pairs, equal = {}, {}, {}
    for model, (planes, frames, joints) in BANDED_SHAPES.items():
        band, spatial = banded_bands()[model]
        base = [rng.normal(size=(planes, frames * joints, BANDED_DH)).astype(np.float32)
                for _ in range(4)]
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            case = f"{model}/{str(dtype).split('.')[1]}"
            inputs = [torch.from_numpy(x * (0.2 if i >= 2 else 1.0)).cuda().to(dtype)
                      for i, x in enumerate(base)]
            outs = {name: [torch.empty_like(inputs[0]) for _ in range(3)] for name in fns}
            calls = {name: banded_call(fn, d, inputs + outs[name], band, planes, frames,
                                       joints, code) for name, (d, fn) in fns.items()}
            for name in variants:
                times[f"{name}/{case}"] = device_ms(calls[name])
            d, fn = fns["full"]
            times[f"full/{case}/nondiagonal_band"] = device_ms(banded_call(
                fn, d, inputs + outs["full"], spatial, planes, frames, joints, code))
            if parent is not None:
                pairs[case], equal[case] = paired(calls, outs)
    out = {"design": design, "device_ms": times,
           "shapes": {m: [*s, BANDED_DH] for m, s in BANDED_SHAPES.items()}}
    if parent is not None:
        out.update(parent_design=fns["parent"][0], paired_device_ms=pairs, bit_equal=equal)
    return out


# K7's entries before they took the scores' type (f32 scores only)
SOFTMAX_F32_SCORES_ARGTYPES = {ha.KERNEL: ["p"] * 5 + ["ll"] + ["i"] * 7 + ["ll", "p"],
                               ha.KERNEL_BWD: ["p"] * 6 + ["ll"] + ["i"] * 7 + ["ll", "p"]}
SOFTMAX_TYPES = (torch.float32, torch.bfloat16)


def occupancy(ptxas: list) -> list:
    """Blocks of 256 threads an SM can hold by each kernel's registers in
    ``ptxas`` lines (in order; 64 Ki registers an SM, allocated 8 a thread
    at a time, at most 8 such blocks)."""
    regs = [int(ln.split("Used ")[1].split()[0]) for ln in ptxas if "Used " in ln]
    return [min(8, 65536 // (256 * (-(-r // 8) * 8))) for r in regs]


def softmax_cases(device="cuda"):
    """(case, scores f32, adj, kwargs) of K7 beyond the timed single-mask
    calls: both models' shapes under the dual mask by the temporal-group
    phase and by ``sel``, with pruning; 37 units of 58 and of 33 tokens at
    stack 1 (ragged spans; 33: no span 16-byte aligned in bf16), and those
    scores as a view one entry into its storage (no tensor 16-byte
    aligned). Scores at twice unit scale, one entry in 7 exactly 0 (the
    zero quirk)."""
    from sl_hwgat_tpu_torch.models.hwgate import shift_tail_mask

    g = torch.Generator(device=device).manual_seed(0)

    def scores(units, n):
        s = torch.randn(units, n, n, generator=g, device=device) * 2.0
        return s.masked_fill(torch.rand(s.shape, generator=g, device=device) < 1 / 7, 0.0)

    prune = torch.full((1,), 0.3, device=device)
    for model, (units, n) in SOFTMAX_SHAPES.items():
        adj = windowed_block_adj(2)[0] if model == "HWGATE" else hgate_block_adj()
        tail = adj * shift_tail_mask(16 if model == "HWGATE" else 29, 2, 1)
        stack = 4 if model == "HWGATE" else 2
        s = scores(units, n)
        sel = (torch.rand(units // stack, generator=g, device=device) < 0.5).int()
        yield f"{model}/dual_phase/prune", s, adj, dict(
            stack=stack, tail_adj=tail, units_per_group=8 if model == "HWGATE" else 2,
            groups=96, prune_u=prune)
        yield f"{model}/dual_sel/prune", s, adj, dict(
            stack=stack, tail_adj=tail, units_per_group=stack, groups=2, sel=sel, prune_u=prune)
    for n in (58, 33):
        rng = np.random.default_rng(n)
        a = rng.random((n, n)) < 3.0 / n
        adj = (a | a.T | np.eye(n, dtype=bool)).astype(np.float32)
        tail = adj * (rng.random((n, n)) < 0.5)
        np.fill_diagonal(tail, 1.0)
        s = scores(37, n)
        sel = (torch.rand(37, generator=g, device=device) < 0.5).int()
        kw = dict(stack=1, tail_adj=tail, units_per_group=1, groups=2, sel=sel, prune_u=prune)
        yield f"37x{n}/dual_sel/prune", s, adj, kw
        view = torch.empty(s.numel() + 1, device=device)[1:].view(s.shape)
        view.copy_(s)
        yield f"37x{n}/offset_view/dual_sel/prune", view, adj, kw


def softmax_equal_cases(parent) -> dict:
    """{case: whether this checkout's K7 gives the parent's P and dS bit for
    bit} at ``softmax_cases``, through each checkout's wrappers (the
    parent's imported beside these), scores and P / dP in f32 and bf16."""
    ph, pbuild = parent_modules(Path(parent), names=("ops.hybrid_attention", "ops._build"))
    pbuild.build((ha.KERNEL, ha.KERNEL_BWD))
    _build.build((ha.KERNEL, ha.KERNEL_BWD))
    g = torch.Generator(device="cuda").manual_seed(1)
    equal = {}
    with torch.no_grad():
        for case, s32, adj, kw in softmax_cases():
            dp32 = torch.randn(s32.shape, generator=g, device="cuda") * 0.2
            for st in SOFTMAX_TYPES:
                # a view one entry in stays a view one entry in, in either type
                s = s32 if st == torch.float32 else s32.to(st)
                if s32.storage_offset() and st != torch.float32:
                    s = torch.empty(s32.numel() + 1, dtype=st, device="cuda")[1:].view(
                        s32.shape).copy_(s32)
                sname = str(st).split(".")[1]
                for ot in SOFTMAX_TYPES:
                    oname = str(ot).split(".")[1]
                    dp = dp32.to(ot)
                    equal[f"{case}/fwd/s_{sname}/p_{oname}"] = torch.equal(
                        ha.masked_softmax(s, adj, p_dtype=ot, **kw),
                        ph.masked_softmax(s, adj, p_dtype=ot, **kw))
                    equal[f"{case}/bwd/s_{sname}/dp_{oname}"] = torch.equal(
                        ha.masked_softmax_bwd(s, dp, adj, **kw),
                        ph.masked_softmax_bwd(s, dp, adj, **kw))
    return equal


def run_softmax(parent) -> dict:
    design, variants = design_of(_build.CSRC_DIR, SOFTMAX_FWD, SOFTMAX_DESIGNS)
    builds = {name: (_build.CSRC_DIR, edits) for name, edits in variants.items()}
    if parent is not None:
        builds["parent"] = (Path(parent) / "sl_hwgat_tpu_torch" / "csrc", {})
    jobs = {name: build_variant(name, edits, (ha.KERNEL, ha.KERNEL_BWD), csrc)
            for name, (csrc, edits) in builds.items()}
    ptxas = wait(jobs)
    if ptxas is None:
        return {}
    # whether a build's entries take the scores' type
    typed = {name: "int s_dtype" in (Path(csrc) / SOFTMAX_FWD).read_text()
             for name, (csrc, _) in builds.items()}
    fns = {name: {src: entry(name, src, ha._ARGTYPES[src] if typed[name]
                             else SOFTMAX_F32_SCORES_ARGTYPES[src])
                  for src in (ha.KERNEL, ha.KERNEL_BWD)} for name in builds}
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    times, pairs, equal = {}, {}, {}
    for model, (units, n) in SOFTMAX_SHAPES.items():
        adj = windowed_block_adj(2)[0] if model == "HWGATE" else hgate_block_adj()
        stack = 4 if model == "HWGATE" else 2
        masks = wa.device_masks(adj, None, "cuda", wide=True)
        s32 = torch.from_numpy(rng.normal(size=(units, n, n)).astype(np.float32)).cuda()
        dp32 = torch.from_numpy(rng.normal(size=(units, n, n)).astype(np.float32) * 0.2).cuda()
        allowed = unit_allowed(adj, None, None, units, stack, s32.device)
        for st in SOFTMAX_TYPES:
            s = s32.to(st)
            s_code = int(st == torch.bfloat16)
            sname = str(st).split(".")[1]
            names = [name for name in fns if typed[name] or not s_code]
            masked = masked_scores(s32, allowed, zero_quirk=True, prune_u=None).to(st)
            leaf = masked.detach().requires_grad_()
            p_lib = torch.softmax(leaf, -1)
            dp_lib = dp32.to(st)
            times[f"torch.softmax/{model}/fwd/s_{sname}"] = profiling.device_seconds(
                lambda: torch.softmax(masked, -1), calls=20) * 1e3
            times[f"torch.softmax/{model}/bwd/s_{sname}"] = profiling.device_seconds(
                lambda: torch.autograd.grad(p_lib, leaf, dp_lib, retain_graph=True),
                calls=20) * 1e3
            for ot in SOFTMAX_TYPES:  # P's type (forward), dP's type (backward)
                code = int(ot == torch.bfloat16)
                oname = str(ot).split(".")[1]
                dp = dp32.to(ot)
                outs = {name: {"fwd": [torch.empty(s.shape, dtype=ot, device="cuda")],
                               "bwd": [torch.empty_like(s)]} for name in names}
                mode = (1, 0, stack, 0, 0, 0, stream)  # zero quirk, single mask
                for kind in ("fwd", "bwd"):
                    case = f"{model}/{kind}/s_{sname}/{'p' if kind == 'fwd' else 'dp'}_{oname}"
                    calls = {}
                    for name in names:
                        fn, out = fns[name][ha.KERNEL if kind == "fwd" else ha.KERNEL_BWD], \
                            outs[name][kind][0]
                        types = ((s_code,) if typed[name] else ()) + (code,)
                        ins = (s.data_ptr(),) if kind == "fwd" else (s.data_ptr(), dp.data_ptr())
                        calls[name] = (lambda fn=fn, ins=ins, o=out.data_ptr(), types=types: fn(
                            *ins, o, masks.data_ptr(), None, None, units, n, *types, *mode))
                    for name in variants:
                        times[f"{name}/{case}"] = device_ms(calls[name])
                    if "parent" in calls:
                        pairs[case], equal[case] = paired(
                            calls, {name: outs[name][kind] for name in calls},
                            ("parent", "full", *(v for v in SOFTMAX_EXACT if v in variants)))
            del s, masked, leaf, p_lib, dp_lib
    out = {"design": design, "device_ms": times, "ptxas": ptxas,
           "blocks_per_sm_by_registers": {name: occupancy(lines) for name, lines in ptxas.items()},
           "scores": {m: [u, n, n] for m, (u, n) in SOFTMAX_SHAPES.items()},
           "note": "torch.softmax: over the masked scores in their type; bwd: "
                   "torch.autograd.grad of its output, dP in the scores' type"}
    if parent is not None:
        out.update(parent_design=design_of(builds["parent"][0], SOFTMAX_FWD, SOFTMAX_DESIGNS)[0],
                   paired_device_ms=pairs, bit_equal=equal,
                   bit_equal_cases=softmax_equal_cases(parent))
    return out


def variant_builds(csrc_designs, parent, fname: str, src: str) -> dict:
    """({name: (design, entry)}, {name: ptxas lines}) of this checkout's
    variants of ``src`` and, with ``parent``, the parent's ``full`` kernel,
    built in parallel; ({}, {}) if a build failed."""
    design, variants = design_of(_build.CSRC_DIR, fname, csrc_designs)
    builds = {(name, design, _build.CSRC_DIR): edits for name, edits in variants.items()}
    if parent is not None:
        pcsrc = Path(parent) / "sl_hwgat_tpu_torch" / "csrc"
        builds[("parent", design_of(pcsrc, fname, csrc_designs)[0], pcsrc)] = {}
    jobs = {name: build_variant(name, edits, (src,), csrc, count_once=False)
            for (name, _, csrc), edits in builds.items()}
    ptxas = wait(jobs)
    if ptxas is None:
        return {}, {}
    return {name: (d, entry(name, src, argtypes=_ARGTYPES_OF.get((src, d))))
            for name, d, _ in builds}, ptxas


def paired(calls: dict, outs: dict, names=("parent", "full")) -> tuple[dict, bool]:
    """(``names``, the parent first, timed in turns, whether their outputs
    equal the parent's bit for bit after one more call each)."""
    times = in_turns({n: calls[n] for n in names})
    for n in names:
        calls[n]()
    torch.cuda.synchronize()
    return times, all(torch.equal(a, b) for n in names[1:]
                      for a, b in zip(outs["parent"], outs[n]))


def run_window32(parent) -> dict:
    from sl_hwgat_tpu_torch.models.hwgate import shift_tail_mask

    fns, ptxas = variant_builds(WINDOW32_DESIGNS, parent, WINDOW_BWD, wa.KERNEL_BWD)
    if not fns:
        return {}
    adj = windowed_block_adj(2)[0]
    masks = wa.device_masks(adj, adj * shift_tail_mask(16, 2, 1), "cuda")
    # (dual, stack, units per temporal group, groups, unit offset): stage 0 at batch 16
    modes = {"single": (0, 4, 0, 0, 0), "dual": (1, 4, 8, 96, 0)}
    rng = np.random.default_rng(0)
    shape = (WINDOW32_UNITS, 32, 64)
    base = [rng.normal(size=shape).astype(np.float32) * (0.2 if i == 2 else 1.0)
            for i in range(4)]
    times, pairs, equal = {}, {}, {}
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        q, k, v, do = (torch.from_numpy(x).cuda().to(dtype) for x in base)
        outs = {name: [torch.empty_like(q) for _ in range(3)] for name in fns}
        stream = torch.cuda.current_stream().cuda_stream
        for mode, mask_args in modes.items():
            calls = {name: (lambda fn=fn, o=outs[name]: fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                *(t.data_ptr() for t in o), masks.data_ptr(), None, None, shape[0], shape[1],
                shape[2], code, 0.125, 1, *mask_args, stream)) for name, (_, fn) in fns.items()}
            case = f"{str(dtype).split('.')[1]}/{mode}"
            if mode == "single":
                for name in fns:
                    if name != "parent":
                        times[f"{name}/{case}"] = device_ms(calls[name])
            if parent is not None:
                pairs[case], equal[case] = paired(calls, outs)
    out = {"design": fns["full"][0], "device_ms": times, "shape": list(shape), "ptxas": ptxas}
    if parent is not None:
        out.update(parent_design=fns["parent"][0], paired_device_ms=pairs, bit_equal=equal)
    return out


def run_window32_fwd(parent) -> dict:
    from sl_hwgat_tpu_torch.models.hwgate import shift_tail_mask

    fns, ptxas = variant_builds(WINDOW32_FWD_DESIGNS, parent, WINDOW_FWD, wa.KERNEL)
    if not fns:
        return {}
    adj = windowed_block_adj(2)[0]
    masks = wa.device_masks(adj, adj * shift_tail_mask(16, 2, 1), "cuda")
    modes = {"single": (0, 4, 0, 0, 0), "dual": (1, 4, 8, 96, 0)}
    rng = np.random.default_rng(0)
    shape = (WINDOW32_UNITS, 32, 64)
    base = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    times, pairs, equal = {}, {}, {}
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        q, k, v = (torch.from_numpy(x).cuda().to(dtype) for x in base)
        outs = {name: [torch.empty_like(q)] for name in fns}
        stream = torch.cuda.current_stream().cuda_stream
        for mode, mask_args in modes.items():
            calls = {name: (lambda fn=fn, o=outs[name][0]: fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), masks.data_ptr(), None,
                None, shape[0], shape[1], shape[2], code, code, 0.125, 1, *mask_args, stream))
                for name, (_, fn) in fns.items()}
            case = f"{str(dtype).split('.')[1]}/{mode}"
            for name in fns:
                if name != "parent" and (mode == "single" or name == "full"):
                    times[f"{name}/{case}"] = device_ms(calls[name])
            if parent is not None:
                pairs[case], equal[case] = paired(calls, outs)
    out = {"design": fns["full"][0], "device_ms": times, "shape": list(shape), "ptxas": ptxas}
    if parent is not None:
        out.update(parent_design=fns["parent"][0], paired_device_ms=pairs, bit_equal=equal)
    return out


# tile_matmul's cases: (planes, tiles, rows, depth, C, in dtype, out dtype)
# of matmul_only (the bench's 3072 tiles of 128 x 64), sn256 and K10 at
# WGATE's and GATE's batch-16 calls (tiles of 8 frames x 16 joints and 4 x 29)
TILE_CASES = {
    "matmul_only/float32": (1, 3072, 128, 64, 64, torch.float32, torch.float32),
    "matmul_only/bfloat16": (1, 3072, 128, 64, 64, torch.bfloat16, torch.float32),
    "sn256/bfloat16": (1, 1536, 256, 64, 64, torch.bfloat16, torch.bfloat16),
    "K10/WGATE/float32": (512, 24, 128, 16, 16, torch.float32, torch.float32),
    "K10/WGATE/bfloat16": (512, 24, 128, 16, 16, torch.bfloat16, torch.float32),
    "K10/GATE/float32": (128, 48, 116, 16, 16, torch.float32, torch.float32),
    "K10/GATE/bfloat16": (128, 48, 116, 16, 16, torch.bfloat16, torch.float32),
}


def tile_call(fn, x, y, z, out):
    """A launch of the tile-product entry ``fn`` on (planes, tiles, rows, ·)
    views: O = round(X·Yᵀ)·Z (mode 0), as ``probes.tile_matmul`` calls it."""
    planes, tiles, rows, depth = x.shape
    strides = (ctypes.c_longlong * 16)(*(s for t in (x, y, z, out) for s in t.stride()))
    codes = [probes._DTYPE_CODE[t.dtype] for t in (x, out)]
    stream = torch.cuda.current_stream().cuda_stream
    return lambda: fn(x.data_ptr(), y.data_ptr(), z.data_ptr(), out.data_ptr(),
                      ctypes.addressof(strides), planes, tiles, rows, depth, out.shape[3], 0,
                      *codes, stream)


def run_tile(parent) -> dict:
    fns, ptxas = variant_builds(TILE_DESIGNS, parent, TILE, probes.KERNEL_MATMUL)
    if not fns:
        return {}
    g = torch.Generator(device="cuda").manual_seed(0)
    times, pairs, equal = {}, {}, {}
    for case, (planes, tiles, rows, depth, cols, dt, out_dt) in TILE_CASES.items():
        x, y, z = (torch.randn(planes, tiles, rows, depth, generator=g, device="cuda").to(dt)
                   for _ in range(3))
        z = z[..., :cols]
        outs = {name: [torch.empty(planes, tiles, rows, cols, dtype=out_dt, device="cuda")]
                for name in fns}
        calls = {name: tile_call(fn, x, y, z, outs[name][0]) for name, (_, fn) in fns.items()}
        for name in fns:
            if name != "parent":
                times[f"{name}/{case}"] = device_ms(calls[name])
        times[f"torch.bmm/{case}"] = profiling.device_seconds(
            lambda: torch.matmul(torch.matmul(x, y.transpose(2, 3)), z), calls=20) * 1e3
        if parent is not None:
            pairs[case], equal[case] = paired(calls, outs)
        del x, y, z, outs, calls
    out = {"design": fns["full"][0], "device_ms": times,
           "cases": {c: [*s[:5], str(s[5]).split(".")[1], str(s[6]).split(".")[1]]
                     for c, s in TILE_CASES.items()}, "ptxas": ptxas}
    if parent is not None:
        out.update(parent_design=fns["parent"][0], paired_device_ms=pairs, bit_equal=equal)
    return out


def run_banded_fwd(parent) -> dict:
    fns, ptxas = variant_builds(BANDED_FWD_DESIGNS, parent, BANDED_FWD, ba.KERNEL)
    if not fns:
        return {}
    rng = np.random.default_rng(0)
    times, pairs, equal = {}, {}, {}
    for model, (planes, frames, joints) in BANDED_SHAPES.items():
        bands = dict(zip(("band", "nondiagonal_band"), banded_bands()[model]))
        base = [rng.normal(size=(planes, frames * joints, BANDED_DH)).astype(np.float32)
                for _ in range(3)]
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            inputs = [torch.from_numpy(x * (0.2 if i == 2 else 1.0)).cuda().to(dtype)
                      for i, x in enumerate(base)]
            outs = {name: [torch.empty(inputs[0].shape, device="cuda")] for name in fns}
            for kind, band in bands.items():
                case = f"{model}/{str(dtype).split('.')[1]}" + ("" if kind == "band" else f"/{kind}")
                calls = {name: banded_fwd_call(fn, d, inputs + outs[name], band, planes, frames,
                                               joints, code) for name, (d, fn) in fns.items()}
                for name in fns:
                    if name != "parent" and (kind == "band" or name == "full"):
                        times[f"{name}/{case}"] = device_ms(calls[name])
                if parent is not None:
                    pairs[case], equal[case] = paired(calls, outs)
    out = {"design": fns["full"][0], "device_ms": times,
           "shapes": {m: [*s, BANDED_DH] for m, s in BANDED_SHAPES.items()}, "ptxas": ptxas}
    if parent is not None:
        out.update(parent_design=fns["parent"][0], paired_device_ms=pairs, bit_equal=equal)
    return out


def banded_fwd_call(fn, design: str, tensors, band, planes, frames, joints, code):
    """A launch of the banded forward ``fn`` of ``design`` on ``tensors``
    (q, k, v, o), f32 out."""
    ptrs = [t.data_ptr() for t in tensors]
    bits = ba._bits(band, "cuda").data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    if design == "recompute":
        return lambda: fn(*ptrs, bits, planes, frames, joints, BANDED_DH, code, 0, BANDED_SCALE,
                          stream)
    return lambda: fn(*ptrs, bits, planes, frames, joints, BANDED_DH, code, 0,
                      ba.edges_per_row(band), BANDED_SCALE, stream)


PACKAGE = "sl_hwgat_tpu_torch"


def _own_modules() -> dict:
    return {n: m for n, m in sys.modules.items() if n == PACKAGE or n.startswith(PACKAGE + ".")}


def parent_modules(parent: Path, names=("bench.kernel", "ops._build")) -> list:
    """The parent checkout's modules ``names`` of the package, imported from
    ``parent`` beside this checkout's (which stay what ``sys.modules``
    holds): their functions keep reaching the parent's code and kernels."""
    own = _own_modules()
    for name in own:
        del sys.modules[name]
    sys.path.insert(0, str(parent))
    try:
        return [importlib.import_module(f"{PACKAGE}.{n}") for n in names]
    finally:
        sys.path.remove(str(parent))
        for name in _own_modules():
            del sys.modules[name]
        sys.modules.update(own)


def entries_in_turns(parent, impls, parent_sources, own_sources) -> dict:
    """``impls`` as ``bench.kernel`` builds them in this checkout and in the
    parent's (``parent_modules``; ``parent_sources`` built there,
    ``own_sources`` here), timed in turns by their card ms and by events,
    with ``bit_equal`` and this checkout's launches a call."""
    from sl_hwgat_tpu_torch.bench import kernel as bench

    pbench, pbuild = parent_modules(Path(parent))
    built = threading.Thread(target=pbuild.build, args=(parent_sources,))
    built.start()
    _build.build(own_sources)
    built.join()
    for src in parent_sources:  # fails here, not in a timed call, if a parent's build did
        pbuild.load(src)
    times, events, equal, counts = {}, {}, {}, {}
    with torch.no_grad():
        for impl in impls:
            probes_ = {"parent": pbench.inputs(impl, WINDOW32_UNITS),
                       "full": bench.inputs(impl, WINDOW32_UNITS)}
            calls = {n: (lambda p=p: p.body(p.state)) for n, p in probes_.items()}
            times[impl] = {n: [] for n in calls}
            for name in ("parent", "full", "full", "parent"):
                times[impl][name].append(profiling.device_seconds(calls[name], calls=20) * 1e3)
            events[impl] = {n: statistics.median(profiling.timeit(c, repeats=5)) * 1e3
                            for n, c in calls.items()}
            got, counts[impl] = bench.launches_of(calls["full"])
            equal[impl] = torch.equal(calls["parent"](), got)
            del probes_, calls, got
            torch.cuda.empty_cache()
    return {"units": WINDOW32_UNITS, "paired_device_ms": times, "events_ms": events,
            "bit_equal": equal, "launches": counts}


def run_fused(parent) -> dict:
    from sl_hwgat_tpu_torch.bench import kernel as bench

    if parent is None:
        raise SystemExit("bench.ablate fused: --parent is required")
    out = entries_in_turns(parent, (*bench.LAYOUT_ENTRIES, "softmax_only"),
                           ("window_attention_fwd", "relayout", "masked_softmax_fwd"),
                           (wa.KERNEL_LAYOUT, ha.KERNEL_BLOCKS))
    return {**out, "window32_fwd": run_window32_fwd(parent)}


LAYOUT = "window_attention_layout.cu"
LAYOUT_HEADER = "window_attention_layout.cuh"
LAYOUT_BOUND = "__launch_bounds__(kWarps * 32, kMinBlocks<T>)"
# variants of the layout kernel: every one gives the same bits
LAYOUT_VARIANTS = {
    "full": {},
    # no register bound: bf16 may take more than 128 registers (fewer warps)
    "unbounded": {LAYOUT: [(LAYOUT_BOUND, "__launch_bounds__(kWarps * 32)")]},
    # a unit's first element by 64-bit divisions
    "unit_u64": {LAYOUT_HEADER: [(
        "  const unsigned uu = static_cast<unsigned>(u), ns = static_cast<unsigned>(w.ns),\n"
        "                 nb = static_cast<unsigned>(w.nb), r = uu / ns;\n"
        "  return static_cast<long long>(r / nb) * w.sa + static_cast<long long>(r % nb) * w.sb +\n"
        "         static_cast<long long>(uu - r * ns) * w.ss;\n",
        "  const long long r = u / w.ns;\n"
        "  return r / w.nb * w.sa + r % w.nb * w.sb + (u - r * w.ns) * w.ss;\n")]},
}
# one bench entry of each instantiation, and tlay_fused_bf16 (all transposed,
# scale 1: its softmax leaves most probabilities subnormal or 0)
LAYOUT_ENTRIES_TIMED = ("tmq_fused", "tlay_fused_bf16", "mix_fused", "tmx_fused", "lp_fused_bf16",
                        "tlay_fused")


def run_layout(parent) -> dict:
    """The layout kernel's variants on bench entries, each loaded in place of
    the built library behind ``window_attention_into`` and timed in turns."""
    from sl_hwgat_tpu_torch.bench import kernel as bench

    jobs = {name: build_variant(name, edits, (wa.KERNEL_LAYOUT,))
            for name, edits in LAYOUT_VARIANTS.items()}
    ptxas = wait(jobs)
    if ptxas is None:
        return {}
    libs = {name: ctypes.CDLL(str(ABLATE_DIR / name / f"lib{wa.KERNEL_LAYOUT}.so"))
            for name in LAYOUT_VARIANTS}
    built = _build.load(wa.KERNEL_LAYOUT)
    times, equal = {}, {}
    try:
        with torch.no_grad():
            for impl in LAYOUT_ENTRIES_TIMED:
                p = bench.inputs(impl, WINDOW32_UNITS)
                times[impl], outs = {name: [] for name in libs}, {}
                for name in [*libs, *reversed(libs)]:
                    _build._LIBS[wa.KERNEL_LAYOUT] = libs[name]
                    outs.setdefault(name, p.body(p.state))
                    times[impl][name].append(
                        profiling.device_seconds(lambda: p.body(p.state), calls=20) * 1e3)
                equal[impl] = all(torch.equal(o, outs["full"]) for o in outs.values())
                del p, outs
                torch.cuda.empty_cache()
    finally:
        _build._LIBS[wa.KERNEL_LAYOUT] = built
    return {"units": WINDOW32_UNITS, "device_ms": times, "bit_equal_across_variants": equal,
            "ptxas": ptxas}


def run_fused_bwd(parent) -> dict:
    """The gradient entries in TPU layouts, this checkout's bench against the
    parent's, in turns, as ``run_fused`` times the forward entries."""
    from sl_hwgat_tpu_torch.bench import kernel as bench

    if parent is None:
        raise SystemExit("bench.ablate fused_bwd: --parent is required")
    return entries_in_turns(parent, bench.LAYOUT_BWD_ENTRIES,
                            ("window_attention_fwd", "window_attention_bwd",
                             "window_attention_layout", "relayout"),
                            (wa.KERNEL_LAYOUT, wa.KERNEL_LAYOUT_BWD))


HYBRID_ENTRIES = ("hybrid", "hybrid_bf16", "hybrid_bwd", "hybrid_bwd_bf16")


def run_hybrid(parent) -> dict:
    """The kernel bench's hybrid entries (forward and gradient, f32 and
    bf16: the two products around K7), this checkout's against the
    parent's, in turns, as ``run_fused`` times the forward layout entries."""
    if parent is None:
        raise SystemExit("bench.ablate hybrid: --parent is required")
    sources = (ha.KERNEL, ha.KERNEL_BWD)
    return {**entries_in_turns(parent, HYBRID_ENTRIES, sources, sources),
            "this_checkout": hybrid_parts()}


def hybrid_parts() -> dict:
    """This checkout's hybrid attention at the bench's ``hybrid_bf16`` call
    (bf16 q, k, v of 12288 units × 32 tokens × dh 64, single mask, stack 4)
    with f32 and with bf16 scores, forward and forward + backward, and each
    of its products alone on f32 against bf16 operands
    (``aten::bmm.dtype``), card ms in turns."""
    from sl_hwgat_tpu_torch.bench import kernel as bench

    def timer(call):
        return profiling.device_seconds(call, calls=20) * 1e3

    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(WINDOW32_UNITS, bench.N, bench.DH, generator=g, device="cuda")
               .to(bf16) for _ in range(3))
    do = torch.randn(q.shape, generator=g, device="cuda")
    adj, kw = bench.window_adj(), dict(scale=bench.SCALE, stack=bench.STACK)
    scores = {"f32_scores": torch.float32, "bf16_scores": bf16}
    out = {}
    with torch.no_grad():
        out["attention_fwd"] = in_turns({n: (lambda d=d: ha.hybrid_window_attention(
            q, k, v, adj, scores_dtype=d, **kw)) for n, d in scores.items()}, timer=timer)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out["attention_fwd_bwd"] = in_turns({n: (lambda d=d: torch.autograd.grad(
        ha.hybrid_window_attention(*leaves, adj, scores_dtype=d, **kw), leaves, do))
        for n, d in scores.items()}, timer=timer)
    scaled = q * torch.tensor(bench.SCALE, dtype=bf16)
    p = torch.softmax(torch.bmm(scaled, k.transpose(1, 2), out_dtype=torch.float32), -1)
    for name, (a, b) in {"scores": (scaled, k.transpose(1, 2)), "pv": (p.to(bf16), v)}.items():
        out[f"product_{name}"] = in_turns({
            "f32_operands": lambda a=a, b=b: torch.bmm(a.float(), b.float()),
            "bf16_operands": lambda a=a, b=b: torch.bmm(a, b, out_dtype=torch.float32)},
            timer=timer)
    return out


# relayout's cases on the bench path: (input shape, permutation, dtype)
RELAYOUT_CASES = {
    "transpose_bf16": ((3072, 128, 64), (0, 2, 1), torch.bfloat16),
    "transpose_back_bf16": ((3072, 64, 128), (0, 2, 1), torch.bfloat16),
    "transpose_f32": ((3072, 128, 64), (0, 2, 1), torch.float32),
    "t_to_units_bf16": ((3072, 64, 4, 32), (0, 2, 3, 1), torch.bfloat16),
    "units_to_t_bf16": ((3072, 4, 32, 64), (0, 3, 1, 2), torch.bfloat16),
    "widen_bf16": ((8, 384, 128, 64), (0, 3, 1, 2), torch.bfloat16),
    "pack_plane_bf16": ((128, 6144, 16), (0, 2, 1), torch.bfloat16),
    "unpack_plane_bf16": ((128, 16, 6144), (0, 2, 1), torch.bfloat16),
    "xrelay_s0_bf16": ((6144, 32, 2, 64), (0, 2, 1, 3), torch.bfloat16),
    "xrelay_s2_f32": ((1536, 32, 8, 64), (0, 2, 1, 3), torch.float32),
    "xstrided_s2_bf16": ((1536, 32, 8, 64), (2, 0, 1, 3), torch.bfloat16),
}


def run_relayout(parent) -> dict:
    """relayout's C entry point on the bench path's transposes and gathers,
    this checkout's (and with ``parent`` the parent's, in turns)."""
    builds = {"full": _build.CSRC_DIR}
    if parent is not None:
        builds["parent"] = Path(parent) / "sl_hwgat_tpu_torch" / "csrc"
    ptxas = wait({name: build_variant(name, {}, (probes.KERNEL_RELAYOUT,), csrc)
                  for name, csrc in builds.items()})
    if ptxas is None:
        return {}
    fns = {name: entry(name, probes.KERNEL_RELAYOUT) for name in builds}
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    times, pairs, equal = {}, {}, {}
    for case, (shape, perm, dtype) in RELAYOUT_CASES.items():
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda().to(dtype)
        dims = [1] * (4 - x.ndim) + list(shape)
        full = list(range(4 - x.ndim)) + [p + 4 - x.ndim for p in perm]
        outs = {name: torch.empty([shape[p] for p in perm], dtype=dtype, device="cuda")
                for name in fns}
        calls = {name: (lambda fn=fn, o=outs[name]: fn(x.data_ptr(), o.data_ptr(), *dims, *full,
                                                        x.element_size(), stream))
                 for name, fn in fns.items()}
        times[case] = device_ms(calls["full"])
        if parent is not None:
            pairs[case] = in_turns(calls)
            calls["parent"]()
            calls["full"]()
            torch.cuda.synchronize()
            equal[case] = torch.equal(outs["parent"], outs["full"])
        if not torch.equal(outs["full"], x.permute(*perm).contiguous()):
            raise AssertionError(f"relayout {case}: not the permutation")
        del x, outs
    out = {"device_ms": times, "cases": {c: [list(s), list(p), str(d).split(".")[1]]
                                         for c, (s, p, d) in RELAYOUT_CASES.items()},
           "ptxas": ptxas}
    if parent is not None:
        out.update(paired_device_ms=pairs, bit_equal=equal)
    return out


# C signatures of older designs' entries that differ from the wrappers' own:
# neither "recompute" design took edges_per_row
_ARGTYPES_OF = {(ba.KERNEL, "recompute"): ["p"] * 5 + ["ll", "i", "i", "i", "i", "i", "f", "p"],
                (ba.KERNEL_BWD, "recompute"): ["p"] * 8 + ["ll", "i", "i", "i", "i", "f", "p"]}


WRAPPER_SOURCES = ("window_attention_fwd", "masked_softmax_fwd", "banded_attention_fwd")


def host_us(call, calls: int = 500) -> float:
    """The host's µs a call over ``calls`` back-to-back calls (the card
    finishes each in a few µs, so the queue never fills)."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def run_wrappers(parent) -> dict:
    if parent is None:
        raise SystemExit("bench.ablate wrappers: --parent is required")
    pw, ph, pb, pbuild = parent_modules(Path(parent), names=(
        "ops.window_attention", "ops.hybrid_attention", "ops.banded_attention", "ops._build"))
    built = threading.Thread(target=pbuild.build, args=(WRAPPER_SOURCES,))
    built.start()
    _build.build(WRAPPER_SOURCES)
    built.join()
    for name in WRAPPER_SOURCES:  # fails here, not in a timed call, if a build did
        pbuild.load(name)
    g = torch.Generator(device="cuda").manual_seed(0)
    adj = windowed_block_adj(2)[0]
    q, k, v = (torch.randn(64, 32, 64, generator=g, device="cuda") for _ in range(3))
    s = torch.randn(64, 32, 32, generator=g, device="cuda")
    band = make_band(edges_to_dense(BODY29_EDGES, 29, self_loops=False))
    qb, kb, vb = (torch.randn(8, 4 * 29, 16, generator=g, device="cuda") for _ in range(3))
    calls = {
        "window_attention": {m: (lambda m=m: m.window_attention(q, k, v, adj, scale=SCALE))
                             for m in (pw, wa)},
        "masked_softmax": {m: (lambda m=m: m.masked_softmax(s, adj)) for m in (ph, ha)},
        "banded_attention": {m: (lambda m=m: m.banded_attention(qb, kb, vb, band, scale=0.25))
                             for m in (pb, ba)},
    }
    out = {}
    with torch.no_grad():
        for name, pair in calls.items():
            (pmod, pcall), (_, call) = pair.items()
            times = {"parent": [], "full": []}
            for _ in range(6):
                for who, fn in (("parent", pcall), ("full", call), ("full", call),
                                ("parent", pcall)):
                    times[who].append(host_us(fn))
            out[name] = {"host_us": times,
                         "median_us": {w: statistics.median(t) for w, t in times.items()},
                         "bit_equal": torch.equal(pcall(), call())}
    return {"wrappers": out}


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("bench.ablate: no CUDA device", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser(prog="python -m sl_hwgat_tpu_torch.bench.ablate")
    parser.add_argument("kernel", nargs="?", default="wide",
                        choices=("wide", "banded", "softmax", "window32", "banded_fwd",
                                 "window32_fwd", "tile", "fused", "layout", "fused_bwd",
                                 "relayout", "wrappers", "hybrid"))
    parser.add_argument("--parent", type=Path, default=None,
                        help="another checkout whose kernel is timed in turns with this one")
    args = parser.parse_args(argv)
    out = {"wide": run_wide, "banded": run_banded, "softmax": run_softmax,
           "window32": run_window32, "banded_fwd": run_banded_fwd,
           "window32_fwd": run_window32_fwd, "tile": run_tile,
           "fused": run_fused, "layout": run_layout, "fused_bwd": run_fused_bwd,
           "relayout": run_relayout, "wrappers": run_wrappers,
           "hybrid": run_hybrid}[args.kernel](args.parent)
    if not out:
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(json.dumps({"kernel": args.kernel, **out,
                      "nvidia_smi": smi.stdout.strip().splitlines()[0]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
