"""Which side rounds T(A) wrong where K2 and its plain version part: the bf16
dv bar of the 32-token backward.

    python -m sl_hwgat_tpu_torch.bench.rounding [--units N] [--seeds S ...]

K2 (``csrc/window_attention_bwd.cu``) and its plain version
(``ops.attention.stacked_window_attention_bwd``) both form dV = T(A)ᵀ·dO,
with T(A) the f32 probabilities rounded to bf16. Their f32 A may differ in
the last bit (the kernel's score sums run in its own order, the plain
version's in cuBLAS's); where such an A lies at a bf16 rounding boundary,
the two T(A) are one bf16 ulp apart, and dV moves by that ulp times dO.

At the bench's 32-token units (12288 × 32 × 64, bf16, scale 1/8; single
mask, dual mask with pruning at u = 0.3, an explicit selector), on phase
4's draw (``chip_smoke.py``'s ``attention_inputs`` and ``output_grad``: v at
0.2 scale, dO from seed 2) and on draws in phase 18's manner (q, k, v and
dO unit normal from one generator, seeds ``--seeds``), this prints one
JSON line with, per draw and mask:

- ``violations``: dV entries outside the bar 4e-3 + 1e-2·|x|, and the worst;
- the kernel's T(A), read exactly from K2's own dV under a dO that is one
  at row i, column i of every unit (then dV[j, i] = T(A[i, j])), and its f32
  A, from the f32 instantiation on the same (bf16-exact) inputs the same
  way (checked: it rounds to the bf16 instantiation's T(A));
- the plain version's f32 A, computed by its own functions on the card;
- A in float64 from the same inputs and the same mask decisions;
- ``flips``: entries where the two T(A) differ, with, for each, the three
  A values, the bf16 boundary between the two T(A), the f32 ulps from each
  side's A and from the boundary to the float64 A, and which side rounds
  as the float64 A does; the flips under a violating dV entry in full.

``dv_float64`` and ``dv_bound_ratio`` anchor the dv check on float64
instead of on the other side: each side's bf16 dV against dV computed in
float64 from the float64 A, at 4e-3 + 1e-2·|dv64| plus one bf16 ulp of
T(A) times |dO| summed over the rows (the most a rounding of T(A) either
way can move dv). ``chip_smoke.py`` holds K2-32, the backward layout kernel
and the plain version to it on the draws of ``draw``.

It needs a card and ``nvcc``, as ``chip_smoke.py`` does.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

BAR = dict(atol=4e-3, rtol=1e-2)


def _ulp(x: torch.Tensor, bits: int) -> torch.Tensor:
    """One ulp at |x| (float64) of a type with ``bits`` stored significand
    bits (the smallest normal's at 0)."""
    x = x.abs().clamp_min(2.0**-126)
    return torch.exp2(torch.floor(torch.log2(x)) - bits)


def draw(units: int, seed: int, v_scale: float = 1.0, do_seed: int | None = None,
         n: int = 32, dh: int = 64):
    """bf16 (q, k, v, dO) of (units, n, dh) on the card: q, k, v (v times
    ``v_scale``) unit normal from one generator seeded ``seed``, and dO from
    the same generator, or from one seeded ``do_seed``. Phase 18's manner:
    ``draw(units, seed)``; phase 4's inputs: ``draw(units, 0, 0.2, 2)``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(units, n, dh, generator=g, device="cuda") for _ in range(3))
    if do_seed is not None:
        g = torch.Generator(device="cuda").manual_seed(do_seed)
    do = torch.randn(units, n, dh, generator=g, device="cuda")
    bf16 = torch.bfloat16
    return q.to(bf16), k.to(bf16), (v * v_scale).to(bf16), do.to(bf16)


def dv_float64(q, k, do, adj, kw) -> tuple[torch.Tensor, torch.Tensor]:
    """(dv64, slack) of (U, N, dh) units: dV = Aᵀ·dO in float64 from the
    float64 A under the plain version's mask decisions (``plain_a``), and
    per entry Σᵢ ulp_bf16(A64ᵢⱼ)·|dOᵢ|, one bf16 ulp of T(A) per term."""
    a64 = plain_a(q, k, adj, kw)
    d = do.double()
    return torch.bmm(a64.transpose(1, 2), d), torch.bmm(_ulp(a64, 7).transpose(1, 2), d.abs())


def dv_bound_ratio(dv, dv64, slack) -> float:
    """The worst |dv − dv64| / (4e-3 + 1e-2·|dv64| + slack) over the
    entries: at most 1 where dv meets the float64-anchored bound."""
    bound = BAR["atol"] + BAR["rtol"] * dv64.abs() + slack
    return ((dv.double() - dv64).abs() / bound).max().item()


def plain_a(q, k, adj, kw, dtype=torch.float64):
    """(U, N, N) A of the plain version: its f32 probabilities, or with
    ``dtype=float64`` the same softmax in float64 over the same kept scores
    (the plain version's mask, prune and zero-score decisions)."""
    from sl_hwgat_tpu_torch.ops.attention import _softmax, _stack, _tile_scores
    from sl_hwgat_tpu_torch.ops.window_attention import plain_sel

    n, stack = q.shape[1], kw["stack"]
    sel = plain_sel(q, stack, kw.get("tail_adj"), kw.get("units_per_group"), kw.get("groups"),
                    0, kw.get("sel"))
    qs, ks = _stack(q, n, stack), _stack(k, n, stack)
    raw, s = _tile_scores(qs, ks, adj, n=n, np_=n, stack=stack, scale=kw["scale"],
                          zero_quirk=True, prune_u=kw.get("prune_u"),
                          tail_adj=kw.get("tail_adj"), sel=sel)
    if dtype == torch.float32:
        a = _softmax(s)
    else:
        scaled = (qs * torch.tensor(kw["scale"], dtype=qs.dtype, device=qs.device)).double()
        raw64 = torch.matmul(scaled, ks.double().transpose(1, 2))
        a = _softmax(torch.where(s == raw, raw64, s.double()))
    t = a.shape[0]
    blocks = a.reshape(t, stack, n, stack, n)
    idx = torch.arange(stack, device=a.device)
    return blocks[:, idx, :, idx].permute(1, 0, 2, 3).reshape(t * stack, n, n)


def kernel_a(q, k, v, adj, kw):
    """(U, N, N) A of K2 in q's dtype, read from its dV under dO[u, i, c] =
    [c == i]: dV[u, j, i] = T(A[u, i, j]) (one product of 1.0, exact)."""
    from sl_hwgat_tpu_torch.ops.window_attention import window_attention_bwd

    u, n, dh = q.shape
    eye = torch.zeros(u, n, dh, dtype=q.dtype, device=q.device)
    eye[:, torch.arange(n), torch.arange(n)] = 1
    dv = window_attention_bwd(q, k, v, eye, adj, **kw)[2]
    return dv[:, :, :n].transpose(1, 2).double()


def analyse(q, k, v, do, adj, kw, detail: int = 12) -> dict:
    from sl_hwgat_tpu_torch.ops.window_attention import (
        plain_window_attention_bwd,
        window_attention_bwd,
    )

    dv_k = window_attention_bwd(q, k, v, do, adj, **kw)[2].double()
    dv_p = plain_window_attention_bwd(q, k, v, do, adj, **kw)[2].double()
    excess = (dv_k - dv_p).abs() - BAR["atol"] - BAR["rtol"] * dv_p.abs()
    bad = (excess > 0).nonzero().tolist()

    t_k = kernel_a(q, k, v, adj, kw)
    a_k = kernel_a(q.float(), k.float(), v.float(), adj, kw)
    a_p = plain_a(q, k, adj, kw, torch.float32).double()
    a_64 = plain_a(q, k, adj, kw)
    t_p = a_p.to(torch.bfloat16).double()
    consistent = int((a_k.float().to(torch.bfloat16).double() != t_k).sum())
    ulp = _ulp(a_64, 23)
    out = {"violations": len(bad),
           "worst_excess": max(0.0, excess.max().item()),
           "kernel_f32_rounds_to_kernel_bf16_T_mismatches": consistent,
           "max_ulps_from_float64": {"kernel": ((a_k - a_64).abs() / ulp).max().item(),
                                     "plain": ((a_p - a_64).abs() / ulp).max().item()}}
    flips = (t_k != t_p).nonzero()
    rows = []
    for u, i, j in flips.tolist():
        boundary = (t_k[u, i, j] + t_p[u, i, j]).item() / 2
        x64 = a_64[u, i, j].item()
        right = t_k[u, i, j].item() if (x64 > boundary) == (t_k[u, i, j] > t_p[u, i, j]).item() \
            else t_p[u, i, j].item()
        one = ulp[u, i, j].item()
        rows.append({"unit": u, "row": i, "col": j, "a_kernel": a_k[u, i, j].item(),
                     "a_plain": a_p[u, i, j].item(), "a_float64": x64,
                     "t_kernel": t_k[u, i, j].item(), "t_plain": t_p[u, i, j].item(),
                     "boundary": boundary,
                     "ulps_kernel": (a_k[u, i, j].item() - x64) / one,
                     "ulps_plain": (a_p[u, i, j].item() - x64) / one,
                     "ulps_float64_to_boundary": (x64 - boundary) / one,
                     "rounds_as_float64": ("kernel" if right == t_k[u, i, j].item() else "")
                     + ("plain" if right == t_p[u, i, j].item() else "")})
    out["flips"] = len(rows)
    out["flips_rounding_as_float64"] = {
        side: sum(r["rounds_as_float64"] == side for r in rows) for side in ("kernel", "plain")}
    out["flips_both_within_one_ulp"] = sum(
        abs(r["ulps_kernel"]) <= 1 and abs(r["ulps_plain"]) <= 1 for r in rows)
    out["max_ulps_float64_to_boundary"] = max(
        (abs(r["ulps_float64_to_boundary"]) for r in rows), default=None)
    # the flips under each violating dV entry (u, j, c): T(A[u, i, j]) for all i
    under = [r for r in rows if any(r["unit"] == u and r["col"] == j for u, j, _ in bad)]
    for (u, j, c) in bad[:detail]:
        for r in under:
            if r["unit"] == u and r["col"] == j:
                r.setdefault("violating_dv", []).append(
                    {"channel": c, "dv_kernel": dv_k[u, j, c].item(),
                     "dv_plain": dv_p[u, j, c].item(), "do": do[r["unit"], r["row"], c].item()})
    out["flips_under_violations"] = under
    out["flip_sample"] = rows[:detail]
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--units", type=int, default=12288)
    parser.add_argument("--seeds", type=int, nargs="*", default=[18, 19, 20, 21])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("rounding: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from sl_hwgat_tpu_torch.bench import kernel as bench

    units = args.units
    adj = bench.window_adj()
    tail = bench.dual_tail(adj)
    masks = {"single": {},
             "dual_prune": dict(tail_adj=tail, units_per_group=32, groups=3,
                                prune_u=torch.full((1,), 0.3, device="cuda")),
             "sel": dict(tail_adj=tail, units_per_group=32, groups=3,
                         sel=(torch.arange(units // 4, device="cuda") % 3 == 1).int())}

    draws = {"phase4": draw(units, 0, 0.2, 2)}
    draws.update({f"phase18_seed{seed}": draw(units, seed) for seed in args.seeds})
    result = {"units": units, "tokens": bench.N, "head_dim": bench.DH, "bar": BAR, "draws": {}}
    for name, (q, k, v, do) in draws.items():
        result["draws"][name] = {
            mask: analyse(q, k, v, do, adj, dict(scale=bench.SCALE, stack=bench.STACK, **kw))
            for mask, kw in masks.items()}
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
