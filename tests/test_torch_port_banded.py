"""The port's banded attention against the JAX package, on the CPU.

``ops/attention.py::banded_frame_attention_k8`` and
``banded_frame_attention_bwd`` are the plain versions of the banded CUDA
kernels (``csrc/banded_attention_{fwd,bwd}.cu``). They are held against:

- the JAX package's ``banded_frame_attention`` (forward, and gradients
  through ``jax.vjp``) and ``compact_banded_frame_attention``;
- the frame-packed Pallas kernel K8 in interpret mode, through both its
  array entry (``pallas_packed_banded_attention``) and its plane entry, in
  f32 and bf16, forward and ``jax.vjp``;
- the general banded Pallas kernel K9 (``pallas_banded_frame_attention``)
  in interpret mode, with a non-diagonal band;
- torch autograd of the plain forward.

Cases: GATE's 29 joints (whole-body graph, no self loops) and WGATE's
16-joint window graph. Inputs are made with numpy from a seed. Bars
(``tests/test_pallas_banded.py``, ``tests/test_pallas_attention.py``):
forward 2e-5 and gradients 3e-5 in f32; bf16 4e-3 + 1e-2·|x| (one bf16 ulp
is 2^-8 relative).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sl_hwgat_tpu import graphs
from sl_hwgat_tpu.graphs.skeleton import BODY29_EDGES, edges_to_dense
from sl_hwgat_tpu.ops import attention as jax_attention
from sl_hwgat_tpu.ops.pallas_banded import (
    pallas_banded_frame_attention,
    pallas_packed_banded_attention,
    pallas_packed_banded_attention_planes,
)

from sl_hwgat_tpu_torch.ops.attention import (
    banded_frame_attention,
    banded_frame_attention_bwd,
    banded_frame_attention_k8,
)
from sl_hwgat_tpu_torch.ops.banded_attention import (
    _bits,
    banded_attention,
    banded_attention_bwd,
    check_band,
    plain_banded_attention,
    plain_banded_attention_bwd,
)

FWD = dict(atol=2e-5, rtol=0)
GRAD = dict(atol=3e-5, rtol=0)
BF16 = dict(atol=4e-3, rtol=1e-2)
SCALE = 0.25
SPATIAL = {
    "gate29": lambda: edges_to_dense(BODY29_EDGES, 29, self_loops=False),
    "wgate16": lambda: graphs.window_adj(window_size=16),
}


def identity_band(spatial):
    """The GATE/WGATE band (the K8 case): identity prev/next planes."""
    eye = np.eye(spatial.shape[0], dtype=np.float32)
    return np.stack([graphs.additive_mask(eye), graphs.additive_mask(spatial),
                     graphs.additive_mask(eye)])


def spatial_band(spatial):
    """A non-diagonal band (the K9 case): the spatial plane as prev/next."""
    return np.stack([graphs.additive_mask(spatial)] * 3)


def inputs(v, frames, dh=16, gh=(1, 2), seed=0):
    r = np.random.default_rng(seed)
    return tuple(r.normal(size=(*gh, frames, v, dh)).astype(np.float32) for _ in range(4))


def t(*xs, dtype=torch.float32):
    return tuple(torch.from_numpy(x).to(dtype) for x in xs)


def j(*xs, dtype=jnp.float32):
    return tuple(jnp.asarray(x, dtype) for x in xs)


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("case", sorted(SPATIAL))
@pytest.mark.parametrize("make", [identity_band, spatial_band])
def test_port_copy_and_k8_rounding_match_jax_banded(case, make):
    band = make(SPATIAL[case]())
    q, k, v, _ = inputs(band.shape[1], frames=12)
    want = jax_attention.banded_frame_attention(*j(q, k, v), jnp.asarray(band), scale=SCALE)
    close(banded_frame_attention(*t(q, k, v), band, scale=SCALE), want, FWD)
    close(banded_frame_attention_k8(*t(q, k, v), band, scale=SCALE), want, FWD)


@pytest.mark.parametrize("case", sorted(SPATIAL))
def test_port_copy_matches_jax_banded_in_bf16(case):
    band = identity_band(SPATIAL[case]())
    q, k, v, _ = inputs(band.shape[1], frames=8, seed=1)
    want = jax_attention.banded_frame_attention(*j(q, k, v, dtype=jnp.bfloat16),
                                                jnp.asarray(band), scale=SCALE)
    close(banded_frame_attention(*t(q, k, v, dtype=torch.bfloat16), band, scale=SCALE), want,
          BF16)


@pytest.mark.parametrize("case", sorted(SPATIAL))
def test_matches_compact_banded(case):
    spatial = SPATIAL[case]()
    band = identity_band(spatial)
    q, k, v, _ = inputs(band.shape[1], frames=10, seed=2)
    want = jax_attention.compact_banded_frame_attention(
        *j(q, k, v), jnp.asarray(graphs.additive_mask(spatial)), scale=SCALE)
    close(banded_frame_attention_k8(*t(q, k, v), band, scale=SCALE), want, FWD)


@pytest.mark.parametrize("case", sorted(SPATIAL))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_k8_array_entry(case, dtype):
    band = identity_band(SPATIAL[case]())
    q, k, v, _ = inputs(band.shape[1], frames=8, seed=3)
    want = pallas_packed_banded_attention(*j(q, k, v, dtype=getattr(jnp, dtype)), band,
                                          scale=SCALE)
    got = banded_frame_attention_k8(*t(q, k, v, dtype=getattr(torch, dtype)), band, scale=SCALE)
    close(got, want, FWD if dtype == "float32" else BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_gradients_match_k8_plane_entry(dtype):
    """WGATE's plane path: (G·H, dh, F·V) planes, V = Vp = 16."""
    band = identity_band(SPATIAL["wgate16"]())
    q, k, v, do = inputs(16, frames=16, seed=4)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def planes(x):
        return jnp.asarray(x.reshape(2, 16 * 16, 16).swapaxes(1, 2), jdt)

    def entry(a, b, c):
        return pallas_packed_banded_attention_planes(a, b, c, band, scale=SCALE, vp=16, frames=16)

    out, vjp = jax.vjp(entry, *(planes(x) for x in (q, k, v)))
    tol = FWD if dtype == "float32" else BF16
    close(banded_frame_attention_k8(*t(q, k, v, dtype=tdt), band, scale=SCALE),
          np.asarray(out, np.float32).swapaxes(1, 2).reshape(q.shape), tol)
    want = [np.asarray(g, np.float32).swapaxes(1, 2).reshape(q.shape)
            for g in vjp(planes(do).astype(jnp.float32))]
    got = banded_frame_attention_bwd(*t(q, k, v, do, dtype=tdt), band, scale=SCALE)
    for g, w in zip(got, want):
        assert g.dtype == tdt
        close(g.float(), w, GRAD if dtype == "float32" else BF16)


@pytest.mark.parametrize("case", sorted(SPATIAL))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_matches_k8_vjp(case, dtype):
    band = identity_band(SPATIAL[case]())
    q, k, v, do = inputs(band.shape[1], frames=8, seed=5)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda a, b, c: pallas_packed_banded_attention(a, b, c, band, scale=SCALE),
                     *j(q, k, v, dtype=jdt))
    want = vjp(jnp.asarray(do))
    got = banded_frame_attention_bwd(*t(q, k, v, do, dtype=tdt), band, scale=SCALE)
    for g, w in zip(got, want):
        assert g.dtype == tdt
        close(g.float(), w, GRAD if dtype == "float32" else BF16)


@pytest.mark.parametrize("case", sorted(SPATIAL))
def test_forward_and_gradients_match_k9_with_a_nondiagonal_band(case):
    band = spatial_band(SPATIAL[case]())
    nv = band.shape[1]
    q, k, v, do = inputs(nv, frames=8 if nv == 16 else 12, seed=6)
    out, vjp = jax.vjp(lambda a, b, c: pallas_banded_frame_attention(a, b, c, band, scale=SCALE),
                       *j(q, k, v))
    close(banded_frame_attention_k8(*t(q, k, v), band, scale=SCALE), out, FWD)
    for g, w in zip(banded_frame_attention_bwd(*t(q, k, v, do), band, scale=SCALE),
                    vjp(jnp.asarray(do))):
        close(g, w, GRAD)


@pytest.mark.parametrize("case", sorted(SPATIAL))
@pytest.mark.parametrize("make", [identity_band, spatial_band])
def test_backward_matches_jax_banded_vjp_and_torch_autograd(case, make):
    band = make(SPATIAL[case]())
    q, k, v, do = inputs(band.shape[1], frames=9, seed=7)
    _, vjp = jax.vjp(lambda a, b, c: jax_attention.banded_frame_attention(
        a, b, c, jnp.asarray(band), scale=SCALE), *j(q, k, v))
    got = banded_frame_attention_bwd(*t(q, k, v, do), band, scale=SCALE)
    for g, w in zip(got, vjp(jnp.asarray(do))):
        close(g, w, GRAD)
    leaves = tuple(x.requires_grad_() for x in t(q, k, v))
    banded_frame_attention_k8(*leaves, band, scale=SCALE).backward(torch.from_numpy(do))
    for g, leaf in zip(got, leaves):
        close(g, leaf.grad, GRAD)


def token_major(*xs):
    """(G, H, F, V, dh) → the kernels' (G·H, F·V, dh)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(
        x.reshape(x.shape[0] * x.shape[1], -1, x.shape[-1]))) for x in xs)


@pytest.mark.parametrize("case", sorted(SPATIAL))
def test_wrapper_on_cpu_runs_the_plain_version_and_differentiates(case):
    band = identity_band(SPATIAL[case]())
    q, k, v, do = inputs(band.shape[1], frames=8, seed=8)
    tq, tk, tv, tdo = token_major(q, k, v, do)
    launches = (banded_attention.launches, banded_attention_bwd.launches)
    want = banded_frame_attention_k8(*t(q, k, v), band, scale=SCALE)
    out = banded_attention(tq, tk, tv, band, scale=SCALE)
    assert out.dtype == torch.float32
    assert torch.equal(out, want.reshape(out.shape))
    assert torch.equal(out, plain_banded_attention(tq, tk, tv, band, scale=SCALE))
    bf = banded_attention(*(x.bfloat16() for x in (tq, tk, tv)), band, scale=SCALE,
                          out_dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    grads = banded_attention_bwd(tq, tk, tv, tdo, band, scale=SCALE)
    want_grads = banded_frame_attention_bwd(*t(q, k, v, do), band, scale=SCALE)
    for g, w, p in zip(grads, want_grads,
                       plain_banded_attention_bwd(tq, tk, tv, tdo, band, scale=SCALE)):
        assert torch.equal(g, w.reshape(g.shape)) and torch.equal(g, p)
    leaves = tuple(x.clone().requires_grad_() for x in (tq, tk, tv))
    banded_attention(*leaves, band, scale=SCALE).backward(tdo)
    for g, leaf in zip(grads, leaves):
        close(leaf.grad, g, GRAD)
    assert (banded_attention.launches, banded_attention_bwd.launches) == launches


def test_band_bits_are_the_edges_and_their_transpose():
    band = spatial_band(SPATIAL["gate29"]())
    band[0] = identity_band(SPATIAL["gate29"]())[0]
    words = _bits(band, "cpu").numpy().view(np.uint32)
    edges = band == 0
    for p in range(3):
        for i in range(29):
            assert words[p, i] == sum(1 << jj for jj in range(29) if edges[p, i, jj])
            assert words[3 + p, i] == sum(1 << ii for ii in range(29) if edges[p, ii, i])
    assert not words[:, 29:].any()


def test_the_kernels_contract_is_checked_on_every_device():
    band = identity_band(SPATIAL["wgate16"]())
    q = torch.zeros(2, 8 * 16, 16)
    with pytest.raises(ValueError, match="head dim 16"):
        banded_attention(*(torch.zeros(2, 8 * 16, 8),) * 3, band, scale=SCALE)
    with pytest.raises(ValueError, match="whole frames"):
        banded_attention(*(torch.zeros(2, 8 * 16 + 3, 16),) * 3, band, scale=SCALE)
    big = identity_band(np.eye(33, dtype=np.float32))
    with pytest.raises(ValueError, match="at most 32 joints"):
        banded_attention(*(torch.zeros(2, 33 * 4, 16),) * 3, big, scale=SCALE)
    with pytest.raises(ValueError, match="0 \\(edge\\) or -1e4"):
        banded_attention(q, q, q, band * 0.5, scale=SCALE)
    # joint 3 has no edge in the self plane: fine inside the clip (it has its
    # prev/next identity edges), refused in a one-frame clip
    hole = band.copy()
    hole[1, 3] = -1e4
    check_band(hole, frames=8)
    with pytest.raises(ValueError, match="no edge"):
        check_band(hole, frames=1)
    # without its next edge, joint 3's row in frame 0 has no edge left
    hole[2, 3] = -1e4
    with pytest.raises(ValueError, match="no edge"):
        banded_attention(q, q, q, hole, scale=SCALE)
    check_band(identity_band(SPATIAL["gate29"]()), frames=2)
