"""The port's exported serving program against the JAX package's, on the CPU.

- ``torch.library.opcheck`` holds each custom op of ``ops/library.py`` (K1,
  K7's forward, K8's forward) on CPU tensors, and each op's CPU
  implementation equals its wrapper's eager output bit for bit;
- ``Predictor.export_program`` → ``Predictor.load_exported`` for small
  HWGATE (both paths), HGATE, WGATE and GATE: logits bit for bit
  ``Predictor.forward``'s, the model's custom op in the graph and no other
  op of the namespace;
- the loaded program's logits match the JAX ``export_stablehlo`` →
  ``load_exported`` on the same ``.pt`` at 2e-4 / 1e-4;
- ``load_exported`` in a fresh process imports no module of the port's
  models, and none of jax or ``sl_hwgat_tpu``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sl_hwgat_tpu_torch.constants import DATASET_PARAMS
from sl_hwgat_tpu_torch.graphs.adjacency import windowed_block_adj
from sl_hwgat_tpu_torch.graphs.skeleton import BODY29_EDGES, edges_to_dense
from sl_hwgat_tpu_torch.models import build_model
from sl_hwgat_tpu_torch.models.wgate import make_band
from sl_hwgat_tpu_torch.ops import banded_attention as banded_mod
from sl_hwgat_tpu_torch.ops import hybrid_attention as hybrid_mod
from sl_hwgat_tpu_torch.ops import library
from sl_hwgat_tpu_torch.ops import window_attention as window_mod
from sl_hwgat_tpu_torch.serve import Predictor
from sl_hwgat_tpu_torch.weights import save_state_dict

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = DATASET_PARAMS["SYNTH"]
BUCKET = 4
CASES = {"HWGATE": ("HWGATE", dict(embed_dim=32, depths=(1, 1), num_heads=(2, 2)), {}),
         "HWGATE-hybrid": ("HWGATE", dict(embed_dim=32, depths=(1, 1), num_heads=(2, 2)),
                           {"attn_impl": "hybrid"}),
         "HGATE": ("HGATE", dict(embed_dim=32, depths=(1, 1, 1), num_heads=(1, 2, 4)), {}),
         "WGATE": ("WGATE", dict(embed_dim=32, depths=2, num_heads=2), {}),
         "GATE": ("GATE", dict(embed_dim=32, depths=2, num_heads=2), {})}
OPS = {"HWGATE": "window_attention", "HWGATE-hybrid": "masked_softmax",
       "HGATE": "window_attention", "WGATE": "banded_attention", "GATE": "banded_attention"}


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _randn(shape, seed, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32)) \
        .to(dtype)


def _window_cases():
    adj = windowed_block_adj(2)[0]
    tail = adj * (np.arange(32)[:, None] % 2 == np.arange(32)[None, :] % 2)
    hgate = windowed_block_adj(2)[0][:29, :29]
    return [  # (q, k, v, adj, kwargs of window_attention)
        (*(_randn((16, 32, 64), s) for s in range(3)), adj, dict(scale=0.125)),
        (*(_randn((24, 32, 32), s, torch.bfloat16) for s in range(3, 6)), adj,
         dict(scale=0.125, tail_adj=tail, units_per_group=8, groups=3, prune_u=0.3,
              out_dtype=torch.bfloat16)),
        (*(_randn((6, 29, 64), s) for s in range(6, 9)), hgate,
         dict(scale=0.125, stack=2, pad_tokens=32)),
    ]


@pytest.mark.parametrize("case", range(3))
def test_window_attention_op(case):
    q, k, v, adj, kw = _window_cases()[case]
    full = dict(stack=4, pad_tokens=None, zero_quirk=True, prune_u=None, tail_adj=None,
                units_per_group=None, groups=None, unit_offset=0, sel=None,
                out_dtype=torch.float32)
    full.update(kw)
    prune = full["prune_u"]
    mode = window_mod.mask_mode(full["tail_adj"], full["stack"], full["units_per_group"],
                                full["groups"], 0)
    args = (q, k, v, window_mod.device_masks(adj, full["tail_adj"], q.device), None,
            None if prune is None else torch.full((1,), prune), full["scale"],
            full["pad_tokens"] or 0, True, list(mode), full["out_dtype"])
    torch.library.opcheck(library.window_attention_op, args)
    assert torch.equal(library.window_attention_op(*args),
                       window_mod.window_attention(q, k, v, adj, **kw))


@pytest.mark.parametrize("dual", [False, True])
def test_masked_softmax_op(dual):
    adj = windowed_block_adj(2)[0]
    tail = adj * (np.arange(32)[:, None] % 2 == np.arange(32)[None, :] % 2) if dual else None
    s = _randn((24, 32, 32), 9)
    kw = dict(tail_adj=tail, units_per_group=8 if dual else None, groups=3 if dual else None,
              prune_u=0.2 if dual else None, p_dtype=torch.bfloat16 if dual else torch.float32)
    mode = window_mod.mask_mode(tail, 4, kw["units_per_group"], kw["groups"], 0)
    args = (s, window_mod.device_masks(adj, tail, s.device, wide=True), None,
            torch.full((1,), 0.2) if dual else None, True, list(mode), kw["p_dtype"])
    torch.library.opcheck(library.masked_softmax_op, args)
    assert torch.equal(library.masked_softmax_op(*args), hybrid_mod.masked_softmax(s, adj, **kw))


@pytest.mark.parametrize("joints,dtype", [(29, torch.float32), (16, torch.bfloat16)])
def test_banded_attention_op(joints, dtype):
    spatial = edges_to_dense(BODY29_EDGES, 29, self_loops=False) if joints == 29 else \
        windowed_block_adj(1)[0][:16, :16]
    band = make_band(spatial)
    np.testing.assert_array_equal(library.band_of(banded_mod._bits(band, "cpu"), joints), band)
    q, k, v = (_randn((4, joints * 6, 16), s, dtype) for s in range(3))
    args = (q, k, v, banded_mod._bits(band, q.device), 0.25, joints,
            banded_mod.edges_per_row(band), dtype)
    torch.library.opcheck(library.banded_attention_op, args)
    assert torch.equal(library.banded_attention_op(*args),
                       banded_mod.banded_attention(q, k, v, band, scale=0.25, out_dtype=dtype))


def _raw_clips(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.random((int(f), 543, 4)).astype(np.float32)
            for f in rng.integers(SYNTH["src_len"] // 2, 2 * SYNTH["src_len"], size=n)]


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """For every case: its .pt, its Predictor, its exported .pt2 (bucket 4)."""
    root = tmp_path_factory.mktemp("export")
    out = {}
    for case, (name, size, extra) in CASES.items():
        pt = str(root / f"{case}.pt")
        save_state_dict(pt, build_model(name, SYNTH, 2, device="cpu", seed=3, **size))
        pred = Predictor.from_checkpoint(pt, model_type=name, dataset="SYNTH", device="cpu",
                                         batch_buckets=(BUCKET,), **size, **extra)
        pt2 = pred.export_program(str(root / f"{case}.pt2"), BUCKET, _raw_clips(1, 0)[0])
        out[case] = (pt, pred, pt2)
    yield out
    for _, pred, _ in out.values():
        pred.close()


@pytest.mark.parametrize("case", sorted(CASES))
def test_loaded_program_is_predictor_forward_bit_for_bit(exported, case):
    _, pred, pt2 = exported[case]
    x = np.stack([pred.preprocess(c) for c in _raw_clips(BUCKET, 1)])
    got = Predictor.load_exported(pt2)(x)
    want = pred.forward(x)
    assert got.shape == (BUCKET, SYNTH["num_class"]) and got.dtype == torch.float32
    assert torch.equal(got, want)
    ops = {str(n.target) for n in torch.export.load(pt2).graph.nodes
           if str(n.target).startswith(library.NAMESPACE)}
    assert ops == {f"{library.NAMESPACE}.{OPS[case]}.default"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loaded_program_matches_jax_export(exported, case, tmp_path):
    from sl_hwgat_tpu.serve import Predictor as JaxPredictor

    pt, pred, pt2 = exported[case]
    name, size, extra = CASES[case]
    clips = _raw_clips(BUCKET, 2)
    jp = JaxPredictor.from_checkpoint(pt, model_type=name, dataset="SYNTH",
                                      batch_buckets=(BUCKET,), **size, **extra)
    blob = jp.export_stablehlo(str(tmp_path / "jax.bin"), BUCKET, clips[0])
    x = np.stack([pred.preprocess(c) for c in clips])
    want = np.asarray(JaxPredictor.load_exported(blob)(x))
    got = Predictor.load_exported(pt2)(x).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


_LOAD_CHECK = """
import json, sys
import numpy as np
for name in ("jax", "flax", "optax"):
    sys.modules[name] = None  # any import of them raises ImportError
from sl_hwgat_tpu_torch.serve import Predictor
fn = Predictor.load_exported(sys.argv[1])
out = fn(np.load(sys.argv[2]))
print(json.dumps({
    "shape": list(out.shape),
    "models": [n for n in sys.modules if n.startswith("sl_hwgat_tpu_torch.models")],
    "reference": [n for n in sys.modules if n == "sl_hwgat_tpu" or n.startswith("sl_hwgat_tpu.")],
    "library": "sl_hwgat_tpu_torch.ops.library" in sys.modules,
}))
"""


def test_load_exported_in_a_fresh_process_imports_no_model(exported, tmp_path):
    _, pred, pt2 = exported["GATE"]
    x = np.stack([pred.preprocess(c) for c in _raw_clips(BUCKET, 3)])
    np.save(tmp_path / "x.npy", x)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO_ROOT
    out = subprocess.run([sys.executable, "-c", _LOAD_CHECK, pt2, str(tmp_path / "x.npy")],
                         cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen == {"shape": [BUCKET, SYNTH["num_class"]], "models": [], "reference": [],
                    "library": True}
