"""The port's serving path against the JAX package's, on the CPU.

- the eval transform (static + eval pipeline) gives exactly the JAX
  package's arrays, on short, long and hand-missing clips;
- ``Predictor`` gives the JAX ``Predictor``'s logits from the same ``.pt``
  file, at atol 2e-4;
- bucketing and ``BatchingQueue`` answer every clip with its
  ``predict_logits`` row;
- the port and ``chip_smoke.py`` import no JAX and nothing of ``sl_hwgat_tpu``.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from sl_hwgat_tpu import configs as jax_configs
from sl_hwgat_tpu.data import transforms as jax_T

from sl_hwgat_tpu_torch import configs
from sl_hwgat_tpu_torch.constants import DATASET_PARAMS
from sl_hwgat_tpu_torch.data import transforms as T
from sl_hwgat_tpu_torch.models import build_model
from sl_hwgat_tpu_torch.serve import BatchingQueue, Predictor
from sl_hwgat_tpu_torch.weights import save_state_dict

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = DATASET_PARAMS["SYNTH"]
_LEFT_HAND = slice(501, 522)  # mediapipe holistic: 33 pose | 468 face | 21 left hand


def _clip(frames: int, rng, missing: str | None = None) -> np.ndarray:
    """Raw (F, 543, 4) extractor clip; ``missing`` zeroes the left hand in
    leading/trailing frames and an interior gap ("gaps") or everywhere ("all")."""
    clip = rng.random((frames, 543, 4)).astype(np.float32)
    if missing == "gaps":
        for t in (0, 1, frames // 2, frames // 2 + 1, frames // 2 + 3, frames - 1):
            clip[t, _LEFT_HAND] = 0.0
    elif missing == "all":
        clip[:, _LEFT_HAND] = 0.0
    return clip


def _pipelines(mod_configs, mod_T, src_len):
    static = mod_configs.build_static_transform("mediapipe")
    ev = mod_configs.build_eval_transform(src_len)
    return mod_T.Compose([*static.transforms, *ev.transforms])


@pytest.mark.parametrize("frames,missing", [(12, None), (32, "gaps"), (80, "gaps"),
                                            (50, "all"), (200, None)])
def test_eval_transform_equals_jax(frames, missing):
    rng = np.random.default_rng(frames)
    clip = _clip(frames, rng, missing)
    payload = lambda: {"feat": clip.copy(), "vid_width": 640, "vid_height": 480}  # noqa: E731
    want = _pipelines(jax_configs, jax_T, SYNTH["src_len"])(payload())
    got = _pipelines(configs, T, SYNTH["src_len"])(payload())
    assert got.shape == (SYNTH["src_len"], 64, 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pose_method", ["mediapipe", "dwpose"])
def test_static_transform_equals_jax(pose_method):
    clip = np.random.default_rng(3).random((20, 543, 4)).astype(np.float32)
    want = jax_configs.build_static_transform(pose_method)({"feat": clip.copy(),
                                                            "vid_width": 2, "vid_height": 3})
    got = configs.build_static_transform(pose_method)({"feat": clip.copy(),
                                                       "vid_width": 2, "vid_height": 3})
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A port checkpoint of HWGATE at the SYNTH geometry, seeded init."""
    path = str(tmp_path_factory.mktemp("port_serve") / "model.pt")
    save_state_dict(path, build_model("HWGATE", SYNTH, 2, device="cpu", seed=7))
    return path


@pytest.fixture(scope="module")
def predictor(checkpoint):
    pred = Predictor.from_checkpoint(checkpoint, model_type="HWGATE", dataset="SYNTH",
                                     device="cpu", batch_buckets=(2, 4))
    yield pred
    pred.close()


def _clips(n, seed):
    rng = np.random.default_rng(seed)
    return [_clip(int(f), rng) for f in rng.integers(SYNTH["src_len"] // 2,
                                                     SYNTH["src_len"] * 2, size=n)]


def test_predictor_matches_jax_predictor(checkpoint, predictor):
    from sl_hwgat_tpu.serve import Predictor as JaxPredictor

    clips = _clips(3, seed=0)
    jp = JaxPredictor.from_checkpoint(checkpoint, model_type="HWGATE", dataset="SYNTH",
                                      batch_buckets=(4,))
    want = jp.predict_logits(clips)
    got = predictor.predict_logits(clips)
    assert got.shape == (3, SYNTH["num_class"])
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_bucketing_and_topk(predictor):
    assert [predictor._bucket(n) for n in (1, 2, 3, 4, 5, 9)] == [2, 2, 4, 4, 8, 12]
    clips = _clips(4, seed=1)
    full = predictor.predict_logits(clips)
    np.testing.assert_allclose(predictor.predict_logits(clips[:3]), full[:3], atol=1e-5)
    out = predictor.predict_topk(clips, k=5)
    for (ids, scores), row in zip(out, full):
        assert ids.shape == (5,) and np.all(scores[:-1] >= scores[1:])
        assert ids[0] == np.argmax(row)


def test_batching_queue_answers_every_clip(predictor):
    clips = _clips(10, seed=2)
    want = np.concatenate([predictor.predict_logits([c]) for c in clips])
    q = BatchingQueue(predictor, max_batch=4, max_wait_ms=20.0)
    futures = [None] * len(clips)

    def submit(i):
        futures[i] = q.submit(clips[i])

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(len(clips))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    rows = np.stack([f.result(timeout=60) for f in futures])
    q.close()
    np.testing.assert_allclose(rows, want, atol=1e-5)
    assert q.stats["requests"] == q.stats["rows"] == sum(q.stats["batch_sizes"]) == 10
    assert max(q.stats["batch_sizes"]) <= 4 and q.stats["batches"] == len(q.stats["batch_sizes"])
    with pytest.raises(RuntimeError, match="closed"):
        q.submit(clips[0])


def test_from_checkpoint_defaults_to_cuda(checkpoint):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor.from_checkpoint(checkpoint, model_type="HWGATE", dataset="SYNTH")


_IMPORT_CHECK = """
import importlib, importlib.util, json, pkgutil, sys
for name in ("jax", "flax", "optax"):
    sys.modules[name] = None  # any import of them raises ImportError
import sl_hwgat_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(sl_hwgat_tpu_torch.__path__, "sl_hwgat_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
for script in ("chip_smoke", "main_torch"):
    spec = importlib.util.spec_from_file_location(script, script + ".py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps({
    "modules": mods,
    "reference": [n for n in sys.modules if n == "sl_hwgat_tpu" or n.startswith("sl_hwgat_tpu.")],
    "jax": [n for n, m in sys.modules.items() if m is not None
            and n.split(".")[0] in ("jax", "jaxlib", "flax", "optax")],
}))
"""


def test_port_and_chip_smoke_import_no_jax_and_no_reference_package():
    """Every port module, chip_smoke.py and main_torch.py import with jax,
    flax and optax blocked, and leave no module of the JAX package loaded."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO_ROOT
    out = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], cwd=REPO_ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("serve", "ops.window_attention", "ops.hybrid_attention", "models.hgate",
                 "train.loop", "train.state", "train.losses", "data.dataset", "data.synthetic",
                 "ops.probes", "ops.layouts", "bench.kernel", "bench.run", "utils.profiling",
                 "cli", "configs", "train.checkpoint", "train.reporting", "train.inference",
                 "ops.sparse_attention", "ops.library", "data.clipstore", "data.meta_generators",
                 "data.preprocess", "parallel", "parallel.mesh", "parallel.comm",
                 "parallel.sharding", "parallel.kernel_sharding", "parallel.edge_partition",
                 "parallel.dryrun", "train.dist", "bench.scaling", "data.pose_extract",
                 "data.pose", "data.pose.mediapipe_backend", "data.pose.dwpose",
                 "data.pose.rtmwpose"):
        assert f"sl_hwgat_tpu_torch.{name}" in seen["modules"]
    assert seen["reference"] == [] and seen["jax"] == []
