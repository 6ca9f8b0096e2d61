"""The port's pose-extraction script, its backends and the ``.mp4``
data-map entry (``sl_hwgat_tpu_torch/data/pose_extract.py``,
``data/pose/``, ``data/dataset.py::load_entry``) against the JAX
package's, with the fake backends and frames of
``tests/test_pose_extract.py`` and ``tests/test_pose_backends.py`` run on
both packages: the payloads are equal, the registries' shapes are equal,
both raise ImportError without their dependencies, and both raise the
``.mp4`` ImportError without decord. The port's mmpose backends run on
the card unless the caller asks for the host. (The real-mp4 test of
``tests/test_pose_extract.py`` needs OpenCV, absent here, and is not
ported.)
"""

import importlib
import os
import pickle
import sys
import types

import numpy as np
import pytest
import torch

import sl_hwgat_tpu.data.dataset as jax_dataset
import sl_hwgat_tpu.data.pose as jax_pose
import sl_hwgat_tpu.data.pose_extract as jax_px
from sl_hwgat_tpu.data.pose.dwpose import Model as JaxDWModel
from sl_hwgat_tpu.data.pose.mediapipe_backend import Model as JaxMPModel

import sl_hwgat_tpu_torch.data.dataset as port_dataset
import sl_hwgat_tpu_torch.data.pose as port_pose
import sl_hwgat_tpu_torch.data.pose_extract as port_px
from sl_hwgat_tpu_torch.data.pose.dwpose import Model as PortDWModel
from sl_hwgat_tpu_torch.data.pose.mediapipe_backend import Model as PortMPModel
from sl_hwgat_tpu_torch.data.pose.rtmwpose import Model as RTMWModel

EXTRACTORS = {"jax": jax_px, "port": port_px}
BACKENDS = {"jax": (JaxMPModel, JaxDWModel), "port": (PortMPModel, PortDWModel)}


class FakePose:
    def __call__(self, image):
        h, w = image.shape[:2]
        return np.full((543, 4), image.mean() / 255.0 + 0.5, np.float32), h, w


def fake_frames(path):
    if "broken" in path:
        raise RuntimeError("decode error")
    for i in range(5):
        yield np.full((48, 64, 3), 10 * i, np.uint8)


def _payload(px, tmp_path, monkeypatch, job):
    monkeypatch.setattr(px, "_frames", fake_frames)
    out = px.extract_one(job, str(tmp_path), pose_model=FakePose())
    if out is None:
        return None
    with open(out, "rb") as f:
        return pickle.load(f)


def test_extract_one_payloads_are_equal(tmp_path, monkeypatch):
    job = {"id": "vid0", "video_dir": "a/b.mp4", "video_name": "b.mp4", "root": str(tmp_path)}
    got = {k: _payload(px, tmp_path / k, monkeypatch, job) for k, px in EXTRACTORS.items()}
    assert got["port"].keys() == got["jax"].keys()
    np.testing.assert_array_equal(got["port"]["feat"], got["jax"]["feat"])
    assert got["port"]["feat"].shape == (5, 543, 4)
    for k in ("num_frames", "vid_loc", "vid_name", "vid_width", "vid_height"):
        assert got["port"][k] == got["jax"][k], k


def test_extract_one_is_idempotent_and_skips_broken_videos(tmp_path, monkeypatch, capsys):
    for k, px in EXTRACTORS.items():
        monkeypatch.setattr(px, "_frames", fake_frames)
        job = {"id": "vid0", "video_dir": "a.mp4", "video_name": "a.mp4",
               "root": str(tmp_path)}
        out = px.extract_one(job, str(tmp_path / k), pose_model=FakePose())
        mtime = os.path.getmtime(out)
        assert px.extract_one(job, str(tmp_path / k), pose_model=FakePose()) == out
        assert os.path.getmtime(out) == mtime
        bad = dict(job, id="bad", video_dir="broken.mp4")
        assert px.extract_one(bad, str(tmp_path / k), pose_model=FakePose()) is None
        assert "failed" in capsys.readouterr().out
        assert not os.path.exists(tmp_path / k / "bad.pkl")


def test_read_metadata_and_extract_all_agree(tmp_path, monkeypatch):
    meta = tmp_path / "metadata.csv"
    meta.write_text("id,video_dir,video_name,class,split\n0,a/x.mp4,x.mp4,hello,train\n"
                    "1,a/y.mp4,y.mp4,world,test\n2,broken.mp4,broken.mp4,bad,val\n")
    jobs = {k: px.read_metadata(str(meta), "/videos") for k, px in EXTRACTORS.items()}
    assert jobs["port"] == jobs["jax"]
    written = {}
    for k, px, registry in (("jax", jax_px, jax_pose), ("port", port_px, port_pose)):
        monkeypatch.setattr(px, "_frames", fake_frames)
        monkeypatch.setattr(registry, "load_pose_model",
                            lambda name, **kw: (FakePose(), (543, 4)))
        paths = px.extract_all(str(meta), str(tmp_path / "videos"), str(tmp_path / k),
                               pose_name="mediapipe", workers=1)
        written[k] = sorted(os.path.basename(p) for p in paths)
        assert px.extract_all(str(meta), str(tmp_path / "videos"), str(tmp_path / k),
                              pose_name="mediapipe", workers=1) == []
    assert written["port"] == written["jax"] == ["0.pkl", "1.pkl"]


def test_main_parses_the_jax_flags(tmp_path, monkeypatch):
    argv = ["pose_extract", "--root", str(tmp_path), "-ds", "X", "--meta", "m.csv",
            "-kpm", "dwpose", "--workers", "3"]
    calls = {}
    for k, extra in (("jax", []), ("port", []), ("port_cpu", ["--device", "cpu"])):
        px = EXTRACTORS[k.split("_")[0]]
        monkeypatch.setattr(px, "extract_all", lambda *a, k=k: calls.setdefault(k, a))
        monkeypatch.setattr("sys.argv", argv + extra)
        px.main()
    want = ("m.csv", str(tmp_path), os.path.join(str(tmp_path), "X_keypoints"), "dwpose", 3)
    assert calls["jax"] == want
    # the port's --device, the card by default
    assert calls["port"] == want + ("cuda",) and calls["port_cpu"] == want + ("cpu",)


@pytest.mark.parametrize("name,passed", [("dwpose", True), ("rtmwpose", True),
                                         ("mediapipe", False)])
def test_extract_all_hands_the_device_to_the_mmpose_backends(tmp_path, monkeypatch, name,
                                                             passed):
    meta = tmp_path / "metadata.csv"
    meta.write_text("id,video_dir,video_name,class,split\n0,a/x.mp4,x.mp4,hello,train\n")
    seen = []

    class Recording(FakePose):
        def __init__(self, **kw):
            seen.append(kw)

    module = importlib.import_module(port_pose.KEYPOINT_MODEL_DICT[name]["module"])
    monkeypatch.setattr(module, "Model", Recording)
    monkeypatch.setattr(port_px, "_frames", fake_frames)
    for device in ("cuda", "cpu"):
        port_px.extract_all(str(meta), str(tmp_path / "videos"), str(tmp_path / device),
                            pose_name=name, workers=1, device=device)
    # mediapipe runs on the host whatever the device
    assert seen == ([{"device": "cuda"}, {"device": "cpu"}] if passed else [{}, {}])


@pytest.mark.parametrize("cls", [PortDWModel, RTMWModel])
def test_mmpose_backends_default_to_the_card_and_refuse_without_one(monkeypatch, cls):
    inits = []
    apis = types.ModuleType("mmpose.apis")
    apis.inference_topdown = lambda model, image: None
    apis.init_model = lambda config, checkpoint, device: inits.append(device) or "net"
    utils = types.ModuleType("mmpose.utils")
    utils.register_all_modules = lambda: None
    for mod_name, mod in (("mmpose", types.ModuleType("mmpose")), ("mmpose.apis", apis),
                          ("mmpose.utils", utils)):
        monkeypatch.setitem(sys.modules, mod_name, mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no card is present"):
        cls()
    assert cls(device="cpu").model == "net" and inits == ["cpu"]


def _landmarks(n, x=0.25, vis=0.75):
    pts = [types.SimpleNamespace(x=x, y=0.5, z=0.0, visibility=vis) for _ in range(n)]
    return types.SimpleNamespace(landmark=pts)


@pytest.mark.parametrize("parts", [
    dict(pose_landmarks=_landmarks(33, x=0.1, vis=0.6), face_landmarks=None,
         left_hand_landmarks=_landmarks(21, x=0.9), right_hand_landmarks=None),
    dict(pose_landmarks=None, face_landmarks=None, left_hand_landmarks=None,
         right_hand_landmarks=None),
])
def test_mediapipe_features_are_equal(parts):
    results = types.SimpleNamespace(**parts)
    want = BACKENDS["jax"][0]._features(results)
    got = BACKENDS["port"][0]._features(results)
    assert got.shape == (543, 4)
    np.testing.assert_array_equal(got, want)


def _dw_instance(cls, keypoints, scores):
    m = cls.__new__(cls)
    inst = types.SimpleNamespace(keypoints=keypoints, keypoint_scores=scores)
    result = types.SimpleNamespace(pred_instances=inst, img_shape=(48, 64))
    m._inference = lambda model, image: [result]
    m.model = None
    return m


@pytest.mark.parametrize("detected", [True, False])
def test_dwpose_outputs_are_equal(detected):
    r = np.random.default_rng(0)
    kp = r.uniform(size=(1, 133, 2)).astype(np.float32) if detected else np.zeros((1, 133, 2))
    sc = np.linspace(0, 1, 133, dtype=np.float32)[None] if detected else np.zeros((1, 133))
    image = np.zeros((48, 64, 3), np.uint8)
    want = _dw_instance(BACKENDS["jax"][1], kp, sc)(image)
    got = _dw_instance(BACKENDS["port"][1], kp, sc)(image)
    assert got[1:] == want[1:] == (48, 64)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].shape == (133, 3)


def test_registries_have_the_same_shapes_and_point_into_their_package():
    port, jax_reg = port_pose.KEYPOINT_MODEL_DICT, jax_pose.KEYPOINT_MODEL_DICT
    assert {k: v["shape"] for k, v in port.items()} == {k: v["shape"] for k, v in
                                                        jax_reg.items()}
    for name, info in port.items():
        assert info["module"] == jax_reg[name]["module"].replace(
            "sl_hwgat_tpu.", "sl_hwgat_tpu_torch.", 1)
        assert importlib.import_module(info["module"]).Model is not None


@pytest.mark.parametrize("name", ["mediapipe", "dwpose", "rtmwpose"])
def test_both_raise_the_same_import_error_without_their_dependencies(name):
    messages = []
    for registry in (jax_pose, port_pose):
        try:
            registry.load_pose_model(name)
        except ImportError as e:
            messages.append(str(e))
        except Exception as e:  # pragma: no cover - partially-installed deps
            pytest.skip(f"{name} deps partially installed: {type(e).__name__}: {e}")
        else:  # pragma: no cover - only if the heavy deps exist
            pytest.skip(f"{name} deps installed in this image")
    assert messages[0] == messages[1] and "not installed" in messages[0]


def test_mp4_entries_need_decord_in_both(tmp_path):
    try:
        import decord  # noqa: F401
        pytest.skip("decord is installed in this image")
    except ImportError:
        pass
    path = str(tmp_path / "clip.mp4")
    messages = []
    for dataset in (jax_dataset, port_dataset):
        with pytest.raises(ImportError) as err:
            dataset.load_entry(path)
        messages.append(str(err.value))
    assert messages[0] == messages[1] == "decord is required to read .mp4 data-map entries"
    for dataset in (jax_dataset, port_dataset):
        with pytest.raises(ValueError, match="unsupported data-map entry"):
            dataset.load_entry(str(tmp_path / "clip.avi"))
