"""The port's data tools against the JAX package's, on the CPU.

- ``Rectifier3Dto2D``, ``ShearTransform3D`` and ``ValidFrames`` give the JAX
  transforms' arrays under the same ``rng``;
- the clip store: the port's writer read by the JAX readers and the JAX
  writer read by the port's, native and numpy, bit for bit; a uuid or count
  mismatch with the sidecar raises as in JAX; a native build that fails
  raises with the compiler's message (no fallback), and the reader is built
  under ``build/host/``, not beside its source, under a name that changes
  with the host (compiler, machine, C library);
- the meta adapters and ``generate_meta`` on the small trees of
  ``tests/test_pipeline.py`` give the JAX rows, vocabularies and files;
- ``preprocess`` writes the JAX artifacts (pickles equal, the class-map CSV
  byte-equal, the clips bit for bit) with either store, and its parser has
  the JAX flags plus ``--store``;
- ``get_loaders`` on a clip store gives the JAX loaders' batches.
"""

import argparse
import csv
import json
import os
import pickle
import types

import numpy as np
import pytest
import torch

from sl_hwgat_tpu.data import clipstore as jax_clipstore
from sl_hwgat_tpu.data import dataset as jax_dataset
from sl_hwgat_tpu.data import meta_generators as jax_meta
from sl_hwgat_tpu.data import preprocess as jax_preprocess
from sl_hwgat_tpu.data import transforms as jax_T
from sl_hwgat_tpu.configs import DataConfig as JaxDataConfig

from sl_hwgat_tpu_torch import configs
from sl_hwgat_tpu_torch.data import clipstore
from sl_hwgat_tpu_torch.data import dataset
from sl_hwgat_tpu_torch.data import meta_generators as meta
from sl_hwgat_tpu_torch.data import preprocess
from sl_hwgat_tpu_torch.data import transforms as T

SEEDS = range(4)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _clip(seed, frames=20, joints=29, coords=3, low=-0.2, high=1.2):
    return np.random.default_rng(seed).uniform(low, high, (frames, joints, coords))


@pytest.mark.parametrize("name", ["Rectifier3Dto2D", "ShearTransform3D", "ValidFrames"])
def test_transforms_match_jax(name):
    for seed in SEEDS:
        clip = _clip(seed).astype(np.float32 if seed % 2 else np.float64)
        if name == "ValidFrames" and seed == 3:
            clip = _clip(seed, low=1.5, high=2.0)  # no valid frame: kept as it is
        got_t, want_t = getattr(T, name)(), getattr(jax_T, name)()
        if getattr(got_t, "stochastic", False):
            got = got_t(clip.copy(), np.random.default_rng(seed))
            want = want_t(clip.copy(), np.random.default_rng(seed))
        else:
            got, want = got_t(clip.copy()), want_t(clip.copy())
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert getattr(T.ShearTransform3D, "stochastic", False) == jax_T.ShearTransform3D.stochastic
    ranged = T.ValidFrames(x_range=(0.1, 0.9), y_range=(0.0, 1.0))
    clip = _clip(7, frames=40, coords=2, low=0.0, high=1.0)
    np.testing.assert_array_equal(
        ranged(clip), jax_T.ValidFrames(x_range=(0.1, 0.9), y_range=(0.0, 1.0))(clip))


def _mapping(seed=0, n=7):
    r = np.random.default_rng(seed)
    return {f"{i:07d}": r.normal(size=(int(r.integers(3, 40)), 29, 2 + i % 2)).astype(np.float32)
            for i in range(n)}


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_clipstore_crosses_packages_bit_for_bit(tmp_path, writer, backend):
    m = _mapping(seed=1)
    path = str(tmp_path / "clips.cs")
    (clipstore if writer == "port" else jax_clipstore).write_clipstore(path, m)
    reader = jax_clipstore.ClipStore if writer == "port" else clipstore.ClipStore
    if writer == "port" and backend == "native" and jax_clipstore._native_lib() is None:
        pytest.fail("the JAX package's native reader did not build")
    store = reader(path, force_numpy=backend == "numpy")
    assert store.backend == backend and len(store) == len(m)
    for vid, arr in m.items():
        got = store[vid]
        assert vid in store and got.dtype == np.float32
        np.testing.assert_array_equal(got, arr)
    store.close()
    with open(path, "rb") as f:  # the same header and index layout
        assert f.read(8) == jax_clipstore.MAGIC + (2).to_bytes(4, "little")


def test_clipstore_sidecar_mismatch_raises_as_in_jax(tmp_path):
    a, b = str(tmp_path / "a.cs"), str(tmp_path / "b.cs")
    clipstore.write_clipstore(a, _mapping(seed=2, n=3))
    clipstore.write_clipstore(b, _mapping(seed=3, n=3))
    os.replace(b + ".ids", a + ".ids")  # another write's sidecar
    for reader in (clipstore.ClipStore, jax_clipstore.ClipStore):
        for force in (False, True):
            with pytest.raises(ValueError, match="uuid mismatch"):
                reader(a, force_numpy=force)
    clipstore.write_clipstore(a, _mapping(seed=2, n=3))
    with open(a + ".ids", "rb") as f:
        side = pickle.load(f)
    side["rows"]["extra"] = 3
    with open(a + ".ids", "wb") as f:
        pickle.dump(side, f)
    for reader in (clipstore.ClipStore, jax_clipstore.ClipStore):
        with pytest.raises(ValueError, match="record count 3 != sidecar 4"):
            reader(a, force_numpy=True)
    with open(a, "r+b") as f:
        f.write(b"XXXX")
    with pytest.raises(ValueError, match="not a clip store"):
        clipstore.ClipStore(a)


def test_failed_native_build_raises_and_never_falls_back(tmp_path, monkeypatch):
    path = str(tmp_path / "clips.cs")
    clipstore.write_clipstore(path, _mapping(n=2))
    broken = tmp_path / "clipstore.cpp"
    broken.write_text(clipstore.NATIVE_SRC.read_text() + "\nint broken( {\n")
    monkeypatch.setattr(clipstore, "NATIVE_SRC", broken)
    monkeypatch.setattr(clipstore, "HOST_BUILD_DIR", tmp_path / "host")
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ exited 1 .*error"):
        clipstore.ClipStore(path)
    assert not any((tmp_path / "host").iterdir())  # no library left behind
    assert clipstore.ClipStore(path, force_numpy=True).backend == "numpy"


def test_native_reader_is_keyed_by_the_host(monkeypatch):
    here = clipstore.native_library_path()
    monkeypatch.setattr(clipstore, "host_identity", lambda: "g++ 0.0 other-machine glibc 0")
    assert clipstore.native_library_path() != here
    assert clipstore.native_library_path().parent == here.parent


def test_native_reader_is_built_under_build_host():
    lib_path = clipstore.native_library_path()
    assert lib_path.parent == clipstore.HOST_BUILD_DIR
    assert clipstore.HOST_BUILD_DIR.parts[-2:] == ("build", "host")
    assert clipstore.HOST_BUILD_DIR.parent.parent == clipstore.NATIVE_SRC.parents[3]
    clipstore.native_lib()
    assert lib_path.is_file()
    assert not list(clipstore.NATIVE_SRC.parent.glob("*.so"))  # nothing beside the source


# the small trees of tests/test_pipeline.py, one per adapter

def _fdmse(root):
    for split in ("train", "test"):
        for cls in ("hello", "world", "Thanks "):
            d = os.path.join(root, split, cls)
            os.makedirs(d, exist_ok=True)
            for i in range(5 if split == "train" else 1):
                open(os.path.join(d, f"{cls.strip()}_{split}_{i}.mp4"), "w").close()
    return {}


def _fdmse_csv(root):
    os.makedirs(os.path.join(root, "vids", "d"), exist_ok=True)
    for n in ("a.mp4", "b.mp4"):
        open(os.path.join(root, "vids", "d", n), "w").close()
    split = os.path.join(root, "metadata.csv")
    with open(split, "w") as f:
        f.write("id,dir,name,class,split\n0,vids/d,a.mp4,hello,train\n"
                "1,vids/d,b.mp4,world,test\n2,vids/d,missing.mp4,ghost,train\n"
                "3,vids/d,a.mp4,hello,x\n")
    return {"split_file": split}


def _wlasl(root):
    os.makedirs(os.path.join(root, "videos"), exist_ok=True)
    content = [{"gloss": "Book", "instances": [{"video_id": "00001", "split": "train"},
                                               {"video_id": "00002", "split": "test"},
                                               {"video_id": "99999", "split": "train"}]},
               {"gloss": "drink", "instances": [{"video_id": "00003", "split": "val"}]},
               {"gloss": "zz", "instances": [{"video_id": "00004", "split": "train"}]}]
    with open(os.path.join(root, "WLASL_v0.3.json"), "w") as f:
        json.dump(content, f)
    for vid in ("00001", "00002", "00003", "00004"):
        open(os.path.join(root, "videos", f"{vid}.mp4"), "w").close()
    return {"subset": 2}


def _autsl(root):
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "train_labels.csv"), "w") as f:
        f.write("signer1_sample1,5\nsigner1_sample2,7\n")
    with open(os.path.join(root, "test_labels.csv"), "w") as f:
        f.write("signer2_sample1,5\n")
    return {}


def _msasl(root):
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "MSASL_train.json"), "w") as f:
        json.dump([{"label": 0, "clean_text": "Hello", "file": "a"},
                   {"label": 5, "clean_text": "rare", "file": "b"}], f)
    with open(os.path.join(root, "MSASL_test.json"), "w") as f:
        json.dump([{"label": 1, "clean_text": "world", "file": "c"}], f)
    return {"subset": 2}


def _include(root):
    vids = os.path.join(root, "INCLUDE", "Adjectives", "1. happy")
    os.makedirs(vids, exist_ok=True)
    names = []
    for i in range(7):
        open(os.path.join(vids, f"clip{i}.MOV"), "w").close()
        names.append(f"Adjectives/1. happy/clip{i}.MOV")
    split = os.path.join(root, "Train_Test_Split")
    os.makedirs(split, exist_ok=True)
    with open(os.path.join(split, "train_include.csv"), "w") as f:
        f.write("a,b,c,path\n" + "".join(f"x,y,z,{n}\n" for n in names[:6]))
    with open(os.path.join(split, "test_include.csv"), "w") as f:
        f.write(f"a,b,c,path\nx,y,z,{names[6]}\n")
    return {}


def _lsa64(root):
    os.makedirs(os.path.join(root, "all"), exist_ok=True)
    for cls in ("001", "002", "003"):
        for s in range(2):
            for r in range(5):
                open(os.path.join(root, "all", f"{cls}_{s:03d}_{r:03d}.mp4"), "w").close()
    return {}


def _pose(root):
    os.makedirs(root, exist_ok=True)
    meta_csv = os.path.join(root, "metadata.csv")
    with open(meta_csv, "w") as f:
        f.write("id,video_dir,video_name,class,split\n0,d/a.mp4,a.mp4,b,train\n"
                "1,d/c.mp4,c.mp4,a,test\n2,d/e.mp4,e.mp4,b,val\n")
    return {"meta_csv": meta_csv}


ADAPTERS = {
    "include_meta": (_include, {"seed": 0}),
    "fdmse_meta": (_fdmse, {"seed": 0}),
    "fdmse_meta_from_csv": (_fdmse_csv, {}),
    "wlasl_subset_meta": (_wlasl, {}),
    "autsl_meta": (_autsl, {}),
    "msasl_subset_meta": (_msasl, {}),
    "lsa64_meta": (_lsa64, {"seed": 3}),
    "pose_video_meta": (_pose, {}),
}


@pytest.mark.parametrize("name", sorted(ADAPTERS))
def test_meta_adapters_match_jax(tmp_path, name):
    make, kw = ADAPTERS[name]
    root = str(tmp_path / name)
    kw = {**kw, **make(root)}
    got = getattr(meta, name)(root, **kw)
    want = getattr(jax_meta, name)(root, **kw)
    assert got == want and len(got[0]) > 0
    assert sorted(meta.ADAPTERS) == sorted(jax_meta.ADAPTERS)
    assert all(meta.ADAPTERS[k].__name__ == jax_meta.ADAPTERS[k].__name__ for k in meta.ADAPTERS)
    for subset in (None, 7):  # the written files, byte for byte
        a = meta.generate_meta(str(tmp_path / "port" / name), got[0], got[1], subset)
        b = jax_meta.generate_meta(str(tmp_path / "jax" / name), want[0], want[1], subset)
        assert os.path.basename(a) == os.path.basename(b)
        for fa, fb in ((a, b), (a.replace("metadata", "classes").replace(".csv", ".txt"),
                                b.replace("metadata", "classes").replace(".csv", ".txt"))):
            with open(fa, "rb") as x, open(fb, "rb") as y:
                assert x.read() == y.read()


def _keypoint_tree(tmp_path, seed=0):
    """A FDMSE-style tree, its metadata.csv (generate_meta) and mediapipe
    keypoint pickles, one all-zero clip among them (dropped by both)."""
    root = str(tmp_path / "FDMSE")
    _fdmse(root)
    rows, vocab = meta.fdmse_meta(root, seed=0)
    meta_csv = meta.generate_meta(root, rows, vocab)
    kp_dir = tmp_path / "kp"
    kp_dir.mkdir()
    rng = np.random.default_rng(seed)
    for i, row in enumerate(rows):
        t = int(rng.integers(8, 40))
        feat = rng.uniform(0.1, 0.9, size=(t, 543, 4)).astype(np.float32)
        if i == 3:
            feat[:] = 0.0
        with open(kp_dir / f"{row[0]}.pkl", "wb") as f:
            pickle.dump({"feat": feat, "num_frames": t, "vid_width": 640, "vid_height": 480}, f)
    return meta_csv, str(kp_dir)


def _read(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("store", ["pickle", "clipstore"])
def test_preprocess_writes_the_jax_artifacts(tmp_path, store):
    meta_csv, kp_dir = _keypoint_tree(tmp_path)
    got = preprocess.preprocess(meta_csv, "SYNTH", kp_dir, input_root=str(tmp_path / "port"),
                                store=store)
    want = jax_preprocess.preprocess(meta_csv, "SYNTH", kp_dir,
                                     input_root=str(tmp_path / "jax"), store=store)
    for attr in ("vid_split_path", "vid_class_path"):
        assert _read(getattr(got, attr)) == _read(getattr(want, attr))
    with open(got.class_map_path, "rb") as a, open(want.class_map_path, "rb") as b:
        assert a.read() == b.read()
    gmap, wmap = _read(got.data_map_path), _read(want.data_map_path)
    if store == "clipstore":
        assert gmap == {"__clipstore__": got.data_map_path + ".cs"}
        assert wmap == {"__clipstore__": want.data_map_path + ".cs"}
        gmap = clipstore.ClipStore(gmap["__clipstore__"])
        wmap = jax_clipstore.ClipStore(wmap["__clipstore__"], force_numpy=True)
        assert gmap.backend == "native"
    assert sorted(gmap.keys()) == sorted(wmap.keys()) and len(gmap) == len(wmap) > 0
    for vid in wmap.keys():
        assert gmap[vid].shape[1:] == (29, 2)
        np.testing.assert_array_equal(gmap[vid], wmap[vid])


def test_get_loaders_on_a_clipstore_give_the_jax_batches(tmp_path):
    meta_csv, kp_dir = _keypoint_tree(tmp_path, seed=1)
    root = str(tmp_path / "input")
    preprocess.preprocess(meta_csv, "SYNTH", kp_dir, input_root=root, store="clipstore")
    common = dict(mode="train", batch_size=4, n_workers=2, seed=1001)
    port_cfg = types.SimpleNamespace(input_root=root, dataset="SYNTH", feature_type="keypoints",
                                     **common)
    jax_cfg = types.SimpleNamespace(data=JaxDataConfig("SYNTH", "keypoints", root), **common)
    src_len = 16
    got = dataset.get_loaders(port_cfg, configs.build_train_transform(src_len),
                              configs.build_eval_transform(src_len))
    from sl_hwgat_tpu import configs as jax_configs

    want = jax_dataset.get_loaders(jax_cfg, jax_configs.build_train_transform(src_len),
                                   jax_configs.build_eval_transform(src_len))
    try:
        assert got[0].dataset.data_map.backend == "native"
        for g, w in zip(got, want):
            for epoch in (0, 1):
                gb, wb = list(g.epoch(epoch)), list(w.epoch(epoch))
                assert len(gb) == len(wb) > 0
                for x, y in zip(gb, wb):
                    for a, b in zip(x, y):
                        np.testing.assert_array_equal(a, b)
    finally:
        for loader in got:
            loader.close()


def _jax_parser(monkeypatch):
    """The parser the JAX ``preprocess.main`` builds (captured at parse)."""
    seen = []

    def capture(self, args=None, namespace=None):
        seen.append(self)
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(SystemExit):
        jax_preprocess.main()
    monkeypatch.undo()
    return seen[0]


def _flags(p):
    return {a.dest: (tuple(a.option_strings), a.default, a.required, a.choices)
            for a in p._actions if a.dest != "help"}


def test_preprocess_flags_are_the_jax_ones_and_store(monkeypatch, tmp_path):
    got, want = _flags(preprocess.parser()), _flags(_jax_parser(monkeypatch))
    assert {k: v for k, v in got.items() if k != "store"} == want
    assert got["store"] == (("--store",), "pickle", False, ("pickle", "clipstore"))
    meta_csv, kp_dir = _keypoint_tree(tmp_path)
    monkeypatch.chdir(tmp_path)
    preprocess.main(["--root", os.path.dirname(kp_dir), "-dr", "kp", "-ds", "SYNTH",
                     "--meta", meta_csv, "--store", "clipstore"])
    splits, classes, store = dataset.load_artifacts("input", "SYNTH")
    assert isinstance(store, clipstore.ClipStore) and len(store) == sum(map(len, splits.values()))
    with open(os.path.join("input", "SYNTH", "class_map_SYNTH.csv")) as f:
        assert next(csv.reader(f)) == ["class", "word"]
