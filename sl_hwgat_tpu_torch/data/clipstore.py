"""Clip store: an mmap-backed float32 record file of preprocessed keypoint
clips, the port's own copy of ``sl_hwgat_tpu/data/clipstore.py`` (the same
on-disk format, version 2), in place of the reference's all-in-RAM
``data_map`` pickle (`hwgat/data_preprocess.py:102-116`).

Two readers of one format (``native/clipstore.cpp`` describes it):

1. **native** (the default): the C reader ``native/clipstore.cpp``, built at
   first use with ``g++ -O3 -shared -fPIC`` into
   ``build/host/libclipstore-<hash>.so`` at the repository root (the hash
   covers the source, the flags, g++'s version, the machine and the C
   library, so an edited source or another host builds anew) and bound
   through ctypes. A build or load that fails raises with the
   compiler's or the loader's message: there is no silent fallback.
2. **numpy** (``force_numpy=True``): ``np.memmap`` parsing of the same
   layout, bit for bit the same clips.

``ClipStore`` is mapping-like (``store[vid] -> np.ndarray``), so it drops
into ``KeypointDataset.data_map`` unchanged; ``backend`` says which reader
runs. ``write_clipstore`` converts any ``{id: (T, V, C) float32 array}``
mapping; the id → row table is a ``.ids`` pickle sidecar.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pickle
import platform
import struct
import subprocess
import threading
import uuid
from pathlib import Path

import numpy as np

MAGIC = b"SLCS"
VERSION = 2
_HEADER = 32  # magic, version u32, n u64, store uuid (16 bytes)
_INDEX_ENTRY = 16  # offset u64, T u32, (V<<16|C) u32

NATIVE_SRC = Path(__file__).resolve().parent / "native" / "clipstore.cpp"
HOST_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LIBS: dict[Path, ctypes.CDLL] = {}
_LOCK = threading.Lock()


@functools.lru_cache(maxsize=1)
def host_identity() -> str:
    """g++'s version, the machine and the C library: a library built on one
    host is never loaded on another."""
    try:
        cxx = subprocess.run(["g++", "-dumpfullversion"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
    except OSError:
        cxx = "no g++"  # the build then raises with the reason
    return " ".join([cxx, platform.machine(), *platform.libc_ver()])


def native_library_path(src: Path | None = None) -> Path:
    """Where the reader built from ``src`` lives: its name carries a hash of
    the source, the flags and ``host_identity()``."""
    src = NATIVE_SRC if src is None else src
    key = "\0".join([" ".join(CXX_FLAGS), host_identity()]).encode()
    h = hashlib.sha256(key + b"\0" + src.read_bytes())
    return HOST_BUILD_DIR / f"libclipstore-{h.hexdigest()[:12]}.so"


def native_lib() -> ctypes.CDLL:
    """The native reader, built first if missing. Raises ``RuntimeError``
    with the compiler's output when the build fails, ``OSError`` when the
    library does not load."""
    src = NATIVE_SRC
    target = native_library_path(src)
    with _LOCK:
        lib = _LIBS.get(target)
        if lib is not None:
            return lib
        if not target.exists():
            HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # a process-unique temporary, then an atomic rename: concurrent
            # builds never load or keep a half-written library
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            try:
                proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(src)],
                                      capture_output=True, text=True, timeout=300)
            except OSError as e:
                raise RuntimeError(f"clip store reader: g++ did not run: {e}") from e
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"clip store reader: g++ exited {proc.returncode} building "
                                   f"{src}\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, target)
        lib = ctypes.CDLL(str(target))
        lib.cs_open.restype = ctypes.c_void_p
        lib.cs_open.argtypes = [ctypes.c_char_p]
        lib.cs_close.restype = None
        lib.cs_close.argtypes = [ctypes.c_void_p]
        lib.cs_len.restype = ctypes.c_int64
        lib.cs_len.argtypes = [ctypes.c_void_p]
        lib.cs_read.restype = ctypes.c_int
        lib.cs_read.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        _LIBS[target] = lib
        return lib


def write_clipstore(path: str, mapping: dict) -> None:
    """Write ``{id: (T, V, C) float32 ndarray}`` as a clip store and its id
    sidecar. A random store uuid goes into both files and is checked at
    open, so a crash between the two atomic replaces can never pair a new
    store with a stale id → row table (it fails loudly instead)."""
    ids = list(mapping.keys())
    n = len(ids)
    store_uuid = uuid.uuid4().bytes
    offset = _HEADER + n * _INDEX_ENTRY
    index = bytearray()
    payloads = []
    for vid in ids:
        arr = np.ascontiguousarray(np.asarray(mapping[vid], dtype=np.float32))
        if arr.ndim != 3:
            raise ValueError(f"clip {vid!r} must be (T, V, C), got {arr.shape}")
        t, v, c = arr.shape
        if v >= 1 << 16 or c >= 1 << 16:
            raise ValueError(f"clip {vid!r} dims too large for the index: {arr.shape}")
        index += struct.pack("<QII", offset, t, (v << 16) | c)
        payloads.append(arr)
        offset += arr.nbytes
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC + struct.pack("<IQ", VERSION, n) + store_uuid)
        f.write(bytes(index))
        for arr in payloads:
            f.write(arr.tobytes())
    tmp_ids = path + ".ids.tmp"
    with open(tmp_ids, "wb") as f:
        pickle.dump({"rows": {vid: row for row, vid in enumerate(ids)}, "uuid": store_uuid}, f)
    os.replace(tmp, path)
    os.replace(tmp_ids, path + ".ids")


class ClipStore:
    """Mapping-like reader over a clip store file: the native reader, or
    numpy's with ``force_numpy=True``. ``close()`` releases the mapping."""

    def __init__(self, path: str, force_numpy: bool = False):
        self.path = path
        with open(path + ".ids", "rb") as f:
            sidecar = pickle.load(f)
        self._rows = sidecar["rows"]
        # the store and its sidecar must come from one write (see the writer)
        with open(path, "rb") as f:
            header = f.read(_HEADER)
        if len(header) < _HEADER or header[:4] != MAGIC:
            raise ValueError(f"{path}: not a clip store")
        version, n = struct.unpack("<IQ", header[4:16])
        if version != VERSION:
            raise ValueError(f"{path}: unsupported version {version}")
        if header[16:32] != sidecar["uuid"]:
            raise ValueError(
                f"{path}: id sidecar does not match the store (uuid mismatch "
                "— interrupted rewrite?); regenerate with write_clipstore")
        if n != len(self._rows):
            raise ValueError(f"{path}: record count {n} != sidecar {len(self._rows)}")
        self._lib = self._handle = self._mm = None
        with open(path, "rb") as f:
            f.seek(_HEADER)
            raw = f.read(n * _INDEX_ENTRY)
        # (offset, (T, V, C)) per row: one index parse for both readers, so a
        # native read is one call into the library
        self._index = []
        for i in range(n):
            offset, t, vc = struct.unpack_from("<QII", raw, i * _INDEX_ENTRY)
            self._index.append((offset, (t, vc >> 16, vc & 0xFFFF)))
        if force_numpy:
            self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        else:
            self._lib = native_lib()
            self._handle = self._lib.cs_open(os.fsencode(path))
            if not self._handle:
                raise OSError(f"{path}: the native reader could not open the store")

    @property
    def backend(self) -> str:
        return "numpy" if self._lib is None else "native"

    def __len__(self):
        return len(self._rows)

    def __contains__(self, vid):
        return vid in self._rows

    def keys(self):
        return self._rows.keys()

    def _read_row(self, row: int) -> np.ndarray:
        offset, shape = self._index[row]
        if self._lib is not None:
            if not self._handle:
                raise ValueError(f"{self.path}: the store is closed")
            out = np.empty(shape, np.float32)
            rc = self._lib.cs_read(self._handle, row, out.ctypes.data)
            if rc != 0:
                raise OSError(f"{self.path}: clip store read failed: rc={rc}")
            return out
        t, v, c = shape
        flat = np.frombuffer(self._mm, dtype=np.float32, count=t * v * c, offset=offset)
        return flat.reshape(shape).copy()

    def __getitem__(self, vid) -> np.ndarray:
        return self._read_row(self._rows[vid])

    def close(self) -> None:
        lib, handle = getattr(self, "_lib", None), getattr(self, "_handle", None)
        if lib is not None and handle:
            lib.cs_close(handle)
            self._handle = None

    def __del__(self):
        self.close()
