"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exports plain C functions and compiles, for
``sm_90a``, into ``build/kernels/lib<name>-<hash>.so`` at the repository root
(the hash covers the source, the local headers it includes and the flags, so
an edited source or header rebuilds).
Building happens at first use, never at import: ``build()`` starts one
``nvcc`` per source, all at once, and waits for them; ``load()`` builds what
is missing and returns the loaded library; ``function()`` returns its C entry
point with the signature bound.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
SOURCES = ("window_attention_fwd", "window_attention_bwd", "banded_attention_fwd",
           "banded_attention_bwd", "masked_softmax_fwd", "masked_softmax_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_CTYPES = {"p": ctypes.c_void_p, "ll": ctypes.c_longlong, "i": ctypes.c_int,
           "f": ctypes.c_float}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every local header it includes, transitively."""
    files, todo = [], [CSRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        todo += [path.parent / inc.decode() for inc in _LOCAL_INCLUDE.findall(path.read_bytes())]
    return files


def library_path(name: str) -> Path:
    """The library's path; its hash covers the source, its local headers and
    the flags, so an edit to any of them builds anew."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> dict[str, dict]:
    """Compile every missing library of ``names`` in parallel.

    Returns ``{name: {"seconds": wall time, "log": nvcc's stderr}}`` for the
    sources it compiled (``-Xptxas -v`` puts registers and spills there).
    Raises ``RuntimeError`` with the compiler's output if one fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs[name] = (proc, tmp, target, time.perf_counter())
    report = {}
    failures = []
    for name, (proc, tmp, target, t0) in jobs.items():
        out, err = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{out}{err}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, target)
        report[name] = {"seconds": seconds, "log": out + err}
    if failures:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failures))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def function(name: str, argtypes):
    """The C function ``name`` of ``csrc/<name>.cu``, built at first use,
    with ``argtypes`` bound ("p" pointer, "ll" long long, "i" int, "f"
    float: ctypes would pass an unbound pointer as a 32-bit int) and an int
    (cudaError_t) result."""
    fn = getattr(load(name), name)
    with _LOCK:
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = [_CTYPES[t] for t in argtypes]
    return fn
