"""Build and load the CUDA kernels, and count their launches.

Each ``csrc/*.cu`` file with a plain C interface compiles with ``nvcc``
into its own shared library (``-gencode arch=compute_90a,code=sm_90a``),
every compiler started at once, and loads through ``ctypes``.  Builds land
in ``build/kernels/<digest>/`` at the root of the checkout, keyed by a
digest of the sources and flags, so an unchanged tree compiles nothing.
Nothing is built at import: the first launch builds.

``LAUNCHES`` counts kernel launches by name.  A wrapper adds one where it
launches its kernel and nowhere else; the plain versions are not counted.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIBRARIES = ("static_scan", "scout")  # one library per csrc/<name>.cu
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

LAUNCHES = {"static_lane_scan": 0, "scout_lane_scan": 0, "scout_step": 0}

_LOCK = threading.Lock()
_LIBS: dict = {}
BUILD_INFO: dict = {}  # seconds, directory, ptxas report per library


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit (CUDA_HOME or /usr/local/cuda)")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every library not yet built for these sources (one ``nvcc``
    per source, all running at once); returns the build directory."""
    out_dir = BUILD_ROOT / _digest()
    todo = [n for n in LIBRARIES if not (out_dir / f"lib{n}.so").exists()]
    nvcc = _nvcc() if todo else None
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        tmp = out_dir / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_INFO[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
        else:
            os.replace(tmp, out_dir / f"lib{name}.so")
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["directory"] = str(out_dir)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out_dir


def _bind(lib: ctypes.CDLL, name: str) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    sigs = {
        "static_scan": {
            "static_lane_scan_launch": [p, i, p, i, p, i, p, p, p, p, p, p, i, i,
                                        i, p, i, p, i, p, p, i, p],
        },
        "scout": {
            "scout_lane_scan_launch": [p, i, p, i, p, p, p, p, i, i, i, p, p, i,
                                       i, p, i, p, i, p, i, p, i, p, p, p, i, p],
            "scout_step_launch": [p, p, i, p, i, p, p, i, i, i, p, p, p, p],
        },
    }[name]
    for fn, argtypes in sigs.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building every library on first use."""
    with _LOCK:
        if name not in _LIBS:
            out_dir = build_all()
            for n in LIBRARIES:
                lib = ctypes.CDLL(str(out_dir / f"lib{n}.so"))
                _bind(lib, n)
                _LIBS[n] = lib
        return _LIBS[name]


def check(lib: ctypes.CDLL, code: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code}: {msg}")


def ptr(t) -> int:
    return t.data_ptr()
