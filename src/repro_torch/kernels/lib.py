"""Build and load the port's hand-written CUDA kernels.

The sources under ``repro_torch/csrc/`` have a plain C interface.  At
first use they are compiled with ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` process per source, all started together, then linked into one
``libreprotorch_kernels.so`` in :data:`BUILD_DIR`: ``$REPRO_TORCH_BUILD_DIR``
if set; else ``build/repro_torch/`` at the root of the checkout
(git-ignored) when the package runs from its ``src/`` tree; else, for an
installed package, ``$XDG_CACHE_HOME/repro_torch`` (default
``~/.cache/repro_torch``), a per-user directory.  The library's file name carries a hash of
the sources and flags, so an edited source is rebuilt and an unchanged
one is reused.  The library is loaded with ``ctypes``: every pointer
and the stream are ``c_void_p``, and every C entry point returns
``cudaGetLastError()``, which :func:`check` turns into an exception.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("replay_gather.cu", "fused_td.cu", "rmsnorm.cu", "flash_attention.cu")


def _build_dir() -> Path:
    if os.environ.get("REPRO_TORCH_BUILD_DIR"):
        return Path(os.environ["REPRO_TORCH_BUILD_DIR"])
    src = Path(__file__).resolve().parents[2]
    if src.name == "src":
        return src.parent / "build" / "repro_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "repro_torch"


BUILD_DIR = _build_dir()
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
)

_LIB: ctypes.CDLL | None = None


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else
    ``nvcc`` on the ``PATH``."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libreprotorch_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the kernels unless this exact build exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (Path(name).stem + ".o") for name in SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
            for name, obj in zip(SOURCES, objs, strict=True)
        ]
        logs = [p.communicate()[0] for p in procs]
        for name, p, log in zip(SOURCES, procs, logs, strict=True):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib_tmp = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(lib_tmp)],
            capture_output=True,
            text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(lib_tmp, out)  # atomic: a reader never sees half a file
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.replay_gather_f32.argtypes = [ptr, ptr, ptr, ptr, i32, i32, ptr]
        lib.replay_gather_f32.restype = i32
        lib.fused_td_f32.argtypes = [ptr] * 6 + [i32, i32, ctypes.c_float, ptr]
        lib.fused_td_f32.restype = i32
        f32 = ctypes.c_float
        for name in ("rmsnorm_f32", "rmsnorm_bf16"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, i32, i32, f32, i32, ptr]
            fn.restype = i32
        for name in (
            "flash_attention_f32",
            "flash_attention_bf16",
            "flash_attention_bf16_wgmma",
        ):
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * 4 + [i32] * 5 + [f32, f32, i32, i32, ptr]
            fn.restype = i32
        _LIB = lib
    return _LIB


def check(rc: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {rc}")


__all__ = ["BUILD_DIR", "CSRC", "SOURCES", "build", "check", "library_path", "load"]
