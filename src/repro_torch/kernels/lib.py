"""Build and load the port's hand-written CUDA kernels.

The sources under ``repro_torch/csrc/`` have a plain C interface.  At
first use they are compiled with ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` process per source, all started together, then linked into one
``libreprotorch_kernels.so`` in :data:`BUILD_DIR`: ``$REPRO_TORCH_BUILD_DIR``
if set; else ``build/repro_torch/`` at the root of the checkout
(git-ignored) when the package runs from its ``src/`` tree; else, for an
installed package, ``$XDG_CACHE_HOME/repro_torch`` (default
``~/.cache/repro_torch``), a per-user directory.  The library's file
name carries a hash of the sources, their header and the flags, so an
edited source is rebuilt and an unchanged one is reused.  The library
is loaded with ``ctypes``; every C entry point returns
``cudaGetLastError()``, which :func:`check` turns into an exception.

**The launch path.**  Every kernel launches the same lean way.  A
wrapper's host cost is paid on every call, and at the fleet's and the
zoo decode's shapes it is the whole cost of the call, so the path keeps
only what a launch needs:

* :func:`load` binds each C entry point once, with its ``argtypes``,
  to a module-level handle (:data:`replay_gather_f32`,
  :data:`fused_td_f32`, :data:`rmsnorm_f32`, :data:`rmsnorm_bf16`,
  :data:`flash_attention_f32`, :data:`flash_attention_bf16`,
  :data:`flash_attention_bf16_wgmma`, :data:`kda_step_f32`,
  :data:`kda_step_bf16`, :data:`kda_chunk_f32`, :data:`kda_chunk_bf16`,
  :data:`mhc_pre_f32`, :data:`mhc_pre_bf16`, :data:`mhc_post_f32`,
  :data:`mhc_post_bf16`);
  a wrapper calls the handle, with
  no ``load()`` or ``getattr`` on the library per call.
* An entry point takes one argument: a pointer to a C struct of the
  launch's arguments, which the wrapper packs into ``bytes`` with a
  precompiled ``struct.Struct`` (:data:`REPLAY_GATHER_ARGS`,
  :data:`FUSED_TD_ARGS`, :data:`RMSNORM_ARGS`,
  :data:`FLASH_ATTENTION_ARGS`, :data:`KDA_STEP_ARGS`,
  :data:`KDA_CHUNK_ARGS`, :data:`MHC_PRE_ARGS`, :data:`MHC_POST_ARGS`),
  through its kernel
  module's ``launch_args``,
  the one place that packs it.  ``ctypes`` converts each declared argument on
  its own, at a few hundred nanoseconds each; one packed buffer costs one
  conversion and the pack.  :func:`load` checks each format's size
  against the C struct's ``sizeof``.
* The device guard is in C (``csrc/launch.cuh``): the entry point takes
  the operands' device index, calls ``cudaGetDevice`` and
  ``cudaSetDevice`` only when the index differs, and restores it after
  the launch.
* The stream is a raw ``cudaStream_t`` read by :data:`raw_stream`
  (``torch._C._cuda_getCurrentRawStream``, the call Inductor's generated
  code makes) for that device index, without building a
  ``torch.cuda.Stream``.  It follows ``torch.cuda.stream(...)`` and graph
  capture like ``torch.cuda.current_stream(dev).cuda_stream`` (a ``cuda``
  test holds the two equal on three streams).
* The wrapper still checks device, dtype, shape and contiguity, reading
  each tensor attribute once (:func:`device_index` reads ``is_cuda`` and
  ``get_device()``, which build no ``torch.device``), allocates outputs
  with ``torch.empty``, and raises through :func:`check` when the entry
  point's ``cudaGetLastError()`` is not 0.  No entry point synchronises
  or allocates, so the launches can be captured in a CUDA graph.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = (
    "replay_gather.cu",
    "fused_td.cu",
    "rmsnorm.cu",
    "flash_attention.cu",
    "kda_step.cu",
    "kda_chunk.cu",
    "mhc.cu",
)
HEADERS = ("launch.cuh",)  # included by the sources; part of the build's hash


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

# The entry points' argument structs, field by field as in the C
# sources: pointers (and the stream) first, then 32-bit fields.
# replay_gather.cu ReplayGatherArgs: buffer, idx, w, out, stream; device,
# batch, feat; 4 bytes of padding to sizeof.
REPLAY_GATHER_ARGS = struct.Struct("@5P3i4x")
# fused_td.cu FusedTdArgs: q, q_next, rows, loss_rows, dq, loss, grad_q,
# td_abs, q_max (both null: no statistics), stream; device, n, b, a, f,
# col_action, col_reward, col_done; gamma; 4 bytes of padding to sizeof.
FUSED_TD_ARGS = struct.Struct("@10P8if4x")
# rmsnorm.cu RmsnormArgs: x, scale, out, stream; device, n, d, route,
# threads, rows_per_cta, vec; eps.
RMSNORM_ARGS = struct.Struct("@4P7if")
# flash_attention.cu FlashAttentionArgs: q, k, v, o, stream; device, b, s,
# hq, hkv, d, causal, window; scale, softcap.
FLASH_ATTENTION_ARGS = struct.Struct("@5P8i2f")
# kda_step.cu KdaStepArgs: state, qkv, g, beta, o, stream; device, bh, h,
# d; scale, eps.
KDA_STEP_ARGS = struct.Struct("@6P4i2f")
# kda_chunk.cu KdaChunkArgs: qkv, g, beta, o, state, stream; device, b, s,
# h, d; scale, eps; the C struct's tail padding to 8 bytes.
KDA_CHUNK_ARGS = struct.Struct("@6P5i2f4x")
# mhc.cu MhcPreArgs: x, phi, alpha, bias, norm, u, h_post, h_res, partial,
# counters (both null for one slice), stream; device, t, c, n,
# rows_per_warp, splits, tiles_per_split; norm_eps.
MHC_PRE_ARGS = struct.Struct("@11P7if")
# mhc.cu MhcPostArgs: x, y, h_post, h_res, out, stream; device, t, c, n.
MHC_POST_ARGS = struct.Struct("@6P4i")
# each entry point, and the sizeof function of the struct it takes
ENTRY_POINTS = {
    "replay_gather_f32": ("replay_gather_args_size", REPLAY_GATHER_ARGS),
    "fused_td_f32": ("fused_td_args_size", FUSED_TD_ARGS),
    "rmsnorm_f32": ("rmsnorm_args_size", RMSNORM_ARGS),
    "rmsnorm_bf16": ("rmsnorm_args_size", RMSNORM_ARGS),
    "flash_attention_f32": ("flash_attention_args_size", FLASH_ATTENTION_ARGS),
    "flash_attention_bf16": ("flash_attention_args_size", FLASH_ATTENTION_ARGS),
    "flash_attention_bf16_wgmma": (
        "flash_attention_args_size",
        FLASH_ATTENTION_ARGS,
    ),
    "kda_step_f32": ("kda_step_args_size", KDA_STEP_ARGS),
    "kda_step_bf16": ("kda_step_args_size", KDA_STEP_ARGS),
    "kda_chunk_f32": ("kda_chunk_args_size", KDA_CHUNK_ARGS),
    "kda_chunk_bf16": ("kda_chunk_args_size", KDA_CHUNK_ARGS),
    "mhc_pre_f32": ("mhc_pre_args_size", MHC_PRE_ARGS),
    "mhc_pre_bf16": ("mhc_pre_args_size", MHC_PRE_ARGS),
    "mhc_post_f32": ("mhc_post_args_size", MHC_POST_ARGS),
    "mhc_post_bf16": ("mhc_post_args_size", MHC_POST_ARGS),
}

_LIB: ctypes.CDLL | None = None
# The entry points' handles (ENTRY_POINTS), bound by load(); None until then.
replay_gather_f32 = None
fused_td_f32 = None
rmsnorm_f32 = None
rmsnorm_bf16 = None
flash_attention_f32 = None
flash_attention_bf16 = None
flash_attention_bf16_wgmma = None
kda_step_f32 = None
kda_step_bf16 = None
kda_chunk_f32 = None
kda_chunk_bf16 = None
mhc_pre_f32 = None
mhc_pre_bf16 = None
mhc_post_f32 = None
mhc_post_bf16 = None
raw_stream = None  # device index -> its current stream as a cudaStream_t


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
    for name in SOURCES + HEADERS:
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
    """The loaded kernel library (built on first call).  Also binds the
    entry points' module-level handles."""
    global _LIB, replay_gather_f32, fused_td_f32, rmsnorm_f32, rmsnorm_bf16
    global flash_attention_f32, flash_attention_bf16, flash_attention_bf16_wgmma
    global kda_step_f32, kda_step_bf16, kda_chunk_f32, kda_chunk_bf16, raw_stream
    global mhc_pre_f32, mhc_pre_bf16, mhc_post_f32, mhc_post_bf16
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, (size_name, fmt) in ENTRY_POINTS.items():
            size = getattr(lib, size_name)
            size.argtypes, size.restype = [], ctypes.c_int
            if size() != fmt.size:
                raise RuntimeError(
                    f"{size_name}: the C struct has {size()} bytes, its format "
                    f"{fmt.size}"
                )
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = [ctypes.c_char_p], ctypes.c_int
        replay_gather_f32, fused_td_f32 = lib.replay_gather_f32, lib.fused_td_f32
        rmsnorm_f32, rmsnorm_bf16 = lib.rmsnorm_f32, lib.rmsnorm_bf16
        flash_attention_f32 = lib.flash_attention_f32
        flash_attention_bf16 = lib.flash_attention_bf16
        flash_attention_bf16_wgmma = lib.flash_attention_bf16_wgmma
        kda_step_f32, kda_step_bf16 = lib.kda_step_f32, lib.kda_step_bf16
        kda_chunk_f32, kda_chunk_bf16 = lib.kda_chunk_f32, lib.kda_chunk_bf16
        mhc_pre_f32, mhc_pre_bf16 = lib.mhc_pre_f32, lib.mhc_pre_bf16
        mhc_post_f32, mhc_post_bf16 = lib.mhc_post_f32, lib.mhc_post_bf16
        raw_stream = torch._C._cuda_getCurrentRawStream
        _LIB = lib
    return _LIB


def device_index(kernel: str, *tensors) -> int:
    """The CUDA device index of ``tensors`` when all lie on one card, -1
    when all lie on the CPU or all on ``meta`` (the planner's shapes
    without data: a wrapper then runs its plain version, as on the CPU);
    raise when they lie on different devices or on another kind of
    device (a wrapper never falls back from one)."""
    first = tensors[0]
    if first.is_cuda:
        index = first.get_device()
        for t in tensors[1:]:
            if not t.is_cuda or t.get_device() != index:
                raise ValueError(f"{kernel} operands are on different devices")
        return index
    dev = first.device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{kernel} operands are on different devices")
    if dev.type not in ("cpu", "meta"):
        raise ValueError(f"{kernel}: unsupported device {dev}")
    return -1


def check(rc: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {rc}")


__all__ = [
    "BUILD_DIR",
    "CSRC",
    "ENTRY_POINTS",
    "FLASH_ATTENTION_ARGS",
    "FUSED_TD_ARGS",
    "HEADERS",
    "KDA_CHUNK_ARGS",
    "KDA_STEP_ARGS",
    "MHC_POST_ARGS",
    "MHC_PRE_ARGS",
    "REPLAY_GATHER_ARGS",
    "RMSNORM_ARGS",
    "SOURCES",
    "build",
    "check",
    "device_index",
    "library_path",
    "load",
]
