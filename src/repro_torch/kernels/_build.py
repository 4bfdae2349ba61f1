"""Build, load and launch the port's CUDA kernels; dispatch by device.

Every source under ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` at
first use into ``build/repro_torch_kernels/`` at the repo root (one
``nvcc`` per source, all started together) and bound with ``ctypes``: each
source exports C entry points that take device pointers and PyTorch's
current stream and return ``cudaGetLastError()`` after their launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("transition", "transition_roce", "serve_enqueue", "rank",
           "flash_attention", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-lineinfo")

_LIBS: dict = {}  # loaded libraries, by source name


def check(name, t, dtype, shape=None, device=None):
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` (and
    ``shape`` / ``device`` where given)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def route(t: torch.Tensor) -> str:
    """``"plain"`` for a CPU tensor, ``"cuda"`` for a CUDA one; anything
    else raises.  There is no fallback and no switch."""
    if t.device.type == "cpu":
        return "plain"
    if t.device.type == "cuda":
        return "cuda"
    raise ValueError(f"no kernel for device {t.device}")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card")
    return path


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() + (CSRC / "common.cuh"
                                                ).read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_all(verbose: bool = False) -> dict:
    """Compile every kernel source that is not built yet, one ``nvcc`` per
    source, all started together.  Returns ``{name: path}``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _lib_path(n) for n in SOURCES}
    procs = {}
    for name, out in todo.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu ---\n{log}")
            continue
        if verbose and log:
            print(f"--- nvcc {name}.cu ---\n{log}", flush=True)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return todo


def load(name: str, declare) -> ctypes.CDLL:
    """The loaded library of one source (building every source first, in
    one parallel round); ``declare(lib)`` sets its entry points'
    ``argtypes`` and ``restype`` once."""
    if name not in _LIBS:
        lib = ctypes.CDLL(str(build_all()[name]))
        declare(lib)
        _LIBS[name] = lib
    return _LIBS[name]


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def launch(fn, *args) -> None:
    """Call a C entry point; raise if it reports a CUDA error."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel launch failed: error {err} "
                           f"({fn.__name__})")
