"""Build the CUDA sources under ``csrc/`` at first use and bind them with ctypes.

Each source is compiled by its own ``nvcc`` for ``sm_90a``, all started
together, and the objects are linked into one shared library with a plain C
interface, cached under ``_build/`` in the package directory by a hash of the
sources and flags.  Nothing is compiled when this module is imported: the CPU
tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["library", "check", "BUILD_DIR", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "muse_glu_down": [_P] * 5 + [_I] * 3 + [_P],
    "muse_glu_down_bwd": [_P] * 8 + [_I] * 3 + [_P],
    "muse_attn_sublayer": [_P] * 12 + [_I] * 6 + [ctypes.c_float, _P],
    "muse_attn_sublayer_bwd": [_P] * 22 + [_I] * 6 + [ctypes.c_float, _P],
    "muse_attn_bwd_one_block": [_I, _I],
    "muse_cfg_sample": [_P, _I, _I, _I, _I, ctypes.c_float, _P, ctypes.c_int64, _P,
                        ctypes.c_int64, _P, _P, _P],
    "muse_sample": [_P, _I, _I, _I, _I, _P, ctypes.c_int64, _P, ctypes.c_int64, _P, _P, _P],
    "muse_vq_argmin": [_P, _P, _P, _I, _I, _I] + [_P] * 5,
    "muse_vq_split": [_P, _P, _I, _I, _I, _P, _P, _P],
    "muse_vq_route": [_I, _I, _I, ctypes.POINTER(ctypes.c_int64)],
    "muse_vq_pack": [_P, _I, _I, _P, _P],
    "muse_fused_norm": [_P] * 6 + [_I, _I, ctypes.c_float, _I, _I, _P],
    "muse_flash_attention": [_P] * 4 + [_I] * 5 + [ctypes.POINTER(ctypes.c_int64),
                                                   ctypes.c_float, _P],
    "muse_gemm": [_P] * 3 + [_I] * 6 + [_P],
    "muse_null": [_I, _P],
}

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output (ptxas register and shared-memory report)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME) to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _compile_and_link(cu, tmp: Path, target: Path) -> str:
    """One nvcc per source, all running at once, then one link; returns
    nvcc's output."""
    nvcc = _nvcc()
    objects = [tmp / f"{path.stem}.o" for path in cu]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for path, obj in zip(cu, objects)]
    logs = [f"== {path.name}\n{proc.communicate()[0]}" for path, proc in zip(cu, procs)]
    failed = [path.name for path, proc in zip(cu, procs) if proc.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    linked = tmp / target.name
    proc = subprocess.run([nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(linked),
                           *map(str, objects)], capture_output=True, text=True)
    logs.append(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n" + "\n".join(logs))
    os.replace(linked, target)
    return "\n".join(logs)


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiled on the first call."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        cu, headers = _sources()
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in cu + headers:
            digest.update(path.name.encode())
            digest.update(path.read_bytes())
        target = BUILD_DIR / f"libmuse_kernels_{digest.hexdigest()[:16]}.so"
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                build_log = _compile_and_link(cu, Path(tmp), target)
        lib = ctypes.CDLL(str(target))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(status: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t {status}")
