"""Build the port's CUDA kernels at first use and load them with ctypes.

``csrc/*.cu`` compile with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, ``build/chd_tpu_torch/<content-hash>/`` under the
checkout (the directory the package sits in). The hash covers the sources
and the compiler flags, so an edited kernel builds anew and an unchanged one
loads what is there. Like the auto-build of ``chd_tpu.utils.native``, but
with no fallback: a missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Optional

from .profiling import span

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
_BUILD_ROOT = os.path.join(os.path.dirname(_PKG_DIR), "build", "chd_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class Kernels:
    lib: ctypes.CDLL
    path: str
    build_seconds: float  # 0.0 when an earlier build was loaded
    log: str              # nvcc's output, ptxas register/smem report included


_lock = threading.Lock()
_kernels: Optional[Kernels] = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        found = cand if os.path.exists(cand) else None
    if found is None:
        raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME); "
                           "the CUDA kernels of chd_tpu_torch cannot be built")
    return found


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.chd_fused_mlp_forward.argtypes = [p, ll, ll, ll, ll, i] + [p] * 4 + [i, i, p, p]
    lib.chd_fused_mlp_forward.restype = i
    for name, args in (("smem_bytes", [i, i]), ("tiles", [i, i]), ("parts", [i]),
                       ("cluster_size", []), ("ring_stages", [i, i]), ("clusters", [i, i])):
        fn = getattr(lib, f"chd_fused_mlp_{name}")
        fn.argtypes = args
        fn.restype = i
    for name in ("chd_traj_jtjv", "chd_phys_jtjv"):
        fn = getattr(lib, name)
        fn.argtypes = [i, i, ctypes.POINTER(ll), ctypes.POINTER(ll), p]
        fn.restype = i
    lib.chd_cuda_error_string.argtypes = [i]
    lib.chd_cuda_error_string.restype = ctypes.c_char_p


def kernels() -> Kernels:
    """The built kernel library; builds it on the first call. The call that
    loads it is the span ``fused_mlp.build`` (the hash, nvcc where no build
    is there, the load; attribute ``nvcc_s``)."""
    global _kernels
    with _lock:
        if _kernels is not None:
            return _kernels
        with span("fused_mlp.build") as sp:
            _kernels = _build()
            sp.attrs["nvcc_s"] = _kernels.build_seconds
        return _kernels


def _build() -> Kernels:
    sources = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    out_dir = os.path.join(_BUILD_ROOT, h.hexdigest()[:16])
    path = os.path.join(out_dir, "libchd_tpu_torch.so")
    seconds, log = 0.0, ""
    if not os.path.exists(path):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{log}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    _declare(lib)
    return Kernels(lib, path, seconds, log)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel entry returned a CUDA error."""
    if err != 0:
        msg = lib.chd_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
