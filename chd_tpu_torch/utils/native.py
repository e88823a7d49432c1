"""ctypes bindings for the native runtime library (``native/chd_native.cpp``);
the port's copy of chd_tpu/utils/native.py.

Builds the shared library with the host C++ compiler on first use, into
``build/chd_native/<content-hash>/`` under the checkout (git-ignored), and
never into ``native/``. Callers fall back to their pure-Python paths when no
compiler is present or the build fails: ``load_keypoint_dir`` and
``parse_floats`` then return None.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List, Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SOURCE = os.path.join(_REPO_ROOT, "native", "chd_native.cpp")
_BUILD_ROOT = os.path.join(_REPO_ROOT, "build", "chd_native")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_lock = threading.Lock()
_lib = None
_tried = False


def _lib_path() -> str:
    with open(_SOURCE, "rb") as f:
        h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_ROOT, h, "libchd_native.so")


def _build(path: str) -> bool:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return False
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, _SOURCE], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, path)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SOURCE):
            return None
        path = _lib_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.chd_load_keypoint_dir.restype = ctypes.c_int
        lib.chd_load_keypoint_dir.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.chd_parse_floats.restype = ctypes.c_int64
        lib.chd_parse_floats.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ]
        lib.chd_native_version.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def load_keypoint_dir(files: List[str], num_joints: int = 25) -> Optional[np.ndarray]:
    """Parse OpenPose JSON files → (F, J, 3), or None if native unavailable."""
    lib = _load()
    if lib is None or not files:
        return None
    blob = b"\x00".join(f.encode() for f in files) + b"\x00"
    out = np.zeros((len(files), num_joints, 3), dtype=np.float64)
    rc = lib.chd_load_keypoint_dir(
        blob, len(files), num_joints,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if rc != 0:
        raise IOError(f"native loader failed on file #{rc}: {files[rc - 1]}")
    return out


def parse_floats(path: str, max_vals: int) -> Optional[np.ndarray]:
    """All numeric tokens of a whitespace file (at most ``max_vals``),
    skipping labels; None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(max_vals, dtype=np.float64)
    n = lib.chd_parse_floats(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_vals
    )
    if n < 0:
        raise IOError(f"cannot read {path}")
    return out[:n]
