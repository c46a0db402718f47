"""Lazy build + load of the native extension.

Compiles window_ops.cpp into ``afcm_tpu_torch/_build/_window_ops.so`` with g++
on first use (cached by source mtime); environments without a toolchain fall
back to numpy implementations transparently.

The port's own copy of ``afcm_tpu/native/build.py`` (host code, numpy only): the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "window_ops.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_SO = os.path.join(_BUILD_DIR, "_window_ops.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    try:
        if not os.path.exists(_SRC):
            # source-less install: trust an existing binary, else fall back
            return os.path.exists(_SO)
        # Strictly newer: an equal mtime (fresh checkout, cp -p) may be a
        # foreign-host -march=native binary — rebuild once to be safe
        # (SIGILL from a stale binary is not catchable from Python).
        if (os.path.exists(_SO)
                and os.path.getmtime(_SO) > os.path.getmtime(_SRC)):
            return True
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{_SO}.tmp.{os.getpid()}"  # unique: concurrent builds race
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o",
             tmp, _SRC],
            check=True, capture_output=True)
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.CalledProcessError) as exc:
        print(f"[afcm_tpu_torch.native] build failed, using numpy fallback: {exc}")
        return False


def get_native() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            if _build():
                try:
                    _lib = _load()
                except OSError as exc:
                    print(f"[afcm_tpu_torch.native] load failed, using numpy "
                          f"fallback: {exc}")
        return _lib


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(_SO)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    lib.assemble_windows.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, f32p]
    lib.assemble_windows.restype = None
    lib.accumulate_patches.argtypes = [
        f32p, u16p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p,
        i32p, i32p]
    lib.accumulate_patches.restype = None
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.ssim_mean.argtypes = [
        f64p, f64p, ctypes.POINTER(ctypes.c_long), ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, f64p]
    lib.ssim_mean.restype = None
    lib.err_stats.argtypes = [f64p, f64p, ctypes.c_long, f64p]
    lib.err_stats.restype = None
    return lib


def have_native() -> bool:
    return get_native() is not None
