"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on first use
into ``afcm_tpu_torch/_build/lib<name>_<hash>.so``; the hash covers the
source and the flags, so an edited source rebuilds. ``load_libraries``
runs one nvcc per source, all at once. Nothing here runs at
import time: the CPU tests import every module on a machine without nvcc.
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
from typing import Dict, Tuple

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# sm_90a keeps wgmma/setmaxnreg available to later kernels; -Xptxas -v
# reports registers, shared memory and spills into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, Tuple[ctypes.CDLL, dict]] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def load_libraries(names) -> Dict[str, Tuple[ctypes.CDLL, dict]]:
    """Build (if needed) and load ``csrc/<name>.cu`` for every name, cached
    per process; the nvcc runs of all sources that need a build run at the
    same time. Returns ``{name: (library, info)}``; info holds the .so path,
    the build seconds (0.0 when the cached binary was reused) and nvcc's
    log."""
    with _lock:
        pending = {}
        for name in names:
            if name in _loaded or name in pending:
                continue
            src = CSRC_DIR / f"{name}.cu"
            digest = hashlib.sha256(src.read_bytes() +
                                    " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
            so = BUILD_DIR / f"lib{name}_{digest}.so"
            info = {"path": str(so), "seconds": 0.0, "log": ""}
            proc = tmp = None
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                proc = subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            pending[name] = (src, so, tmp, info, proc, time.perf_counter())
        for src, so, tmp, info, proc, t0 in pending.values():
            if proc is not None:           # every nvcc ends before any error
                info["log"] = proc.communicate()[0]
                info["seconds"] = time.perf_counter() - t0
        for name, (src, so, tmp, info, proc, t0) in pending.items():
            if proc is not None:
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {src}:\n{info['log']}")
                os.replace(tmp, so)
            _loaded[name] = (ctypes.CDLL(str(so)), info)
        return {name: _loaded[name] for name in names}


def load_library(name: str) -> Tuple[ctypes.CDLL, dict]:
    """``load_libraries([name])[name]``."""
    return load_libraries([name])[name]
