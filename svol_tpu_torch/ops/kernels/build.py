"""Build the CUDA sources under ``svol_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``_build/lib<name>.so`` beside the package at first use, then
loaded with ``ctypes``. Pointers and the stream are passed as ``c_void_p``;
every C entry returns ``cudaGetLastError()`` so the wrapper can raise on a
launch that CUDA refused. A library is rebuilt when its source is newer.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
KERNEL_SOURCES = ("flash_attention", "flash_attention_bwd", "flash_attention_int8",
                  "gated_attention", "layer_norm", "lsap")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register / shared-memory report) of the last build
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _paths(name: str):
    return (os.path.join(CSRC_DIR, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    return (not os.path.exists(lib)
            or os.path.getmtime(lib) < os.path.getmtime(src))


def build(names=KERNEL_SOURCES) -> float:
    """Compile every stale source, one ``nvcc`` per source, all started
    together. Returns the wall seconds spent; raises with nvcc's output if
    any compile fails."""
    t0 = time.perf_counter()
    with _lock:
        todo = [n for n in names if _stale(n)]
        if not todo:
            return 0.0
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        procs: List = []
        for name in todo:
            src, lib = _paths(name)
            tmp = os.path.join(BUILD_DIR, f"lib{name}.{os.getpid()}.tmp.so")
            procs.append((name, lib, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for name, lib, tmp, proc in procs:
            out, _ = proc.communicate()
            build_log[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}.cu:\n{out}")
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(_paths(name)[1])
                _libs[name] = lib
    return lib

