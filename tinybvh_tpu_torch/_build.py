"""Builds the port's native code at first use, into `_build/` beside
this file (ignored by git), keyed by a hash of the sources and flags.

* CUDA kernels: `nvcc` compiles every `csrc/*.cu` into ONE shared
  library with a plain C interface, loaded with ctypes. A source that
  includes PyTorch's headers takes minutes to compile; a plain C
  interface takes seconds. Pointers and the stream pass as `c_void_p`;
  every C entry returns `cudaGetLastError()` and `check()` raises when
  it is not 0.
* The host BVH builder: `cc` compiles `tinybvh_tpu/native/builder.c`
  (see native/__init__.py).

Importing this module needs neither compiler; building does.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_kernels = None


def build_dir() -> str:
    d = os.path.join(_PKG, "_build")
    os.makedirs(d, exist_ok=True)
    return d


def _key(paths, flags) -> str:
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + b"\0" + f.read())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def compile_once(cmd_prefix, sources, flags, name, deps=()) -> str:
    """Run `cmd_prefix + flags + sources -o lib` unless a library keyed by
    the same sources, headers (`deps`) and flags exists. Returns the
    library path."""
    key = _key(list(sources) + list(deps), flags)
    lib = os.path.join(build_dir(), f"{name}_{key}.so")
    if not os.path.exists(lib):
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.run(cmd_prefix + flags + sources + ["-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {name} failed:\n{proc.stderr}")
        os.replace(tmp, lib)
    return lib


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # cull.cu
    "tbvh_cull": [_P, _P, _P, _P, _P, _P, _P,
                  _I, _I, _I, _I, _I, _I, _P],
    # mt_fused.cu
    "tbvh_mt_fused": [_P, _P, _P, _P, _P, _P, _P,
                      _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _I, _P],
}


def kernels():
    """The CUDA kernel library (built at first call)."""
    global _kernels
    if _kernels is None:
        sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
        headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
        lib_path = compile_once([find_nvcc(), "-I", CSRC], sources,
                                NVCC_FLAGS, "libtbvh_kernels", deps=headers)
        lib = ctypes.CDLL(lib_path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _kernels = lib
    return _kernels


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
