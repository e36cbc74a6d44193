"""Builds the port's native code at first use, into `_build/` beside
this file (ignored by git), keyed by a hash of the sources and flags.

* CUDA kernels: one `nvcc` per `csrc/*.cu`, all started together,
  compiles each source to an object (`compile_once`); one more links
  them into ONE shared library with a plain C interface, loaded with ctypes. A source
  that includes PyTorch's headers takes minutes to compile; a plain C
  interface takes seconds. Pointers and the stream pass as `c_void_p`;
  every C entry returns `cudaGetLastError()` and `check()` raises when
  it is not 0.
* The host BVH builder: `cc` compiles the port's `native/builder.c`
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
              "-O3", "-Xcompiler", "-fPIC"]

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


def compile_once(compile_cmd, sources, link_cmd, name, deps=()) -> str:
    """Build the shared library `name` from `sources` unless a library
    keyed by the same sources, headers (`deps`) and commands exists: one
    `compile_cmd -c src -o obj` per source, all started together, then
    `link_cmd objs -o lib`. Returns the library path."""
    key = _key(list(sources) + list(deps), compile_cmd + link_cmd)
    lib = os.path.join(build_dir(), f"{name}_{key}.so")
    if os.path.exists(lib):
        return lib
    work = f"{lib}.{os.getpid()}.d"
    os.makedirs(work, exist_ok=True)
    try:
        objs = [os.path.join(work, os.path.basename(src) + ".o")
                for src in sources]
        procs = [subprocess.Popen(compile_cmd + ["-c", src, "-o", obj],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(sources, objs)]
        errs = [(src, p.communicate()[1], p.returncode)
                for src, p in zip(sources, procs)]
        failed = [f"{src}:\n{err}" for src, err, rc in errs if rc != 0]
        if failed:
            raise RuntimeError(f"building {name} failed:\n"
                               + "\n".join(failed))
        tmp = f"{lib}.{os.getpid()}.tmp"
        proc = subprocess.run(link_cmd + objs + ["-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"linking {name} failed:\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # cull.cu
    "tbvh_cull": [_P, _P, _P, _P, _P, _P, _P,
                  _I, _I, _I, _I, _I, _I, _P],
    "tbvh_cull_occupancy": [_P],
    # mt_fused.cu
    "tbvh_mt_fused": [_P, _P, _P, _P, _P, _P, _P,
                      _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "tbvh_mt_fused_occupancy": [_I, _P],
    "tbvh_mt_fused_omap_occupancy": [_I, _P],
    # mt_gathered.cu
    "tbvh_mt_gathered": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "tbvh_mt_gathered_occupancy": [_P],
    # cull_blocks.cu
    "tbvh_cull_blocks": [_P, _P, _P, _P, _I, _I, _I, _P],
    "tbvh_cull_blocks_occupancy": [_P],
    # leaf_resolve.cu
    "tbvh_leaf_resolve_v2": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "tbvh_leaf_resolve_v2_occupancy": [_I, _P],
    "tbvh_leaf_resolve": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "tbvh_leaf_resolve_occupancy": [_P],
    # frustum_walk.cu
    "tbvh_frustum_walk": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "tbvh_frustum_walk_seq": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    "tbvh_frustum_walk_occupancy": [_P],
    # gather_probe.cu
    "tbvh_gather_row": [_P, _P, _P, _I, _I, _I, _I, _P],
    "tbvh_gather_col": [_P, _P, _P, _I, _I, _P],
    "tbvh_gather_lane": [_P, _P, _P, _I, _I, _P],
    "tbvh_gather_sublane": [_P, _P, _P, _I, _I, _P],
    "tbvh_gather_flat": [_P, _P, _P, _I, _I, _P],
    "tbvh_gather_chain": [_P, _P, _P, _I, _P],
    "tbvh_gather_sum": [_P, _P, _P, _I, _I, _I, _I, _P],
    "tbvh_gather_empty": [_P],
    "tbvh_gather_row_occupancy": [_I, _P],
    "tbvh_gather_col_occupancy": [_P],
    "tbvh_gather_sublane_occupancy": [_P],
    "tbvh_gather_lane_occupancy": [_I, _P],
    "tbvh_gather_flat_occupancy": [_I, _P],
    "tbvh_gather_chain_occupancy": [_P],
    "tbvh_gather_sum_occupancy": [_P],
    "tbvh_gather_onehot": [_P, _P, _P, _I, _I, _I, _I, _P],
    "tbvh_gather_onehot_occupancy": [_P],
    # retrace.cu
    "tbvh_retrace": [_P] * 4 + [_F] + [_P] * 12 + [_I, _I, _I, _P],
    "tbvh_retrace_occupancy": [_P],
    # mt_ablation.cu
    "tbvh_mt_ablation": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _P],
    "tbvh_mt_ablation_occupancy": [_I, _P],
}


def kernels():
    """The CUDA kernel library (built at first call)."""
    global _kernels
    if _kernels is None:
        sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
        headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
        nvcc = find_nvcc()
        lib_path = compile_once([nvcc, "-I", CSRC] + NVCC_FLAGS, sources,
                                [nvcc, "-shared"], "libtbvh_kernels",
                                deps=headers)
        lib = ctypes.CDLL(lib_path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _kernels = lib
    return _kernels


OCCUPANCY = ("threads", "registers", "static_smem", "dynamic_smem",
             "local_bytes", "ctas_per_sm")


def occupancy(entry: str, *args) -> dict:
    """The resources of one kernel as its C entry `entry` reports them
    (common.cuh kernel_occupancy): OCCUPANCY -> int."""
    out = (ctypes.c_int * len(OCCUPANCY))()
    check(getattr(kernels(), entry)(*args, ctypes.addressof(out)), entry)
    return dict(zip(OCCUPANCY, out))


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
