"""Build and load the port's CUDA kernels (csrc/*.cu).

The sources are compiled on first use with nvcc, one process per source,
all started together, and linked into one shared library with a plain C
interface, loaded through ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -I csrc -c csrc/<name>.cu -o build/torch_kernels/<name>.<tag>.o
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o build/torch_kernels/librrt_torch_<hash>.so <the objects>

The library name carries a hash of the sources, the shared headers
(csrc/*.cuh) and the flags, so an edit rebuilds it; `build/` is ignored
by git. Nothing here runs at import time: the CPU tests import every
module without nvcc.
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
from typing import Optional

import torch

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -I csrc: the sources include their shared headers (tf32_wgmma.cuh,
# mha_wide.cuh), also when a copy of one is built from another directory
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-I", str(CSRC_DIR)]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_info: dict = {}


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels of review_recommender_tpu_torch cannot be built")


def library_path(extra_flags: tuple = ()) -> Path:
    h = hashlib.sha256()
    for src in _sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS + list(extra_flags)).encode())
    return BUILD_DIR / f"librrt_torch_{h.hexdigest()[:16]}.so"


def build(extra_flags: tuple = (), force: bool = False) -> Path:
    """Compile csrc/*.cu into the hashed library unless it exists (or
    `force`): one nvcc per source in parallel, then one link. Returns its
    path; `build_info` records the seconds taken and nvcc's output."""
    out = library_path(extra_flags)
    if out.exists() and not force:
        build_info.update(path=str(out), seconds=0.0, cached=True)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-c", str(src), "-o", str(obj)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, _obj, proc in jobs:
        text = proc.communicate()[0]
        logs.append(f"$ {' '.join(cmd)}\n{text}".strip())
        if proc.returncode != 0:
            failed.append(proc.returncode)
    tmp = out.with_name(f"{tag}.tmp.so")
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *(str(o) for _c, o, _p in jobs)]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append(f"$ {' '.join(link)}\n{proc.stdout}{proc.stderr}".strip())
        if proc.returncode != 0:
            failed.append(proc.returncode)
    secs = time.perf_counter() - t0
    for _c, obj, _p in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({failed}):\n" + "\n".join(logs))
    os.replace(tmp, out)
    build_info.update(path=str(out), seconds=secs, cached=False,
                      nvcc_output="\n".join(logs))
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first call, with argtypes declared."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            lib = ctypes.CDLL(str(path if path.exists() else build()))
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.rrt_mha_fwd.argtypes = [I, P, P, P, P, P, I, I, I, I, P]
            lib.rrt_mha_fwd.restype = I
            lib.rrt_mha_generic.argtypes = [I, P, P, P, P, P, I, I, I, I, P]
            lib.rrt_mha_generic.restype = I
            lib.rrt_mha_bwd.argtypes = [I, P, P, P, P, P, P, P, P, P, I, I, I, I, P]
            lib.rrt_mha_bwd.restype = I
            for fn in (lib.rrt_mha_generic_last_dp, lib.rrt_mha_bwd_last_dp,
                       lib.rrt_mha_wide_last_dc, lib.rrt_mha_wide_last_resident,
                       lib.rrt_mha_wide_bwd_last_resident):
                fn.argtypes = []
                fn.restype = I
            lib.rrt_mha_wide.argtypes = [I, P, P, P, P, P, P, I, I, I, I, I, I, P]
            lib.rrt_mha_wide.restype = I
            lib.rrt_mha_wide_bwd.argtypes = [I, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P]
            lib.rrt_mha_wide_bwd.restype = I
            lib.rrt_mha_wide_ws_floats.argtypes = [I, I, I, I, I, I]
            lib.rrt_mha_wide_ws_floats.restype = ctypes.c_longlong
            lib.rrt_mha_wide_bwd_last_dc.argtypes = [I]
            lib.rrt_mha_wide_bwd_last_dc.restype = I
            for fn, args in ((lib.rrt_mha_wide_last_split, [I]),
                             (lib.rrt_mha_wide_bwd_last_split, [I, I]),
                             (lib.rrt_mha_wide_score_tiles, []),
                             (lib.rrt_mha_wide_bwd_score_tiles, [I])):
                fn.argtypes = args
                fn.restype = ctypes.c_longlong
            lib.rrt_mha_wide_f32.argtypes = [P, P, P, P, P, P, I, I, I, I, I, P]
            lib.rrt_mha_wide_f32.restype = I
            lib.rrt_mha_wide_f32_bwd.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, P]
            lib.rrt_mha_wide_f32_bwd.restype = I
            lib.rrt_mha_wide_f32_ws_floats.argtypes = [I, I, I, I, I, I]
            lib.rrt_mha_wide_f32_ws_floats.restype = ctypes.c_longlong
            lib.rrt_mha_wide_f32_dc.argtypes = []
            lib.rrt_mha_wide_f32_dc.restype = I
            F = ctypes.c_float
            lib.rrt_bm25_packed.argtypes = [P, P, P, P, F, P, I, I, I, P]
            lib.rrt_bm25_packed.restype = I
            lib.rrt_bm25_unpacked.argtypes = [P, P, P, P, P, F, P, I, I, I, P]
            lib.rrt_bm25_unpacked.restype = I
            for fn in (lib.rrt_stage_a_wgmma, lib.rrt_stage_a_tf32):
                fn.argtypes = [P, P, P, P, P, P, I, I, I, I, P]
                fn.restype = I
            _lib = lib
        return _lib


def check_tensors(name: str, tensors: dict, dtypes: dict) -> torch.device:
    """A kernel wrapper's input check: CUDA tensors on one device, of the
    given dtypes, contiguous and 4-byte aligned. Returns the device."""
    devs = {t.device for t in tensors.values()}
    if any(t.device.type != "cuda" for t in tensors.values()):
        raise ValueError(f"{name} needs CUDA tensors (the plain version runs on the CPU)")
    if len(devs) != 1:
        raise ValueError(f"{name}: all inputs must be on one device, got {sorted(map(str, devs))}")
    for key, t in tensors.items():
        if t.dtype != dtypes[key]:
            raise ValueError(f"{name}: {key} must be {dtypes[key]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.data_ptr() % 4:
            raise ValueError(f"{name}: {key} must be 4-byte aligned")
    return devs.pop()


def check_launch(name: str, err: int, shape: str) -> None:
    """Raise if a C entry returned a nonzero cudaError (a refused launch
    never runs, and a later synchronize does not report it)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err} at {shape}")
