"""Build, load and count the port's hand-written CUDA kernels.

Each source under ``gmmvi_tpu_torch/csrc/`` has a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` into its own shared library under
``build/kernels/`` (at the root of the checkout) the first time a kernel of
it is launched, then loaded with ``ctypes``.  All sources build in
parallel, one ``nvcc`` each.  A library's file name carries a hash of its
source, the shared headers (``*.cuh``) and the flags, so an edited source
never reuses a stale build.

Every launching wrapper adds one to its entry in :data:`LAUNCHES` where it
launches its kernel, and nowhere else, so a run can show which kernels the
main path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# kernel name -> launches on CUDA tensors since the last reset
LAUNCHES: Dict[str, int] = {"density_pack": 0, "densities": 0, "tr_kl": 0,
                             "tr_search": 0, "background_logpdf": 0,
                             "more_grams": 0, "densities_large": 0,
                             "density_grads_large": 0, "stein_smom": 0,
                             "mixture_logpdf": 0}

_c_ptr = ctypes.c_void_p
_c_int = ctypes.c_int
# C signatures of the exported launchers (all return cudaError_t as int,
# but the ``*_workspace`` functions: bytes of scratch, as size_t)
_SIGNATURES = {
    "density.cu": {
        # means, inv_chols, logw, logdets, x, comp, model, grads, K, N, D,
        # stream
        "gmmvi_density": [_c_ptr] * 8 + [_c_int] * 3 + [_c_ptr],
    },
    "trust_region.cu": {
        # etas, prec, rq, lin, rlin, old_inv_chols, means, klconst, kl, K, D,
        # stream
        "gmmvi_tr_kl": [_c_ptr] * 9 + [_c_int] * 2 + [_c_ptr],
        # prec, rq, lin, rlin, old_inv_chols, means, klconst, kl_bound,
        # lower0, upper0, active, exp_lower, exp_upper, trips, K, D, stream
        "gmmvi_tr_search": [_c_ptr] * 14 + [_c_int] * 2 + [_c_ptr],
    },
    "background.cu": {
        # U, N, D
        "gmmvi_background_workspace": [_c_int] * 3,
        # means, inv_chols, logw, logdets, x, out, ws, U, N, D, stream
        "gmmvi_background": [_c_ptr] * 7 + [_c_int] * 3 + [_c_ptr],
        # means, inv_chols, logw, logdets, x, out, ws, K, N, D, stream
        "gmmvi_mixture_logpdf": [_c_ptr] * 7 + [_c_int] * 3 + [_c_ptr],
    },
    "more.cu": {
        # K, N, D
        "gmmvi_more_grams_workspace": [_c_int] * 3,
        # inv_chols, means, w, y, x, gram, rhs, ws, K, N, D, stream
        "gmmvi_more_grams": [_c_ptr] * 8 + [_c_int] * 3 + [_c_ptr],
    },
    "density_large.cu": {
        # K, N, D
        "gmmvi_densities_large_workspace": [_c_int] * 3,
        # means, inv_chols, logw, logdets, x, comp, model, ws, K, N, D,
        # skip_masked, stream
        "gmmvi_densities_large": [_c_ptr] * 8 + [_c_int] * 4 + [_c_ptr],
        # K, N, D
        "gmmvi_density_grads_large_workspace": [_c_int] * 3,
        # lam, means, logw, comp, model, x, grads, ws, K, N, D, stream
        "gmmvi_density_grads_large": [_c_ptr] * 8 + [_c_int] * 3 + [_c_ptr],
    },
    "stein.cu": {
        # K, N, D
        "gmmvi_stein_smom_workspace": [_c_int] * 3,
        # w, g, xc, out, ws, K, N, D, stream
        "gmmvi_stein_smom": [_c_ptr] * 5 + [_c_int] * 3 + [_c_ptr],
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _lib_path(source: str) -> Path:
    """The build of ``source``, named by a hash of it, the shared headers
    and the flags."""
    text = (CSRC_DIR / source).read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh"))) \
        + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build_all() -> Dict[str, float]:
    """Compile every source that has no current build, all ``nvcc``
    processes started together; returns seconds per source built."""
    import time

    with _lock:
        todo = [s for s in _SIGNATURES if not _lib_path(s).exists()]
        if not todo:
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        t0 = time.perf_counter()
        for source in todo:
            out = _lib_path(source)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
            procs.append((source, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        errors, build_seconds = [], {}
        for source, out, tmp, proc in procs:
            log, _ = proc.communicate()
            build_seconds[source] = time.perf_counter() - t0
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {source}:\n"
                              f"{log.decode(errors='replace')}")
                continue
            os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
        return build_seconds


def library(source: str) -> ctypes.CDLL:
    """The loaded library for ``source`` (building it first if needed)."""
    lib = _libs.get(source)
    if lib is not None:
        return lib
    build_all()
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(_lib_path(source)))
            for fn, argtypes in _SIGNATURES[source].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = (
                    ctypes.c_size_t if fn.endswith("_workspace")
                    else ctypes.c_int)
            _libs[source] = lib
    return lib


def check_tensors(tensors: Dict[str, tuple], device: torch.device) -> None:
    """Each ``name: (tensor, shape)`` is float32 (or, on the CPU, all of
    them float64: the plain versions then run in float64), of that shape,
    on ``device`` and row-major: a kernel wrapper raises rather than
    copy."""
    all64 = device.type == "cpu" and all(
        t.dtype == torch.float64 for t, _ in tensors.values())
    want = torch.float64 if all64 else torch.float32
    for name, (t, shape) in tensors.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        if t.dtype != want:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {want}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")


def workspace(lib: ctypes.CDLL, fn: str, device: torch.device,
              *sizes: int) -> torch.Tensor:
    """Scratch for one launch of ``fn``: the bytes ``fn + "_workspace"``
    asks for at ``sizes``, from PyTorch's allocator (256-byte aligned)."""
    nbytes = getattr(lib, fn + "_workspace")(*sizes)
    return torch.empty((max(int(nbytes), 1),), dtype=torch.uint8,
                       device=device)


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError_t {rc}")
