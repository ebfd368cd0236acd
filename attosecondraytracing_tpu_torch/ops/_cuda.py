"""Build and bind the hand-written CUDA kernels (``csrc/``).

The sources are compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use, keyed by a hash of the sources and
flags, under ``build/kernels/`` of the checkout, and loaded with ``ctypes``.
``--use_fast_math`` is deliberately absent: it would change division and
square-root rounding and break the float32 accuracy gates.

Nothing here runs at import time, and nothing falls back: a missing
``nvcc``, a failed build, a record layout that disagrees with the C structs,
or a nonzero launch status raises.
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

import numpy as np

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("fused_trace.cu", "trace_common.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib = None
#: wall seconds of the build this process ran (0.0 when the library was cached)
build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_log_path() -> Path:
    return BUILD_DIR / f"fused_trace_{_digest()}.log"


def _build() -> Path:
    """Compile the library if this source hash has no build yet; returns its
    path. The compiler's report (registers, spills) goes to the log file."""
    global build_seconds
    out = BUILD_DIR / f"libfused_trace_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / "fused_trace.cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log_path().write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load(_build())
        return _lib


def load(path) -> ctypes.CDLL:
    """Load a kernel library built from ``csrc/fused_trace.cu``, bind its C
    interface and check its record layouts against the numpy records."""
    from .fused_trace import CHAIN_T, DETECTOR_T, SOURCE_T

    lib = ctypes.CDLL(str(path))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in ("art_chain_params_size", "art_source_params_size",
                 "art_detector_params_size"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_size_t
    lib.art_moment_rays_per_block.argtypes = []
    lib.art_moment_rays_per_block.restype = ci
    lib.art_error_string.argtypes = [ci]
    lib.art_error_string.restype = ctypes.c_char_p
    lib.art_launch_fused_source_trace.argtypes = [
        vp, vp, ci, cf, cf, vp, vp, vp, vp, vp, vp, vp]
    lib.art_launch_fused_source_trace.restype = ci
    lib.art_launch_fused_source_moments.argtypes = [
        vp, vp, vp, ci, ci, ci, vp, vp, ci, vp]
    lib.art_launch_fused_source_moments.restype = ci
    for name, dt in (("art_chain_params_size", CHAIN_T),
                     ("art_source_params_size", SOURCE_T),
                     ("art_detector_params_size", DETECTOR_T)):
        size = getattr(lib, name)()
        if size != dt.itemsize:
            raise RuntimeError(f"{name}: C struct is {size} B, numpy record is "
                               f"{dt.itemsize} B — layouts disagree")
    return lib


def _check(lib, status: int, what: str):
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} "
                           f"({lib.art_error_string(status).decode()})")


def _record_ptr(rec: np.ndarray) -> int:
    if not rec.flags.c_contiguous:
        raise ValueError("kernel records must be contiguous")
    return rec.ctypes.data


def moment_rays_per_block() -> int:
    return library().art_moment_rays_per_block()


def launch_fused_source_trace(chain_rec, src_rec, n_rays, phase, k_frac,
                              p, d, opl, opl_c, alive, inc, stream):
    lib = library()
    status = lib.art_launch_fused_source_trace(
        _record_ptr(chain_rec), _record_ptr(src_rec), int(n_rays), phase, k_frac,
        p.data_ptr(), d.data_ptr(), opl.data_ptr(), opl_c.data_ptr(),
        alive.data_ptr(), inc.data_ptr(), stream)
    _check(lib, status, "fused_source_trace launch")


def launch_fused_source_moments(chain_rec, src_rec, det_rec, n_rays, chunk, n_chunks,
                                chunk_params, rows, blocks_per_chunk, stream):
    lib = library()
    status = lib.art_launch_fused_source_moments(
        _record_ptr(chain_rec), _record_ptr(src_rec), _record_ptr(det_rec),
        int(n_rays), int(chunk), int(n_chunks), chunk_params.data_ptr(),
        rows.data_ptr(), int(blocks_per_chunk), stream)
    _check(lib, status, "fused_source_moments launch")
