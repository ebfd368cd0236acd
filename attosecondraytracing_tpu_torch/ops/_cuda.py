"""Build and bind the hand-written CUDA kernels (``csrc/``).

Each ``.cu`` source is compiled by its own ``nvcc`` for ``sm_90a`` (all
started together), the objects are linked into one shared library with a
plain C interface at first use, keyed by a hash of the sources and flags,
under ``build/kernels/`` of the checkout, and loaded with ``ctypes``.
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
#: compiled sources, one object each: K1, K1i, K2 and K8; K5; K3 and K4; K6
#: and K7; the gather probes P4 and P5; the cost probes P1-P3
UNITS = ("fused_trace.cu", "fused_scan.cu", "streamed_trace.cu", "fused_grad.cu",
         "gather_probe.cu", "cost_probe.cu")
SOURCES = UNITS + ("trace_common.cuh", "dual.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
#: flags of each source's compile (the link adds ``-shared``)
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-lineinfo", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)

#: version of the C interface these bindings take (``art_abi_version``)
ABI_VERSION = 7

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
    return BUILD_DIR / f"kernels_{_digest()}.log"


def _build() -> Path:
    """Compile the library if this source hash has no build yet; returns its
    path. The compilers' reports (registers, spills) go to the log file."""
    global build_seconds
    digest = _digest()
    out = BUILD_DIR / f"libkernels_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{digest}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for unit in UNITS:
        obj = BUILD_DIR / f"{Path(unit).stem}_{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / unit)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _obj, proc in jobs:
        text, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{text}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp), *(str(obj) for _c, obj, _p in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(f"link ({res.returncode}):\n{res.stdout}{res.stderr}")
    build_seconds = time.perf_counter() - t0
    build_log_path().write_text("\n".join(log))
    for _c, obj, _p in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
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
    """Load a kernel library built from ``csrc/``, refuse it unless it has
    this C interface's version, and bind it (:func:`bind`)."""
    lib = ctypes.CDLL(str(path))
    version = lib.art_abi_version() if hasattr(lib, "art_abi_version") else None
    if version != ABI_VERSION:
        raise RuntimeError(f"{path}: C interface version {version}: this checkout takes "
                           f"version {ABI_VERSION} only")
    return bind(lib)


def bind(lib) -> ctypes.CDLL:
    """Bind the entry points of C interface version 7 (K1, K1i, K2, K3/K4,
    K5, K6, K7 and K8) to a loaded library and check its record sizes
    against the numpy records. The gather probes are bound by
    ``utils/gather_probe.py``, the cost probes by ``utils/cost_probe.py``."""
    from .fused_scan import N_AUX
    from .fused_trace import CHAIN_T, DETECTOR_T, IMAGE_T, SOURCE_T

    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in ("art_chain_params_size", "art_source_params_size",
                 "art_detector_params_size", "art_image_params_size"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_size_t
    for name in ("art_abi_version", "art_moment_rays_per_block",
                 "art_source_moments_rays_per_block", "art_source_stats_rays_per_block",
                 "art_source_image_rays_per_block", "art_stats_primal_rays_per_block",
                 "art_scan_aux_size", "art_tangent_batch"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ci
    lib.art_error_string.argtypes = [ci]
    lib.art_error_string.restype = ctypes.c_char_p
    lib.art_launch_fused_source_trace.argtypes = [
        vp, vp, ci, cf, cf, vp, vp, vp, vp, vp, vp, vp]
    lib.art_launch_fused_source_trace.restype = ci
    lib.art_launch_fused_source_image.argtypes = [
        vp, vp, vp, ci, ci, ci, ci, vp, vp, vp, ci, ci, vp, vp, vp, vp]
    lib.art_launch_fused_source_image.restype = ci
    lib.art_launch_fused_source_moments.argtypes = [
        vp, vp, vp, ci, ci, ci, ci, vp, vp, vp]
    lib.art_launch_fused_source_moments.restype = ci
    lib.art_launch_scan_moments.argtypes = [vp, vp, ci, ci, ci, ci, vp, vp, vp, vp]
    lib.art_launch_scan_moments.restype = ci
    lib.art_launch_streamed_trace.argtypes = [vp, ci, ci] + [vp] * 13
    lib.art_launch_streamed_trace.restype = ci
    lib.art_launch_fused_source_stats.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp, vp, ci, vp, vp]
    lib.art_launch_fused_source_stats.restype = ci
    lib.art_launch_stats_params.argtypes = [vp, vp, cf, ci, ci, ci, ci, ci, vp, ci, vp, vp, vp, vp]
    lib.art_launch_stats_params.restype = ci
    lib.art_launch_stats_primal.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp, vp, vp]
    lib.art_launch_stats_primal.restype = ci
    for name, size in (("art_chain_params_size", CHAIN_T.itemsize),
                       ("art_source_params_size", SOURCE_T.itemsize),
                       ("art_detector_params_size", DETECTOR_T.itemsize),
                       ("art_image_params_size", IMAGE_T.itemsize)):
        got = getattr(lib, name)()
        if got != size:
            raise RuntimeError(f"{name}: C struct is {got} B, numpy record is "
                               f"{size} B — layouts disagree")
    if lib.art_scan_aux_size() != N_AUX:
        raise RuntimeError(f"scan kernel takes {lib.art_scan_aux_size()} aux scalars, "
                           f"ops/fused_scan.py packs {N_AUX}")
    return lib


def _check(lib, status: int, what: str):
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} "
                           f"({lib.art_error_string(status).decode()})")


def _record_ptr(rec: np.ndarray) -> int:
    if not rec.flags.c_contiguous:
        raise ValueError("kernel records must be contiguous")
    return rec.ctypes.data


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _check_grids(grids, like):
    """The packed grid rows a record points into (``ops/fused_trace.
    launch_grids``): contiguous float32 (n, 4) on the device of the tensor
    ``like``. The caller holds them for as long as the launch may run."""
    import torch

    for rows in grids:
        if (rows.device != like.device or rows.dtype != torch.float32 or rows.ndim != 2
                or rows.shape[1] != 4 or not rows.is_contiguous()):
            raise ValueError(f"grid rows must be contiguous float32 (n, 4) on {like.device}, got "
                             f"{rows.dtype} {tuple(rows.shape)} on {rows.device}")


def moment_rays_per_block() -> int:
    """Rays per block of the runtime-pose kernels K5 and K6."""
    return library().art_moment_rays_per_block()


def stats_primal_rays_per_block() -> int:
    """Rays per block of K7."""
    return library().art_stats_primal_rays_per_block()


def source_moments_rays_per_block() -> int:
    """Rays per block of K2."""
    return library().art_source_moments_rays_per_block()


def source_stats_rays_per_block() -> int:
    """Rays per block of K8 (each traced once, kept in shared memory for
    every distance)."""
    return library().art_source_stats_rays_per_block()


def source_image_rays_per_block() -> int:
    """Rays per block of K1i."""
    return library().art_source_image_rays_per_block()


def tangent_batch() -> int:
    """G: the tangent rows each K6 block carries (a group of the step's rows)."""
    return library().art_tangent_batch()


def launch_fused_source_trace(chain_rec, src_rec, n_rays, phase, k_frac,
                              p, d, opl, opl_c, alive, inc, stream, grids=()):
    """``grids``: the packed rows ``chain_rec`` points into (every launch
    function below takes them so)."""
    _check_grids(grids, p)
    lib = library()
    status = lib.art_launch_fused_source_trace(
        _record_ptr(chain_rec), _record_ptr(src_rec), int(n_rays), phase, k_frac,
        p.data_ptr(), d.data_ptr(), opl.data_ptr(), opl_c.data_ptr(),
        alive.data_ptr(), inc.data_ptr(), stream)
    _check(lib, status, "fused_source_trace launch")


def launch_fused_source_moments(chain_rec, src_rec, det_rec, n_rays, chunk, grid,
                                chunk_params, rows, stream, grids=()):
    """``grid``: (blocks_per_chunk, n_blocks) of :func:`.fused_trace.ray_grid`."""
    _check_grids(grids, rows)
    lib = library()
    status = lib.art_launch_fused_source_moments(
        _record_ptr(chain_rec), _record_ptr(src_rec), _record_ptr(det_rec),
        int(n_rays), int(chunk), int(grid[0]), int(grid[1]), chunk_params.data_ptr(),
        rows.data_ptr(), stream)
    _check(lib, status, "fused_source_moments launch")


def launch_fused_source_image(chain_rec, src_rec, image_rec, n_rays, chunk, grid, chunk_params,
                              images, record, stream, grids=()):
    """``grid``: (blocks_per_chunk, n_blocks) of :func:`.fused_trace.ray_grid`;
    ``images``: the flat float64 weight and weight x delay images, added
    into; ``record``: None, or (first chunk, chunks, flat, weight, delay) of
    :class:`.fused_trace.ImageRecord`."""
    _check_grids(grids, images[0])
    first, n_rec, flat, w, delay = record if record is not None else (0, 0, None, None, None)
    lib = library()
    status = lib.art_launch_fused_source_image(
        _record_ptr(chain_rec), _record_ptr(src_rec), _record_ptr(image_rec), int(n_rays),
        int(chunk), int(grid[0]), int(grid[1]), chunk_params.data_ptr(), images[0].data_ptr(),
        images[1].data_ptr(), int(first), int(n_rec), _ptr(flat), _ptr(w), _ptr(delay), stream)
    _check(lib, status, "fused_source_image launch")


def launch_scan_moments(chain_rec, src_rec, n_rays, chunk, grid, svec, aux, rows, stream,
                        grids=()):
    """``grid``: (blocks_per_chunk, n_blocks) of :func:`.fused_trace.ray_grid`."""
    _check_grids(grids, rows)
    lib = library()
    status = lib.art_launch_scan_moments(
        _record_ptr(chain_rec), _record_ptr(src_rec), int(n_rays), int(chunk), int(grid[0]),
        int(grid[1]), svec.data_ptr(), aux.data_ptr(), rows.data_ptr(), stream)
    _check(lib, status, "scan_moments launch")


def launch_streamed_trace(chain_rec, n_rays, fresh, inputs, outputs, stream, grids=()):
    """``inputs``: (p, d, opl, opl_c, alive, incidence), the last four None
    when ``fresh``; ``outputs``: (p, d, opl, opl_c, alive, incidence)."""
    _check_grids(grids, outputs[0])
    lib = library()
    status = lib.art_launch_streamed_trace(
        _record_ptr(chain_rec), int(n_rays), int(bool(fresh)),
        *(_ptr(t) for t in inputs), *(t.data_ptr() for t in outputs), stream)
    _check(lib, status, "streamed_trace launch")


def launch_fused_source_stats(chain_rec, src_rec, det_rec, n_rays, chunk, grid, chunk_params,
                              dist_params, n_dist, rows, stream, grids=()):
    """``grid``: (blocks_per_chunk, n_blocks) of :func:`.fused_trace.ray_grid`;
    ``rows``: (n_blocks, n_dist, 7) float64."""
    _check_grids(grids, rows)
    lib = library()
    status = lib.art_launch_fused_source_stats(
        _record_ptr(chain_rec), _record_ptr(src_rec), _record_ptr(det_rec), int(n_rays),
        int(chunk), int(grid[0]), int(grid[1]), chunk_params.data_ptr(), dist_params.data_ptr(),
        int(n_dist), rows.data_ptr(), stream)
    _check(lib, status, "fused_source_stats launch")


def launch_stats_params(chain_rec, src_rec, opl_ref, n_rays, chunk, grid, n_scal, svec,
                        stangents, chunk_params, rows, stream, grids=()):
    """K6: ``stangents`` the step's (P, n_scal) tangent rows on the device,
    P > 0; ``grid``: (blocks_per_chunk, n_blocks) of
    :func:`.fused_trace.ray_grid`."""
    _check_grids(grids, rows)
    lib = library()
    status = lib.art_launch_stats_params(
        _record_ptr(chain_rec), _record_ptr(src_rec), float(opl_ref), int(n_rays), int(chunk),
        int(grid[0]), int(grid[1]), int(n_scal), svec.data_ptr(), int(stangents.shape[0]),
        stangents.data_ptr(), chunk_params.data_ptr(), rows.data_ptr(), stream)
    _check(lib, status, "stats_params launch")


def launch_stats_primal(chain_rec, src_rec, det_rec, n_rays, chunk, grid, chunk_params, rows,
                        stream, grids=()):
    """K7: the chain record carries the pose (:func:`.fused_grad.
    pack_primal_records`); ``grid``: (blocks_per_chunk, n_blocks) of
    :func:`.fused_trace.ray_grid`; ``rows``: (n_blocks, 7) float64."""
    _check_grids(grids, rows)
    lib = library()
    status = lib.art_launch_stats_primal(
        _record_ptr(chain_rec), _record_ptr(src_rec), _record_ptr(det_rec), int(n_rays), int(chunk),
        int(grid[0]), int(grid[1]), chunk_params.data_ptr(), rows.data_ptr(), stream)
    _check(lib, status, "stats_primal launch")
