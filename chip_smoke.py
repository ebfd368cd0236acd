#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the CUDA kernels from ``csrc/``,
holds each kernel against its plain PyTorch version on the card (every
surface and all four source kinds the fused engines synthesize), drives the
port's paths through the entry points a user calls, and checks the results:

* the main path: ``main.main`` on the flagship chain at 1e7 rays with the
  detector-distance optimizer (kernels K1, K2);
* the plots path: ``main.make_plots``' dispatch (``main._plot_calls``) on
  the main path's flagship with matplotlib hidden: ``main.main`` with spot
  and delay plot options (one stderr line, nothing drawn), then the
  dispatch's data: the giga-ray images at 1e9 rays (one K1i launch) and the
  incidence image of the K1 bundle, held against a direct
  ``fused_source_images`` call and against the same data functions on the
  CPU, and the traced-history plots (``MirrorProjection``,
  ``RayRenderGraph``) at 1e6 rays, card against CPU;
* the parameter scan: ``run_config_file`` on
  ``examples/CONFIG_2toroidals_f-x-f.py`` at 2.5e6 rays (11 chains, kernel K5),
  against the serial K1 + K2 path;
* user-built bundles: ``main.main`` on ``examples/CONFIG_toroidal2f-2f_byhand.py``
  with a 1e7-ray PointSource (kernel K4) and on a traced bundle fed through a
  second chain (kernel K3), against the plain streamed trace; K3 and K4 on
  a shuffled copy of their bundles (equal to the ordered run permuted, bit
  for bit), K3 on a bundle dead on entry (returned as read), and both on
  stream views off the 16-byte boundary with a tail past the last whole
  warp of rays, on the flagship and both deformed flagships;
* alignment by gradient descent: ``gradient_align`` on the flagship at 1e7
  rays through the fused gradient engine (kernel K6), against the autograd
  engine on the card, and ``fused_focus_loss`` (kernel K7, one launch, held
  against the loss of its plain version's sums);
* the per-distance stats baseline (kernel K8) at 1, 8, 9, 20 and 128
  distances, and at 20 against K2's moments;
* Zernike surface defects: ``main.main`` on the deformed flagship (its first
  toroid a ``DeformedMirror`` with four Zernike terms) at 1e7 rays through
  K1 and K2, and every kernel K1-K8 held against its plain version on the
  deformed chain (K1, K2 and K6 with ``ignore_defects`` True and False), with
  each kernel's deformed-chain time beside its undeformed time, and
  ``gradient_align`` on the deformed flagship at 1e7 rays (12 Adam steps,
  12 K6 launches);
* grid defect maps: the same on the grid flagship (its first toroid a
  ``DeformedMirror`` with a 1 nm Fourier-PSD map of 3000 x 640 nodes), and
  ``examples/CONFIG_deformed.py`` at ``--rays 1e7`` through the port's CLI
  (one K1 launch, its 8000 x 8000 map packed in HBM) against the plain trace
  of the same loaded chain on the card;
* the gather probes P4 and P5 (``utils/gather_probe.py``) against their
  plain versions at the script's shapes, and the trace's lookup timed on
  three maps in two point orders;
* giga-ray images (``analysis/gigascan.py``): ``fused_source_images`` on the
  flagship with its second toroid rolled 0.05 deg at 1e9 rays into 512 x 512
  pixels (exactly one launch of the image kernel K1i for its 120 chunks of
  2^23 rays), K1i's launch alone, the setup and the copy to the host, its
  plain version on the same image held against it, and the chunk loop it
  replaced (K1 per chunk, plain binning) on the same image; K1i vs plain at
  1e8 rays ray by ray (its per-ray record) and image by image, and vs the
  K1 loop; the 1e7-ray image against
  ``Detector.get_Image`` / ``get_DelayMap`` of the K1 bundle of the same
  spiral; K1i vs plain on the grid flagship (slopes in the normals) and on
  an extended source;
* the cost probes P1-P3 (``utils/cost_probe.py``) against their plain
  versions: P1's first launch from a fresh library load, its steady
  launch latency and its launch alone on the card beside ``x + 1``'s, its
  wrapper's host time taken apart, P2's cost per operation of the nine ops slope-timed over
  the op count, P3's copy floor against K4 on four subsets of the flagship;
* batched scans (``main._batched_final_bundles``): ``main.main`` on
  ``examples/CONFIG_2toroidals_f-x-f.py`` and ``examples/CONFIG_tolerancing.py``
  at their own 1000 rays and at 150,000 (just under ``PALLAS_MIN_RAYS``):
  every chain through the stacked plain trace, against the serial path
  (``ART_TPU_SCAN_STACK_MAX_BYTES=0``);
* the shard mesh (``parallel/mesh.py``): on the flagship at 1e7 rays, a
  mesh of 4 shards on the one card, ``source_stats_sharded`` (K2 per shard),
  ``scan_moments_sharded`` (K5), ``fused_focus_value_and_grad(mesh=)`` (K6),
  ``source_images_sharded`` at 2^30 rays into 512 x 512 (K1i),
  ``trace_sharded`` and ``trace_scan_sharded`` against their unsharded
  calls; then the same passes in 2 spawned processes on gloo, one shard
  each on the card (the scan engine's mesh from the process group,
  ``ART_TPU_SCAN_MESH=1``), against the one-process 2-shard mesh;
* the CLI path on ``examples/CONFIG_singleparabola.py``,
  ``examples/CONFIG_gradient_alignment.py`` (a CONFIG that aligns its chain
  while it loads) and ``examples/CONFIG_deformed.py`` at its 1000 rays (the
  plain trace, below ``PALLAS_MIN_RAYS``).

Each path runs with the launch counts set to 0 just before it and read just
after. It exits nonzero, printing no result, when there is no CUDA card,
when the package is missing beside it, or when any phase fails.

Output: the card's name and power limit, per-phase lines, then one JSON line
with each kernel's launches on its path, its error against the plain
version, its time, the plain version's time and its bound, and as the last
line ``{"ok": true, "device": {...}}``. A kernel's ``ms`` is its launch alone
(records packed, inputs copied and outputs allocated beforehand),
``plain_ms`` the plain version's whole call; both are medians of 5
CUDA-event windows of 5 back-to-back calls each (the plain versions of K6,
K7 and K8: 3 windows of one call), at 1e7 rays: K1, K2, K5, K6, K7 and K8
(at 20 distances) on the flagship, K4 and K3 on their own paths' chains
and bundles (and on the flagship's bundle in its spiral order and
shuffled: ``flagship_ms``, ``flagship_shuffled_ms``; the deformed phases'
``<kind>_shuffled_ms``). The entries of K2, K5, K6 and K1i also carry ``mesh``: their
launches per sharded call (one per shard), the sharded and unsharded calls'
walls, the largest difference from the unsharded result and from the
one-process mesh in the two-process run. The entries of K1, K2 and K1i
also carry ``plots``: their launches on the plots path, its ``main.main``
wall, each plot's dispatch wall and the bytes its data brought to the
host.
``bound_ms`` is the larger of the bytes the kernel must move over 3.35 TB/s
and its float32 operations over 67 TFLOP/s (H100 SXM data sheet), counted
for the same inputs; the summing kernels' operations (K1i, K2, K5, K7, K8)
are counted where the rays die: the source for every ray, each element's
step for the rays alive entering it, the epilogue for the rays alive at the
end (a warp whose rays all died leaves the chain). K7's entry also carries
``stages``: its launch alone on prefixes of the flagship chain (the mask;
the mask and the first toroid; the whole chain), the rays and warps alive
at each stage, each stage's time and operations, and its SASS by stage with
the issue-slot and per-pipe bounds of each prefix (utils/kernel_ab.py).
Each entry also carries the phase zernike's numbers:
``zernike_ms`` (the launch alone on the deformed flagship at 1e7 rays),
``zernike_flat_ms`` (the undeformed flagship's, timed beside it),
``zernike_bound_ms`` and ``zernike_bound_by``, and the phase grid's
(``grid_ms``, ``grid_flat_ms``, ``grid_bound_ms``, ``grid_bound_by``: the
grid flagship's; its bytes add the smaller of the map's packed bytes and
four 32-byte sectors per ray and lookup); K6's, per deformed flagship, also
its ``gradient_align`` run (``zernike_grad_align``: launches, ms per step,
first and last loss), the defects' share of its rows against the plain
version's (``zernike_effect``: per chain and difference, the largest gap,
the statistics moved and the largest difference), ptxas's registers, stack
frame and spill bytes of its instantiation, its SASS's local-memory
operations by stage and its issue-slot bound (``zernike_local_memory``,
``zernike_issue_ms``), and the same ``grid_...`` fields; K1's also ``config_deformed_ms``
and ``config_deformed_flat_ms`` (its launch on examples/CONFIG_deformed.py's
chain at 1e7 rays with and without the map). The entries P4 and P5 follow:
their launches in the probe's run, the largest error against the plain
version, the bilinear form's (P4) and the largest case's (P5) launch, and
P4's ``lookup``: the trace's lookup over 1e7 points of each map and point
order, with the sectors per point its time gives at the HBM rate. K1i's
entry is the 1e9-ray image's: its launch alone, the plain version's one
call, the bound counted where the image's rays die (the source for every
ray, each element for the rays alive past its masks, the epilogue for the
rays alive at the end), and ``images`` (the wall,
rays/s, setup, copy, the K1 loop's wall, the comparisons); K1's entry
carries the K1 loop's launches and wall on the same image (``images``). The entries P1-P3
follow: their launches in the probes' run, the largest error against the
plain version, the launch alone (P1 on its tile, P2 fma at 40 ops over
(78336, 128), P3 over 1e7 rays), P1's first-launch seconds and
``split_us`` (cost_probe.add_one_split), P2's
slope-timed ``ops``, P3's K4 subsets and K4's compute share. P1, P2, P4 and
P5 (and each P4 form and P5 case) also carry ``device_ms``, the launch alone
on the card with the host's work hidden (utils/cost_probe.queued_us).
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_CHECK = 1 << 20        # rays per kernel-vs-plain comparison
N_TIME = 10_000_000      # rays per timed call (the main path's size)
N_SLICE = 10_000_000     # rays of the main-path run
N_SCAN = 2_500_000       # rays per chain of the scan run
N_STREAMED = 10_000_000  # rays of the user-built bundles
N_CLI = 1_000_000        # rays of the CLI run
N_GRAD = 10_000_000      # rays of the gradient-descent run
N_PLOTS_HISTORY = 1_000_000  # rays of the plots path's traced-history plots
GRAD_ITERS = 12          # Adam steps of the gradient-descent run
N_GRAD_CHECK = 1 << 18   # rays of the fused-vs-autograd gradient check
CSRC = "attosecondraytracing_tpu_torch/csrc/"

#: H100 SXM data sheet: HBM rate and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: float32 operations per ray of the device code (csrc/trace_common.cuh),
#: counted from the source for the parts the timed (flagship) chains use:
#: add, subtract, multiply 1 each, a fused multiply-add 2, a divide, square
#: root, reciprocal square root, exp or arccos 1 each; comparisons and
#: selects 0
OPS = {
    "cone_source": 55,   # base-256 golden angle, sin/cos polynomials, radius law, direction
    "affine": 33,        # the composed map of a step or a folded mask
    "premask": 15,       # a folded mask's plane crossing and round-hole test
    "mask": 19,          # an unfolded mask step (K5)
    "toroid": 121,       # seed, one Newton step, validity, normal, reflection, Kahan OPL
    "store": 34,         # the to-lab map of p and d, the incidence arccos
    "weight": 2,         # exp(ln edge * rr)
    # K1i's epilogue of an alive ray (csrc/fused_trace.cu image_pixel): the
    # to-lab map 33, the plane crossing 14, the point and in-plane
    # coordinates 19, the Kahan step and delay 7, the bin coordinates 4, the
    # weight x delay 1 (the two float64 atomic adds resolve in L2)
    "image": 78,
    "moments": 78,       # the 16 moment terms of an alive ray
    "stats": 58,         # the 7 stats terms at one distance of an alive ray, accumulated
    # K8's stats epilogue of an alive ray: the distance-independent geometry
    # (once per ray, like the trace, whatever the kernel's tiling of the
    # distances) and each distance's 7 terms, accumulated
    "stats_geometry": 40,
    "stats_distance": 21,
    # K6 on the flagship chain (mask and two toroids, unfolded), per ray:
    # what its Dual<G> operators add to the primal trace, once (the
    # reciprocals the tangents share) and per tangent; and per alive ray for
    # the stats epilogue with its accumulation. A dual a*b adds 3 per
    # tangent (a multiply and a fused multiply-add), a*c with c a float 1,
    # a/b 3, a +- b 1, a +- c 0, sqrt and rsqrt 1; selects 0. The bound of
    # a gradient step counts the primal and these once-per-ray factors once
    # and the per-tangent parts once per tangent row, whatever the kernel's
    # grouping G retraces
    "dual_trace_once": 23,
    "dual_trace_tangent": 658,
    "dual_stats_once": 1,
    "dual_stats_tangent": 106,
    # a mirror with Zernike defects (trace_common.cuh deformed_hit, on a
    # toroid): the two surface normals, the normalized coordinates, cos
    # alpha, the shifted t and point, rows 0-1 of the values ("shift"); each
    # further (n, m) term of the values pass, its row entry and the sum
    # ("term"); with ignore_defects False each term of the slopes pass and
    # the composed normal ("slope_term", "compose"). On Dual<G> (K6's
    # zernike_height for Dual<G>, ignore_defects True): the recurrence runs on
    # the primal with slopes, once per ray, so each term adds its slope
    # rows and sums ("dual_zernike_gradient_term"), and once the gradient's
    # scaling and the reciprocals the tangents share ("once"); per tangent
    # the shift's linear parts (the normals, cos alpha, t and the point)
    # and the height's tangent composed at the hit, h_x t(x) + h_y t(y)
    "zernike_shift": 55,
    "zernike_term": 9,
    "zernike_slope_term": 19,
    "zernike_compose": 22,
    "dual_zernike_once": 14,
    "dual_zernike_gradient_term": 10,
    "dual_zernike_shift_tangent": 112,
    # a mirror with one grid map (trace_common.cuh deformed_hit and
    # grid_sums, on a toroid): the two surface normals, cos alpha, the
    # shifted t and point, the support coordinates and the height lookup
    # (fractional indices by IEEE divide, weights, 4 corners, the sum:
    # "grid_shift"); with ignore_defects False the slope lookup (two more
    # channels) and the composed normal ("grid_slopes"). On Dual<G> (K6's
    # grid_height for Dual<G>): once the reciprocals the tangents share and
    # the lookup's two cell derivatives (grid_cell), and per tangent the
    # shift's linear parts and the height's tangent composed at the hit,
    # added to the height's zero start
    "grid_shift": 69,
    "grid_slopes": 48,
    "dual_grid_once": 30,
    "dual_grid_shift_tangent": 111,
}

#: the Zernike defects of the deformed flagship's first toroid (the phase's
#: chain: astigmatism, coma, a 4th- and a 6th-order term, in mm)
ZERNIKE = {(2, 0): 2e-4, (3, 1): -1e-4, (4, 2): 5e-5, (6, 3): 2e-5}
#: the grid flagship's first toroid: a Fourier-PSD map over its 150 x 32 mm
#: support, RMS 1 nm, wavelengths down to 0.1 mm (3000 x 640 nodes, 31 MB
#: packed: it sits in the card's 50 MB L2)
GRID = {"RMS": 1e-6, "smallest": 0.1, "seed": 7}
#: the same map at 100 nm RMS, for the check that the kernels carry the map's
#: slopes into the spot: the 1 nm map's slopes (up to ~2e-6 rad) move the
#: spot SD by less than the kernels' float32 error of it
GRID_EFFECT_RMS = 1e-4
#: the defects of K6's effect check (_k6_effect): the Zernike terms 100
#: times ZERNIKE's (20 um of astigmatism), and a Fourier-PSD map of 1 um RMS
#: down to 1 mm wavelengths (the slopes of the 100 nm map, ten times its
#: heights: at 100 nm a height's share of the rows with ignore_defects True
#: does not stand clear of K6's float32 error of them); PERF.md §6 PR 13
ZERNIKE_K6_EFFECT = {key: 100 * c for key, c in ZERNIKE.items()}
GRID_K6_EFFECT = {"RMS": 1e-3, "smallest": 1.0, "seed": 7}
#: the bound on K6's difference of rows against the plain version's,
#: relative to the plain version's largest, per statistic (_k6_effect): on
#: an H100 the shipped K6 reads at most 0.0107, a K6 with the Hessian's
#: tangent rows zeroed 0.355, its grid cell derivatives zeroed 1.08, its
#: Zernike height's gradient zeroed 0.544 (PERF.md §6 PR 13)
K6_EFFECT_REL = 0.05
#: rays of examples/CONFIG_deformed.py through the CLI (its map: 8000 x 8000
#: nodes, 1 GB packed, in HBM)
N_CONFIG_DEFORMED = 10_000_000
#: the giga-ray images (analysis/gigascan.py): rays of the full-width image
#: (chunks of 2^23 rays, one K1 launch each), of the kernel-vs-plain images,
#: and of the image held against the bundle path; the images' pixels; the
#: roll [deg] of the flagship's second toroid (examples/gigaray_delay_map.py)
N_IMAGE = 1_000_000_000
N_IMAGE_CHECK = 100_000_000
N_IMAGE_BUNDLE = 10_000_000
IMAGE_BINS = (512, 512)
IMAGE_ROLL = 0.05
#: the image size and ray count of tests/test_gigascan.py's image
#: comparisons: the kernel-vs-plain images' mean delays are held on blocks of
#: this size holding more than 5 weight per PRECEDENT_RAYS rays, the JAX
#: tests' share (as tests/test_torch_gigascan.py's MIN_WEIGHT scales it)
PRECEDENT_BINS = (64, 64)
PRECEDENT_RAYS = 16384
#: the plots path's options (main.make_plots / main._plot_calls): the spot
#: and delay plots of the flagship, images from 200,000 rays ("auto"), and
#: the intensity and delay images from 1e9 rays in the image kernel
PLOT_OPTIONS = {"plot_SpotDiagram": True, "plot_DelaySpotDiagram": True,
                "plot_IncidenceSpotDiagram": True, "plot_DelayGraph": True,
                "plot_IntensityGraph": True, "image_plots": "auto", "image_bins": 256,
                "image_rays": 1e9}


def _fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _check(cond, msg):
    if not cond:
        _fail(msg)


def _time_ms(fn, torch, reps=5, inner=5):
    """Per-call time [ms] of ``fn``, after a warm-up: the median over
    ``reps`` CUDA-event windows, each around ``inner`` back-to-back calls (so
    the card's queue stays full and a call's host latency hides behind the
    one before)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return sorted(times)[len(times) // 2]


def _bound(n_bytes, n_ops):
    """{"bound_ms", "bound_by"}: the larger of the memory and the
    arithmetic time of the work at the data sheet's peak rates."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _zernike_terms(el) -> int:
    """(n, m) terms with n >= 2 of a deformed mirror's recurrence: every row
    up to the highest order of its defects (the kernel's table order)."""
    order = max([2] + [n for d in el.defects for (n, _m) in d.coeffs])
    return sum(n + 1 for n in range(2, order + 1))


def _defect_kind(el) -> str | None:
    """"zernike" or "grid" for a mirror with Zernike defects or one grid
    map (what the operation counts cover), None without defects."""
    from attosecondraytracing_tpu_torch.ops.defects import GridDefect, ZernikeDefect

    defects = getattr(el, "defects", ())
    if not defects:
        return None
    if all(isinstance(d, ZernikeDefect) for d in defects):
        return "zernike"
    _check(len(defects) == 1 and isinstance(defects[0], GridDefect),
           "operation counts cover Zernike defects or one grid map per mirror")
    return "grid"


def _stage_ops(table, ignore_defects: bool = True) -> list:
    """Per element of a chain table whose mirrors are toroids (the
    flagship's), the per-ray operations of its folded masks' tests and of
    its step (the affine map, the mask or toroid, with the Zernike or grid
    branch of a deformed mirror): ``[(premask ops, step ops), ...]``."""
    from attosecondraytracing_tpu_torch.ops import surfaces as srf
    from attosecondraytracing_tpu_torch.ops.trace import MaskElement

    stages = []
    for el, pre in zip(table.elements, table.premasks):
        ops = OPS["affine"]
        if isinstance(el, MaskElement):
            ops += OPS["mask"]
        else:
            _check(isinstance(el.surface, srf.Toroid), "operation counts cover toroids only")
            ops += OPS["toroid"]
            kind = _defect_kind(el)
            if kind == "zernike":
                terms = _zernike_terms(el)
                ops += OPS["zernike_shift"] + terms * OPS["zernike_term"]
                if not ignore_defects:
                    ops += terms * OPS["zernike_slope_term"] + OPS["zernike_compose"]
            elif kind == "grid":
                ops += OPS["grid_shift"] + (0 if ignore_defects else OPS["grid_slopes"])
        stages.append((len(pre) * (OPS["affine"] + OPS["premask"]), ops))
    return stages


def _trace_ops(table, source: bool, ignore_defects: bool = True) -> int:
    """Per-ray operations of the source (if synthesized) and the whole
    chain walk (:func:`_stage_ops`)."""
    return (OPS["cone_source"] if source else 0) + sum(a + b for a, b in _stage_ops(table, ignore_defects))


def _ops_where_rays_die(table, alive, end_ops: int, ignore_defects: bool = True) -> int:
    """A fused-source kernel's operations on one launch's rays, counted
    where the rays die (``alive`` from utils/kernel_ab.alive_by_stage): the source
    for every ray, an element's folded masks' tests for the rays entering
    it and its step (an unfolded mask's too) for those past its masks, and
    ``end_ops`` (the weight and the epilogue) for the rays alive at the
    end. A warp whose rays are all dead leaves the chain, so the kernel's
    work follows these counts."""
    ops = OPS["cone_source"] * alive[0] + end_ops * alive[-1]
    for i, (pre, step) in enumerate(_stage_ops(table, ignore_defects)):
        ops += pre * alive[2 * i] + step * alive[2 * i + 1]
    return ops


def _dual_defect_ops(elements, n_tangents: int) -> int:
    """Per-ray operations the defect branch adds on Dual<G> (K6) for a
    gradient step of ``n_tangents`` rows, ignore_defects True: once, and
    its linear parts per tangent."""
    ops = 0
    for el in elements:
        kind = _defect_kind(el)
        if kind == "zernike":
            ops += (OPS["dual_zernike_once"] + _zernike_terms(el) * OPS["dual_zernike_gradient_term"]
                    + n_tangents * OPS["dual_zernike_shift_tangent"])
        elif kind == "grid":
            ops += OPS["dual_grid_once"] + n_tangents * OPS["dual_grid_shift_tangent"]
    return ops


def _flagship(n_rays):
    """Round-hole mask + two grazing toroids in f-d-f (the JAX package's
    flagship, __graft_entry__._flagship_chain)."""
    from attosecondraytracing_tpu_torch.models import masks, mirrors, supports
    from attosecondraytracing_tpu_torch.models.placement import OEPlacement

    R, r = mirrors.ReturnOptimalToroidalRadii(500.0, 80.0)
    tor = mirrors.MirrorToroidal(R, r, supports.SupportRectangle(150, 32))
    mask = masks.Mask(supports.SupportRoundHole(Radius=20, RadiusHole=7, CenterHoleX=0, CenterHoleY=0))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6, "DeltaFT": 0.5,
             "NumberRays": n_rays}
    chain = OEPlacement(props, [mask, tor, tor], [400.0, 100.0, 500.0], [0.0, 80.0, -80.0],
                        [0.0, 0.0, 0.0], "flagship: mask + 2 toroidals f-d-f")
    return chain, props


def _deformed_flagship(n_rays, second_distance=500.0, kind="zernike", zernike=ZERNIKE, grid=GRID):
    """The flagship with its first toroid carrying the Zernike defects
    ``zernike`` (``kind`` "zernike"), the Fourier-PSD map ``grid`` ("grid")
    or both ("mixed") over its support; ``second_distance`` places the
    second toroid (a list: one chain per value)."""
    from attosecondraytracing_tpu_torch.models import defects, masks, mirrors, supports
    from attosecondraytracing_tpu_torch.models.placement import OEPlacement

    R, r = mirrors.ReturnOptimalToroidalRadii(500.0, 80.0)
    tor = mirrors.MirrorToroidal(R, r, supports.SupportRectangle(150, 32))
    support = supports.SupportRectangle(150, 32)
    deformed = mirrors.DeformedMirror(
        tor, ([defects.Zernike(support, zernike)] if kind in ("zernike", "mixed") else [])
        + ([defects.Fourrier(support, **grid)] if kind in ("grid", "mixed") else []))
    mask = masks.Mask(supports.SupportRoundHole(Radius=20, RadiusHole=7, CenterHoleX=0, CenterHoleY=0))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6, "DeltaFT": 0.5,
             "NumberRays": n_rays}
    chain = OEPlacement(props, [mask, deformed, tor], [400.0, 100.0, second_distance],
                        [0.0, 80.0, -80.0], [0.0, 0.0, 0.0],
                        f"deformed flagship: mask + {kind}-deformed toroidal + toroidal f-d-f")
    return chain, props


def _single_parabola(n_rays):
    """examples/CONFIG_singleparabola.py's chain (plane-wave disk source)."""
    import numpy as np

    from attosecondraytracing_tpu_torch.models import mirrors, supports
    from attosecondraytracing_tpu_torch.models.placement import OEPlacement

    par = mirrors.MirrorParabolic(100, 90, supports.SupportRoundHole(30, 5, 10, 5))
    props = {"Divergence": 0, "SourceSize": 50, "Wavelength": 800e-6, "DeltaFT": 2.7,
             "NumberRays": n_rays}
    chain = OEPlacement(props, [par], [200], [0.00])
    chain.optical_elements[0].rotate_roll_by(np.rad2deg(50e-6))
    return chain


def _extended(n_rays):
    """The flagship's optics behind an extended source: a Vogel grid of
    point sources over a 0.4 mm disk, each a 10 mrad cone."""
    from attosecondraytracing_tpu_torch.models import masks, mirrors, supports
    from attosecondraytracing_tpu_torch.models.placement import OEPlacement

    R, r = mirrors.ReturnOptimalToroidalRadii(500.0, 80.0)
    tor = mirrors.MirrorToroidal(R, r, supports.SupportRectangle(150, 32))
    mask = masks.Mask(supports.SupportRoundHole(Radius=20, RadiusHole=3, CenterHoleX=0, CenterHoleY=0))
    props = {"Divergence": 10e-3, "SourceSize": 0.4, "Wavelength": 80e-6, "NumberRays": n_rays}
    return OEPlacement(props, [mask, tor, tor], [400.0, 100.0, 500.0], [0.0, 80.0, -80.0], [0.0, 0.0, 0.0])


def _square(n_rays):
    """The single parabola lit by a collimated 40 mm square grid."""
    import numpy as np

    from attosecondraytracing_tpu_torch.models import sources
    from attosecondraytracing_tpu_torch.models.chain import OpticalChain

    bundle, spec = sources.PlaneWaveSquareFused(np.zeros(3), np.array([1.0, 0.0, 0.0]), 40.0, n_rays,
                                                Wavelength=800e-6, gaussian_edge=float(np.exp(-2.0)))
    return OpticalChain(bundle, _single_parabola(16).optical_elements, source_spec=spec)


def _quadrics(n_rays):
    """Convex sphere, holed cylinder and ellipsoid: the kernels' other
    quadric surfaces, with supports that clip."""
    from attosecondraytracing_tpu_torch.models import mirrors, supports
    from attosecondraytracing_tpu_torch.models.placement import OEPlacement

    ell = mirrors.MirrorEllipsoidal(supports.SupportRectangle(80, 30),
                                    *mirrors.ReturnOptimalEllipsoidalAxes(600, 75))
    sph = mirrors.MirrorSpherical(-2000, supports.SupportRound(25))
    cyl = mirrors.MirrorCylindrical(3000, supports.SupportRectangleHole(60, 30, 3, 10, 5))
    props = {"Divergence": 30e-3, "SourceSize": 0, "Wavelength": 50e-6, "NumberRays": n_rays}
    return OEPlacement(props, [sph, cyl, ell], [300, 200, 300], [5.0, 10.0, 75.0], [0, 90, 0])


def _flagship_source(n_rays):
    """The flagship's cone source (25 mrad along +x from the origin)."""
    import numpy as np

    from attosecondraytracing_tpu_torch.ops import fused_trace as ft

    return ft.make_source_spec("cone", np.zeros(3), np.array([1.0, 0.0, 0.0]), 25e-3, n_rays=n_rays)


def _load_config(name):
    """(chains, SourceProperties, DetectorOptions, AnalysisOptions, module)
    of an example CONFIG, run under the port's module names."""
    import importlib.util

    from attosecondraytracing_tpu_torch import main as art

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / name)
    module = importlib.util.module_from_spec(spec)
    with art._config_aliases():
        spec.loader.exec_module(module)
    return (*art.load_config(module), module)


def _reset_launches():
    from attosecondraytracing_tpu_torch.ops import fused_grad as fg
    from attosecondraytracing_tpu_torch.ops import fused_scan as fs
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft

    ft.fused_source_trace.launches = 0
    ft.prepare_fused_source_image.launches = 0
    ft.fused_source_moments.launches = 0
    ft.streamed_trace.launches = 0
    ft.streamed_trace.fresh_launches = 0
    fs.fused_scan_moments.launches = 0
    fg.fused_stats_params.launches = 0
    fg.fused_stats_params.primal_launches = 0
    ft.fused_source_stats.launches = 0


def _launches():
    from attosecondraytracing_tpu_torch.ops import fused_grad as fg
    from attosecondraytracing_tpu_torch.ops import fused_scan as fs
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft

    return {"K1": ft.fused_source_trace.launches, "K1i": ft.prepare_fused_source_image.launches,
            "K2": ft.fused_source_moments.launches,
            "K3": ft.streamed_trace.launches, "K4": ft.streamed_trace.fresh_launches,
            "K5": fs.fused_scan_moments.launches, "K6": fg.fused_stats_params.launches,
            "K7": fg.fused_stats_params.primal_launches, "K8": ft.fused_source_stats.launches}


def _check_bundles(tag, ker, ref, torch):
    """Kernel vs plain outputs: alive masks and the tests/test_pallas.py
    envelopes on rays alive in both. Returns the largest |dp| [mm]."""
    mismatch = float((ker.alive != ref.alive).double().mean())
    both = ker.alive & ref.alive
    dp = (ker.p[both] - ref.p[both]).abs()
    dopl = ((ker.opl - ker.opl_c)[both] - (ref.opl - ref.opl_c)[both]).abs()
    dinc = (ker.incidence[both] - ref.incidence[both]).abs()
    med, mx = float(dp.median()), float(dp.max())
    print(f"{tag}: {int(ker.alive.sum())}/{ker.alive.numel()} alive, alive mismatch {mismatch:.3g}, "
          f"|dp| median {med:.3g} max {mx:.3g} mm, |d opl| max {float(dopl.max()):.3g} mm, "
          f"|d incidence| max {float(dinc.max()):.3g} rad", flush=True)
    _check(int(both.sum()) > 0, f"{tag}: no ray alive")
    _check(mismatch <= 1e-4, f"{tag}: alive masks differ on {mismatch} of rays")
    _check(med <= 1e-3 and mx <= 5e-2, f"{tag}: position envelope {med}/{mx} mm")
    _check(float(dopl.max()) <= 0.1, f"{tag}: optical path differs by {float(dopl.max())} mm")
    _check(float(dinc.max()) <= 1e-4, f"{tag}: incidence differs by {float(dinc.max())} rad")
    return mx


def _check_stats(tag, ker, ref, opl_ref, w_rtol, spot_rtol, dur_rel, dur_abs):
    """Two moment vectors: the sum of weights and the spot and duration SDs
    at 5 distances. Returns the largest spot SD difference [mm]."""
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft

    rel_w = abs(ker[0] - ref[0]) / abs(ref[0])
    distances = (-20.0, -5.0, 0.0, 5.0, 20.0)
    sk = ft.sums_to_stats(ft.moments_to_distance_sums(ker, distances), opl_ref, distances)
    sr = ft.sums_to_stats(ft.moments_to_distance_sums(ref, distances), opl_ref, distances)
    print(f"{tag}: sum w {ker[0]:.9g} vs {ref[0]:.9g} (rel {rel_w:.3g})", flush=True)
    _check(rel_w <= w_rtol, f"{tag}: sum of weights differs by {rel_w} (rel)")
    spot_err = 0.0
    for j, dist in enumerate(distances):
        s_k, s_r = sk["spot_sd"][j], sr["spot_sd"][j]
        d_k, d_r = sk["duration_sd"][j], sr["duration_sd"][j]
        print(f"{tag} d={dist:+.0f} mm: spot {s_k:.6g} vs {s_r:.6g} mm, "
              f"duration {d_k:.6g} vs {d_r:.6g} fs", flush=True)
        _check(abs(s_k - s_r) <= spot_rtol * abs(s_r) + 1e-6, f"{tag}: spot SD at {dist} mm: {s_k} vs {s_r}")
        _check(abs(d_k - d_r) <= dur_rel * d_r or abs(d_k**2 - d_r**2) ** 0.5 <= dur_abs,
               f"{tag}: duration SD at {dist} mm: {d_k} vs {d_r}")
        spot_err = max(spot_err, abs(s_k - s_r))
    return spot_err


def phase_k1(torch, dev):
    """K1 against its plain version on the card, on chains that take every
    surface and source kind of the kernels: alive masks and the
    tests/test_pallas.py envelopes on rays alive in both."""
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft

    errs = {}
    for name, chain in (("flagship", _flagship(N_CHECK)[0]), ("singleparabola", _single_parabola(N_CHECK)),
                        ("quadrics", _quadrics(N_CHECK)), ("extended", _extended(N_CHECK)),
                        ("square", _square(N_CHECK))):
        chain.to(dev)
        spec = chain.source_spec.baked()
        n = chain.source_spec.n_rays
        table = ft.chain_table(spec, chain.device_elements(torch.float64))
        ker = ft.fused_source_trace(table, spec, n, device=dev)
        torch.cuda.synchronize()
        ref = ft.fused_source_trace_ref(table, spec, n, device=dev)
        errs[name] = _check_bundles(f"K1 {name} ({spec.kind} source)", ker, ref, torch)
        if name == "flagship":
            flagship_table = table
    spec = _flagship_source(N_TIME)
    outs, launch = ft.prepare_fused_source_trace(flagship_table, spec, N_TIME, device=dev)
    ms = _time_ms(launch, torch)
    n_alive = int(outs.alive.sum())
    wrapper_ms = _time_ms(lambda: ft.fused_source_trace(flagship_table, spec, N_TIME, device=dev), torch)
    plain_ms = _time_ms(lambda: ft.fused_source_trace_ref(flagship_table, spec, N_TIME, device=dev), torch)
    bound = _bound(37 * N_TIME, (_trace_ops(flagship_table, True) + OPS["store"]) * N_TIME)
    print(f"K1 flagship at {N_TIME} rays: kernel launch {ms:.4f} ms, whole wrapper {wrapper_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}), "
          f"{n_alive} rays alive", flush=True)
    return {"max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms, **bound}


def _k2_setup(torch, dev, chain, n_time):
    """(spec, elements, detector, chief-ray refs, chunks, n) of a chain's
    source at ``n_time`` rays, described without building its bundle, with
    the detector autoplaced 490 mm behind its K1 trace at N_CHECK rays."""
    import numpy as np

    from attosecondraytracing_tpu_torch.models.detector import Detector
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft

    chain.to(dev)
    info = chain.source_spec
    elements = chain.device_elements(torch.float64)
    det = Detector(np.zeros(3))
    det.autoplace(chain.trace_final(engine="fused"), 490.0)
    spec = ft.make_source_spec(info.kind, info.origin, info.axis, info.param,
                               diameter=info.diameter, n_rays=n_time)
    n = spec.n_sources * spec.n_each if info.kind == "extended" else n_time
    refs = ft.chief_ray_refs(spec, elements, det.centre, det.normal, device=dev, dtype=torch.float32)
    chunks = ft.source_chunks(spec.kind, n, n, n_each=spec.n_each, n_sources=spec.n_sources)
    return spec, elements, det, refs, chunks, n


def phase_k2(torch, dev):
    """K2 against its plain version on the card at 1e7 rays, on the flagship
    (cone source, 2 chunks of 2^23 rays) and on an extended source (chunks
    on whole sub-sources): sum of weights and the tests/test_stats_kernel.py
    tolerances on the statistics at 5 distances."""
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft
    from attosecondraytracing_tpu_torch.utils import kernel_ab as ab

    spot_err = 0.0
    for name, chain in (("flagship", _flagship(N_CHECK)[0]), ("extended", _extended(N_CHECK))):
        spec, elements, det, (opl_ref, inv_dn), chunks, n = _k2_setup(torch, dev, chain, N_TIME)
        table = ft.chain_table(spec, elements)
        bdet = ft.bake_detector(elements, det.centre, det.normal, det._plane_rotation(),
                                opl_ref=opl_ref, inv_dn_chief=inv_dn)
        _check(len(chunks) == 2, f"K2 {name}: expected 2 chunks at {n} rays, got {len(chunks)}")
        kw = dict(device=dev, gaussian_edge=chain.source_spec.gaussian_edge, centre_distance=0.0)
        ker = ft.fused_source_moments(table, spec, bdet, chunks, n, **kw)
        ref = ft.fused_source_moments_ref(table, spec, bdet, chunks, n, **kw)
        tag = f"K2 {name} ({spec.kind} source) {n} rays in chunks of {[c[0] for c in chunks]}"
        spot_err = max(spot_err, _check_stats(tag, ker, ref, opl_ref, 1e-5, 2e-3, 0.025, 0.8))
        if name == "flagship":
            rows, launch = ft.prepare_fused_source_moments(table, spec, bdet, chunks, n, **kw)
            ms = _time_ms(launch, torch)
            wrapper_ms = _time_ms(lambda: ft.fused_source_moments(table, spec, bdet, chunks, n, **kw), torch)
            plain_ms = _time_ms(lambda: ft.fused_source_moments_ref(table, spec, bdet, chunks, n, **kw), torch)
            alive = ab.alive_by_stage(table, spec, chunks, n, dev)
            bound = _bound(rows.numel() * 8 + 8 * len(chunks),
                           _ops_where_rays_die(table, alive, OPS["weight"] + OPS["moments"]))
            print(f"K2 flagship at {n} rays: kernel launch {ms:.4f} ms, whole wrapper {wrapper_ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})",
                  flush=True)
    return {"max_abs_err": spot_err, "ms": ms, "plain_ms": plain_ms, **bound}


def phase_k5(torch, dev):
    """K5 against its plain version on the card at 1e7 rays (2 chunks), on
    the flagship, the flagship with its first toroid rolled 0.3 deg, and an
    extended source: the K2 phase's tolerances on the moments; and K5
    against K2 on the same chain within the scan tests' envelope
    (tests/test_scan_kernel.py:49-55)."""
    from attosecondraytracing_tpu_torch.ops import fused_grad as fg
    from attosecondraytracing_tpu_torch.ops import fused_scan as fs
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft
    from attosecondraytracing_tpu_torch.utils import kernel_ab as ab

    flagship = _flagship(N_CHECK)[0]
    spot_err = 0.0
    for name, chain in (("flagship", flagship), ("rolled", flagship.get_OE_loop_list(1, "roll", [0.3])[0]),
                        ("extended", _extended(N_CHECK))):
        spec, elements, det, (opl_ref, inv_dn), chunks, n = _k2_setup(torch, dev, chain, N_TIME)
        _check(len(chunks) == 2, f"K5 {name}: expected 2 chunks at {n} rays, got {len(chunks)}")
        edge = chain.source_spec.gaussian_edge
        sspec = fs.make_scan_spec(spec.kind, elements, n, n_each=spec.n_each, n_sources=spec.n_sources)
        svec = fs.scan_chain_scalars(elements, spec.rot, spec.origin, det.centre, det.normal,
                                     det._plane_rotation())
        aux = fs.scan_aux(chunks, opl_ref, inv_dn, 0.0, spec.radius, edge, spec.pos_radius)
        ker = fs.fused_scan_moments(sspec, svec, aux, chunks, device=dev)
        ref = fs.scan_moments_ref(sspec, svec, aux, chunks, device=dev)
        tag = f"K5 {name} ({spec.kind} source) {n} rays"
        spot_err = max(spot_err, _check_stats(tag, ker, ref, opl_ref, 1e-5, 2e-3, 0.025, 0.8))
        bdet = ft.bake_detector(elements, det.centre, det.normal, det._plane_rotation(),
                                opl_ref=opl_ref, inv_dn_chief=inv_dn)
        k2 = ft.fused_source_moments(ft.chain_table(spec, elements), spec, bdet, chunks, n, device=dev,
                                     gaussian_edge=edge)
        _check_stats(f"K5 vs K2 {name}", ker, k2, opl_ref, 2e-3, 5e-3, 0.03, 0.9)
        if name == "flagship":
            rows, launch = fs.prepare_scan_moments(sspec, svec, aux, chunks, device=dev)
            ms = _time_ms(launch, torch)
            wrapper_ms = _time_ms(lambda: fs.fused_scan_moments(sspec, svec, aux, chunks, device=dev), torch)
            plain_ms = _time_ms(lambda: fs.scan_moments_ref(sspec, svec, aux, chunks, device=dev), torch)
            table = fg.pose_table(sspec.elements, svec)
            alive = ab.alive_by_stage(table, spec, chunks, n, dev)
            bound = _bound(rows.numel() * 8 + 4 * (svec.size + aux.size),
                           _ops_where_rays_die(table, alive, OPS["weight"] + OPS["moments"]))
            print(f"K5 flagship at {n} rays: kernel launch {ms:.4f} ms, whole wrapper {wrapper_ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})",
                  flush=True)
    return {"max_abs_err": spot_err, "ms": ms, "plain_ms": plain_ms, **bound}


def _time_streamed(tag, table, bundle, fresh, torch, dev):
    """K4 (``fresh``) or K3 on one table and bundle already on the card:
    launch-only, whole-wrapper and plain times, and the bound (K4 reads p
    and d, 24 B/ray, K3 every field, 37 B/ray; both write 37 B/ray)."""
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft

    n = bundle.n_rays
    _, launch = ft.prepare_streamed_trace(table, bundle, fresh=fresh, device=dev)
    ms = _time_ms(launch, torch)
    wrapper_ms = _time_ms(lambda: ft.streamed_trace(table, bundle, device=dev, fresh=fresh), torch)
    plain_ms = _time_ms(lambda: ft.streamed_trace_ref(table, bundle, fresh=fresh, device=dev), torch)
    bound = _bound((61 if fresh else 74) * n, (_trace_ops(table, False) + OPS["store"]) * n)
    print(f"{tag} at {n} rays: kernel launch {ms:.4f} ms, whole wrapper {wrapper_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, **bound}


#: K3 and K4 on bundles whose streams start off the 16-byte boundary: each
#: input stream's offset in elements into a larger buffer, each output's,
#: and the rays past the last whole warp of 32
K34_IN_OFFSETS = {"p": 1, "d": 2, "opl": 3, "opl_c": 1, "alive": 5, "incidence": 2}
K34_OUT_OFFSETS = {"p": 3, "d": 1, "opl": 2, "opl_c": 3, "alive": 9, "incidence": 1}
K34_TAIL = 13
K34_FIELDS = ("p", "d", "opl", "opl_c", "alive", "incidence")


def _offset_view(x, offset):
    """A copy of ``x`` in a view that starts ``offset`` elements into a
    larger buffer of its dtype."""
    flat = x.reshape(-1)
    view = flat.new_empty(flat.numel() + offset + 7)[offset:offset + flat.numel()]
    view.copy_(flat)
    return view.view(x.shape)


def _differing_rays(torch, a, b, rays):
    """How many of the rays ``rays`` (a mask) differ in any bit of p, d,
    opl, opl_c or incidence between two streamed-trace outputs."""
    differ = torch.zeros(int(rays.sum()), dtype=torch.bool, device=rays.device)
    for name in ("p", "d", "opl", "opl_c", "incidence"):
        x, y = getattr(a, name)[rays].view(torch.int32), getattr(b, name)[rays].view(torch.int32)
        differ |= (x != y).reshape(len(differ), -1).any(dim=1)
    return int(differ.sum())


def _k34_layouts(tag, torch, dev, runs):
    """K3 and K4 on what a user's bundle may be, for each ``(kernel, table,
    bundle on the card, fresh, ignore_defects)`` of ``runs``:
    - a shuffled copy (utils/kernel_ab.shuffle_order) traces to the ordered
      run's outputs permuted: alive flags equal, every output bit equal on
      the alive rays (a ray's arithmetic is its own; the warps only skip);
    - K3 on the bundle all dead on entry: alive all 0, every output as read;
    - the bundle's first rays, past a whole number of 32-ray warps by
      K34_TAIL, with every input stream a view off the 16-byte boundary
      (K34_IN_OFFSETS) against the plain version (K1's envelopes), and with
      the outputs such views too (K34_OUT_OFFSETS, a direct launch) equal to
      the wrapper's outputs bit for bit.
    Returns {kernel: largest |dp| [mm] of the views against plain}."""
    from attosecondraytracing_tpu_torch.ops import _cuda
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft
    from attosecondraytracing_tpu_torch.utils import kernel_ab as ab

    errs = {}
    for key, table, bundle, fresh, ignore in runs:
        kw = dict(device=dev, fresh=fresh, ignore_defects=ignore)
        order = ab.shuffle_order(bundle.n_rays, dev)
        ordered = ft.streamed_trace(table, bundle, **kw)
        shuffled = ft.streamed_trace(table, ab.permuted(bundle, order), **kw)
        moved = ft.TraceOutputs(*(x[order] for x in ordered))
        same_alive = bool(torch.equal(shuffled.alive, moved.alive))
        differ = _differing_rays(torch, shuffled, moved, shuffled.alive) if same_alive else -1
        print(f"{key} {tag} shuffled ({bundle.n_rays} rays): alive flags {'equal' if same_alive else 'differ'}, "
              f"{differ} of {int(shuffled.alive.sum())} alive rays differ in a bit from the ordered run's",
              flush=True)
        _check(same_alive and differ == 0, f"{key} {tag}: the shuffled bundle's outputs are not the ordered ones")
        if not fresh:
            dead = bundle._replace(alive=torch.zeros_like(bundle.alive))
            out = ft.streamed_trace(table, dead, **kw)
            as_read = all(bool(torch.equal(getattr(out, f).view(torch.int32), getattr(dead, f).view(torch.int32)))
                          for f in ("p", "d", "opl", "opl_c", "incidence"))
            print(f"{key} {tag} all dead on entry: {int(out.alive.sum())} alive out, outputs "
                  f"{'as read' if as_read else 'not as read'}", flush=True)
            _check(not bool(out.alive.any()) and as_read, f"{key} {tag}: a bundle dead on entry came back traced")
        n = bundle.n_rays - bundle.n_rays % 32 - 32 + K34_TAIL
        head = bundle._replace(**{f: getattr(bundle, f)[:n] for f in K34_FIELDS + ("intensity",)})
        views = head._replace(**{f: _offset_view(getattr(head, f), K34_IN_OFFSETS[f]) for f in K34_FIELDS})
        _check(all(getattr(views, f).data_ptr() % 16 for f in K34_FIELDS),
               f"{key} {tag}: the views must start off the 16-byte boundary")
        got = ft.streamed_trace(table, views, **kw)
        errs[key] = _check_bundles(f"{key} {tag} ({n} rays, input views off the 16-byte boundary)", got,
                                   ft.streamed_trace_ref(table, head, fresh=fresh, device=dev,
                                                         ignore_defects=ignore), torch)
        outs = ft.TraceOutputs(*(_offset_view(x, K34_OUT_OFFSETS[f]) for f, x in zip(K34_FIELDS, got)))
        inputs = [views.p, views.d] + ([None] * 4 if fresh else
                                       [views.opl, views.opl_c, views.alive, views.incidence])
        _cuda.launch_streamed_trace(ft.pack_chain(table, ignore, dev), n, fresh, inputs, outs,
                                    torch.cuda.current_stream(dev).cuda_stream, ft.launch_grids(table.elements, dev))
        torch.cuda.synchronize()
        equal = all(bool(torch.equal(x.view(-1).view(torch.uint8), y.view(-1).view(torch.uint8)))
                    for x, y in zip(outs, got))
        print(f"{key} {tag}: input and output views off the 16-byte boundary "
              f"{'equal' if equal else 'differ from'} the wrapper's outputs bit for bit", flush=True)
        _check(equal, f"{key} {tag}: output views off the 16-byte boundary differ")
    return errs


def phase_k34(torch, dev):
    """K4 on a user-built PointSource bundle through the flagship optics at
    2^20 rays, and K3 on a traced bundle (dead rays, nonzero optical paths)
    fed through the rest of the chain, against their plain versions: alive
    masks and K1's envelopes; both on a shuffled copy, on views off the
    16-byte boundary and K3 on the bundle dead on entry (:func:`_k34_layouts`).
    Returns each kernel's largest |dp| [mm], and both kernels' times on the
    flagship's bundle at 1e7 rays, in its spiral order and shuffled."""
    import numpy as np

    from attosecondraytracing_tpu_torch.models import sources
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft
    from attosecondraytracing_tpu_torch.ops.bundle import RayBundle
    from attosecondraytracing_tpu_torch.utils import kernel_ab as ab

    chain, _ = _flagship(16)
    host = [e.to_device("cpu", torch.float64) for e in chain.optical_elements]
    table = ft.chain_table(None, host)
    bundle = sources.ApplyGaussianIntensityToRayList(
        sources.PointSource(np.zeros(3), np.array([1.0, 0.0, 0.0]), 25e-3, N_CHECK, 80e-6), np.exp(-2.0))
    _check(ft._is_fresh(bundle), "a factory PointSource bundle must be fresh")
    err4 = _check_bundles("K4 flagship (user PointSource)", ft.streamed_trace(table, bundle, device=dev),
                          ft.streamed_trace_ref(table, bundle, fresh=True, device=dev), torch)
    first = ft.streamed_trace(ft.chain_table(None, host[:2]), bundle, device=dev)
    mid = RayBundle(p=first.p, d=first.d, opl=first.opl, opl_c=first.opl_c, alive=first.alive,
                    intensity=bundle.intensity.to(dev, torch.float32), incidence=first.incidence,
                    wavelength=bundle.wavelength.to(dev, torch.float32))
    _check(not ft._is_fresh(mid) and not bool(mid.alive.all()), "the traced bundle must not be fresh")
    rest = ft.chain_table(None, host[2:])
    err3 = _check_bundles("K3 flagship (traced bundle -> second toroid)",
                          ft.streamed_trace(rest, mid, device=dev),
                          ft.streamed_trace_ref(rest, mid, fresh=False, device=dev), torch)
    views = _k34_layouts("flagship", torch, dev, [("K4", table, bundle.to(dev, torch.float32), True, True),
                                                  ("K3", rest, mid, False, True)])

    big = ft.source_bundle(_flagship_source(N_TIME), N_TIME, device=dev)  # a fresh bundle on the card
    shuffled = ab.permuted(big, ab.shuffle_order(N_TIME, dev))
    times = {}
    for name, fresh in (("K4", True), ("K3", False)):
        times[name] = {"flagship_ms": _time_streamed(f"{name} flagship", table, big, fresh, torch, dev)["ms"],
                       "flagship_shuffled_ms": _time_streamed(f"{name} flagship, shuffled", table, shuffled,
                                                              fresh, torch, dev)["ms"]}
    return {"K4": max(err4, views["K4"]), "K3": max(err3, views["K3"])}, times


def phase_slice(torch, dev):
    """The main path: main.main on the flagship at 1e7 rays with the
    detector-distance optimizer; both kernels must launch."""
    from attosecondraytracing_tpu_torch import main as art

    chain, props = _flagship(N_SLICE)
    do = {"ReflectionNumber": -1, "DistanceDetector": 500.0, "AutoDetectorDistance": True,
          "OptFor": "intensity"}
    ao = {"verbose": True, "save_results": False}
    _reset_launches()
    t0 = time.perf_counter()
    kept = art.main(chain, props, do, ao, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    transmission = kept["ETransmission"][0]
    det = kept["Detector"][0]
    spot, duration = kept["SpotSizeSD"][0], kept["DurationSD"][0]
    print(f"slice: engine {chain.last_trace_engine}, launches {launches}, transmission "
          f"{transmission:.6g} %, distance {det.get_distance():.6g} mm, spot SD {spot:.6g} mm, "
          f"duration SD {duration:.6g} fs, main.main wall {wall:.3f} s", flush=True)
    _check(chain.last_trace_engine == "cuda-source", f"trace engine {chain.last_trace_engine}")
    _check(launches["K1"] >= 1 and launches["K2"] >= 1, f"kernels not launched on the main path: {launches}")
    _check(0 < transmission <= 100, f"transmission {transmission}")
    _check(abs(det.get_distance() - 500.0) <= 25.0, f"optimal distance {det.get_distance()}")
    _check(spot < 0.5, f"spot SD {spot} mm")

    # warm wall times of the two stages (outside the counted run)
    t0 = time.perf_counter()
    bundle = chain.trace_final()
    torch.cuda.synchronize()
    t_trace = time.perf_counter() - t0
    det0 = art.setup_detector(chain, art.complete_defaults({}, do, {})[1], bundle)
    t0 = time.perf_counter()
    art.optimize_detector_fused(chain, det0, art.complete_defaults({}, do, {})[1], verbose=False)
    torch.cuda.synchronize()
    t_opt = time.perf_counter() - t0
    print(f"slice warm wall: trace_final {t_trace * 1e3:.3f} ms, optimizer {t_opt * 1e3:.3f} ms",
          flush=True)
    return launches, chain


@contextlib.contextmanager
def _without_matplotlib():
    """matplotlib hidden from imports while the block runs, as on a machine
    without it (any import of it raises ImportError), then restored."""
    saved = {k: v for k, v in sys.modules.items() if k == "matplotlib" or k.startswith("matplotlib.")}
    for name in saved:
        del sys.modules[name]
    sys.modules["matplotlib"] = None
    try:
        yield
    finally:
        sys.modules.pop("matplotlib", None)
        sys.modules.update(saved)


def _run_quiet_stderr(fn):
    """(fn's result, the lines it wrote to sys.stderr); the lines are
    echoed to stdout."""
    import io

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out = fn()
    lines = err.getvalue().splitlines()
    for line in lines:
        print(f"(stderr) {line}", flush=True)
    return out, lines


def _host_bytes(data) -> int:
    """The bytes of the host arrays in a plot's data record."""
    import dataclasses

    import numpy as np

    def walk(x):
        if isinstance(x, np.ndarray):
            return x.nbytes
        if isinstance(x, (list, tuple)):
            return sum(walk(v) for v in x)
        return 0

    return sum(walk(getattr(data, f.name)) for f in dataclasses.fields(data))


def _ray_pixels(bundle, det, bins):
    """(flat pixel, in window, weight) of each ray of ``bundle`` in the
    intensity image ``Detector.get_Image`` bins it into, on the bundle's
    device."""
    from attosecondraytracing_tpu_torch.analysis import histogram, stats

    xy = stats.detector_points_2d(bundle, det.centre, det.normal, det._plane_rotation())
    w, lo, hi = histogram._weights_and_extent(bundle, xy, None, True)
    ix, iy, inside = histogram._bin_indices(xy, lo, hi, bins)
    return histogram._flat_index(ix, iy, bins), inside, w


def phase_plots(torch, dev, chain):
    """The plots path (main.make_plots' dispatch, main._plot_calls) on the
    card with matplotlib hidden, on phase slice's flagship at 1e7 rays: the
    launch counts set to 0, main.main with the plot options
    :data:`PLOT_OPTIONS` (K1, K2; make_plots prints one stderr line and
    draws nothing, since matplotlib cannot be imported), then the dispatch
    on main.main's chain, its detector and the bundle of trace_final (K1),
    each plot's data timed as it is made (the giga-ray images at 1e9 rays:
    exactly one K1i launch). Then, outside the counted run: the giga-ray
    images against a direct fused_source_images call with the same
    arguments (sums within 1e-12 relative: the float64 atomics' order is
    free); the intensity, delay and incidence images of the card's bundle
    against the same data functions on that bundle moved to the CPU (the
    total weight within 1e-9 relative, at least 1 - 1e-4 of the weight in
    the same pixel; on the pixels summed into PRECEDENT_BINS blocks of
    weight above 5 per 16384 rays, as phase images scales
    tests/test_gigascan.py's envelope (_image_diffs), the
    mean delays within 0.05 fs median and 0.5 fs max about their common
    offset, which one float32 ulp of the mean path bounds, and the mean
    incidences within 1e-3 deg); MirrorProjection's data on each element and
    RayRenderGraph's of the flagship at 1e6 rays through get_output_rays,
    card against CPU (alive counts within 0.05 %, the projected points'
    centroid within 1e-3 mm, the same segment counts per hop). Returns the
    K1, K2 and K1i entries' ``plots``."""
    import numpy as np

    from attosecondraytracing_tpu_torch import main as art
    from attosecondraytracing_tpu_torch.analysis import gigascan as gs
    from attosecondraytracing_tpu_torch.analysis import plots
    from attosecondraytracing_tpu_torch.ops.precision import LIGHT_SPEED_MM_S

    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6, "DeltaFT": 0.5,
             "NumberRays": N_SLICE}
    do = {"ReflectionNumber": -1, "DistanceDetector": 500.0, "AutoDetectorDistance": True,
          "OptFor": "intensity"}
    ao = dict(PLOT_OPTIONS, verbose=False, save_results=False)
    sp, do_full, ao_full = art.complete_defaults(props, do, ao)
    with _without_matplotlib():
        _reset_launches()
        t0 = time.perf_counter()
        kept, err = _run_quiet_stderr(lambda: art.main(chain, props, do, ao, device=dev))
        torch.cuda.synchronize()
        main_wall = time.perf_counter() - t0
        det = kept["Detector"][0]
        bundle = chain.trace_final()
        calls = []
        dispatch = art._plot_calls(chain, bundle, det, sp, do_full, ao_full)
        while True:
            t0 = time.perf_counter()
            try:
                name, data = next(dispatch)
            except StopIteration:
                break
            torch.cuda.synchronize()
            calls.append((name, data, time.perf_counter() - t0))
        launches = _launches()
        loaded = [k for k in sys.modules if k.startswith("matplotlib.")]
    requested = [k for k in PLOT_OPTIONS if k.startswith("plot_")]
    drawn = [line for line in err if "plots not drawn" in line]
    names = [name for name, _, _ in calls]
    print(f"plots: main.main wall {main_wall:.3f} s (T {kept['ETransmission'][0]:.6g} %, "
          f"distance {det.get_distance():.6g} mm, spot {kept['SpotSizeSD'][0]:.6g} mm); dispatch "
          + ", ".join(f"{name} {wall:.3f} s {_host_bytes(data)} B to the host"
                      for name, data, wall in calls) + f"; launches {launches}", flush=True)
    _check(len(drawn) == 1 and all(k in drawn[0] for k in requested),
           f"plots: make_plots without matplotlib must print one line naming {requested}, got {err}")
    _check(not loaded, f"plots: the data half imported {loaded}")
    _check(names == ["GigaRayImages", "SpotDiagramImage"], f"plots: dispatch {names}")
    _check(launches["K1"] >= 1 and launches["K2"] >= 1 and launches["K1i"] == 1,
           f"plots: launches {launches}: K1, K2 and exactly one K1i expected")
    _check(chain.last_trace_engine == "cuda-source", f"plots: trace engine {chain.last_trace_engine}")

    # the giga-ray images against a direct call with the same arguments
    giga = calls[0][1]
    bins = int(ao_full["image_bins"])
    ref = gs.fused_source_images(chain.source_spec, chain.device_elements(), det,
                                 n_total=int(ao_full["image_rays"]), bins=(bins, bins))
    img_err = float(np.abs(giga.image - ref["image"].T).max() / ref["image"].max())
    sum_err = float(abs(np.nansum(giga.image) - ref["sum_w"]) / ref["sum_w"])
    finite = np.isfinite(ref["mean_delay"].T)
    same_mask = bool((np.isfinite(giga.mean_delay) == finite).all())
    md_scale = np.abs(ref["mean_delay"][np.isfinite(ref["mean_delay"])]).max()
    md_err = float(np.abs(giga.mean_delay - ref["mean_delay"].T)[finite].max() / md_scale)
    print(f"plots: giga-ray images vs fused_source_images: pixels {img_err:.3g}, sum w {sum_err:.3g}, "
          f"mean delays {md_err:.3g} (rel), NaN masks equal {same_mask}", flush=True)
    _check(img_err <= 1e-12 and sum_err <= 1e-12 and md_err <= 1e-12 and same_mask,
           "plots: the dispatch's giga-ray images differ from fused_source_images")

    # the card's bundle images against the same data functions on the CPU
    cpu = bundle.to("cpu")
    card_imgs = {w: plots.spot_diagram_image_data(bundle, det, False, w, bins) for w in
                 (None, "Delay", "Incidence")}
    cpu_imgs = {w: plots.spot_diagram_image_data(cpu, det, False, w, bins) for w in
                (None, "Delay", "Incidence")}
    sum_rel = float(abs(np.nansum(card_imgs[None].image) - np.nansum(cpu_imgs[None].image))
                    / np.nansum(cpu_imgs[None].image))
    flat_g, in_g, _ = _ray_pixels(bundle, det, (bins, bins))
    flat_c, in_c, w_c = _ray_pixels(cpu, det, (bins, bins))
    same = (flat_g.cpu() == flat_c) & in_g.cpu() & in_c
    same_frac = float((w_c.double() * same).sum() / (w_c.double() * in_c).sum())
    # mean values on the pixels summed into PRECEDENT_BINS blocks of more
    # than the precedent's share of the weight (5 per 16384 rays), as phase
    # images scales tests/test_gigascan.py's envelope (_image_diffs)
    block_weight = 5.0 * N_SLICE / PRECEDENT_RAYS

    def blocks(imgs, which):
        w = np.nan_to_num(imgs[None].image)
        return _rebinned({"image": w, "weight_image": w, "mean_delay": imgs[which].image})

    def block_diffs(which):
        a, b = blocks(card_imgs, which), blocks(cpu_imgs, which)
        both = (np.isfinite(a["mean_delay"]) & np.isfinite(b["mean_delay"])
                & (b["weight_image"] > block_weight))
        return (a["mean_delay"] - b["mean_delay"])[both], b["weight_image"][both]

    # The delays are taken against the mean path of the alive rays, a
    # float32 sum (stats.detector_delays), which may round to a float32 one
    # ulp apart on the two devices: a constant offset of one ulp of the path
    # (0.41 fs at 1.5 m). It is bounded by that ulp; the blocks are held to
    # the envelope about it.
    dd, ww = block_diffs("Delay")
    offset = float((dd * ww).sum() / ww.sum()) if dd.size else np.nan
    resid = np.abs(dd - offset)
    path = float((cpu.opl - cpu.opl_c)[cpu.alive].double().mean()) + det.get_distance()
    ulp_fs = float(np.spacing(np.float32(path))) / LIGHT_SPEED_MM_S * 1e15
    inc = np.abs(block_diffs("Incidence")[0])
    print(f"plots: bundle images card vs CPU: sum w rel {sum_rel:.3g}, weight in the same pixel "
          f"{same_frac:.8f}; on {dd.size} of {PRECEDENT_BINS} blocks of weight > {block_weight:.0f}: "
          f"delays offset {offset:.6g} fs (one float32 ulp of the {path:.1f} mm path: {ulp_fs:.6g} fs), "
          f"about it median {np.median(resid) if dd.size else np.nan:.3g} max "
          f"{resid.max() if dd.size else np.nan:.3g} fs, raw max {np.abs(dd).max() if dd.size else np.nan:.3g} fs; "
          f"incidences max {inc.max() if inc.size else np.nan:.3g} deg", flush=True)
    _check(sum_rel <= 1e-9, f"plots: image weight differs by {sum_rel} (rel)")
    _check(same_frac >= 1 - 1e-4, f"plots: only {same_frac} of the weight in the same pixel")
    _check(dd.size > 50 and abs(offset) <= 1.001 * ulp_fs and np.median(resid) <= 0.05
           and resid.max() <= 0.5, "plots: block mean delays differ")
    _check(inc.size > 50 and inc.max() <= 1e-3, "plots: block mean incidences differ")
    card_vs_cpu = {"sum_w_rel": sum_rel, "same_pixel": same_frac, "blocks": int(dd.size),
                   "delay_offset_fs": offset, "delay_median_fs": float(np.median(resid)),
                   "delay_max_fs": float(resid.max()), "incidence_max_deg": float(inc.max())}

    # the traced history's plots (MirrorProjection, RayRenderGraph), card vs CPU
    hchain, _ = _flagship(N_PLOTS_HISTORY)
    history = {}
    for where in (dev, "cpu"):
        hchain.to(where)
        t0 = time.perf_counter()
        proj = [plots.mirror_projection_data(hchain, k, det, None) for k in range(3)]
        render = plots.ray_render_graph_data(hchain, det.get_distance() * 1.2,
                                             ao_full["maxRaysToRender"], ao_full["OEPointsToRender"])
        history[str(where)] = (proj, render, time.perf_counter() - t0)
    (pg, rg, tg), (pc, rc, tc) = history[str(dev)], history["cpu"]
    for k, (a, b) in enumerate(zip(pg, pc)):
        na, nb = len(a.x), len(b.x)
        dc = float(np.hypot(a.x.mean() - b.x.mean(), a.y.mean() - b.y.mean()))
        print(f"plots: MirrorProjection element {k} at {N_PLOTS_HISTORY} rays: alive {na} vs {nb} (CPU), "
              f"centroid moved {dc:.3g} mm", flush=True)
        _check(abs(na - nb) <= 5e-4 * nb and dc <= 1e-3, f"plots: projection on element {k} differs")
    counts = [[len(s) for s in r.segment_sets] for r in (rg, rc)]
    print(f"plots: RayRenderGraph segments per hop {counts[0]} vs {counts[1]} (CPU); history plots "
          f"{tg:.3f} s on the card, {tc:.3f} s on the CPU", flush=True)
    _check(counts[0] == counts[1] and len(counts[0]) == 4, f"plots: render segments {counts}")

    walls = {name: wall for name, _, wall in calls}
    summary = {"main_s": main_wall, "dispatch_s": walls,
               "host_bytes": {name: _host_bytes(data) for name, data, _ in calls},
               "card_vs_cpu": card_vs_cpu}
    return {"K1": dict(summary, launches=launches["K1"]), "K2": dict(summary, launches=launches["K2"]),
            "K1i": dict(summary, launches=launches["K1i"], giga_rel_err=max(img_err, sum_err, md_err))}


def phase_scan(torch, dev):
    """The parameter scan: run_config_file on CONFIG_2toroidals_f-x-f.py at
    N_SCAN rays per chain. Every chain must take the scan engine (K5, no K1 or
    K2 launch) and agree chain by chain with the serial K1 + K2 path on the
    card: transmission within 0.05 %, spot SD 1e-2 relative, distance 1 mm."""
    from attosecondraytracing_tpu_torch import main as art

    name = "CONFIG_2toroidals_f-x-f.py"
    _reset_launches()
    t0 = time.perf_counter()
    kept = art.run_config_file(str(ROOT / "examples" / name), n_rays=N_SCAN, device=dev)
    torch.cuda.synchronize()
    wall_cli = time.perf_counter() - t0
    launches = _launches()
    chains = kept["OpticalChain"]
    engines = [c.last_trace_engine for c in chains]
    print(f"scan {name} at {N_SCAN} rays: {len(chains)} chains, engines {sorted(set(engines))}, "
          f"launches {launches}, run_config_file wall {wall_cli:.3f} s", flush=True)
    n = len(chains)
    _check(n == 11 and all(e == "cuda-scan" for e in engines), f"scan engines {engines}")
    _check(launches["K5"] == n and launches["K1"] == 0 and launches["K2"] == 0,
           f"scan launches {launches}")

    # the same chains (sources already at N_SCAN) through main.main: the
    # scan engine again, then the serial K1 + K2 path; each run counted
    _, sp, do, ao, _ = _load_config(name)
    ao = dict(ao, verbose=False)
    walls = {}
    for engine, expect in (("auto", "cuda-scan"), ("off", "cuda-source")):
        _reset_launches()
        t0 = time.perf_counter()
        res = art.main(chains, sp, do, ao, device=dev, scan_engine=engine)
        torch.cuda.synchronize()
        walls[engine] = time.perf_counter() - t0
        rerun = _launches()
        engines = [c.last_trace_engine for c in chains]
        print(f"\nscan main.main scan_engine={engine!r}: engines {sorted(set(engines))}, launches {rerun}",
              flush=True)
        _check(all(e == expect for e in engines), f"scan_engine={engine!r}: engines {engines}")
        if engine == "auto":
            _check(rerun["K5"] == n and rerun["K1"] == 0 and rerun["K2"] == 0,
                   f"scan_engine='auto': launches {rerun}")
        else:
            off = res
            _check(rerun["K5"] == 0 and rerun["K1"] >= n and rerun["K2"] >= n,
                   f"scan_engine='off': launches {rerun}")
    for i in range(n):
        t_s, t_o = kept["ETransmission"][i], off["ETransmission"][i]
        s_s, s_o = kept["SpotSizeSD"][i], off["SpotSizeSD"][i]
        d_s, d_o = kept["Detector"][i].get_distance(), off["Detector"][i].get_distance()
        print(f"scan chain {i}: transmission {t_s:.6g} vs {t_o:.6g} %, spot SD {s_s:.6g} vs {s_o:.6g} mm, "
              f"distance {d_s:.6g} vs {d_o:.6g} mm, duration SD {kept['DurationSD'][i]:.6g} vs "
              f"{off['DurationSD'][i]:.6g} fs", flush=True)
        _check(abs(t_s - t_o) <= 0.05, f"scan chain {i}: transmission {t_s} vs {t_o}")
        _check(abs(s_s - s_o) <= 1e-2 * abs(s_o), f"scan chain {i}: spot SD {s_s} vs {s_o}")
        _check(abs(d_s - d_o) <= 1.0, f"scan chain {i}: distance {d_s} vs {d_o}")
    _check(abs(kept["Detector"][5].get_distance() - 500.0) <= 10.0, "mid-scan optimum not near 500 mm")
    print(f"scan walls: main.main scan engine {walls['auto']:.3f} s, serial K1 + K2 path "
          f"{walls['off']:.3f} s ({n} chains at {N_SCAN} rays)", flush=True)
    return launches


def phase_streamed(torch, dev):
    """User-built bundles, each path run through main.main with the launch
    counts set to 0 just before it: CONFIG_toroidal2f-2f_byhand.py with a
    1e7-ray PointSource (K4 once, engine cuda-streamed), and a second chain
    fed with the traced bundle of the flagship's first two elements (K3
    once). On each path's own table and bundle: the kernel against its
    plain version ray by ray (K1's envelopes), its times, and the summary
    against the plain streamed trace on the card: transmission within
    0.05 %, spot SD 1e-2 relative, duration SD 10 % relative (both traces
    are float32 and these durations are a fraction of a femtosecond, where
    float32 delays add noise of a few percent; the float64 trace is printed
    beside them). Returns ({"K4": n, "K3": n}, {kernel: numbers})."""
    import numpy as np

    from attosecondraytracing_tpu_torch import main as art
    from attosecondraytracing_tpu_torch.analysis import stats
    from attosecondraytracing_tpu_torch.models import sources
    from attosecondraytracing_tpu_torch.models.chain import OpticalChain
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft
    from attosecondraytracing_tpu_torch.ops.trace import trace

    chain, sp, do, ao, module = _load_config("CONFIG_toroidal2f-2f_byhand.py")
    t0 = time.perf_counter()
    src = sources.ApplyGaussianIntensityToRayList(
        sources.PointSource(module.SourcePoint, -module.SourcePoint, sp["Divergence"], N_STREAMED,
                            sp["Wavelength"]), 1 / np.e**2)
    t_build = time.perf_counter() - t0
    chain.source_rays = src
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    src.p.to(dev, torch.float32)
    src.d.to(dev, torch.float32)
    torch.cuda.synchronize()
    t_copy = time.perf_counter() - t0
    print(f"streamed: host PointSource of {N_STREAMED} rays built in {t_build:.3f} s; p and d to the "
          f"card as float32 in {t_copy * 1e3:.3f} ms (pageable)", flush=True)
    ao = dict(ao, verbose=True)

    # the traced bundle (one K4 launch) is built before its path's run
    flag, props = _flagship(16)
    user = ft.source_bundle(_flagship_source(N_STREAMED), N_STREAMED, device=dev)
    first = OpticalChain(user, flag.optical_elements[:2], "flagship: mask + first toroidal", device=dev)
    second = OpticalChain(first.trace_final(), flag.optical_elements[2:],
                          "the traced bundle through the second toroidal", device=dev)
    do2 = {"ReflectionNumber": -1, "DistanceDetector": 500.0, "AutoDetectorDistance": False}

    counts, timed = {}, {}
    for key, tag, ch, sp_, do_, fresh in (("K4", "byhand", chain, sp, do, True),
                                          ("K3", "traced bundle", second, props, do2, False)):
        _reset_launches()
        t0 = time.perf_counter()
        res = art.main(ch, sp_, do_, ao, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launches()
        print(f"streamed {tag}: engine {ch.last_trace_engine}, launches {launches}, "
              f"main.main wall {wall:.3f} s", flush=True)
        _check(ch.last_trace_engine == "cuda-streamed", f"streamed {tag}: engine {ch.last_trace_engine}")
        other = "K3" if fresh else "K4"
        _check(launches[key] == 1 and launches[other] == 0 and launches["K1"] == 0
               and launches["K5"] == 0, f"streamed {tag}: launches {launches}")
        counts[key] = launches[key]

        table = ft.chain_table(None, [e.to_device("cpu", torch.float64) for e in ch.optical_elements])
        bundle = ch.source_rays.to(dev, torch.float32)
        _check(ft._is_fresh(bundle) == fresh, f"streamed {tag}: the bundle's freshness")
        err = _check_bundles(f"{key} {tag} ({bundle.n_rays} rays)",
                             ft.streamed_trace(table, bundle, device=dev, fresh=fresh),
                             ft.streamed_trace_ref(table, bundle, fresh=fresh, device=dev), torch)
        timed[key] = {"max_abs_err": err, **_time_streamed(f"{key} {tag}", table, bundle, fresh, torch, dev)}

        det = res["Detector"][0]
        ref = ch.trace_final(engine="trace")
        spot, duration = (float(v) for v in det.get_SpotAndDuration(ref))
        transmission = stats.energy_transmission(ch.source_rays, ref)
        ref64 = trace(ch.source_rays.to(dev, torch.float64), ch.device_elements(torch.float64),
                      keep_history=False)
        spot64, duration64 = (float(v) for v in det.get_SpotAndDuration(ref64))
        tg, sg, dg = res["ETransmission"][0], res["SpotSizeSD"][0], res["DurationSD"][0]
        print(f"streamed {tag}: kernels T {tg:.6g} % spot {sg:.6g} mm duration {dg:.6g} fs; plain trace "
              f"T {transmission:.6g} % spot {spot:.6g} mm duration {duration:.6g} fs; float64 trace "
              f"spot {spot64:.6g} mm duration {duration64:.6g} fs", flush=True)
        _check(abs(tg - transmission) <= 0.05, f"streamed {tag}: transmission {tg} vs {transmission}")
        _check(abs(sg - spot) <= 1e-2 * abs(spot), f"streamed {tag}: spot SD {sg} vs {spot}")
        _check(abs(dg - duration) <= 0.1 * duration, f"streamed {tag}: duration SD {dg} vs {duration}")
    return counts, timed


def _grad_problem(torch, dev, chain, n_rays, params_fn, distance=495.0, survival_weight=1.0, det=None):
    """(spec, host elements, geometry, params, detector) of a fused
    alignment loss: the chain's factory source at ``n_rays`` rays with the
    Gaussian edge exp(-2), a detector ``distance`` behind the last element,
    placed from a 4096-ray probe trace (scripts/bench_fused_grad.py) unless
    ``det`` is given, and the misalignment ``params_fn`` gives."""
    import numpy as np

    from attosecondraytracing_tpu_torch.analysis import alignment as al
    from attosecondraytracing_tpu_torch.models.detector import Detector
    from attosecondraytracing_tpu_torch.ops import fused_grad as fg
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft

    chain.to(dev)
    info = chain.source_spec._replace(gaussian_edge=float(np.exp(-2.0)), n_rays=n_rays)
    baked = info.baked()
    elements = chain.device_elements()
    if det is None:
        det = Detector(chain.optical_elements[-1].position)
        det.autoplace(ft.probe_trace(baked, elements, 4096, device=dev, dtype=torch.float32), distance)
    spec = fg.make_loss_spec(info, elements, det.centre, det.normal, survival_weight=survival_weight,
                             device=dev)
    host = [e.to_device("cpu", torch.float64) for e in chain.optical_elements]
    geo = (np.asarray(baked.rot, np.float64), np.asarray(info.origin, np.float64), det.centre,
           det.normal, det._plane_rotation())
    params = al.zero_params(len(host))
    params_fn(params)
    return spec, host, geo, params, det


def _bench_misalignment(params):
    """scripts/bench_fused_grad.py:50-53: the first toroid pitched 2e-4 rad
    and shifted 0.05 mm along its normal."""
    params.angles[1, 0] = 2e-4
    params.shifts[1, 0] = 0.05


def _check_grad_sums(tag, got, ref, opl_ref):
    """K6/K7 sums against their plain version with the K2 phase's tolerances
    on what they give: the sum of weights rel 1e-5, the spot SD rel 2e-3,
    the duration SD within 2.5 % or 0.8 fs in quadrature (the spatial sums'
    difference relative to their scales is printed: kernel and plain
    version differ per ray as K1 does from its plain version)."""
    import numpy as np

    from attosecondraytracing_tpu_torch.ops import fused_trace as ft

    w, _, _, wxx, wyy, _, _ = ref
    scale = np.array([np.sqrt(w * wxx), np.sqrt(w * wyy), wxx, wyy])
    spatial = float(np.max(np.abs(got[1:5] - ref[1:5]) / scale))
    stats = [ft.sums_to_stats(dict(zip(ft.STATS_FIELDS, v[:, None])), opl_ref, (0.0,)) for v in (got, ref)]
    (s_k, d_k), (s_r, d_r) = ((float(x["spot_sd"][0]), float(x["duration_sd"][0])) for x in stats)
    print(f"{tag}: sum w {got[0]:.9g} vs {ref[0]:.9g}, spatial sums within {spatial:.3g} of scale, "
          f"spot {s_k:.6g} vs {s_r:.6g} mm, duration {d_k:.6g} vs {d_r:.6g} fs", flush=True)
    _check(abs(got[0] - w) <= 1e-5 * w, f"{tag}: sum of weights {got[0]} vs {w}")
    _check(abs(s_k - s_r) <= 2e-3 * s_r, f"{tag}: spot SD {s_k} vs {s_r}")
    _check(abs(d_k - d_r) <= 0.025 * d_r or abs(d_k**2 - d_r**2) ** 0.5 <= 0.8,
           f"{tag}: duration SD {d_k} vs {d_r}")
    return abs(s_k - s_r)


def _check_focus_loss(tag, fg, params, spec, host, geo, ref_sums, dev):
    """fused_focus_loss on the card (one K7 launch, counted) against the
    loss of the plain version's sums ``ref_sums``: rel 2e-3. Returns the
    difference."""
    fg.fused_stats_params.primal_launches = 0
    loss = fg.fused_focus_loss(params, spec, host, *geo, device=dev)
    ref = fg._loss_from_stats(ref_sums, spec, fg._total_weight(spec))[0]
    print(f"{tag}: fused_focus_loss {loss:.9g} vs the plain version's {ref:.9g}", flush=True)
    _check(fg.fused_stats_params.primal_launches == 1, f"{tag}: fused_focus_loss launched K7 "
           f"{fg.fused_stats_params.primal_launches} times")
    _check(abs(loss - ref) <= 2e-3 * abs(ref), f"{tag}: fused_focus_loss {loss} vs {ref}")
    return abs(loss - ref)


def _grad_ref(fg, spec, svec, tangents, chunks, dev):
    """(loss, gradient) from the plain version of K6 over every tangent row,
    the host side of fused_focus_value_and_grad."""
    p_stats, t_stats = fg.stats_params_ref(spec, svec, tangents, chunks, device=dev)
    loss, dloss = fg._loss_from_stats(p_stats, spec, fg._total_weight(spec))
    return loss, t_stats @ dloss


def phase_k67(torch, dev):
    """K6 and K7 against their plain version on the card at 2^20 rays, on
    the flagship with scripts/bench_fused_grad.py's misalignment and on an
    extended source: all 18 tangent rows of a gradient step in one K6
    launch, its 7 sums (the CPU tests' envelopes) and the tangents (the
    spatial sums' within 2e-3 of each statistic's largest, the delay sums'
    within 2e-2), K7's sums and K7 against K6's primal, and the loss and
    gradient of fused_focus_value_and_grad (loss rel 2e-3, gradient within
    2e-2 of its largest entry). Then launch-only times at 1e7 rays (2
    chunks): K6 for the whole step's 18 rows in one launch, K7, and the
    plain version's; at that size K7's sums are held against the plain
    version's and K6's primal, and fused_focus_loss against the plain
    loss, as at 2^20."""
    import numpy as np

    from attosecondraytracing_tpu_torch.ops import fused_grad as fg
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft
    from attosecondraytracing_tpu_torch.utils import kernel_ab as ab

    err6 = err7 = 0.0
    for name, chain in (("flagship", _flagship(N_CHECK)[0]), ("extended", _extended(N_CHECK))):
        spec, host, geo, params, _ = _grad_problem(torch, dev, chain, chain.source_spec.n_rays,
                                                   _bench_misalignment)
        svec = fg.chain_scalars_np(fg._apply_params_np(host, params), *geo)
        tang = fg.scalar_tangents(host, params, *geo)
        chunks = fg._ray_chunks(spec, fg.GRAD_CHUNK)
        _check(tang.shape[0] == fg.n_params(len(host)) == 18, f"K6 {name}: {tang.shape[0]} tangent rows")
        fg.fused_stats_params.launches = 0
        p_k, t_k = fg.fused_stats_params(spec, svec, tang, chunks, device=dev)
        _check(fg.fused_stats_params.launches == 1, f"K6 {name}: {fg.fused_stats_params.launches} launches")
        p_r, t_r = fg.stats_params_ref(spec, svec, tang, chunks, device=dev)
        _check_grad_sums(f"K6 {name} ({spec.source_kind}, {spec.n_rays} rays, 18 tangent rows in one launch)",
                         p_k, p_r, spec.opl_ref)
        scale = np.maximum(np.abs(t_r).max(axis=0), 1e-12)
        per_stat = (np.abs(t_k - t_r) / scale).max(axis=0)
        print(f"K6 {name}: the 18 tangent rows within " + ", ".join(
            f"{f} {v:.3g}" for f, v in zip(ft.STATS_FIELDS, per_stat))
            + " of each statistic's largest", flush=True)
        # the spatial sums' tangents to 2e-3 (the CPU tests' envelope); the
        # delay sums' to 2e-2: they carry the float32 delay noise that
        # makes the primal durations differ by several percent
        _check(t_k.shape == (18, 7) and np.all(np.isfinite(t_k)) and per_stat[:5].max() <= 2e-3
               and per_stat[5:].max() <= 2e-2, f"K6 {name}: tangents differ by {per_stat}")
        p7, _ = fg.fused_stats_params(spec, svec, None, chunks, device=dev)
        p7_r, _ = fg.stats_params_ref(spec, svec, None, chunks, device=dev)
        _check_grad_sums(f"K7 {name}", p7, p7_r, spec.opl_ref)
        _check_grad_sums(f"K7 vs K6 primal {name}", p7, p_k, spec.opl_ref)
        loss_k, grads = fg.fused_focus_value_and_grad(params, spec, host, *geo, device=dev)
        g_k = np.concatenate([grads.angles.reshape(-1).numpy(), grads.shifts.reshape(-1).numpy()])
        loss_r, g_r = _grad_ref(fg, spec, svec, tang, chunks, dev)
        print(f"K6 {name}: loss {loss_k:.9g} vs {loss_r:.9g}, gradient max |diff| "
              f"{np.abs(g_k - g_r).max():.3g} of max |g| {np.abs(g_r).max():.3g}", flush=True)
        _check(abs(loss_k - loss_r) <= 2e-3 * abs(loss_r), f"K6 {name}: loss {loss_k} vs {loss_r}")
        _check(np.all(np.abs(g_k - g_r) <= 2e-2 * np.abs(g_r).max() + 2e-2 * np.abs(g_r)),
               f"K6 {name}: gradient {g_k} vs {g_r}")
        err6 = max(err6, float(np.abs(g_k - g_r).max()))
        err7 = max(err7, _check_focus_loss(f"K7 {name}", fg, params, spec, host, geo, p7_r, dev))

    # launch-only times at 1e7 rays of the flagship (2 chunks in one launch)
    chain = _flagship(N_CHECK)[0]
    spec, host, geo, params, det = _grad_problem(torch, dev, chain, N_TIME, _bench_misalignment)
    svec = fg.chain_scalars_np(fg._apply_params_np(host, params), *geo)
    tang = fg.scalar_tangents(host, params, *geo)
    chunks = fg._ray_chunks(spec, fg.GRAD_CHUNK)
    _check(len(chunks) == 2, f"K6 timing: expected 2 chunks, got {len(chunks)}")
    table = fg.pose_table(spec.elements, svec)
    alive, warps = ab.alive_by_stage(table, fg.loss_source(spec), chunks, spec.n_rays, dev, warps=True)
    n_alive = alive[-1]
    per_ray = _trace_ops(table, True) + OPS["weight"]
    out, last = {}, {}
    for key, group in (("K6", tang), ("K7", None)):
        rows, launch = fg.prepare_stats_params(spec, svec, group, chunks, device=dev)
        ms = _time_ms(launch, torch)
        wrapper_ms = _time_ms(lambda: last.update(
            {key: fg.fused_stats_params(spec, svec, group, chunks, device=dev)[0]}), torch)
        plain_ms = _time_ms(lambda: last.update(
            plain=fg.stats_params_ref(spec, svec, group, chunks, device=dev)[0]), torch, reps=3, inner=1)
        n_in = svec.size
        if group is not None:  # one gradient step: the primal once, every tangent row once
            P = len(group)
            ops = per_ray * N_TIME + OPS["stats"] * n_alive
            ops += (OPS["dual_trace_once"] + P * OPS["dual_trace_tangent"]) * N_TIME
            ops += (OPS["dual_stats_once"] + P * OPS["dual_stats_tangent"]) * n_alive
            n_in += group.size
        else:
            # the timed size's sums (2 chunks, the last block partial) against
            # the plain version's and K6's primal, and the loss
            tag = f"K7 flagship at {N_TIME} rays"
            _check_grad_sums(tag, last["K7"], last["plain"], spec.opl_ref)
            _check_grad_sums(f"K7 vs K6 primal flagship at {N_TIME} rays", last["K7"], last["K6"], spec.opl_ref)
            err7 = max(err7, _check_focus_loss(tag, fg, params, spec, host, geo, last["plain"], dev))
            ops = _ops_where_rays_die(table, alive, OPS["weight"] + OPS["stats"])
            whole = _bound(rows.numel() * 8 + 4 * n_in + 8 * len(chunks), per_ray * N_TIME + OPS["stats"] * n_alive)
            print(f"K7 bound counted where the rays die (alive entering each element, then at the end: "
                  f"{alive}): {ops:.6g} operations; every ray charged the whole chain, as before: "
                  f"{whole['bound_ms']:.4f} ms", flush=True)
        bound = _bound(rows.numel() * 8 + 4 * n_in + 8 * len(chunks), ops)
        print(f"{key} flagship at {N_TIME} rays ({n_alive} alive): kernel launch {ms:.4f} ms, whole "
              f"wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']})", flush=True)
        out[key] = {"max_abs_err": err6 if key == "K6" else err7, "ms": ms, "plain_ms": plain_ms, **bound}
    out["K7"]["stages"] = _k7_stage_split(torch, dev, chain, host, geo, params, det, alive, warps)
    return out


#: K7's stage split: the flagship chain's prefixes (the mask; the mask and
#: the first toroid; the whole chain), each with its own loss spec
K7_PREFIXES = (1, 2, 3)


def _k7_stage_split(torch, dev, chain, host, geo, params, det, rays, warps):
    """K7's launch alone at 1e7 rays on each prefix of the misaligned
    flagship (:data:`K7_PREFIXES`), the same source and detector plane, each
    prefix its own loss spec and pose vector; the rays and warps alive
    entering each element and at the end (a prefix's are the whole chain's
    ``rays`` and ``warps`` up to its end: its pose vector begins with the
    whole chain's); then per stage (the source, the
    mask and the epilogue: the first prefix; each toroid: the difference of
    two prefixes) its time, its rays and warps, its time per entering ray
    and its operations (:func:`_stage_ops`) beside its time at the float32
    peak. Returns the prefixes and the stages."""
    import numpy as np

    from attosecondraytracing_tpu_torch.ops import fused_grad as fg
    from attosecondraytracing_tpu_torch.utils import kernel_ab as ab

    info = chain.source_spec._replace(gaussian_edge=float(np.exp(-2.0)), n_rays=N_TIME)
    elements = chain.device_elements()
    posed = fg._apply_params_np(host, params)
    prefixes = []
    for j in K7_PREFIXES:
        spec = fg.make_loss_spec(info, elements[:j], det.centre, det.normal, device=dev)
        svec = fg.chain_scalars_np(posed[:j], *geo)
        chunks = fg._ray_chunks(spec, fg.GRAD_CHUNK)
        table = fg.pose_table(spec.elements, svec)
        rays_j, warps_j = rays[:2 * j + 1], warps[:2 * j + 1]
        rows, launch = fg.prepare_stats_params(spec, svec, None, chunks, device=dev)
        prefixes.append({"elements": j, "ms": _time_ms(launch, torch), "rays": rays_j, "warps": warps_j,
                         "stage_warps": ab.stage_warps(table, warps_j, rows.shape[1]),
                         "stage_ops": [step for _pre, step in _stage_ops(table)],
                         "ops": _ops_where_rays_die(table, rays_j, OPS["weight"] + OPS["stats"])})
    first = prefixes[0]
    stages = [{"stage": "source, mask, epilogue", "ms": first["ms"], "rays": first["rays"][1],
               "warps": first["warps"][1], "ops": first["ops"]}]
    for a, b in zip(prefixes, prefixes[1:]):
        i = b["elements"] - 1
        stages.append({"stage": f"element {i} (toroid)", "ms": b["ms"] - a["ms"], "rays": b["rays"][2 * i + 1],
                       "warps": b["warps"][2 * i + 1], "ops": b["stage_ops"][i] * b["rays"][2 * i + 1]})
    for st in stages:
        st["ns_per_ray"] = st["ms"] * 1e6 / st["rays"]
        st["ops_ms"] = st["ops"] / FP32_OPS_PER_S * 1e3
        print(f"K7 stage {st['stage']}: {st['ms']:.4f} ms for {st['rays']} rays ({st['warps']} warps) entering, "
              f"{st['ns_per_ray']:.5f} ns per ray; {st['ops']:.6g} operations, {st['ops_ms']:.4f} ms at the "
              f"float32 peak ({st['ms'] / st['ops_ms']:.2f}x)", flush=True)
    issue = _k7_issue_bounds(prefixes)
    for p in prefixes:
        print(f"K7 prefix of {p['elements']} element(s): {p['ms']:.4f} ms; rays alive {p['rays']}, warps "
              f"{p['warps']}; " + ", ".join(f"{k} {v:.4f}" for k, v in p.get("issue_ms", {}).items())
              + " ms (issue-slot and pipe bounds)", flush=True)
    return {"prefixes": prefixes, "stages": stages, "sass": issue}


def _k7_issue_bounds(prefixes) -> dict:
    """K7's SASS by stage on the flagship's path (utils/kernel_ab.
    sass_stages over this build's nvdisasm listing) and, for each prefix of
    the stage split, the issue-slot bound of its warp passes and each pipe's
    own bound (kernel_ab.issue_bound at the card's clocks.max.sm), written
    into the prefixes as ``issue_ms``. Returns the stage counts and the
    clock, or the reason they are not measured."""
    from attosecondraytracing_tpu_torch.ops import _cuda
    from attosecondraytracing_tpu_torch.utils import kernel_ab as ab

    try:
        mhz = ab.clock_hz() / 1e6
        stages = ab.sass_stages(_cuda.library()._name)
    except (OSError, RuntimeError, ValueError, subprocess.CalledProcessError) as exc:
        print(f"K7 SASS by stage not measured ({exc})", flush=True)
        return {"not_measured": str(exc)}
    for st, c in stages.items():
        print(f"K7 SASS {st}: {c['total']:g} warp instructions a pass ({ab._pipes_text(c)})", flush=True)
    for p in prefixes:
        p["issue_ms"] = ab.issue_bound(stages, p["stage_warps"], mhz * 1e6)
    return {"stages": stages, "clock_mhz": mhz}


def phase_grad(torch, dev):
    """The gradient path at full width: gradient_align on the flagship at 1e7
    rays, its first toroid rolled 0.3 deg (tests/test_gradients.py:212-219),
    lr 2e-4, survival weight 0.1, 12 Adam steps, engine "auto", with the
    launch counts set to 0 just before it: the engine must be cuda-grad, K6
    launched once per step and no other kernel, the loss must fall, and
    its spot-variance part must fall below 0.9 of its first value (the
    check of tests/test_gradients.py:219; there the whole loss is spot
    variance, while on the flagship, ~72 % transmitted, the survival term
    0.1 (1 - T) ~ 0.028 is a floor that the pose gradient leaves alone and
    that holds the whole loss above ~0.89 of its first value). Then
    fused_focus_loss (K7) on its own
    counted run, the wall of a step's parts, and one step's loss and gradient
    against the autograd engine on the card at 2^18 rays with the kernel-form
    source (tests/test_gradients.py:173-192)."""
    import numpy as np

    from attosecondraytracing_tpu_torch.analysis import alignment as al
    from attosecondraytracing_tpu_torch.models.detector import Detector
    from attosecondraytracing_tpu_torch.ops import fused_grad as fg
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft

    t0 = time.perf_counter()
    chain, _ = _flagship(N_GRAD)
    t_build = time.perf_counter() - t0
    chain.to(dev)
    chain.rotate_OE(1, "roll", 0.3)
    det = Detector(chain.optical_elements[-1].position)
    det.autoplace(chain.trace_final(), 500.0)
    _check(chain.fused_eligible(), "the flagship at 1e7 rays must be fused-eligible")
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, history = al.gradient_align(chain, det, iters=GRAD_ITERS, lr=2e-4, survival_weight=0.1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    print(f"grad: chain of {N_GRAD} rays placed in {t_build:.3f} s; gradient_align engine "
          f"{al.gradient_align.last_engine}, launches {launches}, {GRAD_ITERS} steps in {wall:.3f} s "
          f"({wall / GRAD_ITERS * 1e3:.3f} ms per step), loss {history[0]:.6g} -> {history[-1]:.6g}",
          flush=True)
    _check(al.gradient_align.last_engine == "cuda-grad", f"engine {al.gradient_align.last_engine}")
    _check(launches["K6"] == GRAD_ITERS and all(
        v == 0 for k, v in launches.items() if k != "K6"), f"gradient_align launches {launches}")
    _check(history[-1] < history[0], f"loss did not descend: {history}")

    # the spot-variance part of the loss at the first and the last poses (K7)
    spec = fg.make_loss_spec(chain.source_spec, chain.device_elements(), det.centre, det.normal,
                             survival_weight=0.1, device=dev)
    host = [e.to_device("cpu", torch.float64) for e in chain.optical_elements]
    info = chain.source_spec
    geo = (np.asarray(info.baked().rot, np.float64), np.asarray(info.origin, np.float64), det.centre,
           det.normal, det._plane_rotation())

    def spot_variance(p):
        svec = fg.chain_scalars_np(fg._apply_params_np(host, p), *geo)
        st, _ = fg.fused_stats_params(spec, svec, None, fg._ray_chunks(spec, fg.GRAD_CHUNK), device=dev)
        w, wx, wy, wxx, wyy = st[:5]
        return wxx / w - (wx / w) ** 2 + wyy / w - (wy / w) ** 2, 100.0 * w / fg._total_weight(spec)

    (var0, t0_pct), (var1, t1_pct) = spot_variance(al.zero_params(len(host))), spot_variance(params)
    print(f"grad: spot variance {var0:.6g} -> {var1:.6g} mm^2, transmission {t0_pct:.4f} -> {t1_pct:.4f} %",
          flush=True)
    _check(var1 < 0.9 * var0, f"spot variance did not fall below 0.9 of its first value: {var0} -> {var1}")

    # a step's parts, and K7 on its own counted run
    walls = {}
    for key, fn in (("tangents (closed form)", lambda: fg.scalar_tangents(host, params, *geo)),
                    ("value_and_grad", lambda: fg.fused_focus_value_and_grad(params, spec, host, *geo,
                                                                             device=dev)),
                    ("fused_focus_loss (K7)", lambda: fg.fused_focus_loss(params, spec, host, *geo,
                                                                         device=dev))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        walls[key] = (time.perf_counter() - t0) / 5 * 1e3
    _reset_launches()
    loss7 = fg.fused_focus_loss(params, spec, host, *geo, device=dev)
    k7 = _launches()
    print("grad step parts (ms, mean of 5 warm calls): " + ", ".join(f"{k} {v:.3f}" for k, v in walls.items())
          + f"; fused_focus_loss {loss7:.6g} with launches {k7}", flush=True)
    _check(k7["K7"] == 1 and all(v == 0 for k, v in k7.items() if k != "K7"), f"K7 launches {k7}")

    # the closed-form tangent rows against torch.func.jacfwd of the tests'
    # differentiable pose vector
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_pose_oracle import chain_scalars

    K = len(host)

    def scal(fp):
        p = al.AlignmentParams(angles=fp[:3 * K].reshape(K, 3), shifts=fp[3 * K:].reshape(K, 3))
        return chain_scalars(al.apply_params(host, p), *geo)

    flat = torch.cat([params.angles.reshape(-1), params.shifts.reshape(-1)]).to(torch.float64)
    ref = torch.func.jacfwd(scal)(flat).T.numpy()
    closed = fg.scalar_jacobian(host, params, *geo)
    gap = float(np.abs(closed - ref).max() / np.abs(ref).max())
    print(f"grad tangents: closed form vs torch.func.jacfwd, largest gap {gap:.3g} of the largest "
          "entry", flush=True)
    _check(gap <= 1e-12 and np.array_equal(fg.scalar_tangents(host, params, *geo),
                                           closed.astype(np.float32)),
           f"closed-form tangent rows vs torch.func.jacfwd: gap {gap:.3g} of the largest entry")

    # one step against the autograd engine on the card
    def misalign(p):
        p.angles[1, 0] = 2e-4
        p.angles[2, 2] = -1e-4
        p.shifts[1, 0] = 0.05

    small = _flagship(16)[0]
    spec, host, geo, params, det = _grad_problem(torch, dev, small, N_GRAD_CHECK, misalign, distance=495.0)
    loss_f, grads_f = fg.fused_focus_value_and_grad(params, spec, host, *geo, device=dev)
    info = small.source_spec._replace(n_rays=N_GRAD_CHECK)
    src = ft.source_bundle(info.baked(), N_GRAD_CHECK, device=dev)
    k = torch.arange(N_GRAD_CHECK, dtype=torch.float32, device=dev)
    src = src._replace(intensity=torch.exp(float(np.log(np.exp(-2.0))) * k / N_GRAD_CHECK))
    p = al.AlignmentParams(params.angles.to(dev).requires_grad_(True),
                           params.shifts.to(dev).requires_grad_(True))
    loss_x = al.focus_loss(p, src, small.device_elements(torch.float32), det.centre, det.normal,
                           det._plane_rotation(), survival_weight=1.0)
    loss_x.backward()
    loss_x = float(loss_x.detach())
    print(f"grad check at {N_GRAD_CHECK} rays: fused loss {loss_f:.9g} vs autograd {loss_x:.9g}", flush=True)
    _check(abs(loss_f - loss_x) <= 2e-3 * abs(loss_x), "fused vs autograd loss")
    for name, g_f, g_x in (("angles", grads_f.angles, p.angles.grad), ("shifts", grads_f.shifts, p.shifts.grad)):
        g_f, g_x = g_f.numpy(), g_x.cpu().numpy()
        scale = max(float(np.abs(g_x).max()), 1e-12)
        print(f"grad check {name}: fused {np.array2string(g_f.ravel(), precision=4)} autograd "
              f"{np.array2string(g_x.ravel(), precision=4)}", flush=True)
        _check(np.all(np.isfinite(g_x)) and np.all(np.abs(g_f - g_x) <= 2e-2 * scale + 2e-2 * np.abs(g_x)),
               f"fused vs autograd {name} gradient")
    return launches, k7


#: distances of K8's checks (8 and 9: an edge of its tiles of 4 distances
#: and one past it; 128: the most a pass takes) and, among them, of its timed
#: launches
K8_CHECK = (1, 8, 9, 20, 128)
K8_TIMED = (1, 20, 128)


def phase_k8(torch, dev):
    """K8 against its plain version on the card at 2^20 rays for 1, 8, 9, 20
    and 128 distances (scripts/bench_stats_kernel.py:35-36: +-10 mm,
    per-distance chief-ray delay offsets), with the launch counts set to 0
    just before those calls: one launch per call; the 20-distance statistics
    against K2's moments on the same chain; then launch-only times at 1e7
    rays for 1, 20 and 128 distances. The bound counts one trace per ray and
    one stats geometry per alive ray, then 21 operations per alive ray and
    distance."""
    import numpy as np

    from attosecondraytracing_tpu_torch.ops import fused_trace as ft
    from attosecondraytracing_tpu_torch.utils import kernel_ab as ab

    chain = _flagship(N_CHECK)[0]
    edge = chain.source_spec.gaussian_edge
    cases = {J: (0.0,) if J == 1 else tuple(float(d) for d in np.linspace(-10, 10, J)) for J in K8_CHECK}

    def detector(elements, det, opl_ref, inv_dn, distances):
        return ft.bake_detector(elements, det.centre, det.normal, det._plane_rotation(), opl_ref=opl_ref,
                                inv_dn_chief=inv_dn, distances=distances,
                                delay_offsets=tuple(-d * inv_dn for d in distances))

    spec, elements, det, (opl_ref, inv_dn), chunks, n = _k2_setup(torch, dev, chain, N_CHECK)
    table = ft.chain_table(spec, elements)
    err, runs = 0.0, {}
    _reset_launches()
    for J in K8_CHECK:
        runs[J] = ft.fused_source_stats(table, spec, detector(elements, det, opl_ref, inv_dn, cases[J]),
                                        chunks, n, device=dev, gaussian_edge=edge)
    launches = _launches()
    _check(launches["K8"] == len(K8_CHECK) and sum(launches.values()) == len(K8_CHECK),
           f"K8 launches {launches}")
    for J in K8_CHECK:
        ref = ft.fused_source_stats_ref(table, spec, detector(elements, det, opl_ref, inv_dn, cases[J]),
                                        chunks, n, device=dev, gaussian_edge=edge)
        _check(runs[J].shape == ref.shape == (7, J), f"K8 J={J}: shapes {runs[J].shape} {ref.shape}")
        err = max(err, _check_sum_stats(f"K8 J={J} vs plain", runs[J], ref, opl_ref, cases[J]))
    mom = ft.fused_source_moments(table, spec, detector(elements, det, opl_ref, inv_dn, (0.0,)), chunks, n,
                                  device=dev, gaussian_edge=edge)
    k2 = ft.moments_to_distance_sums(mom, cases[20])
    _check_sum_stats("K8 J=20 vs K2 moments", runs[20], np.stack([k2[f] for f in ft.STATS_FIELDS]),
                     opl_ref, cases[20])

    spec, elements, det, (opl_ref, inv_dn), chunks, n = _k2_setup(torch, dev, chain, N_TIME)
    table = ft.chain_table(spec, elements)
    _check(len(chunks) == 2, f"K8 timing: expected 2 chunks, got {len(chunks)}")
    alive = ab.alive_by_stage(table, spec, chunks, n, dev)
    out = {}
    for J in K8_TIMED:
        bdet = detector(elements, det, opl_ref, inv_dn, cases[J])
        rows, launch = ft.prepare_fused_source_stats(table, spec, bdet, chunks, n, device=dev,
                                                     gaussian_edge=edge)
        ms = _time_ms(launch, torch)
        wrapper_ms = _time_ms(lambda: ft.fused_source_stats(table, spec, bdet, chunks, n, device=dev,
                                                            gaussian_edge=edge), torch)
        plain_ms = _time_ms(lambda: ft.fused_source_stats_ref(table, spec, bdet, chunks, n, device=dev,
                                                              gaussian_edge=edge), torch, reps=3, inner=1)
        ops = _ops_where_rays_die(table, alive, OPS["weight"] + OPS["stats_geometry"] + J * OPS["stats_distance"])
        bound = _bound(rows.numel() * 8 + 8 * len(chunks) + 8 * J, ops)
        print(f"K8 flagship J={J} at {n} rays: kernel launch {ms:.4f} ms, whole wrapper {wrapper_ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms ({bound['bound_by']})", flush=True)
        out[J] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound}
    return out, launches["K8"]


def _check_sum_stats(tag, ker, ref, opl_ref, distances):
    """Two (7, J) sum arrays: the sum of weights rel 1e-5 and
    tests/test_stats_kernel.py's envelopes on the statistics at every
    distance. Returns the largest spot SD difference [mm]."""
    import numpy as np

    from attosecondraytracing_tpu_torch.ops import fused_trace as ft

    sk, sr = (ft.sums_to_stats(dict(zip(ft.STATS_FIELDS, np.asarray(v))), opl_ref, distances)
              for v in (ker, ref))
    rel_w = float(np.max(np.abs(ker[0] - ref[0]) / np.abs(ref[0])))
    spot = np.abs(sk["spot_sd"] - sr["spot_sd"])
    print(f"{tag}: sum w rel {rel_w:.3g}, spot SD {sk['spot_sd'][0]:.6g} vs {sr['spot_sd'][0]:.6g} mm at "
          f"{distances[0]:+.1f} mm (largest difference {spot.max():.3g} mm), duration "
          f"{sk['duration_sd'][0]:.6g} vs {sr['duration_sd'][0]:.6g} fs", flush=True)
    _check(rel_w <= 1e-5, f"{tag}: sum of weights differs by {rel_w} (rel)")
    _check(np.all(spot <= 2e-3 * sr["spot_sd"] + 1e-6), f"{tag}: spot SDs {sk['spot_sd']} vs {sr['spot_sd']}")
    for d_k, d_r in zip(sk["duration_sd"], sr["duration_sd"]):
        _check(abs(d_k - d_r) <= 0.025 * d_r or abs(d_k**2 - d_r**2) ** 0.5 <= 0.8,
               f"{tag}: duration SD {d_k} vs {d_r}")
    return float(spot.max())


def _deformed_main_path(torch, dev, kind):
    """The slice's path on the ``kind`` flagship ("zernike" or "grid"):
    main.main at 1e7 rays with the detector-distance optimizer, the launch
    counts set to 0 just before it: engine cuda-source, exactly one K1 and
    one K2 launch, no other kernel."""
    from attosecondraytracing_tpu_torch import main as art

    chain, props = _deformed_flagship(N_SLICE, kind=kind)
    do = {"ReflectionNumber": -1, "DistanceDetector": 500.0, "AutoDetectorDistance": True,
          "OptFor": "intensity"}
    ao = {"verbose": True, "save_results": False}
    _reset_launches()
    t0 = time.perf_counter()
    kept = art.main(chain, props, do, ao, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    transmission, det = kept["ETransmission"][0], kept["Detector"][0]
    spot, duration = kept["SpotSizeSD"][0], kept["DurationSD"][0]
    print(f"{kind} main path: engine {chain.last_trace_engine}, launches {launches}, transmission "
          f"{transmission:.6g} %, distance {det.get_distance():.6g} mm, spot SD {spot:.6g} mm, "
          f"duration SD {duration:.6g} fs, main.main wall {wall:.3f} s", flush=True)
    _check(chain.last_trace_engine == "cuda-source", f"{kind}: trace engine {chain.last_trace_engine}")
    _check(launches["K1"] == 1 and launches["K2"] == 1
           and all(v == 0 for k, v in launches.items() if k not in ("K1", "K2")),
           f"{kind} main path launches {launches}")
    _check(0 < transmission <= 100, f"{kind}: transmission {transmission}")
    _check(abs(det.get_distance() - 500.0) <= 25.0, f"{kind}: optimal distance {det.get_distance()}")
    _check(spot < 0.5, f"{kind}: spot SD {spot} mm")
    return launches


def _deformed_k12(torch, dev, kind, n_rays=N_TIME):
    """K1 and K2 against their plain versions on the ``kind`` flagship at
    ``n_rays`` rays, with ignore_defects True and False (phase k1's and k2's
    tolerances), and the defect slopes' effect on K1's directions and K2's
    spot SD (for "grid", on the same map at :data:`GRID_EFFECT_RMS`, whose
    kernels are held against their plain versions too). Returns the largest
    |dp| [mm] of K1 and spot SD difference [mm] of K2."""
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft

    chain, _ = _deformed_flagship(N_CHECK, kind=kind)
    spec, elements, det, (opl_ref, inv_dn), chunks, n = _k2_setup(torch, dev, chain, n_rays)
    bdet = ft.bake_detector(elements, det.centre, det.normal, det._plane_rotation(),
                            opl_ref=opl_ref, inv_dn_chief=inv_dn)
    tables = [(kind, ft.chain_table(spec, elements))]
    if kind == "grid":  # the same geometry, so the same detector
        rough = _deformed_flagship(16, kind=kind, grid=dict(GRID, RMS=GRID_EFFECT_RMS))[0].to(dev)
        tables.append((f"grid at {GRID_EFFECT_RMS * 1e6:.0f} nm", ft.chain_table(
            spec, rough.device_elements(torch.float64))))
    err1 = err2 = 0.0
    for tag, table in tables:
        dirs, spots = {}, {}
        for ignore in (True, False):
            ker = ft.fused_source_trace(table, spec, n, device=dev, ignore_defects=ignore)
            torch.cuda.synchronize()
            ref = ft.fused_source_trace_ref(table, spec, n, device=dev, ignore_defects=ignore)
            err1 = max(err1, _check_bundles(f"K1 {tag} flagship ignore_defects={ignore}", ker, ref, torch))
            dirs[ignore] = (ker, ref)
            kw = dict(device=dev, gaussian_edge=chain.source_spec.gaussian_edge, ignore_defects=ignore)
            k2 = ft.fused_source_moments(table, spec, bdet, chunks, n, **kw)
            r2 = ft.fused_source_moments_ref(table, spec, bdet, chunks, n, **kw)
            err2 = max(err2, _check_stats(f"K2 {tag} flagship ignore_defects={ignore} ({n} rays)", k2, r2,
                                          opl_ref, 1e-5, 2e-3, 0.025, 0.8))
            spots[ignore] = [float(ft.sums_to_stats(ft.moments_to_distance_sums(m, (0.0,)), opl_ref,
                                                    (0.0,))["spot_sd"][0]) for m in (k2, r2)]
        both = dirs[True][0].alive & dirs[False][0].alive & dirs[True][1].alive & dirs[False][1].alive
        effect_k = dirs[False][0].d[both] - dirs[True][0].d[both]
        effect_r = dirs[False][1].d[both] - dirs[True][1].d[both]
        effect = float(effect_k.abs().max())
        effect_err = float((effect_k - effect_r).abs().median())
        spot_move = abs(spots[False][0] - spots[True][0])
        spot_err = max(abs(spots[v][0] - spots[v][1]) for v in (True, False))
        print(f"{tag}: the defect slopes (ignore_defects=False) move K1's directions by up to {effect:.3g} "
              f"(median {float(effect_k.abs().median()):.3g}) on alive rays, the kernel's move against the "
              f"plain version's within {effect_err:.3g} (median); K2's spot SD at the detector "
              f"{spots[True][0]:.6g} -> {spots[False][0]:.6g} mm (kernel vs plain within {spot_err:.3g} mm)",
              flush=True)
    # The defect slopes must change what the kernels compute, by more than
    # their float32 error. The Zernike coefficients' slopes over the
    # support's 76.7 mm radius are ~1e-6 (the Pallas test's 20 mm parabola
    # at normal incidence reaches 1e-5), so directions move by up to ~2e-6
    # and by a float32 ulp on most rays, where the kernel's own per-ray
    # error is of that size: the check asks for a move of more than 1e-6
    # and holds K2's move of the spot SD to 100 times its error against the
    # plain version. The grid map at 100 nm must move the spot SD by more
    # than 10 times that error.
    factor = 100.0 if kind == "zernike" else 10.0
    _check(effect > 1e-6 and spot_move > factor * spot_err,
           f"{tag}: the defect slopes' effect {effect} / spot {spot_move} against the kernel's error "
           f"{effect_err} / {spot_err}")
    return err1, err2


def _deformed_k34(torch, dev, kind):
    """K4 on a user-built 2^20-ray PointSource bundle through the ``kind``
    flagship, and K3 on that bundle traced through the mask, then through
    the deformed toroid (ignore_defects False) and the second toroid, against
    their plain versions (K1's envelopes); both on a shuffled copy, on views
    off the 16-byte boundary and K3 on the bundle dead on entry
    (:func:`_k34_layouts`). Returns each kernel's largest |dp| [mm]."""
    import numpy as np

    from attosecondraytracing_tpu_torch.models import sources
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft
    from attosecondraytracing_tpu_torch.ops.bundle import RayBundle

    chain, _ = _deformed_flagship(16, kind=kind)
    host = [e.to_device("cpu", torch.float64) for e in chain.optical_elements]
    bundle = sources.ApplyGaussianIntensityToRayList(
        sources.PointSource(np.zeros(3), np.array([1.0, 0.0, 0.0]), 25e-3, N_CHECK, 80e-6), np.exp(-2.0))
    table = ft.chain_table(None, host)
    err4 = _check_bundles(f"K4 {kind} flagship (user PointSource)", ft.streamed_trace(table, bundle, device=dev),
                          ft.streamed_trace_ref(table, bundle, fresh=True, device=dev), torch)
    first = ft.streamed_trace(ft.chain_table(None, host[:1]), bundle, device=dev)
    mid = RayBundle(p=first.p, d=first.d, opl=first.opl, opl_c=first.opl_c, alive=first.alive,
                    intensity=bundle.intensity.to(dev, torch.float32), incidence=first.incidence,
                    wavelength=bundle.wavelength.to(dev, torch.float32))
    _check(not ft._is_fresh(mid), "the masked bundle must not be fresh")
    rest = ft.chain_table(None, host[1:])
    err3 = _check_bundles(f"K3 {kind} flagship (masked bundle -> deformed toroid -> toroid)",
                          ft.streamed_trace(rest, mid, device=dev, ignore_defects=False),
                          ft.streamed_trace_ref(rest, mid, fresh=False, device=dev, ignore_defects=False),
                          torch)
    views = _k34_layouts(f"{kind} flagship", torch, dev, [("K4", table, bundle.to(dev, torch.float32), True, True),
                                                          ("K3", rest, mid, False, False)])
    return max(err3, views["K3"]), max(err4, views["K4"])


def _deformed_k5(torch, dev, kind):
    """A 5-chain scan of the ``kind`` flagship (second toroid at 490-510
    mm; the chains share the first toroid's defects) at 2^20 rays per chain:
    main.main takes the scan engine (K5 once per chain, no K1 or K2), and
    each chain's K5 against its plain version (phase k5's tolerances).
    Returns the largest spot SD difference [mm]."""
    from attosecondraytracing_tpu_torch import main as art
    from attosecondraytracing_tpu_torch.ops import fused_scan as fs

    chains, props = _deformed_flagship(N_CHECK, [490.0, 495.0, 500.0, 505.0, 510.0], kind=kind)
    do = {"ReflectionNumber": -1, "DistanceDetector": 500.0, "AutoDetectorDistance": True,
          "OptFor": "spotsize"}
    _reset_launches()
    kept = art.main(chains, props, do, {"verbose": False, "save_results": False}, device=dev)
    launches = _launches()
    engines = [c.last_trace_engine for c in chains]
    print(f"{kind} scan of {len(chains)} chains at {N_CHECK} rays: engines {sorted(set(engines))}, "
          f"launches {launches}, optimal distances "
          f"{[round(d.get_distance(), 3) for d in kept['Detector']]} mm", flush=True)
    _check(all(e == "cuda-scan" for e in engines) and launches["K5"] == len(chains)
           and launches["K1"] == 0 and launches["K2"] == 0, f"{kind} scan: {engines} {launches}")
    spot_err = 0.0
    for i, chain in enumerate(chains):
        spec, elements, det, (opl_ref, inv_dn), chunks, n = _k2_setup(torch, dev, chain, N_CHECK)
        sspec = fs.make_scan_spec(spec.kind, elements, n)
        svec = fs.scan_chain_scalars(elements, spec.rot, spec.origin, det.centre, det.normal,
                                     det._plane_rotation())
        aux = fs.scan_aux(chunks, opl_ref, inv_dn, 0.0, spec.radius, chain.source_spec.gaussian_edge)
        ker = fs.fused_scan_moments(sspec, svec, aux, chunks, device=dev)
        ref = fs.scan_moments_ref(sspec, svec, aux, chunks, device=dev)
        spot_err = max(spot_err, _check_stats(f"K5 {kind} scan chain {i}", ker, ref, opl_ref,
                                              1e-5, 2e-3, 0.025, 0.8))
    return spot_err


def _k6_rows(problem, tag, dev, ignores=(True, False)):
    """K6's 18 tangent rows of one launch against stats_params_ref on the
    fused loss ``problem`` (:func:`_grad_problem`), with each of
    ``ignores``: ignore_defects True (gradient_align's) and False (the
    defect slopes in the normals: their tangents are the Hessian's rows and
    the slope maps' cell derivatives). The sums, each statistic's tangents
    within 2e-3 of its largest (the delay's within 2e-2), the loss rel 2e-3
    and the gradient within 2e-2 (phase k67's tolerances). Returns
    {ignore_defects: (K6's primal, K6's rows, the plain version's rows)}
    and, under "err", the gradient's largest difference with the first of
    ``ignores``."""
    import numpy as np

    from attosecondraytracing_tpu_torch.ops import fused_grad as fg
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft

    spec, host, geo, params, _ = problem
    svec = fg.chain_scalars_np(fg._apply_params_np(host, params), *geo)
    tang = fg.scalar_tangents(host, params, *geo)
    chunks = fg._ray_chunks(spec, fg.GRAD_CHUNK)
    out = {}
    for ignore in ignores:
        ispec = spec._replace(ignore_defects=ignore)
        _reset_launches()
        p_i, t_i = fg.fused_stats_params(ispec, svec, tang, chunks, device=dev)
        _check(_launches()["K6"] == 1 and tang.shape[0] == 18, f"{tag}: {_launches()}, {tang.shape}")
        p_ir, t_ir = fg.stats_params_ref(ispec, svec, tang, chunks, device=dev)
        itag = f"{tag}, ignore_defects {ignore}"
        _check_grad_sums(f"{itag} (18 tangent rows in one launch)", p_i, p_ir, spec.opl_ref)
        scale = np.maximum(np.abs(t_ir).max(axis=0), 1e-12)
        per_stat = (np.abs(t_i - t_ir) / scale).max(axis=0)
        print(f"{itag}: the 18 tangent rows within " + ", ".join(
            f"{f} {v:.3g}" for f, v in zip(ft.STATS_FIELDS, per_stat)) + " of each statistic's largest",
            flush=True)
        _check(np.all(np.isfinite(t_i)) and per_stat[:5].max() <= 2e-3 and per_stat[5:].max() <= 2e-2,
               f"{itag}: tangents differ by {per_stat}")
        loss_k, dloss = fg._loss_from_stats(p_i, ispec, fg._total_weight(ispec))
        loss_r, dloss_r = fg._loss_from_stats(p_ir, ispec, fg._total_weight(ispec))
        g_k, g_r = t_i @ dloss, t_ir @ dloss_r
        print(f"{itag}: loss {loss_k:.9g} vs {loss_r:.9g}, gradient max |diff| "
              f"{np.abs(g_k - g_r).max():.3g} of max |g| {np.abs(g_r).max():.3g}", flush=True)
        _check(abs(loss_k - loss_r) <= 2e-3 * abs(loss_r), f"{itag}: loss {loss_k} vs {loss_r}")
        _check(np.all(np.abs(g_k - g_r) <= 2e-2 * np.abs(g_r).max() + 2e-2 * np.abs(g_r)),
               f"{itag}: gradient {g_k} vs {g_r}")
        out[ignore] = (p_i, t_i, t_ir)
        out.setdefault("err", float(np.abs(g_k - g_r).max()))
    return out


def _k6_effect(torch, dev, kind):
    """The defects' share of K6's tangent rows against the plain version's:
    the undeformed flagship at 2^20 rays (its detector placed by the probe
    trace) and, on the same detector, the flagship deformed at the effect
    sizes (``kind`` "zernike": :data:`ZERNIKE_K6_EFFECT`; "grid":
    :data:`GRID_K6_EFFECT`, then both on one mirror, "mixed"), each checked
    as :func:`_k6_rows` checks. Three differences per deformed chain: its
    rows with ignore_defects True minus the undeformed rows ("T"), the same
    with False ("F"), and its rows with False minus those with True
    ("F-T"). Each statistic's column is divided by the undeformed rows'
    largest; for each statistic the difference moves, the largest gap
    between K6's difference and the plain version's over the 18 rows must
    stay within :data:`K6_EFFECT_REL` of the plain version's largest.
    Returns {chain: {difference: {"gap": the largest such ratio, "moved":
    the statistics the difference moves, "size": its largest}}}."""
    import numpy as np

    from attosecondraytracing_tpu_torch.ops import fused_trace as ft

    base = _grad_problem(torch, dev, _flagship(N_CHECK)[0], N_CHECK, _bench_misalignment)
    b = _k6_rows(base, "K6 flagship (the effect check's undeformed chain)", dev, ignores=(True,))[True]
    scale = np.maximum(np.abs(b[2]).max(axis=0), 1e-12)
    chains = {"zernike": [("zernike", {"zernike": ZERNIKE_K6_EFFECT})],
              "grid": [("grid", {"grid": GRID_K6_EFFECT}),
                       ("mixed", {"zernike": ZERNIKE_K6_EFFECT, "grid": GRID_K6_EFFECT})]}[kind]
    out = {}
    for name, sizes in chains:
        chain = _deformed_flagship(N_CHECK, kind=name, **sizes)[0]
        tag = f"K6 {name} flagship at the effect sizes"
        r = _k6_rows(_grad_problem(torch, dev, chain, N_CHECK, _bench_misalignment, det=base[4]), tag, dev)
        diffs = {"T": (r[True][1] - b[1], r[True][2] - b[2]), "F": (r[False][1] - b[1], r[False][2] - b[2]),
                 "F-T": (r[False][1] - r[True][1], r[False][2] - r[True][2])}
        out[name] = {}
        for d, (dk, dr) in diffs.items():
            size = np.abs(dr / scale).max(axis=0)
            moved = size > 0
            rel = np.abs((dk - dr) / scale).max(axis=0)[moved] / size[moved]
            print(f"{tag}: {d} difference, per statistic the plain version's largest (of the undeformed "
                  "rows' largest) and K6's largest gap from it (of that): " + ", ".join(
                      f"{f} {v:.3g} / {e:.3g}" for f, v, e in zip(np.asarray(ft.STATS_FIELDS)[moved],
                                                                   size[moved], rel)), flush=True)
            _check(np.all(np.isfinite(dk)) and moved.any() and rel.max() <= K6_EFFECT_REL,
                   f"{tag}: the {d} difference's gaps {rel} (bound {K6_EFFECT_REL})")
            out[name][d] = {"gap": float(rel.max()) if moved.any() else None, "moved": int(moved.sum()),
                            "size": float(size.max())}
    return out


def _deformed_k678(torch, dev, kind):
    """K6's 18 tangent rows of one launch against stats_params_ref with
    ignore_defects True and False (:func:`_k6_rows`), K7 against its plain
    version and equal to K6's primal, and K8 at 20 distances against its
    plain version and against K2's moments, all on the ``kind`` flagship at
    2^20 rays (phases k67's and k8's tolerances).
    Returns the (K6 gradient with ignore_defects True, K7 loss, K8 spot SD)
    differences."""
    import numpy as np

    from attosecondraytracing_tpu_torch.ops import fused_grad as fg
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft

    chain, _ = _deformed_flagship(N_CHECK, kind=kind)
    problem = _grad_problem(torch, dev, chain, N_CHECK, _bench_misalignment)
    spec, host, geo, params, _ = problem
    svec = fg.chain_scalars_np(fg._apply_params_np(host, params), *geo)
    chunks = fg._ray_chunks(spec, fg.GRAD_CHUNK)
    rows = _k6_rows(problem, f"K6 {kind} flagship", dev)
    p_k, err6 = rows[True][0], rows["err"]
    p7, _ = fg.fused_stats_params(spec, svec, None, chunks, device=dev)
    p7_r, _ = fg.stats_params_ref(spec, svec, None, chunks, device=dev)
    _check_grad_sums(f"K7 {kind} flagship", p7, p7_r, spec.opl_ref)
    _check_grad_sums(f"K7 vs K6 primal {kind} flagship", p7, p_k, spec.opl_ref)
    err7 = _check_focus_loss(f"K7 {kind} flagship", fg, params, spec, host, geo, p7_r, dev)

    spec8, elements, det, (opl_ref, inv_dn), chunks8, n = _k2_setup(torch, dev, chain, N_CHECK)
    table = ft.chain_table(spec8, elements)
    distances = tuple(float(d) for d in np.linspace(-10, 10, 20))
    bdet = ft.bake_detector(elements, det.centre, det.normal, det._plane_rotation(), opl_ref=opl_ref,
                            inv_dn_chief=inv_dn, distances=distances,
                            delay_offsets=tuple(-d * inv_dn for d in distances))
    edge = chain.source_spec.gaussian_edge
    _reset_launches()
    k8 = ft.fused_source_stats(table, spec8, bdet, chunks8, n, device=dev, gaussian_edge=edge)
    _check(_launches()["K8"] == 1, f"K8 {kind}: {_launches()}")
    r8 = ft.fused_source_stats_ref(table, spec8, bdet, chunks8, n, device=dev, gaussian_edge=edge)
    err8 = _check_sum_stats(f"K8 J=20 {kind} flagship vs plain", k8, r8, opl_ref, distances)
    mom = ft.fused_source_moments(table, spec8, bdet._replace(distances=(0.0,), delay_offsets=(0.0,)),
                                  chunks8, n, device=dev, gaussian_edge=edge)
    k2 = ft.moments_to_distance_sums(mom, distances)
    _check_sum_stats(f"K8 J=20 {kind} flagship vs K2 moments", k8,
                     np.stack([k2[f] for f in ft.STATS_FIELDS]), opl_ref, distances)
    return err6, err7, err8


def _kernel_launches(torch, dev, chain):
    """Prepared launch-only calls of K1-K8 on ``chain`` (the flagship or a
    deformed twin) at 1e7 rays, each with its bound: {kernel: (launch,
    bound)}. K1, K2, K5, K7 and K8 (20 distances) as their phases prepare
    them on the flagship; K6 one gradient step (18 rows); K4 and K3 on a
    fresh 1e7-ray bundle of the flagship's source through the chain's
    lab-frame table, and on a shuffled copy of it ("K4_shuffled",
    "K3_shuffled"). A grid map's bytes join each bound (utils/kernel_ab.grid_bytes)."""
    import numpy as np

    from attosecondraytracing_tpu_torch.ops import fused_grad as fg
    from attosecondraytracing_tpu_torch.ops import fused_scan as fs
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft
    from attosecondraytracing_tpu_torch.utils import kernel_ab as ab

    spec, elements, det, (opl_ref, inv_dn), chunks, n = _k2_setup(torch, dev, chain, N_TIME)
    edge = chain.source_spec.gaussian_edge
    table = ft.chain_table(spec, elements)
    grid_bytes = ab.grid_bytes(table.elements, n)
    outs, k1 = ft.prepare_fused_source_trace(table, spec, n, device=dev)
    k1()
    n_alive = int(outs.alive.sum())
    trace_ops = _trace_ops(table, True)
    alive = ab.alive_by_stage(table, spec, chunks, n, dev)
    out = {"K1": (k1, _bound(37 * n + grid_bytes, (trace_ops + OPS["store"]) * n))}
    bdet = ft.bake_detector(elements, det.centre, det.normal, det._plane_rotation(), opl_ref=opl_ref,
                            inv_dn_chief=inv_dn)
    rows, k2 = ft.prepare_fused_source_moments(table, spec, bdet, chunks, n, device=dev, gaussian_edge=edge)
    out["K2"] = (k2, _bound(rows.numel() * 8 + 8 * len(chunks) + grid_bytes,
                            _ops_where_rays_die(table, alive, OPS["weight"] + OPS["moments"])))
    host = [e.to_device("cpu", torch.float64) for e in chain.optical_elements]
    lab = ft.chain_table(None, host)
    bundle = ft.source_bundle(spec, n, device=dev)
    shuffled = ab.permuted(bundle, ab.shuffle_order(n, dev))
    for key, fresh in (("K4", True), ("K3", False)):
        bound = _bound((61 if fresh else 74) * n + grid_bytes, (_trace_ops(lab, False) + OPS["store"]) * n)
        for tag, rays in ((key, bundle), (f"{key}_shuffled", shuffled)):
            _, launch = ft.prepare_streamed_trace(lab, rays, fresh=fresh, device=dev)
            out[tag] = (launch, bound)
    sspec = fs.make_scan_spec(spec.kind, elements, n)
    svec = fs.scan_chain_scalars(elements, spec.rot, spec.origin, det.centre, det.normal,
                                 det._plane_rotation())
    aux = fs.scan_aux(chunks, opl_ref, inv_dn, 0.0, spec.radius, edge)
    rows, k5 = fs.prepare_scan_moments(sspec, svec, aux, chunks, device=dev)
    table5 = fg.pose_table(sspec.elements, svec)
    out["K5"] = (k5, _bound(rows.numel() * 8 + 4 * (svec.size + aux.size) + grid_bytes,
                            _ops_where_rays_die(table5, ab.alive_by_stage(table5, spec, chunks, n, dev),
                                                OPS["weight"] + OPS["moments"])))
    lspec, lhost, geo, params, _ = _grad_problem(torch, dev, chain, n, _bench_misalignment)
    gsvec = fg.chain_scalars_np(fg._apply_params_np(lhost, params), *geo)
    tang = fg.scalar_tangents(lhost, params, *geo)
    gchunks = fg._ray_chunks(lspec, fg.GRAD_CHUNK)
    table7 = fg.pose_table(lspec.elements, gsvec)
    per_ray = _trace_ops(table7, True) + OPS["weight"]
    alive7, warps7 = ab.alive_by_stage(table7, fg.loss_source(lspec), gchunks, lspec.n_rays, dev,
                                     warps=True)
    for key, group in (("K6", tang), ("K7", None)):
        rows, launch = fg.prepare_stats_params(lspec, gsvec, group, gchunks, device=dev)
        n_in = gsvec.size
        if group is not None:
            P = len(group)
            ops = per_ray * n + OPS["stats"] * n_alive
            ops += (OPS["dual_trace_once"] + P * OPS["dual_trace_tangent"]
                    + _dual_defect_ops(lspec.elements, P)) * n
            ops += (OPS["dual_stats_once"] + P * OPS["dual_stats_tangent"]) * n_alive
            n_in += group.size
            # K6's warp passes through each stage: every group retraces the primal
            out["K6_stage_warps"] = {k: v * rows.shape[0]
                                     for k, v in ab.stage_warps(table7, warps7, rows.shape[1]).items()}
        else:
            ops = _ops_where_rays_die(table7, alive7, OPS["weight"] + OPS["stats"])
        out[key] = (launch, _bound(rows.numel() * 8 + 4 * n_in + 8 * len(gchunks) + grid_bytes, ops))
    distances = tuple(float(d) for d in np.linspace(-10, 10, 20))
    bdet20 = ft.bake_detector(elements, det.centre, det.normal, det._plane_rotation(), opl_ref=opl_ref,
                              inv_dn_chief=inv_dn, distances=distances,
                              delay_offsets=tuple(-d * inv_dn for d in distances))
    rows, k8 = ft.prepare_fused_source_stats(table, spec, bdet20, chunks, n, device=dev, gaussian_edge=edge)
    out["K8"] = (k8, _bound(rows.numel() * 8 + 8 * len(chunks) + 8 * 20 + grid_bytes,
                            _ops_where_rays_die(table, alive, OPS["weight"] + OPS["stats_geometry"]
                                                + 20 * OPS["stats_distance"])))
    return out


def _deformed_grad_align(torch, dev, kind):
    """gradient_align on the ``kind`` flagship at 1e7 rays, its first toroid
    rolled 0.3 deg as phase grad rolls the flagship's, lr 2e-4, survival
    weight 0.1, 12 Adam steps, engine "auto", the launch counts set to 0
    just before it: the engine must be cuda-grad, K6 launched once per step
    and no other kernel, every loss finite. Returns {"launches", "ms_per_step",
    "loss_first", "loss_last"}."""
    import numpy as np

    from attosecondraytracing_tpu_torch.analysis import alignment as al
    from attosecondraytracing_tpu_torch.models.detector import Detector

    chain, _ = _deformed_flagship(N_GRAD, kind=kind)
    chain.to(dev)
    chain.rotate_OE(1, "roll", 0.3)
    det = Detector(chain.optical_elements[-1].position)
    det.autoplace(chain.trace_final(), 500.0)
    _check(chain.fused_eligible(), f"the {kind} flagship at {N_GRAD} rays must be fused-eligible")
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _params, history = al.gradient_align(chain, det, iters=GRAD_ITERS, lr=2e-4, survival_weight=0.1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    ms = wall / GRAD_ITERS * 1e3
    print(f"grad {kind}: gradient_align engine {al.gradient_align.last_engine}, launches {launches}, "
          f"{GRAD_ITERS} steps in {wall:.3f} s ({ms:.3f} ms per step), loss {history[0]:.6g} -> "
          f"{history[-1]:.6g}", flush=True)
    _check(al.gradient_align.last_engine == "cuda-grad", f"{kind} engine {al.gradient_align.last_engine}")
    _check(launches["K6"] == GRAD_ITERS and all(v == 0 for k, v in launches.items() if k != "K6"),
           f"{kind} gradient_align launches {launches}")
    _check(len(history) == GRAD_ITERS and np.all(np.isfinite(history)), f"{kind} losses {history}")
    return {"launches": launches["K6"], "ms_per_step": ms, "loss_first": float(history[0]),
            "loss_last": float(history[-1])}


def _k6_sass(kind, stage_warps) -> dict:
    """K6's ``kind`` instantiation in this build: ptxas's registers, stack
    frame and spills (the build log), its SASS by stage with the
    local-memory loads and stores of each (utils/kernel_ab.sass_stages),
    and the issue-slot bound of a launch's warp passes through the stages
    (``stage_warps``) at the card's clocks.max.sm. Keys prefixed by
    ``kind``."""
    from attosecondraytracing_tpu_torch.ops import _cuda
    from attosecondraytracing_tpu_torch.utils import kernel_ab as ab

    name = f"stats_params_kernel<{_cuda.tangent_batch()}{'' if kind == 'flat' else ', ' + kind}>"
    ptxas = ab.ptxas_fields(_cuda.build_log_path().read_text()).get(name, {})
    out = {f"{kind}_{k}": v for k, v in ptxas.items()}
    try:
        stages, local = ab.sass_stages(_cuda.library()._name, ab.k6_kernel(_cuda.tangent_batch(), kind),
                                       local=True)
        bound = ab.issue_bound(stages, stage_warps, ab.clock_hz())
    except (OSError, RuntimeError, ValueError, subprocess.CalledProcessError) as exc:
        print(f"K6 {kind} SASS by stage not measured ({exc})", flush=True)
        return dict(out, **{f"{kind}_sass": f"not measured ({exc})"})
    print(f"K6 {kind} ({name}): ptxas {ptxas}\n" + ab.stages_text(f"K6 {kind}", stages, local)
          + f"\nK6 {kind}: issue-slot bound " + ", ".join(f"{p} {v:.4f}" for p, v in bound.items())
          + " ms (per pipe: its lanes)", flush=True)
    return dict(out, **{f"{kind}_local_memory": local, f"{kind}_issue_ms": bound["issue"]})


def _deformed_phase(torch, dev, kind):
    """Surface defects of ``kind`` ("zernike" or "grid") through the slice's
    path and every kernel: the main path on the deformed flagship
    (:func:`_deformed_main_path`), each kernel against its plain version on
    the deformed chain (:func:`_deformed_k12`, :func:`_deformed_k34`,
    :func:`_deformed_k5`, :func:`_deformed_k678`), the defects' share of
    K6's rows (:func:`_k6_effect`), then each kernel's
    launch-only time on the deformed flagship at 1e7 rays beside the
    undeformed flagship's, in turns (flagship, deformed, deformed,
    flagship). Returns ({kernel: the phase's numbers, keys prefixed by
    ``kind``}, the main path's launches)."""
    launches = _deformed_main_path(torch, dev, kind)
    grad_align = _deformed_grad_align(torch, dev, kind)
    err1, err2 = _deformed_k12(torch, dev, kind)
    err3, err4 = _deformed_k34(torch, dev, kind)
    err5 = _deformed_k5(torch, dev, kind)
    err6, err7, err8 = _deformed_k678(torch, dev, kind)
    effect = _k6_effect(torch, dev, kind)
    errs = {"K1": err1, "K2": err2, "K3": err3, "K4": err4, "K5": err5, "K6": err6, "K7": err7, "K8": err8}
    flat = _kernel_launches(torch, dev, _flagship(N_CHECK)[0])
    deformed = _kernel_launches(torch, dev, _deformed_flagship(N_CHECK, kind=kind)[0])
    out = {}
    for key in sorted(errs):
        reps, inner = (3, 3) if key == "K6" else (5, 5)
        t_flat = _time_ms(flat[key][0], torch, reps=reps, inner=inner)
        t_def = _time_ms(deformed[key][0], torch, reps=reps, inner=inner)
        t_def2 = _time_ms(deformed[key][0], torch, reps=reps, inner=inner)
        t_flat2 = _time_ms(flat[key][0], torch, reps=reps, inner=inner)
        ms, flat_ms = (t_def + t_def2) / 2, (t_flat + t_flat2) / 2
        bound = deformed[key][1]
        print(f"{key} at {N_TIME} rays: {kind} flagship {ms:.4f} ms, flagship {flat_ms:.4f} ms "
              f"(ratio {ms / flat_ms:.4f}); {kind} bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}), flagship bound {flat[key][1]['bound_ms']:.4f} ms; kernel vs plain "
              f"on the {kind} chain {errs[key]:.3g}", flush=True)
        out[key] = {f"{kind}_ms": ms, f"{kind}_flat_ms": flat_ms, f"{kind}_bound_ms": bound["bound_ms"],
                    f"{kind}_bound_by": bound["bound_by"], f"{kind}_max_abs_err": errs[key]}
    for key in ("K3", "K4"):  # the same bundles shuffled: the warps' rays die apart
        shuffled = f"{key}_shuffled"
        t_flat = _time_ms(flat[shuffled][0], torch)
        t_def = _time_ms(deformed[shuffled][0], torch)
        t_def2 = _time_ms(deformed[shuffled][0], torch)
        t_flat2 = _time_ms(flat[shuffled][0], torch)
        ms, flat_ms = (t_def + t_def2) / 2, (t_flat + t_flat2) / 2
        print(f"{key} at {N_TIME} rays, shuffled bundle: {kind} flagship {ms:.4f} ms, flagship {flat_ms:.4f} ms "
              f"(in its spiral order: {out[key][f'{kind}_ms']:.4f} / {out[key][f'{kind}_flat_ms']:.4f} ms)",
              flush=True)
        out[key].update({f"{kind}_shuffled_ms": ms, f"{kind}_shuffled_flat_ms": flat_ms})
    out["K6"].update({f"{kind}_grad_align": grad_align, f"{kind}_effect": effect},
                     **_k6_sass(kind, deformed["K6_stage_warps"]))
    return out, launches


def phase_zernike(torch, dev):
    """Zernike surface defects through the slice's path and every kernel
    (:func:`_deformed_phase` on the Zernike-deformed flagship)."""
    return _deformed_phase(torch, dev, "zernike")


def _config_deformed(torch, dev):
    """examples/CONFIG_deformed.py (a parabola with a Fourier-PSD map of
    8000 x 8000 nodes, 1 GB packed) at --rays 1e7 through the port's CLI,
    the launch counts set to 0 just before it: exactly one K1 launch and no
    other kernel; then the plain trace (engine "trace") of the same loaded
    chain on the card, summarized at the CLI's detector: transmission within
    0.05 %, spot SD 1e-3 relative, duration SD 1e-2 relative (the CLI
    envelopes of phase cli). Then K1's launch alone on the loaded chain
    beside the same chain without its map, in turns. Returns {"ms",
    "flat_ms"} of those launches."""
    from attosecondraytracing_tpu_torch.analysis import stats
    from attosecondraytracing_tpu_torch.main import run_config_file
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft

    _reset_launches()
    t0 = time.perf_counter()
    kept = run_config_file(str(ROOT / "examples" / "CONFIG_deformed.py"), n_rays=N_CONFIG_DEFORMED,
                           device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    chain, det = kept["OpticalChain"][0], kept["Detector"][0]
    tg, sg, dg = kept["ETransmission"][0], kept["SpotSizeSD"][0], kept["DurationSD"][0]
    print(f"CONFIG_deformed.py --rays {N_CONFIG_DEFORMED}: engine {chain.last_trace_engine}, launches "
          f"{launches}, run_config_file wall {wall:.3f} s (the map's synthesis included)", flush=True)
    _check(chain.last_trace_engine == "cuda-source" and launches["K1"] == 1
           and all(v == 0 for k, v in launches.items() if k != "K1"),
           f"CONFIG_deformed: engine {chain.last_trace_engine}, launches {launches}")
    t0 = time.perf_counter()
    ref = chain.trace_final(engine="trace")
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    tr = stats.energy_transmission(chain.source_rays, ref)
    sr, dr = (float(v) for v in det.get_SpotAndDuration(ref))
    print(f"CONFIG_deformed.py at {N_CONFIG_DEFORMED} rays: K1 T {tg:.6g} % spot {sg:.6g} mm duration "
          f"{dg:.6g} fs; plain trace T {tr:.6g} % spot {sr:.6g} mm duration {dr:.6g} fs "
          f"(plain trace {t_plain:.3f} s)", flush=True)
    _check(abs(tg - tr) <= 0.05, f"CONFIG_deformed: transmission {tg} vs {tr}")
    _check(abs(sg - sr) <= 1e-3 * abs(sr), f"CONFIG_deformed: spot SD {sg} vs {sr}")
    _check(abs(dg - dr) <= 1e-2 * abs(dr), f"CONFIG_deformed: duration SD {dg} vs {dr}")
    spec, n = chain.source_spec.baked(), chain.source_spec.n_rays
    table = ft.chain_table(spec, [e.to_device("cpu", torch.float64) for e in chain.optical_elements])
    bare = table._replace(elements=tuple(el._replace(defects=()) if getattr(el, "defects", ()) else el
                                         for el in table.elements))
    launches = {"ms": ft.prepare_fused_source_trace(table, spec, n, device=dev)[1],
                "flat_ms": ft.prepare_fused_source_trace(bare, spec, n, device=dev)[1]}
    times = {key: [] for key in launches}
    for key in ("flat_ms", "ms", "ms", "flat_ms"):
        times[key].append(_time_ms(launches[key], torch))
    out = {key: sum(v) / 2 for key, v in times.items()}
    print(f"CONFIG_deformed.py K1 launch at {n} rays: {out['ms']:.4f} ms with its map (1 GB packed, in HBM), "
          f"{out['flat_ms']:.4f} ms without it", flush=True)
    return out


def phase_grid(torch, dev):
    """Grid defect maps through the slice's path and every kernel
    (:func:`_deformed_phase` on the grid flagship, :data:`GRID`), and
    examples/CONFIG_deformed.py at 1e7 rays through the CLI
    (:func:`_config_deformed`). Returns {kernel: the phase's numbers}, K1's
    with the CONFIG's launch times (``config_deformed_ms``,
    ``config_deformed_flat_ms``)."""
    out, _ = _deformed_phase(torch, dev, "grid")
    config = _config_deformed(torch, dev)
    out["K1"].update(config_deformed_ms=config["ms"], config_deformed_flat_ms=config["flat_ms"])
    return out


def phase_gather(torch, dev):
    """The gather probes P4 and P5 (utils/gather_probe.py): the probe's run
    at the script's shapes with the launch counts set to 0 just before it
    (every form and case once), each output against its plain version
    (gathers equal, bilinear within the script's 1e-5), the trace's lookup
    against its plain version on the grid flagship's map size, then
    launch-only times: each form and case, and the lookup over 1e7 points of
    three maps in two orders. Returns the JSON entries of P4 and P5."""
    from attosecondraytracing_tpu_torch.utils import cost_probe as cp
    from attosecondraytracing_tpu_torch.utils import gather_probe as gp

    gp.gather.launches = gp.take_along.launches = 0
    outs, (g, x, y, operands) = gp.probe(device=dev)
    torch.cuda.synchronize()
    launches = {"P4": gp.gather.launches, "P5": gp.take_along.launches}
    _check(launches == {"P4": 4, "P5": 4}, f"gather probe launches {launches}")
    err4 = 0.0
    forms = {}
    for form in gp.GATHER_FORMS:
        ref = gp.gather_ref(form, g, x, y)
        err = float((outs[form] - ref).abs().max())
        _check(err <= gp.ATOL if form == "bilinear" else err == 0.0, f"P4 {form}: differs by {err}")
        err4 = max(err4, err)
        ms = _time_ms(lambda: gp.gather(form, g, x, y), torch)
        plain = _time_ms(lambda: gp.gather_ref(form, g, x, y), torch)
        # the launch alone on the card, queued behind a busy stream (utils/cost_probe.queued_us)
        device_ms = cp.queued_us(lambda: gp.gather(form, g, x, y)) * 1e-3
        forms[form] = {"ms": ms, "plain_ms": plain, "max_abs_err": err, "device_ms": device_ms}
        print(f"P4 {form}: max |kernel - plain| {err:.3g}, {ms:.4f} ms per wrapper call, {device_ms:.5f} ms "
              f"on the card alone, plain {plain:.4f} ms", flush=True)
    cases = {}
    for (name, shape, axis), op in zip(gp.TAKE_CASES, operands):
        _check(bool(torch.equal(outs[name], gp.take_along_ref(op, axis))), f"P5 {name}: differs")
        ms = _time_ms(lambda: gp.take_along(op, axis), torch)
        plain = _time_ms(lambda: gp.take_along_ref(op, axis), torch)
        device_ms = cp.queued_us(lambda: gp.take_along(op, axis)) * 1e-3
        cases[name] = {"ms": ms, "plain_ms": plain, "bytes": 8 * op.numel(), "device_ms": device_ms}
        print(f"P5 {name}: equal, {ms:.4f} ms per wrapper call, {device_ms:.5f} ms on the card alone, plain "
              f"{plain:.4f} ms", flush=True)
    grid = gp.random_grid((3000, 640), device=dev)
    px, py = gp.probe_points((3000, 640), N_CHECK, "spiral", device=dev)
    lookup_err = float((gp.lookup(grid, px, py) - gp.lookup_ref(grid, px, py)).abs().max())
    print(f"lookup (grid_sums) on 3000 x 640 at {N_CHECK} points: max |kernel - plain| {lookup_err:.3g}",
          flush=True)
    _check(lookup_err <= 1e-5, f"the trace's lookup differs from its plain version by {lookup_err}")
    del grid, px, py
    lookups = gp.lookup_timings(device=dev)
    for row in lookups:
        print(f"lookup {row['map']} ({row['map_mb']:.1f} MB packed), {row['order']} order: {row['ms']:.4f} ms "
              f"per {row['points']} points, {row['sectors_per_point']:.3f} sectors per point at "
              f"{gp.HBM_BYTES_PER_S:.3g} B/s", flush=True)
    n_pts = x.numel()
    bil = forms["bilinear"]
    p4 = {"name": "P4 gather_forms (bilinear form; the four forms in forms)", "route": "cuda",
          "source": CSRC + "gather_probe.cu", "replaces": "scripts/exp_mosaic_gather.py:28",
          "launches": launches["P4"], "max_abs_err": err4, "ms": bil["ms"], "plain_ms": bil["plain_ms"],
          "device_ms": bil["device_ms"],
          # x, y in, the output out, four 4-byte corners per point
          **_bound(n_pts * (8 + 4 + 16), 19 * n_pts), "library_ms": None, "forms": forms,
          "lookup": lookups, "lookup_max_abs_err": lookup_err}
    big = cases["taa_axis0_512x128"]
    p5 = {"name": "P5 take_along (case taa_axis0_512x128; all four in cases)", "route": "cuda",
          "source": CSRC + "gather_probe.cu", "replaces": "scripts/exp_mosaic_gather.py:115",
          "launches": launches["P5"], "max_abs_err": 0.0, "ms": big["ms"], "plain_ms": big["plain_ms"],
          "device_ms": big["device_ms"],
          **_bound(big["bytes"], 0), "library_ms": None, "cases": cases}
    return [p4, p5]


def _image_chain(torch, dev, chain):
    """(source spec, float32 elements on the card, detector autoplaced at
    the focal distance behind the chain's K1 trace) of an image phase's
    chain."""
    from attosecondraytracing_tpu_torch.models.detector import Detector

    chain.to(dev)
    det = Detector(chain.optical_elements[-1].position)
    det.autoplace(chain.trace_final(), 500.0)
    return chain.source_spec, chain.device_elements(), det


def _blur3(a):
    import numpy as np
    from numpy.lib.stride_tricks import sliding_window_view

    return sliding_window_view(np.pad(a, 1), (3, 3)).sum(axis=(2, 3))


def _image_moments(img):
    """(centroids, variances) of an image in pixels, both axes."""
    import numpy as np

    gx, gy = np.meshgrid(np.arange(img.shape[0]), np.arange(img.shape[1]), indexing="ij")
    w = img.sum()
    mx, my = (img * gx).sum() / w, (img * gy).sum() / w
    return np.array([mx, my]), np.array([(img * (gx - mx) ** 2).sum() / w, (img * (gy - my) ** 2).sum() / w])


def _delay_diffs(a, b, min_weight=5.0):
    """|mean delay| differences [fs] of two images on the pixels where both
    are finite and the first holds more than ``min_weight``."""
    import numpy as np

    both = np.isfinite(a["mean_delay"]) & np.isfinite(b["mean_delay"]) & (a["weight_image"] > min_weight)
    return np.abs(a["mean_delay"] - b["mean_delay"])[both]


def _rebinned(res):
    """An image dict summed into :data:`PRECEDENT_BINS` blocks (weights and
    weight x mean delay), the block means re-formed."""
    import numpy as np

    bx, by = PRECEDENT_BINS

    def block(a):
        return a.reshape(bx, a.shape[0] // bx, by, a.shape[1] // by).sum(axis=(1, 3))

    w = res["weight_image"]
    wb = block(w)
    wdb = block(np.where(w > 0, np.nan_to_num(res["mean_delay"]) * w, 0.0))
    return dict(res, image=block(res["image"]), weight_image=wb,
                mean_delay=np.where(wb > 0, wdb / np.where(wb > 0, wb, 1.0), np.nan))


def _image_diffs(ker, ref):
    """Two images of one extent compared: the sum of weights (relative), the
    summed pixel differences (over the sum of weights), the centroids [px]
    and variances (relative), the mean delays [fs] on pixels of weight > 5
    (median, max), and on the images summed into :data:`PRECEDENT_BINS`
    blocks the summed differences and the mean delays on blocks of weight
    > 5 (max) and of more than the precedent's share of the weight
    (median, max)."""
    import numpy as np

    sum_w = ref["sum_w"]
    (c, v), (cr, vr) = _image_moments(ker["image"]), _image_moments(ref["image"])
    raw = _delay_diffs(ref, ker)
    kb, rb = _rebinned(ker), _rebinned(ref)
    block_weight = 5.0 * ref["n_total"] / PRECEDENT_RAYS
    blocks = _delay_diffs(rb, kb, block_weight)
    sparse = _delay_diffs(rb, kb)
    return {"sum_w_rel": float(abs(ker["sum_w"] - sum_w) / sum_w),
            "l1_rel": float(np.abs(ker["image"] - ref["image"]).sum() / sum_w),
            "centroid_px": float(np.abs(c - cr).max()), "variance_rel": float(np.abs(v / vr - 1).max()),
            "delay_pixels": int(raw.size), "delay_median_fs": float(np.median(raw)), "delay_max_fs": float(raw.max()),
            "block_l1_rel": float(np.abs(kb["image"] - rb["image"]).sum() / sum_w),
            "blocks_over_5": int(sparse.size), "block_over_5_delay_max_fs": float(sparse.max()),
            "block_weight": block_weight, "blocks": int(blocks.size),
            "block_delay_median_fs": float(np.median(blocks)), "block_delay_max_fs": float(blocks.max())}


def _pair_rays(stats, ker, ref, ny):
    """Add one chunk's rays of two ``(flat, w, delay)`` records (K1i's
    against another's, ``ops/fused_trace.image_rays_ref``) into ``stats``:
    rays counted by either, counted by one only, landing in the same pixel;
    per chunk the median and max of the pixel distance (the larger of the
    two axes' index differences) and of the |d delay| on rays counted by
    both, and the largest |d weight| (the largest kept over chunks)."""
    kf, kw, kd = ker
    rf, rw, rd = ref
    either, both = (kf >= 0) | (rf >= 0), (kf >= 0) & (rf >= 0)
    stats["rays"] += int(either.sum())
    stats["one_only"] += int((either & ~both).sum())
    stats["same_pixel"] += int((kf[either] == rf[either]).sum())
    stats["w_max"] = max(stats.get("w_max", 0.0), float((kw - rw).abs().max()))
    if int(both.sum()):
        k, r = kf[both].long(), rf[both].long()
        px = ((k // ny - r // ny).abs()).maximum((k % ny - r % ny).abs()).double()
        dd = (kd[both].double() - rd[both].double()).abs()
        for key, v in (("px_median", px.median()), ("px_max", px.max()), ("delay_median_fs", dd.median()),
                       ("delay_max_fs", dd.max())):
            stats[key] = max(stats.get(key, 0.0), float(v))


def _paired_records(torch, record, image_rec, sampled, edge, pairs):
    """A chunk tracer for ``gigascan._images`` (the plain image loop) that
    traces every chunk with K1's plain version, returns it (binned into the
    plain image) and holds K1i's per-ray ``record`` of the chunk against the
    plain rays' own (``image_rays_ref``, the same weights) in
    ``pairs["plain"]``. On the ``sampled`` chunks it also traces the chunk
    with K1 (launches not on the image's path) and holds K1i's record
    against K1's rays binned by the same float32 arithmetic
    (``pairs["k1"]``). The second chunk is also traced by the plain version
    at the first chunk's (phase, k_frac) with its weights:
    ``pairs["fault"]``, what a chunk-law fault reads; and by K1 alike:
    ``pairs["k1_fault"]``."""
    from attosecondraytracing_tpu_torch.analysis import gigascan as gs
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft

    ny = int(image_rec["ny"])

    def tracer(table, spec, chunk, n_total, *, device, ignore_defects):
        k1 = gs.k1_chunks(table, spec, chunk, n_total, device=device, ignore_defects=ignore_defects)
        plain = gs.plain_chunks(table, spec, chunk, n_total, device=device, ignore_defects=ignore_defects)
        laws = []

        def rays(out, n_local, phase, k_frac):
            w = ft.source_weights(spec, n_local, n_total, phase, k_frac, edge, device)
            return ft.image_rays_ref(out, w, image_rec)

        def trace_chunk(n_local, phase, k_frac):
            c = len(laws)
            laws.append((phase, k_frac))
            ker = tuple(x[c * chunk:c * chunk + n_local] for x in record[2:])
            ref = plain(n_local, phase, k_frac)
            _pair_rays(pairs["plain"], ker, rays(ref, n_local, phase, k_frac), ny)
            if c in sampled:
                _pair_rays(pairs["k1"], ker, rays(k1(n_local, phase, k_frac), n_local, phase, k_frac), ny)
            if c == 1:
                fault = plain(n_local, *laws[0])
                _pair_rays(pairs["fault"], ker, rays(fault, n_local, *laws[0]), ny)
                _pair_rays(pairs["k1_fault"], ker, rays(k1(n_local, *laws[0]), n_local, *laws[0]), ny)
            return ref

        return trace_chunk

    return tracer


def _check_records(tag, pairs, image_rec, extent):
    """K1i's per-ray record held ray by ray (:func:`_paired_records`).
    Against the plain path: rays counted by one only (alive and in the
    window) on at most 1e-4 of the rays, weights within 1e-6, the |d delay|
    median within 2 ulps of the float32 optical path in every chunk (as the
    K1 phase holds K1), and the pixel distance median within two ulps of the
    lab coordinate in pixels (at least one): the plain trace rounds its lab
    point otherwise (1.38 ulps per ray in the median, measured), so
    the pixels' equality is printed, not held. Against K1's rays binned by
    the same float32 arithmetic (``image_rays_ref`` on K1's outputs):
    rays counted by one only on at most 1e-4, weights within 1e-6, and the
    same pixel on at least 1 - 3e-3 of the rays. K1 and K1i trace from the
    same source, but nvcc contracts the trace's products into FMAs
    otherwise in the two kernels on 1.0 % of the flagship's alive rays
    (K1's are its earlier build's bit for bit; PERF.md §6): the same pixel
    reads 0.998836 on the flagship, 0.998781 on the grid flagship, 0.999883
    on the extended source, and 1.000000 against K1 built in K1i's form.
    The chunk-law fault must fail the plain limits, and traced by K1, the
    K1 limits. Returns the numbers."""
    import math

    import numpy as np

    from attosecondraytracing_tpu_torch.ops.precision import LIGHT_SPEED_MM_S

    pixel = float((1.0 / image_rec["scale"]).min())
    lab_ulp = float(np.spacing(np.float32(np.abs(image_rec["c"]).max())))
    opl_ulp_fs = float(np.spacing(np.float32(image_rec["opl_ref"]))) * 1e15 / LIGHT_SPEED_MM_S
    px_limit = max(1, math.ceil(2 * lab_ulp / pixel))
    out = {"pixel_mm": pixel, "lab_ulp_mm": lab_ulp, "opl_ulp_fs": opl_ulp_fs, "px_limit": px_limit}

    def rates(st):
        n = max(st["rays"], 1)
        return dict(st, one_only_rate=st["one_only"] / n, same_pixel_rate=st["same_pixel"] / n)

    def plain_ok(st):
        return (st["one_only_rate"] <= 1e-4 and st["w_max"] <= 1e-6
                and st.get("delay_median_fs", math.inf) <= 2 * opl_ulp_fs
                and st.get("px_median", math.inf) <= px_limit)

    def k1_ok(st):
        return (st["rays"] > 0 and st["one_only_rate"] <= 1e-4 and st["w_max"] <= 1e-6
                and st["same_pixel_rate"] >= 1 - 3e-3)

    names = dict(plain="the plain path", k1="K1 + the same binning", fault="a chunk-law fault",
                 k1_fault="a chunk-law fault traced by K1")
    for key in names:
        st = out[key] = rates(pairs[key])
        print(f"{tag} per ray vs {names[key]}"
              f": {st['rays']} rays counted, by one only {st['one_only_rate']:.3g}, same pixel "
              f"{st['same_pixel_rate']:.6f}, pixel distance median {st.get('px_median', float('nan')):.3g} max "
              f"{st.get('px_max', float('nan')):.3g} (limit {px_limit}: 2 ulps of {lab_ulp * 1e3:.4g} um over pixels of "
              f"{pixel * 1e3:.4g} um), |d w| max {st['w_max']:.3g}, |d delay| median "
              f"{st.get('delay_median_fs', float('nan')):.3g} fs max {st.get('delay_max_fs', float('nan')):.3g} fs "
              f"(ulp of the path {opl_ulp_fs:.3g} fs)", flush=True)
    _check(out["plain"]["rays"] > 0 and plain_ok(out["plain"]), f"{tag}: K1i's rays vs the plain path: {out['plain']}")
    _check(k1_ok(out["k1"]), f"{tag}: K1i's rays vs K1's binned alike (same pixel >= 1 - 3e-3): {out['k1']}")
    _check(not plain_ok(out["fault"]), f"{tag}: the chunk-law fault passes the per-ray check: {out['fault']}")
    _check(not k1_ok(out["k1_fault"]), f"{tag}: the chunk-law fault traced by K1 passes the K1 check: "
           f"{out['k1_fault']}")
    return out


def _check_kernel_images(tag, ker, ref):
    """Kernel vs plain images on one extent (:func:`_image_diffs`), held as
    tests/test_gigascan.py:55-97 holds the JAX package's two float32 image
    engines (K1 and its plain version are two float32 pipelines of one
    law): the sum of weights within 1e-5 (:37-39), the summed pixel
    differences below 20 % of it (:70), centroids within 0.05 px (:83) and
    variances within 1 %, all on the 512 x 512 pixels; the mean delays on
    64 x 64 blocks, the precedent's image size, holding more than its share
    of the rays' weight (5 per 16384 rays) within a median of 0.05 fs and a
    maximum of 0.5 fs (:37-49). At 512 x 512 a pixel (0.06 um on the image
    flagship) is finer than the float32 lab coordinate's ulp (0.12 um), so
    the two pipelines' rays mostly land in different pixels and a pixel's
    mean delay compares two samples of rays; summed into 64 x 64 blocks,
    rounding moves a ray out of its block about as often as the precedent's
    1e-3 mm noise moves one out of its 3.7 um pixel. A block of weight 5 in
    a 1e8-ray image averages a few rays' delay differences (per ray 0.2 fs
    in the median, up to ~3 fs): every ray's delay is held by
    :func:`_check_rays`. Returns the numbers."""
    d = _image_diffs(ker, ref)
    print(f"{tag}: sum w {ker['sum_w']:.9g} vs {ref['sum_w']:.9g}; " + ", ".join(
        f"{k} {v:.3g}" for k, v in d.items()), flush=True)
    _check(d["sum_w_rel"] <= 1e-5, f"{tag}: sum of weights differs by {d['sum_w_rel']} (rel)")
    _check(d["l1_rel"] < 0.2 and d["centroid_px"] < 0.05 and d["variance_rel"] < 0.01,
           f"{tag}: images differ: {d}")
    _check(d["blocks"] > 50 and d["block_delay_median_fs"] < 0.05 and d["block_delay_max_fs"] < 0.5,
           f"{tag}: mean delays differ: {d}")
    return d


def _shifted(res):
    """``res`` (an image dict) moved one pixel along x: what a systematic
    one-pixel fault reads in :func:`_image_diffs`."""
    import numpy as np

    return dict(res, image=np.roll(res["image"], 1, axis=0), weight_image=np.roll(res["weight_image"], 1, axis=0),
                mean_delay=np.roll(res["mean_delay"], 1, axis=0))


def _images_kernel_vs_plain(tag, torch, dev, spec, els, det, n_total, extent=None, ignore_defects=True):
    """K1i (one launch, the launch counts set to 0 just before it, its
    per-ray record of every chunk) against the plain image loop on the card
    on the kernel's extent (:func:`_check_kernel_images`), every chunk's
    rays against the plain path's and the first, a middle and the last
    chunk's against K1's (:func:`_paired_records`, :func:`_check_records`).
    Prints what a one-pixel shift of the plain image would read. Returns
    the numbers and the kernel's image."""
    from attosecondraytracing_tpu_torch.analysis import gigascan as gs
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft

    baked = spec.baked()
    chunks = ft.source_chunks(baked.kind, n_total, n_total, ft.CHUNK, n_each=baked.n_each,
                              n_sources=baked.n_sources)
    record = ft.image_record(0, len(chunks), chunks[0][0], device=dev)
    _reset_launches()
    ker = gs._images_k1i(spec, els, det, n_total, IMAGE_BINS, extent, ft.CHUNK, ignore_defects, dev,
                         record=record)
    launches = _launches()
    _check(launches["K1i"] == 1 and all(v == 0 for k, v in launches.items() if k != "K1i"),
           f"{tag}: launches {launches}, expected one K1i")
    job = gs._setup(spec, els, det, n_total, IMAGE_BINS, ker["extent"], ft.CHUNK, ignore_defects, dev)
    image_rec = ft.pack_image(job.det, job.window, job.bins)
    pairs = {key: {"rays": 0, "one_only": 0, "same_pixel": 0} for key in ("plain", "k1", "fault", "k1_fault")}
    sampled = {0, len(chunks) // 2, len(chunks) - 1}
    ref = gs._images(spec, els, det, n_total, IMAGE_BINS, ker["extent"], ft.CHUNK, ignore_defects, dev,
                     _paired_records(torch, record, image_rec, sampled, spec.gaussian_edge, pairs))
    del record
    tag = f"{tag} ({len(chunks)} chunks, one K1i launch) vs plain"
    rays = _check_records(tag, pairs, image_rec, ker["extent"])
    d = _check_kernel_images(tag, ker, ref)
    print(f"{tag}: the plain image moved one pixel along x would read " + ", ".join(
        f"{k} {v:.3g}" for k, v in _image_diffs(ker, _shifted(ref)).items()), flush=True)
    return dict(d, launches=launches["K1i"], rays=rays), ker


def phase_images(torch, dev):
    """Giga-ray images (analysis/gigascan.py) on the flagship with its second
    toroid rolled IMAGE_ROLL deg (examples/gigaray_delay_map.py), the
    detector autoplaced at the focal distance: fused_source_images at 1e9
    rays into 512 x 512 pixels with the launch counts set to 0 just before
    it (exactly one K1i launch, no other kernel), its wall, K1i's launch
    alone by CUDA events, the setup and the images' copy to the host, its
    plain version on the same image (image by image), and the K1 loop it
    replaced (one K1 launch per chunk, the chunks binned in plain PyTorch)
    on the same image in the same process; K1i vs its plain version at 1e8
    rays, ray by ray and image by image, and against the K1 loop; the 1e7-ray image against Detector.get_Image / get_DelayMap of the
    K1 bundle of the same spiral (tests/test_gigascan.py:127-185); K1i vs
    plain on the grid flagship at 1e8 rays (engine "xla-source",
    ignore_defects False) and on an extended source at 1e7 rays (chunks on
    whole sub-sources, the window on its whole beam). Returns K1i's JSON
    numbers and the K1 loop's."""
    import numpy as np

    from attosecondraytracing_tpu_torch.analysis import gigascan as gs
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft
    from attosecondraytracing_tpu_torch.ops.bundle import RayBundle
    from attosecondraytracing_tpu_torch.utils import kernel_ab as ab

    chain, _ = _flagship(N_CHECK)
    chain.rotate_OE(2, "roll", IMAGE_ROLL)
    spec, els, det = _image_chain(torch, dev, chain)
    n_chunks = -(-N_IMAGE // ft.CHUNK)
    _reset_launches()
    t0 = time.perf_counter()
    res = gs.fused_source_images(spec, els, det, n_total=N_IMAGE, bins=IMAGE_BINS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    d = res["mean_delay"]
    finite = np.isfinite(d)
    gmean = float((d[finite] * res["weight_image"][finite]).sum() / res["weight_image"][finite].sum())
    print(f"images {N_IMAGE} rays into {IMAGE_BINS}: launches {launches}, wall {wall:.3f} s, "
          f"{N_IMAGE / wall:.4g} rays/s, sum w {res['sum_w']:.9g}, extent {res['extent'][0]} .. "
          f"{res['extent'][1]} mm, delay map {np.nanmin(d):.4g} .. {np.nanmax(d):.4g} fs on "
          f"{int(finite.sum())} pixels (weighted mean {gmean:.3g} fs)", flush=True)
    _check(launches["K1i"] == 1 and all(v == 0 for k, v in launches.items() if k != "K1i"),
           f"images: launches {launches}, expected one K1i")
    _check(np.isfinite(res["sum_w"]) and res["sum_w"] > 0 and res["image"].shape == IMAGE_BINS
           and abs(res["image"].sum() - res["sum_w"]) <= 1e-9 * res["sum_w"], "images: image and sum of weights")
    _check(finite.sum() > 1000 and abs(gmean) < 1e-3, f"images: delay map ({finite.sum()} pixels, mean {gmean})")

    # K1i's launch alone, the setup, the images' copy to the host
    t0 = time.perf_counter()
    job = gs._setup(spec, els, det, N_IMAGE, IMAGE_BINS, None, ft.CHUNK, True, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    _check(len(job.chunks) == n_chunks == 120, f"images: {len(job.chunks)} chunks")
    launch = ft.prepare_fused_source_image(job.table, job.spec, job.chunks, job.n_total, job.det, job.window,
                                           job.bins, device=dev, gaussian_edge=job.edge)
    images = gs._zeros(job, dev)
    k1i_ms = _time_ms(lambda: launch(images), torch)
    t0 = time.perf_counter()
    for img in images:
        img.cpu()
    copy_s = time.perf_counter() - t0
    # the bound, counted where the rays die: the rays binned (the same
    # launch without weights) and the rays alive past each stage of the chain
    unit = gs._zeros(job, dev)
    ft.prepare_fused_source_image(job.table, job.spec, job.chunks, job.n_total, job.det, job.window, job.bins,
                                  device=dev)(unit)
    n_binned = float(unit[0].sum())
    alive = ab.alive_by_stage(job.table, job.spec, job.chunks, job.n_total, dev)
    bound = _bound(2 * 8 * IMAGE_BINS[0] * IMAGE_BINS[1] + 8 * n_chunks,
                   _ops_where_rays_die(job.table, alive, OPS["image"]) + OPS["weight"] * n_binned)
    print(f"images bound: rays alive entering / past the masks of each element, then at the end {alive}, "
          f"{n_binned:.6g} binned; {_trace_ops(job.table, True)} operations per ray traced to the end",
          flush=True)
    # the plain version on the same inputs (one call), held against the
    # image above on its window
    plain_job = gs._setup(spec, els, det, N_IMAGE, IMAGE_BINS, res["extent"], ft.CHUNK, True, dev)
    plain_images = gs._zeros(plain_job, dev)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    ft.fused_source_image_ref(plain_job.table, plain_job.spec, plain_job.chunks, plain_job.n_total, plain_job.det,
                              plain_job.window, plain_job.bins, plain_images, device=dev, gaussian_edge=plain_job.edge)
    stop.record()
    stop.synchronize()
    plain_ms = start.elapsed_time(stop)
    vs_plain = _check_kernel_images(f"images {N_IMAGE} ({n_chunks} chunks, one K1i launch) vs plain", res,
                                    gs._finish(plain_job, plain_images))
    del unit, plain_images, images

    # the loop K1i replaced: K1 per chunk, each chunk weighted and binned in plain PyTorch
    _reset_launches()
    t0 = time.perf_counter()
    loop = gs._images(spec, els, det, N_IMAGE, IMAGE_BINS, None, ft.CHUNK, True, dev, gs.k1_chunks)
    torch.cuda.synchronize()
    loop_wall = time.perf_counter() - t0
    loop_launches = _launches()
    _check(loop_launches["K1"] == n_chunks and loop_launches["K1i"] == 0, f"images: K1 loop {loop_launches}")
    vs_loop = _image_diffs(res, loop)
    print(f"images split: K1i launch alone {k1i_ms:.3f} ms ({k1i_ms * 1e-3 / wall * 100:.2f} % of the wall), "
          f"setup (chief ray, extent probe) {setup_s:.3f} s, the two images to the host {copy_s * 1e3:.2f} ms, "
          f"the rest {wall - setup_s - copy_s - k1i_ms * 1e-3:.3f} s; bound {bound['bound_ms']:.3f} ms "
          f"({bound['bound_by']}; {n_binned:.6g} rays binned), plain version {plain_ms:.1f} ms; the K1 loop "
          f"({loop_launches['K1']} K1 launches) wall {loop_wall:.3f} s ({loop_wall / wall:.3g}x K1i's wall); "
          f"K1i vs the K1 loop: " + ", ".join(f"{k} {v:.3g}" for k, v in vs_loop.items()), flush=True)
    _check(vs_loop["sum_w_rel"] <= 1e-5 and vs_loop["l1_rel"] < 0.2 and vs_loop["centroid_px"] < 0.05,
           f"images: K1i and the K1 loop differ: {vs_loop}")
    k1i = {"launches": launches["K1i"], "ms": k1i_ms, "plain_ms": plain_ms, **bound, "library_ms": None,
           "images": {"wall_s": wall, "rays_per_s": N_IMAGE / wall, "sum_w": res["sum_w"],
                      "delay_min_fs": float(np.nanmin(d)), "delay_max_fs": float(np.nanmax(d)),
                      "setup_s": setup_s, "copy_s": copy_s, "rays_binned": n_binned, "rays_alive_by_stage": alive,
                      "vs_plain": vs_plain,
                      "k1_loop_wall_s": loop_wall, "k1_loop_launches": loop_launches["K1"],
                      "vs_k1_loop": vs_loop}}
    k1 = {"launches": loop_launches["K1"], "wall_s": loop_wall, "rays_per_s": N_IMAGE / loop_wall}
    del loop

    imgs = k1i["images"]
    imgs["plain"], ker = _images_kernel_vs_plain("images 1e8", torch, dev, spec, els, det, N_IMAGE_CHECK,
                                                 extent=res["extent"])
    loop = gs._images(spec, els, det, N_IMAGE_CHECK, IMAGE_BINS, ker["extent"], ft.CHUNK, True, dev, gs.k1_chunks)
    imgs["vs_k1_loop_1e8"] = _image_diffs(ker, loop)
    print("images 1e8 K1i vs the K1 loop: " + ", ".join(f"{k} {v:.3g}" for k, v in imgs["vs_k1_loop_1e8"].items()),
          flush=True)
    del loop, ker

    # against the bundle path: Detector.get_Image / get_DelayMap of the K1
    # bundle of the same spiral, its intensities the image's weights
    baked = spec.baked()
    logedge = float(np.log(spec.gaussian_edge))
    small = gs.fused_source_images(spec, els, det, n_total=N_IMAGE_BUNDLE, bins=IMAGE_BINS)
    out = ft.fused_source_trace(ft.chain_table(baked, els), baked, N_IMAGE_BUNDLE, device=dev)
    rr = ft.synth_spec(baked, torch.arange(N_IMAGE_BUNDLE, device=dev), N_IMAGE_BUNDLE)[2]
    bundle = RayBundle(p=out.p, d=out.d, opl=out.opl, opl_c=out.opl_c, alive=out.alive,
                       intensity=torch.exp(logedge * rr), incidence=out.incidence,
                       wavelength=torch.tensor(spec.wavelength, device=dev))
    img, _ = det.get_Image(bundle, bins=IMAGE_BINS, extent=small["extent"])
    mean, w_img, _ = det.get_DelayMap(bundle, bins=IMAGE_BINS, extent=small["extent"])
    img, mean, w_img = (x.double().cpu().numpy() for x in (img, mean, w_img))
    bundle_w = float(bundle.weights().double().sum())
    blur = float(np.abs(_blur3(img) - _blur3(small["image"])).sum() / (9 * small["sum_w"]))
    (c, v), (cr, vr) = _image_moments(small["image"]), _image_moments(img)
    rel_w = abs(small["sum_w"] - bundle_w) / bundle_w
    finite = np.isfinite(mean)
    mean = mean - (mean[finite] * w_img[finite]).sum() / w_img[finite].sum()
    bundle_res = {"mean_delay": mean, "weight_image": w_img}
    diffs = _delay_diffs(bundle_res, small)
    print(f"images {N_IMAGE_BUNDLE} vs get_Image/get_DelayMap of the K1 bundle: blurred L1 {blur:.3g} of 9 sum w, "
          f"centroid |diff| {np.abs(c - cr).max():.3g} px, variance rel diff {np.abs(v / vr - 1).max():.3g}, "
          f"sum w rel {rel_w:.3g}, pixels |diff| max {np.abs(img - small['image']).max():.3g}; re-centred delay "
          f"maps on {diffs.size} pixels of weight > 5: median {np.median(diffs):.3g} max {diffs.max():.3g} fs",
          flush=True)
    _check(blur < 0.05 and np.abs(c - cr).max() < 0.05 and np.all(np.abs(v - vr) <= 0.01 * np.maximum(vr, 1.0))
           and rel_w <= 1e-4, "images vs the bundle path: outside tests/test_gigascan.py's envelope")
    imgs["bundle"] = {"blur_l1_rel": blur, "centroid_px": float(np.abs(c - cr).max()),
                      "variance_rel": float(np.abs(v / vr - 1).max()), "sum_w_rel": rel_w,
                      "delay_median_fs": float(np.median(diffs)), "delay_max_fs": float(diffs.max())}
    del out, rr, bundle

    # a grid-deformed chain (engine "xla-source", the defect slopes in the
    # normals) and an extended source (chunks on whole sub-sources)
    gspec, gels, gdet = _image_chain(torch, dev, _deformed_flagship(N_CHECK, kind="grid")[0])
    imgs["grid"], _ = _images_kernel_vs_plain("images grid flagship 1e8", torch, dev, gspec, gels, gdet,
                                              N_IMAGE_CHECK, ignore_defects=False)
    # the extended source's window spans its whole beam: an auto-fitted one
    # (a probe of its first 2^17 rays) frames only the first two of its 100
    # sub-sources, all in the first chunk
    espec, eels, edet = _image_chain(torch, dev, _extended(N_CHECK))
    espec = espec._replace(n_rays=N_IMAGE_BUNDLE)
    ebaked = espec.baked()
    n_ext = ebaked.n_sources * ebaked.n_each
    ecentre, enormal, erot = (torch.as_tensor(v, dtype=torch.float32, device=dev)
                              for v in (edet.centre, edet.normal, edet._plane_rotation()))
    eextent = gs._fit_extent(ebaked, eels, n_ext, ecentre, enormal, erot, True, dev)
    imgs["extended"], _ = _images_kernel_vs_plain(
        f"images extended source 1e7 ({ebaked.n_sources} x {ebaked.n_each})", torch, dev, espec, eels, edet,
        n_ext, extent=eextent)
    k1i["max_abs_err"] = max(imgs[key]["block_delay_max_fs"] for key in ("plain", "grid", "extended"))
    return k1i, k1


def phase_cost(torch, dev):
    """The cost probes P1-P3 (utils/cost_probe.py): the probes' run at the
    scripts' shapes with the launch counts set to 0 just before it, each
    output against its plain version (P1 and P3 equal; P2 every op at 8 and
    40 ops within 1e-6 relative, recip_approx 1e-5: the approximate
    reciprocal against the exact one), then P1's first launch from a fresh
    library load, its steady launch latency and its wrapper's host time
    taken apart (cost_probe.add_one_split), P2 slope-timed over n_ops
    (the script's 8 and 40, and 0, 200, 400), P3's copy floor against K4 on
    the flagship's four chain subsets. Returns the JSON entries of P1-P3."""
    from attosecondraytracing_tpu_torch.utils import cost_probe as cp

    cp.add_one.launches = cp.op_chain.launches = cp.copy_streams.launches = 0
    runs = cp.probe(device=dev, op_shape=cp.OP_SHAPE, n_rays=cp.N_RAYS)
    torch.cuda.synchronize()
    launches = {"P1": cp.add_one.launches, "P2": cp.op_chain.launches, "P3": cp.copy_streams.launches}
    _check(launches == {"P1": 1, "P2": 2 * len(cp.OPS), "P3": 1}, f"cost probe launches {launches}")
    (x1,), out1 = runs["P1"]
    _check(bool(torch.equal(out1, cp.add_one_ref(x1))), "P1 differs from its plain version")
    err2, abs2 = {}, 0.0
    for op in cp.OPS:
        for n in cp.SCRIPT_N_OPS:
            (_op, x2, _n), out2 = runs[f"P2 {op} {n}"]
            ref = cp.op_chain_ref(op, x2, n)
            rel = float(((out2 - ref).abs() / ref.abs()).max())
            err2[f"{op} {n}"] = rel
            abs2 = max(abs2, float((out2 - ref).abs().max()))
            _check(rel <= (1e-5 if op == "recip_approx" else 1e-6), f"P2 {op} at {n} ops: rel {rel}")
    print("P2 kernel vs plain (max rel): " + ", ".join(f"{k} {v:.3g}" for k, v in err2.items()), flush=True)
    streams, out3 = runs["P3"]
    ref3 = cp.copy_streams_ref(streams)
    _check(all(bool(torch.equal(a, b)) for a, b in zip(out3, ref3)), "P3 differs from its plain version")
    del runs, out3, ref3

    seconds, x, out = cp.first_launch_seconds(device=dev)
    _check(bool(torch.equal(out, cp.add_one_ref(x))), "P1 (fresh library) differs from its plain version")
    p1_ms = _time_ms(lambda: cp.add_one(x), torch, inner=20)
    # the plain version is one PyTorch call (x + 1): P1's library time too
    p1_plain = _time_ms(lambda: cp.add_one_ref(x), torch, inner=20)
    # the launches alone on the card: queued behind a busy stream, the host's work hidden
    p1_device_us = cp.queued_us(lambda: cp.add_one(x))
    plain_device_us = cp.queued_us(lambda: cp.add_one_ref(x))
    split = cp.add_one_split(x)
    print("P1 wrapper call taken apart (host us per call): "
          + ", ".join(f"{k} {v:.2f}" for k, v in split.items()), flush=True)
    print(f"P1: first launch from a fresh library load {seconds:.4f} s; steady launch {p1_ms * 1e3:.2f} us "
          f"(plain {p1_plain * 1e3:.2f} us); on the card alone, queued: {p1_device_us:.2f} us (plain "
          f"{plain_device_us:.2f} us): the {'kernel' if p1_device_us > 1.2 * plain_device_us else 'host binding'} "
          f"loses", flush=True)

    costs = cp.op_costs(device=dev)
    x2 = cp.op_inputs(device=dev)
    out2 = torch.empty_like(x2)
    n_lanes = x2.numel()
    for op, row in costs.items():
        floor = row["floor_ms"]
        leaves = [n for n, ms in row["ms_at"].items() if n and ms > 1.1 * floor]
        row["leaves_floor_at"] = leaves[0] if leaves else None
        print(f"P2 {op:12s}: {row['ms_per_op']:.5f} ms per op over {n_lanes} lanes (n_ops 8..40), "
              f"{row['ms_per_op_large']:.5f} (200..400); " + ", ".join(
                  f"{n}: {ms:.4f}" for n, ms in row["ms_at"].items())
              + f" ms; leaves the {floor:.4f} ms floor at {row['leaves_floor_at']} ops", flush=True)
    p2_ms = _time_ms(lambda: cp.op_chain("fma", x2, 40, out=out2), torch)
    p2_device_us = cp.queued_us(lambda: cp.op_chain("fma", x2, 40, out=out2))
    print(f"P2 fma at 40 ops: {p2_ms * 1e3:.2f} us per wrapper call, {p2_device_us:.2f} us on the card alone, "
          f"queued", flush=True)
    p2_plain = _time_ms(lambda: cp.op_chain_ref("fma", x2, 40), torch, reps=3, inner=1)
    cost = cp.kernel_cost(device=dev)
    for name, ms in cost["k4_ms"].items():
        print(f"K4 {name}: {ms:.4f} ms per {cp.N_RAYS} rays", flush=True)
    _bundle, streams = cp.source_streams(cp.N_RAYS, device=dev)
    p3_plain = _time_ms(lambda: cp.copy_streams_ref(streams), torch)
    print(f"P3 copy floor {cost['copy_ms']:.4f} ms ({cost['copy_gb_per_s']:.0f} GB/s at {cp.COPY_BYTES_PER_RAY} "
          f"B/ray; bound {_bound(cp.COPY_BYTES_PER_RAY * cp.N_RAYS, 0)['bound_ms']:.4f} ms), plain "
          f"{p3_plain:.4f} ms; K4 compute share {cost['compute_share'] * 100:.1f} % (mask "
          f"{cost['mask_ms']:.4f}, toroid {cost['toroid_ms']:.4f}, second toroid {cost['second_toroid_ms']:.4f} ms)",
          flush=True)
    n_tile = x1.numel()
    p1 = {"name": "P1 add_one", "route": "cuda", "source": CSRC + "cost_probe.cu", "replaces": "bench.py:162",
          "launches": launches["P1"], "max_abs_err": 0.0, "ms": p1_ms, "plain_ms": p1_plain,
          **_bound(8 * n_tile, n_tile), "library_ms": p1_plain, "first_launch_s": seconds,
          "device_ms": p1_device_us * 1e-3, "library_device_ms": plain_device_us * 1e-3, "split_us": split}
    p2 = {"name": "P2 op_chain (fma at 40 ops; every op in ops)", "route": "cuda",
          "source": CSRC + "cost_probe.cu", "replaces": "scripts/diag_vpu_ops.py:21", "launches": launches["P2"],
          "max_abs_err": abs2, "ms": p2_ms, "plain_ms": p2_plain,
          **_bound(8 * n_lanes, 2 * 40 * n_lanes), "library_ms": None, "device_ms": p2_device_us * 1e-3,
          "ops": costs, "max_rel_err": err2}
    p3 = {"name": "P3 copy_streams", "route": "cuda", "source": CSRC + "cost_probe.cu",
          "replaces": "scripts/diag_kernel_cost.py:72", "launches": launches["P3"], "max_abs_err": 0.0,
          "ms": cost["copy_ms"], "plain_ms": p3_plain, **_bound(cp.COPY_BYTES_PER_RAY * cp.N_RAYS, 0),
          "library_ms": None, "k4_ms": cost["k4_ms"], "k4_compute_share": cost["compute_share"]}
    return [p1, p2, p3]


#: the batched scans: rays per chain just under PALLAS_MIN_RAYS, the largest
#: a scan takes the batched trace at (11 chains stack to ~68 MB in float32)
N_BATCHED = 150_000
#: the sharded passes: rays of the flagship, shards of the one-process mesh
#: (all on the one card), rays of the sharded image (4 shards of 32 chunks of
#: 2^23 rays: the unsharded image's chunks), ranks of the two-process run and
#: their time limit [s]
N_MESH = 10_000_000
MESH_SHARDS = 4
N_MESH_IMAGE = 1 << 30
MESH_RANKS = 2
MESH_RANK_TIMEOUT = 300
MESH_DISTANCES = (-5.0, 0.0, 5.0)


def phase_batched(torch, dev):
    """The batched scan (main._batched_final_bundles): main.main on
    CONFIG_2toroidals_f-x-f.py (11 chains) and CONFIG_tolerancing.py (16
    chains) at their own 1000 rays and at N_BATCHED rays: every chain must
    take the batched trace ("trace-scan", no kernel launched: the plain
    trace, as in the JAX package) and agree with the serial path forced by
    ART_TPU_SCAN_STACK_MAX_BYTES=0 (each chain's plain trace) within 1e-6
    relative in transmission, spot SD and duration SD (float32, the same
    plain trace's operations on both sides); both walls are printed (the
    earlier phases have loaded the card's elementwise kernels). Returns
    the walls."""
    import contextlib
    import io
    import os

    import numpy as np

    from attosecondraytracing_tpu_torch import main as art

    out = {}
    for name in ("CONFIG_2toroidals_f-x-f.py", "CONFIG_tolerancing.py"):
        np.random.seed(7)  # CONFIG_tolerancing.py draws its rotation axes from it
        chains, sp, do, ao, _ = _load_config(name)
        ao = dict(ao, verbose=False)
        for n_rays in (chains[0].source_rays.n_rays, N_BATCHED):
            for c in chains:
                if c.source_rays.n_rays != n_rays:
                    c.resize_source(n_rays)
            runs = {}
            for mode, guard, engine in (("batched", None, "trace-scan"), ("serial", "0", "trace")):
                if guard is None:
                    os.environ.pop("ART_TPU_SCAN_STACK_MAX_BYTES", None)
                else:
                    os.environ["ART_TPU_SCAN_STACK_MAX_BYTES"] = guard
                _reset_launches()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):  # a progress line per chain
                    kept = art.main(chains, sp, do, ao, device=dev)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = _launches()
                engines = {c.last_trace_engine for c in chains}
                _check(engines == {engine} and not any(launches.values()),
                       f"batched {name} at {n_rays} rays, {mode}: engines {engines}, launches {launches}")
                runs[mode] = (kept, wall)
            os.environ.pop("ART_TPU_SCAN_STACK_MAX_BYTES", None)
            (kb, wb), (ks, ws) = runs["batched"], runs["serial"]
            err = max(abs(a - b) / max(abs(b), 1e-30) for key in ("ETransmission", "SpotSizeSD", "DurationSD")
                      for a, b in zip(kb[key], ks[key]))
            print(f"batched {name} at {n_rays} rays: {len(chains)} chains, main.main wall batched {wb:.3f} s, "
                  f"serial {ws:.3f} s; transmission, spot SD, duration SD max rel diff {err:.3g}; chain 0 "
                  f"T {kb['ETransmission'][0]:.6g} % spot {kb['SpotSizeSD'][0]:.6g} mm duration "
                  f"{kb['DurationSD'][0]:.6g} fs", flush=True)
            _check(err <= 1e-6, f"batched {name} at {n_rays} rays: batched vs serial differ by {err}")
            out[f"{name}@{n_rays}"] = {"chains": len(chains), "batched_s": wb, "serial_s": ws, "max_rel_diff": err}
    return out


def _mesh_problem(torch, dev):
    """The sharded passes' inputs on the flagship: its source at N_MESH rays
    with the Gaussian edge exp(-2), a detector 495 mm behind it and the
    alignment loss of the K6 phase (_grad_problem), the scan record, and the
    image flagship (its second toroid rolled IMAGE_ROLL deg, the detector at
    its focal distance)."""
    from attosecondraytracing_tpu_torch.ops import fused_scan as fs

    chain, _ = _flagship(N_CHECK)
    spec, host, geo, params, det = _grad_problem(torch, dev, chain, N_MESH, _bench_misalignment)
    info = chain.source_spec._replace(gaussian_edge=spec.gaussian_edge, n_rays=N_MESH)
    els64 = chain.device_elements(torch.float64)
    ichain, _ = _flagship(N_CHECK)
    ichain.rotate_OE(2, "roll", IMAGE_ROLL)
    ispec, iels, idet = _image_chain(torch, dev, ichain)
    return {"info": info, "els": chain.device_elements(), "els64": els64, "det": det,
            "loss": (params, spec, host, geo), "scan": fs.make_scan_spec(info.kind, els64, N_MESH),
            "image": (ispec, iels, idet)}


def _mesh_calls(torch, dev, mesh, prob, extent):
    """Every sharded pass of parallel/mesh.py on ``mesh``, each with the
    launch counts set to 0 just before it: the stats (K2), the scan moments
    (K5) and the scan engine's moments_fn (K5; sharded over the process
    group under ART_TPU_SCAN_MESH=1), the alignment loss and gradient (K6),
    the 2^30-ray image into the fixed ``extent`` (K1i) and the plain trace
    of N_MESH rays (trace_sharded; its alive count and float64 sums).
    Returns ({result: numpy array}, {call: (wall s, launches)})."""
    import numpy as np

    from attosecondraytracing_tpu_torch.analysis import gigascan as gs
    from attosecondraytracing_tpu_torch.ops import fused_grad as fg
    from attosecondraytracing_tpu_torch.ops import fused_scan as fs
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft
    from attosecondraytracing_tpu_torch.ops.precision import default_dtype
    from attosecondraytracing_tpu_torch.parallel import mesh as pm

    info, els, els64, det = prob["info"], prob["els"], prob["els64"], prob["det"]
    baked = info.baked()
    rot = det._plane_rotation()
    res, calls = {}, {}

    def run(name, fn):
        _reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        calls[name] = (time.perf_counter() - t0, _launches())
        return out

    st = run("stats", lambda: pm.source_stats_sharded(baked, els, N_MESH, mesh, det.centre, det.normal, rot,
                                                      distances=MESH_DISTANCES, gaussian_edge=info.gaussian_edge))
    res.update({"stats_" + k: np.asarray(st[k]) for k in ("sum_w", "spot_sd", "duration_sd")})
    opl_ref, inv_dn = ft.chief_ray_refs(baked, els64, det.centre, det.normal, device=dev, dtype=default_dtype())
    svec = fs.scan_chain_scalars(els64, np.asarray(baked.rot), np.asarray(baked.origin), det.centre,
                                 det.normal, rot)
    res["scan"] = run("scan", lambda: pm.scan_moments_sharded(
        prob["scan"], svec, N_MESH, mesh, opl_ref, inv_dn, radius=baked.radius,
        gaussian_edge=info.gaussian_edge, pos_radius=baked.pos_radius))
    moments_fn = fs.make_moments_fn(prob["scan"], els64, info, N_MESH, device=dev)
    res["moments_fn"] = run("moments_fn", lambda: moments_fn(det.centre, det.normal, rot,
                                                             gaussian_edge=info.gaussian_edge))["moments"]
    params, spec, host, geo = prob["loss"]
    loss, grads = run("grad", lambda: fg.fused_focus_value_and_grad(params, spec, host, *geo, device=dev,
                                                                    mesh=mesh))
    res["loss"] = np.float64(loss)
    res["grads"] = np.concatenate([grads.angles.reshape(-1).numpy(), grads.shifts.reshape(-1).numpy()])
    ispec, iels, idet = prob["image"]
    iopl, _ = ft.chief_ray_refs(ispec.baked(), iels, idet.centre, idet.normal, device=dev,
                                dtype=gs._elements_dtype(iels))
    res["w_img"], res["wd_img"] = run("images", lambda: pm.source_images_sharded(
        ispec.baked(), iels, N_MESH_IMAGE, mesh, idet.centre, idet.normal, idet._plane_rotation(), extent,
        bins=IMAGE_BINS, chunk=ft.CHUNK, gaussian_edge=ispec.gaussian_edge, opl_ref=iopl))
    source = ft.source_bundle(baked, N_MESH, device=dev)
    traced = run("trace", lambda: pm.trace_sharded(source, els, mesh))
    per = traced.n_rays // len(mesh.shards)
    for j, shard in enumerate(mesh.shards):  # each shard's rays: alive count and float64 sums
        p, alive = traced.p[j * per:(j + 1) * per], traced.alive[j * per:(j + 1) * per]
        path = (traced.opl - traced.opl_c)[j * per:(j + 1) * per]
        res[f"trace_{shard}"] = np.array([float(alive.sum()), float(p[alive].double().sum()),
                                          float(path[alive].double().sum())])
    return res, calls


def _mesh_rank(rank, world, store, out_path, extent, device):
    """One rank of the two-process mesh run (a spawned process): the process
    group on gloo through a file store, one shard on card 0, every pass of
    _mesh_calls with the scan engine's mesh taken from the group
    (ART_TPU_SCAN_MESH=1); the results saved to ``out_path``."""
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    os.environ["ART_TPU_SCAN_MESH"] = "1"
    from attosecondraytracing_tpu_torch.ops import fused_scan as fs
    from attosecondraytracing_tpu_torch.parallel import mesh as pm

    dev = torch.device(device)
    if not pm.distributed_init(backend="gloo", init_method="file://" + store, rank=rank, world_size=world):
        sys.exit(3)
    try:
        mesh = pm.make_mesh(devices=[dev], group=dist.group.WORLD)
        prob = _mesh_problem(torch, dev)
        scan_mesh = fs._scan_mesh(prob["scan"], N_MESH, device=dev)
        if scan_mesh is None or scan_mesh.size != world or mesh.shards != (rank,):
            sys.exit(4)
        res, calls = _mesh_calls(torch, dev, mesh, prob, extent)
        np.savez(out_path, **res, launches=np.array([calls[k][1][key] for k, key in _MESH_KERNELS]))
    finally:
        dist.destroy_process_group()


#: the sharded calls and the kernel each launches once per shard
_MESH_KERNELS = (("stats", "K2"), ("scan", "K5"), ("moments_fn", "K5"), ("grad", "K6"), ("images", "K1i"))


def _rel(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def phase_mesh(torch, dev):
    """The sharded passes (parallel/mesh.py) in one process on a mesh of
    MESH_SHARDS shards, all on the card: each sharded call launches its
    kernel once per shard (K2, K5, K6, K1i; the plain trace none) and is
    held against the unsharded call, its wall beside the unsharded one's
    (each the second of two calls): source_stats_sharded against one K2
    pass (tests/test_stats_kernel.py:159-161: sum of weights and spot SD rel
    2e-3, duration SD rel 2e-2 or 0.2 fs), scan_moments_sharded against
    scan_moments (tests/test_scan_kernel.py:226-256: sum of weights 2e-3,
    spot SD 5e-3, duration SD 3 % or 0.9 fs), fused_focus_value_and_grad
    with and without the mesh (tests/test_gradients.py:281-296: loss rel
    1e-4, gradients within 2e-3 of their largest entry), the 2^30-ray image
    against fused_source_images (the shards' chunks are the unsharded
    image's 128 chunks: every pixel within 1e-9 of the largest, the float64
    atomics' order), trace_sharded against the plain trace (equal), and
    trace_scan_sharded on a 2 x 2 mesh against each chain's plain trace
    (equal). Then the same passes in MESH_RANKS spawned processes on gloo,
    one shard each on card 0 (the scan engine's moments_fn sharded over the
    group, ART_TPU_SCAN_MESH=1), each rank's results equal to the
    one-process MESH_RANKS-shard mesh's within 1e-12 relative (K1i's float64
    atomics are the only reordering). Returns the JSON numbers of K2, K5,
    K6 and K1i."""
    import multiprocessing
    import os
    import tempfile

    import numpy as np

    from attosecondraytracing_tpu_torch.analysis import gigascan as gs
    from attosecondraytracing_tpu_torch.ops import fused_grad as fg
    from attosecondraytracing_tpu_torch.ops import fused_scan as fs
    from attosecondraytracing_tpu_torch.ops import fused_trace as ft
    from attosecondraytracing_tpu_torch.ops.trace import trace
    from attosecondraytracing_tpu_torch.parallel import mesh as pm

    prob = _mesh_problem(torch, dev)
    info, els, det = prob["info"], prob["els"], prob["det"]
    baked = info.baked()
    rot = det._plane_rotation()
    ispec, iels, idet = prob["image"]
    full = gs.fused_source_images(ispec, iels, idet, n_total=N_MESH_IMAGE, bins=IMAGE_BINS, chunk=ft.CHUNK)
    extent = full["extent"]
    mesh = pm.make_mesh(devices=[dev] * MESH_SHARDS)
    _mesh_calls(torch, dev, mesh, prob, extent)  # first calls: records packed, grids copied
    res, calls = _mesh_calls(torch, dev, mesh, prob, extent)
    for call, key in _MESH_KERNELS:
        expect = 1 if call == "moments_fn" else MESH_SHARDS  # one process: moments_fn is not sharded
        launches = calls[call][1]
        _check(launches[key] == expect and sum(launches.values()) == expect,
               f"mesh {call}: launches {launches}, expected {expect} x {key}")
    _check(not any(calls["trace"][1].values()), f"mesh trace: launches {calls['trace'][1]}")

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # the unsharded calls
    one_mom, t_stats = timed(lambda: ft.source_detector_moments(baked, els, N_MESH, det.centre, det.normal, rot,
                                                                device=dev, gaussian_edge=info.gaussian_edge))
    st1 = ft.sums_to_stats(ft.moments_to_distance_sums(one_mom["moments"], MESH_DISTANCES), one_mom["opl_ref"],
                           MESH_DISTANCES)
    err = {}
    err["K2"] = max(_rel(res["stats_sum_w"], st1["sum_w"]), _rel(res["stats_spot_sd"], st1["spot_sd"]))
    dur = float(np.abs(res["stats_duration_sd"] - st1["duration_sd"]).max())
    print(f"mesh stats ({MESH_SHARDS} shards x {N_MESH // MESH_SHARDS} rays): sum w {res['stats_sum_w'][0]:.9g} "
          f"vs {st1['sum_w'][0]:.9g}, spot SD {res['stats_spot_sd']} vs {st1['spot_sd']} mm, duration SD "
          f"{res['stats_duration_sd']} vs {st1['duration_sd']} fs", flush=True)
    _check(err["K2"] <= 2e-3 and np.all(np.abs(res["stats_duration_sd"] - st1["duration_sd"])
                                        <= np.maximum(2e-2 * st1["duration_sd"], 0.2)),
           f"mesh stats: rel {err['K2']}, duration {dur}")
    opl_ref, inv_dn = ft.chief_ray_refs(baked, prob["els64"], det.centre, det.normal, device=dev,
                                        dtype=torch.float32)
    svec = fs.scan_chain_scalars(prob["els64"], np.asarray(baked.rot), np.asarray(baked.origin), det.centre,
                                 det.normal, rot)
    mom1, t_scan = timed(lambda: fs.scan_moments(prob["scan"], svec, N_MESH, opl_ref, inv_dn, radius=baked.radius,
                                                 gaussian_edge=info.gaussian_edge, pos_radius=baked.pos_radius,
                                                 device=dev))
    _check(np.array_equal(mom1, res["moments_fn"]), "mesh: the unsharded moments_fn is not scan_moments")
    s8, s1 = (ft.sums_to_stats(ft.moments_to_distance_sums(m, MESH_DISTANCES), opl_ref, MESH_DISTANCES)
              for m in (res["scan"], mom1))
    err["K5"] = max(_rel(s8["sum_w"], s1["sum_w"]), _rel(s8["spot_sd"], s1["spot_sd"]))
    print(f"mesh scan moments: sum w {s8['sum_w'][0]:.9g} vs {s1['sum_w'][0]:.9g}, spot SD {s8['spot_sd']} vs "
          f"{s1['spot_sd']} mm, duration SD {s8['duration_sd']} vs {s1['duration_sd']} fs", flush=True)
    _check(_rel(s8["sum_w"], s1["sum_w"]) <= 2e-3 and _rel(s8["spot_sd"], s1["spot_sd"]) <= 5e-3
           and all(abs(k - r) <= 0.03 * r or abs(k * k - r * r) ** 0.5 <= 0.9
                   for k, r in zip(s8["duration_sd"], s1["duration_sd"])), "mesh scan moments: outside the envelope")
    params, spec, host, geo = prob["loss"]
    (loss1, grads1), t_grad = timed(lambda: fg.fused_focus_value_and_grad(params, spec, host, *geo, device=dev))
    g1 = np.concatenate([grads1.angles.reshape(-1).numpy(), grads1.shifts.reshape(-1).numpy()])
    err["K6"] = float(np.abs(res["grads"] - g1).max() / np.abs(g1).max())
    print(f"mesh gradient: loss {res['loss']:.9g} vs {loss1:.9g}, gradient within {err['K6']:.3g} of its "
          f"largest entry", flush=True)
    _check(abs(res["loss"] - loss1) <= 1e-4 * abs(loss1) and err["K6"] <= 2e-3, "mesh gradient: outside the envelope")
    _, t_img = timed(lambda: gs.fused_source_images(ispec, iels, idet, n_total=N_MESH_IMAGE, bins=IMAGE_BINS,
                                                    extent=extent, chunk=ft.CHUNK))
    w8, wd8 = res["w_img"], res["wd_img"]
    err["K1i"] = _rel(w8, full["image"])
    has = (w8 > 0) & (full["weight_image"] > 0)
    mean8 = wd8[has] / w8[has] - wd8.sum() / w8.sum()
    delay_err = float(np.abs(mean8 - full["mean_delay"][has]).max())
    print(f"mesh image {N_MESH_IMAGE} rays into {IMAGE_BINS}: sum w {w8.sum():.9g} vs {full['sum_w']:.9g}, "
          f"pixels within {err['K1i']:.3g} of the largest, mean delays within {delay_err:.3g} fs", flush=True)
    _check(err["K1i"] <= 1e-9 and delay_err <= 1e-6, f"mesh image: pixels {err['K1i']}, delays {delay_err} fs")
    source = ft.source_bundle(baked, N_MESH, device=dev)
    ref, t_trace = timed(lambda: trace(source, els, True, keep_history=False))
    traced = pm.trace_sharded(source, els, mesh)
    _check(torch.equal(traced.p, ref.p) and torch.equal(traced.alive, ref.alive), "mesh trace: not equal")
    scan_chains = [c.to(dev) for c in _flagship(N_BATCHED)[0].get_OE_loop_list(1, "roll", np.linspace(-0.2, 0.2, 4))]
    stacked = pm.trace_scan_sharded(scan_chains, pm.make_mesh(rays=2, scan=2, devices=[dev] * 4))
    for i, c in enumerate(scan_chains):
        own = c.trace_final()
        _check(torch.equal(stacked.p[i], own.p) and torch.equal(stacked.alive[i], own.alive),
               f"mesh trace_scan_sharded: chain {i} differs")
    walls = {"K2": (calls["stats"][0], t_stats), "K5": (calls["scan"][0], t_scan), "K6": (calls["grad"][0], t_grad),
             "K1i": (calls["images"][0], t_img), "trace": (calls["trace"][0], t_trace)}
    print("mesh walls (sharded vs unsharded call, s): "
          + ", ".join(f"{k} {a:.4f} vs {b:.4f}" for k, (a, b) in walls.items()), flush=True)

    # the same passes in MESH_RANKS processes, one shard each on the card
    t0 = time.perf_counter()
    ref2, _ = _mesh_calls(torch, dev, pm.make_mesh(devices=[dev] * MESH_RANKS), prob, extent)
    ctx = multiprocessing.get_context("spawn")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        store = os.path.join(tmp, "store")
        paths = [os.path.join(tmp, f"rank{r}.npz") for r in range(MESH_RANKS)]
        procs = [ctx.Process(target=_mesh_rank, args=(r, MESH_RANKS, store, paths[r], extent, str(dev)))
                 for r in range(MESH_RANKS)]
        for p in procs:
            p.start()
        deadline = time.perf_counter() + MESH_RANK_TIMEOUT
        for p in procs:
            p.join(timeout=max(deadline - time.perf_counter(), 1.0))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        _check(codes == [0] * MESH_RANKS, f"mesh ranks: exit codes {codes} (time limit {MESH_RANK_TIMEOUT} s)")
        ranks = [dict(np.load(path)) for path in paths]
    rank_err = 0.0
    for r, got in enumerate(ranks):
        launches = dict(zip([c for c, _ in _MESH_KERNELS], got.pop("launches")))
        _check(all(v == 1 for v in launches.values()), f"mesh rank {r}: launches {launches}")
        _check(set(got) == set(ref2) - {f"trace_{s}" for s in range(MESH_RANKS) if s != r},
               f"mesh rank {r}: results {sorted(got)}")
        for key, have in got.items():
            want = ref2["scan"] if key == "moments_fn" else ref2[key]  # the group's sharded K5 pass
            e = _rel(have, want)
            rank_err = max(rank_err, e)
            _check(e <= 1e-12, f"mesh rank {r}: {key} differs from the one-process mesh by {e} (rel)")
    print(f"mesh {MESH_RANKS} processes (gloo, one shard each on {dev}): every result within {rank_err:.3g} "
          f"(rel) of the one-process {MESH_RANKS}-shard mesh; launches per rank 1 each of "
          f"{[k for _, k in _MESH_KERNELS]}; {time.perf_counter() - t0:.1f} s with the processes", flush=True)
    return {key: {"shards": MESH_SHARDS, "launches": MESH_SHARDS, "wall_s": walls[key][0],
                  "unsharded_wall_s": walls[key][1], "max_rel_err": err[key], "ranks": MESH_RANKS,
                  "ranks_max_rel_err": rank_err} for key in ("K2", "K5", "K6", "K1i")}


def phase_cli(torch):
    """run_config_file on the card and on the CPU (plain versions) in this
    process: CONFIG_singleparabola.py at 1e6 rays,
    CONFIG_gradient_alignment.py at its own 2000 rays (it aligns its chain
    while it loads, through the autograd engine at that size), whose loss
    must fall at least 10x on the card, and CONFIG_deformed.py at its own
    1000 rays (a Fourier-PSD defect map: the plain trace, no kernel, on
    both devices). Transmission within 0.05 %, spot SD
    1e-3 relative, duration SD 1e-2 relative, or 10 % for the sub-fs
    duration of the alignment CONFIG (float32 delay noise sets it: 0.44 fs
    in float32 against 0.067 fs in float64, as in the user-bundle phase).
    matplotlib is hidden while the CONFIGs run: CONFIG_singleparabola.py's
    plot request makes make_plots print one stderr line and draw nothing,
    and its results on the card equal main.main's on the same CONFIG with
    the plot option off (1e-9 relative)."""
    import io
    import re

    from attosecondraytracing_tpu_torch import main as art

    for name, n_rays, dur_rtol in (("CONFIG_singleparabola.py", N_CLI, 1e-2),
                                   ("CONFIG_gradient_alignment.py", None, 0.1),
                                   ("CONFIG_deformed.py", None, 1e-2)):
        path = str(ROOT / "examples" / name)
        res = {}
        for dev in ("cuda", "cpu"):
            out = io.StringIO()
            with _without_matplotlib(), contextlib.redirect_stdout(out):
                kept, err = _run_quiet_stderr(lambda: art.run_config_file(path, n_rays=n_rays, device=dev))
            drawn = [line for line in err if "plots not drawn" in line]
            want = 1 if name == "CONFIG_singleparabola.py" else 0
            _check(len(drawn) == want and all("plot_DelaySpotDiagram" in line for line in drawn),
                   f"CLI {name} on {dev}: expected {want} line(s) for the plots matplotlib cannot "
                   f"draw, got {err}")
            losses = re.findall(r"alignment loss: (\S+) -> (\S+)", out.getvalue())
            res[dev] = (kept["ETransmission"][0], kept["SpotSizeSD"][0], kept["DurationSD"][0], losses)
        if name == "CONFIG_singleparabola.py":
            chain, sp, do, ao, _ = _load_config(name)
            chain.resize_source(n_rays)
            quiet = art.main(chain, dict(sp, NumberRays=n_rays), do,
                             dict(ao, plot_DelaySpotDiagram=False, verbose=False), device="cuda")
            plain = [quiet[k][0] for k in ("ETransmission", "SpotSizeSD", "DurationSD")]
            print(f"CLI {name} with the plot option off: {plain}", flush=True)
            _check(all(abs(a - b) <= 1e-9 * abs(b) for a, b in zip(res["cuda"][:3], plain)),
                   f"CLI {name}: the plot request changed the results: {res['cuda'][:3]} vs {plain}")
        (tg, sg, dg, lg), (tc, sc, dc, lc) = res["cuda"], res["cpu"]
        print(f"CLI {name} {kept['OpticalChain'][0].source_rays.n_rays} rays: cuda T {tg:.6g} % spot "
              f"{sg:.6g} mm duration {dg:.6g} fs{' loss ' + ' -> '.join(lg[0]) if lg else ''}; cpu T "
              f"{tc:.6g} % spot {sc:.6g} mm duration {dc:.6g} fs{' loss ' + ' -> '.join(lc[0]) if lc else ''}",
              flush=True)
        _check(abs(tg - tc) <= 0.05, f"CLI {name}: transmission {tg} vs {tc}")
        _check(abs(sg - sc) <= 1e-3 * abs(sc), f"CLI {name}: spot SD {sg} vs {sc}")
        _check(abs(dg - dc) <= dur_rtol * abs(dc), f"CLI {name}: duration SD {dg} vs {dc}")
        if name == "CONFIG_gradient_alignment.py":
            _check(len(lg) == 1 and float(lg[0][1]) * 10 <= float(lg[0][0]),
                   f"CLI {name}: the alignment loss must fall 10x on the card, got {lg}")


def main():
    if len(sys.argv) != 1:
        _fail("usage: python3 chip_smoke.py (no arguments)")
    try:
        import torch
    except ImportError:
        _fail("torch is not installed")
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    if not (ROOT / "attosecondraytracing_tpu_torch").is_dir():
        _fail("attosecondraytracing_tpu_torch/ is missing beside chip_smoke.py; run from a checkout")
    sys.path.insert(0, str(ROOT))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    from attosecondraytracing_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.library()
    print(f"kernel library ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_cuda.build_seconds:.2f} s)", flush=True)
    for line in _cuda.build_log_path().read_text().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line or "error" in line:
            print("ptxas:", line.strip(), flush=True)

    def phase(name, fn):
        t0 = time.perf_counter()
        out = fn()
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    timed = {}
    timed["K1"] = phase("k1", lambda: phase_k1(torch, dev))
    timed["K2"] = phase("k2", lambda: phase_k2(torch, dev))
    timed["K5"] = phase("k5", lambda: phase_k5(torch, dev))
    k34_err, k34_times = phase("k34", lambda: phase_k34(torch, dev))
    slice_launches, slice_chain = phase("slice", lambda: phase_slice(torch, dev))
    plots = phase("plots", lambda: phase_plots(torch, dev, slice_chain))
    del slice_chain
    scan_launches = phase("scan", lambda: phase_scan(torch, dev))
    launches, streamed = phase("streamed", lambda: phase_streamed(torch, dev))
    timed.update(phase("k67", lambda: phase_k67(torch, dev)))
    grad_launches, k7_launches = phase("grad", lambda: phase_grad(torch, dev))
    k8, k8_launches = phase("k8", lambda: phase_k8(torch, dev))
    timed["K8"] = k8[20]
    zernike, zernike_launches = phase("zernike", lambda: phase_zernike(torch, dev))
    grid = phase("grid", lambda: phase_grid(torch, dev))
    probes = phase("gather", lambda: phase_gather(torch, dev))
    timed["K1i"], k1_images = phase("images", lambda: phase_images(torch, dev))
    probes += phase("cost", lambda: phase_cost(torch, dev))
    phase("cli", lambda: phase_cli(torch))
    phase("batched", lambda: phase_batched(torch, dev))
    mesh = phase("mesh", lambda: phase_mesh(torch, dev))
    launches.update(K1=slice_launches["K1"], K1i=timed["K1i"].pop("launches"), K2=slice_launches["K2"],
                    K5=scan_launches["K5"],
                    K6=grad_launches["K6"], K7=k7_launches["K7"], K8=k8_launches)
    for key in ("K3", "K4"):
        timed[key] = dict(streamed[key], max_abs_err=max(streamed[key]["max_abs_err"], k34_err[key]),
                          **k34_times[key])
    _check("jax" not in sys.modules, "jax was imported")
    print(f"all phases: {time.perf_counter() - t_start:.1f} s", flush=True)

    rows = (
        ("K1", "K1 fused_source_trace", "fused_trace.cu", "attosecondraytracing_tpu/ops/pallas_trace.py:476"),
        ("K1i", "K1i fused_source_image (a 1e9-ray 512 x 512 image)", "fused_trace.cu",
         "attosecondraytracing_tpu/analysis/gigascan.py:75"),
        ("K2", "K2 fused_source_moments", "fused_trace.cu", "attosecondraytracing_tpu/ops/pallas_trace.py:979"),
        ("K3", "K3 streamed_trace", "streamed_trace.cu", "attosecondraytracing_tpu/ops/pallas_trace.py:182"),
        ("K4", "K4 streamed_trace (fresh)", "streamed_trace.cu",
         "attosecondraytracing_tpu/ops/pallas_trace.py:194"),
        ("K5", "K5 fused_scan_moments", "fused_scan.cu", "attosecondraytracing_tpu/ops/pallas_scan.py:86"),
        ("K6", "K6 fused_stats_params (a gradient step: 18 tangent rows)", "fused_grad.cu",
         "attosecondraytracing_tpu/ops/pallas_grad.py:266"),
        ("K7", "K7 fused_stats_params (primal)", "fused_grad.cu",
         "attosecondraytracing_tpu/ops/pallas_grad.py:293"),
        ("K8", "K8 fused_source_stats (20 distances)", "fused_trace.cu",
         "attosecondraytracing_tpu/ops/pallas_trace.py:931"),
    )
    kernels = [{"name": name, "route": "cuda", "source": CSRC + src, "replaces": replaces,
                "launches": launches[key], **timed[key], "library_ms": None, **zernike.get(key, {}),
                **grid.get(key, {}), **({"mesh": mesh[key]} if key in mesh else {}),
                **({"plots": plots[key]} if key in plots else {})}
               for key, name, src, replaces in rows] + probes
    kernels[0]["images"] = k1_images
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
