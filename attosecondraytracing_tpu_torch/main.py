"""CONFIG runner and CLI: run a CONFIG file end to end (counterpart of the JAX
package's ``main.py``).

Usage::

    python -m attosecondraytracing_tpu_torch.main [--rays N] [--device cuda|cpu] [--scan-engine auto|off] [--profile DIR] CONFIG

A CONFIG file is an executable Python module defining ``OpticalChain`` (or
``OpticalChainList``), ``SourceProperties``, ``DetectorOptions`` and
``AnalysisOptions``. The repository's ``examples/CONFIG_*.py`` import the
JAX package's module names; :func:`run_config_file` points those names at
this package while the file runs, so the same files drive both packages and
JAX is never imported.

``--device`` defaults to ``cuda`` and raises when no card is present;
``cpu`` runs the kernels' plain PyTorch versions. ``--scan-engine off`` (or
``ART_TPU_SCAN_ENGINE=off``, the JAX package's variable) runs a parameter
scan chain by chain instead of through the scan engine. ``--profile DIR``
runs the CONFIG under ``torch.profiler`` (:func:`profiled`).
"""

from __future__ import annotations

import contextlib
import importlib.util
import os
import sys

import numpy as np
import torch

from . import default_options as defaults
from .analysis import stats
from .analysis.optimizer import FindOptimalDistance
from .models.chain import OpticalChain, config_device
from .models.detector import Detector
from .ops.bundle import RayBundle
from .ops.precision import resolve_device
from .utils import log
from .utils.io import save_compressed

# True while run_config_file() drives a CONFIG from the CLI; mirrors the
# reference's `__name__ != "__main__"` plot gating
_CLI_ACTIVE = False


def load_config(config):
    """Pull the 4 config variables off an imported config module."""
    if hasattr(config, "OpticalChainList"):
        chains = config.OpticalChainList
    elif hasattr(config, "OpticalChain"):
        chains = config.OpticalChain
    else:
        raise ValueError(
            "Could not import an optical-chain-object or list thereof with the "
            "name OpticalChain or OpticalChainList."
        )
    source_props = getattr(config, "SourceProperties", {})
    detector_opts = getattr(config, "DetectorOptions", {})
    analysis_opts = getattr(config, "AnalysisOptions", {})
    return chains, source_props, detector_opts, analysis_opts


def complete_defaults(SourceProperties, DetectorOptions, AnalysisOptions):
    """Merge user dicts over the defaults."""
    sp = defaults.default_source_properties()
    do = defaults.default_detector_options()
    ao = defaults.default_analysis_options()
    sp.update(SourceProperties or {})
    do.update(DetectorOptions or {})
    ao.update(AnalysisOptions or {})
    return sp, do, ao


def setup_detector(chain: OpticalChain, DetectorOptions: dict, bundle: RayBundle | None = None) -> Detector:
    """Manual or automatic detector placement."""
    ref_element = chain.optical_elements[DetectorOptions["ReflectionNumber"]]
    if DetectorOptions["ManualDetector"]:
        if DetectorOptions["DetectorCentre"] is None or DetectorOptions["DetectorNormal"] is None:
            raise RuntimeError(
                'Manual detector placement needs "DetectorCentre" and "DetectorNormal" '
                'in the "DetectorOptions"-dictionary.'
            )
        return Detector(
            ref_element.position,
            DetectorOptions["DetectorCentre"],
            DetectorOptions["DetectorNormal"],
        )
    if DetectorOptions["DistanceDetector"] is None:
        raise RuntimeError(
            'Automatic detector placement needs "DistanceDetector" in the '
            '"DetectorOptions"-dictionary.'
        )
    if bundle is None:
        raise RuntimeError("Automatic detector placement needs the analyzed ray bundle.")
    det = Detector(ref_element.position)
    det.autoplace(bundle, DetectorOptions["DistanceDetector"])
    return det


def _subsample(bundle: RayBundle, max_rays: int, generator: torch.Generator) -> RayBundle:
    """Randomly subsample alive rays (the reference caps its optimizer at
    ``max_rays`` for speed); draws from the explicit ``generator``."""
    idx = torch.nonzero(bundle.alive).reshape(-1)
    if len(idx) > max_rays:
        pick = torch.randperm(len(idx), generator=generator, device=generator.device)[:max_rays]
        idx = idx[pick.to(idx.device)]
    return RayBundle(*[x[idx] if x.ndim else x for x in bundle])


def optimize_detector(
    bundle: RayBundle,
    detector: Detector,
    DetectorOptions: dict,
    verbose: bool = True,
    maxRaystoConsider: int = 1000,
    IntensityWeighted: bool = False,
    Amplitude=None,
    Precision: int = 3,
    generator: torch.Generator | None = None,
):
    """Shift the detector to the optimum of DetectorOptions['OptFor'] on a
    subsample of ``maxRaystoConsider`` alive rays (``generator`` draws it;
    a fresh CPU generator seeded with 0 when None)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    sub = _subsample(bundle, maxRaystoConsider, generator)
    det, spot, duration = FindOptimalDistance(
        detector, sub, DetectorOptions["OptFor"], Amplitude, Precision, IntensityWeighted, verbose
    )
    if verbose:
        _print_optimum(det, spot, duration, DetectorOptions["OptFor"], IntensityWeighted)
    return det, spot, duration


def _print_optimum(det, spot, duration, opt_for, weighted, suffix=""):
    result = f"The optimal detector distance is {det.get_distance():.3f} mm, with"
    if weighted:
        result += " intensity-weighted"
    if opt_for in ["intensity", "spotsize", "size"]:
        result += f" spatial std of {spot * 1e3:.3g} μm"
    if opt_for in ["intensity", "duration"]:
        result += f" temporal std of {duration:.3g} fs."
    print(result + suffix, flush=True)


def _fused_optimizer_available(chain: OpticalChain) -> bool:
    """True when the detector optimizer runs as one fused moment pass
    (kernel K2 on CUDA, its plain version on the CPU): the fused trace
    engine's rule, so what K2 lacks raises rather than dropping to the
    subsampled host optimizer."""
    return chain.fused_eligible()


def optimize_detector_fused(chain: OpticalChain, detector: Detector,
                            DetectorOptions: dict, verbose: bool = True):
    """Detector-distance optimization through one fused source -> trace ->
    moments pass over all rays (FindOptimalDistanceFused); the minimization
    runs on the host in float64. Optional ``DetectorOptions`` knobs:
    ``Amplitude``, ``Precision``, ``IntensityWeighted`` (False drops the
    Gaussian source weights)."""
    from .analysis.optimizer import FindOptimalDistanceFused

    info = chain.source_spec
    weighted = DetectorOptions.get("IntensityWeighted", True)
    det, spot, duration = FindOptimalDistanceFused(
        info.baked(),
        chain.device_elements(torch.float64),
        info.n_rays,
        detector,
        DetectorOptions["OptFor"],
        Amplitude=DetectorOptions.get("Amplitude"),
        Precision=DetectorOptions.get("Precision", 3),
        gaussian_edge=info.gaussian_edge if weighted else None,
        verbose=False,
        device=chain.device,
    )
    if verbose:
        _print_optimum(det, spot, duration, DetectorOptions["OptFor"], weighted,
                       " [fused kernel scan over all rays]")
    return det, spot, duration


def get_result_summary(detector: Detector, bundle: RayBundle, verbose: bool = False):
    """(spot SD, duration SD) + optional printed summary."""
    spot, duration = detector.get_SpotAndDuration(bundle)
    spot = float(spot)
    duration = float(duration)
    if verbose:
        alive = bundle.alive.cpu().numpy()
        xy = detector.get_PointList2DCentre(bundle).double().cpu().numpy()[alive]
        delays = detector.get_Delays(bundle).double().cpu().numpy()[alive]
        extent = max(np.ptp(xy[:, 0]), np.ptp(xy[:, 1])) if len(xy) else 0.0
        print(
            f"At the detector distance of {detector.get_distance():.3f} mm we get:\n"
            f"Spatial std : {spot * 1e3:.3f} μm and min-max: {extent * 1e3:.3f} μm\n"
            f"Temporal std : {duration:.3e} fs and min-max : {np.ptp(delays):.3e} fs"
        )
    return spot, duration


def _plot_calls(chain, bundle, detector, SourceProperties, DetectorOptions, AnalysisOptions):
    """The flag-gated standard plots in the JAX package's order: yields
    (public name in ``analysis.plots``, its data record) for each plot
    requested, computing each record on the bundle's device as it is
    reached. Neither it nor the records import matplotlib; :func:`make_plots`
    draws them.

    Spot and delay plots become device-binned images (``SpotDiagramImage``,
    ``DelayMapImage``) for ``image_plots`` True, or "auto" at
    ``PALLAS_MIN_RAYS`` rays or more. ``image_rays`` makes the intensity and
    delay images from that many rays synthesized in the image kernel
    (``gigascan.fused_source_images``, kernel K1i on a card) when the chain
    has a ``source_spec``, and then replaces only the Intensity and Delay
    spot plots and graphs; incidence plots still come from the bundle."""
    from .analysis import plots
    from .models import chain as mchain

    A = AnalysisOptions
    if A["plot_Render"]:
        yield "RayRenderGraph", plots.ray_render_graph_data(
            chain,
            detector.get_distance() * 1.2,
            A["maxRaysToRender"],
            A["OEPointsToRender"],
            A["OEPointsScale"],
            draw_mesh=A["draw_mesh"],
            cycle_ray_colors=A["cycle_ray_colors"],
        )
    for which in ("Delay", "Intensity", "Incidence"):
        if A[f"plot_{which}MirrorProjection"]:
            yield "MirrorProjection", plots.mirror_projection_data(
                chain, DetectorOptions["ReflectionNumber"], detector, which)

    use_images = A["image_plots"] is True or (
        A["image_plots"] == "auto" and bundle.n_rays >= mchain.PALLAS_MIN_RAYS
    )
    bins = int(A["image_bins"])

    image_rays = A.get("image_rays")
    giga_done = False
    want_giga = A["plot_SpotDiagram"] or any(
        A[f"plot_{w}SpotDiagram"] or A[f"plot_{w}Graph"] for w in ("Delay", "Intensity")
    )
    if image_rays and want_giga:
        if chain.source_spec is None:
            print(
                "[attosecondraytracing_tpu_torch] image_rays ignored: this chain's "
                "source is not in-kernel synthesizable (no source_spec).",
                flush=True,
            )
        else:
            from .analysis.gigascan import fused_source_images

            res = fused_source_images(
                chain.source_spec, chain.device_elements(), detector,
                n_total=int(image_rays), bins=(bins, bins),
            )
            yield "GigaRayImages", plots.giga_ray_images_data(res, title=chain.description)
            giga_done = True

    if A["plot_SpotDiagram"] and not giga_done:
        if use_images:
            yield "SpotDiagramImage", plots.spot_diagram_image_data(
                bundle, detector, A["DrawAiryAndFourier"], bins=bins)
        else:
            yield "SpotDiagram", plots.spot_diagram_data(bundle, detector, A["DrawAiryAndFourier"])
    for which in ("Delay", "Intensity", "Incidence"):
        if A[f"plot_{which}SpotDiagram"] and not (giga_done and which != "Incidence"):
            if use_images:
                yield "SpotDiagramImage", plots.spot_diagram_image_data(
                    bundle, detector, A["DrawAiryAndFourier"], which, bins=bins)
            else:
                yield "SpotDiagram", plots.spot_diagram_data(
                    bundle, detector, A["DrawAiryAndFourier"], which)
    for which in ("Delay", "Intensity", "Incidence"):
        if A[f"plot_{which}Graph"] and not (giga_done and which != "Incidence"):
            if use_images:
                yield "DelayMapImage", plots.delay_map_image_data(
                    bundle, detector, SourceProperties["DeltaFT"], A["DrawAiryAndFourier"],
                    None if which == "Delay" else which, bins=bins,
                )
            else:
                yield "DelayGraph", plots.delay_graph_data(
                    bundle, detector, SourceProperties["DeltaFT"], A["DrawAiryAndFourier"],
                    None if which == "Delay" else which,
                )


def make_plots(chain, bundle, detector, SourceProperties, DetectorOptions, AnalysisOptions):
    """Flag-gated standard plots: draws each record of :func:`_plot_calls`.
    Where matplotlib cannot be imported (the card's machine has none), it
    prints one stderr line naming the requested plots and computes none of
    them; the JAX package raises ModuleNotFoundError there."""
    from .analysis import plots

    try:
        plots.pyplot()
    except ImportError as exc:
        requested = [k for k in AnalysisOptions if k.startswith("plot_") and AnalysisOptions[k]]
        print(f"[attosecondraytracing_tpu_torch] plots not drawn ({', '.join(requested)}): "
              f"matplotlib cannot be imported ({exc}).", file=sys.stderr, flush=True)
        return
    for _name, data in _plot_calls(chain, bundle, detector, SourceProperties, DetectorOptions,
                                   AnalysisOptions):
        data.draw()


def run_ART(
    chain: OpticalChain,
    SourceProperties,
    DetectorOptions,
    AnalysisOptions,
    loop=False,
    precomputed_bundle: RayBundle | None = None,
    *,
    device="cuda",
):
    """Trace one chain on ``device``, set up / optimize its detector,
    summarize and plot (:func:`make_plots`). ``precomputed_bundle`` (the
    chain's analysed bundle, e.g. from :func:`_batched_final_bundles`)
    replaces the trace. Returns (chain, detector, transmission %, spot SD,
    duration SD)."""
    chain.to(device)
    niceline = "_" * 99 + "\n"
    A = AnalysisOptions
    needs_history = A["plot_Render"] or any(
        A[f"plot_{w}MirrorProjection"] for w in ("Delay", "Intensity", "Incidence")
    )
    is_final = DetectorOptions["ReflectionNumber"] in (-1, len(chain.optical_elements) - 1)
    if precomputed_bundle is not None:
        bundle = precomputed_bundle
    elif is_final and not needs_history:
        bundle = chain.trace_final()
        if AnalysisOptions["verbose"] and chain.last_trace_engine != "trace":
            print(f"[trace engine: {chain.last_trace_engine}]", flush=True)
    else:
        bundle = chain.get_output_rays()[DetectorOptions["ReflectionNumber"]]

    etransmission = stats.energy_transmission(chain.source_weight(), bundle)
    if AnalysisOptions["verbose"]:
        print(niceline[:-1], flush=True)
        if isinstance(chain.description, str) and chain.description:
            print("***" + chain.description + "*** :")
        if chain.loop_variable_name is not None and chain.loop_variable_value is not None:
            print(f"For {chain.loop_variable_name} = {chain.loop_variable_value:f}:\n")
        print(f"The optical setup has an energy transmission of {etransmission:.1f}%.\n")

    detector = setup_detector(chain, DetectorOptions, bundle)

    if DetectorOptions["AutoDetectorDistance"]:
        if _fused_optimizer_available(chain):
            detector, spot_sd, duration_sd = optimize_detector_fused(
                chain, detector, DetectorOptions, AnalysisOptions["verbose"])
        else:
            detector, spot_sd, duration_sd = optimize_detector(
                bundle,
                detector,
                DetectorOptions,
                AnalysisOptions["verbose"],
                maxRaystoConsider=DetectorOptions.get("maxRaystoConsider", 1000),
                IntensityWeighted=DetectorOptions.get("IntensityWeighted", True),
                Amplitude=DetectorOptions.get("Amplitude"),
                Precision=DetectorOptions.get("Precision", 3),
            )
    else:
        spot_sd, duration_sd = get_result_summary(detector, bundle, AnalysisOptions["verbose"])

    if AnalysisOptions["verbose"]:
        print(niceline)

    # the reference's gating: a scan's chains plot only when main() is
    # called as a library, not from the CLI
    if not loop or not _CLI_ACTIVE:
        if any(AnalysisOptions[k] for k in AnalysisOptions if k.startswith("plot_")):
            make_plots(chain, bundle, detector, SourceProperties, DetectorOptions, AnalysisOptions)

    return chain, detector, etransmission, spot_sd, duration_sd


SCAN_ENGINES = ("auto", "off")


def _prepare_fused_scan(chains, AnalysisOptions):
    """The shared :class:`~.ops.fused_scan.ScanSpec` of a parameter scan the
    scan engine (kernel K5) takes, or None: at least 2 chains, every one a
    factory source of the same kind and ray count at ``PALLAS_MIN_RAYS`` or
    more, one pose-independent signature, and no plots requested in library
    mode (they need per-ray bundles)."""
    from .models import chain as mchain
    from .ops.fused_scan import make_scan_spec, pose_independent_signature

    if len(chains) < 2:
        return None
    specs = [c.source_spec for c in chains]
    if any(s is None for s in specs):
        return None
    n_rays = specs[0].n_rays
    if any(s.n_rays != n_rays or s.kind != specs[0].kind for s in specs):
        return None
    if n_rays < mchain.PALLAS_MIN_RAYS:
        return None
    if any(AnalysisOptions.get(k) for k in AnalysisOptions if k.startswith("plot_")) and not _CLI_ACTIVE:
        return None
    elements = [[e.to_device("cpu", torch.float64) for e in c.optical_elements] for c in chains]
    if len({pose_independent_signature(els) for els in elements}) != 1:
        return None
    baked = specs[0].baked()
    return make_scan_spec(specs[0].kind, elements[0], n_rays, n_each=baked.n_each,
                          n_sources=baked.n_sources)


def _run_ART_fused_scan(chain: OpticalChain, scan_spec, DetectorOptions, AnalysisOptions,
                        *, device):
    """One chain of a parameter scan through the scan engine: a probe trace
    of ``min(n, 8192)`` source rays places the detector, one K5 pass (its
    plain version on the CPU) feeds the detector optimizer or the summary,
    and the transmission is the surviving weight over the source's
    closed-form total weight, so no per-ray bundle is built."""
    from .analysis.optimizer import FindOptimalDistanceFused
    from .ops import fused_scan as fs
    from .ops import fused_trace as ft
    from .ops.precision import default_dtype

    chain.to(device)
    niceline = "_" * 99 + "\n"
    info = chain.source_spec
    baked = info.baked()
    elements = chain.device_elements(torch.float64)
    probe_out = ft.probe_trace(baked, elements, min(info.n_rays, 8192), device=chain.device,
                               dtype=default_dtype())
    detector = setup_detector(chain, DetectorOptions, probe_out)

    fn = fs.make_moments_fn(scan_spec, elements, info, info.n_rays, device=chain.device)
    weighted = DetectorOptions.get("IntensityWeighted", True)
    edge = info.gaussian_edge if weighted else None
    rec = {}
    if DetectorOptions["AutoDetectorDistance"]:
        detector, spot_sd, duration_sd = FindOptimalDistanceFused(
            baked, elements, info.n_rays, detector, DetectorOptions["OptFor"],
            Amplitude=DetectorOptions.get("Amplitude"),
            Precision=DetectorOptions.get("Precision", 3),
            gaussian_edge=edge, device=chain.device, moments_fn=fn, last_moments=rec)
    else:
        rec = fn(detector.centre, detector.normal, detector._plane_rotation(), gaussian_edge=edge)
        sums = ft.moments_to_distance_sums(rec["moments"], (0.0,), rec["centre_distance"])
        res = ft.sums_to_stats(sums, rec["opl_ref"], (0.0,))
        spot_sd, duration_sd = float(res["spot_sd"][0]), float(res["duration_sd"][0])

    # transmission numerator: the surviving source weight; the optimizer's
    # pass carries it unless it ran unweighted
    if edge != info.gaussian_edge:
        rec = fn(detector.centre, detector.normal, detector._plane_rotation(),
                 gaussian_edge=info.gaussian_edge)
    etransmission = 100.0 * float(rec["moments"][0]) / fs.total_source_weight(
        info.n_rays, info.gaussian_edge, n_each=baked.n_each, n_sources=baked.n_sources,
        kind=baked.kind)
    chain.last_trace_engine = "cuda-scan" if chain.device.type == "cuda" else "torch-scan"

    if AnalysisOptions["verbose"]:
        print(niceline[:-1], flush=True)
        if isinstance(chain.description, str) and chain.description:
            print("***" + chain.description + "*** :")
        if chain.loop_variable_name is not None and chain.loop_variable_value is not None:
            print(f"For {chain.loop_variable_name} = {chain.loop_variable_value:f}:\n")
        print(f"The optical setup has an energy transmission of {etransmission:.1f}%.\n")
        if DetectorOptions["AutoDetectorDistance"]:
            _print_optimum(detector, spot_sd, duration_sd, DetectorOptions["OptFor"], weighted,
                           f" [{chain.last_trace_engine}: fused scan kernel over all rays]")
        else:
            print(f"At the detector distance of {detector.get_distance():.3f} mm we get:\n"
                  f"Spatial std : {spot_sd * 1e3:.3f} μm\n"
                  f"Temporal std : {duration_sd:.3e} fs  "
                  f"[{chain.last_trace_engine}: fused scan kernel over all rays]")
        print(niceline)
    return chain, detector, etransmission, spot_sd, duration_sd


def main(OpticalChainList, SourceProperties, DetectorOptions, AnalysisOptions,
         save_file_name=None, *, device="cuda", scan_engine="auto"):
    """Loop over the chain(s) on ``device``, keep the results, optionally
    save. A parameter scan (a list of chains) analysed at its last element
    runs through the scan engine (kernel K5, one packed record for every
    chain, no per-ray bundles) when :func:`_prepare_fused_scan` takes it;
    otherwise, or with ``scan_engine="off"``, its chains run through
    :func:`run_ART`: each through the fused kernels when it qualifies, and,
    when every chain would take the plain trace, on the bundles of one
    batched plain trace (:func:`_batched_final_bundles`) where that is
    possible."""
    if scan_engine not in SCAN_ENGINES:
        raise ValueError(f"scan_engine must be one of {SCAN_ENGINES}, got {scan_engine!r}")
    SourceProperties, DetectorOptions, AnalysisOptions = complete_defaults(
        SourceProperties, DetectorOptions, AnalysisOptions
    )
    keeper_names = ["OpticalChain", "Detector", "ETransmission", "SpotSizeSD", "DurationSD"]
    kept_data = {name: [] for name in keeper_names}

    if isinstance(OpticalChainList, OpticalChain):
        OpticalChainList = [OpticalChainList]
        loop = False
    elif not isinstance(OpticalChainList, list):
        raise ValueError(
            "The supplied OpticalChain is neither an OpticalChain-object, nor a list of those."
        )
    else:
        loop = True

    scan_spec = bundles = None
    last = len(OpticalChainList[0].optical_elements) - 1
    if loop and DetectorOptions["ReflectionNumber"] in (-1, last):
        if scan_engine == "auto":
            scan_spec = _prepare_fused_scan(OpticalChainList, AnalysisOptions)
        if scan_spec is None and all(c.takes_plain_trace() for c in OpticalChainList):
            bundles = _batched_final_bundles([c.to(device) for c in OpticalChainList])

    for i, chain in enumerate(OpticalChainList):
        print(f"Optical Chain {i}/{len(OpticalChainList)} ", end="", flush=True)
        if scan_spec is not None:
            values = _run_ART_fused_scan(chain, scan_spec, DetectorOptions, AnalysisOptions,
                                         device=device)
        else:
            values = run_ART(chain, SourceProperties, DetectorOptions, AnalysisOptions, loop,
                             None if bundles is None else bundles[i], device=device)
        for name, value in zip(keeper_names, values):
            kept_data[name].append(value)

    if AnalysisOptions["save_results"]:
        log.transient("...saving data...")
        save_compressed(kept_data, save_file_name)
        log.clear_line()
    return kept_data


def _batched_final_bundles(chains):
    """The final bundles of a scan's chains from ONE plain trace over the
    chains stacked on a leading axis (``parallel/mesh.stack_chains`` /
    ``trace_scan``), each marked ``last_trace_engine = "trace-scan"``; or
    None, with one stderr line, when the scan is not batched. :func:`main`
    asks for it only when every chain's ``trace_final`` would run the plain
    trace (below ``PALLAS_MIN_RAYS``, or ``ART_TPU_ENGINE=trace``), so a
    chain that qualifies for a kernel engine keeps it; the JAX package
    batches any scan its scan engine declines. Not batched:

    * the stacked sources would pass ``ART_TPU_SCAN_STACK_MAX_BYTES`` (default
      1e9; the JAX package's memory guard);
    * the chains differ in source ray count or in element structure beyond
      their poses (``parallel/mesh.scan_unbatchable``), decided before any
      trace. The JAX package instead falls back to the serial trace on any
      exception of its batched trace; here an error inside the trace
      raises."""
    from .ops.precision import default_dtype
    from .parallel.mesh import scan_unbatchable, stack_chains, trace_scan

    itemsize = torch.finfo(default_dtype()).bits // 8
    est_bytes = len(chains) * sum(
        leaf.numel() * (itemsize if leaf.is_floating_point() else leaf.element_size())
        for leaf in chains[0].source_rays)
    limit = float(os.environ.get("ART_TPU_SCAN_STACK_MAX_BYTES", 1e9))
    if est_bytes > limit:
        print(f"[attosecondraytracing_tpu_torch] batched scan skipped: stacking {len(chains)} "
              f"source bundles would allocate ~{est_bytes / 1e9:.1f} GB (limit {limit / 1e9:.1f} GB, "
              f"ART_TPU_SCAN_STACK_MAX_BYTES); tracing serially.", file=sys.stderr, flush=True)
        return None
    reason = scan_unbatchable(chains)
    if reason is not None:
        print(f"[attosecondraytracing_tpu_torch] batched scan unavailable (ValueError: {reason}); "
              f"falling back to the serial per-chain trace.", file=sys.stderr, flush=True)
        return None
    stacked_elements, stacked_sources = stack_chains(chains)
    outs = trace_scan(stacked_sources, stacked_elements)
    for c in chains:
        c.last_trace_engine = "trace-scan"
    return [RayBundle(*(x[i] for x in outs)) for i in range(len(chains))]


#: short names the JAX package exports at its top level
_SHORT_NAMES = {"mirrors": "models.mirrors", "supports": "models.supports",
                "masks": "models.masks", "sources": "models.sources",
                "defects": "models.defects"}


@contextlib.contextmanager
def _config_aliases():
    """Point the JAX package's module names (``attosecondraytracing_tpu`` and
    every ``attosecondraytracing_tpu.<module>`` this package has) at this
    package's modules in ``sys.modules`` while a CONFIG file runs, then
    restore them. A module this package lacks fails to import by name."""
    import pkgutil

    port = importlib.import_module(__package__)
    names = dict(_SHORT_NAMES)
    for info in pkgutil.walk_packages(port.__path__, prefix=__package__ + "."):
        rel = info.name[len(__package__) + 1:]
        names[rel] = rel
    aliases = {"attosecondraytracing_tpu": port}
    for rel, target in names.items():
        aliases["attosecondraytracing_tpu." + rel] = importlib.import_module(f"{__package__}.{target}")
    saved = {name: sys.modules.get(name) for name in aliases}
    try:
        sys.modules.update(aliases)
        yield
    finally:
        for name, module in saved.items():
            if module is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module


def run_config_file(path: str, n_rays: int | None = None, *, device="cuda", scan_engine="auto"):
    """Execute a CONFIG file and run :func:`main` on its contents on
    ``device``. ``n_rays`` overrides the config's ray count by regenerating
    each chain's source at that size (CLI ``--rays``); a chain whose source
    the user built keeps its own bundle, with one printed line, as in the
    JAX package's CLI. ``scan_engine`` as in :func:`main`."""
    global _CLI_ACTIVE
    device = resolve_device(device)
    log.print_banner()
    filename = os.path.basename(path)
    spec = importlib.util.spec_from_file_location(filename, path)
    config_module = importlib.util.module_from_spec(spec)
    # the CONFIG is importable by its file name while it runs, as in the JAX
    # package's CLI (pickling, dataclasses and self-imports look it up there)
    saved_module = sys.modules.get(filename)
    sys.modules[filename] = config_module
    _CLI_ACTIVE = True
    try:
        # a CONFIG may trace while it loads (examples/CONFIG_gradient_alignment.py
        # aligns its chain at import time): its chains take the CLI's device
        with _config_aliases(), config_device(device):
            spec.loader.exec_module(config_module)
        chains, sp, do, ao = load_config(config_module)
        if n_rays is not None:
            sp = dict(sp, NumberRays=int(n_rays))
            for chain in chains if isinstance(chains, list) else [chains]:
                try:
                    chain.resize_source(int(n_rays))
                except ValueError as exc:
                    print(f"[attosecondraytracing_tpu_torch] --rays ignored for "
                          f"'{chain.description}': {exc}", flush=True)
        return main(chains, sp, do, ao, save_file_name=os.path.splitext(path)[0], device=device,
                    scan_engine=scan_engine)
    finally:
        _CLI_ACTIVE = False
        if saved_module is None:
            sys.modules.pop(filename, None)
        else:
            sys.modules[filename] = saved_module


_USAGE = ("Usage: python -m attosecondraytracing_tpu_torch.main "
          "[--rays N] [--device cuda|cpu] [--scan-engine auto|off] [--profile DIR] CONFIG_FILE")


def _pop_option(argv, flag):
    if flag not in argv:
        return None
    i = argv.index(flag)
    if i + 1 >= len(argv):
        print(f"{flag} requires a value\n{_USAGE}")
        sys.exit(1)
    value = argv[i + 1]
    del argv[i : i + 2]
    return value


def profiled(out_dir, fn):
    """Run ``fn()`` under ``torch.profiler`` (host activity, and the card's
    where one is present) and return its result; write the Chrome trace to
    ``out_dir/trace.json.gz`` and print the wall time, the summed device
    kernel time with its share of the wall, and the top device kernels."""
    import gzip
    import shutil
    import time

    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        result = fn()
        if cuda:
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trace = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(trace)
    with open(trace, "rb") as src, gzip.open(trace + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(trace)
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    key = "self_device_time_total"  # named self_cuda_time_total before torch 2.4
    if kernels and not hasattr(kernels[0], key):
        key = "self_cuda_time_total"
    device_s = sum(getattr(e, key) for e in kernels) * 1e-6
    n_kernels = sum(e.count for e in kernels)
    print(f"[profile] wall {wall:.3f} s, device kernel time {device_s:.4f} s "
          f"({100.0 * device_s / wall:.2f} % of the wall), {n_kernels} device kernel calls; "
          f"trace {trace}.gz", flush=True)
    if cuda:
        print(events.table(sort_by=key, row_limit=12), flush=True)
    return result


def cli(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    rays = _pop_option(argv, "--rays")
    device = _pop_option(argv, "--device") or "cuda"
    scan_engine = _pop_option(argv, "--scan-engine") or os.environ.get("ART_TPU_SCAN_ENGINE", "auto")
    profile_dir = _pop_option(argv, "--profile")
    if not argv:
        print(_USAGE)
        sys.exit(1)
    try:
        n_rays = None if rays is None else int(float(rays))
    except ValueError:
        print("--rays requires a ray count (e.g. --rays 1e7)")
        sys.exit(1)
    if scan_engine not in SCAN_ENGINES:
        print(f"--scan-engine takes one of {', '.join(SCAN_ENGINES)}, got {scan_engine!r}\n{_USAGE}")
        sys.exit(1)

    def run():
        return run_config_file(argv[0], n_rays=n_rays, device=device, scan_engine=scan_engine)

    if profile_dir is None:
        run()
    else:
        profiled(profile_dir, run)


if __name__ == "__main__":
    cli()
