"""Default option dictionaries merged under user CONFIG values
(ART/DefaultOptions.py — same keys and defaults)."""


def default_analysis_options() -> dict:
    return {
        "verbose": True,
        "plot_Render": False,
        "maxRaysToRender": 200,
        "OEPointsToRender": 3000,
        "OEPointsScale": 5,
        "draw_mesh": False,
        "cycle_ray_colors": False,
        "DrawAiryAndFourier": True,
        "plot_SpotDiagram": False,
        "plot_DelaySpotDiagram": False,
        "plot_IntensitySpotDiagram": False,
        "plot_IncidenceSpotDiagram": False,
        "plot_DelayGraph": False,
        "plot_IntensityGraph": False,
        "plot_IncidenceGraph": False,
        "plot_DelayMirrorProjection": False,
        "plot_IntensityMirrorProjection": False,
        "plot_IncidenceMirrorProjection": False,
        "save_results": True,
        # additions of the JAX package (not in ART/DefaultOptions.py): spot/delay
        # plots render as device-binned images instead of per-ray scatters —
        # "auto" switches at production bundle sizes (PALLAS_MIN_RAYS) where
        # gathering every ray to the host is impractical; True/False force
        # either mode
        "image_plots": "auto",
        "image_bins": 256,
        # render the spot/delay images from THIS many rays synthesized in the
        # image kernel (analysis/gigascan) instead of the traced bundle —
        # detector images at ray counts far beyond what fits in memory (e.g.
        # 1e9). Requires a chain built by OEPlacement from a factory source
        # (a source_spec); None = use the traced bundle
        "image_rays": None,
    }


def default_source_properties() -> dict:
    return {
        "Divergence": 0,  # half-angle in rad
        "SourceSize": 0,  # diameter in mm
        "Wavelength": 50e-6,  # 50 nm in mm
        "DeltaFT": 1,  # Fourier-limited duration in fs
        "NumberRays": 1000,
    }


def default_detector_options() -> dict:
    return {
        "ReflectionNumber": -1,
        "ManualDetector": False,
        "DetectorCentre": None,
        "DetectorNormal": None,
        "DistanceDetector": None,
        "AutoDetectorDistance": False,
        "OptFor": "intensity",
    }


# reference-style module-level names (main.complete_defaults works on fresh
# copies per call, unlike the reference which mutates the module dicts in place)
DefaultAnalysisOptions = default_analysis_options()
DefaultSourceProperties = default_source_properties()
DefaultDetectorOptions = default_detector_options()
