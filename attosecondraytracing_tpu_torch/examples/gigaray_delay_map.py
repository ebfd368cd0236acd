"""Giga-ray spot diagram + femtosecond delay map, rendered on the device
(counterpart of the repository's ``examples/gigaray_delay_map.py``).

The reference's SpotDiagram/DelayGraph (ART/ModuleAnalysisAndPlots.py:
133-440) fetch every traced ray to the host and scatter-plot them. Here the
source is synthesized inside the image kernel K1i, chunk by chunk, and
binned on the device (``analysis/gigascan.py``), so the ray count is limited
by patience, not memory: nothing per ray reaches the host.

    python -m attosecondraytracing_tpu_torch.examples.gigaray_delay_map            # 1e8 rays, card
    python -m attosecondraytracing_tpu_torch.examples.gigaray_delay_map 1e9        # a billion rays
    python -m attosecondraytracing_tpu_torch.examples.gigaray_delay_map 2e5 --device cpu   # smoke

Writes ``gigaray_delay_map.png`` into the current directory: the intensity
image (left) and the mean-delay map in fs (right), through the flagship
2-toroidal grazing-incidence chain with a slight roll misalignment, so the
delay map shows the characteristic spatio-temporal tilt. It needs
matplotlib for the PNG, and says so before it traces anything.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..analysis import plots
from ..analysis.gigascan import fused_source_images
from ..models import masks as mmask
from ..models import mirrors as mmirror
from ..models import supports as msupp
from ..models.detector import Detector
from ..models.placement import OEPlacement

FOCAL = 500.0
INCIDENCE = 80.0
OUT = "gigaray_delay_map.png"


def chain_and_detector(device):
    """The rolled flagship on ``device`` and its detector, autoplaced at the
    focal distance on the chain's traced bundle."""
    R, r = mmirror.ReturnOptimalToroidalRadii(FOCAL, INCIDENCE)
    toroidal = mmirror.MirrorToroidal(R, r, msupp.SupportRectangle(150, 32))
    mask = mmask.Mask(msupp.SupportRoundHole(20, 7, 0, 0))
    chain = OEPlacement(
        {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6,
         "DeltaFT": 0.5, "NumberRays": 200_000},
        [mask, toroidal, toroidal],
        [400.0, 100.0, 2 * FOCAL],
        [0.0, INCIDENCE, -INCIDENCE],
        Description="flagship: mask + 2 toroidals f-d-f",
    ).to(device)
    # sub-mrad roll misalignment: the refocus acquires the spatio-temporal
    # couplings this framework exists to quantify
    chain.rotate_OE(2, "roll", 0.05)
    det = Detector(chain.optical_elements[-1].position)
    det.autoplace(chain.trace_final(), FOCAL)
    return chain, det


def main(n_total: int, device="cuda") -> dict:
    """Make the images of ``n_total`` rays on ``device``, write the PNG
    and return :func:`fused_source_images`' result."""
    try:
        plots.pyplot()
    except ImportError as exc:
        raise SystemExit(f"gigaray_delay_map needs matplotlib to write {OUT}: {exc}") from exc
    chain, det = chain_and_detector(device)
    elements = chain.device_elements(torch.float32)
    res = fused_source_images(chain.source_spec, elements, det, n_total=n_total,
                              bins=(512, 512))

    fig = plots.GigaRayImages(res, title=chain.description)
    fig.savefig(OUT, dpi=130)
    d = res["mean_delay"]
    print(f"rays traced: {res['n_total']:.3e}, surviving weight {res['sum_w']:.3e}")
    print(f"delay-map spread (fs): {np.nanmin(d):.2f} .. {np.nanmax(d):.2f}")
    print(f"wrote {os.path.abspath(OUT)}")
    return res


def cli(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            raise SystemExit("--device requires a value (cuda or cpu)")
        device = argv[i + 1]
        del argv[i:i + 2]
    return main(int(float(argv[0])) if argv else 100_000_000, device=device)


if __name__ == "__main__":
    cli()
