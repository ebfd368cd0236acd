"""attosecondraytracing_tpu_torch — the PyTorch + CUDA port of
attosecondraytracing_tpu.

Structure-of-arrays ray bundles traced by batched PyTorch code, with the
production path (fused source trace, fused detector moments) in CUDA
kernels written for Hopper (``csrc/``), and the reference's user-facing
semantics (CONFIG scripts, OEPlacement, detector analysis) kept intact. The
JAX package beside it is the reference this port is tested against; this
package never imports JAX.

Quick start::

    from attosecondraytracing_tpu_torch import mirrors, supports, processing as mp
    from attosecondraytracing_tpu_torch.main import main
"""

__version__ = "0.1.0"

from . import processing  # noqa: F401
from .models import defects, masks, mirrors, sources, supports  # noqa: F401
from .models.chain import OpticalChain  # noqa: F401
from .models.detector import Detector  # noqa: F401
from .models.elements import OpticalElement  # noqa: F401
from .models.placement import OEPlacement  # noqa: F401
from .ops.bundle import RayBundle, make_bundle  # noqa: F401
