"""PyTorch port vs the JAX package: the trace on the flagship chain (round
mask + two grazing toroids), float64, on the identical chain and source fed
to both packages through ``interop``: alive masks identical, positions
within 1e-9 mm."""

import sys

# tests/reference_shims.py leaves stand-in modules (pyvista, colorcet, ...)
# in sys.modules whose every attribute is a stub object. Importing torch runs
# inspect.getmodule, which reads each module's __file__ and fails on them, so
# they are set aside while torch imports.
_stubs = {name: mod for name, mod in list(sys.modules.items())
          if not isinstance(getattr(mod, "__file__", None), (str, type(None)))}
for _name in _stubs:
    del sys.modules[_name]
import torch  # noqa: E402

sys.modules.update(_stubs)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from attosecondraytracing_tpu.models import masks as jmask
from attosecondraytracing_tpu.models import mirrors as jmirror
from attosecondraytracing_tpu.models import supports as jsupp
from attosecondraytracing_tpu.models.placement import OEPlacement as JPlacement
from attosecondraytracing_tpu.ops import trace as jtr
from attosecondraytracing_tpu_torch import interop
from attosecondraytracing_tpu_torch.ops import trace as ttr

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def flagship():
    R, r = jmirror.ReturnOptimalToroidalRadii(500.0, 80.0)
    tor = jmirror.MirrorToroidal(R, r, jsupp.SupportRectangle(150, 32))
    mask = jmask.Mask(jsupp.SupportRoundHole(20, 7, 0, 0))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6,
             "DeltaFT": 0.5, "NumberRays": 8000}
    chain = JPlacement(props, [mask, tor, tor], [400, 100, 500], [0, 80, -80], [0, 0, 0])
    jels = jax.tree.map(np.asarray, chain.device_elements())
    tels = interop.elements_from_numpy(jels, device="cpu", dtype=torch.float64)
    tsrc = interop.bundle_from_numpy(chain.source_rays, device="cpu", dtype=torch.float64)
    return chain.source_rays, jels, tsrc, tels


#: the JAX package takes arccos from the Abramowitz & Stegun 4.4.45
#: polynomial (|error| < 2e-8 rad); the port calls torch.acos
INCIDENCE_ATOL = 5e-8


def _assert_bundles(tb, jb, all_rays=False):
    alive = np.asarray(jb.alive)
    np.testing.assert_array_equal(tb.alive.numpy(), alive)
    sel = slice(None) if all_rays else alive
    for leaf in ("p", "d", "opl", "opl_c", "incidence"):
        np.testing.assert_allclose(getattr(tb, leaf).numpy()[sel], np.asarray(getattr(jb, leaf))[sel],
                                   rtol=0, atol=INCIDENCE_ATOL if leaf == "incidence" else 1e-9,
                                   err_msg=leaf)


@pytest.mark.parametrize("keep_history", [True, False], ids=["history", "final"])
def test_trace_matches_jax(flagship, keep_history):
    jsrc, jels, tsrc, tels = flagship
    jout = jtr.trace(jsrc, jels, keep_history=keep_history)
    tout = ttr.trace(tsrc, tels, keep_history=keep_history)
    if keep_history:
        assert len(tout) == len(jout) == 3
        for tb, jb in zip(tout, jout):
            # frozen dead rays keep exact coordinates in both packages
            _assert_bundles(tb, jb, all_rays=True)
        assert 0 < int(tout[-1].alive.sum()) < len(tsrc.alive)
    else:
        _assert_bundles(tout, jout, all_rays=True)


def test_compose_and_fold_match_jax(flagship):
    _, jels, _, tels = flagship
    jmaps, jfinal = jtr.compose_chain(jels)
    tmaps, tfinal = ttr.compose_chain(tels)
    for (jM, jb), (tM, tb) in zip(jmaps, tmaps):
        np.testing.assert_allclose(tM, jM, rtol=0, atol=1e-12)
        np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-9)
    jf = jtr.fold_premasks(jels, jmaps)
    tf = ttr.fold_premasks(tels, tmaps)
    assert [type(e).__name__ for e in jf[0]] == [type(e).__name__ for e in tf[0]]
    assert [len(p) for p in jf[2]] == [len(p) for p in tf[2]] == [1, 0]
    for (_, jM, jb), (_, tM, tb) in zip(jf[2][0], tf[2][0]):
        np.testing.assert_allclose(tM, jM, rtol=0, atol=1e-12)
        np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-9)


@pytest.mark.parametrize("freeze_dead", [True, False], ids=["freeze", "nofreeze"])
def test_run_chain_chained_matches_jax(flagship, freeze_dead):
    jsrc, jels, tsrc, tels = flagship
    jmaps, jfinal = jtr.compose_chain(jels)
    jfels, jfmaps, jpre = jtr.fold_premasks(jels, jmaps)
    tmaps, tfinal = ttr.compose_chain(tels)
    tfels, tfmaps, tpre = ttr.fold_premasks(tels, tmaps)
    js = jtr.run_chain_chained(jtr.bundle_to_state(jax.tree.map(jnp.asarray, jsrc)), jfels,
                               jfmaps, jfinal, premasks=jpre, freeze_dead=freeze_dead)
    ts = ttr.run_chain_chained(ttr.bundle_to_state(tsrc), tfels, tfmaps, tfinal,
                               premasks=tpre, freeze_dead=freeze_dead)
    alive = np.asarray(js.alive)
    np.testing.assert_array_equal(ts.alive.numpy(), alive)
    assert alive.sum() > 1000
    for leaf in ("px", "py", "pz", "dx", "dy", "dz", "opl", "opl_c", "incidence"):
        np.testing.assert_allclose(getattr(ts, leaf).numpy()[alive], np.asarray(getattr(js, leaf))[alive],
                                   rtol=0, atol=INCIDENCE_ATOL if leaf == "incidence" else 1e-9,
                                   err_msg=leaf)
    # the chained frames land where the lab-frame trace does
    out = ttr.trace(tsrc, tels, keep_history=False)
    np.testing.assert_array_equal(out.alive.numpy(), alive)
    np.testing.assert_allclose(ts.px.numpy()[alive], out.p[:, 0].numpy()[alive], atol=1e-8)


def test_trace_rejects_defects(flagship):
    """Surface defects trace (tests/test_torch_zernike_trace.py); a defect
    record of no known kind raises TypeError, as in the JAX package."""
    _, _, tsrc, tels = flagship
    bad = [tels[0], tels[1]._replace(defects=("zernike",)), tels[2]]
    with pytest.raises(TypeError, match="unknown defect type"):
        ttr.trace(tsrc, bad, keep_history=False)
