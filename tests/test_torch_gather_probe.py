"""The gather probes P4 and P5 of the port (``utils/gather_probe.py``)
against the JAX package's ``scripts/exp_mosaic_gather.py``: the script's
Pallas kernel bodies run through ``pl.pallas_call(..., interpret=True)`` on
the CPU (the script's own calls, recorded as they run), and the port's
plain versions on the same inputs. Gathers must be equal; the bilinear form
within the script's own tolerance, 1e-5 (``np.allclose`` atol at :35). The
trace's lookup (the plain version of ``grid_sums``) against the JAX
package's ``ops/defects._bilinear_multi`` on the same map, 1e-6 (float32
maps and points in both, one operation order)."""

import importlib.util
import sys
from pathlib import Path

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

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from attosecondraytracing_tpu.ops import defects as jodef  # noqa: E402
from attosecondraytracing_tpu_torch.ops import defects as todef  # noqa: E402
from attosecondraytracing_tpu_torch.utils import gather_probe as gp  # noqa: E402

torch.set_num_threads(1)

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "exp_mosaic_gather.py"


@pytest.fixture(scope="module")
def script_runs():
    """The script's eight probes as it runs them (P4's four forms through
    ``run``, P5's four cases through ``probe_take_along``), each recorded
    as (kernel name, inputs, output) from its ``pl.pallas_call``."""
    spec = importlib.util.spec_from_file_location("exp_mosaic_gather", SCRIPT)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    calls = []
    real = pl.pallas_call

    def recording(kernel, **kw):
        call = real(kernel, **kw)

        def run(*args):
            out = call(*args)
            name = getattr(kernel, "__name__", None) or kernel.func.__name__  # P5's are partials
            calls.append((name, [np.asarray(a) for a in args], np.asarray(out)))
            return out

        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", recording)
        ok = [script.run(name, kernel, check) for name, kernel, check in (
            ("row_gather", script.k_row_gather, script.GRID[script.IX, 0]),
            ("2d_gather", script.k_2d_gather, script.GRID[script.IX, script.IY]),
            ("flat_take", script.k_flat_take, script.GRID[script.IX, script.IY]),
            ("bilinear", script.k_bilinear, script.bilinear_ref()))]
        ok += list(script.probe_take_along().values())
    assert len(calls) == 8 and all(ok)  # the script's own checks pass in interpret mode
    return script, calls


def test_script_inputs_are_the_scripts(script_runs):
    """The port draws the script's inputs from its seed in its order."""
    script, calls = script_runs
    grid, x, y, operands = gp.script_inputs()
    for a, b in zip((grid, x, y), (script.GRID, script.X, script.Y)):
        np.testing.assert_array_equal(a, b)
    for op, (_name, args, _out) in zip(operands, calls[4:]):
        np.testing.assert_array_equal(op, args[0])


@pytest.mark.parametrize("form", gp.GATHER_FORMS)
def test_p4_plain_matches_script_kernel(script_runs, form):
    """P4's plain version (and its wrapper on the CPU, no launch) against
    the script's kernel body: gathers equal, bilinear within 1e-5."""
    _script, calls = script_runs
    name, (g, x, y), ref = calls[gp.GATHER_FORMS.index(form)]
    assert name == {"gather_2d": "k_2d_gather"}.get(form, f"k_{form}")
    gp.gather.launches = 0
    got = gp.gather(form, *(torch.from_numpy(a) for a in (g, x, y))).numpy()
    assert gp.gather.launches == 0 and got.shape == ref.shape == (8, 128)
    if form == "bilinear":
        np.testing.assert_allclose(got, ref, rtol=0, atol=gp.ATOL)
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", range(len(gp.TAKE_CASES)))
def test_p5_plain_matches_script_kernel(script_runs, case):
    """P5's plain version against the script's take_along_axis kernels:
    equal, on the script's four operand shapes and both axes."""
    _script, calls = script_runs
    _name, (op,), ref = calls[4 + case]
    _case, shape, axis = gp.TAKE_CASES[case]
    assert op.shape == shape
    gp.take_along.launches = 0
    got = gp.take_along(torch.from_numpy(op), axis).numpy()
    assert gp.take_along.launches == 0
    np.testing.assert_array_equal(got, ref)


def test_probe_runs_every_form_on_the_cpu():
    """probe() runs the eight forms at the script's shapes (plain versions
    here); a form the probe does not know raises."""
    outs, (g, x, y, operands) = gp.probe(device="cpu")
    assert set(outs) == set(gp.GATHER_FORMS) | {c[0] for c in gp.TAKE_CASES}
    assert all(outs[c[0]].shape == c[1] for c in gp.TAKE_CASES)
    with pytest.raises(ValueError):
        gp.gather("texture", g, x, y)
    with pytest.raises(ValueError):
        gp.take_along(operands[0], 2)


@pytest.mark.parametrize("order", ["uniform", "spiral"])
def test_lookup_plain_matches_jax_bilinear(order):
    """The trace's lookup (plain version of grid_sums: h + dh/dx + dh/dy)
    against the JAX package's _bilinear_multi on one float32 map, at points
    of both orders over the map and past its edge (clamped)."""
    shape = (48, 30)
    grid = gp.random_grid(shape, device="cpu", seed=3)
    x, y = gp.probe_points(shape, 4096, order, device="cpu")
    x, y = 1.1 * x - 1.0, 1.1 * y - 1.0  # some points past either edge
    got = gp.lookup(grid, x, y)
    maps = tuple(jnp.asarray(m.numpy()) for m in (grid.height, grid.slope_x, grid.slope_y))
    vals = jodef._bilinear_multi(maps, 0.0, 0.0, 1.0, 1.0, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))
    ref = np.asarray(vals[0] + vals[1] + vals[2])
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    assert float(x.min()) < 0 and float(x.max()) > shape[0] - 1
    assert todef._bilinear_multi is gp._bilinear_multi
