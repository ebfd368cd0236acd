"""K3 and K4 (``csrc/streamed_trace.cu``) on what a user's bundle may be,
on the CPU: their plain version (``ops/fused_trace.streamed_trace_ref``) on
a shuffled bundle whose dead rays sit among the live ones, against the
ordered bundle's outputs permuted and against the JAX package's streamed
trace of the same shuffled bundle; the wrapper on views off the 16-byte
boundary with a tail past the last whole warp of rays; and
``utils/kernel_ab.py``'s accounting of the kernels (SASS by stage on a
fixed listing, warp passes by tile).

The JAX side is ``pallas_trace`` (``_kernel`` / ``_kernel_fresh``) in
interpret mode for the flat and Zernike flagships; the JAX package takes
grid maps through its XLA trace only (``pallas_trace`` refuses them), so
the grid flagship is held against that (``trace_jit``), as
tests/test_torch_grid_kernels.py does. Tolerances: the float32 envelope of
tests/test_pallas.py:44-51 (positions 1e-3 mm median and 5e-2 mm max,
optical path 0.1 mm, incidence 1e-4 rad on rays alive in both; at most 2
edge rays may flip alive). The shuffled bundle's outputs equal the ordered
bundle's permuted bit for bit on alive rays: a ray's arithmetic is its own.
"""

import functools
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

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from attosecondraytracing_tpu.ops import pallas_trace as jpt  # noqa: E402
from attosecondraytracing_tpu.ops.trace import trace_jit  # noqa: E402
from attosecondraytracing_tpu_torch import interop  # noqa: E402
from attosecondraytracing_tpu_torch.ops import fused_trace as ft  # noqa: E402
from attosecondraytracing_tpu_torch.utils import kernel_ab as ab  # noqa: E402

torch.set_num_threads(1)

N = 4096
#: the stream views' offsets in elements (chip_smoke.py's K34_IN_OFFSETS)
OFFSETS = {"p": 1, "d": 2, "opl": 3, "opl_c": 1, "alive": 5, "incidence": 2}
FIELDS = ("p", "d", "opl", "opl_c", "alive", "incidence")


def _flagship(kind):
    """The flagship (round-hole mask, two grazing toroids in f-d-f) in the
    JAX package, its first toroid carrying tests/test_torch_zernike_trace.py's
    Zernike terms ("zernike") or tests/test_torch_grid_kernels.py's
    Fourier-PSD map ("grid")."""
    from attosecondraytracing_tpu.models import defects, masks, mirrors, supports
    from attosecondraytracing_tpu.models.placement import OEPlacement

    R, r = mirrors.ReturnOptimalToroidalRadii(500.0, 80.0)
    sup = supports.SupportRectangle(150, 32)
    tor = mirrors.MirrorToroidal(R, r, sup)
    first = {"flat": tor,
             "zernike": mirrors.DeformedMirror(tor, [defects.Zernike(sup, {(2, 0): 2e-4, (3, 1): -1e-4,
                                                                            (4, 2): 5e-5, (6, 3): 2e-5})]),
             "grid": mirrors.DeformedMirror(tor, [defects.Fourrier(sup, RMS=1e-4, smallest=1.0, seed=3)])}[kind]
    mask = masks.Mask(supports.SupportRoundHole(Radius=20, RadiusHole=7, CenterHoleX=0, CenterHoleY=0))
    props = {"Divergence": 25e-3, "SourceSize": 0, "Wavelength": 80e-6, "DeltaFT": 0.5, "NumberRays": N}
    return OEPlacement(props, [mask, first, tor], [400.0, 100.0, 500.0], [0.0, 80.0, -80.0], [0.0, 0.0, 0.0])


def _f32(bundle):
    return jax.tree.map(lambda x: np.asarray(x).astype(np.float32)
                        if np.issubdtype(np.asarray(x).dtype, np.floating) else np.asarray(x), bundle)


@functools.lru_cache(maxsize=None)
def _masked(kind):
    """(JAX float32 elements, port float64 elements, the flagship's source
    bundle and that bundle past the mask, both float32 numpy): the masked
    bundle's dead rays come in whole runs of the spiral."""
    chain = _flagship(kind)
    jels = [e.to_device(dtype=jnp.float32) for e in chain.optical_elements]
    tels = interop.elements_from_numpy(jax.tree.map(np.asarray, jels), device="cpu", dtype=torch.float64)
    src = _f32(chain.source_rays)
    return jels, tels, src, _f32(trace_jit(src, jels[:1], keep_history=False))


def _shuffled(bundle, order):
    return jax.tree.map(lambda x: x[order] if np.ndim(x) else x, bundle)


def _jax_streamed(bundle, jels, kind, fresh, ignore):
    """The JAX package's streamed trace of ``bundle``: its Pallas kernels
    (interpret mode), or its XLA trace for a grid map."""
    if kind == "grid":
        return trace_jit(bundle, jels, ignore_defects=ignore, keep_history=False)
    return jpt.pallas_trace(bundle, jels, fresh=fresh, ignore_defects=ignore)


def _assert_envelope(out, ref):
    ja, ta = np.asarray(ref.alive), out.alive.numpy()
    assert N // 10 < ja.sum()
    assert (ja != ta).sum() <= 2
    both = ja & ta
    dp = np.abs(out.p.numpy()[both] - np.asarray(ref.p)[both])
    assert np.median(dp) < 1e-3 and dp.max() < 5e-2
    assert np.abs(out.opl.numpy()[both] - np.asarray(ref.opl)[both]).max() < 0.1
    assert np.abs(out.incidence.numpy()[both] - np.asarray(ref.incidence)[both]).max() < 1e-4


def _assert_permuted(got, ordered, order):
    """``got`` (of the shuffled bundle) is ``ordered`` permuted: alive flags
    equal, every bit of p, d, opl, opl_c and incidence equal on alive rays."""
    order = torch.as_tensor(order)
    assert torch.equal(got.alive, ordered.alive[order])
    alive = got.alive
    for name in ("p", "d", "opl", "opl_c", "incidence"):
        x, y = getattr(got, name)[alive], getattr(ordered, name)[order][alive]
        assert torch.equal(x.view(torch.int32), y.view(torch.int32)), name


@pytest.mark.parametrize("kind", ["flat", "zernike", "grid"])
@pytest.mark.parametrize("ignore", [True, False])
def test_shuffled_bundle_is_the_ordered_one_permuted(kind, ignore):
    """K3's plain version on the masked flagship bundle shuffled (dead rays
    among the live ones, as a user's bundle need not come in spiral order)
    through the toroids equals the ordered bundle's outputs permuted, and
    the JAX package's streamed trace of the same shuffled bundle; K4's on
    the shuffled source bundle through the whole flagship likewise."""
    jels, tels, src, masked = _masked(kind)
    order = np.random.default_rng(14).permutation(N)
    for bundle, els, tab, fresh in ((masked, jels[1:], tels[1:], False), (src, jels, tels, True)):
        shuffled = _shuffled(bundle, order)
        table = ft.chain_table(None, tab)
        kw = dict(device="cpu", fresh=fresh, ignore_defects=ignore)
        ordered = ft.streamed_trace(table, interop.bundle_from_numpy(bundle, device="cpu", dtype=torch.float32),
                                    **kw)
        got = ft.streamed_trace(table, interop.bundle_from_numpy(shuffled, device="cpu", dtype=torch.float32),
                                **kw)
        _assert_permuted(got, ordered, order)
        _assert_envelope(got, _jax_streamed(shuffled, els, kind, fresh, ignore))
    assert not bool(np.asarray(masked.alive).all())


def _offset_view(x, offset):
    flat = x.reshape(-1)
    view = flat.new_empty(flat.numel() + offset + 7)[offset:offset + flat.numel()]
    view.copy_(flat)
    return view.view(x.shape)


@pytest.mark.parametrize("fresh", [True, False])
def test_views_off_the_boundary_with_a_tail_tile(fresh):
    """The streamed trace of a bundle whose streams are views starting off
    the 16-byte boundary (chip_smoke.py's offsets), with 13 rays past the
    last whole warp of 32, equals that of contiguous copies bit for bit;
    the wrapper takes such views as they are (no copy)."""
    _jels, tels, src, masked = _masked("zernike")
    bundle = interop.bundle_from_numpy(src if fresh else masked, device="cpu", dtype=torch.float32)
    n = N - 32 + 13
    head = bundle._replace(**{f: getattr(bundle, f)[:n].clone() for f in FIELDS + ("intensity",)})
    views = head._replace(**{f: _offset_view(getattr(head, f), OFFSETS[f]) for f in FIELDS})
    assert all(getattr(views, f).data_ptr() % 16 for f in FIELDS)
    assert all(getattr(views, f).is_contiguous() for f in FIELDS)
    table = ft.chain_table(None, tels if fresh else tels[1:])
    kw = dict(device="cpu", fresh=fresh, ignore_defects=False)
    got, ref = ft.streamed_trace(table, views, **kw), ft.streamed_trace(table, head, **kw)
    for x, y in zip(got, ref):
        assert torch.equal(x, y) or torch.equal(x.view(torch.int32), y.view(torch.int32))
    assert 0 < int(got.alive.sum()) < n


def _csrc_line(name, text):
    """The 1-based line of csrc/``name`` holding ``text``."""
    from attosecondraytracing_tpu_torch.ops import _cuda

    lines = (_cuda.CSRC / name).read_text().splitlines()
    return next(i + 1 for i, line in enumerate(lines) if text in line)


def test_k34_sass_stages_on_a_fixed_listing():
    """kernel_ab's SASS accounting of K3: the ray's loads, stores and
    to-lab map (streamed_trace.cu) are stage "setup", the walk's lines
    their stages (the vote "walk", a Zernike mirror's branch "defects");
    the warp passes of a launch count "setup" once per warp of 32 rays and
    the walk's stages per warp with a ray alive, so a shuffled bundle's
    warps walk more than the ordered one's."""
    from attosecondraytracing_tpu_torch.ops import _cuda

    st, tc = "streamed_trace.cu", "trace_common.cuh"
    load = _csrc_line(st, "s.px = in.p[3 * k];")
    store = _csrc_line(tc, "opl[k] = s.opl;")
    rays = _csrc_line(st, "  store_lab(ch, s, k, out.p, out.d, out.opl, out.opl_c, out.alive, out.inc);")
    walk_call = _csrc_line(st, "trace_chain<true, ACTIVE_VOTE, DEFECTS>(ch, s);")
    kernel = _csrc_line(st, "trace_ray<false, DEFECTS>(ch, n_rays, in, out);")
    vote = _csrc_line(tc, "!__any_sync(WARP_EXIT == ACTIVE_VOTE ? __activemask() : 0xffffffffu, s.alive))")
    mirror = _csrc_line(tc, "const int z = ch.zk_of[i];")
    maps_mirror = _csrc_line(tc, "mirror_step<WANT_INCIDENCE, DEFECTS>(ch, i, last")
    chain = _csrc_line(tc, "trace_chain_maps<WANT_INCIDENCE, WARP_EXIT, DEFECTS>(ch, TableMaps{ch}, s);")

    def group(*frames):
        lines = [f'        //## File "/r/{f}", line {n} inlined at "/r/{g}", line {m}'
                 for (f, n), (g, m) in zip(frames, frames[1:])]
        return "\n".join(lines + [f'        //## File "/r/{frames[-1][0]}", line {frames[-1][1]}'])

    listing = "\n".join([
        "\t.text._ZN3art21streamed_trace_kernelILi1EEEvNS_6ChainPEiNS_7StreamsES2_:",
        group((st, load), (st, kernel)),
        "        /*0000*/                   LDG.E R1, desc[UR4][R2.64] ;",
        group((tc, vote), (tc, chain), (st, walk_call), (st, kernel)),
        "        /*0010*/                   VOTE.ANY R0, PT, P0 ;",
        group((tc, mirror), (tc, maps_mirror), (tc, chain), (st, walk_call), (st, kernel)),
        "        /*0020*/                   FFMA R1, R2, R3, R4 ;",
        "        /*0030*/                   FMUL R1, R2, R3 ;",
        group((tc, store), (st, rays), (st, kernel)),
        "        /*0040*/                   STG.E desc[UR4][R2.64], R4 ;",
        "        /*0050*/                   EXIT ;",
    ])
    instructions = ab.parse_nvdisasm(listing, "streamed_trace_kernelILi1E")
    stages = ab.stage_counts(instructions, ab._Sources(_cuda.CSRC))
    assert stages["setup"]["total"] == 3 and stages["setup"]["memory"] == 1
    assert stages["walk"] == ab.pipe_counts(["VOTE"])
    assert stages["defects"] == ab.pipe_counts(["FFMA", "FMUL"])

    _jels, tels, src, _masked_ = _masked("zernike")
    table = ft.chain_table(None, tels)
    bundle = interop.bundle_from_numpy(src, device="cpu", dtype=torch.float32)
    n = N - 7
    bundle = bundle._replace(**{f: getattr(bundle, f)[:n] for f in FIELDS + ("intensity",)})
    ordered = ab.streamed_stage_warps(table, bundle, True, "cpu")
    shuffled = ab.streamed_stage_warps(table, ab.permuted(bundle, ab.shuffle_order(n, "cpu")), True, "cpu")
    assert ordered["setup"] == shuffled["setup"] == -(-n // 32)
    assert ordered["walk"] < shuffled["walk"] and ordered["defects"] < shuffled["defects"]
    assert ordered["premask"] == shuffled["premask"] == -(-n // 32)
    bound = ab.issue_bound({"setup": ab.pipe_counts(["FFMA"] * 4)}, {"setup": 132 * 4}, 1e9)
    assert bound["issue"] == pytest.approx(4 / 1e6)
    assert ab._defect_branch(table) == 1 and ab._defect_branch(ft.chain_table(None, tels[2:])) == 0
    assert [k for k in ab.K34_CASES if ab._case_runs(k, "flat")] == [
        "K4", "K4_shuffled", "K4_byhand", "K3", "K3_shuffled", "K3_masked", "K3_traced"]
    assert "K4_byhand" not in [k for k in ab.K34_CASES if ab._case_runs(k, "grid")]
