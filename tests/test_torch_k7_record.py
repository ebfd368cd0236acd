"""Kernel K7, the focus loss's primal pass (``ops/fused_grad.
prepare_stats_params`` with no tangent rows), on the CPU: its launch record
(the pose written into the chain record's maps and a detector record, as
``csrc/fused_grad.cu`` ``stats_primal_kernel`` reads them), the wrapper's
route to the kernel's entry point on a CUDA device (the card stubbed), the
binding of C interface version 7 alone (stand-in libraries), the SASS
accounting of ``utils/kernel_ab.py`` on fixed listings, and
``chip_smoke.py``'s operation count where the rays die against the plain
trace's alive counts. The kernel itself runs only on the card
(``chip_smoke.py``, phases k67, zernike and grid)."""

import contextlib
import sys

# tests/reference_shims.py leaves stand-in modules in sys.modules whose
# attributes are stubs; importing torch runs inspect.getmodule over them, so
# they are set aside while torch imports (as in tests/test_torch_gigascan.py).
_stubs = {name: mod for name, mod in list(sys.modules.items())
          if not isinstance(getattr(mod, "__file__", None), (str, type(None)))}
for _name in _stubs:
    del sys.modules[_name]
import torch  # noqa: E402

sys.modules.update(_stubs)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import chip_smoke  # noqa: E402
from attosecondraytracing_tpu_torch.analysis import alignment as al  # noqa: E402
from attosecondraytracing_tpu_torch.ops import _cuda  # noqa: E402
from attosecondraytracing_tpu_torch.ops import fused_grad as fg  # noqa: E402
from attosecondraytracing_tpu_torch.ops import fused_trace as ft  # noqa: E402
from attosecondraytracing_tpu_torch.ops import trace as tr  # noqa: E402
from attosecondraytracing_tpu_torch.utils import kernel_ab as ab  # noqa: E402

torch.set_num_threads(1)

N = 4096


@pytest.fixture(autouse=True, scope="module")
def _no_stub_modules():
    """Set tests/reference_shims.py's stub modules aside while this module's
    tests run: torch.func (K6's tangent rows, ``scalar_tangents``) looks
    modules up through inspect on its first transforms, which fails on the
    stubs (see the top of this file)."""
    with pytest.MonkeyPatch.context() as mp:
        for name, mod in list(sys.modules.items()):
            if not isinstance(getattr(mod, "__file__", None), (str, type(None))):
                mp.delitem(sys.modules, name)
        yield


def _loss(kind, n=N):
    """The ``kind`` flagship (kernel_ab's: undeformed, Zernike or grid
    first toroid) misaligned as scripts/bench_fused_grad.py misaligns it,
    its loss spec, pose vector and detector geometry."""
    host, spec = ab.flagship(n, kind)
    params = al.zero_params(len(host))
    params.angles[1, 0] = 2e-4
    params.shifts[1, 0] = 0.05
    rot = np.array([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])
    geo = (np.asarray(spec.rot, np.float64), np.asarray(spec.origin, np.float64),
           np.array([1500.0, 0.0, 0.0]), np.array([1.0, 0.0, 0.0]), rot)
    lspec = fg.FusedLossSpec(source_kind="cone", source_radius=float(spec.radius), elements=tuple(host),
                             opl_ref=1500.0, gaussian_edge=float(np.exp(-2.0)), n_rays=n,
                             duration_weight=0.0, survival_weight=1.0)
    return lspec, fg.chain_scalars_np(fg._apply_params_np(host, params), *geo), params, host, geo


@pytest.mark.parametrize("kind", ["flat", "zernike", "grid"])
def test_primal_record_holds_the_pose(kind):
    """Unpacked, K7's chain record holds the pose vector's maps in each
    element's (M, b), bit for bit, with the masks unfolded (no folded
    masks, the mask its own step), and its detector record holds the
    vector's detector centre, normal, e1 and e2 and the loss's opl_ref; the
    pose-independent rest equals K6's record (K5's pack_scan_chain)."""
    lspec, svec, *_ = _loss(kind)
    chain, source, det = fg.pack_primal_records(lspec, svec)
    n = len(lspec.elements)
    assert int(chain["n_elements"]) == n == 3 and int(chain["n_premasks"]) == 0
    maps = np.concatenate([np.concatenate([chain["el"][i]["M"], chain["el"][i]["b"]]) for i in range(n)])
    np.testing.assert_array_equal(maps, svec[:12 * n])
    plane = np.concatenate([det["c"], det["n"], det["e1"], det["e2"]])
    np.testing.assert_array_equal(plane, svec[12 * n:])
    assert float(det["opl_ref"]) == np.float32(lspec.opl_ref)
    assert float(det["inv_dn_chief"]) == 0.0 and float(det["centre_distance"]) == 0.0
    k6_chain, k6_source = fg.pack_stats_records(lspec)
    assert source.tobytes() == k6_source.tobytes()
    for i in range(n):
        for field in ("kind", "pre_begin", "pre_end", "cen", "s", "sup"):
            assert chain["el"][i][field].tobytes() == k6_chain["el"][i][field].tobytes()
    for field in ("ignore_defects", "n_zernike", "zk_of", "zk", "n_grids", "grid_begin", "grid_end"):
        assert chain[field].tobytes() == k6_chain[field].tobytes()
    assert int(chain["el"][0]["kind"]) == 0  # the mask
    assert int(chain["n_zernike"]) == (kind == "zernike") and int(chain["n_grids"]) == (kind == "grid")


def test_primal_record_layout_matches_the_kernel():
    """K7 reads the chain record (ChainP, its maps ElementP::M and ::b),
    the source record and a DetectorP by value, as csrc/fused_grad.cu
    declares its kernel; DETECTOR_T mirrors DetectorP of
    csrc/trace_common.cuh (four float[3], then opl_ref, inv_dn_chief,
    centre_distance: 60 bytes) and ElementP's map sits after its three
    ints (M at byte 12, b at 48)."""
    grad = (_cuda.CSRC / "fused_grad.cu").read_text()
    common = (_cuda.CSRC / "trace_common.cuh").read_text()
    assert ("stats_primal_kernel(const __grid_constant__ ChainP ch, const __grid_constant__ SourceP src,\n"
            "                    const __grid_constant__ DetectorP det," in grad)
    assert "struct DetectorP {\n  float c[3], n[3], e1[3], e2[3];\n  float opl_ref;\n  float inv_dn_chief;" in common
    assert ft.DETECTOR_T.itemsize == 60 and ft.DETECTOR_T.fields["opl_ref"][1] == 48
    assert "  int kind;\n  int pre_begin, pre_end;  // premasks" in common
    element = ft.CHAIN_T.fields["el"][0].base
    assert element.fields["M"][1] == 12 and element.fields["b"][1] == 48


class _Entry:
    """A stand-in entry point of a kernel library: returns ``value``."""

    def __init__(self, value):
        self.value, self.argtypes, self.restype = value, None, None

    def __call__(self, *args):
        return self.value


class _StandInLibrary:
    """A stand-in for ``ctypes.CDLL`` of a kernel library of this checkout's
    records: every ``art_*`` entry returns 0 but the record sizes, the
    version and those of ``changes``; an entry changed to None is absent."""

    def __init__(self, **changes):
        from attosecondraytracing_tpu_torch.ops.fused_scan import N_AUX

        self._entries = {}
        self._values = {"art_abi_version": _cuda.ABI_VERSION, "art_scan_aux_size": N_AUX,
                        "art_chain_params_size": ft.CHAIN_T.itemsize,
                        "art_source_params_size": ft.SOURCE_T.itemsize,
                        "art_detector_params_size": ft.DETECTOR_T.itemsize,
                        "art_image_params_size": ft.IMAGE_T.itemsize, **changes}

    def __getattr__(self, name):
        if not name.startswith("art_") or self._values.get(name, 0) is None:
            raise AttributeError(name)
        return self._entries.setdefault(name, _Entry(self._values.get(name, 0)))


def test_binding_takes_c_interface_version_7_only(monkeypatch):
    """``_cuda.load`` and ``kernel_ab.bind`` refuse a library of another C
    interface version (6, or none at all) with one message; ``_cuda.bind``
    binds every entry point of version 7, K1i's and K7's among them, and
    raises where the library's chain record disagrees with CHAIN_T."""
    import ctypes

    for version in (6, None):
        monkeypatch.setattr(ctypes, "CDLL", lambda path, v=version: _StandInLibrary(art_abi_version=v))
        with pytest.raises(RuntimeError, match=f"C interface version {version}: this checkout takes "
                                               "version 7 only"):
            _cuda.load("libkernels_old.so")
        with pytest.raises(RuntimeError, match=f"C interface version {version}: A/B takes version 7 only"):
            ab.bind("libkernels_old.so")
    monkeypatch.setattr(ctypes, "CDLL", lambda path: _StandInLibrary())
    lib = ab.bind("libkernels_other.so")
    for name in ("art_launch_fused_source_image", "art_launch_stats_primal", "art_launch_stats_params"):
        assert getattr(lib, name).argtypes and getattr(lib, name).restype is ctypes.c_int, name
    assert lib.art_launch_stats_primal.argtypes[:3] == [ctypes.c_void_p] * 3
    short = _StandInLibrary(art_chain_params_size=ft.CHAIN_T.fields["n_grids"][1])
    with pytest.raises(RuntimeError, match="art_chain_params_size: C struct is 2512 B, numpy record is "
                                           "2744 B"):
        _cuda.bind(short)


@pytest.mark.parametrize("tangents", [0, 18])
def test_wrapper_routes_to_the_kernel(tangents, monkeypatch):
    """On a CUDA device (the card stubbed: the launch functions record
    their calls) fused_stats_params takes K7's own entry point for P = 0
    and K6's for P > 0, launches once and counts it, and never runs the
    plain version; K7's grid is sized at its own rays per block."""
    lspec, svec, params, host, geo = _loss("flat")
    stangents = fg.scalar_tangents(host, params, *geo) if tangents else None
    calls = []

    def primal(chain, source, det, n_rays, chunk, grid, chunk_params, rows, stream, grids=()):
        calls.append(("K7", n_rays, grid, det))
        rows.zero_()

    def params_launch(chain, source, opl_ref, n_rays, chunk, grid, n_scal, svec_t, tang, chunk_params, rows,
                      stream, grids=()):
        calls.append(("K6", n_rays, grid, tang.shape))
        rows.zero_()

    def refuse(*_a, **_k):
        raise AssertionError("the plain version ran for a CUDA device")

    monkeypatch.setattr(ft, "_cuda_device", lambda device, name: torch.device("cpu"))
    monkeypatch.setattr(_cuda, "stats_primal_rays_per_block", lambda: 512)
    monkeypatch.setattr(_cuda, "moment_rays_per_block", lambda: 256)
    monkeypatch.setattr(_cuda, "tangent_batch", lambda: 6)
    monkeypatch.setattr(_cuda, "launch_stats_primal", primal)
    monkeypatch.setattr(_cuda, "launch_stats_params", params_launch)
    monkeypatch.setattr(fg, "stats_params_ref", refuse)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(fg.fused_stats_params, "launches", 0)
    monkeypatch.setattr(fg.fused_stats_params, "primal_launches", 0)
    chunks = fg._ray_chunks(lspec, 1024)
    p, t = fg.fused_stats_params(lspec, svec, stangents, chunks, device="cuda")
    assert len(calls) == 1 and t.shape == (tangents, 7) and np.all(p == 0.0)
    key, n_rays, grid, extra = calls[0]
    assert n_rays == N and len(chunks) == 4
    if tangents:
        assert key == "K6" and extra == (18, svec.size) and grid == ft.ray_grid([1024] * 4, 256)
        assert (fg.fused_stats_params.launches, fg.fused_stats_params.primal_launches) == (1, 0)
    else:
        assert key == "K7" and grid == ft.ray_grid([1024] * 4, 512)
        np.testing.assert_array_equal(extra["c"], svec[-12:-9])
        assert (fg.fused_stats_params.launches, fg.fused_stats_params.primal_launches) == (0, 1)
        loss = fg.fused_focus_loss(params, lspec, host, *geo, device="cuda")
        assert len(calls) == 2 and calls[1][0] == "K7" and fg.fused_stats_params.primal_launches == 2
        assert np.isfinite(loss)


def _line(name, text):
    """The 1-based line of csrc/``name`` holding ``text``."""
    lines = (_cuda.CSRC / name).read_text().splitlines()
    return next(i + 1 for i, line in enumerate(lines) if text in line)


def test_sass_pipe_grouping_on_fixed_listings():
    """kernel_ab groups SASS opcodes by the pipe that issues them (a
    predicate and modifiers do not change an opcode's pipe), in a
    cuobjdump listing and by stage in an nvdisasm listing with inline line
    information: the toroid case of the walk, the mask and mirror steps (the
    same functions in K7's walk and in trace_chain_maps), a mirror's defect
    branch, the source, the epilogue; the code of a support kind or source kind the flagship
    does not take is left out, and a subroutine ending in RET (an IEEE
    slow path) is counted apart."""
    sass = """
        Function : _Z19stats_primal_kernelILi0EEv6ChainP7SourceP9DetectorPiiiPK6float2Pd
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
        /*0010*/              @!PT FFMA.FTZ R2, R3, R4, R5 ;              /* 0x0000000403027223 */
        /*0020*/               @P0 IMAD.MOV.U32 R4, RZ, RZ, R5 ;          /* 0x000000ffff047224 */
        /*0030*/                   MUFU.RSQ R6, R7 ;                      /* 0x0000000700067308 */
        /*0040*/                   F2F.F64.F32 R8, R9 ;                   /* 0x0000000900087310 */
        /*0050*/                   VOTE.ANY R0, PT, P1 ;                  /* 0x0000000000007806 */
        /*0060*/                   S2R R0, SR_TID.X ;                     /* 0x0000000000007919 */
        Function : _Z26fused_source_trace_kernelILi0EEv6ChainP
        /*0000*/                   FADD R1, R2, R3 ;                      /* 0x0000000302017221 */
"""
    assert ab.pipe_counts(["FFMA", "LEA", "SHFL", "MUFU", "I2F", "LDS", "BSSY"]) == {
        "fp32": 1, "integer": 1, "mufu": 1, "conversion": 1, "memory": 1, "control": 1, "other": 1,
        "total": 7}
    assert ab.summarize_sass(sass).splitlines() == [
        "SASS stats_primal_kernel: 7 opcodes (MUFU 1, FCHK 0, CALL 0, LDC 1, SHFL 0, F2F 1, DADD 0, LDS 0, "
        "STS 0, BAR 0, BRA 0); by pipe: fp32 1, integer 1, mufu 1, conversion 1, memory 1, control 1, "
        "other 1"]
    walk_toroid = _line("fused_grad.cu", "h = toroid_hit(el, qx, qy, qz, ux, uy, uz, T_EPS);")
    walk_mask = _line("fused_grad.cu", "mask_step<false>(el, T_EPS, false")
    walk_mirror = _line("fused_grad.cu", "mirror_step<false, DEFECTS>(ch, i, false")
    mask_test = _line("trace_common.cuh", "const bool upd = s.alive && (t > t_eps) && !include(el.sup")
    reflect = _line("trace_common.cuh", "s.dx = ux - 2.0f * dn * h.nx;")
    zk_of = _line("trace_common.cuh", "const int z = ch.zk_of[i];")
    in_toroid = _line("trace_common.cuh", "h.hit = (t > t_eps) && (g_abs < tol) && (h.z < -R)")
    rect = _line("trace_common.cuh", "return in_rect(s.p[0], s.p[1], x, y);")
    round_hole = _line("trace_common.cuh", "return in_disk(s.p[0], x, y) && !in_disk(s.p[1], x - s.p[2]")
    seed = _line("trace_common.cuh", "const S a = -(ux * ux * i2A + uy * uy * i2B);")
    square = _line("trace_common.cuh", "s.px = x; s.py = y; s.pz = 0.0f;")
    cone = _line("trace_common.cuh", "s.dx = cx * inv; s.dy = cy * inv; s.dz = inv;")
    epi = _line("fused_grad.cu", "stats_geometry(det.c, det.n, det.e1, det.e2")
    walk_call = _line("fused_grad.cu", "k7_walk<DEFECTS>(ch, s);")
    src_call = _line("fused_grad.cu", "synth_source(src, k, cp.x, cp.y, s, rr);")
    # trace_chain_maps (K2 and the others) calls the same steps
    maps_mirror = _line("trace_common.cuh", "mirror_step<WANT_INCIDENCE, DEFECTS>(ch, i, last")
    maps_mask = _line("trace_common.cuh", "mask_step<WANT_INCIDENCE>(el, t_eps, last")
    maps_call = _line("trace_common.cuh", "trace_chain_maps<WANT_INCIDENCE, WARP_EXIT, DEFECTS>(ch, TableMaps{ch}, s);")

    def group(*frames):
        """nvdisasm's lines above an instruction: one per frame, innermost first."""
        lines = [f'        //## File "/r/{f}", line {n} inlined at "/r/{g}", line {m}'
                 for (f, n), (g, m) in zip(frames, frames[1:])]
        return "\n".join(lines + [f'        //## File "/r/{frames[-1][0]}", line {frames[-1][1]}'])

    tc, fg_cu = "trace_common.cuh", "fused_grad.cu"
    walk = [(fg_cu, walk_toroid), (fg_cu, walk_call)]
    listing = "\n".join([
        "\t.text._ZN3art19stats_primal_kernelILi0EEEvNS_6ChainPENS_7SourcePENS_9DetectorPEiiiPK6float2Pd:",
        group((tc, cone), (fg_cu, src_call)),
        "        /*0000*/                   FMUL R1, R2, R3 ;",
        group((tc, square), (fg_cu, src_call)),
        "        /*0010*/                   FADD R1, R2, R3 ;",
        group((tc, seed), *walk),
        "        /*0020*/                   FFMA R1, R2, R3, R4 ;",
        "        /*0030*/                   MUFU.SQRT R1, R2 ;",
        group((tc, rect), (tc, in_toroid), *walk),
        "        /*0040*/                   FSETP.GT.AND P0, PT, R2, R3, PT ;",
        group((tc, round_hole), (tc, in_toroid), *walk),
        "        /*0050*/                   FSETP.GT.AND P0, PT, R2, R3, PT ;",
        group((tc, round_hole), (tc, mask_test), (fg_cu, walk_mask), (fg_cu, walk_call)),
        "        /*0060*/                   FSETP.GT.AND P0, PT, R2, R3, PT ;",
        "        /*0070*/                   LOP3.LUT P0, RZ, R1, 0x1, RZ, 0xc0, !PT ;",
        group((tc, zk_of), (fg_cu, walk_mirror), (fg_cu, walk_call)),
        "        /*0080*/                   LDC R1, c[0x0][0x28] ;",
        group((tc, reflect), (fg_cu, walk_mirror), (fg_cu, walk_call)),
        "        /*0090*/                   FMUL R1, R2, R3 ;",
        group((tc, reflect), (tc, maps_mirror), (tc, maps_call)),
        "        /*00a0*/                   FFMA R1, R2, R3, R4 ;",
        group((tc, mask_test), (tc, maps_mask), (tc, maps_call)),
        "        /*00b0*/                   FSETP.GT.AND P0, PT, R2, R3, PT ;",
        group((fg_cu, epi)),
        "        /*00c0*/                   MUFU.EX2 R1, R2 ;",
        "        /*00d0*/                   EXIT ;",
        "        /*00e0*/                   MUFU.RCP R1, R2 ;",
        "        /*00f0*/                   RET.REL.NODEC R2 `(_ZN3art19stats_primal_kernelILi0EEEv) ;",
        "        /*0100*/                   BRA 0x100;",
        "\t.text._ZN3art26fused_source_trace_kernelILi0EEEvNS_6ChainPE:",
        "        /*0000*/                   FADD R1, R2, R3 ;",
    ])
    instructions = ab.parse_nvdisasm(listing, "stats_primal_kernelILi0E")
    assert [op for op, _c in instructions] == ["FMUL", "FADD", "FFMA", "MUFU", "FSETP", "FSETP", "FSETP",
                                               "LOP3", "LDC", "FMUL", "FFMA", "FSETP", "MUFU", "EXIT", "MUFU",
                                               "RET"]
    stages = ab.stage_counts(instructions, ab._Sources(_cuda.CSRC))
    assert list(stages) == ["source", "mask", "toroid", "defects", "mirror", "epilogue", "slow path"]
    assert stages["source"]["fp32"] == 1 and stages["source"]["total"] == 1  # the square's FADD left out
    # the walk is unrolled: its code holds one copy of an element step per element
    copies = ab._Sources(_cuda.CSRC).copies
    assert copies == ft.MAX_ELEMENTS

    def step(ops):
        return {k: v / copies for k, v in ab.pipe_counts(ops).items()}

    def plus(a, b):
        return {k: a[k] + b[k] for k in a}

    assert stages["toroid"] == step(["FFMA", "MUFU", "FSETP"])  # the round hole's left out
    # the mask and mirror steps are the same functions in both walks
    assert stages["mask"] == plus(step(["FSETP", "LOP3"]), ab.pipe_counts(["FSETP"]))
    assert stages["mirror"] == plus(step(["FMUL"]), ab.pipe_counts(["FFMA"]))
    assert stages["defects"] == step(["LDC"])  # a mirror's defect branch
    assert stages["epilogue"] == ab.pipe_counts(["MUFU", "EXIT"])
    assert stages["slow path"]["total"] == 2
    counts = {"toroid": ab.pipe_counts(["FFMA", "MUFU", "FSETP"]), "setup": ab.pipe_counts(["LDC"])}
    bound = ab.issue_bound(counts, {"toroid": 132 * 4, "setup": 132 * 8}, 1e9)
    assert bound["issue"] == pytest.approx((3 * 132 * 4 + 132 * 8) / (4 * 132 * 1e9) * 1e3)
    assert bound["mufu"] == pytest.approx(132 * 4 * 32 / (16 * 132 * 1e9) * 1e3)


def test_ops_where_rays_die_follow_the_plain_trace():
    """chip_smoke's operation count where the rays die, on the misaligned
    flagship (mask, two toroids) unfolded as K7 walks it: the source and
    the mask step for every ray, each toroid step for the rays alive
    entering it, the weight and the stats for the rays alive at the end,
    the alive counts those of the plain trace (the rays' alive mask after
    each chained step, counted here); the warps are those of 32 consecutive
    rays holding an alive ray."""
    lspec, svec, *_ = _loss("flat")
    table = fg.pose_table(lspec.elements, svec)
    chunks = fg._ray_chunks(lspec, 1000)
    src = fg.loss_source(lspec)
    rays, warps = ab.alive_by_stage(table, src, chunks, lspec.n_rays, "cpu", warps=True)
    alive_after, warp_after = [0, 0, 0, 0], [0, 0, 0, 0]
    for n_local, phase, k_frac in chunks:
        k = torch.arange(n_local)
        (px, py, pz), (dx, dy, dz), _rr = ft.synth_spec(src, k, lspec.n_rays, phase, k_frac)
        zeros = torch.zeros_like(px)
        s = tr.TraceState(px, py, pz, dx, dy, dz, zeros, zeros, torch.ones_like(px, dtype=torch.bool), zeros)
        masks = [s.alive]
        for el, (M, b) in zip(table.elements, table.maps):
            s = tr.chained_step(el, M, b, s, want_incidence=False, freeze_dead=False)
            masks.append(s.alive)
        for i, m in enumerate(masks):
            alive_after[i] += int(m.sum())
            pad = torch.cat([m, m.new_zeros((-n_local) % 32)])
            warp_after[i] += int(pad.view(-1, 32).any(dim=1).sum())
    assert rays == [alive_after[0], alive_after[0], alive_after[1], alive_after[1], alive_after[2],
                    alive_after[2], alive_after[3]]
    assert warps[0::2] == warp_after and warps[1::2] == warp_after[:3]
    assert 0 < alive_after[3] <= alive_after[1] < N
    ops = chip_smoke._ops_where_rays_die(table, rays, chip_smoke.OPS["weight"] + chip_smoke.OPS["stats"])
    assert ops == ((55 + 33 + 19) * N + (33 + 121) * (alive_after[1] + alive_after[2])
                   + (2 + 58) * alive_after[3])
