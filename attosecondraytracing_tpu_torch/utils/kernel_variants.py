"""Design variants of the kernels as ``csrc/`` trees of their own, for
:mod:`.kernel_ab`.

    python -m attosecondraytracing_tpu_torch.utils.kernel_variants OUT_DIR [NAME ...]

Writes ``OUT_DIR/<name>/`` for each named variant (default: all of them; a
NAME ending in ``*`` takes every variant with that prefix): a copy of this
checkout's ``csrc/`` with the edits below applied to the text. The shipped
sources hold one choice; a variant is measured as a build of its own tree
against them (``kernel_ab OUT_DIR/rsq_ieee OUT_DIR/k8_tile1 ...``), never as
a switch in the shipped code. OUT_DIR belongs in a directory that
``.gitignore`` lists (``build/``).

The shared ray arithmetic (``dual.cuh``, ``trace_common.cuh``: every kernel
compiles it; time K2 for the trace, K1-K8 for who else moves):

* ``rsq_ieee`` / ``rsq_nr``: the reciprocal square root as an IEEE square
  root and divide (``1 / sqrtf``), or the special-function unit's with one
  Newton step, in place of the shipped ``rsqrtf``.
* ``div_ieee`` / ``div_frcp``: the chain walk's divides as IEEE divides, or
  as a product with the IEEE-rounded reciprocal ``__frcp_rn``, in place of
  the shipped product with the reciprocal unit's (``__fdividef``).
* ``sqrt_ieee``: the quadratic seeds' square roots as ``sqrtf`` in place of
  ``sqrt.approx``.
* ``ieee_all``: the three above together.
* ``no_warp_exit``: no early exit of a warp whose rays are all dead.
* ``unrolled``: the chain walk of the float kernels that read the chain
  record (K1-K4, K8) unrolled over ``MAX_ELEMENTS``, so the record's offsets
  are compile-time constants.
* ``reduce_shuffle``: the block reduction of K2, K5 and K7 as 5 float64
  shuffles per thread and column (the form before ``reduce_columns``).

K2 (``fused_trace.cu``): ``k2_r<R>``: R rays per thread, R in 8, 32 (shipped
16); ``k2_b<B>``: a register budget of B 256-thread blocks per SM, B in 6 (40
registers), 8 (32) (shipped: none, 48 registers, 5 blocks).

K1 (``fused_trace.cu``): ``k1_warp_loop``: K1 on the summing kernels'
warp-uniform loop (``for_thread_rays``, 4 rays per thread, the warp's 32
lanes voting), in place of the shipped one ray per thread whose active
lanes vote; ``k1_no_warp_exit``: the shipped K1 without the exit of a warp
whose rays are all dead.

K1i (``fused_trace.cu``): ``k1i_aggregate``: the lanes of a warp whose rays
share a pixel add their sums in one atomic per image (``__match_any_sync``),
in place of the shipped atomic per ray.

K8 (``fused_trace.cu``): ``k8_tile<T>``: T distances per pass over a
thread's kept rays, T in 1, 2, 8 (shipped 4); ``k8_r<R>``: R rays traced and
kept per thread, R in 4, 5 (32, 40 KB of shared memory a block), 8 (64 KB: 3
blocks per SM), 16 (128 KB: 1 block; shipped 6: 48 KB, 4 blocks per SM, as
many as its registers allow); ``k8_all_blocks``: a block without a surviving ray runs the
distance loop like any other; ``k8_columns_g<N>``: the 7
sums of a group of N distances in the thread's columns of shared memory,
added to ray by ray (N in 6: 2 blocks per SM, 20: 1 block), in place of the
shipped distance-outer loop with the sums in registers.

K7 (``fused_grad.cu``, ``stats_primal_kernel``):

* ``k7_r<R>``: R rays per thread (``K7_RAYS_PER_THREAD``), R in 8 (the
  parent's K7, ``stats_params_kernel<0>``, took 8), 16, 32; the shipped
  value's tree is a copy of the shipped sources (an A-against-A reading).
* ``k7_b<B>``: a register budget of B 256-thread blocks per SM in
  ``__launch_bounds__``, B in 6 (40 registers), 8 (32).
* ``k7_inline_other``: the plane and quadric hits inline in every unrolled
  element, in place of the shipped out-of-line ``k7_other_hit``.
* ``k7_runtime_walk``: the chain walked by trace_chain_maps (a runtime
  loop over the record, as K2 walks it), in place of K7's unrolled walk.

K6 (``fused_grad.cu``):

* ``g<G>_b<B>``: G tangent rows per block (``TANGENT_BATCH``) and a register
  budget of B 256-thread blocks per SM (``K6_MIN_BLOCKS`` in
  ``__launch_bounds__``), for G in 2, 3, 6 and B in 1, 2, 3, and G = 9
  (two groups for 18 rows) with B in 1, 2.
* ``..._reg``: each thread's 7 (1 + G) sums in registers, in place of the
  shipped column of dynamic shared memory (which then only stages the block
  reduction).
* ``..._ieee``: the tangent-only factors of ``dual.cuh`` as IEEE divides
  (``1 / b``, ``0.5 / sqrt``, ``-r / (2 a)``), as in the first version.

K6 on deformed mirrors (``trace_common.cuh``, the defect branch's forms for
``Dual<G>``; time ``--kernels K6 --chains flat,zernike,grid``; G = 3 is
``g3_b2``):

* ``k6_slopes_noinline``: the slope sums on ``Dual<G>`` (``zernike_slopes``,
  ``grid_slopes``, run only where ignore_defects is False) out of line
  (calls), in place of the shipped inline code.
* ``k6_two_walks``: K6's walk in two copies on a deformed chain's
  ignore_defects (the first one's slope normals folded away), in place of
  the shipped one (its SASS by stage counts both copies).
* ``k6_sums_first``: K6's defect hits take cos alpha after the defect sums,
  as the float kernels do (``dual.cuh`` ``is_dual`` false for ``Dual<G>``,
  its only use), in place of before them.
* ``k6_cos_first``: the float kernels' defect hits take cos alpha before
  the defect sums too, as K6's do (``is_dual`` true for every type).
* ``k6_dual_recurrence``: the recurrence and the grid lookups on
  ``Dual<G>`` (the ``Dual<G>`` overloads of the defect sums removed, so the
  generic ones run on it: the form before the float sums), in place of the
  shipped float sums with their tangents composed at the hit.
"""

from __future__ import annotations

import argparse
import re
import shutil
from pathlib import Path

from ..ops._cuda import CSRC


def _set(name, value, fname="fused_grad.cu"):
    return (fname, rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};")


def _lit(fname, old, new):
    """A literal (not a regular-expression) edit."""
    return (fname, re.escape(old), new)


#: the sums in registers; K6's 7 (1 + G) columns exceed the 48 KB a static
#: array may take, so its reduction stages them in the dynamic columns
_REG = [
    _lit("fused_grad.cu", "  SharedColumn<N_OUT> acc{sums_smem + threadIdx.x};", "  RegisterSums<N_OUT> acc{};"),
    _lit("fused_grad.cu", "template <int N>\nstruct SharedColumn {", """template <int N>
struct RegisterSums {
  float v[N];
  __device__ __forceinline__ float& operator[](int m) { return v[m]; }
  // the block's sums of every thread's N, one float64 row
  __device__ __forceinline__ void reduce(double* __restrict__ row) const {
    if constexpr (N * MOMENT_THREADS * sizeof(float) > 48 * 1024) {
#pragma unroll
      for (int m = 0; m < N; ++m) sums_smem[m * MOMENT_THREADS + threadIdx.x] = v[m];
      __syncthreads();
      reduce_columns(sums_smem, N, row);
    } else {
      reduce_to_row<N>(v, row);
    }
  }
};
template <int N>
struct SharedColumn {"""),
]

_IEEE = [
    ("dual.cuh", r"return __fdividef\(1\.0f, b\);", "return 1.0f / b;"),
    ("dual.cuh", r"0\.5f \* tangent_rcp\(r\.v\)", "0.5f / r.v"),
    ("dual.cuh", r"-0\.5f \* r\.v \* r\.v \* r\.v;", "-0.5f * r.v / a.v;"),
]

_RSQ = "float rsq(float x) { return rsqrtf(x); }"
_DIV = "float div_(float a, float b) { return __fdividef(a, b); }"
_SQRT = """  float y;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
"""
_RSQ_IEEE = _lit("dual.cuh", _RSQ, "float rsq(float x) { return 1.0f / sqrtf(x); }")
_DIV_IEEE = _lit("dual.cuh", _DIV, "float div_(float a, float b) { return a / b; }")
_SQRT_IEEE = _lit("dual.cuh", _SQRT, "  return sqrtf(x);\n")

_UNROLLED = _lit(
    "trace_common.cuh",
    "  for (int i = 0; i < ch.n_elements; ++i) {\n    const ElementP& el = ch.el[i];",
    """  constexpr int CHAIN_UNROLL =
      sizeof(S) == sizeof(float) && std::is_same<Maps, TableMaps>::value ? MAX_ELEMENTS : 1;
#pragma unroll CHAIN_UNROLL
  for (int i = 0; i < MAX_ELEMENTS; ++i) {
    if (i >= ch.n_elements) break;
    const ElementP& el = ch.el[i];""")

_REDUCE_SHUFFLE = _lit(
    "trace_common.cuh",
    """  __shared__ float cols[N * MOMENT_THREADS];
#pragma unroll
  for (int m = 0; m < N; ++m) cols[m * MOMENT_THREADS + threadIdx.x] = acc[m];
  __syncthreads();
  reduce_columns(cols, N, row);
""",
    """  __shared__ double part[MOMENT_THREADS / 32][N];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < N; ++m) {
    double v = (double)acc[m];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) part[warp][m] = v;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    double v = 0.0;
#pragma unroll
    for (int w = 0; w < MOMENT_THREADS / 32; ++w) v += part[w][threadIdx.x];
    row[threadIdx.x] = v;
  }
""")

#: K8's second phase with the sums of a group of distances in the thread's
#: columns of shared memory (volatile, so they stay there), ray-outer
_K8_COLUMNS_PHASE = """  // phase 2: the distances in groups of K8_GROUP, their 7 sums each in the
  // thread's shared columns, added to ray by ray
  volatile float* sums = cols + threadIdx.x;
  for (int j0 = 0; j0 < n_dist; j0 += K8_GROUP) {
    const int nj = min(K8_GROUP, n_dist - j0);
    __syncthreads();  // the group before this one is reduced
    for (int m = 0; m < nj * N_STATS; ++m) sums[m * MOMENT_THREADS] = 0.0f;
    for (int i = 0; i < n_kept; ++i) {
      const float* ray = kept + i * N_KEPT * MOMENT_THREADS;
      StatsGeom<float> g;
      g.t0 = ray[0 * MOMENT_THREADS];
      g.inv_dn = ray[1 * MOMENT_THREADS];
      g.a1 = ray[2 * MOMENT_THREADS];
      g.a2 = ray[3 * MOMENT_THREADS];
      g.g1 = ray[4 * MOMENT_THREADS];
      g.g2 = ray[5 * MOMENT_THREADS];
      g.dsmall = ray[6 * MOMENT_THREADS];
      const float w = ray[7 * MOMENT_THREADS];
      for (int j = 0; j < nj; ++j) {
        const float2 dp = dist_params[j0 + j];
        const float tj = g.t0 - dp.x * g.inv_dn;
        float terms[N_STATS];
        stats_terms(g, tj, sub_rn(add_rn(g.dsmall, tj), dp.y), w, terms);
#pragma unroll
        for (int f = 0; f < N_STATS; ++f) sums[(j * N_STATS + f) * MOMENT_THREADS] += terms[f];
      }
    }
    __syncthreads();
    reduce_columns(cols, nj * N_STATS, row + j0 * N_STATS);
  }
}
"""


def _k8_columns(group):
    return [
        ("fused_trace.cu", r"  // phase 2: the distances, a tile at a time\n.*?\n}\n",
         _K8_COLUMNS_PHASE, re.DOTALL),
        _lit("fused_trace.cu", "constexpr int K8_TILE = 4;", f"constexpr int K8_GROUP = {group};"),
        _lit("fused_trace.cu", "(K8_RAYS_PER_THREAD * N_KEPT + N_STATS) * MOMENT_THREADS",
             "(K8_RAYS_PER_THREAD * N_KEPT + K8_GROUP * N_STATS) * MOMENT_THREADS"),
    ]


def variants() -> dict:
    """{name: [(file, pattern, replacement[, re flags]), ...]}"""
    out = {
        "rsq_ieee": [_RSQ_IEEE],
        "rsq_nr": [_lit("dual.cuh", _RSQ, "float rsq(float x) {\n  const float y = rsqrtf(x);\n"
                        "  return y * fmaf(-0.5f * x * y, y, 1.5f);\n}")],
        "div_ieee": [_DIV_IEEE],
        "div_frcp": [_lit("dual.cuh", _DIV,
                          "float div_(float a, float b) { return a * __frcp_rn(b); }")],
        "sqrt_ieee": [_SQRT_IEEE],
        "ieee_all": [_RSQ_IEEE, _DIV_IEEE, _SQRT_IEEE],
        "no_warp_exit": [_lit("trace_common.cuh", "if (WARP_EXIT != NO_EXIT &&", "if (false &&")],
        "unrolled": [_UNROLLED],
        "reduce_shuffle": [_REDUCE_SHUFFLE],
        "k8_all_blocks": [_lit("fused_trace.cu", "if (__syncthreads_or(n_kept) == 0) {",
                               "if (false) {")],
        "k8_columns_g6": _k8_columns(6),
        "k8_columns_g20": _k8_columns(20),
    }
    out["k1_warp_loop"] = [
        ("fused_trace.cu", r"  const int k = blockIdx.x \* K1_THREADS.*?\n}\n",
         """  for_thread_rays<4>(blockIdx.x * 4 * K1_THREADS + (int)threadIdx.x, n_rays,
                     [&](int k, bool in_range) {
                       Ray s;
                       float rr;
                       synth_source(src, k, phase, k_frac, s, rr);
                       s.alive = in_range;
                       trace_chain<true, WARP_VOTE, DEFECTS>(ch, s);
                       if (in_range) store_lab(ch, s, k, p, d, opl, opl_c, alive, inc);
                     });
}
""", re.DOTALL),
        _lit("fused_trace.cu", "const int blocks = (n_rays + K1_THREADS - 1) / K1_THREADS;",
             "const int blocks = (n_rays + 4 * K1_THREADS - 1) / (4 * K1_THREADS);")]
    out["k1_no_warp_exit"] = [_lit("fused_trace.cu", "trace_chain<true, ACTIVE_VOTE, DEFECTS>(ch, s);",
                                   "trace_chain<true, NO_EXIT, DEFECTS>(ch, s);")]
    out["k1i_aggregate"] = [_lit("fused_trace.cu", """  if (flat < 0) return;
  atomicAdd(w_img + flat, (double)w);
  atomicAdd(wd_img + flat, (double)wd);
""", """  const unsigned peers = __match_any_sync(0xffffffffu, flat);
  if (flat < 0) return;  // the whole group of lanes without a pixel
  double sw = 0.0, swd = 0.0;
  for (unsigned m = peers; m; m &= m - 1) {
    const int lane = __ffs(m) - 1;
    sw += __shfl_sync(peers, (double)w, lane);
    swd += __shfl_sync(peers, (double)wd, lane);
  }
  if ((int)(threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(w_img + flat, sw);
    atomicAdd(wd_img + flat, swd);
  }
""")]
    for R in (8, 16, 32):
        out[f"k7_r{R}"] = [_set("K7_RAYS_PER_THREAD", R)]
    for B in (6, 8):
        out[f"k7_b{B}"] = [_lit("fused_grad.cu", "__launch_bounds__(MOMENT_THREADS)\nstats_primal_kernel",
                                f"__launch_bounds__(MOMENT_THREADS, {B})\nstats_primal_kernel")]
    out["k7_inline_other"] = [_lit("fused_grad.cu", "__device__ __noinline__ HitT<float> k7_other_hit",
                                   "__device__ __forceinline__ HitT<float> k7_other_hit")]
    out["k7_runtime_walk"] = [
        _lit("fused_grad.cu", "    k7_walk<DEFECTS>(ch, s);\n", "    trace_chain<false, WARP_VOTE, DEFECTS>(ch, s);\n")]
    for R in (8, 32):
        out[f"k2_r{R}"] = [_set("K2_RAYS_PER_THREAD", R, "fused_trace.cu")]
    for B in (6, 8):
        out[f"k2_b{B}"] = [_lit("fused_trace.cu", "__launch_bounds__(MOMENT_THREADS)\n"
                                "fused_source_moments_kernel",
                                f"__launch_bounds__(MOMENT_THREADS, {B})\nfused_source_moments_kernel")]
    for T in (1, 2, 8):
        out[f"k8_tile{T}"] = [_set("K8_TILE", T, "fused_trace.cu")]
    for R in (4, 5, 8, 16):
        out[f"k8_r{R}"] = [_set("K8_RAYS_PER_THREAD", R, "fused_trace.cu")]
    for G, budgets in ((2, (1, 2, 3)), (3, (1, 2, 3)), (6, (1, 2, 3)), (9, (1, 2))):
        for B in budgets:
            out[f"g{G}_b{B}"] = [_set("TANGENT_BATCH", G), _set("K6_MIN_BLOCKS", B)]
    for base in ("g2_b3", "g3_b1", "g3_b2", "g3_b3", "g6_b1", "g6_b2", "g6_b3", "g9_b1", "g9_b2"):
        out[f"{base}_reg"] = out[base] + _REG
    out["g6_b2_ieee"] = out["g6_b2"] + _IEEE
    out["k6_slopes_noinline"] = [
        _lit("trace_common.cuh", f"__device__ __forceinline__ void {head}", f"__device__ __noinline__ void {head}")
        for head in ("zernike_slopes(const ZernikeP& zk, Dual<G>", "grid_slopes(const GridP& g, Dual<G>")]
    out["k6_two_walks"] = [
        _lit("fused_grad.cu", """  trace_runtime_pose<DEFECTS>(ch, src, pose, min(chunk, n_rays - br.chunk * chunk), br.first,
                              cp.x, cp.y, [&](const RayT<S>& s, float rr) {""",
             "  const auto sums = [&](const RayT<S>& s, float rr) {"),
        _lit("fused_grad.cu", """  });
  acc.reduce(rows""", """  };
  const int n_local = min(chunk, n_rays - br.chunk * chunk);
  if (DEFECTS != NO_DEFECTS && ch.ignore_defects != 0)
    trace_runtime_pose<DEFECTS>(ch, src, pose, n_local, br.first, cp.x, cp.y, sums);
  else
    trace_runtime_pose<DEFECTS>(ch, src, pose, n_local, br.first, cp.x, cp.y, sums);
  acc.reduce(rows""")]
    out["k6_sums_first"] = [_lit("dual.cuh", "inline constexpr bool is_dual<Dual<G>> = true;",
                                 "inline constexpr bool is_dual<Dual<G>> = false;")]
    out["k6_cos_first"] = [_lit("dual.cuh", "template <typename S>\ninline constexpr bool is_dual = false;",
                                "template <typename S>\ninline constexpr bool is_dual = true;")]
    out["k6_dual_recurrence"] = [
        ("trace_common.cuh", r"// the height: the recurrence with slopes on the primal.*?(?=// The hit on a mirror)", "",
         re.DOTALL)]
    return out


def select(names) -> list:
    """The variants ``names`` pick (all of them when empty; ``prefix*`` takes
    every variant that starts with the prefix)."""
    known = variants()
    if not names:
        return list(known)
    out = []
    for name in names:
        found = [k for k in known if k.startswith(name[:-1])] if name.endswith("*") else [name]
        if not found or not set(found) <= set(known):
            raise SystemExit(f"no variant {name!r}; known: {', '.join(known)}")
        out += found
    return out


def write(out_dir: Path, name: str) -> Path:
    """Write variant ``name``'s tree under ``out_dir``; every edit must
    apply exactly once."""
    dst = Path(out_dir) / name
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(CSRC, dst)
    for fname, pattern, repl, *flags in variants()[name]:
        path = dst / fname
        text, n = re.subn(pattern, lambda _m: repl, path.read_text(), flags=flags[0] if flags else 0)
        if n != 1:
            raise RuntimeError(f"variant {name}: {pattern!r} matched {n} times in {fname}")
        path.write_text(text)
    return dst


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("out_dir", type=Path)
    parser.add_argument("names", nargs="*")
    args = parser.parse_args(argv)
    for name in select(args.names):
        print(write(args.out_dir, name), flush=True)


if __name__ == "__main__":
    main()
