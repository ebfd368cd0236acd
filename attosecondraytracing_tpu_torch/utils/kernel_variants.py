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

K3 and K4 (``streamed_trace.cu``; time ``--kernels K3,K4 --chains
flat,zernike,grid``):

* ``k34_no_warp_exit``: every ray walks the whole chain, the ones that
  entered dead and the warps whose rays all died too (the parent's walk,
  ``NO_EXIT``).
* ``k34_prefetch``: the second design: a thread traces 2 rays, 256 apart,
  the float streams of its next ray in flight into its own slot of shared
  memory (4-byte ``cp.async`` copies, no register held) while it traces
  one, in place of the shipped loads into registers.
* ``k34_tiles``: the first design: each warp walks 32-ray tiles of a grid
  as large as the card holds, the next tile's streams in flight as 16-byte
  copies into a ring of tiles in shared memory (any stream offset), in
  place of the shipped one ray a thread.
* ``k34_bulk``: the third design: thread 0 brings the block's tile of
  every input stream into shared memory with the Tensor Memory
  Accelerator (one ``cp.async.bulk`` a stream, rounded out to 16-byte
  boundaries, completing on an mbarrier), every thread waits for it and
  reads its ray there, in place of the shipped loads into registers.
* ``k34_t128``: 128-thread blocks, in place of 256.

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
    out.update(_k34_variants())
    return out


#: the first design of K3/K4's streams: warps walking 32-ray tiles with
#: 16-byte copies into a ring in shared memory
_K34_TILES = r"""// K3 and K4 on warps' tiles (utils/kernel_variants.py k34_tiles): each warp
// walks 32-ray tiles of a grid as large as the card holds, the next tile's
// streams in flight as 16-byte cp.async copies into a ring of K34_STAGES
// tiles in shared memory (any stream offset: the chunks from the 16-byte
// boundary at or below the tile), the outputs stored from registers.
#include <cuda_runtime.h>

#include <cstdint>

#include "trace_common.cuh"

namespace art {

constexpr int K34_THREADS = 256;
constexpr int K34_WARPS = K34_THREADS / 32;
// tiles of a warp in shared memory: the one traced and the ones loading
constexpr int K34_STAGES = 2;
// rays of a warp's tile, one a lane
constexpr int TILE = 32;

// one stream's tile in shared memory: its bytes and the up to 15 before
// them in their first 16-byte chunk (TILE * bytes_per_ray is a multiple of
// 16, so every tile of a stream starts at the stream's own offset in its
// chunk)
__host__ __device__ constexpr int tile_buffer(int bytes_per_ray) { return TILE * bytes_per_ray + 16; }
constexpr int OFF_P = 0;
constexpr int OFF_D = OFF_P + tile_buffer(12);
constexpr int OFF_OPL = OFF_D + tile_buffer(12);
constexpr int OFF_OPL_C = OFF_OPL + tile_buffer(4);
constexpr int OFF_INC = OFF_OPL_C + tile_buffer(4);
constexpr int OFF_ALIVE = OFF_INC + tile_buffer(4);
// every stream's tile (K3's inputs, K3's and K4's outputs); K4 reads p, d
constexpr int TILE_BYTES = OFF_ALIVE + tile_buffer(1);
template <bool FRESH>
__host__ __device__ constexpr int in_tile_bytes() { return FRESH ? OFF_OPL : TILE_BYTES; }
template <bool FRESH>
__host__ __device__ constexpr int warp_smem_bytes() { return K34_STAGES * in_tile_bytes<FRESH>(); }

// the six streams of a bundle, as bytes (K4's inputs: p, d only)
struct Streams {
  unsigned char *p, *d, *opl, *opl_c, *alive, *inc;
};

__device__ __forceinline__ int skew(const void* g) {
  return (int)(reinterpret_cast<uintptr_t>(g) & 15);
}

// each input stream's offset in its 16-byte chunk: a tile of a stream starts
// there too (TILE * bytes per ray is a multiple of 16)
struct Skews {
  int p, d, opl, opl_c, alive, inc;
  __device__ __forceinline__ explicit Skews(const Streams& s)
      : p(skew(s.p)), d(skew(s.d)), opl(skew(s.opl)), opl_c(skew(s.opl_c)), alive(skew(s.alive)),
        inc(skew(s.inc)) {}
};

__device__ __forceinline__ void cp_async16(unsigned char* smem, const unsigned char* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying the bytes [g, g + n) of a stream into buf (16-byte aligned
// shared memory) as whole 16-byte chunks from the boundary at or below g:
// byte g + i lands at buf[sk + i], sk = skew(g). A tile's stream is at most
// 12 * TILE + 15 bytes, 25 chunks: one copy a lane.
__device__ __forceinline__ void load_tile(unsigned char* buf, const unsigned char* g, int sk, int n,
                                          int lane) {
  if (lane < (sk + n + 15) >> 4) cp_async16(buf + 16 * lane, g - sk + 16 * lane);
}

// Start the copies of tile t's input streams into one stage of the warp's
// ring, and commit them as one group (an empty group past the last tile,
// so every iteration waits on the same count).
template <bool FRESH>
__device__ __forceinline__ void load_streams(const Streams& in, const Skews& sk, int n_rays, int t,
                                             int n_tiles, unsigned char* stage, int lane) {
  if (t < n_tiles) {
    const size_t first = (size_t)t * TILE;
    const int n = min(TILE, n_rays - (int)first);
    load_tile(stage + OFF_P, in.p + 12 * first, sk.p, 12 * n, lane);
    load_tile(stage + OFF_D, in.d + 12 * first, sk.d, 12 * n, lane);
    if constexpr (!FRESH) {
      load_tile(stage + OFF_OPL, in.opl + 4 * first, sk.opl, 4 * n, lane);
      load_tile(stage + OFF_OPL_C, in.opl_c + 4 * first, sk.opl_c, 4 * n, lane);
      load_tile(stage + OFF_INC, in.inc + 4 * first, sk.inc, 4 * n, lane);
      load_tile(stage + OFF_ALIVE, in.alive + first, sk.alive, n, lane);
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ float ld_f(const unsigned char* b) { return *reinterpret_cast<const float*>(b); }

// Ray k's outputs, from the lane's registers.
__device__ __forceinline__ void store_ray(const Streams& out, int k, const float* P, const float* D,
                                          const Ray& s) {
  float* p = reinterpret_cast<float*>(out.p) + 3 * k;
  float* d = reinterpret_cast<float*>(out.d) + 3 * k;
  p[0] = P[0];
  p[1] = P[1];
  p[2] = P[2];
  d[0] = D[0];
  d[1] = D[1];
  d[2] = D[2];
  reinterpret_cast<float*>(out.opl)[k] = s.opl;
  reinterpret_cast<float*>(out.opl_c)[k] = s.opl_c;
  reinterpret_cast<float*>(out.inc)[k] = s.inc;
  out.alive[k] = s.alive ? 1 : 0;
}

// The warp's tiles: K3 (FRESH false) or K4; smem is the warp's ring of
// K34_STAGES input tiles.
template <bool FRESH, int DEFECTS>
__device__ __forceinline__ void trace_tiles(const ChainP& ch, int n_rays, const Streams& in,
                                            const Streams& out, unsigned char* smem) {
  constexpr int IN = in_tile_bytes<FRESH>();
  const Skews sk(in);
  const int lane = threadIdx.x & 31;
  const int n_tiles = (n_rays + TILE - 1) / TILE;
  const int warps = gridDim.x * K34_WARPS;
  int t = blockIdx.x * K34_WARPS + (threadIdx.x >> 5);
#pragma unroll
  for (int st = 0; st < K34_STAGES - 1; ++st)
    load_streams<FRESH>(in, sk, n_rays, t + st * warps, n_tiles, smem + st * IN, lane);
  for (int stage = 0; t < n_tiles; t += warps, stage = stage == K34_STAGES - 1 ? 0 : stage + 1) {
    cp_async_wait<K34_STAGES - 2>();
    __syncwarp();  // tile t is in: every lane's copies are done
    // the stage this warp read in its previous tile takes tile t + (K34_STAGES - 1) warps
    const int refill = stage == 0 ? K34_STAGES - 1 : stage - 1;
    load_streams<FRESH>(in, sk, n_rays, t + (K34_STAGES - 1) * warps, n_tiles, smem + refill * IN, lane);
    const unsigned char* b = smem + stage * IN;
    const int k = t * TILE + lane;
    Ray s;
    const unsigned char* p = b + OFF_P + sk.p + 12 * lane;
    const unsigned char* d = b + OFF_D + sk.d + 12 * lane;
    s.px = ld_f(p);
    s.py = ld_f(p + 4);
    s.pz = ld_f(p + 8);
    s.dx = ld_f(d);
    s.dy = ld_f(d + 4);
    s.dz = ld_f(d + 8);
    if constexpr (FRESH) {
      s.opl = 0.0f;
      s.opl_c = 0.0f;
      s.inc = 0.0f;
      s.alive = k < n_rays;
    } else {
      s.opl = ld_f(b + OFF_OPL + sk.opl + 4 * lane);
      s.opl_c = ld_f(b + OFF_OPL_C + sk.opl_c + 4 * lane);
      s.inc = ld_f(b + OFF_INC + sk.inc + 4 * lane);
      s.alive = k < n_rays && b[OFF_ALIVE + sk.alive + lane] != 0;
    }
    float P[3] = {s.px, s.py, s.pz}, D[3] = {s.dx, s.dy, s.dz};
    if (s.alive) {
      trace_chain<true, ACTIVE_VOTE, DEFECTS>(ch, s);
      to_lab(ch, s, P, D);
    }
    if (k < n_rays) store_ray(out, k, P, D, s);
  }
  cp_async_wait<0>();  // no copy outlives the block's shared memory
}

template <int DEFECTS>
__global__ void __launch_bounds__(K34_THREADS)
streamed_trace_kernel(const __grid_constant__ ChainP ch, int n_rays, Streams in, Streams out) {
  __shared__ __align__(16) unsigned char smem[K34_WARPS][warp_smem_bytes<false>()];
  trace_tiles<false, DEFECTS>(ch, n_rays, in, out, smem[threadIdx.x >> 5]);
}

template <int DEFECTS>
__global__ void __launch_bounds__(K34_THREADS)
streamed_trace_fresh_kernel(const __grid_constant__ ChainP ch, int n_rays, Streams in, Streams out) {
  __shared__ __align__(16) unsigned char smem[K34_WARPS][warp_smem_bytes<true>()];
  trace_tiles<true, DEFECTS>(ch, n_rays, in, out, smem[threadIdx.x >> 5]);
}

// One launch of K3 (FRESH false) or K4: a grid of as many blocks as the
// card holds at once (or as the tiles fill), each warp walking its tiles.
template <bool FRESH, int DEFECTS>
int launch_tiles(const ChainP& ch, int n_rays, const Streams& in, const Streams& out, cudaStream_t st) {
  const auto kernel = FRESH ? &streamed_trace_fresh_kernel<DEFECTS> : &streamed_trace_kernel<DEFECTS>;
  static int per_sm = 0;  // the kernel's blocks per SM (the same on every card of the process)
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, K34_THREADS, 0);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = ((long long)n_rays + TILE - 1) / TILE;
  const long long fill = (tiles + K34_WARPS - 1) / K34_WARPS;
  const long long most = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  kernel<<<(int)(fill < most ? fill : most), K34_THREADS, 0, st>>>(ch, n_rays, in, out);
  return (int)cudaGetLastError();
}

}  // namespace art

using namespace art;

extern "C" {

// chain is a host record (size checked by the caller); every array is a
// device pointer, each stream starting at any element. K3 when fresh == 0
// (reads every input), K4 otherwise (reads p and d only; the other inputs
// may be null).
int art_launch_streamed_trace(const void* chain, int n_rays, int fresh, const float* p_in,
                              const float* d_in, const float* opl_in, const float* opl_c_in,
                              const unsigned char* alive_in, const float* inc_in, float* p,
                              float* d, float* opl, float* opl_c, unsigned char* alive,
                              float* inc, void* stream) {
  const ChainP ch = *static_cast<const ChainP*>(chain);
  auto bytes = [](const void* x) { return const_cast<unsigned char*>(static_cast<const unsigned char*>(x)); };
  const Streams in{bytes(p_in), bytes(d_in), bytes(opl_in), bytes(opl_c_in), bytes(alive_in), bytes(inc_in)};
  const Streams out{bytes(p), bytes(d), bytes(opl), bytes(opl_c), bytes(alive), bytes(inc)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_defects(ch, [&](auto defects) {
    constexpr int D = decltype(defects)::value;
    return fresh ? launch_tiles<true, D>(ch, n_rays, in, out, st)
                 : launch_tiles<false, D>(ch, n_rays, in, out, st);
  });
}

}  // extern "C"
"""

#: the second design: a thread's next ray's float streams in flight into its
#: own slot of shared memory while it traces one
_K34_PREFETCH = r"""// K3 and K4 with the next ray's streams in flight (utils/kernel_variants.py
// k34_prefetch): a thread traces K34_RAYS_PER_THREAD rays, K34_THREADS apart,
// the float streams of its next ray copied into its own slot of shared
// memory (4-byte cp.async copies) while it traces one.
#include <cuda_runtime.h>

#include "trace_common.cuh"

namespace art {

constexpr int K34_THREADS = 256;
// a thread's rays, K34_THREADS apart
constexpr int K34_RAYS_PER_THREAD = 2;
constexpr int K34_RAYS_PER_BLOCK = K34_THREADS * K34_RAYS_PER_THREAD;
// a ray's float inputs: p, d, then K3's opl, opl_c, incidence
constexpr int N_FIELDS = 9;
// a thread's two slots of them in shared memory: field f of slot s at
// [(s * N_FIELDS + f) * K34_THREADS + threadIdx.x]
constexpr int SLOT_FLOATS = N_FIELDS * K34_THREADS;

// the six streams of a bundle (K4's inputs: p, d only)
struct Streams {
  float *p, *d, *opl, *opl_c;
  unsigned char* alive;
  float* inc;
};

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copies of ray k's float inputs into this thread's column of a
// slot, and commit them as one group (an empty group past the last ray, so
// every wait counts the same groups); K3's alive byte is loaded into alive.
template <bool FRESH>
__device__ __forceinline__ void load_ray(const Streams& in, int k, int n_rays, float* slot,
                                         unsigned char& alive) {
  if (k < n_rays) {
    const float* p = in.p + 3 * k;
    const float* d = in.d + 3 * k;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      cp_async4(slot + j * K34_THREADS, p + j);
      cp_async4(slot + (3 + j) * K34_THREADS, d + j);
    }
    if constexpr (!FRESH) {
      cp_async4(slot + 6 * K34_THREADS, in.opl + k);
      cp_async4(slot + 7 * K34_THREADS, in.opl_c + k);
      cp_async4(slot + 8 * K34_THREADS, in.inc + k);
      alive = in.alive[k];
    }
  }
  cp_async_commit();
}

// Ray k's outputs, from the thread's registers.
__device__ __forceinline__ void store_ray(const Streams& out, int k, const float* P, const float* D,
                                          const Ray& s) {
  float* p = out.p + 3 * k;
  float* d = out.d + 3 * k;
  p[0] = P[0];
  p[1] = P[1];
  p[2] = P[2];
  d[0] = D[0];
  d[1] = D[1];
  d[2] = D[2];
  out.opl[k] = s.opl;
  out.opl_c[k] = s.opl_c;
  out.inc[k] = s.inc;
  out.alive[k] = s.alive ? 1 : 0;
}

// The thread's rays: K3 (FRESH false) or K4; smem holds the block's two
// slots.
template <bool FRESH, int DEFECTS>
__device__ __forceinline__ void trace_rays(const ChainP& ch, int n_rays, const Streams& in,
                                           const Streams& out, float* smem) {
  const int first = blockIdx.x * K34_RAYS_PER_BLOCK + threadIdx.x;
  float* column = smem + threadIdx.x;
  unsigned char alive_in = 0, alive_next = 0;
  load_ray<FRESH>(in, first, n_rays, column, alive_in);
#pragma unroll 1
  for (int r = 0; r < K34_RAYS_PER_THREAD; ++r) {
    const int k = first + r * K34_THREADS;
    if (r + 1 < K34_RAYS_PER_THREAD) {
      load_ray<FRESH>(in, k + K34_THREADS, n_rays, column + ((r + 1) & 1) * SLOT_FLOATS, alive_next);
      cp_async_wait<1>();  // ray k's copies are done, the next ray's in flight
    } else {
      cp_async_wait<0>();
    }
    if (k >= n_rays) break;
    const float* f = column + (r & 1) * SLOT_FLOATS;
    Ray s;
    s.px = f[0];
    s.py = f[K34_THREADS];
    s.pz = f[2 * K34_THREADS];
    s.dx = f[3 * K34_THREADS];
    s.dy = f[4 * K34_THREADS];
    s.dz = f[5 * K34_THREADS];
    if constexpr (FRESH) {
      s.opl = 0.0f;
      s.opl_c = 0.0f;
      s.inc = 0.0f;
      s.alive = true;
    } else {
      s.opl = f[6 * K34_THREADS];
      s.opl_c = f[7 * K34_THREADS];
      s.inc = f[8 * K34_THREADS];
      s.alive = alive_in != 0;
    }
    float P[3] = {s.px, s.py, s.pz}, D[3] = {s.dx, s.dy, s.dz};
    if (s.alive) {
      trace_chain<true, ACTIVE_VOTE, DEFECTS>(ch, s);
      to_lab(ch, s, P, D);
    }
    store_ray(out, k, P, D, s);
    alive_in = alive_next;
  }
}

template <int DEFECTS>
__global__ void __launch_bounds__(K34_THREADS)
streamed_trace_kernel(const __grid_constant__ ChainP ch, int n_rays, Streams in, Streams out) {
  __shared__ float smem[2 * SLOT_FLOATS];
  trace_rays<false, DEFECTS>(ch, n_rays, in, out, smem);
}

template <int DEFECTS>
__global__ void __launch_bounds__(K34_THREADS)
streamed_trace_fresh_kernel(const __grid_constant__ ChainP ch, int n_rays, Streams in, Streams out) {
  __shared__ float smem[2 * SLOT_FLOATS];
  trace_rays<true, DEFECTS>(ch, n_rays, in, out, smem);
}

}  // namespace art

using namespace art;

extern "C" {

// chain is a host record (size checked by the caller); every array is a
// device pointer (any float32 view: 4-byte aligned). K3 when fresh == 0
// (reads every input), K4 otherwise (reads p and d only; the other inputs
// may be null).
int art_launch_streamed_trace(const void* chain, int n_rays, int fresh, const float* p_in,
                              const float* d_in, const float* opl_in, const float* opl_c_in,
                              const unsigned char* alive_in, const float* inc_in, float* p,
                              float* d, float* opl, float* opl_c, unsigned char* alive,
                              float* inc, void* stream) {
  const ChainP ch = *static_cast<const ChainP*>(chain);
  const Streams in{const_cast<float*>(p_in), const_cast<float*>(d_in), const_cast<float*>(opl_in),
                   const_cast<float*>(opl_c_in), const_cast<unsigned char*>(alive_in),
                   const_cast<float*>(inc_in)};
  const Streams out{p, d, opl, opl_c, alive, inc};
  const int blocks = (n_rays + K34_RAYS_PER_BLOCK - 1) / K34_RAYS_PER_BLOCK;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_defects(ch, [&](auto defects) {
    constexpr int D = decltype(defects)::value;
    if (fresh)
      streamed_trace_fresh_kernel<D><<<blocks, K34_THREADS, 0, st>>>(ch, n_rays, in, out);
    else
      streamed_trace_kernel<D><<<blocks, K34_THREADS, 0, st>>>(ch, n_rays, in, out);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
"""


#: the third design: the block's tiles of the input streams brought into
#: shared memory by the Tensor Memory Accelerator, one bulk copy a stream
#: on an mbarrier, every thread waiting for it
_K34_BULK = r"""// a stream's tile of K34_THREADS rays in shared memory: its bytes from the
// 16-byte boundary at or below its first one, rounded up to 16 bytes
__host__ __device__ constexpr int tile_buffer(int bytes_per_ray) { return K34_THREADS * bytes_per_ray + 32; }
constexpr int OFF_P = 0;
constexpr int OFF_D = OFF_P + tile_buffer(12);
constexpr int OFF_OPL = OFF_D + tile_buffer(12);
constexpr int OFF_OPL_C = OFF_OPL + tile_buffer(4);
constexpr int OFF_INC = OFF_OPL_C + tile_buffer(4);
constexpr int OFF_ALIVE = OFF_INC + tile_buffer(4);
constexpr int TILE_BYTES = OFF_ALIVE + tile_buffer(1);

__device__ __forceinline__ int skew(const void* g) { return (int)(reinterpret_cast<uintptr_t>(g) & 15); }
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One bulk copy of the bytes [g, g + n) of a stream (rounded out to 16-byte
// boundaries: the granules hold a byte of the stream each) into buf,
// completing on the barrier; returns the bytes it moves.
__device__ __forceinline__ unsigned bulk_tile(unsigned char* buf, const unsigned char* g, int n,
                                              unsigned bar) {
  const unsigned char* g0 = g - skew(g);
  const unsigned bytes = (unsigned)((skew(g) + n + 15) & ~15);
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(smem_addr(buf)), "l"(g0), "r"(bytes), "r"(bar) : "memory");
  return bytes;
}

// Ray k of the thread: K3 (FRESH false) or K4. Thread 0 copies the block's
// tile of every input stream into shared memory with the Tensor Memory
// Accelerator (one bulk copy a stream, completing on an mbarrier), every
// thread waits for the barrier and reads its ray there.
template <bool FRESH, int DEFECTS>
__device__ __forceinline__ void trace_ray(const ChainP& ch, int n_rays, const Streams& in,
                                          const Streams& out, unsigned char* tile, unsigned long long* bar) {
  const int first = blockIdx.x * K34_THREADS;
  const int n = min(K34_THREADS, n_rays - first);
  const unsigned b = smem_addr(bar);
  const unsigned char* ip = reinterpret_cast<const unsigned char*>(in.p);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned bytes = ((skew(in.p) + 12 * n + 15) & ~15) + ((skew(in.d) + 12 * n + 15) & ~15);
    if constexpr (!FRESH)
      bytes += ((skew(in.opl) + 4 * n + 15) & ~15) + ((skew(in.opl_c) + 4 * n + 15) & ~15) +
               ((skew(in.inc) + 4 * n + 15) & ~15) + ((skew(in.alive) + n + 15) & ~15);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes) : "memory");
    bulk_tile(tile + OFF_P, ip + 12 * (size_t)first, 12 * n, b);
    bulk_tile(tile + OFF_D, reinterpret_cast<const unsigned char*>(in.d) + 12 * (size_t)first, 12 * n, b);
    if constexpr (!FRESH) {
      bulk_tile(tile + OFF_OPL, reinterpret_cast<const unsigned char*>(in.opl) + 4 * (size_t)first, 4 * n, b);
      bulk_tile(tile + OFF_OPL_C, reinterpret_cast<const unsigned char*>(in.opl_c) + 4 * (size_t)first, 4 * n, b);
      bulk_tile(tile + OFF_INC, reinterpret_cast<const unsigned char*>(in.inc) + 4 * (size_t)first, 4 * n, b);
      bulk_tile(tile + OFF_ALIVE, in.alive + first, n, b);
    }
  }
  const int j = threadIdx.x;
  const int k = first + j;
  if (k >= n_rays) return;
  unsigned done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\nselp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(b) : "memory");
  Ray s;
  const float* p = reinterpret_cast<const float*>(tile + OFF_P + skew(in.p)) + 3 * j;
  const float* d = reinterpret_cast<const float*>(tile + OFF_D + skew(in.d)) + 3 * j;
  s.px = p[0];
  s.py = p[1];
  s.pz = p[2];
  s.dx = d[0];
  s.dy = d[1];
  s.dz = d[2];
  if constexpr (FRESH) {
    s.opl = 0.0f;
    s.opl_c = 0.0f;
    s.inc = 0.0f;
    s.alive = true;
  } else {
    s.opl = reinterpret_cast<const float*>(tile + OFF_OPL + skew(in.opl))[j];
    s.opl_c = reinterpret_cast<const float*>(tile + OFF_OPL_C + skew(in.opl_c))[j];
    s.inc = reinterpret_cast<const float*>(tile + OFF_INC + skew(in.inc))[j];
    s.alive = tile[OFF_ALIVE + skew(in.alive) + j] != 0;
    if (!s.alive) {  // entered dead: stored as read, no arithmetic
      out.p[3 * k] = s.px;
      out.p[3 * k + 1] = s.py;
      out.p[3 * k + 2] = s.pz;
      out.d[3 * k] = s.dx;
      out.d[3 * k + 1] = s.dy;
      out.d[3 * k + 2] = s.dz;
      out.opl[k] = s.opl;
      out.opl_c[k] = s.opl_c;
      out.inc[k] = s.inc;
      out.alive[k] = 0;
      return;
    }
  }
  trace_chain<true, ACTIVE_VOTE, DEFECTS>(ch, s);
  store_lab(ch, s, k, out.p, out.d, out.opl, out.opl_c, out.alive, out.inc);
}

template <int DEFECTS>
__global__ void __launch_bounds__(K34_THREADS)
streamed_trace_kernel(const __grid_constant__ ChainP ch, int n_rays, Streams in, Streams out) {
  __shared__ __align__(16) unsigned char tile[TILE_BYTES];
  __shared__ unsigned long long bar;
  trace_ray<false, DEFECTS>(ch, n_rays, in, out, tile, &bar);
}

template <int DEFECTS>
__global__ void __launch_bounds__(K34_THREADS)
streamed_trace_fresh_kernel(const __grid_constant__ ChainP ch, int n_rays, Streams in, Streams out) {
  __shared__ __align__(16) unsigned char tile[OFF_OPL];
  __shared__ unsigned long long bar;
  trace_ray<true, DEFECTS>(ch, n_rays, in, out, tile, &bar);
}

"""


def _k34_variants() -> dict:
    """K3's and K4's design variants (``streamed_trace.cu``)."""
    st = "streamed_trace.cu"
    return {
        "k34_no_warp_exit": [_lit(st, "    if (!s.alive) {  // entered dead: stored as read, no arithmetic",
                                  "    if (false) {"),
                             _lit(st, "  trace_chain<true, ACTIVE_VOTE, DEFECTS>(ch, s);",
                                  "  trace_chain<true, NO_EXIT, DEFECTS>(ch, s);")],
        "k34_prefetch": [(st, r"\A.*\Z", _K34_PREFETCH, re.DOTALL)],
        "k34_tiles": [(st, r"\A.*\Z", _K34_TILES, re.DOTALL)],
        "k34_bulk": [_lit(st, '#include "trace_common.cuh"', '#include <cstdint>\n\n#include "trace_common.cuh"'),
                     (st, r"// Ray k of the thread: K3 \(FRESH false\) or K4\.\n.*?(?=}  // namespace art)",
                      _K34_BULK, re.DOTALL)],
        "k34_t128": [_set("K34_THREADS", 128, st)],
    }


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
