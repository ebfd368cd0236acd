// Alignment-gradient kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes, ops/_cuda.py).
//
// K6 stats_params_kernel<G> (G = TANGENT_BATCH) replaces the JAX package's
//   ops/pallas_grad.py::_kernel_stats_jvp (pallas_call at :335).
//   The 7 weighted detector sums (w, wx, wy, wxx, wyy, wd, wdd) at one
//   distance AND their directional derivatives along every tangent row of
//   the runtime pose vector, in one launch per gradient step: the P tangent
//   rows are split into ceil(P / G) groups of G (blockIdx.y = group), and
//   each block traces its rays once on Dual<G> (dual.cuh), so the primal is
//   shared by the G tangents of its group and each tangent costs only its
//   linearized arithmetic, as with the JAX kernel's jax.linearize. The
//   toroid's Newton step and the quadrics' root polishing are differentiated
//   through their iterations, as JAX differentiates them.
//
// K6 takes K5's layout: the pose-independent chain record (kinds, surfaces,
// supports, support centres; ops/fused_scan.pack_scan_chain) and the source
// record as __grid_constant__ parameters, and the pose vector svec (12 per
// element: M row-major, b; then the detector centre, normal, e1, e2 in the
// last element's frame; ops/fused_grad.chain_scalars_np) with its P tangent
// rows as device arrays. Each block writes svec and its group's G tangents
// into one shared table of scalars and walks the chain from it
// (trace_runtime_pose, trace_common.cuh, the loop K5 shares): masks are their
// own (unfolded) steps and dead rays are not frozen at mirrors, as in the
// JAX kernel; the source does not depend on the poses, so it enters with
// zero tangents. A deformed mirror's branch (trace_common.cuh, the Dual<G>
// overloads of zernike_height, zernike_slopes, grid_height and
// grid_slopes) sums its Zernike recurrence and grid lookups once per ray on
// the float primal, K7's arithmetic, and composes
// their tangents at the hit by the chain rule (the height's gradient, the
// slopes' Hessian rows and cell derivatives; a clamped grid index carries
// none, as JAX's autograd through the gather); the base normals and the
// shifted hit stay on Dual<G>. On the deformed flagships that took a step
// from 9.87 / 6.04 ms (the recurrence and lookups on Dual<6>, their rows in
// local memory) to 3.69 / 3.97 ms (PERF.md §6 PR 13; NVIDIA H100 80GB HBM3,
// 700.00 W). Epilogue: stats_rows at distance 0 for alive
// rays (dead rays are skipped, so no tangent of a dead ray reaches a sum; a
// warp of dead rays leaves the chain early). Each thread sums 7 (1 + G) floats over its
// rays; the block reduces them in float64 to one row (reduce_columns), no
// atomics; the host sums the rows in float64. All chunks of 2^23 rays go in
// one launch, on a grid sized to the rays (block_rays).
//
// Bound: pure arithmetic (K6 writes 7 (1 + G) doubles per 2048 rays and
// group); its operation count is the primal's once per group plus, per
// tangent, each dual operator's linear part. On this card that arithmetic is
// one long dependent chain per ray (reciprocal square roots, IEEE divides and
// square roots, the toroid's Newton step), so what sets K6's speed is how
// many warps each SM holds to hide it, and that is set by registers: 65,536
// per SM, at most 64 warps. Left alone, G = 6 takes 215 registers a thread
// (ptxas for sm_90a; the card: NVIDIA H100 80GB HBM3, 700.00 W): one
// 256-thread block, 8 warps per SM. The design:
// - one launch per gradient step, every tangent group in one grid;
// - G = 6 (the JAX kernel's TANGENT_BATCH): the primal is traced 3 times
//   for the flagship's 18 rows; fewer tangents per block buy occupancy but
//   retrace the primal more often, and measured slower;
// - __launch_bounds__(256, K6_MIN_BLOCKS = 2) caps the registers at 128 for
//   2 blocks (16 warps) per SM;
// - the thread's 49 sums move to a column of dynamic shared memory
//   (SharedColumn: 50,176 B a block), which frees the registers the capped
//   dual state needs: 68 B spilled, against 360 B with the sums in
//   registers;
// - the factors only the tangents use (a divisor's reciprocal, sqrt's
//   0.5 / r, rsqrt's -r^3 / 2) come from the reciprocal unit or a product,
//   not from a second IEEE sequence (dual.cuh); the value path is K7's.
// PERF.md records each lever's time on an NVIDIA H100 80GB HBM3 at 700.00 W
// (utils/kernel_ab.py over the trees of utils/kernel_variants.py: G in 2, 3,
// 6, 9, register budgets of 1-3 blocks per SM, sums in registers or shared
// memory, IEEE tangent factors) and the build's registers.
#include <cuda_runtime.h>

#include "trace_common.cuh"

namespace art {

constexpr int TANGENT_BATCH = 6;         // G: tangent rows per block and thread
constexpr int K6_MIN_BLOCKS = 2;         // 256-thread blocks per SM: <= 128 registers
constexpr int MAX_TANGENTS = 6 * MAX_ELEMENTS;  // 3 angles and 3 shifts per element

// K6's sums: each thread's N in a column of dynamic shared memory, added to
// once per ray: volatile, so the compiler cannot hold the column in registers
// across the ray loop, which frees them for the dual state
// (utils/kernel_variants.py's _reg trees hold the sums in registers).
extern __shared__ float sums_smem[];  // N x MOMENT_THREADS, one column per thread

template <int N>
struct SharedColumn {
  volatile float* col;
  __device__ __forceinline__ volatile float& operator[](int m) const {
    return col[m * MOMENT_THREADS];
  }
  // the columns are the block reduction's input as they stand
  __device__ __forceinline__ void reduce(double* __restrict__ row) const {
    __syncthreads();
    reduce_columns(sums_smem, N, row);
  }
};

template <int G, int DEFECTS>
__global__ void __launch_bounds__(MOMENT_THREADS, K6_MIN_BLOCKS)
stats_params_kernel(const __grid_constant__ ChainP ch, const __grid_constant__ SourceP src,
                    float opl_ref, int n_rays, int chunk, int blocks_per_chunk, int n_scal,
                    const float* __restrict__ svec, int n_tangents,
                    const float* __restrict__ stangents, const float2* __restrict__ chunk_params,
                    double* __restrict__ rows) {
  using S = Dual<G>;
  constexpr int N_OUT = N_STATS * (1 + G);
  __shared__ S pose[MAX_SCALARS];
  for (int i = threadIdx.x; i < n_scal; i += MOMENT_THREADS) {
    S p(svec[i]);
    const int g0 = blockIdx.y * G;  // this block's first tangent row
#pragma unroll
    for (int g = 0; g < G; ++g)
      p.t[g] = g0 + g < n_tangents ? stangents[(size_t)(g0 + g) * n_scal + i] : 0.0f;
    pose[i] = p;
  }
  __syncthreads();
  const S* det = pose + 12 * ch.n_elements;  // centre, normal, e1, e2
  const BlockRays br = block_rays<MOMENT_RAYS_PER_BLOCK>(blocks_per_chunk);
  const float2 cp = chunk_params[br.chunk];
  SharedColumn<N_OUT> acc{sums_smem + threadIdx.x};
#pragma unroll
  for (int m = 0; m < N_OUT; ++m) acc[m] = 0.0f;
  trace_runtime_pose<DEFECTS>(ch, src, pose, min(chunk, n_rays - br.chunk * chunk), br.first,
                              cp.x, cp.y, [&](const RayT<S>& s, float rr) {
    const float w = src.weighted ? expf(src.ln_edge * rr) : 1.0f;
    const StatsGeom<S> geo = stats_geometry(det, det + 3, det + 6, det + 9, opl_ref, s);
    // distance 0, delay offset 0: tj = t0, dj = dsmall + t0
    S terms[N_STATS];
    stats_terms(geo, geo.t0, add_rn(geo.dsmall, geo.t0), w, terms);
#pragma unroll
    for (int f = 0; f < N_STATS; ++f) {
      acc[f] += val(terms[f]);
#pragma unroll
      for (int g = 0; g < G; ++g) acc[N_STATS * (1 + g) + f] += terms[f].t[g];
    }
  });
  acc.reduce(rows + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * N_OUT);
}

template <int G>
int launch_stats_params(const void* chain, const void* source, float opl_ref, int n_rays,
                        int chunk, int blocks_per_chunk, int n_blocks, int n_scal,
                        const float* svec, int n_tangents, const float* stangents,
                        const float* chunk_params, double* rows, void* stream) {
  const ChainP ch = *static_cast<const ChainP*>(chain);
  const SourceP src = *static_cast<const SourceP*>(source);
  return with_defects(ch, [&](auto defects) {
    constexpr int D = decltype(defects)::value;
    const int n_groups = (n_tangents + G - 1) / G;
    const int smem = N_STATS * (1 + G) * MOMENT_THREADS * (int)sizeof(float);  // the sums' columns
    const cudaError_t status = cudaFuncSetAttribute(
        stats_params_kernel<G, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (status != cudaSuccess) return (int)status;
    const dim3 grid(n_blocks, n_groups);
    stats_params_kernel<G, D><<<grid, MOMENT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        ch, src, opl_ref, n_rays, chunk, blocks_per_chunk, n_scal, svec, n_tangents, stangents,
        reinterpret_cast<const float2*>(chunk_params), rows);
    return (int)cudaGetLastError();
  });
}

// K7 stats_primal_kernel replaces the JAX package's
//   ops/pallas_grad.py::_kernel_stats_primal (pallas_call at :335), the
//   loss-only pass of ops/fused_grad.fused_focus_loss: K6's 7 sums without
//   tangents, over every ray of a factory source, one launch for all chunks.
//   Its pose is one float32 vector, the same for every ray and known on the
//   host before the launch, so the host writes it into the launch record
//   (ops/fused_grad.pack_primal_records): each element's 12 scalars into the
//   chain record's maps (el[i].M, el[i].b), the detector plane into a
//   DetectorP. No shared pose table, no barrier, no shared loads per
//   element; the masks stay their own (unfolded) steps, as in the JAX kernel
//   and the plain version.
//   Bound: pure arithmetic; counted where the rays die (chip_smoke.py: the
//   source and the mask step for every ray, each toroid step for the rays
//   that reach it, the weight and the stats for the rays alive at the end;
//   a warp whose rays all died leaves the chain), the flagship's 1e7 rays
//   take 2.87e9 float32 operations, 0.043 ms at 67 TFLOP/s.
//   What binds it: issue slots (PERF.md §6, on an NVIDIA H100 80GB HBM3 at
//   700.00 W). Its SASS on the flagship's path, times the warps that run
//   each stage, takes 1.84e8 warp instructions: 0.176 ms at 4 per SM and
//   clock (1980 MHz), against 0.201 ms measured, while the FP32 pipe alone
//   needs 0.084 ms and MUFU 0.031. Half of the slots are not FP32: the
//   runtime walk's constant loads (each record read an LDC at a computed
//   address), index arithmetic and kind tests.
//   The design cuts those: K7 walks the chain with a walk of its own
//   (k7_walk), unrolled over MAX_ELEMENTS, so every record read is a
//   constant-bank operand at a fixed offset and no index is computed; the
//   mask and toroid steps are inline and the plane and quadric hits out of
//   line (k7_other_hit, __noinline__), so the eight unrolled copies hold the
//   flagship's steps only and stay in the instruction cache; the mask and
//   mirror steps are trace_chain_maps's own (mask_step, mirror_step).
//   nvcc contracts the unrolled code's products into FMAs in places of its
//   own, so the sums differ from the runtime walk's by float32 rounding
//   (~4e-7 of their scale). Each thread sums its 7 in registers over
//   K7_RAYS_PER_THREAD rays; one float64 row per block (reduce_to_row), no
//   atomics; the host sums the rows in float64. PERF.md §6 holds its times
//   against the runtime-pose K7 it replaces (utils/kernel_ab.py) and its
//   issue-slot bound: still issue-bound, now on the toroid's and the source
//   law's own instructions. Two rays per thread in flight, walked together
//   element by element, gained about 2 % on the flagship only and are not
//   kept.
constexpr int K7_RAYS_PER_THREAD = 16;
constexpr int K7_RAYS_PER_BLOCK = MOMENT_THREADS * K7_RAYS_PER_THREAD;

// the hits of the surfaces the flagship does not have, out of line
__device__ __noinline__ HitT<float> k7_other_hit(const ElementP& el, float qx, float qy, float qz,
                                                 float ux, float uy, float uz) {
  return el.kind == ELEM_PLANE ? plane_hit(el, qx, qy, qz, ux, uy, uz, T_EPS)
                               : quadric_hit(el, qx, qy, qz, ux, uy, uz, T_EPS);
}

// trace_chain_maps on K7's record (float, no incidence, masks unfolded: the
// record has no folded masks), unrolled; the warp leaves once all its rays
// are dead (every lane votes: the ray loop is warp-uniform)
template <int DEFECTS>
__device__ __forceinline__ void k7_walk(const ChainP& ch, Ray& s) {
#pragma unroll
  for (int i = 0; i < MAX_ELEMENTS; ++i) {
    if (i >= ch.n_elements) break;
    if (!__any_sync(0xffffffffu, s.alive)) return;
    const ElementP& el = ch.el[i];
    float qx, qy, qz, ux, uy, uz;
    affine(el.M, el.b, s, qx, qy, qz, ux, uy, uz);
    if (el.kind == ELEM_MASK) {
      mask_step<false>(el, T_EPS, false, qx, qy, qz, ux, uy, uz, s);
      continue;
    }
    HitT<float> h;
    if (el.kind == ELEM_TOROID) {
      h = toroid_hit(el, qx, qy, qz, ux, uy, uz, T_EPS);
    } else {
      h = k7_other_hit(el, qx, qy, qz, ux, uy, uz);
    }
    mirror_step<false, DEFECTS>(ch, i, false, qx, qy, qz, ux, uy, uz, h, s);
  }
}

template <int DEFECTS>
__global__ void __launch_bounds__(MOMENT_THREADS)
stats_primal_kernel(const __grid_constant__ ChainP ch, const __grid_constant__ SourceP src,
                    const __grid_constant__ DetectorP det, int n_rays, int chunk,
                    int blocks_per_chunk, const float2* __restrict__ chunk_params,
                    double* __restrict__ rows) {
  const BlockRays br = block_rays<K7_RAYS_PER_BLOCK>(blocks_per_chunk);
  const float2 cp = chunk_params[br.chunk];
  const int n_local = min(chunk, n_rays - br.chunk * chunk);
  const int lane = threadIdx.x & 31;
  float acc[N_STATS];
#pragma unroll
  for (int m = 0; m < N_STATS; ++m) acc[m] = 0.0f;
  // the thread's rays k = first + r * MOMENT_THREADS; a warp's lanes hold
  // consecutive rays and leave together (as for_thread_rays)
  for (int r = 0; r < K7_RAYS_PER_THREAD; ++r) {
    const int k = br.first + r * MOMENT_THREADS;
    if (k - lane >= n_local) break;
    Ray s;
    float rr;
    synth_source(src, k, cp.x, cp.y, s, rr);
    s.alive = k < n_local;
    k7_walk<DEFECTS>(ch, s);
    if (!s.alive) continue;
    const float w = src.weighted ? expf(src.ln_edge * rr) : 1.0f;
    const StatsGeom<float> geo = stats_geometry(det.c, det.n, det.e1, det.e2, det.opl_ref, s);
    // distance 0, delay offset 0: tj = t0, dj = dsmall + t0
    float terms[N_STATS];
    stats_terms(geo, geo.t0, add_rn(geo.dsmall, geo.t0), w, terms);
#pragma unroll
    for (int f = 0; f < N_STATS; ++f) acc[f] += terms[f];
  }
  reduce_to_row<N_STATS>(acc, rows + (size_t)blockIdx.x * N_STATS);
}

}  // namespace art

using namespace art;

extern "C" {

int art_tangent_batch() { return TANGENT_BATCH; }

// K6: chain and source are host records (sizes checked by the caller);
// svec (n_scal), stangents (n_tangents x n_scal), chunk_params (n_chunks x
// 2) and rows are device pointers; 0 < n_tangents <= 48. Writes rows
// (ceil(n_tangents / G) x n_blocks x 7 (1 + G)), group-major. The grid's x
// is n_blocks blocks, blocks_per_chunk for each full chunk
// (ops/fused_trace.ray_grid at art_moment_rays_per_block).
int art_launch_stats_params(const void* chain, const void* source, float opl_ref, int n_rays,
                            int chunk, int blocks_per_chunk, int n_blocks, int n_scal,
                            const float* svec, int n_tangents, const float* stangents,
                            const float* chunk_params, double* rows, void* stream) {
  if (n_scal < 24 || n_scal > MAX_SCALARS || n_tangents <= 0 || n_tangents > MAX_TANGENTS ||
      stangents == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_stats_params<TANGENT_BATCH>(chain, source, opl_ref, n_rays, chunk,
                                            blocks_per_chunk, n_blocks, n_scal, svec, n_tangents,
                                            stangents, chunk_params, rows, stream);
}

int art_stats_primal_rays_per_block() { return K7_RAYS_PER_BLOCK; }

// K7: chain (its maps the pose's), source and detector are host records
// (sizes checked by the caller), copied into the launch's parameter space;
// chunk_params (n_chunks x 2) and rows (n_blocks x 7) are device pointers.
// The grid as K6's, at art_stats_primal_rays_per_block.
int art_launch_stats_primal(const void* chain, const void* source, const void* detector,
                            int n_rays, int chunk, int blocks_per_chunk, int n_blocks,
                            const float* chunk_params, double* rows, void* stream) {
  const ChainP ch = *static_cast<const ChainP*>(chain);
  const SourceP src = *static_cast<const SourceP*>(source);
  const DetectorP det = *static_cast<const DetectorP*>(detector);
  return with_defects(ch, [&](auto defects) {
    stats_primal_kernel<decltype(defects)::value>
        <<<n_blocks, MOMENT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            ch, src, det, n_rays, chunk, blocks_per_chunk,
            reinterpret_cast<const float2*>(chunk_params), rows);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
