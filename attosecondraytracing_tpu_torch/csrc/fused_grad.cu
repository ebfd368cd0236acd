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
// K7 stats_params_kernel<0> replaces ops/pallas_grad.py::_kernel_stats_primal:
//   the same sums without tangents (S = float).
//
// Both take K5's layout: the pose-independent chain record (kinds, surfaces,
// supports, support centres; ops/fused_scan.pack_scan_chain) and the source
// record as __grid_constant__ parameters, and the pose vector svec (12 per
// element: M row-major, b; then the detector centre, normal, e1, e2 in the
// last element's frame; ops/fused_grad.chain_scalars_np) with its P tangent
// rows as device arrays. Each block writes svec and its group's G tangents
// into one shared table of scalars and walks the chain from it
// (trace_runtime_pose, trace_common.cuh, the loop K5 shares): masks are their
// own (unfolded) steps and dead rays are not frozen at mirrors, as in the
// JAX kernel; the source does not depend on the poses, so it enters with
// zero tangents. A deformed mirror's branch runs on Dual<G> too: a grid
// map's lookup takes its cell from the primal and its tangents through the
// bilinear weights (a clamped index carries none), as JAX's autograd takes
// them through the gather. Epilogue: stats_rows at distance 0 for alive
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
//   (thread_sums: 50,176 B a block), which frees the registers the capped
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

// A thread's N sums. K6 keeps them in a column of dynamic shared memory,
// added to once per ray: volatile, so the compiler cannot hold the column in
// registers across the ray loop, which frees them for the dual state. K7
// keeps its 7 in registers.
extern __shared__ float sums_smem[];  // K6: N x MOMENT_THREADS, one column per thread

template <int N>
struct RegisterSums {
  float v[N];
  __device__ __forceinline__ float& operator[](int m) { return v[m]; }
  // the block's sums of every thread's N, one float64 row
  __device__ __forceinline__ void reduce(double* __restrict__ row) const {
    reduce_to_row<N>(v, row);
  }
};
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
template <int N, bool SHARED>
__device__ __forceinline__ auto thread_sums() {
  if constexpr (SHARED) {
    return SharedColumn<N>{sums_smem + threadIdx.x};
  } else {
    return RegisterSums<N>{};
  }
}

template <int G>
struct ScalarOf {
  using type = Dual<G>;
};
template <>
struct ScalarOf<0> {
  using type = float;
};

template <int G, int DEFECTS>
__global__ void __launch_bounds__(MOMENT_THREADS, G > 0 ? K6_MIN_BLOCKS : 1)
stats_params_kernel(const __grid_constant__ ChainP ch, const __grid_constant__ SourceP src,
                    float opl_ref, int n_rays, int chunk, int blocks_per_chunk, int n_scal,
                    const float* __restrict__ svec, int n_tangents,
                    const float* __restrict__ stangents, const float2* __restrict__ chunk_params,
                    double* __restrict__ rows) {
  using S = typename ScalarOf<G>::type;
  constexpr int N_OUT = N_STATS * (1 + G);
  __shared__ S pose[MAX_SCALARS];
  for (int i = threadIdx.x; i < n_scal; i += MOMENT_THREADS) {
    S p(svec[i]);
    if constexpr (G > 0) {
      const int g0 = blockIdx.y * G;  // this block's first tangent row
#pragma unroll
      for (int g = 0; g < G; ++g)
        p.t[g] = g0 + g < n_tangents ? stangents[(size_t)(g0 + g) * n_scal + i] : 0.0f;
    }
    pose[i] = p;
  }
  __syncthreads();
  const S* det = pose + 12 * ch.n_elements;  // centre, normal, e1, e2
  const BlockRays br = block_rays<MOMENT_RAYS_PER_BLOCK>(blocks_per_chunk);
  const float2 cp = chunk_params[br.chunk];
  auto acc = thread_sums<N_OUT, (G > 0)>();
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
      if constexpr (G > 0) {
#pragma unroll
        for (int g = 0; g < G; ++g) acc[N_STATS * (1 + g) + f] += terms[f].t[g];
      }
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
    int n_groups = 1, smem = 0;
    if constexpr (G > 0) {
      n_groups = (n_tangents + G - 1) / G;
      smem = N_STATS * (1 + G) * MOMENT_THREADS * (int)sizeof(float);  // the sums' columns
      const cudaError_t status = cudaFuncSetAttribute(
          stats_params_kernel<G, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (status != cudaSuccess) return (int)status;
    }
    const dim3 grid(n_blocks, n_groups);
    stats_params_kernel<G, D><<<grid, MOMENT_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        ch, src, opl_ref, n_rays, chunk, blocks_per_chunk, n_scal, svec, n_tangents, stangents,
        reinterpret_cast<const float2*>(chunk_params), rows);
    return (int)cudaGetLastError();
  });
}

}  // namespace art

using namespace art;

extern "C" {

int art_tangent_batch() { return TANGENT_BATCH; }

// chain and source are host records (sizes checked by the caller); svec
// (n_scal), stangents (n_tangents x n_scal, null for K7), chunk_params
// (n_chunks x 2) and rows are device pointers. K6 (0 < n_tangents <= 48)
// writes rows (ceil(n_tangents / G) x n_blocks x 7 (1 + G)), group-major;
// K7 (n_tangents = 0) writes rows (n_blocks x 7). The grid's x is n_blocks
// blocks, blocks_per_chunk for each full chunk (ops/fused_trace.ray_grid).
int art_launch_stats_params(const void* chain, const void* source, float opl_ref, int n_rays,
                            int chunk, int blocks_per_chunk, int n_blocks, int n_scal,
                            const float* svec, int n_tangents, const float* stangents,
                            const float* chunk_params, double* rows, void* stream) {
  if (n_scal < 24 || n_scal > MAX_SCALARS) return (int)cudaErrorInvalidValue;
  if (n_tangents > 0 && n_tangents <= MAX_TANGENTS && stangents != nullptr)
    return launch_stats_params<TANGENT_BATCH>(chain, source, opl_ref, n_rays, chunk,
                                              blocks_per_chunk, n_blocks, n_scal, svec,
                                              n_tangents, stangents, chunk_params, rows, stream);
  if (n_tangents == 0)
    return launch_stats_params<0>(chain, source, opl_ref, n_rays, chunk, blocks_per_chunk,
                                  n_blocks, n_scal, svec, 0, nullptr, chunk_params, rows,
                                  stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
