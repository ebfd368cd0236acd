// Alignment-gradient kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes, ops/_cuda.py).
//
// K6 stats_params_kernel<6> replaces the JAX package's
//   ops/pallas_grad.py::_kernel_stats_jvp (pallas_call at :335).
//   The 7 weighted detector sums (w, wx, wy, wxx, wyy, wd, wdd) at one
//   distance AND their directional derivatives along G = 6 tangent rows of the
//   runtime pose vector, from one trace: the ray state is Dual<6> (dual.cuh),
//   so the primal is shared and each tangent costs only its linearized
//   arithmetic, as with the JAX kernel's jax.linearize. The toroid's Newton
//   step and the quadrics' root polishing are differentiated through their
//   iterations, as JAX differentiates them.
// K7 stats_params_kernel<0> replaces ops/pallas_grad.py::_kernel_stats_primal:
//   the same sums without tangents (S = float).
//
// Both take K5's layout: the pose-independent chain record (kinds, surfaces,
// supports, support centres; ops/fused_scan.pack_scan_chain) and the source
// record as __grid_constant__ parameters, and the pose vector svec (12 per
// element: M row-major, b; then the detector centre, normal, e1, e2 in the
// last element's frame; ops/fused_grad.chain_scalars_np) with its G tangent
// rows as device arrays. Each block writes svec and the tangents into one
// shared table of S scalars and walks the chain from it: masks are their own
// (unfolded) steps and dead rays are not frozen at mirrors, as in the JAX
// kernel; the source does not depend on the poses, so it enters with zero
// tangents. Epilogue: stats_rows at distance 0 for alive rays (dead rays are
// skipped, so no tangent of a dead ray reaches a sum). Each thread sums 7 (1
// + G) floats over its rays; the block reduces them in float64 to one row, no
// atomics; the host sums the rows in float64. All chunks of 2^23 rays go in
// one launch (blockIdx.y = chunk).
// Bound: pure arithmetic, like K2 (it writes 392 B per 2048 rays); K6's count
// is the primal's plus, per tangent, each dual operator's linear part.
// Register pressure is high for K6 (8 state scalars x 7 floats and 49
// accumulators per thread); the build log reports its registers and spills.
#include <cuda_runtime.h>

#include "trace_common.cuh"

namespace art {

constexpr int TANGENT_BATCH = 6;
constexpr int MAX_SCALARS = 12 * MAX_ELEMENTS + 12;

template <int G>
struct ScalarOf {
  using type = Dual<G>;
};
template <>
struct ScalarOf<0> {
  using type = float;
};

template <int G>
__global__ void __launch_bounds__(MOMENT_THREADS)
stats_params_kernel(const __grid_constant__ ChainP ch, const __grid_constant__ SourceP src,
                    float opl_ref, int n_rays, int chunk, int n_scal,
                    const float* __restrict__ svec, const float* __restrict__ stangents,
                    const float2* __restrict__ chunk_params, double* __restrict__ rows) {
  using S = typename ScalarOf<G>::type;
  constexpr int N_OUT = N_STATS * (1 + G);
  __shared__ S pose[MAX_SCALARS];
  for (int i = threadIdx.x; i < n_scal; i += MOMENT_THREADS) {
    S p(svec[i]);
    if constexpr (G > 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) p.t[g] = stangents[g * n_scal + i];
    }
    pose[i] = p;
  }
  __syncthreads();
  const S* det = pose + 12 * ch.n_elements;  // centre, normal, e1, e2
  const PoseMaps<S> maps{pose};

  const int c = blockIdx.y;
  const int n_local = min(chunk, n_rays - c * chunk);
  const float2 cp = chunk_params[c];
  float acc[N_OUT];
#pragma unroll
  for (int m = 0; m < N_OUT; ++m) acc[m] = 0.0f;
  const int base = blockIdx.x * MOMENT_RAYS_PER_BLOCK + threadIdx.x;
  for (int r = 0; r < MOMENT_RAYS_PER_THREAD; ++r) {
    const int k = base + r * MOMENT_THREADS;
    if (k >= n_local) break;
    Ray s0;
    float rr;
    synth_source(src, k, cp.x, cp.y, s0, rr);
    RayT<S> s = lift<S>(s0);
    trace_chain_maps<false>(ch, maps, s);
    if (!s.alive) continue;
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
  }
  reduce_to_row<N_OUT>(acc, rows + ((size_t)c * gridDim.x + blockIdx.x) * N_OUT);
}

template <int G>
int launch_stats_params(const void* chain, const void* source, float opl_ref, int n_rays,
                        int chunk, int n_chunks, int n_scal, const float* svec,
                        const float* stangents, const float* chunk_params, double* rows,
                        int blocks_per_chunk, void* stream) {
  const ChainP ch = *static_cast<const ChainP*>(chain);
  const SourceP src = *static_cast<const SourceP*>(source);
  const dim3 grid(blocks_per_chunk, n_chunks);
  stats_params_kernel<G><<<grid, MOMENT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ch, src, opl_ref, n_rays, chunk, n_scal, svec, stangents,
      reinterpret_cast<const float2*>(chunk_params), rows);
  return (int)cudaGetLastError();
}

}  // namespace art

using namespace art;

extern "C" {

int art_tangent_batch() { return TANGENT_BATCH; }

// chain and source are host records (sizes checked by the caller); svec
// (n_scal), stangents (n_tangents x n_scal, null for K7), chunk_params
// (n_chunks x 2) and rows (n_chunks * blocks_per_chunk x 7 (1 + n_tangents))
// are device pointers. n_tangents is 6 (K6) or 0 (K7).
int art_launch_stats_params(const void* chain, const void* source, float opl_ref, int n_rays,
                            int chunk, int n_chunks, int n_scal, const float* svec,
                            const float* stangents, const float* chunk_params, double* rows,
                            int blocks_per_chunk, int n_tangents, void* stream) {
  if (n_scal < 24 || n_scal > MAX_SCALARS) return (int)cudaErrorInvalidValue;
  if (n_tangents == TANGENT_BATCH && stangents != nullptr)
    return launch_stats_params<TANGENT_BATCH>(chain, source, opl_ref, n_rays, chunk, n_chunks,
                                              n_scal, svec, stangents, chunk_params, rows,
                                              blocks_per_chunk, stream);
  if (n_tangents == 0)
    return launch_stats_params<0>(chain, source, opl_ref, n_rays, chunk, n_chunks, n_scal, svec,
                                  nullptr, chunk_params, rows, blocks_per_chunk, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
