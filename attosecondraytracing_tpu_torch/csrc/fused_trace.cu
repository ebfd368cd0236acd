// Fused source -> chain kernels for Hopper (sm_90a), bound through a plain
// C interface (ctypes, ops/_cuda.py).
//
// K1 fused_source_trace_kernel replaces the JAX package's
//   ops/pallas_trace.py::_kernel_source (pallas_call at :525).
//   One thread per ray: the Vogel source is synthesized from the int32 ray
//   index, traced through the chain table and mapped back to the lab.
//   Bound: it reads nothing per ray and writes 37 B/ray (p, d: 24 B, opl,
//   opl_c, incidence: 12 B, alive: 1 B); against that store stream stands the
//   per-ray arithmetic (a grazing toroid takes a quadratic seed, a Newton
//   step and ~5 IEEE divides/square roots), which PERF.md finds to be the
//   bound on the H100. Design: the chain rides in the kernel's parameter space
//   (__grid_constant__, constant-cache broadcasts, warp-uniform reads) and
//   the state lives in registers; nothing is staged in memory.
//
// K2 fused_source_moments_kernel replaces
//   ops/pallas_trace.py::_kernel_source_moments (pallas_call at :1015).
//   The same trace without incidence, the Gaussian weight exp(ln_edge * rr)
//   and the 16 weighted detector moments. Each thread accumulates its rays
//   (MOMENT_RAYS_PER_THREAD, dead rays skipped by a branch) in float32; the
//   block reduces in float64 (reduce_to_row) and writes one row of 16
//   doubles; no atomics, so the result is deterministic. The host sums the
//   rows in float64. Bound: pure arithmetic, it writes 128 B per 2048 rays.
//   Chunks of 2^23 rays keep each local ray index float-exact; all chunks go
//   in one launch (blockIdx.y = chunk).
//
// K8 fused_source_stats_kernel replaces
//   ops/pallas_trace.py::_kernel_source_stats (pallas_call at :968), the
//   per-distance stats baseline that K2 replaced on the main path. K2's
//   trace, then the stats epilogue (stats_rows) at J <= 128 runtime
//   (distance, delay offset) pairs: 7 weighted sums per distance. 7 J
//   accumulators do not fit in registers, so each block takes a group of
//   STATS_GROUP = 8 distances (blockIdx.z) and every group retraces its rays:
//   the cost grows with ceil(J / 8), the property for which K2 (J-independent
//   moments) replaced this kernel. Bound: pure arithmetic, like K2; it writes
//   448 B per 2048 rays and group.
//
// This file also carries the library's shared C entry points (record sizes,
// error strings).
#include <cuda_runtime.h>

#include "trace_common.cuh"

namespace art {

constexpr int K1_THREADS = 256;

__global__ void __launch_bounds__(K1_THREADS)
fused_source_trace_kernel(const __grid_constant__ ChainP ch, const __grid_constant__ SourceP src,
                          int n_rays, float phase, float k_frac,
                          float* __restrict__ p, float* __restrict__ d,
                          float* __restrict__ opl, float* __restrict__ opl_c,
                          unsigned char* __restrict__ alive, float* __restrict__ inc) {
  const int k = blockIdx.x * K1_THREADS + threadIdx.x;
  if (k >= n_rays) return;
  Ray s;
  float rr;
  synth_source(src, k, phase, k_frac, s, rr);
  trace_chain<true>(ch, s);
  store_lab(ch, s, k, p, d, opl, opl_c, alive, inc);
}

__global__ void __launch_bounds__(MOMENT_THREADS)
fused_source_moments_kernel(const __grid_constant__ ChainP ch, const __grid_constant__ SourceP src,
                            const __grid_constant__ DetectorP det, int n_rays, int chunk,
                            const float2* __restrict__ chunk_params, double* __restrict__ rows) {
  const int c = blockIdx.y;
  const int n_local = min(chunk, n_rays - c * chunk);
  const float2 cp = chunk_params[c];
  float acc[N_MOMENTS];
#pragma unroll
  for (int m = 0; m < N_MOMENTS; ++m) acc[m] = 0.0f;
  const int base = blockIdx.x * MOMENT_RAYS_PER_BLOCK + threadIdx.x;
  for (int j = 0; j < MOMENT_RAYS_PER_THREAD; ++j) {
    const int k = base + j * MOMENT_THREADS;
    if (k >= n_local) break;
    Ray s;
    float rr;
    synth_source(src, k, cp.x, cp.y, s, rr);
    trace_chain<false>(ch, s);
    if (!s.alive) continue;
    const float w = src.weighted ? expf(src.ln_edge * rr) : 1.0f;
    add_moments(det, s, w, acc);
  }
  reduce_to_row<N_MOMENTS>(acc, rows + ((size_t)c * gridDim.x + blockIdx.x) * N_MOMENTS);
}

constexpr int STATS_GROUP = 8;
constexpr int STATS_ROW = STATS_GROUP * N_STATS;

__global__ void __launch_bounds__(MOMENT_THREADS)
fused_source_stats_kernel(const __grid_constant__ ChainP ch, const __grid_constant__ SourceP src,
                          const __grid_constant__ DetectorP det, int n_rays, int chunk, int n_dist,
                          const float2* __restrict__ chunk_params,
                          const float2* __restrict__ dist_params, double* __restrict__ rows) {
  const int c = blockIdx.y;
  const int j0 = blockIdx.z * STATS_GROUP;
  const int nj = min(STATS_GROUP, n_dist - j0);
  const int n_local = min(chunk, n_rays - c * chunk);
  const float2 cp = chunk_params[c];
  float2 dp[STATS_GROUP];  // (distance, delay offset) of this block's group
#pragma unroll
  for (int j = 0; j < STATS_GROUP; ++j)
    dp[j] = j < nj ? dist_params[j0 + j] : make_float2(0.0f, 0.0f);
  float acc[STATS_ROW];
#pragma unroll
  for (int m = 0; m < STATS_ROW; ++m) acc[m] = 0.0f;
  const int base = blockIdx.x * MOMENT_RAYS_PER_BLOCK + threadIdx.x;
  for (int r = 0; r < MOMENT_RAYS_PER_THREAD; ++r) {
    const int k = base + r * MOMENT_THREADS;
    if (k >= n_local) break;
    Ray s;
    float rr;
    synth_source(src, k, cp.x, cp.y, s, rr);
    trace_chain<false>(ch, s);
    if (!s.alive) continue;
    const float w = src.weighted ? expf(src.ln_edge * rr) : 1.0f;
    const StatsGeom<float> g = stats_geometry(det.c, det.n, det.e1, det.e2, det.opl_ref, s);
#pragma unroll
    for (int j = 0; j < STATS_GROUP; ++j) {
      if (j < nj) {
        const float tj = g.t0 - dp[j].x * g.inv_dn;
        float terms[N_STATS];
        stats_terms(g, tj, sub_rn(add_rn(g.dsmall, tj), dp[j].y), w, terms);
#pragma unroll
        for (int f = 0; f < N_STATS; ++f) acc[j * N_STATS + f] += terms[f];
      }
    }
  }
  const size_t row = ((size_t)c * gridDim.x + blockIdx.x) * gridDim.z + blockIdx.z;
  reduce_to_row<STATS_ROW>(acc, rows + row * STATS_ROW);
}

}  // namespace art

using namespace art;

extern "C" {

// Version of this C interface; ops/_cuda.py loads only its own. Version 2:
// the runtime-pose kernels (K5-K7) take a grid sized to the rays and K6 all
// tangent rows of a gradient step. Libraries without this entry point have
// version 1's signatures (utils/kernel_ab.py binds them for A/B runs).
int art_abi_version() { return 2; }

size_t art_chain_params_size() { return sizeof(ChainP); }
size_t art_source_params_size() { return sizeof(SourceP); }
size_t art_detector_params_size() { return sizeof(DetectorP); }
int art_moment_rays_per_block() { return MOMENT_RAYS_PER_BLOCK; }
int art_stats_group() { return STATS_GROUP; }
const char* art_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The records are host bytes laid out as the structs above (checked against
// sizeof by the caller); they are copied into the launch's parameter space.
int art_launch_fused_source_trace(const void* chain, const void* source, int n_rays, float phase,
                                  float k_frac, float* p, float* d, float* opl, float* opl_c,
                                  unsigned char* alive, float* inc, void* stream) {
  const ChainP ch = *static_cast<const ChainP*>(chain);
  const SourceP src = *static_cast<const SourceP*>(source);
  const int blocks = (n_rays + K1_THREADS - 1) / K1_THREADS;
  fused_source_trace_kernel<<<blocks, K1_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ch, src, n_rays, phase, k_frac, p, d, opl, opl_c, alive, inc);
  return (int)cudaGetLastError();
}

int art_launch_fused_source_moments(const void* chain, const void* source, const void* detector,
                                    int n_rays, int chunk, int n_chunks, const float* chunk_params,
                                    double* rows, int blocks_per_chunk, void* stream) {
  const ChainP ch = *static_cast<const ChainP*>(chain);
  const SourceP src = *static_cast<const SourceP*>(source);
  const DetectorP det = *static_cast<const DetectorP*>(detector);
  const dim3 grid(blocks_per_chunk, n_chunks);
  fused_source_moments_kernel<<<grid, MOMENT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ch, src, det, n_rays, chunk, reinterpret_cast<const float2*>(chunk_params), rows);
  return (int)cudaGetLastError();
}

// K8: rows hold, per block (chunk, block, group of distances), one row of
// STATS_GROUP x 7 doubles; chunk_params (n_chunks x 2) and dist_params
// (n_dist x 2: distance, delay offset) are device pointers.
int art_launch_fused_source_stats(const void* chain, const void* source, const void* detector,
                                  int n_rays, int chunk, int n_chunks, const float* chunk_params,
                                  const float* dist_params, int n_dist, double* rows,
                                  int blocks_per_chunk, void* stream) {
  if (n_dist < 1) return (int)cudaErrorInvalidValue;
  const ChainP ch = *static_cast<const ChainP*>(chain);
  const SourceP src = *static_cast<const SourceP*>(source);
  const DetectorP det = *static_cast<const DetectorP*>(detector);
  const dim3 grid(blocks_per_chunk, n_chunks, (n_dist + STATS_GROUP - 1) / STATS_GROUP);
  fused_source_stats_kernel<<<grid, MOMENT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ch, src, det, n_rays, chunk, n_dist, reinterpret_cast<const float2*>(chunk_params),
      reinterpret_cast<const float2*>(dist_params), rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
