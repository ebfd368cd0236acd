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
//   (K2_RAYS_PER_THREAD, dead rays skipped by a branch) in float32; the block
//   reduces in float64 (warp shuffles, then shared memory) and writes one row
//   of 16 doubles; no atomics, so the result is deterministic. The host sums
//   the rows in float64. Bound: pure arithmetic, it writes 128 B per 2048
//   rays. Chunks of 2^23 rays keep each local ray index float-exact; all
//   chunks go in one launch (blockIdx.y = chunk).
#include <cuda_runtime.h>

#include "trace_common.cuh"

namespace art {

constexpr int K1_THREADS = 256;
constexpr int K2_THREADS = 256;
constexpr int K2_RAYS_PER_THREAD = 8;
constexpr int K2_RAYS_PER_BLOCK = K2_THREADS * K2_RAYS_PER_THREAD;
constexpr int N_MOMENTS = 16;

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
  // patch-relative frame K -> lab: p = RK^T x + posK, d = RK^T d
  const float* R = ch.RK;
  p[3 * k + 0] = R[0] * s.px + R[3] * s.py + R[6] * s.pz + ch.posK[0];
  p[3 * k + 1] = R[1] * s.px + R[4] * s.py + R[7] * s.pz + ch.posK[1];
  p[3 * k + 2] = R[2] * s.px + R[5] * s.py + R[8] * s.pz + ch.posK[2];
  d[3 * k + 0] = R[0] * s.dx + R[3] * s.dy + R[6] * s.dz;
  d[3 * k + 1] = R[1] * s.dx + R[4] * s.dy + R[7] * s.dz;
  d[3 * k + 2] = R[2] * s.dx + R[5] * s.dy + R[8] * s.dz;
  opl[k] = s.opl;
  opl_c[k] = s.opl_c;
  alive[k] = s.alive ? 1 : 0;
  inc[k] = s.inc;
}

// ops/fused_trace.moment_rows for one alive ray
__device__ __forceinline__ void add_moments(const DetectorP& det, const Ray& s, float w,
                                            float* acc) {
  const float dn = s.dx * det.n[0] + s.dy * det.n[1] + s.dz * det.n[2];
  const float inv_dn = 1.0f / (fabsf(dn) > 1e-30f ? dn : CUDART_INF_F);
  const float b0 = (det.c[0] - s.px) * det.n[0] + (det.c[1] - s.py) * det.n[1] +
                   (det.c[2] - s.pz) * det.n[2];
  const float t0 = (b0 - det.centre_distance) * inv_dn;
  const float rx = s.px - det.c[0], ry = s.py - det.c[1], rz = s.pz - det.c[2];
  const float a1 = rx * det.e1[0] + ry * det.e1[1] + rz * det.e1[2];
  const float a2 = rx * det.e2[0] + ry * det.e2[1] + rz * det.e2[2];
  const float g1 = s.dx * det.e1[0] + s.dy * det.e1[1] + s.dz * det.e1[2];
  const float g2 = s.dx * det.e2[0] + s.dy * det.e2[1] + s.dz * det.e2[2];
  const float x0 = a1 + t0 * g1;
  const float y0 = a2 + t0 * g2;
  const float cx = inv_dn * g1;
  const float cy = inv_dn * g2;
  const float cd = inv_dn - det.inv_dn_chief;
  // fs-scale delay: the same-magnitude subtractions stay unfused
  const float d0 = __fadd_rn(__fadd_rn(__fsub_rn(__fsub_rn(s.opl, det.opl_ref), s.opl_c), t0),
                             __fmul_rn(det.centre_distance, det.inv_dn_chief));
  const float wx0 = w * x0, wy0 = w * y0, wd0 = w * d0;
  const float wcx = w * cx, wcy = w * cy, wcd = w * cd;
  acc[0] += w;
  acc[1] += wx0;
  acc[2] += wy0;
  acc[3] += wd0;
  acc[4] += wcx;
  acc[5] += wcy;
  acc[6] += wcd;
  acc[7] += wx0 * x0;
  acc[8] += wy0 * y0;
  acc[9] += wd0 * d0;
  acc[10] += wx0 * cx;
  acc[11] += wy0 * cy;
  acc[12] += wd0 * cd;
  acc[13] += wcx * cx;
  acc[14] += wcy * cy;
  acc[15] += wcd * cd;
}

__global__ void __launch_bounds__(K2_THREADS)
fused_source_moments_kernel(const __grid_constant__ ChainP ch, const __grid_constant__ SourceP src,
                            const __grid_constant__ DetectorP det, int n_rays, int chunk,
                            const float2* __restrict__ chunk_params, double* __restrict__ rows) {
  const int c = blockIdx.y;
  const int n_local = min(chunk, n_rays - c * chunk);
  const float2 cp = chunk_params[c];
  float acc[N_MOMENTS];
#pragma unroll
  for (int m = 0; m < N_MOMENTS; ++m) acc[m] = 0.0f;
  const int base = blockIdx.x * K2_RAYS_PER_BLOCK + threadIdx.x;
  for (int j = 0; j < K2_RAYS_PER_THREAD; ++j) {
    const int k = base + j * K2_THREADS;
    if (k >= n_local) break;
    Ray s;
    float rr;
    synth_source(src, k, cp.x, cp.y, s, rr);
    trace_chain<false>(ch, s);
    if (!s.alive) continue;
    const float w = src.weighted ? expf(src.ln_edge * rr) : 1.0f;
    add_moments(det, s, w, acc);
  }
  // block reduction in float64: warp shuffles, then one row per warp in
  // shared memory, summed by the first warp
  __shared__ double part[K2_THREADS / 32][N_MOMENTS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < N_MOMENTS; ++m) {
    double v = (double)acc[m];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) part[warp][m] = v;
  }
  __syncthreads();
  if (threadIdx.x < N_MOMENTS) {
    double v = 0.0;
#pragma unroll
    for (int w = 0; w < K2_THREADS / 32; ++w) v += part[w][threadIdx.x];
    rows[((size_t)c * gridDim.x + blockIdx.x) * N_MOMENTS + threadIdx.x] = v;
  }
}

}  // namespace art

using namespace art;

extern "C" {

size_t art_chain_params_size() { return sizeof(ChainP); }
size_t art_source_params_size() { return sizeof(SourceP); }
size_t art_detector_params_size() { return sizeof(DetectorP); }
int art_moment_rays_per_block() { return K2_RAYS_PER_BLOCK; }
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
  fused_source_moments_kernel<<<grid, K2_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ch, src, det, n_rays, chunk, reinterpret_cast<const float2*>(chunk_params), rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
