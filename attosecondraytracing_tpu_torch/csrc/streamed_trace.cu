// Streamed-bundle trace kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes, ops/_cuda.py).
//
// K3 streamed_trace_kernel replaces the JAX package's
//   ops/pallas_trace.py::_kernel (pallas_call at :239, fresh=False): a bundle
//   the user built or changed is read ray by ray (p, d as (n, 3) float32;
//   opl, opl_c, incidence as (n,) float32; alive as (n,) bytes), traced
//   through the chain table in chained frames (the first map takes lab
//   coordinates into element 0's frame, non-terminal masks folded into
//   premasks), mapped back to the lab and written as K1 writes its bundle.
// K4 streamed_trace_fresh_kernel replaces ops/pallas_trace.py::_kernel_fresh
//   (the same pallas_call, fresh=True): a bundle fresh from a source factory,
//   so only p and d are read; opl, opl_c and incidence start at 0 and every
//   ray k < n starts alive.
// One thread per ray; dead rays are traced too (not frozen at mirrors, as in
// the JAX kernels) and their outputs other than alive = 0 are unspecified.
// Bound: K3 moves 74 B per ray (37 in, 37 out), K4 61 B (24 in, 37 out),
// 0.22 and 0.18 ms per 1e7 rays at 3.35 TB/s; against that stands K1's
// per-ray trace arithmetic without the source law (PERF.md has the measured
// times beside both floors). Design:
// the chain rides in the parameter space (__grid_constant__), the state in
// registers; each thread's loads and stores are consecutive words of
// neighbouring rays, so every warp's accesses coalesce.
#include <cuda_runtime.h>

#include "trace_common.cuh"

namespace art {

constexpr int K3_THREADS = 256;

template <int DEFECTS>
__global__ void __launch_bounds__(K3_THREADS)
streamed_trace_kernel(const __grid_constant__ ChainP ch, int n_rays,
                      const float* __restrict__ p_in, const float* __restrict__ d_in,
                      const float* __restrict__ opl_in, const float* __restrict__ opl_c_in,
                      const unsigned char* __restrict__ alive_in,
                      const float* __restrict__ inc_in,
                      float* __restrict__ p, float* __restrict__ d,
                      float* __restrict__ opl, float* __restrict__ opl_c,
                      unsigned char* __restrict__ alive, float* __restrict__ inc) {
  const int k = blockIdx.x * K3_THREADS + threadIdx.x;
  if (k >= n_rays) return;
  Ray s;
  s.px = p_in[3 * k + 0];
  s.py = p_in[3 * k + 1];
  s.pz = p_in[3 * k + 2];
  s.dx = d_in[3 * k + 0];
  s.dy = d_in[3 * k + 1];
  s.dz = d_in[3 * k + 2];
  s.opl = opl_in[k];
  s.opl_c = opl_c_in[k];
  s.inc = inc_in[k];
  s.alive = alive_in[k] != 0;
  trace_chain<true, NO_EXIT, DEFECTS>(ch, s);
  store_lab(ch, s, k, p, d, opl, opl_c, alive, inc);
}

template <int DEFECTS>
__global__ void __launch_bounds__(K3_THREADS)
streamed_trace_fresh_kernel(const __grid_constant__ ChainP ch, int n_rays,
                            const float* __restrict__ p_in, const float* __restrict__ d_in,
                            float* __restrict__ p, float* __restrict__ d,
                            float* __restrict__ opl, float* __restrict__ opl_c,
                            unsigned char* __restrict__ alive, float* __restrict__ inc) {
  const int k = blockIdx.x * K3_THREADS + threadIdx.x;
  if (k >= n_rays) return;
  Ray s;
  s.px = p_in[3 * k + 0];
  s.py = p_in[3 * k + 1];
  s.pz = p_in[3 * k + 2];
  s.dx = d_in[3 * k + 0];
  s.dy = d_in[3 * k + 1];
  s.dz = d_in[3 * k + 2];
  s.opl = 0.0f;
  s.opl_c = 0.0f;
  s.inc = 0.0f;
  s.alive = true;
  trace_chain<true, NO_EXIT, DEFECTS>(ch, s);
  store_lab(ch, s, k, p, d, opl, opl_c, alive, inc);
}

}  // namespace art

using namespace art;

extern "C" {

// chain is a host record (size checked by the caller); every array is a
// device pointer. K3 when fresh == 0 (reads every input), K4 otherwise
// (reads p and d only; the other inputs may be null).
int art_launch_streamed_trace(const void* chain, int n_rays, int fresh, const float* p_in,
                              const float* d_in, const float* opl_in, const float* opl_c_in,
                              const unsigned char* alive_in, const float* inc_in, float* p,
                              float* d, float* opl, float* opl_c, unsigned char* alive,
                              float* inc, void* stream) {
  const ChainP ch = *static_cast<const ChainP*>(chain);
  const int blocks = (n_rays + K3_THREADS - 1) / K3_THREADS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_defects(ch, [&](auto defects) {
    constexpr int D = decltype(defects)::value;
    if (fresh) {
      streamed_trace_fresh_kernel<D><<<blocks, K3_THREADS, 0, st>>>(ch, n_rays, p_in, d_in, p, d,
                                                                    opl, opl_c, alive, inc);
    } else {
      streamed_trace_kernel<D><<<blocks, K3_THREADS, 0, st>>>(ch, n_rays, p_in, d_in, opl_in,
                                                              opl_c_in, alive_in, inc_in, p, d,
                                                              opl, opl_c, alive, inc);
    }
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
