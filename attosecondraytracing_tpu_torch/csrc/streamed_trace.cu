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
// Dead rays' outputs other than alive = 0 are unspecified (they are not
// frozen at mirrors, as in the JAX kernels); a ray that enters K3 dead is
// stored as it was read, with alive = 0.
//
// Bound: K3 moves 74 B per ray (37 in, 37 out), K4 61 B (24 in, 37 out),
// 0.22 and 0.18 ms per 1e7 rays at 3.35 TB/s; against that stands K1's
// per-ray trace arithmetic without the source law, which a deformed mirror
// (the Zernike recurrence, the grid lookups) makes longer than the streams
// (PERF.md has the measured times beside both floors). Design:
// * Dead rays leave the walk by warp (trace_chain_maps ACTIVE_VOTE, as K1):
//   a bundle in the source's spiral order loses its rays at a mask as whole
//   warps, which then skip the rest of the chain; a ray that enters dead
//   runs no arithmetic at all.
// * One ray a thread, its streams loaded straight into registers and its
//   outputs stored from them, consecutive lanes on consecutive rays (every
//   warp's accesses coalesce); the SM's other warps hide the loads'
//   latency. Three designs that bring the streams through shared memory
//   measured slower (utils/kernel_variants.py k34_prefetch: a thread's
//   next ray in flight by cp.async; k34_tiles: warps walking tiles with a
//   ring of cp.async stages; k34_bulk: the block's tile by bulk copies on
//   an mbarrier; PERF.md): each costs the walk registers, instructions or
//   a block-wide wait, and saves no wait.
// The chain rides in the parameter space (__grid_constant__), the ray
// state in registers.
#include <cuda_runtime.h>

#include "trace_common.cuh"

namespace art {

constexpr int K34_THREADS = 256;

// the six streams of a bundle (K4's inputs: p, d only)
struct Streams {
  float *p, *d, *opl, *opl_c;
  unsigned char* alive;
  float* inc;
};

// Ray k of the thread: K3 (FRESH false) or K4.
template <bool FRESH, int DEFECTS>
__device__ __forceinline__ void trace_ray(const ChainP& ch, int n_rays, const Streams& in,
                                          const Streams& out) {
  const int k = blockIdx.x * K34_THREADS + threadIdx.x;
  if (k >= n_rays) return;
  Ray s;
  s.px = in.p[3 * k];
  s.py = in.p[3 * k + 1];
  s.pz = in.p[3 * k + 2];
  s.dx = in.d[3 * k];
  s.dy = in.d[3 * k + 1];
  s.dz = in.d[3 * k + 2];
  if constexpr (FRESH) {
    s.opl = 0.0f;
    s.opl_c = 0.0f;
    s.inc = 0.0f;
    s.alive = true;
  } else {
    s.opl = in.opl[k];
    s.opl_c = in.opl_c[k];
    s.inc = in.inc[k];
    s.alive = in.alive[k] != 0;
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
  trace_ray<false, DEFECTS>(ch, n_rays, in, out);
}

template <int DEFECTS>
__global__ void __launch_bounds__(K34_THREADS)
streamed_trace_fresh_kernel(const __grid_constant__ ChainP ch, int n_rays, Streams in, Streams out) {
  trace_ray<true, DEFECTS>(ch, n_rays, in, out);
}

}  // namespace art

using namespace art;

extern "C" {

// chain is a host record (size checked by the caller); every array is a
// device pointer (any element of its stream). K3 when fresh == 0
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
  const int blocks = (n_rays + K34_THREADS - 1) / K34_THREADS;
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
