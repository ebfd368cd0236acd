// Runtime-pose scan kernel for Hopper (sm_90a), bound through a plain C
// interface (ctypes, ops/_cuda.py).
//
// K5 scan_moments_kernel replaces the JAX package's
//   ops/pallas_scan.py::_kernel_scan_moments (pallas_call at :140).
//   K2 with every pose a runtime value, so every chain of a parameter scan
//   runs through one build and one packed record:
//   - the pose-independent part (element kinds, surface constants, supports,
//     support centres, source kind and law) is a __grid_constant__ ChainP /
//     SourceP whose maps are left empty;
//   - svec (12 * n_elements + 12 floats, ops/fused_grad.chain_scalars_np)
//     holds each element's composed map (M row-major, b), the first with the
//     source frame folded in, then the detector centre, normal, e1, e2 in the
//     final element's frame;
//   - aux (8 floats per chunk: opl_ref, inv_dn_chief, centre_distance, source
//     radius, ln edge, phase, k_frac, source-disk radius) holds the chief-ray
//     references, the Gaussian weight coefficient (0 gives weight 1) and the
//     chunk's spiral offsets.
//   Each block copies the records into shared memory, writes the poses from
//   svec and its chunk's aux row into them, and then runs K2's body: masks
//   are their own (unfolded) steps, as in the JAX kernel; the weight is
//   exp(aux[ln edge] * rr); dead rays are skipped; one float64 row of the 16
//   moments per block, no atomics; the host sums rows in float64.
//   Bound: like K2 it reads 4 B per pose scalar per block and writes 128 B per
//   2048 rays, so the per-ray arithmetic bounds it (PERF.md works the
//   operation count out for the flagship chain). Chunks of 2^23 rays keep
//   each local ray index float-exact; all chunks go in one launch
//   (blockIdx.y = chunk).
#include <cuda_runtime.h>

#include "trace_common.cuh"

namespace art {

constexpr int N_AUX = 8;
enum AuxSlot : int {
  AUX_OPL_REF = 0, AUX_INV_DN = 1, AUX_CENTRE_D = 2, AUX_RADIUS = 3,
  AUX_WCOEF = 4, AUX_PHASE = 5, AUX_KFRAC = 6, AUX_POS_RADIUS = 7
};

__global__ void __launch_bounds__(MOMENT_THREADS)
scan_moments_kernel(const __grid_constant__ ChainP shape, const __grid_constant__ SourceP law,
                    int n_rays, int chunk, const float* __restrict__ svec,
                    const float* __restrict__ aux, double* __restrict__ rows) {
  __shared__ ChainP ch;
  __shared__ SourceP src;
  __shared__ DetectorP det;
  const int c = blockIdx.y;
  const float* a = aux + c * N_AUX;
  {
    const int* from = reinterpret_cast<const int*>(&shape);
    int* to = reinterpret_cast<int*>(&ch);
    for (int i = threadIdx.x; i < (int)(sizeof(ChainP) / sizeof(int)); i += MOMENT_THREADS)
      to[i] = from[i];
  }
  if (threadIdx.x == 0) {
    src = law;
    const float r = a[AUX_RADIUS];
    src.radius = r;
    // the Gaussian law's denominator from the runtime radius, in float32
    src.rad2 = (law.kind == SRC_SQUARE) ? __fmul_rn(__fmul_rn(r, r), 0.5f) : __fmul_rn(r, r);
    src.ln_edge = a[AUX_WCOEF];
    src.weighted = 1;
    src.pos_radius = a[AUX_POS_RADIUS];
    det.opl_ref = a[AUX_OPL_REF];
    det.inv_dn_chief = a[AUX_INV_DN];
    det.centre_distance = a[AUX_CENTRE_D];
  }
  __syncthreads();
  const int n_el = ch.n_elements;
  for (int i = threadIdx.x; i < 12 * n_el; i += MOMENT_THREADS) {
    const int e = i / 12, j = i - 12 * (i / 12);
    if (j < 9) {
      ch.el[e].M[j] = svec[i];
    } else {
      ch.el[e].b[j - 9] = svec[i];
    }
  }
  if (threadIdx.x < 12) {
    const int g = threadIdx.x / 3, q = threadIdx.x - 3 * (threadIdx.x / 3);
    float* dst = g == 0 ? det.c : g == 1 ? det.n : g == 2 ? det.e1 : det.e2;
    dst[q] = svec[12 * n_el + threadIdx.x];
  }
  __syncthreads();

  const int n_local = min(chunk, n_rays - c * chunk);
  const float phase = a[AUX_PHASE], k_frac = a[AUX_KFRAC];
  float acc[N_MOMENTS];
#pragma unroll
  for (int m = 0; m < N_MOMENTS; ++m) acc[m] = 0.0f;
  const int base = blockIdx.x * MOMENT_RAYS_PER_BLOCK + threadIdx.x;
  for (int j = 0; j < MOMENT_RAYS_PER_THREAD; ++j) {
    const int k = base + j * MOMENT_THREADS;
    if (k >= n_local) break;
    Ray s;
    float rr;
    synth_source(src, k, phase, k_frac, s, rr);
    trace_chain<false>(ch, s);
    if (!s.alive) continue;
    add_moments(det, s, expf(src.ln_edge * rr), acc);
  }
  reduce_to_row<N_MOMENTS>(acc, rows + ((size_t)c * gridDim.x + blockIdx.x) * N_MOMENTS);
}

}  // namespace art

using namespace art;

extern "C" {

int art_scan_aux_size() { return N_AUX; }

// chain and source are host records (sizes checked by the caller); svec,
// aux (n_chunks x N_AUX) and rows are device pointers.
int art_launch_scan_moments(const void* chain, const void* source, int n_rays, int chunk,
                            int n_chunks, const float* svec, const float* aux, double* rows,
                            int blocks_per_chunk, void* stream) {
  const ChainP ch = *static_cast<const ChainP*>(chain);
  const SourceP src = *static_cast<const SourceP*>(source);
  const dim3 grid(blocks_per_chunk, n_chunks);
  scan_moments_kernel<<<grid, MOMENT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ch, src, n_rays, chunk, svec, aux, rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
