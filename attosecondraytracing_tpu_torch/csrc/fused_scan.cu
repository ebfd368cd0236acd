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
//   Masks are their own (unfolded) steps, as in the JAX kernel; the weight is
//   exp(aux[ln edge] * rr); dead rays are skipped (a warp of dead rays leaves
//   the chain early); one float64 row of the 16 moments per block, no
//   atomics; the host sums rows in float64.
//
//   Bound: like K2 it reads 4 B per pose scalar per block and writes 128 B
//   per 2048 rays, so the per-ray arithmetic bounds it (PERF.md works the
//   operation count out for the flagship chain). What the design does about
//   it is where the records live. The chain and source records stay in the
//   kernel's parameter space (constant-bank operands, warp-uniform reads),
//   as in K2; only the pose vector goes to a shared table, read through
//   PoseMaps with the detector from its tail; the chunk's runtime source
//   fields (radius, rad2, ln edge, source-disk radius) go into a register
//   copy of the source record. This is K7's structure and K7's loop
//   (trace_runtime_pose, trace_common.cuh) with the moments as its epilogue.
//   The grid is sized to the rays (block_rays): no block starts empty.
//   Chunks of 2^23 rays keep each local ray index float-exact; all chunks go
//   in one launch.
#include <cuda_runtime.h>

#include "trace_common.cuh"

namespace art {

constexpr int N_AUX = 8;
enum AuxSlot : int {
  AUX_OPL_REF = 0, AUX_INV_DN = 1, AUX_CENTRE_D = 2, AUX_RADIUS = 3,
  AUX_WCOEF = 4, AUX_PHASE = 5, AUX_KFRAC = 6, AUX_POS_RADIUS = 7
};

template <int DEFECTS>
__global__ void __launch_bounds__(MOMENT_THREADS)
scan_moments_kernel(const __grid_constant__ ChainP ch, const __grid_constant__ SourceP law,
                    int n_rays, int chunk, int blocks_per_chunk, const float* __restrict__ svec,
                    const float* __restrict__ aux, double* __restrict__ rows) {
  __shared__ float pose[MAX_SCALARS];
  const int n_scal = 12 * ch.n_elements + 12;
  for (int i = threadIdx.x; i < n_scal; i += MOMENT_THREADS) pose[i] = svec[i];
  __syncthreads();
  const BlockRays br = block_rays<MOMENT_RAYS_PER_BLOCK>(blocks_per_chunk);
  const float* a = aux + br.chunk * N_AUX;
  SourceP src = law;
  const float r = a[AUX_RADIUS];
  src.radius = r;
  // the Gaussian law's denominator from the runtime radius, in float32
  src.rad2 = (law.kind == SRC_SQUARE) ? __fmul_rn(__fmul_rn(r, r), 0.5f) : __fmul_rn(r, r);
  src.ln_edge = a[AUX_WCOEF];
  src.pos_radius = a[AUX_POS_RADIUS];
  const float opl_ref = a[AUX_OPL_REF], inv_dn_chief = a[AUX_INV_DN];
  const float centre_d = a[AUX_CENTRE_D];
  const float* det = pose + 12 * ch.n_elements;  // centre, normal, e1, e2
  float acc[N_MOMENTS];
#pragma unroll
  for (int m = 0; m < N_MOMENTS; ++m) acc[m] = 0.0f;
  trace_runtime_pose<DEFECTS>(ch, src, pose, min(chunk, n_rays - br.chunk * chunk), br.first,
                              a[AUX_PHASE], a[AUX_KFRAC], [&](const Ray& s, float rr) {
                       add_moments(det, det + 3, det + 6, det + 9, opl_ref, inv_dn_chief,
                                   centre_d, s, expf(src.ln_edge * rr), acc);
                     });
  reduce_to_row<N_MOMENTS>(acc, rows + (size_t)blockIdx.x * N_MOMENTS);
}

}  // namespace art

using namespace art;

extern "C" {

int art_scan_aux_size() { return N_AUX; }

// chain and source are host records (sizes checked by the caller); svec,
// aux (n_chunks x N_AUX) and rows (n_blocks x 16) are device pointers; the
// grid is n_blocks blocks, blocks_per_chunk for each full chunk
// (ops/fused_trace.ray_grid).
int art_launch_scan_moments(const void* chain, const void* source, int n_rays, int chunk,
                            int blocks_per_chunk, int n_blocks, const float* svec,
                            const float* aux, double* rows, void* stream) {
  const ChainP ch = *static_cast<const ChainP*>(chain);
  const SourceP src = *static_cast<const SourceP*>(source);
  return with_defects(ch, [&](auto defects) {
    scan_moments_kernel<decltype(defects)::value>
        <<<n_blocks, MOMENT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            ch, src, n_rays, chunk, blocks_per_chunk, svec, aux, rows);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
