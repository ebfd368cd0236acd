// Fused source -> chain kernels for Hopper (sm_90a), bound through a plain
// C interface (ctypes, ops/_cuda.py).
//
// K1 fused_source_trace_kernel replaces the JAX package's
//   ops/pallas_trace.py::_kernel_source (pallas_call at :525).
//   The Vogel source is synthesized from the int32 ray index, traced through
//   the chain table and mapped back to the lab. Bound: it reads nothing per
//   ray and writes 37 B/ray (p, d: 24 B, opl, opl_c, incidence: 12 B, alive:
//   1 B); against that store stream stands the per-ray arithmetic (a grazing
//   toroid takes a quadratic seed, a Newton step, 4 reciprocal square roots
//   and 2 divides), which PERF.md finds to be the bound on the H100. Design:
//   the chain rides in the kernel's parameter space (__grid_constant__,
//   constant-cache broadcasts, warp-uniform reads) and the state lives in
//   registers; nothing is staged in memory. One ray per thread; a warp
//   whose rays all died at a mask leaves the chain (ACTIVE_VOTE: the
//   flagship's mask kills 51 % of its rays as whole warps) and still stores
//   them (alive 0, the other fields as the exit left them). The vote names
//   the lanes still active, so the lanes past the end return at once, as
//   before the exit: the alive rays' outputs are the earlier build's bit for
//   bit. (The warp-uniform loop of the summing kernels, for_thread_rays,
//   changes how nvcc contracts the trace's products into FMAs on 1 % of
//   the flagship's alive rays; PERF.md §6.)
//
// K1i fused_source_image_kernel replaces the JAX package's
//   analysis/gigascan.py::_images_fused_pallas (:75): a loop of K1's
//   pallas_call (ops/pallas_trace.py:525), one per chunk, with the chunk's
//   weights and one-hot-matmul binning in XLA. One launch traces every chunk
//   of an image (K2's grid: block_rays over the chunk table) and bins each
//   alive ray where it lands: the weight exp(ln_edge * rr), the lab ray's
//   detector point and leg, its in-plane coordinates, its Kahan delay
//   against the chief ray and its pixel, each rounded where the plain path
//   (analysis/gigascan._chunk_rays) rounds, then two float64 atomic adds
//   (red.global.add.f64, resolved in L2) into the flat weight and weight x
//   delay images. Bound: nothing is read per ray and the images (2 x 8 B a
//   pixel, 4 MB at 512 x 512, resident in the 50 MB L2) are the only HBM
//   traffic, so the bound is K2's trace operations plus the image epilogue's
//   per alive ray; the hot pixels of a focus serialize their atomics in L2.
//   A 512 x 512 image pair does not fit a block's shared memory. The atomics'
//   order varies, so the images are reproducible to float64 rounding, not
//   bit for bit. An optional per-ray record (flat pixel or -1, weight,
//   delay) of a range of chunks lets a check hold every ray of those chunks
//   against the plain path.
//
// K2 fused_source_moments_kernel replaces
//   ops/pallas_trace.py::_kernel_source_moments (pallas_call at :1015).
//   The same trace without incidence, the Gaussian weight exp(ln_edge * rr)
//   and the 16 weighted detector moments. Bound: pure arithmetic, it reads
//   nothing per ray and writes 128 B per block, and on this card the
//   arithmetic is bound by what an SM issues per ray (4 warp issue slots per
//   clock), not by latency. The design takes as few slots as it can: reciprocal square roots, the chain's divides and seed square
//   roots from the special-function unit (dual.cuh); a warp whose rays all
//   died at the mask leaves the chain (trace_chain_maps WARP_VOTE); each
//   thread accumulates K2_RAYS_PER_THREAD rays in float32 and the block
//   reduces in float64 through shared columns (reduce_columns), so the
//   epilogue costs per block; the grid is sized to the rays (block_rays), no
//   block starts empty. One row of 16 doubles per block, no atomics, so the
//   result is deterministic; the host sums the rows in float64. Chunks of
//   2^23 rays keep each local ray index float-exact; all chunks go in one
//   launch.
//
// K8 fused_source_stats_kernel replaces
//   ops/pallas_trace.py::_kernel_source_stats (pallas_call at :968), the
//   per-distance stats baseline that K2 replaced on the main path: K2's
//   trace, then the stats epilogue (stats_rows) at J <= 128 runtime
//   (distance, delay offset) pairs, 7 weighted sums per distance. Bound: pure
//   arithmetic like K2, one trace per ray and 21 operations per alive ray and
//   distance; it writes 56 J B per block. 7 J sums do not fit a thread's
//   registers, so the kernel runs in two phases. Phase 1 traces each of the
//   thread's K8_RAYS_PER_THREAD rays once, whatever J is, and keeps what the
//   distances need of an alive ray, its StatsGeom and weight (8 floats), in
//   the thread's column of dynamic shared memory (48 KB a block and 7 KB of
//   reduction columns: 4 blocks, 32 warps per SM, as many as its 61
//   registers allow; more rays per thread amortise phase 2's reductions
//   further but cost phase 1 its warps). A block none of whose rays survived
//   writes zeros and stops. Phase 2 walks the distances in tiles of K8_TILE:
//   a tile's 7 K8_TILE sums over the thread's kept rays fit in registers
//   (one shared-memory read of a ray serves the whole tile), and each
//   distance's 7 columns go through the block reduction, which costs per
//   block. Rows are (blocks, J, 7) doubles.
//
// Each kernel is instantiated on DEFECTS (trace_common.cuh): the launch
// takes the Zernike branch's instantiation for a chain with Zernike tables
// only, the grid branch's for a chain with grid maps, and the defect-free
// one otherwise (with_defects). A grid mirror adds per ray two
// bilinear lookups (the height at the base hit; with ignore_defects False
// the slopes at the shifted hit), each four 16-byte reads of its packed
// rows through the read-only path; a map that fits the 50 MB L2 (the
// grid flagship's 31 MB) is served from it, a larger one (CONFIG_deformed's
// 1 GB) from HBM, and K1's spiral order scatters a warp's lanes over the
// map (PERF.md: the gather probe P4's cost per point beside K1's).
//
// This file also carries the library's shared C entry points (record sizes,
// error strings).
#include <cuda_runtime.h>

#include "trace_common.cuh"

namespace art {

constexpr int K1_THREADS = 256;

template <int DEFECTS>
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
  trace_chain<true, ACTIVE_VOTE, DEFECTS>(ch, s);
  store_lab(ch, s, k, p, d, opl, opl_c, alive, inc);
}

// K1i's image record (ops/fused_trace.IMAGE_T): the detector plane in the
// lab, rows 0-1 of its rotation (lab -> plane), the chief ray's optical
// path, fs per mm, and the window as the plain path forms it in float32:
// its origin and bins / (hi - lo) per axis
struct ImageP {
  float c[3], n[3];
  float rot[6];
  float opl_ref;
  float fs_per_mm;
  float lo[2], scale[2];
  int nx, ny;
};

// K1i's epilogue of an alive ray (analysis/gigascan._chunk_rays): the
// detector point and leg t (stats.detector_points_3d), the in-plane
// coordinates (stats.plane_coords), the delay ((s - opl_ref) - c) * fs_per_mm
// after kahan_add(opl, opl_c, t), and the pixel (histogram._bin_indices:
// truncation toward zero, clamp, 0 <= f <= n). Every rounding as the plain
// path's separate operations round (_rn: nothing contracts). Returns the
// flat pixel ix * ny + iy, or -1 outside the window.
__device__ __forceinline__ int image_pixel(const ImageP& im, const ChainP& ch, const Ray& s,
                                           float& delay) {
  float P[3], D[3];
  to_lab(ch, s, P, D);
  float num = __fmul_rn(im.n[0], __fsub_rn(im.c[0], P[0]));
  num = __fadd_rn(num, __fmul_rn(im.n[1], __fsub_rn(im.c[1], P[1])));
  num = __fadd_rn(num, __fmul_rn(im.n[2], __fsub_rn(im.c[2], P[2])));
  float den = __fmul_rn(D[0], im.n[0]);
  den = __fadd_rn(den, __fmul_rn(D[1], im.n[1]));
  den = __fadd_rn(den, __fmul_rn(D[2], im.n[2]));
  const float t = __fdiv_rn(num, fabsf(den) > 1e-30f ? den : CUDART_INF_F);
  float r[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) r[j] = __fsub_rn(__fadd_rn(P[j], __fmul_rn(t, D[j])), im.c[j]);
  const float x = __fadd_rn(__fadd_rn(__fmul_rn(r[0], im.rot[0]), __fmul_rn(r[1], im.rot[1])),
                            __fmul_rn(r[2], im.rot[2]));
  const float y = __fadd_rn(__fadd_rn(__fmul_rn(r[0], im.rot[3]), __fmul_rn(r[1], im.rot[4])),
                            __fmul_rn(r[2], im.rot[5]));
  float so = s.opl, co = s.opl_c;
  kahan_add(so, co, t);
  delay = __fmul_rn(__fsub_rn(__fsub_rn(so, im.opl_ref), co), im.fs_per_mm);
  const float fx = __fmul_rn(__fsub_rn(x, im.lo[0]), im.scale[0]);
  const float fy = __fmul_rn(__fsub_rn(y, im.lo[1]), im.scale[1]);
  if (!(fx >= 0.0f && fx <= (float)im.nx && fy >= 0.0f && fy <= (float)im.ny)) return -1;
  const int ix = min(max((int)fx, 0), im.nx - 1);
  const int iy = min(max((int)fy, 0), im.ny - 1);
  return ix * im.ny + iy;
}

constexpr int K1I_RAYS_PER_THREAD = 32;
constexpr int K1I_RAYS_PER_BLOCK = MOMENT_THREADS * K1I_RAYS_PER_THREAD;

// Add one ray's weight and weight x delay at pixel flat (-1: nothing), each
// lane its own float64 atomics (resolved in L2: per-lane red.global.add.f64).
// All 32 lanes of the warp call it (the ray loop is warp-uniform).
__device__ __forceinline__ void add_to_images(int flat, float w, float wd,
                                              double* __restrict__ w_img,
                                              double* __restrict__ wd_img) {
  if (flat < 0) return;
  atomicAdd(w_img + flat, (double)w);
  atomicAdd(wd_img + flat, (double)wd);
}

template <int DEFECTS>
__global__ void __launch_bounds__(MOMENT_THREADS)
fused_source_image_kernel(const __grid_constant__ ChainP ch, const __grid_constant__ SourceP src,
                          const __grid_constant__ ImageP im, int n_rays, int chunk,
                          int blocks_per_chunk, const float2* __restrict__ chunk_params,
                          double* __restrict__ w_img, double* __restrict__ wd_img,
                          int rec_first, int rec_chunks, int* __restrict__ rec_flat,
                          float* __restrict__ rec_w, float* __restrict__ rec_delay) {
  const BlockRays br = block_rays<K1I_RAYS_PER_BLOCK>(blocks_per_chunk);
  const float2 cp = chunk_params[br.chunk];
  const int rc = br.chunk - rec_first;
  const bool record = rec_flat != nullptr && rc >= 0 && rc < rec_chunks;
  for_thread_rays<K1I_RAYS_PER_THREAD>(
      br.first, min(chunk, n_rays - br.chunk * chunk), [&](int k, bool in_range) {
        Ray s;
        float rr;
        synth_source(src, k, cp.x, cp.y, s, rr);
        s.alive = in_range;
        trace_chain<false, WARP_VOTE, DEFECTS>(ch, s);
        float delay = 0.0f;
        const int flat = s.alive ? image_pixel(im, ch, s, delay) : -1;
        const float w = (flat >= 0 || record) && src.weighted ? expf(src.ln_edge * rr) : 1.0f;
        add_to_images(flat, w, __fmul_rn(w, delay), w_img, wd_img);
        if (record && in_range) {
          const size_t i = (size_t)rc * chunk + k;
          rec_flat[i] = flat;
          rec_w[i] = w;
          rec_delay[i] = flat >= 0 ? delay : 0.0f;
        }
      });
}

constexpr int K2_RAYS_PER_THREAD = 16;
constexpr int K2_RAYS_PER_BLOCK = MOMENT_THREADS * K2_RAYS_PER_THREAD;

template <int DEFECTS>
__global__ void __launch_bounds__(MOMENT_THREADS)
fused_source_moments_kernel(const __grid_constant__ ChainP ch, const __grid_constant__ SourceP src,
                            const __grid_constant__ DetectorP det, int n_rays, int chunk,
                            int blocks_per_chunk, const float2* __restrict__ chunk_params,
                            double* __restrict__ rows) {
  const BlockRays br = block_rays<K2_RAYS_PER_BLOCK>(blocks_per_chunk);
  const float2 cp = chunk_params[br.chunk];
  float acc[N_MOMENTS];
#pragma unroll
  for (int m = 0; m < N_MOMENTS; ++m) acc[m] = 0.0f;
  for_thread_rays<K2_RAYS_PER_THREAD>(
      br.first, min(chunk, n_rays - br.chunk * chunk), [&](int k, bool in_range) {
        Ray s;
        float rr;
        synth_source(src, k, cp.x, cp.y, s, rr);
        s.alive = in_range;
        trace_chain<false, WARP_VOTE, DEFECTS>(ch, s);
        if (!s.alive) return;
        const float w = src.weighted ? expf(src.ln_edge * rr) : 1.0f;
        add_moments(det, s, w, acc);
      });
  reduce_to_row<N_MOMENTS>(acc, rows + (size_t)blockIdx.x * N_MOMENTS);
}

constexpr int K8_RAYS_PER_THREAD = 6;
constexpr int K8_RAYS_PER_BLOCK = MOMENT_THREADS * K8_RAYS_PER_THREAD;
constexpr int K8_TILE = 4;   // distances per pass over a thread's kept rays
constexpr int N_KEPT = 8;    // floats kept per alive ray: StatsGeom's 7 and the weight
constexpr int MAX_STATS_DISTANCES = 128;
// kept rays (K8_RAYS_PER_THREAD x N_KEPT columns), then one distance's 7 columns
constexpr int K8_SMEM_FLOATS = (K8_RAYS_PER_THREAD * N_KEPT + N_STATS) * MOMENT_THREADS;

extern __shared__ float stats_smem[];

template <int DEFECTS>
__global__ void __launch_bounds__(MOMENT_THREADS)
fused_source_stats_kernel(const __grid_constant__ ChainP ch, const __grid_constant__ SourceP src,
                          const __grid_constant__ DetectorP det, int n_rays, int chunk,
                          int blocks_per_chunk, int n_dist,
                          const float2* __restrict__ chunk_params,
                          const float2* __restrict__ dist_params, double* __restrict__ rows) {
  float* kept = stats_smem + threadIdx.x;  // field f of kept ray i at kept[(i * N_KEPT + f) * MOMENT_THREADS]
  float* cols = stats_smem + K8_RAYS_PER_THREAD * N_KEPT * MOMENT_THREADS;
  const BlockRays br = block_rays<K8_RAYS_PER_BLOCK>(blocks_per_chunk);
  const float2 cp = chunk_params[br.chunk];
  // phase 1: one trace per ray; alive rays are kept in order, dead ones dropped
  int n_kept = 0;
  for_thread_rays<K8_RAYS_PER_THREAD>(
      br.first, min(chunk, n_rays - br.chunk * chunk), [&](int k, bool in_range) {
        Ray s;
        float rr;
        synth_source(src, k, cp.x, cp.y, s, rr);
        s.alive = in_range;
        trace_chain<false, WARP_VOTE, DEFECTS>(ch, s);
        if (!s.alive) return;
        const StatsGeom<float> g = stats_geometry(det.c, det.n, det.e1, det.e2, det.opl_ref, s);
        float* ray = kept + n_kept * N_KEPT * MOMENT_THREADS;
        ray[0 * MOMENT_THREADS] = g.t0;
        ray[1 * MOMENT_THREADS] = g.inv_dn;
        ray[2 * MOMENT_THREADS] = g.a1;
        ray[3 * MOMENT_THREADS] = g.a2;
        ray[4 * MOMENT_THREADS] = g.g1;
        ray[5 * MOMENT_THREADS] = g.g2;
        ray[6 * MOMENT_THREADS] = g.dsmall;
        ray[7 * MOMENT_THREADS] = src.weighted ? expf(src.ln_edge * rr) : 1.0f;
        ++n_kept;
      });
  double* row = rows + (size_t)blockIdx.x * n_dist * N_STATS;
  // a block none of whose rays survived (a mask kills whole rings of the
  // spiral, so whole blocks) writes its zeros without the distance loop
  if (__syncthreads_or(n_kept) == 0) {
    for (int m = threadIdx.x; m < n_dist * N_STATS; m += MOMENT_THREADS) row[m] = 0.0;
    return;
  }
  // phase 2: the distances, a tile at a time
  for (int j0 = 0; j0 < n_dist; j0 += K8_TILE) {
    const int nt = min(K8_TILE, n_dist - j0);
    float2 dp[K8_TILE];  // (distance, delay offset)
    float acc[K8_TILE][N_STATS];
#pragma unroll
    for (int t = 0; t < K8_TILE; ++t) {
      dp[t] = t < nt ? dist_params[j0 + t] : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int f = 0; f < N_STATS; ++f) acc[t][f] = 0.0f;
    }
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
#pragma unroll
      for (int t = 0; t < K8_TILE; ++t) {
        if (t < nt) {
          const float tj = g.t0 - dp[t].x * g.inv_dn;
          float terms[N_STATS];
          stats_terms(g, tj, sub_rn(add_rn(g.dsmall, tj), dp[t].y), w, terms);
#pragma unroll
          for (int f = 0; f < N_STATS; ++f) acc[t][f] += terms[f];
        }
      }
    }
#pragma unroll
    for (int t = 0; t < K8_TILE; ++t) {
      if (t < nt) {  // block-uniform
        __syncthreads();  // the distance before this one is reduced
#pragma unroll
        for (int f = 0; f < N_STATS; ++f) cols[f * MOMENT_THREADS + threadIdx.x] = acc[t][f];
        __syncthreads();
        reduce_columns(cols, N_STATS, row + (j0 + t) * N_STATS);
      }
    }
  }
}

}  // namespace art

using namespace art;

extern "C" {

// Version of this C interface; ops/_cuda.py loads only its own. Version 7:
// K7 in a kernel and entry point of its own (art_launch_stats_primal: its
// pose in the chain record's maps, its detector in a DetectorP), and
// art_launch_stats_params takes K6 only. Version 6:
// the image kernel K1i (art_launch_fused_source_image, ImageP); the other
// entry points and records are version 5's. Version 5:
// the chain record carries grid defect maps after version 4's fields
// (ChainP grows from 2512 to 2744 bytes), and the library holds the gather
// probes P4/P5 (gather_probe.cu). Version 4: the chain record carries
// Zernike tables and ignore_defects (ChainP grows from 1720 to 2512 bytes;
// the entry points keep version 3's signatures).
// Version 3 gave K2 and K8 a grid sized to the rays with their own rays per
// block, and K8 one trace per ray for all its distances (rows (blocks, J,
// 7)); version 2 gave K5-K7 the sized grid and K6 all tangent rows of a
// gradient step; libraries without this entry point have version 1's
// signatures (utils/kernel_ab.py binds every older version for A/B runs).
int art_abi_version() { return 7; }

size_t art_chain_params_size() { return sizeof(ChainP); }
size_t art_source_params_size() { return sizeof(SourceP); }
size_t art_detector_params_size() { return sizeof(DetectorP); }
size_t art_image_params_size() { return sizeof(ImageP); }
// rays per block of K5 and K6, of K2, of K8 and of K1i (ops/fused_trace.ray_grid;
// K7's: fused_grad.cu)
int art_moment_rays_per_block() { return MOMENT_RAYS_PER_BLOCK; }
int art_source_moments_rays_per_block() { return K2_RAYS_PER_BLOCK; }
int art_source_stats_rays_per_block() { return K8_RAYS_PER_BLOCK; }
int art_source_image_rays_per_block() { return K1I_RAYS_PER_BLOCK; }
const char* art_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The records are host bytes laid out as the structs above (checked against
// sizeof by the caller); they are copied into the launch's parameter space.
int art_launch_fused_source_trace(const void* chain, const void* source, int n_rays, float phase,
                                  float k_frac, float* p, float* d, float* opl, float* opl_c,
                                  unsigned char* alive, float* inc, void* stream) {
  const ChainP ch = *static_cast<const ChainP*>(chain);
  const SourceP src = *static_cast<const SourceP*>(source);
  const int blocks = (n_rays + K1_THREADS - 1) / K1_THREADS;
  return with_defects(ch, [&](auto defects) {
    fused_source_trace_kernel<decltype(defects)::value>
        <<<blocks, K1_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            ch, src, n_rays, phase, k_frac, p, d, opl, opl_c, alive, inc);
    return (int)cudaGetLastError();
  });
}

// K2: chunk_params (n_chunks x 2) and rows (n_blocks x 16) are device
// pointers; the grid is n_blocks blocks, blocks_per_chunk for each full chunk
// (ops/fused_trace.ray_grid at art_source_moments_rays_per_block).
int art_launch_fused_source_moments(const void* chain, const void* source, const void* detector,
                                    int n_rays, int chunk, int blocks_per_chunk, int n_blocks,
                                    const float* chunk_params, double* rows, void* stream) {
  const ChainP ch = *static_cast<const ChainP*>(chain);
  const SourceP src = *static_cast<const SourceP*>(source);
  const DetectorP det = *static_cast<const DetectorP*>(detector);
  return with_defects(ch, [&](auto defects) {
    fused_source_moments_kernel<decltype(defects)::value>
        <<<n_blocks, MOMENT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            ch, src, det, n_rays, chunk, blocks_per_chunk,
            reinterpret_cast<const float2*>(chunk_params), rows);
    return (int)cudaGetLastError();
  });
}

// K1i: chunk_params (n_chunks x 2) and the two flat images (nx * ny doubles
// each, added into) are device pointers; the grid as K2's, at
// art_source_image_rays_per_block. rec_flat, rec_w, rec_delay (null: no
// record) hold rec_chunks x chunk entries, ray k of chunk rec_first + c at
// c * chunk + k.
int art_launch_fused_source_image(const void* chain, const void* source, const void* image,
                                  int n_rays, int chunk, int blocks_per_chunk, int n_blocks,
                                  const float* chunk_params, double* w_img, double* wd_img,
                                  int rec_first, int rec_chunks, int* rec_flat, float* rec_w,
                                  float* rec_delay, void* stream) {
  const ChainP ch = *static_cast<const ChainP*>(chain);
  const SourceP src = *static_cast<const SourceP*>(source);
  const ImageP im = *static_cast<const ImageP*>(image);
  return with_defects(ch, [&](auto defects) {
    fused_source_image_kernel<decltype(defects)::value>
        <<<n_blocks, MOMENT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            ch, src, im, n_rays, chunk, blocks_per_chunk,
            reinterpret_cast<const float2*>(chunk_params), w_img, wd_img, rec_first, rec_chunks,
            rec_flat, rec_w, rec_delay);
    return (int)cudaGetLastError();
  });
}

// K8: rows hold, per block, one row of n_dist x 7 doubles; chunk_params
// (n_chunks x 2) and dist_params (n_dist x 2: distance, delay offset) are
// device pointers; the grid as K2's, at art_source_stats_rays_per_block.
int art_launch_fused_source_stats(const void* chain, const void* source, const void* detector,
                                  int n_rays, int chunk, int blocks_per_chunk, int n_blocks,
                                  const float* chunk_params, const float* dist_params, int n_dist,
                                  double* rows, void* stream) {
  if (n_dist < 1 || n_dist > MAX_STATS_DISTANCES) return (int)cudaErrorInvalidValue;
  const ChainP ch = *static_cast<const ChainP*>(chain);
  const SourceP src = *static_cast<const SourceP*>(source);
  const DetectorP det = *static_cast<const DetectorP*>(detector);
  constexpr int smem = K8_SMEM_FLOATS * (int)sizeof(float);
  return with_defects(ch, [&](auto defects) {
    constexpr int D = decltype(defects)::value;
    const cudaError_t status = cudaFuncSetAttribute(
        fused_source_stats_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (status != cudaSuccess) return (int)status;
    fused_source_stats_kernel<D><<<n_blocks, MOMENT_THREADS, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
        ch, src, det, n_rays, chunk, blocks_per_chunk, n_dist,
        reinterpret_cast<const float2*>(chunk_params),
        reinterpret_cast<const float2*>(dist_params), rows);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
