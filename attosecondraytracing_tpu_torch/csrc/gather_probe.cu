// Gather probes for Hopper (sm_90a), bound through a plain C interface
// (ctypes, utils/gather_probe.py).
//
// P4 gather_forms_kernel replaces the JAX package's
//   scripts/exp_mosaic_gather.py::run (pallas_call at :28), which asked
//   whether Mosaic lowers the per-lane gathers a grid defect's bilinear
//   lookup needs: four forms on a (n, n) float32 map at (8, 128) points
//   (x, y) in [0, 1), ix = clip(floor(x (n - 1)), 0, n - 2):
//   row_gather g[ix, 0]; gather_2d g[ix, iy]; flat_take flat[ix n + iy];
//   bilinear, the 4-corner form of the script's k_bilinear. On this card a
//   gather is a load at a computed address, so gather_2d and flat_take are
//   one and the same load: the probe's question becomes what a gather costs.
// P5 take_along_kernel replaces exp_mosaic_gather.py::probe_take_along's
//   try_one (pallas_call at :115): take_along_axis along axis 1 with index
//   (l * 7 + s) % ncols, along axis 0 with index (s * 13 + l) % nrows, at
//   row s, column l of the output (the operand's shape).
// Bound: each writes 4 B and reads at most 4 B per point from the map (P4
//   bilinear: four), all of it in L2 at the script's shapes; launch latency
//   is the whole of their time.
//
// grid_lookup_kernel is the trace's own lookup (grid_sums of
// trace_common.cuh, one template with the kernels'), over many points of a
// packed map: the cost of the grid branch's gather by point order and by map
// size (in L2 or in HBM), which the probes answer on this card. It writes
// h + dh/dx + dh/dy per point, so all three channels of the four corners stay
// live. Bound: 12 B per point of streams, plus the map's bytes or the
// sectors its gathers touch.
#include <cuda_runtime.h>

#include "trace_common.cuh"

namespace art {

constexpr int PROBE_THREADS = 256;
enum GatherForm : int { ROW_GATHER = 0, GATHER_2D = 1, FLAT_TAKE = 2, BILINEAR = 3 };

// the script's idx: clip(floor(a (n - 1)), 0, n - 2)
__device__ __forceinline__ int probe_index(float a, int n) {
  return min(max((int)floorf(a * (float)(n - 1)), 0), n - 2);
}

__global__ void __launch_bounds__(PROBE_THREADS)
gather_forms_kernel(int form, const float* __restrict__ g, int n, const float* __restrict__ x,
                    const float* __restrict__ y, float* __restrict__ o, int count) {
  const int k = blockIdx.x * PROBE_THREADS + threadIdx.x;
  if (k >= count) return;
  const int ix = probe_index(x[k], n), iy = probe_index(y[k], n);
  switch (form) {
    case ROW_GATHER:
      o[k] = __ldg(g + (size_t)ix * n);
      break;
    case GATHER_2D:
    case FLAT_TAKE:
      o[k] = __ldg(g + (size_t)ix * n + iy);
      break;
    default: {  // BILINEAR
      const float fx = x[k] * (float)(n - 1), fy = y[k] * (float)(n - 1);
      const float wx = fx - (float)ix, wy = fy - (float)iy;
      const float* r = g + (size_t)ix * n + iy;
      o[k] = __ldg(r) * (1.0f - wx) * (1.0f - wy) + __ldg(r + n) * wx * (1.0f - wy) +
             __ldg(r + 1) * (1.0f - wx) * wy + __ldg(r + n + 1) * wx * wy;
    }
  }
}

__global__ void __launch_bounds__(PROBE_THREADS)
take_along_kernel(const float* __restrict__ op, int rows, int cols, int axis,
                  float* __restrict__ o) {
  const int k = blockIdx.x * PROBE_THREADS + threadIdx.x;
  if (k >= rows * cols) return;
  const int s = k / cols, l = k - s * cols;
  o[k] = axis == 1 ? __ldg(op + s * cols + (l * 7 + s) % cols)
                   : __ldg(op + ((s * 13 + l) % rows) * cols + l);
}

__global__ void __launch_bounds__(PROBE_THREADS)
grid_lookup_kernel(const __grid_constant__ GridP g, const float* __restrict__ x,
                   const float* __restrict__ y, int count, float* __restrict__ o) {
  const int k = blockIdx.x * PROBE_THREADS + threadIdx.x;
  if (k >= count) return;
  float h, gx, gy;
  grid_sums<true>(g, x[k], y[k], h, gx, gy);
  o[k] = h + gx + gy;
}

inline int probe_blocks(int count) { return (count + PROBE_THREADS - 1) / PROBE_THREADS; }

}  // namespace art

using namespace art;

extern "C" {

size_t art_grid_params_size() { return sizeof(GridP); }

// every pointer but grid is a device pointer; grid is a host GridP record
// (size checked by the caller) whose rows pointer is a device pointer
int art_launch_gather_forms(int form, const float* g, int n, const float* x, const float* y,
                            float* o, int count, void* stream) {
  if (form < ROW_GATHER || form > BILINEAR || n < 2 || count < 1) return (int)cudaErrorInvalidValue;
  gather_forms_kernel<<<probe_blocks(count), PROBE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      form, g, n, x, y, o, count);
  return (int)cudaGetLastError();
}

int art_launch_take_along(const float* op, int rows, int cols, int axis, float* o, void* stream) {
  if ((axis != 0 && axis != 1) || rows < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  take_along_kernel<<<probe_blocks(rows * cols), PROBE_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(op, rows, cols, axis, o);
  return (int)cudaGetLastError();
}

int art_launch_grid_lookup(const void* grid, const float* x, const float* y, int count, float* o,
                           void* stream) {
  if (count < 1) return (int)cudaErrorInvalidValue;
  const GridP g = *static_cast<const GridP*>(grid);
  grid_lookup_kernel<<<probe_blocks(count), PROBE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      g, x, y, count, o);
  return (int)cudaGetLastError();
}

}  // extern "C"
