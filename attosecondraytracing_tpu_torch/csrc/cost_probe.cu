// Cost probes for Hopper (sm_90a), bound through a plain C interface
// (ctypes, utils/cost_probe.py).
//
// P1 add_one_kernel replaces the JAX package's bench.py::warmup_mosaic
//   add_one (pallas_call at :167): an (8, 128) float32 tile plus 1. The TPU
//   probe absorbed Mosaic's one-time warm-up; here it measures what the
//   first launch of a freshly loaded library costs and the steady launch
//   latency. Bound: 8 KB moved, launch latency is the whole of its time.
// P2 op_chain_kernel<OP> replaces scripts/diag_vpu_ops.py::make_kernel
//   (pallas_call at :37): n_ops dependent applications of one of the
//   script's nine OPS (:49-59) to each element of a float32 array. Each op is
//   written with round-to-nearest intrinsics, so nvcc contracts nothing: the
//   script's "fma" (v * 1.0000001 + 1e-7) is one fmaf, every other op rounds
//   as the script's jnp expression does; recip_approx (pl.reciprocal with
//   approx=True) is the approximate reciprocal rcp.approx. Bound: 8 B per
//   element of memory against n_ops operations per element; below the
//   card's ridge (about 20 float32 operations per byte) the memory floor
//   hides the ops, which is why the probe is timed at several n_ops. The
//   runtime loop is unrolled by 16 (one counter update and branch per 16
//   ops).
// P3 copy_streams_kernel replaces scripts/diag_kernel_cost.py::copy_kernel
//   (pallas_call at :97): the memory floor of the fresh-bundle trace K4. It
//   reads 6 float32 streams (px .. dz) and writes them back, writes 3 float32
//   zero streams (opl, opl_c, incidence) and an int8 ones stream (alive):
//   61 B per ray. Bound: those bytes; coalesced 4-byte loads and stores, one
//   element per thread.
#include <cuda_runtime.h>

namespace art {

constexpr int COST_THREADS = 256;

__global__ void __launch_bounds__(COST_THREADS)
add_one_kernel(const float* __restrict__ x, float* __restrict__ o, int n) {
  const int k = blockIdx.x * COST_THREADS + threadIdx.x;
  if (k < n) o[k] = __fadd_rn(x[k], 1.0f);
}

// the script's OPS, in its order
enum CostOp : int {
  OP_FMA = 0, OP_MUL, OP_DIV, OP_SQRT, OP_RSQRT, OP_RECIP, OP_RECIP_APPROX, OP_SELECT, OP_ABS_CMP,
  N_OPS
};

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

template <int OP>
__device__ __forceinline__ float apply_op(float v) {
  if constexpr (OP == OP_FMA) return fmaf(v, 1.0000001f, 1e-7f);
  if constexpr (OP == OP_MUL) return __fmul_rn(v, 1.0000001f);
  if constexpr (OP == OP_DIV) return __fdiv_rn(v, __fadd_rn(v, 1.0f));
  if constexpr (OP == OP_SQRT) return __fsqrt_rn(__fadd_rn(v, 1.0f));
  if constexpr (OP == OP_RSQRT) return rsqrtf(__fadd_rn(v, 1.0f));
  if constexpr (OP == OP_RECIP) return __frcp_rn(__fadd_rn(v, 1.0f));
  if constexpr (OP == OP_RECIP_APPROX) return rcp_approx(__fadd_rn(v, 1.0f));
  if constexpr (OP == OP_SELECT) return v > 0.5f ? __fmul_rn(v, 1.0000001f) : __fadd_rn(v, 1e-7f);
  if constexpr (OP == OP_ABS_CMP) return __fadd_rn(fabsf(v), v > 1.0f ? 1.0f : 0.0f);
  return v;
}

template <int OP>
__global__ void __launch_bounds__(COST_THREADS)
op_chain_kernel(const float* __restrict__ x, float* __restrict__ o, int n, int n_ops) {
  const int k = blockIdx.x * COST_THREADS + threadIdx.x;
  if (k >= n) return;
  float v = x[k];
#pragma unroll 16
  for (int i = 0; i < n_ops; ++i) v = apply_op<OP>(v);
  o[k] = v;
}

__global__ void __launch_bounds__(COST_THREADS)
copy_streams_kernel(const float* __restrict__ px, const float* __restrict__ py,
                    const float* __restrict__ pz, const float* __restrict__ dx,
                    const float* __restrict__ dy, const float* __restrict__ dz,
                    float* __restrict__ opx, float* __restrict__ opy, float* __restrict__ opz,
                    float* __restrict__ odx, float* __restrict__ ody, float* __restrict__ odz,
                    float* __restrict__ oopl, float* __restrict__ oopl_c,
                    signed char* __restrict__ oalive, float* __restrict__ oinc, int n) {
  const int k = blockIdx.x * COST_THREADS + threadIdx.x;
  if (k >= n) return;
  opx[k] = px[k];
  opy[k] = py[k];
  opz[k] = pz[k];
  odx[k] = dx[k];
  ody[k] = dy[k];
  odz[k] = dz[k];
  oopl[k] = 0.0f;
  oopl_c[k] = 0.0f;
  oinc[k] = 0.0f;
  oalive[k] = 1;
}

inline int cost_blocks(int n) { return (n + COST_THREADS - 1) / COST_THREADS; }

template <int OP>
cudaError_t launch_op_chain(const float* x, float* o, int n, int n_ops, cudaStream_t s) {
  op_chain_kernel<OP><<<cost_blocks(n), COST_THREADS, 0, s>>>(x, o, n, n_ops);
  return cudaGetLastError();
}

}  // namespace art

using namespace art;

extern "C" {

int art_cost_op_count() { return N_OPS; }

// every pointer is a device pointer
int art_launch_add_one(const float* x, float* o, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  add_one_kernel<<<cost_blocks(n), COST_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x, o, n);
  return (int)cudaGetLastError();
}

int art_launch_op_chain(int op, const float* x, float* o, int n, int n_ops, void* stream) {
  if (n < 1 || n_ops < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case OP_FMA: return (int)launch_op_chain<OP_FMA>(x, o, n, n_ops, s);
    case OP_MUL: return (int)launch_op_chain<OP_MUL>(x, o, n, n_ops, s);
    case OP_DIV: return (int)launch_op_chain<OP_DIV>(x, o, n, n_ops, s);
    case OP_SQRT: return (int)launch_op_chain<OP_SQRT>(x, o, n, n_ops, s);
    case OP_RSQRT: return (int)launch_op_chain<OP_RSQRT>(x, o, n, n_ops, s);
    case OP_RECIP: return (int)launch_op_chain<OP_RECIP>(x, o, n, n_ops, s);
    case OP_RECIP_APPROX: return (int)launch_op_chain<OP_RECIP_APPROX>(x, o, n, n_ops, s);
    case OP_SELECT: return (int)launch_op_chain<OP_SELECT>(x, o, n, n_ops, s);
    case OP_ABS_CMP: return (int)launch_op_chain<OP_ABS_CMP>(x, o, n, n_ops, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ins: px, py, pz, dx, dy, dz; outs: the six copies, opl, opl_c, alive
// (int8), incidence
int art_launch_copy_streams(const float* const* ins, void* const* outs, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  copy_streams_kernel<<<cost_blocks(n), COST_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      ins[0], ins[1], ins[2], ins[3], ins[4], ins[5], static_cast<float*>(outs[0]),
      static_cast<float*>(outs[1]), static_cast<float*>(outs[2]), static_cast<float*>(outs[3]),
      static_cast<float*>(outs[4]), static_cast<float*>(outs[5]), static_cast<float*>(outs[6]),
      static_cast<float*>(outs[7]), static_cast<signed char*>(outs[8]),
      static_cast<float*>(outs[9]), n);
  return (int)cudaGetLastError();
}

}  // extern "C"
