// Forward-mode dual numbers for the gradient kernel K6 (fused_grad.cu).
//
// Dual<G> carries a float32 value and G directional derivatives. The device
// functions of trace_common.cuh are templated on their scalar type S, so K6
// runs the same arithmetic as K1-K5 (S = float) on Dual<G>: every branch and
// select decides on the value, and the tangent follows the chosen operand,
// which is what JAX's linearize of the Pallas kernel does (jvp of where).
//
// The scalar overload sets below (sqrt_, rsq, div_, fabs_, fmax_, fmin_,
// isfinite_, val, add_rn, sub_rn) take float and Dual alike (val gives the
// primal, which decides every branch and index: the grid lookup's cell), and every Dual
// form takes its value from the float form, so K6's primal is K7's bit for
// bit. The _rn forms round the value without contraction (Kahan step,
// delays) and take plain float arithmetic on the tangents.
//
// The special-function unit. An IEEE-rounded divide or square root is a
// sequence of 8-20 issued operations with a slow-path check; the ray arithmetic
// of trace_common.cuh takes its reciprocal square roots (rsq), the divides
// inside the chain walk (div_) and the square roots of its quadratic seeds
// (sqrt_) from the special-function unit instead (MUFU.RSQ, MUFU.RCP and a
// multiply, MUFU.SQRT: at most 2 ulp), as the JAX kernels take theirs from
// lax.rsqrt and a reciprocal of ~2-3 ulp (ops/surfaces._recip). Every one of
// them feeds a Newton-polished root, a unit normal or a validity test, where
// 2 ulp is far inside the kernel-vs-plain envelopes. The source law, the
// Kahan optical path and the detector epilogue's 1 / (d.n) (fs-scale delays
// hang on it) keep IEEE rounding: they use operator/ and sqrtf directly.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace art {

template <int G>
struct Dual {
  float v;
  float t[G];
  Dual() = default;
  __host__ __device__ __forceinline__ Dual(float x) : v(x) {
#pragma unroll
    for (int i = 0; i < G; ++i) t[i] = 0.0f;
  }
};

// whether a scalar type is a Dual<G> (K6's), for the few places where its
// order of evaluation differs from the float kernels'
template <typename S>
inline constexpr bool is_dual = false;
template <int G>
inline constexpr bool is_dual<Dual<G>> = true;

#define ART_DUAL template <int G> __device__ __forceinline__

ART_DUAL Dual<G> operator-(const Dual<G>& a) {
  Dual<G> r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < G; ++i) r.t[i] = -a.t[i];
  return r;
}

ART_DUAL Dual<G> operator+(const Dual<G>& a, const Dual<G>& b) {
  Dual<G> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < G; ++i) r.t[i] = a.t[i] + b.t[i];
  return r;
}
ART_DUAL Dual<G> operator+(const Dual<G>& a, float b) {
  Dual<G> r = a;
  r.v = a.v + b;
  return r;
}
ART_DUAL Dual<G> operator+(float a, const Dual<G>& b) { return b + a; }

ART_DUAL Dual<G> operator-(const Dual<G>& a, const Dual<G>& b) {
  Dual<G> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < G; ++i) r.t[i] = a.t[i] - b.t[i];
  return r;
}
ART_DUAL Dual<G> operator-(const Dual<G>& a, float b) {
  Dual<G> r = a;
  r.v = a.v - b;
  return r;
}
ART_DUAL Dual<G> operator-(float a, const Dual<G>& b) {
  Dual<G> r;
  r.v = a - b.v;
#pragma unroll
  for (int i = 0; i < G; ++i) r.t[i] = -b.t[i];
  return r;
}

ART_DUAL Dual<G> operator*(const Dual<G>& a, const Dual<G>& b) {
  Dual<G> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < G; ++i) r.t[i] = a.t[i] * b.v + a.v * b.t[i];
  return r;
}
ART_DUAL Dual<G> operator*(const Dual<G>& a, float b) {
  Dual<G> r;
  r.v = a.v * b;
#pragma unroll
  for (int i = 0; i < G; ++i) r.t[i] = a.t[i] * b;
  return r;
}
ART_DUAL Dual<G> operator*(float a, const Dual<G>& b) { return b * a; }

// The factors only the tangents use come from the reciprocal unit
// (tangent_rcp: MUFU.RCP, ~1 ulp) or from a product, never from an IEEE
// divide or square-root sequence: their error is far inside the tangents'
// envelope (2e-3 of each statistic's largest). 1 / +-inf is 0.
__device__ __forceinline__ float tangent_rcp(float b) { return __fdividef(1.0f, b); }

// a / b with the tangent (a' - q b') / b, q = a / b: a divisor selected to
// +-inf (a masked operand) gives q = 0 and a zero tangent, as in JAX
ART_DUAL Dual<G> operator/(const Dual<G>& a, const Dual<G>& b) {
  Dual<G> r;
  r.v = a.v / b.v;
  const float inv = tangent_rcp(b.v);
#pragma unroll
  for (int i = 0; i < G; ++i) r.t[i] = (a.t[i] - r.v * b.t[i]) * inv;
  return r;
}
ART_DUAL Dual<G> operator/(const Dual<G>& a, float b) {
  Dual<G> r;
  r.v = a.v / b;
  const float inv = tangent_rcp(b);
#pragma unroll
  for (int i = 0; i < G; ++i) r.t[i] = a.t[i] * inv;
  return r;
}
ART_DUAL Dual<G> operator/(float a, const Dual<G>& b) {
  Dual<G> r;
  r.v = a / b.v;
  const float inv = tangent_rcp(b.v);
#pragma unroll
  for (int i = 0; i < G; ++i) r.t[i] = -r.v * b.t[i] * inv;
  return r;
}

// comparisons decide on the value
#define ART_DUAL_CMP(op)                                                                   \
  ART_DUAL bool operator op(const Dual<G>& a, const Dual<G>& b) { return a.v op b.v; }     \
  ART_DUAL bool operator op(const Dual<G>& a, float b) { return a.v op b; }                \
  ART_DUAL bool operator op(float a, const Dual<G>& b) { return a op b.v; }
ART_DUAL_CMP(<)
ART_DUAL_CMP(>)
ART_DUAL_CMP(<=)
ART_DUAL_CMP(>=)
ART_DUAL_CMP(==)
ART_DUAL_CMP(!=)
#undef ART_DUAL_CMP

// --- scalar overload sets: float forms are the CUDA functions ------------

__device__ __forceinline__ float val(float x) { return x; }
ART_DUAL float val(const Dual<G>& x) { return x.v; }

// square root of a quadratic seed's discriminant (a Newton step follows it)
__device__ __forceinline__ float sqrt_(float x) {
  float y;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
ART_DUAL Dual<G> sqrt_(const Dual<G>& a) {
  Dual<G> r;
  r.v = sqrt_(a.v);
  const float h = 0.5f * tangent_rcp(r.v);
#pragma unroll
  for (int i = 0; i < G; ++i) r.t[i] = a.t[i] * h;
  return r;
}

__device__ __forceinline__ float rsq(float x) { return rsqrtf(x); }
ART_DUAL Dual<G> rsq(const Dual<G>& a) {
  Dual<G> r;
  r.v = rsq(a.v);
  const float h = -0.5f * r.v * r.v * r.v;  // d a^(-1/2) / da = -a^(-3/2) / 2
#pragma unroll
  for (int i = 0; i < G; ++i) r.t[i] = a.t[i] * h;
  return r;
}

// a / b inside the chain walk: a times the reciprocal unit's 1 / b. A divisor
// selected to +-inf (a masked operand) gives 0 and a zero tangent, as in JAX.
__device__ __forceinline__ float div_(float a, float b) { return __fdividef(a, b); }
ART_DUAL Dual<G> div_(const Dual<G>& a, const Dual<G>& b) {
  Dual<G> r;
  r.v = div_(a.v, b.v);
  const float inv = tangent_rcp(b.v);
#pragma unroll
  for (int i = 0; i < G; ++i) r.t[i] = (a.t[i] - r.v * b.t[i]) * inv;
  return r;
}
ART_DUAL Dual<G> div_(const Dual<G>& a, float b) {
  Dual<G> r;
  r.v = div_(a.v, b);
  const float inv = tangent_rcp(b);
#pragma unroll
  for (int i = 0; i < G; ++i) r.t[i] = a.t[i] * inv;
  return r;
}
ART_DUAL Dual<G> div_(float a, const Dual<G>& b) {
  Dual<G> r;
  r.v = div_(a, b.v);
  const float inv = tangent_rcp(b.v);
#pragma unroll
  for (int i = 0; i < G; ++i) r.t[i] = -r.v * b.t[i] * inv;
  return r;
}

__device__ __forceinline__ float fabs_(float x) { return fabsf(x); }
ART_DUAL Dual<G> fabs_(const Dual<G>& a) { return a.v < 0.0f ? -a : a; }

// fmaxf(x, c) against a constant: the constant (zero tangent) when it wins
__device__ __forceinline__ float fmax_(float x, float c) { return fmaxf(x, c); }
ART_DUAL Dual<G> fmax_(const Dual<G>& a, float c) { return a.v > c ? a : Dual<G>(c); }

__device__ __forceinline__ float fmin_(float a, float b) { return fminf(a, b); }
ART_DUAL Dual<G> fmin_(const Dual<G>& a, const Dual<G>& b) { return b.v < a.v ? b : a; }
// fminf(x, c) against a constant: the constant (zero tangent) when it wins
ART_DUAL Dual<G> fmin_(const Dual<G>& a, float c) { return a.v < c ? a : Dual<G>(c); }

__device__ __forceinline__ bool isfinite_(float x) { return isfinite(x); }
ART_DUAL bool isfinite_(const Dual<G>& a) { return isfinite(a.v); }

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
ART_DUAL Dual<G> add_rn(const Dual<G>& a, const Dual<G>& b) {
  Dual<G> r = a + b;
  r.v = __fadd_rn(a.v, b.v);
  return r;
}
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
ART_DUAL Dual<G> sub_rn(const Dual<G>& a, const Dual<G>& b) {
  Dual<G> r = a - b;
  r.v = __fsub_rn(a.v, b.v);
  return r;
}
ART_DUAL Dual<G> sub_rn(const Dual<G>& a, float b) {
  Dual<G> r = a;
  r.v = __fsub_rn(a.v, b);
  return r;
}

#undef ART_DUAL

}  // namespace art
