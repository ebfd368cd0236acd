// Device functions shared by the kernels K1, K1i, K2 and K8 (fused_trace.cu), K5
// (fused_scan.cu), K3 and K4 (streamed_trace.cu), K6 and K7 (fused_grad.cu).
//
// They are the per-ray arithmetic of the JAX package's ops/trace.py
// (chained_step, premask_alive), ops/surfaces.py (the float32 branches of
// intersect_with_normal_c), ops/supports.py (include) and
// ops/pallas_trace.py (stats_rows), and of the plain PyTorch versions in
// ops/trace.py, ops/surfaces.py and ops/fused_trace.py of this package.
//
// The chain is a table of records (ChainP) walked by a runtime loop with a
// switch on the element kind; every thread of a warp runs the same element,
// so the switch costs no divergence, and a new chain costs no rebuild.
// Every constant in the records was formed in float64 on the host and
// rounded to float32 once (ops/fused_trace.py: chain_table, pack_chain);
// the struct layouts below are mirrored there as numpy dtypes and checked
// against sizeof at load time.
//
// The ray arithmetic is templated on its scalar type S: float for K1-K5, K7
// and K8, Dual<G> (dual.cuh) for K6, which carries G tangents through the
// same code. Predicates (hits, supports, the alive mask, the minimum ray
// parameter) decide on values only.
//
// Surface defects (ops/trace.chained_step's defect branch). A mirror with
// Zernike defects has a table in the chain record (ZernikeP: coefficients,
// 1 / radius; ChainP::zk_of names it); a mirror with grid defect maps has a
// range of grid records (GridP: the device pointer of its maps packed as
// float32 rows, origin, spacing, clamp bounds; ChainP::grid_begin/grid_end).
// Every kernel runs the branch once per deformed mirror, on S: the base
// hit, the height error h at the hit (the Andersen recurrence, zernike_sums,
// plus each grid's bilinear lookup, grid_sums), the hit shifted along the
// ray by h / max(-u.n0, 1e-6), the base surface's normal there
// (surface_normal, ops/surfaces.normal_c), and unless ignore_defects the
// defect slopes composed into it. Each kernel is instantiated three times,
// on the template parameter DEFECTS (NO_DEFECTS, ZERNIKE_TABLES, GRID_MAPS),
// and the launch takes the instantiation the record asks for (with_defects):
// a chain without defects runs the code it ran before grid maps came, and a
// chain with Zernike tables only runs the Zernike branch as it was
// (zernike_hit); only a chain with grid maps takes the branch that reads
// them (deformed_hit), whose extra live state would otherwise cost every
// Zernike chain's registers. Both hit functions read the defects through
// zernike_height / zernike_slopes / grid_height / grid_slopes; K6 (Dual<G>)
// takes their overloads that sum the defects on the primal and compose the
// tangents at the hit, which the float kernels never reach.
//
// Rounding notes. Compiled without --use_fast_math: operator/ and sqrtf are
// IEEE-rounded, and the source law and the detector epilogues use them. The
// chain walk takes its reciprocal square roots, divides and seed square
// roots from the special-function unit (rsq, div_, sqrt_ of dual.cuh, <= 2
// ulp): an IEEE sequence costs 8-20 issue slots, and these kernels are
// bound by the slots they take per ray. Products and sums may
// contract to FMA, which moves hits by ulps (inside the kernel-vs-plain
// envelopes). The two places where contraction would change the algorithm
// are written with _rn intrinsics, which are never contracted: the Kahan OPL
// step and the source law (so ray k leaves the source exactly as in the
// plain version and the JAX package).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

#include "dual.cuh"

namespace art {

constexpr int MAX_ELEMENTS = 8;
constexpr int MAX_PREMASKS = 8;
// Zernike tables per chain (one per deformed mirror) and their highest order
constexpr int MAX_ZERNIKE = 4;
constexpr int MAX_ZERNIKE_ORDER = 8;
constexpr int N_ZERNIKE_TERMS = (MAX_ZERNIKE_ORDER + 1) * (MAX_ZERNIKE_ORDER + 2) / 2;
// grid defect maps per chain
constexpr int MAX_GRIDS = 4;
constexpr float T_EPS = 1e-9f;

enum ElementKind : int {
  ELEM_MASK = 0, ELEM_PLANE = 1, ELEM_TOROID = 2,
  ELEM_PARABOLA = 3, ELEM_SPHERE = 4, ELEM_CYLINDER = 5, ELEM_ELLIPSOID = 6
};
enum SupportKind : int {
  SUP_ROUND = 0, SUP_ROUND_HOLE = 1, SUP_RECT = 2, SUP_RECT_HOLE = 3, SUP_RECT_RECT_HOLE = 4
};
enum SourceKind : int { SRC_CONE = 0, SRC_DISK = 1, SRC_EXTENDED = 2, SRC_SQUARE = 3 };

// p[]: Round {r^2}; RoundHole {R^2, rh^2, cx, cy}; Rect {|dx|/2, |dy|/2};
// RectHole {|dx|/2, |dy|/2, rh^2, cx, cy}; RectRectHole {|dx|/2, |dy|/2, |hx|/2, |hy|/2, cx, cy}
struct SupportP { int kind; float p[6]; };

// a folded mask: support test in the frame reached by (M, b) from the incoming state
struct PremaskP { SupportP sup; float M[9]; float b[3]; };

// s[]: Plane {}; Toroid {R, r, R+r, 0.5/(R+r), 0.5/r, hit_tol};
// quadrics {k0, k1, k2, k3, support offset x, hit_tol} with k = Parabola
// {p, 2p, p^2}, Sphere and Cylinder {R, R^2, -1/R}, Ellipsoid {1/a^2, 1/b^2, a^2, b^2}
struct ElementP {
  int kind;
  int pre_begin, pre_end;  // premasks [pre_begin, pre_end) of ChainP::pre
  float M[9];              // incoming patch-relative frame -> surface frame
  float b[3];
  float cen[3];            // support centre on the surface (mirrors)
  float s[8];
  SupportP sup;
};

// one mirror's Zernike defects: the coefficient of (n, m), 0 <= m <= n, at
// c[n (n + 1) / 2 + m] (several defects of one radius summed on the host)
struct ZernikeP {
  int max_order;  // highest n with a coefficient, >= 2
  float inv_r;    // 1 / the radius that normalizes the support coordinates
  float c[N_ZERNIKE_TERMS];
};

// one grid defect map (ops/defects._bilinear_multi): its height and slope
// maps packed as float32 rows {h, dh/dx, dh/dy, 0} in device memory, node
// (ix, iy) at row ix * ny + iy (ops/fused_trace.grid_rows); origin and
// spacing rounded to float32 as the plain version rounds them, and the
// clamp bounds of the fractional index, nx - 1.000001 and ny - 1.000001
// rounded to float32 on the host
struct GridP {
  const float4* rows;
  int nx, ny;
  float x0, y0, dx, dy;
  float fx_max, fy_max;
};

struct ChainP {
  int n_elements;
  int n_premasks;
  ElementP el[MAX_ELEMENTS];
  PremaskP pre[MAX_PREMASKS];
  float RK[9];  // last element's lab->optic rotation; p_lab = RK^T x + posK
  float posK[3];
  int ignore_defects;         // reflect deformed mirrors off their base normal
  int n_zernike;
  int zk_of[MAX_ELEMENTS];    // element i's Zernike table, or -1
  ZernikeP zk[MAX_ZERNIKE];
  // C interface version 5 (a version-4 library reads the fields above)
  int n_grids;
  int grid_begin[MAX_ELEMENTS];  // element i's grid maps: grid[grid_begin[i] .. grid_end[i])
  int grid_end[MAX_ELEMENTS];
  GridP grid[MAX_GRIDS];
};

// the kernels' instantiations on their DEFECTS parameter
enum DefectBranch : int { NO_DEFECTS = 0, ZERNIKE_TABLES = 1, GRID_MAPS = 2 };

// f(std::integral_constant<int, B>{}) with B the chain's DefectBranch: a
// launch picks its kernel's DEFECTS instantiation
template <typename F>
inline int with_defects(const ChainP& ch, F&& f) {
  if (ch.n_grids > 0) return f(std::integral_constant<int, GRID_MAPS>{});
  if (ch.n_zernike > 0) return f(std::integral_constant<int, ZERNIKE_TABLES>{});
  return f(std::integral_constant<int, NO_DEFECTS>{});
}

struct SourceP {
  int kind;
  float radius;       // tan(divergence): cone, extended; beam radius [mm]: disk; side [mm]: square
  float inv_n_total;  // radius law: 1 / total ray count (cone, disk), 1 / sub-sources (extended)
  float rad2;         // Gaussian law denominator: radius^2 (square: radius^2 / 2)
  float ln_edge;      // log of the Gaussian edge fraction
  int weighted;
  float g[3];         // frac(phi * 256^i), i = 0, 1, 2
  int n_each;         // rays per sub-source (extended), grid side (square)
  float inv_n_each;   // 1 / n_each (extended), 1 / (n_each - 1) (square)
  float pos_radius;   // sub-source disk radius [mm] (extended)
};

// detector plane in the last element's patch-relative frame
struct DetectorP {
  float c[3], n[3], e1[3], e2[3];
  float opl_ref;
  float inv_dn_chief;
  float centre_distance;
};

template <typename S>
struct RayT {
  S px, py, pz, dx, dy, dz;
  S opl, opl_c;
  float inc;
  bool alive;
};
using Ray = RayT<float>;

// a source ray (float) as a ray of scalar type S (zero tangents: the source
// does not depend on the poses)
template <typename S>
__device__ __forceinline__ RayT<S> lift(const Ray& r) {
  RayT<S> s;
  s.px = r.px; s.py = r.py; s.pz = r.pz;
  s.dx = r.dx; s.dy = r.dy; s.dz = r.dz;
  s.opl = r.opl; s.opl_c = r.opl_c;
  s.inc = r.inc;
  s.alive = r.alive;
  return s;
}

template <typename S>
__device__ __forceinline__ void kahan_add(S& s, S& c, S x) {
  const S y = sub_rn(x, c);
  const S t = add_rn(s, y);
  c = sub_rn(sub_rn(t, s), y);
  s = t;
}

// ---------------------------------------------------------------------------
// the summing kernels' blocks (K2, K5-K8): rays per block, the ray loop, the
// block reduction
// ---------------------------------------------------------------------------

constexpr int MOMENT_THREADS = 256;
// rays per thread of the runtime-pose kernels K5-K7
constexpr int MOMENT_RAYS_PER_THREAD = 8;
constexpr int MOMENT_RAYS_PER_BLOCK = MOMENT_THREADS * MOMENT_RAYS_PER_THREAD;

// A grid sized to the rays: blocks_per_chunk blocks for every full chunk and
// only as many as the last chunk's rays fill, so no block starts empty.
// Block b serves chunk b / blocks_per_chunk; this thread's first local ray
// follows (ops/fused_trace.ray_grid sizes the grid).
struct BlockRays {
  int chunk;
  int first;
};
template <int RAYS_PER_BLOCK>
__device__ __forceinline__ BlockRays block_rays(int blocks_per_chunk) {
  const int b = blockIdx.x;
  const int c = b / blocks_per_chunk;
  return {c, (b - c * blocks_per_chunk) * RAYS_PER_BLOCK + (int)threadIdx.x};
}

// This thread's rays of its block: body(k, in_range) for the local rays k =
// first + r * MOMENT_THREADS, r < RAYS_PER_THREAD. The loop is warp-uniform:
// a warp's lanes hold consecutive rays and leave together once the warp's
// first ray is past the chunk's n_local rays, so full-mask votes and shuffles
// are safe inside body; a lane past the end runs body with in_range false
// (its ray enters the chain dead).
template <int RAYS_PER_THREAD, typename Body>
__device__ __forceinline__ void for_thread_rays(int first, int n_local, Body&& body) {
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < RAYS_PER_THREAD; ++r) {
    const int k = first + r * MOMENT_THREADS;
    if (k - lane >= n_local) break;
    body(k, k < n_local);
  }
}

// Block reduction of n_cols columns of per-thread float32 sums (cols: n_cols
// x MOMENT_THREADS floats of shared memory, thread t's sum m at cols[m *
// MOMENT_THREADS + t], written and __syncthreads()-ed by the caller) to one
// row of float64. Each warp takes columns; each lane adds its 8 of a
// column's 256 entries in float64, then one 5-step shuffle per column and
// warp: the shuffles (64-bit: two shuffles each, one warp shuffle per
// clock and SM) cost per block and column, not per thread and column. A
// fixed order and no atomics, so the result is deterministic.
__device__ __forceinline__ void reduce_columns(const float* cols, int n_cols,
                                               double* __restrict__ row) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int m = warp; m < n_cols; m += MOMENT_THREADS / 32) {
    const float* col = cols + m * MOMENT_THREADS + lane;
    double v = 0.0;
#pragma unroll
    for (int i = 0; i < MOMENT_THREADS / 32; ++i) v += (double)col[32 * i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) row[m] = v;
  }
}

// the same for N sums a thread holds in registers
template <int N>
__device__ __forceinline__ void reduce_to_row(const float* acc, double* __restrict__ row) {
  __shared__ float cols[N * MOMENT_THREADS];
#pragma unroll
  for (int m = 0; m < N; ++m) cols[m * MOMENT_THREADS + threadIdx.x] = acc[m];
  __syncthreads();
  reduce_columns(cols, N, row);
}

__device__ __forceinline__ bool in_disk(float r2, float x, float y) { return x * x + y * y <= r2; }

__device__ __forceinline__ bool in_rect(float hx, float hy, float x, float y) {
  return fabsf(x) <= hx && fabsf(y) <= hy;
}

__device__ __forceinline__ bool include(const SupportP& s, float x, float y) {
  switch (s.kind) {
    case SUP_ROUND:
      return in_disk(s.p[0], x, y);
    case SUP_ROUND_HOLE:
      return in_disk(s.p[0], x, y) && !in_disk(s.p[1], x - s.p[2], y - s.p[3]);
    case SUP_RECT:
      return in_rect(s.p[0], s.p[1], x, y);
    case SUP_RECT_HOLE:
      return in_rect(s.p[0], s.p[1], x, y) && !in_disk(s.p[2], x - s.p[3], y - s.p[4]);
    case SUP_RECT_RECT_HOLE:
      return in_rect(s.p[0], s.p[1], x, y) && !in_rect(s.p[2], s.p[3], x - s.p[4], y - s.p[5]);
  }
  return false;
}

// (M, b) of type MT (float: a record's map; S: a runtime pose) applied to a
// ray of scalar type S
template <typename MT, typename S>
__device__ __forceinline__ void affine(const MT* M, const MT* b, const RayT<S>& s,
                                       S& qx, S& qy, S& qz, S& ux, S& uy, S& uz) {
  qx = M[0] * s.px + M[1] * s.py + M[2] * s.pz + b[0];
  qy = M[3] * s.px + M[4] * s.py + M[5] * s.pz + b[1];
  qz = M[6] * s.px + M[7] * s.py + M[8] * s.pz + b[2];
  ux = M[0] * s.dx + M[1] * s.dy + M[2] * s.dz;
  uy = M[3] * s.dx + M[4] * s.dy + M[5] * s.dz;
  uz = M[6] * s.dx + M[7] * s.dy + M[8] * s.dz;
}

template <typename S>
__device__ __forceinline__ S plane_t(S qz, S uz) {
  return div_(-qz, fabs_(uz) > 1e-30f ? uz : S(CUDART_INF_F));
}

// ---------------------------------------------------------------------------
// surfaces (float32 branches of ops/surfaces.py)
// ---------------------------------------------------------------------------

template <typename S>
struct HitT {
  S t, x, y, z, nx, ny, nz;
  bool hit;
};

template <typename S>
__device__ __forceinline__ HitT<S> plane_hit(const ElementP& el, S qx, S qy, S qz,
                                             S ux, S uy, S uz, float t_eps) {
  HitT<S> h;
  // intersect_c(Plane) returns t unmasked; the hit point follows from it
  h.t = plane_t(qz, uz);
  h.x = qx + h.t * ux;
  h.y = qy + h.t * uy;
  h.z = qz + h.t * uz;
  h.hit = (h.t > t_eps) && include(el.sup, val(h.x), val(h.y));
  h.nx = S(0.0f);
  h.ny = S(0.0f);
  h.nz = S(1.0f);
  return h;
}

template <typename S>
__device__ __forceinline__ void toroid_residual(float R, float r, S x, S y, S z,
                                                S ux, S uy, S uz, S& g, S& gp) {
  const S rho2 = x * x + z * z;
  const S inv_rho = rsq(fmax_(rho2, 1e-30f));
  const S w = rho2 * inv_rho - R;
  const S s2 = w * w + y * y;
  const S inv_s = rsq(fmax_(s2, 1e-30f));
  g = s2 * inv_s - r;
  const S drho = (x * ux + z * uz) * inv_rho;
  gp = (w * drho + y * uy) * inv_s;
}

// _toroid_fast_root + the fused normal of intersect_with_normal_c
template <typename S>
__device__ __forceinline__ HitT<S> toroid_hit(const ElementP& el, S qx, S qy, S qz,
                                              S ux, S uy, S uz, float t_eps) {
  const float R = el.s[0], r = el.s[1], RpR = el.s[2], i2A = el.s[3], i2B = el.s[4], tol = el.s[5];
  // osculating-paraboloid seed, nearer valid crossing picked in n/d form
  const S a = -(ux * ux * i2A + uy * uy * i2B);
  const S b = uz - 2.0f * (qx * ux * i2A + qy * uy * i2B);
  const S c = qz + RpR - (qx * qx * i2A + qy * qy * i2B);
  const S disc = b * b - 4.0f * a * c;
  const bool ok = disc >= 0.0f;
  const S sq = ok ? sqrt_(disc) : S(0.0f);
  const S qq = (b == 0.0f) ? -0.5f * sq : -0.5f * (b + (b > 0.0f ? sq : -sq));
  const S n1 = qq, d1 = a, n2 = c, d2 = qq;
  const bool v1 = ((n1 - t_eps * d1) * d1 > 0.0f) && (d1 * (qz * d1 + n1 * uz) < 0.0f);
  const bool v2 = ((n2 - t_eps * d2) * d2 > 0.0f) && (d2 * (qz * d2 + n2 * uz) < 0.0f);
  const bool t1_nearer = (n1 * d2 - n2 * d1) * (d1 * d2) <= 0.0f;
  const bool pick1 = !v2 || (v1 && t1_nearer);
  const S num = pick1 ? n1 : n2;
  const S den = pick1 ? d1 : d2;
  S t = ok ? (den != 0.0f ? div_(num, den) : S(0.0f)) : S(-1.0f);
  // one Newton correction (the seed converges in one), differentiated
  // through the step, as JAX differentiates the kernel
  {
    S g, gp;
    toroid_residual(R, r, qx + t * ux, qy + t * uy, qz + t * uz, ux, uy, uz, g, gp);
    t = t - g * (fabs_(gp) > 1e-12f ? div_(1.0f, gp) : S(0.0f));
  }
  // one shared evaluation: validity residual, hit point, normal
  HitT<S> h;
  h.x = qx + t * ux;
  h.y = qy + t * uy;
  h.z = qz + t * uz;
  const S rho2 = h.x * h.x + h.z * h.z;
  const S inv_rho = rsq(fmax_(rho2, 1e-30f));
  const S w = rho2 * inv_rho - R;
  const S s2 = w * w + h.y * h.y;
  const S inv_s = rsq(fmax_(s2, 1e-30f));
  const float g_abs = fabsf(val(s2 * inv_s - r));
  const S an = w * inv_rho * inv_s;
  h.nx = -an * h.x;
  h.ny = -h.y * inv_s;
  h.nz = -an * h.z;
  h.hit = (t > t_eps) && (g_abs < tol) && (h.z < -R) && include(el.sup, val(h.x), val(h.y));
  h.t = h.hit ? t : S(0.0f);
  return h;
}

// The quadric surfaces (paraboloid, sphere, cylinder, ellipsoid) share the
// generic path of intersect_c: closed-form quadratic seeds, 3 Newton steps on
// a distance-like residual per candidate, the nearest valid root, and the
// normal at the root (normal_at_root_c).

// a t^2 + b t + c of the ray against the surface (ops/surfaces._quadratic_coeffs)
template <typename S>
__device__ __forceinline__ void quadric_coeffs(const ElementP& el, S x, S y, S z,
                                               S ux, S uy, S uz, S& a, S& b, S& c) {
  const float* k = el.s;
  switch (el.kind) {
    case ELEM_PARABOLA:  // {p, 2p, p^2}
      a = ux * ux + uy * uy;
      b = 2.0f * (ux * x + uy * y) - k[1] * uz;
      c = x * x + y * y - k[1] * z;
      break;
    case ELEM_SPHERE:  // {R, R^2, -1/R}
      a = S(1.0f);
      b = 2.0f * (ux * x + uy * y + uz * z);
      c = x * x + y * y + z * z - k[1];
      break;
    case ELEM_CYLINDER:  // {R, R^2, -1/R}
      a = uy * uy + uz * uz;
      b = 2.0f * (uy * y + uz * z);
      c = y * y + z * z - k[1];
      break;
    default:  // ELEM_ELLIPSOID {1/a^2, 1/b^2, a^2, b^2}
      a = div_(uy * uy + uz * uz, k[3]) + div_(ux * ux, k[2]);
      b = 2.0f * (div_(uy * y + uz * z, k[3]) + div_(ux * x, k[2]));
      c = div_(y * y + z * z, k[3]) + div_(x * x, k[2]) - 1.0f;
      break;
  }
}

// distance-like residual g and dg/dt (ops/surfaces._residual_c)
template <typename S>
__device__ __forceinline__ void quadric_residual(const ElementP& el, S x, S y, S z,
                                                 S ux, S uy, S uz, S& g, S& gp) {
  const float* k = el.s;
  switch (el.kind) {
    case ELEM_PARABOLA: {
      const S h = z - div_(x * x + y * y, k[1]);
      const S hp = uz - div_(x * ux + y * uy, k[0]);
      const S scale = k[0] * rsq(x * x + y * y + k[2]);
      g = h * scale;
      gp = hp * scale;
      break;
    }
    case ELEM_SPHERE: {
      const S rr = x * x + y * y + z * z;
      const S inv_r = rsq(fmax_(rr, 1e-30f));
      g = rr * inv_r - k[0];
      gp = (x * ux + y * uy + z * uz) * inv_r;
      break;
    }
    case ELEM_CYLINDER: {
      const S rr = y * y + z * z;
      const S inv_r = rsq(fmax_(rr, 1e-30f));
      g = rr * inv_r - k[0];
      gp = (y * uy + z * uz) * inv_r;
      break;
    }
    default: {  // ELEM_ELLIPSOID
      const S f = x * x * k[0] + (y * y + z * z) * k[1] - 1.0f;
      const S fp = 2.0f * (x * ux * k[0] + (y * uy + z * uz) * k[1]);
      const S ex = x * k[0], ey = y * k[1], ez = z * k[1];
      const S scale = 0.5f * rsq(fmax_(ex * ex + ey * ey + ez * ez, 1e-30f));
      g = f * scale;
      gp = fp * scale;
      break;
    }
  }
}

// unit 'up' normal at a root (ops/surfaces.normal_at_root_c / normal_c)
template <typename S>
__device__ __forceinline__ void quadric_normal(const ElementP& el, HitT<S>& h) {
  const float* k = el.s;
  S nx, ny, nz;
  switch (el.kind) {
    case ELEM_SPHERE:
      h.nx = h.x * k[2];
      h.ny = h.y * k[2];
      h.nz = h.z * k[2];
      return;
    case ELEM_CYLINDER:
      h.nx = S(0.0f);
      h.ny = h.y * k[2];
      h.nz = h.z * k[2];
      return;
    case ELEM_PARABOLA:
      nx = -h.x;
      ny = -h.y;
      nz = S(k[0]);
      break;
    default:  // ELEM_ELLIPSOID
      nx = -h.x * k[0];
      ny = -h.y * k[1];
      nz = -h.z * k[1];
      break;
  }
  const S inv = rsq(nx * nx + ny * ny + nz * nz);
  h.nx = nx * inv;
  h.ny = ny * inv;
  h.nz = nz * inv;
}

// citardauq quadratic roots; invalid roots are NaN (ops/surfaces._solve_quadratic)
template <typename S>
__device__ __forceinline__ void solve_quadratic(S a, S b, S c, S& t1, S& t2) {
  const S disc = b * b - 4.0f * a * c;
  const bool ok = disc >= 0.0f;
  const S sq = ok ? sqrt_(disc) : S(0.0f);
  S qq = -0.5f * (b + (b > 0.0f ? sq : (b < 0.0f ? -sq : S(0.0f))));
  if (b == 0.0f) qq = -0.5f * sq;
  const float tiny = 1e-30f;
  const bool linear = fabs_(a) < tiny;
  const S num1 = linear ? -c : qq;
  const S den1 = linear ? (fabs_(b) > tiny ? b : S(CUDART_INF_F))
                        : (fabs_(a) > tiny ? a : S(CUDART_INF_F));
  t1 = div_(num1, den1);
  t2 = linear ? S(CUDART_INF_F) : div_(c, fabs_(qq) > tiny ? qq : S(CUDART_INF_F));
  if (!ok) {
    t1 = S(CUDART_NAN_F);
    t2 = S(CUDART_NAN_F);
  }
}

// s[4] = support offset x, s[5] = hit tolerance for every quadric
template <typename S>
__device__ __forceinline__ HitT<S> quadric_hit(const ElementP& el, S qx, S qy, S qz,
                                               S ux, S uy, S uz, float t_eps) {
  const float ox = el.s[4], tol = el.s[5];
  S a, b, c;
  quadric_coeffs(el, qx, qy, qz, ux, uy, uz, a, b, c);
  S cand[2];
  solve_quadratic(a, b, c, cand[0], cand[1]);
  S t_best = S(CUDART_INF_F);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    S t = isfinite_(cand[k]) ? cand[k] : S(-1.0f);
    float g_abs = 0.0f;
#pragma unroll
    for (int it = 0; it < 3; ++it) {
      S g, gp;
      quadric_residual(el, qx + t * ux, qy + t * uy, qz + t * uz, ux, uy, uz, g, gp);
      g_abs = fabsf(val(g));
      t = t - div_(g, fabs_(gp) > 1e-12f ? gp : S(CUDART_INF_F));
    }
    const S x = qx + t * ux, y = qy + t * uy, z = qz + t * uz;
    // branch filter: the paraboloid takes every root, the others z < 0
    const bool branch = el.kind == ELEM_PARABOLA || z < 0.0f;
    const bool valid = (t > t_eps) && (g_abs < tol) && branch && include(el.sup, val(x - ox), val(y));
    t_best = fmin_(t_best, valid ? t : S(CUDART_INF_F));
  }
  HitT<S> h;
  h.hit = isfinite_(t_best);
  h.t = h.hit ? t_best : S(0.0f);
  h.x = qx + h.t * ux;
  h.y = qy + h.t * uy;
  h.z = qz + h.t * uz;
  quadric_normal(el, h);
  return h;
}

// ---------------------------------------------------------------------------
// surface defects (ops/trace._deformed_hit, _defect_normal; ops/defects.py)
// ---------------------------------------------------------------------------

// unit 'up' normal at any point (ops/surfaces.normal_c); unlike the hit
// functions' normals it does not assume the point is on the surface
template <typename S>
__device__ __forceinline__ void surface_normal(const ElementP& el, S x, S y, S z,
                                               S& nx, S& ny, S& nz) {
  const float* k = el.s;
  switch (el.kind) {
    case ELEM_PLANE:
      nx = S(0.0f);
      ny = S(0.0f);
      nz = S(1.0f);
      return;
    case ELEM_TOROID: {  // {R, r, ...}: -grad of (rho - R)^2 + y^2
      const S w = 1.0f - k[0] * rsq(fmax_(x * x + z * z, 1e-30f));
      nx = -w * x;
      ny = -y;
      nz = -w * z;
      break;
    }
    case ELEM_SPHERE:
      nx = -x;
      ny = -y;
      nz = -z;
      break;
    case ELEM_CYLINDER:
      nx = S(0.0f);
      ny = -y;
      nz = -z;
      break;
    case ELEM_PARABOLA:  // {p, ...}
      nx = -x;
      ny = -y;
      nz = S(k[0]);
      break;
    default:  // ELEM_ELLIPSOID {1/a^2, 1/b^2, ...}
      nx = -x * k[0];
      ny = -y * k[1];
      nz = -z * k[1];
      break;
  }
  const S inv = rsq(nx * nx + ny * ny + nz * nz);
  nx = nx * inv;
  ny = ny * inv;
  nz = nz * inv;
}

// The Zernike sums of a table at unit-disk coordinates (x, y): h = sum c Z
// and, with SLOPES, gx = sum c dZ/dx, gy = sum c dZ/dy, by the recurrence of
// ops/zernike.py (the JAX package's, Andersen 2018) row by row: row n reads
// rows n - 1 and n - 2 only, so only those stay live, and the sums grow as
// each term is formed. Unrolled to MAX_ZERNIKE_ORDER (every index is then a
// constant and the rows live in registers); the loop leaves at the table's
// order, the same for every ray of a launch.
template <bool SLOPES, typename S>
__device__ __forceinline__ void zernike_sums(const ZernikeP& zk, S x, S y, S& h, S& gx, S& gy) {
  constexpr int W = MAX_ZERNIKE_ORDER + 1;
  const float* c = zk.c;
  S z1[W], z2[W], dx1[W], dx2[W], dy1[W], dy2[W];  // rows n - 1 and n - 2
  z2[0] = S(1.0f);
  z1[0] = y;
  z1[1] = x;
  h = c[0] + c[1] * y + c[2] * x;
  if constexpr (SLOPES) {
    dx2[0] = S(0.0f);
    dy2[0] = S(0.0f);
    dx1[0] = S(0.0f);
    dx1[1] = S(1.0f);
    dy1[0] = S(1.0f);
    dy1[1] = S(0.0f);
    gx = S(c[2]);
    gy = S(c[1]);
  }
#pragma unroll
  for (int n = 2; n <= MAX_ZERNIKE_ORDER; ++n) {
    if (n > zk.max_order) break;
    const float fn = (float)n;
    S zn[W], dxn[W], dyn[W];
#pragma unroll
    for (int m = 0; m <= n; ++m) {
      if (m == 0) {
        zn[0] = x * z1[0] + y * z1[n - 1];
        dxn[0] = fn * z1[0];
        dyn[0] = fn * z1[n - 1];
      } else if (m == n) {
        zn[n] = x * z1[n - 1] - y * z1[0];
        dxn[n] = fn * z1[n - 1];
        dyn[n] = -fn * z1[0];
      } else if (n % 2 != 0 && m == (n - 1) / 2) {
        zn[m] = y * z1[n - 1 - m] + x * z1[m - 1] - y * z1[n - m] - z2[m - 1];
        dxn[m] = fn * z1[m - 1] + dx2[m - 1];
        dyn[m] = fn * z1[n - 1 - m] - fn * z1[n - m] + dy2[m - 1];
      } else if (n % 2 != 0 && m == (n - 1) / 2 + 1) {
        zn[m] = x * z1[m] + y * z1[n - 1 - m] + x * z1[m - 1] - z2[m - 1];
        dxn[m] = fn * z1[m] + fn * z1[m - 1] + dx2[m - 1];
        dyn[m] = fn * z1[n - 1 - m] + dy2[m - 1];
      } else if (n % 2 == 0 && m == n / 2) {
        zn[m] = 2.0f * x * z1[m] + 2.0f * y * z1[m - 1] - z2[m - 1];
        dxn[m] = 2.0f * fn * z1[m] + dx2[m - 1];
        dyn[m] = 2.0f * fn * z1[n - 1 - m] + dy2[m - 1];
      } else {
        zn[m] = x * z1[m] + y * z1[n - 1 - m] + x * z1[m - 1] - y * z1[n - m] - z2[m - 1];
        dxn[m] = fn * z1[m] + fn * z1[m - 1] + dx2[m - 1];
        dyn[m] = fn * z1[n - 1 - m] - fn * z1[n - m] + dy2[m - 1];
      }
      const float cm = c[n * (n + 1) / 2 + m];
      h = h + cm * zn[m];
      if constexpr (SLOPES) {
        gx = gx + cm * dxn[m];
        gy = gy + cm * dyn[m];
      }
    }
#pragma unroll
    for (int m = 0; m <= n; ++m) {
      if (m < n) {
        z2[m] = z1[m];
        if constexpr (SLOPES) {
          dx2[m] = dx1[m];
          dy2[m] = dy1[m];
        }
      }
      z1[m] = zn[m];
      if constexpr (SLOPES) {
        dx1[m] = dxn[m];
        dy1[m] = dyn[m];
      }
    }
  }
}

// A fractional grid index clamped to [0, hi] as torch.clamp takes it (max,
// then min): a clamped index is a constant, with no tangent.
template <typename S>
__device__ __forceinline__ S clamp_index(S f, float hi) {
  return fmin_(fmax_(f, 0.0f), hi);
}

// The bilinear lookup of a grid map at support coordinates (x, y), in the
// arithmetic of ops/defects._bilinear_multi: the fractional index (x - x0) /
// dx (IEEE divide) clamped, the cell's integer index from the value (on
// Dual<G> the primal's) clamped to [0, nx - 2], the four corners' weights,
// and the corners' rows read once each through the read-only path (one
// 16-byte load: the height and, with SLOPES, both slopes). No texture unit:
// its 8-bit weights would break parity with the plain version. Index
// arithmetic is integer: a map of 64 M nodes needs it exact.
template <bool SLOPES, typename S>
__device__ __forceinline__ void grid_sums(const GridP& g, S x, S y, S& h, S& gx, S& gy) {
  const S fx = clamp_index((x - g.x0) / g.dx, g.fx_max);
  const S fy = clamp_index((y - g.y0) / g.dy, g.fy_max);
  const int ix = min(max((int)floorf(val(fx)), 0), g.nx - 2);
  const int iy = min(max((int)floorf(val(fy)), 0), g.ny - 2);
  const S wx = fx - (float)ix, wy = fy - (float)iy;
  const S vx = 1.0f - wx, vy = 1.0f - wy;
  const S w00 = vx * vy, w10 = wx * vy, w01 = vx * wy, w11 = wx * wy;
  const float4* r = g.rows + ((long long)ix * g.ny + iy);
  const float4 c00 = __ldg(r), c01 = __ldg(r + 1), c10 = __ldg(r + g.ny), c11 = __ldg(r + g.ny + 1);
  h = c00.x * w00 + c10.x * w10 + c01.x * w01 + c11.x * w11;
  if constexpr (SLOPES) {
    gx = c00.y * w00 + c10.y * w10 + c01.y * w01 + c11.y * w11;
    gy = c00.z * w00 + c10.z * w10 + c01.z * w01 + c11.z * w11;
  }
}

// The defect sums at a hit (x, y) of a mirror, as the hit functions below
// take them: a Zernike table's height and slopes at the unit-disk
// coordinates ((x - cx) / r, (y - cy) / r) about its support centre (the
// slopes along those coordinates: times 1 / r along the hit's), and a grid
// map's at support coordinates. On float these are the sums themselves. K6
// (Dual<G>) takes the overloads that follow: the sums on the primal, their
// tangents composed at the hit.
template <typename S>
__device__ __forceinline__ S zernike_height(const ZernikeP& zk, S x, S y, float cx, float cy) {
  S h, gx, gy;
  zernike_sums<false>(zk, (x - cx) * zk.inv_r, (y - cy) * zk.inv_r, h, gx, gy);
  return h;
}

template <typename S>
__device__ __forceinline__ void zernike_slopes(const ZernikeP& zk, S x, S y, float cx, float cy, S& gx,
                                               S& gy) {
  S h;
  zernike_sums<true>(zk, (x - cx) * zk.inv_r, (y - cy) * zk.inv_r, h, gx, gy);
}

template <typename S>
__device__ __forceinline__ S grid_height(const GridP& g, S x, S y) {
  S h, sx, sy;
  grid_sums<false>(g, x, y, h, sx, sy);
  return h;
}

template <typename S>
__device__ __forceinline__ void grid_slopes(const GridP& g, S x, S y, S& sx, S& sy) {
  S h;
  grid_sums<true>(g, x, y, h, sx, sy);
}

// The defect sums on dual numbers (K6). The height error and the defect
// slopes are functions of the hit's two support coordinates (x, y) only. So
// K6 evaluates the Zernike recurrence and the grid lookups once per ray on
// the primal coordinates, in float, in the arithmetic K7 runs (the values
// are K7's), and composes their tangents by the chain rule at the hit:
// t(h) = h_x t(x) + h_y t(y), and for the slopes the rows of h's Hessian
// (or of the slope maps' cell derivatives). This is the linear map JAX's
// linearize takes through every row of the recurrence and through the
// bilinear weights; only the float32 rounding differs. The rest of the
// defect branch (the base normals, cos alpha, the shifted t and point)
// stays on Dual<G>.

// the Dual<G> of a function of the support coordinates (x, y): its value v
// and partial derivatives fx, fy composed with the tangents of x and y
template <int G>
__device__ __forceinline__ Dual<G> at_hit(float v, float fx, float fy, const Dual<G>& x,
                                          const Dual<G>& y) {
  Dual<G> r;
  r.v = v;
#pragma unroll
  for (int i = 0; i < G; ++i) r.t[i] = fx * x.t[i] + fy * y.t[i];
  return r;
}

// grid_sums at float coordinates (x, y) with the bilinear's cell
// derivatives: the height channel (v[0], SLOPES false) or the two slope
// channels (v[0], v[1]), each with its derivatives along x and y,
// ((c10 - c00) vy + (c11 - c01) wy) / dx and ((c01 - c00) vx + (c11 - c10)
// wx) / dy. The values are grid_sums' arithmetic. A clamped fractional
// index carries no tangent (clamp_index on Dual<G>: only 0 < f < hi passes
// it); the cell comes from the value.
template <bool SLOPES>
__device__ __forceinline__ void grid_cell(const GridP& g, float x, float y, float* v, float* dvx,
                                          float* dvy) {
  const float ux = (x - g.x0) / g.dx, uy = (y - g.y0) / g.dy;
  const float fx = clamp_index(ux, g.fx_max);
  const float fy = clamp_index(uy, g.fy_max);
  const int ix = min(max((int)floorf(fx), 0), g.nx - 2);
  const int iy = min(max((int)floorf(fy), 0), g.ny - 2);
  const float wx = fx - (float)ix, wy = fy - (float)iy;
  const float vx = 1.0f - wx, vy = 1.0f - wy;
  const float w00 = vx * vy, w10 = wx * vy, w01 = vx * wy, w11 = wx * wy;
  const float4* r = g.rows + ((long long)ix * g.ny + iy);
  const float4 c00 = __ldg(r), c01 = __ldg(r + 1), c10 = __ldg(r + g.ny), c11 = __ldg(r + g.ny + 1);
  const float sx = (ux > 0.0f && ux < g.fx_max) ? tangent_rcp(g.dx) : 0.0f;
  const float sy = (uy > 0.0f && uy < g.fy_max) ? tangent_rcp(g.dy) : 0.0f;
  const auto channel = [&](int k, float a00, float a10, float a01, float a11) {
    v[k] = a00 * w00 + a10 * w10 + a01 * w01 + a11 * w11;
    dvx[k] = ((a10 - a00) * vy + (a11 - a01) * wy) * sx;
    dvy[k] = ((a01 - a00) * vx + (a11 - a10) * wx) * sy;
  };
  if constexpr (SLOPES) {
    channel(0, c00.y, c10.y, c01.y, c11.y);
    channel(1, c00.z, c10.z, c01.z, c11.z);
  } else {
    channel(0, c00.x, c10.x, c01.x, c11.x);
  }
}

// A Zernike table's slopes and their derivatives at unit-disk coordinates
// (x, y): g = {gx, gy, d gx/dx, d gx/dy, d gy/dx, d gy/dy}, the recurrence
// of zernike_sums with slopes on Dual<2> seeded along x and y (its
// tangents are the rows of the sum's Hessian)
__device__ __forceinline__ void zernike_hessian(const ZernikeP& zk, float x, float y, float* g) {
  Dual<2> u(x), v(y), h, gx, gy;
  u.t[0] = 1.0f;
  v.t[1] = 1.0f;
  zernike_sums<true>(zk, u, v, h, gx, gy);
  g[0] = gx.v;
  g[1] = gy.v;
  g[2] = gx.t[0];
  g[3] = gx.t[1];
  g[4] = gy.t[0];
  g[5] = gy.t[1];
}

// the height: the recurrence with slopes on the primal, its gradient along
// the hit's coordinates composed at the hit
template <int G>
__device__ __forceinline__ Dual<G> zernike_height(const ZernikeP& zk, Dual<G> x, Dual<G> y, float cx,
                                                  float cy) {
  float h, hx, hy;
  zernike_sums<true>(zk, (x.v - cx) * zk.inv_r, (y.v - cy) * zk.inv_r, h, hx, hy);
  return at_hit(h, hx * zk.inv_r, hy * zk.inv_r, x, y);
}

// the slopes (only where ignore_defects is False): the Hessian's rows times
// the coordinates' d/dx = 1 / radius
template <int G>
__device__ __forceinline__ void zernike_slopes(const ZernikeP& zk, Dual<G> x, Dual<G> y, float cx,
                                               float cy, Dual<G>& gx, Dual<G>& gy) {
  float g[6];
  zernike_hessian(zk, (x.v - cx) * zk.inv_r, (y.v - cy) * zk.inv_r, g);
  gx = at_hit(g[0], g[2] * zk.inv_r, g[3] * zk.inv_r, x, y);
  gy = at_hit(g[1], g[4] * zk.inv_r, g[5] * zk.inv_r, x, y);
}

template <int G>
__device__ __forceinline__ Dual<G> grid_height(const GridP& g, Dual<G> x, Dual<G> y) {
  float v, vx, vy;
  grid_cell<false>(g, x.v, y.v, &v, &vx, &vy);
  return at_hit(v, vx, vy, x, y);
}

template <int G>
__device__ __forceinline__ void grid_slopes(const GridP& g, Dual<G> x, Dual<G> y, Dual<G>& sx,
                                            Dual<G>& sy) {
  float s[2], dx[2], dy[2];
  grid_cell<true>(g, x.v, y.v, s, dx, dy);
  sx = at_hit(s[0], dx[0], dy[0], x, y);
  sy = at_hit(s[1], dx[1], dy[1], x, y);
}

// The hit on a mirror with Zernike defects, from its base hit h (point and t
// of the base root; alive stays the base hit's): t shifted along the ray by
// the height error over max(-u.n0, 1e-6), the base normal at the shifted
// point, and unless ignore_defects the defect slopes composed into it,
// n = (-gx, -gy, 1) / |.| (the ZERNIKE_TABLES branch).
template <typename S>
__device__ __forceinline__ void zernike_hit(const ElementP& el, const ZernikeP& zk,
                                            bool ignore_defects, S qx, S qy, S qz, S ux, S uy,
                                            S uz, HitT<S>& h) {
  S n0x, n0y, n0z, cos_alpha, gx, gy;
  surface_normal(el, h.x, h.y, h.z, n0x, n0y, n0z);
  // on Dual<G> cos alpha is taken first, so that the base normals (3 (1 + G)
  // floats) die before the defect sums: live across them they spill there
  // (PERF.md §6 PR 13); the float kernels keep the order they were tuned in
  if constexpr (is_dual<S>) cos_alpha = fmax_(-(ux * n0x + uy * n0y + uz * n0z), 1e-6f);
  const S dh = zernike_height(zk, h.x, h.y, el.cen[0], el.cen[1]);
  if constexpr (!is_dual<S>) cos_alpha = fmax_(-(ux * n0x + uy * n0y + uz * n0z), 1e-6f);
  h.t = h.t - div_(dh, cos_alpha);
  h.x = qx + h.t * ux;
  h.y = qy + h.t * uy;
  h.z = qz + h.t * uz;
  surface_normal(el, h.x, h.y, h.z, h.nx, h.ny, h.nz);
  if (ignore_defects) return;
  zernike_slopes(zk, h.x, h.y, el.cen[0], el.cen[1], gx, gy);
  gx = -div_(h.nx, h.nz) + gx * zk.inv_r;
  gy = -div_(h.ny, h.nz) + gy * zk.inv_r;
  const S inv = rsq(gx * gx + gy * gy + 1.0f);
  h.nx = -gx * inv;
  h.ny = -gy * inv;
  h.nz = inv;
}

// The same for element i of a chain with grid maps (the GRID_MAPS branch):
// heights and slopes summed over the mirror's Zernike table, then its grid
// maps in their order (ops/trace._deformed_hit / _defect_normal sum the
// defects in the order of element.defects: two defects add the same either
// way round, and the Zernike defects of one mirror are one table already).
// The grid lookups keep their own temporaries, apart from the recurrence's
// rows.
template <typename S>
__device__ __forceinline__ void deformed_hit(const ChainP& ch, int i, S qx, S qy, S qz, S ux,
                                             S uy, S uz, HitT<S>& h) {
  const ElementP& el = ch.el[i];
  const int z = ch.zk_of[i];
  S n0x, n0y, n0z, cos_alpha, dh = S(0.0f), gx, gy;
  surface_normal(el, h.x, h.y, h.z, n0x, n0y, n0z);
  if constexpr (is_dual<S>) cos_alpha = fmax_(-(ux * n0x + uy * n0y + uz * n0z), 1e-6f);  // as above
  if (z >= 0) dh = zernike_height(ch.zk[z], h.x, h.y, el.cen[0], el.cen[1]);
  for (int g = ch.grid_begin[i]; g < ch.grid_end[i]; ++g)
    dh = dh + grid_height(ch.grid[g], h.x - el.cen[0], h.y - el.cen[1]);
  if constexpr (!is_dual<S>) cos_alpha = fmax_(-(ux * n0x + uy * n0y + uz * n0z), 1e-6f);
  h.t = h.t - div_(dh, cos_alpha);
  h.x = qx + h.t * ux;
  h.y = qy + h.t * uy;
  h.z = qz + h.t * uz;
  surface_normal(el, h.x, h.y, h.z, h.nx, h.ny, h.nz);
  if (ch.ignore_defects) return;
  if (z >= 0) {
    const ZernikeP& zk = ch.zk[z];
    zernike_slopes(zk, h.x, h.y, el.cen[0], el.cen[1], gx, gy);
    gx = -div_(h.nx, h.nz) + gx * zk.inv_r;
    gy = -div_(h.ny, h.nz) + gy * zk.inv_r;
  } else {
    gx = -div_(h.nx, h.nz);
    gy = -div_(h.ny, h.nz);
  }
  for (int g = ch.grid_begin[i]; g < ch.grid_end[i]; ++g) {
    S sx, sy;
    grid_slopes(ch.grid[g], h.x - el.cen[0], h.y - el.cen[1], sx, sy);
    gx = gx + sx;
    gy = gy + sy;
  }
  const S inv = rsq(gx * gx + gy * gy + 1.0f);
  h.nx = -gx * inv;
  h.ny = -gy * inv;
  h.nz = inv;
}

// ---------------------------------------------------------------------------
// source (ops/fused_trace.synth_source)
// ---------------------------------------------------------------------------

// sin(pi x), cos(pi x) on [-1, 1]: the source law's minimax polynomials
// (ops/fused_trace._SIN_PI/_COS_PI), Horner form, unfused so ray k's
// direction matches the plain version and the JAX package bit for bit
__device__ __forceinline__ void sincos_pi_law(float x, float& sn, float& cs) {
  const float x2 = __fmul_rn(x, x);
  float s = 0.00039054382726498024f;
  s = __fadd_rn(__fmul_rn(s, x2), -0.007259921822795766f);
  s = __fadd_rn(__fmul_rn(s, x2), 0.08206264637303859f);
  s = __fadd_rn(__fmul_rn(s, x2), -0.599230762176276f);
  s = __fadd_rn(__fmul_rn(s, x2), 2.550156988459466f);
  s = __fadd_rn(__fmul_rn(s, x2), -5.16771212974953f);
  s = __fadd_rn(__fmul_rn(s, x2), 3.1415926362231827f);
  sn = __fmul_rn(s, x);
  float c = -8.869084444024393e-05f;
  c = __fadd_rn(__fmul_rn(c, x2), 0.0019043286626063097f);
  c = __fadd_rn(__fmul_rn(c, x2), -0.025785808393817295f);
  c = __fadd_rn(__fmul_rn(c, x2), 0.2353208253010271f);
  c = __fadd_rn(__fmul_rn(c, x2), -1.3352602860924583f);
  c = __fadd_rn(__fmul_rn(c, x2), 4.058711817231867f);
  c = __fadd_rn(__fmul_rn(c, x2), -4.934802185862838f);
  c = __fadd_rn(__fmul_rn(c, x2), 0.999999999885547f);
  cs = c;
}

// unit-radius Vogel point k (index < 2^24) of a spiral with radius law
// sqrt(k * inv_n + k_frac), scaled by `scale`: (r cos theta, r sin theta)
__device__ __forceinline__ void vogel_point(const SourceP& src, int k, float inv_n, float phase,
                                            float k_frac, float scale, float& x, float& y) {
  // frac(k * phi) over the base-256 digits of k, in the JAX package's order
  const float a = (float)(k >> 16), b = (float)((k >> 8) & 255), c = (float)(k & 255);
  const float tt = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a, src.g[2]), __fmul_rn(b, src.g[1])),
                                       __fmul_rn(c, src.g[0])), phase);
  const float fr = __fsub_rn(tt, floorf(tt));
  float sn, cs;
  sincos_pi_law(__fsub_rn(__fmul_rn(2.0f, fr), 1.0f), sn, cs);
  const float r = sqrtf(__fadd_rn(__fmul_rn((float)k, inv_n), k_frac));
  x = __fmul_rn(-r * cs, scale);
  y = __fmul_rn(-r * sn, scale);
}

// Source ray k (local index < 2^24): the canonical-frame ray and the
// Gaussian law argument rr. cone/disk: ray k of the spiral (phase, k_frac:
// the chunk's offsets). extended: cone ray j of sub-source i, (i, j) =
// divmod(k, n_each), the chunk's offsets on the sub-source spiral. square:
// grid point (row i, column j) = divmod(k, n_each), phase = the chunk's row
// offset.
__device__ __forceinline__ void synth_source(const SourceP& src, int k, float phase, float k_frac,
                                             Ray& s, float& rr) {
  const int i = (src.kind >= SRC_EXTENDED) ? k / src.n_each : 0;
  const int j = k - i * src.n_each;
  if (src.kind == SRC_SQUARE) {
    const float x = __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn((float)i, phase), src.inv_n_each), 0.5f),
                              src.radius);
    const float y = __fmul_rn(__fsub_rn(__fmul_rn((float)j, src.inv_n_each), 0.5f), src.radius);
    rr = __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)) / src.rad2;
    s.px = x; s.py = y; s.pz = 0.0f;
    s.dx = 0.0f; s.dy = 0.0f; s.dz = 1.0f;
  } else {
    float cx, cy;
    if (src.kind == SRC_EXTENDED) {
      vogel_point(src, i, src.inv_n_total, phase, k_frac, src.pos_radius, s.px, s.py);
      vogel_point(src, j, src.inv_n_each, 0.0f, 0.0f, src.radius, cx, cy);
    } else {
      vogel_point(src, k, src.inv_n_total, phase, k_frac, src.radius, cx, cy);
      s.px = 0.0f; s.py = 0.0f;
    }
    s.pz = 0.0f;
    const float rho2 = __fadd_rn(__fmul_rn(cx, cx), __fmul_rn(cy, cy));
    rr = rho2 / src.rad2;
    if (src.kind == SRC_DISK) {
      s.px = cx; s.py = cy;
      s.dx = 0.0f; s.dy = 0.0f; s.dz = 1.0f;
    } else {
      const float inv = rsq(__fadd_rn(rho2, 1.0f));
      s.dx = cx * inv; s.dy = cy * inv; s.dz = inv;
    }
  }
  s.opl = 0.0f;
  s.opl_c = 0.0f;
  s.inc = 0.0f;
  s.alive = true;
}


// ---------------------------------------------------------------------------
// the chain (ops/trace.chained_step with freeze_dead=False)
// ---------------------------------------------------------------------------

// element maps read from the chain record itself (K1-K4, K8)
struct TableMaps {
  const ChainP& ch;
  __device__ __forceinline__ const float* M(int i) const { return ch.el[i].M; }
  __device__ __forceinline__ const float* b(int i) const { return ch.el[i].b; }
};

// element maps from a runtime pose vector of scalar type S, 12 per element
// (M row-major, then b), as ops/fused_grad.chain_scalars_np lays it out (K5-K7)
template <typename S>
struct PoseMaps {
  const S* pose;
  __device__ __forceinline__ const S* M(int i) const { return pose + 12 * i; }
  __device__ __forceinline__ const S* b(int i) const { return pose + 12 * i + 9; }
};

// The element steps of a chain walk, on the ray (qx..uz) in the element's
// frame; `last`: the chain's last element (its incidence is kept).
// A mask: the ray crosses the mask's plane past t_eps outside its support,
// or stops where it is, dead.
template <bool WANT_INCIDENCE, typename S>
__device__ __forceinline__ void mask_step(const ElementP& el, float t_eps, bool last, S qx, S qy,
                                          S qz, S ux, S uy, S uz, RayT<S>& s) {
  const S t = plane_t(qz, uz);
  const S x = qx + t * ux, y = qy + t * uy, z = qz + t * uz;
  const bool upd = s.alive && (t > t_eps) && !include(el.sup, val(x), val(y));
  if (WANT_INCIDENCE && last && upd) s.inc = acosf(fminf(fmaxf(val(uz), -1.0f), 1.0f));
  kahan_add(s.opl, s.opl_c, upd ? t : S(0.0f));
  s.px = upd ? x : qx;
  s.py = upd ? y : qy;
  s.pz = upd ? z : qz;
  s.dx = ux;
  s.dy = uy;
  s.dz = uz;
  s.alive = upd;
}

// Mirror i after its surface's hit h: a deformed mirror's branch (DEFECTS),
// the OPL, the reflection, the state patch-relative to the element.
template <bool WANT_INCIDENCE, int DEFECTS, typename S>
__device__ __forceinline__ void mirror_step(const ChainP& ch, int i, bool last, S qx, S qy, S qz,
                                            S ux, S uy, S uz, HitT<S>& h, RayT<S>& s) {
  const ElementP& el = ch.el[i];
  if constexpr (DEFECTS == ZERNIKE_TABLES) {
    const int z = ch.zk_of[i];
    if (z >= 0) zernike_hit(el, ch.zk[z], ch.ignore_defects != 0, qx, qy, qz, ux, uy, uz, h);
  } else if constexpr (DEFECTS == GRID_MAPS) {
    if (ch.zk_of[i] >= 0 || ch.grid_end[i] > ch.grid_begin[i])
      deformed_hit(ch, i, qx, qy, qz, ux, uy, uz, h);
  }
  const S dn = ux * h.nx + uy * h.ny + uz * h.nz;
  if (WANT_INCIDENCE && last) s.inc = acosf(fminf(fmaxf(-val(dn), -1.0f), 1.0f));
  kahan_add(s.opl, s.opl_c, h.t);
  s.px = h.x - el.cen[0];
  s.py = h.y - el.cen[1];
  s.pz = h.z - el.cen[2];
  s.dx = ux - 2.0f * dn * h.nx;
  s.dy = uy - 2.0f * dn * h.ny;
  s.dz = uz - 2.0f * dn * h.nz;
  s.alive = s.alive && h.hit;
}

// Trace one ray through the chain; the state stays patch-relative to the
// last element. Dead rays are not frozen at mirrors (their values are
// unspecified and every consumer masks by alive); mask steps freeze.
//
// WARP_EXIT (WarpExit): a warp whose rays are all dead leaves the chain
// before the next element. A warp's rays are consecutive points of the
// source's spiral, one thin ring, so a round mask or hole keeps or kills
// them together (the flagship loses 51 % of its rays, as whole warps at its
// mask, before its two toroids). WARP_VOTE (the kernels that only sum alive
// rays: K1i, K2, K5, K6, K8): the caller's ray loop is warp-uniform
// (for_thread_rays) and the vote names all 32 lanes. ACTIVE_VOTE (K1): the
// vote names the lanes still active, so a lane past the end may have
// returned; a lane leaves only when its own ray is dead, whatever lanes vote.
//
// DEFECTS (with_defects): ZERNIKE_TABLES, a mirror with a Zernike table
// takes zernike_hit; GRID_MAPS, a mirror with a table or grid maps takes
// deformed_hit.
enum WarpExit : int { NO_EXIT = 0, WARP_VOTE = 1, ACTIVE_VOTE = 2 };

template <bool WANT_INCIDENCE, int WARP_EXIT, int DEFECTS, typename S, typename Maps>
__device__ __forceinline__ void trace_chain_maps(const ChainP& ch, const Maps& maps, RayT<S>& s) {
  for (int i = 0; i < ch.n_elements; ++i) {
    const ElementP& el = ch.el[i];
    const bool last = (i == ch.n_elements - 1);
    float t_eps = T_EPS;
    if (el.pre_end > el.pre_begin) {
      // folded masks: alive-predicates; the furthest crossing is the next
      // element's minimum ray parameter
      float t_floor = 0.0f;
      for (int k = el.pre_begin; k < el.pre_end; ++k) {
        const PremaskP& pm = ch.pre[k];
        S mx, my, mz, mux, muy, muz;
        affine(pm.M, pm.b, s, mx, my, mz, mux, muy, muz);
        const S t = plane_t(mz, muz);
        const bool on = include(pm.sup, val(mx + t * mux), val(my + t * muy));
        s.alive = s.alive && (t > t_floor + T_EPS) && !on;
        t_floor = fmaxf(t_floor, val(t));
      }
      t_eps = t_floor + T_EPS;
    }
    if (WARP_EXIT != NO_EXIT &&
        !__any_sync(WARP_EXIT == ACTIVE_VOTE ? __activemask() : 0xffffffffu, s.alive))
      return;
    S qx, qy, qz, ux, uy, uz;
    affine(maps.M(i), maps.b(i), s, qx, qy, qz, ux, uy, uz);
    if (el.kind == ELEM_MASK) {
      mask_step<WANT_INCIDENCE>(el, t_eps, last, qx, qy, qz, ux, uy, uz, s);
      continue;
    }
    HitT<S> h;
    switch (el.kind) {
      case ELEM_TOROID:
        h = toroid_hit(el, qx, qy, qz, ux, uy, uz, t_eps);
        break;
      case ELEM_PLANE:
        h = plane_hit(el, qx, qy, qz, ux, uy, uz, t_eps);
        break;
      default:
        h = quadric_hit(el, qx, qy, qz, ux, uy, uz, t_eps);
        break;
    }
    mirror_step<WANT_INCIDENCE, DEFECTS>(ch, i, last, qx, qy, qz, ux, uy, uz, h, s);
  }
}

// the chain walk with the maps of the chain record
template <bool WANT_INCIDENCE, int WARP_EXIT, int DEFECTS>
__device__ __forceinline__ void trace_chain(const ChainP& ch, Ray& s) {
  trace_chain_maps<WANT_INCIDENCE, WARP_EXIT, DEFECTS>(ch, TableMaps{ch}, s);
}

// A traced state in the lab: patch-relative frame K -> lab, p = RK^T x +
// posK, d = RK^T d (K1's stores, K1i's detector plane: one expression, so
// one rounding, in both).
__device__ __forceinline__ void to_lab(const ChainP& ch, const Ray& s, float* P, float* D) {
  const float* R = ch.RK;
  P[0] = R[0] * s.px + R[3] * s.py + R[6] * s.pz + ch.posK[0];
  P[1] = R[1] * s.px + R[4] * s.py + R[7] * s.pz + ch.posK[1];
  P[2] = R[2] * s.px + R[5] * s.py + R[8] * s.pz + ch.posK[2];
  D[0] = R[0] * s.dx + R[3] * s.dy + R[6] * s.dz;
  D[1] = R[1] * s.dx + R[4] * s.dy + R[7] * s.dz;
  D[2] = R[2] * s.dx + R[5] * s.dy + R[8] * s.dz;
}

// Write ray k of a traced state in the lab (the outputs of K1, K3 and K4).
__device__ __forceinline__ void store_lab(const ChainP& ch, const Ray& s, int k,
                                          float* __restrict__ p, float* __restrict__ d,
                                          float* __restrict__ opl, float* __restrict__ opl_c,
                                          unsigned char* __restrict__ alive,
                                          float* __restrict__ inc) {
  float P[3], D[3];
  to_lab(ch, s, P, D);
  p[3 * k + 0] = P[0];
  p[3 * k + 1] = P[1];
  p[3 * k + 2] = P[2];
  d[3 * k + 0] = D[0];
  d[3 * k + 1] = D[1];
  d[3 * k + 2] = D[2];
  opl[k] = s.opl;
  opl_c[k] = s.opl_c;
  alive[k] = s.alive ? 1 : 0;
  inc[k] = s.inc;
}

// ---------------------------------------------------------------------------
// detector moments (ops/fused_trace.moment_rows), shared by K2 and K5
// ---------------------------------------------------------------------------

constexpr int N_MOMENTS = 16;

// ops/fused_trace.moment_rows for one alive ray, about the detector plane
// (centre c, normal n, axes e1, e2) in the last element's frame
__device__ __forceinline__ void add_moments(const float* c, const float* n, const float* e1,
                                            const float* e2, float opl_ref, float inv_dn_chief,
                                            float centre_distance, const Ray& s, float w,
                                            float* acc) {
  const float dn = s.dx * n[0] + s.dy * n[1] + s.dz * n[2];
  const float inv_dn = 1.0f / (fabsf(dn) > 1e-30f ? dn : CUDART_INF_F);
  const float b0 = (c[0] - s.px) * n[0] + (c[1] - s.py) * n[1] + (c[2] - s.pz) * n[2];
  const float t0 = (b0 - centre_distance) * inv_dn;
  const float rx = s.px - c[0], ry = s.py - c[1], rz = s.pz - c[2];
  const float a1 = rx * e1[0] + ry * e1[1] + rz * e1[2];
  const float a2 = rx * e2[0] + ry * e2[1] + rz * e2[2];
  const float g1 = s.dx * e1[0] + s.dy * e1[1] + s.dz * e1[2];
  const float g2 = s.dx * e2[0] + s.dy * e2[1] + s.dz * e2[2];
  const float x0 = a1 + t0 * g1;
  const float y0 = a2 + t0 * g2;
  const float cx = inv_dn * g1;
  const float cy = inv_dn * g2;
  const float cd = inv_dn - inv_dn_chief;
  // fs-scale delay: the same-magnitude subtractions stay unfused
  const float d0 = __fadd_rn(__fadd_rn(__fsub_rn(__fsub_rn(s.opl, opl_ref), s.opl_c), t0),
                             __fmul_rn(centre_distance, inv_dn_chief));
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

__device__ __forceinline__ void add_moments(const DetectorP& det, const Ray& s, float w,
                                            float* acc) {
  add_moments(det.c, det.n, det.e1, det.e2, det.opl_ref, det.inv_dn_chief, det.centre_distance,
              s, w, acc);
}


// ---------------------------------------------------------------------------
// detector statistics at given distances (ops/fused_trace.stats_rows),
// shared by K6, K7 and K8
// ---------------------------------------------------------------------------

constexpr int N_STATS = 7;  // w, wx, wy, wxx, wyy, wd, wdd

// the distance-independent part of stats_rows for one ray: the detector
// plane (centre c, normal n, axes e1, e2: entries of type D, float or S) in
// the last element's frame
template <typename S>
struct StatsGeom {
  S t0, inv_dn, a1, a2, g1, g2, dsmall;
};

template <typename S, typename D>
__device__ __forceinline__ StatsGeom<S> stats_geometry(const D* c, const D* n, const D* e1,
                                                       const D* e2, float opl_ref,
                                                       const RayT<S>& s) {
  StatsGeom<S> g;
  const S dn = s.dx * n[0] + s.dy * n[1] + s.dz * n[2];
  g.inv_dn = 1.0f / (fabs_(dn) > 1e-30f ? dn : S(CUDART_INF_F));
  const S b0 = (c[0] - s.px) * n[0] + (c[1] - s.py) * n[1] + (c[2] - s.pz) * n[2];
  g.t0 = b0 * g.inv_dn;
  const S rx = s.px - c[0], ry = s.py - c[1], rz = s.pz - c[2];
  g.a1 = rx * e1[0] + ry * e1[1] + rz * e1[2];
  g.a2 = rx * e2[0] + ry * e2[1] + rz * e2[2];
  g.g1 = s.dx * e1[0] + s.dy * e1[1] + s.dz * e1[2];
  g.g2 = s.dx * e2[0] + s.dy * e2[1] + s.dz * e2[2];
  // (opl - ref) is a same-magnitude subtraction, then the Kahan
  // compensation at full significance: unfused
  g.dsmall = sub_rn(sub_rn(s.opl, opl_ref), s.opl_c);
  return g;
}

// the 7 stats terms of one alive ray at ray parameter tj = t0 - dist *
// inv_dn and delay dj = (dsmall + tj) - offset, in STATS_FIELDS order
template <typename S>
__device__ __forceinline__ void stats_terms(const StatsGeom<S>& g, S tj, S dj, float w, S* out) {
  const S xj = g.a1 + tj * g.g1;
  const S yj = g.a2 + tj * g.g2;
  const S wx = w * xj, wy = w * yj, wd = w * dj;
  out[0] = S(w);
  out[1] = wx;
  out[2] = wy;
  out[3] = wx * xj;
  out[4] = wy * yj;
  out[5] = wd;
  out[6] = wd * dj;
}

// ---------------------------------------------------------------------------
// runtime-pose kernels (K5, K6, K7): every pose a runtime value
// ---------------------------------------------------------------------------

// the pose vector svec: 12 scalars per element (M row-major, b), then the
// detector centre, normal, e1, e2 in the last element's frame
constexpr int MAX_SCALARS = 12 * MAX_ELEMENTS + 12;

// The body K5, K6 and K7 share: this thread's rays of one chunk, synthesized
// from the source record, traced with the element maps of the block's pose
// table (scalar type S: float, or Dual<G> for K6) and the rest of the chain
// from the record, then epi(s, rr) for each alive ray.
template <int DEFECTS, typename S, typename Epilogue>
__device__ __forceinline__ void trace_runtime_pose(const ChainP& ch, const SourceP& src,
                                                   const S* pose, int n_local, int first,
                                                   float phase, float k_frac, Epilogue&& epi) {
  const PoseMaps<S> maps{pose};
  for_thread_rays<MOMENT_RAYS_PER_THREAD>(first, n_local, [&](int k, bool in_range) {
    Ray s0;
    float rr;
    synth_source(src, k, phase, k_frac, s0, rr);
    s0.alive = in_range;
    RayT<S> s = lift<S>(s0);
    trace_chain_maps<false, WARP_VOTE, DEFECTS>(ch, maps, s);
    if (s.alive) epi(s, rr);
  });
}

}  // namespace art
