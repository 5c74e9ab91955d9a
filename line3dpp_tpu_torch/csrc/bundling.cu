// Line bundling: every Levenberg-Marquardt iteration of every cluster in
// one launch, a warp per cluster.
//
// Replaces no Pallas kernel: the JAX package's lm_optimize
// (line3dpp_tpu/ops/bundling.py:157) is XLA-jitted.  It takes the place of
// the Python loop of ops/bundling.lm_optimize_plain: about 354 small
// launches and one host sync per iteration, 250 iterations a scene
// (Config.max_iter_optim).
//
// What bounds it on the H100: latency.  A cluster's iterations depend on
// one another, so the launch takes at least 250 times the dependent chain
// of one iteration (residuals and Jacobians, a 5-step shuffle reduction of
// 14 sums, a 4 x 4 solve, the cost, a second reduction).  Its operations
// (a cost evaluation of ~140 an observation each iteration, a Jacobian
// evaluation of ~590 at the start and after each accepted step: ~7e8 on
// the 26-view scene's 15,626 observations) take 0.01 ms at 67 TFLOP/s, and
// its inputs (116 B an observation) are read once.
//
// Design: a warp per cluster over the observations sorted by cluster
// (`order`, `offsets`).  Lane j keeps observation j of its cluster (KinvT,
// R, t, both homogeneous endpoints and the segment direction: 29 floats) in
// registers for all iterations; a cluster longer than 32 reads its further
// observations again from global memory (L1) each time (on an H100, a
// second stride kept in registers took 0.815 against 0.834 ms alone,
// 0.754 against 0.715 ms with kBlocksPerSm, which it spills further).
// Every lane computes the Cayley frame and its 4 tangents, sums its
// observations' IRLS-weighted J^T J (10 terms) and g in order, and an xor
// butterfly
// over the warp leaves the same sums in every lane, bit for bit (a + b is
// b + a).  Every lane then solves the same damped system A = J^T J +
// lambda max(diag, 1e-8) I by Gaussian elimination with partial pivoting,
// evaluates the cost at the new parameters, summed the same way, and
// accepts when it is lower (so NaN is rejected).  lambda goes x0.33 on
// accept and x3 on reject within [1e-9, 1e6].  A rejected step leaves the
// parameters as they were, so the next iteration's J^T J and g are this
// one's: they are kept, not recomputed.  Exactly `iterations` iterations;
// no atomics, so two runs give the same bits.  Float32 with IEEE division
// and square root and the full-precision expf, asinf and sincosf, as the
// plain path (no fast math); nvcc contracts a * b + c into one rounding
// (FMA), where the plain path's separate kernels round twice.  The
// arithmetic is ops/bundling.py's _frame_tangents and _res_and_jac for the
// step, _obs_residual and _huber_w for the cost, written per observation.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                       // warps (clusters) a block
// 5 blocks an SM hold 20 warps, so 2640 clusters run in one wave; ptxas
// then fits the kernel in 96 registers (with 184 B of spill) where it
// would take 148 and 13 warps an SM, two waves on the 26-view scene's 2295
// clusters: 0.715 against 0.834 ms there on an H100 (bit-equal)
constexpr int kBlocksPerSm = 5;
constexpr float kEps = 1e-12f;                  // bundling.EPS
constexpr float kHuber = 2.0f;                  // bundling.HUBER_DELTA
constexpr float kTop = (float)(1.0 - 1e-6);     // the arcsine's clamp

struct Obs {
  float K[9], R[9], t[3], p1[3], p2[3], d[2];
};

__device__ __forceinline__ void load_obs(
    Obs& o, int64_t i, const float* __restrict__ KinvT,
    const float* __restrict__ R, const float* __restrict__ t,
    const float* __restrict__ p1h, const float* __restrict__ p2h,
    const float* __restrict__ seg_dir) {
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    o.K[k] = KinvT[9 * i + k];
    o.R[k] = R[9 * i + k];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o.t[k] = t[3 * i + k];
    o.p1[k] = p1h[3 * i + k];
    o.p2[k] = p2h[3 * i + k];
  }
  o.d[0] = seg_dir[2 * i];
  o.d[1] = seg_dir[2 * i + 1];
}

// torch's clamp_min and clamp keep a NaN, where fmaxf and fminf drop it
__device__ __forceinline__ float at_least(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// l = K^-T (R m + t x (R v)), bundling._mv3 and geometry.cross
__device__ __forceinline__ void project(const Obs& o, const float* m,
                                        const float* v, float* l) {
  float Rm[3], Rv[3], n[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    Rm[i] = dot3(o.R + 3 * i, m);
    Rv[i] = dot3(o.R + 3 * i, v);
  }
  n[0] = Rm[0] + (o.t[1] * Rv[2] - o.t[2] * Rv[1]);
  n[1] = Rm[1] + (o.t[2] * Rv[0] - o.t[0] * Rv[2]);
  n[2] = Rm[2] + (o.t[0] * Rv[1] - o.t[1] * Rv[0]);
#pragma unroll
  for (int i = 0; i < 3; ++i) l[i] = dot3(o.K + 3 * i, n);
}

__device__ __forceinline__ float huber_w(float r) {
  const float a = fabsf(r);
  return sqrtf(a <= kHuber ? 1.0f : kHuber / at_least(a, kEps));
}

// Plücker (m, v) of the parameters and their tangents along s1, s2, s3
// and w: rows 0 (value), 1-3 and 4 (bundling._frame_tangents)
struct Frame {
  float m[5][3], v[5][3];
};

__device__ __forceinline__ void frame_tangents(const float* p, Frame& f) {
  const float s1 = p[0], s2 = p[1], s3 = p[2];
  const float n = 1.0f + s1 * s1 + s2 * s2 + s3 * s3;
  const float N0[3] = {1.0f + s1 * s1 - s2 * s2 - s3 * s3,
                       2.0f * (s1 * s2 + s3), 2.0f * (s1 * s3 - s2)};
  const float N1[3] = {2.0f * (s1 * s2 - s3),
                       1.0f - s1 * s1 + s2 * s2 - s3 * s3,
                       2.0f * (s2 * s3 + s1)};
  const float dN0[3][3] = {{2.0f * s1, 2.0f * s2, 2.0f * s3},
                           {-2.0f * s2, 2.0f * s1, -2.0f},
                           {-2.0f * s3, 2.0f, 2.0f * s1}};
  const float dN1[3][3] = {{2.0f * s2, -2.0f * s1, 2.0f},
                           {2.0f * s1, 2.0f * s2, 2.0f * s3},
                           {-2.0f, -2.0f * s3, 2.0f * s2}};
  const float dn[3] = {2.0f * s1, 2.0f * s2, 2.0f * s3};
  const float inv_n = 1.0f / n;
  float sw, cw;
  sincosf(p[3], &sw, &cw);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float u0 = N0[i] * inv_n, u1 = N1[i] * inv_n;
    f.m[0][i] = cw * u0;
    f.v[0][i] = sw * u1;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      f.m[1 + k][i] = cw * ((dN0[k][i] - u0 * dn[k]) * inv_n);
      f.v[1 + k][i] = sw * ((dN1[k][i] - u1 * dn[k]) * inv_n);
    }
    f.m[4][i] = -sw * u0;
    f.v[4][i] = cw * u1;
  }
}

// One observation's IRLS-weighted J^T J (upper triangle, row by row) and
// g added to the lane's sums (bundling._res_and_jac, _huber_w)
__device__ __forceinline__ void add_normal(const Obs& o, const Frame& f,
                                           float* JTJ, float* g) {
  float l[5][3];
#pragma unroll
  for (int r = 0; r < 5; ++r) project(o, f.m[r], f.v[r], l[r]);
  const float l0 = l[0][0], l1 = l[0][1];
  const float norm = sqrtf(l0 * l0 + l1 * l1);
  const float inv = 1.0f / at_least(norm, kEps);
  const float inv3 = inv * inv * inv;
  const float cr = -l1 * o.d[1] - l0 * o.d[0];
  const float cross = cr * inv;
  const float sinang = fabsf(cross);
  const bool inside = sinang <= kTop;
  const float x = sinang > kTop ? kTop : sinang;
  const float sign = cross > 0.0f ? 1.0f : (cross < 0.0f ? -1.0f : 0.0f);
  const float wgt = expf(2.0f * asinf(x));
  const float root = sqrtf(1.0f - x * x);
  float dinv[4], dwgt[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float dl0 = l[1 + k][0], dl1 = l[1 + k][1];
    dinv[k] = norm > kEps ? -(l0 * dl0 + l1 * dl1) * inv3 : 0.0f;
    const float dcross = (-dl1 * o.d[1] - dl0 * o.d[0]) * inv + cr * dinv[k];
    const float dx = inside ? sign * dcross : 0.0f;
    dwgt[k] = 2.0f * wgt * dx / root;
  }
  float J[2][4], rw[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float* ph = e == 0 ? o.p1 : o.p2;
    const float dot = dot3(l[0], ph);
    const float d = dot * inv;
    const float res = d * wgt;
    const float hw = huber_w(res);
    rw[e] = hw * res;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float dd = dot3(l[1 + k], ph) * inv + dot * dinv[k];
      J[e][k] = hw * (dd * wgt + d * dwgt[k]);
    }
  }
  int u = 0;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = a; b < 4; ++b, ++u)
      JTJ[u] += J[0][a] * J[0][b] + J[1][a] * J[1][b];
    g[a] += J[0][a] * rw[0] + J[1][a] * rw[1];
  }
}

// Plücker (m, v) of the parameters (bundling.plucker_from_params)
__device__ __forceinline__ void plucker(const float* p, float* m, float* v) {
  const float s1 = p[0], s2 = p[1], s3 = p[2];
  const float n = 1.0f + s1 * s1 + s2 * s2 + s3 * s3;
  float sw, cw;
  sincosf(p[3], &sw, &cw);
  m[0] = cw * ((1.0f + s1 * s1 - s2 * s2 - s3 * s3) / n);
  m[1] = cw * ((2.0f * (s1 * s2 + s3)) / n);
  m[2] = cw * ((2.0f * (s1 * s3 - s2)) / n);
  v[0] = sw * ((2.0f * (s1 * s2 - s3)) / n);
  v[1] = sw * ((1.0f - s1 * s1 + s2 * s2 - s3 * s3) / n);
  v[2] = sw * ((2.0f * (s2 * s3 + s1)) / n);
}

// One observation's robustified cost (bundling._obs_residual, _huber_w)
__device__ __forceinline__ float obs_cost(const Obs& o, const float* m,
                                          const float* v) {
  float l[3];
  project(o, m, v, l);
  const float inv = 1.0f / at_least(sqrtf(l[0] * l[0] + l[1] * l[1]), kEps);
  const float ldx = -l[1] * inv, ldy = l[0] * inv;
  const float sinang = fabsf(ldx * o.d[1] - ldy * o.d[0]);
  const float wgt =
      expf(2.0f * asinf(sinang > kTop ? kTop : at_least(sinang, 0.0f)));
  const float r1 = dot3(l, o.p1) * inv * wgt;
  const float r2 = dot3(l, o.p2) * inv * wgt;
  const float a = huber_w(r1) * r1, b = huber_w(r2) * r2;
  return a * a + b * b;
}

// The sum over the warp, the same bits in every lane
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

// x = A^-1 b by Gaussian elimination with partial pivoting; every index is
// a constant after unrolling, so A stays in registers
__device__ __forceinline__ void solve4(float A[4][4], float b[4],
                                       float x[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int i = k + 1; i < 4; ++i) {
      if (fabsf(A[i][k]) > fabsf(A[k][k])) {
#pragma unroll
        for (int j = k; j < 4; ++j) {
          const float s = A[i][j];
          A[i][j] = A[k][j];
          A[k][j] = s;
        }
        const float s = b[i];
        b[i] = b[k];
        b[k] = s;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 4; ++i) {
      const float f = A[i][k] / A[k][k];
#pragma unroll
      for (int j = k + 1; j < 4; ++j) A[i][j] -= f * A[k][j];
      b[i] -= f * b[k];
    }
  }
#pragma unroll
  for (int k = 3; k >= 0; --k) {
    float s = b[k];
#pragma unroll
    for (int j = k + 1; j < 4; ++j) s -= A[k][j] * x[j];
    x[k] = s / A[k][k];
  }
}

__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSm) lm_kernel(
    const float* __restrict__ params0,   // (C, 4)
    const int64_t* __restrict__ order,   // (O,) observations by cluster
    const int32_t* __restrict__ offsets, // (C + 1,) into order
    const float* __restrict__ KinvT,     // (O, 3, 3)
    const float* __restrict__ R,         // (O, 3, 3)
    const float* __restrict__ t,         // (O, 3)
    const float* __restrict__ p1h,       // (O, 3)
    const float* __restrict__ p2h,       // (O, 3)
    const float* __restrict__ seg_dir,   // (O, 2)
    int C, int iterations,
    float* __restrict__ params,          // (C, 4)
    int32_t* __restrict__ accepted) {    // (C,)
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= C) return;                    // the whole warp
  const int lo = offsets[c];
  const int n = offsets[c + 1] - lo;

  Obs mine;
  if (lane < n)
    load_obs(mine, order[lo + lane], KinvT, R, t, p1h, p2h, seg_dir);
  // f on each of the lane's observations, in order
  auto each = [&](auto&& f) {
    if (lane < n) f(mine);
    for (int j = lane + 32; j < n; j += 32) {
      Obs o;
      load_obs(o, order[lo + j], KinvT, R, t, p1h, p2h, seg_dir);
      f(o);
    }
  };
  // the cost at p, summed over the cluster in the same order every time
  auto cost = [&](const float* p) {
    float m[3], v[3];
    plucker(p, m, v);
    float s = 0.0f;
    each([&](const Obs& o) { s += obs_cost(o, m, v); });
    return warp_sum(s);
  };

  float p[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) p[k] = params0[4 * c + k];
  float lam = 1e-3f;
  float c_old = cost(p);
  float JTJ[10], g[4];
  bool stale = true;                     // J^T J and g not yet at p
  int steps = 0;
  for (int it = 0; it < iterations; ++it) {
    if (stale) {
      Frame f;
      frame_tangents(p, f);
#pragma unroll
      for (int u = 0; u < 10; ++u) JTJ[u] = 0.0f;
#pragma unroll
      for (int a = 0; a < 4; ++a) g[a] = 0.0f;
      each([&](const Obs& o) { add_normal(o, f, JTJ, g); });
#pragma unroll
      for (int u = 0; u < 10; ++u) JTJ[u] = warp_sum(JTJ[u]);
#pragma unroll
      for (int a = 0; a < 4; ++a) g[a] = warp_sum(g[a]);
      stale = false;
    }
    float A[4][4], b[4], delta[4], q[4];
    int u = 0;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int bb = a; bb < 4; ++bb, ++u) A[a][bb] = A[bb][a] = JTJ[u];
      b[a] = g[a];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) A[a][a] += lam * at_least(A[a][a], 1e-8f);
    solve4(A, b, delta);
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = p[k] - delta[k];
    const float c_new = cost(q);
    if (c_new < c_old) {                 // the same in every lane
#pragma unroll
      for (int k = 0; k < 4; ++k) p[k] = q[k];
      c_old = c_new;
      lam *= 0.33f;
      stale = true;
      ++steps;
    } else {
      lam *= 3.0f;
    }
    lam = fminf(fmaxf(lam, 1e-9f), 1e6f);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) params[4 * c + k] = p[k];
    accepted[c] = steps;
  }
}

}  // namespace

extern "C" int l3d_lm_optimize(
    const float* params0, const int64_t* order, const int32_t* offsets,
    const float* KinvT, const float* R, const float* t, const float* p1h,
    const float* p2h, const float* seg_dir, int C, int iterations,
    float* params, int32_t* accepted, void* stream) {
  if (C < 0 || iterations < 0) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const int blocks = (C + kWarps - 1) / kWarps;
  lm_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      params0, order, offsets, KinvT, R, t, p1h, p2h, seg_dir, C,
      iterations, params, accepted);
  return (int)cudaGetLastError();
}
