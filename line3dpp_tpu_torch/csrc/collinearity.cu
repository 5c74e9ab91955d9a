// Collinearity edges: every view's collinear, non-overlapping segment pairs
// i < j whose 3D estimates agree, with their similarity weights, compacted
// in row-major (view, s1, s2) order.  One routine in two launches: a count
// pass, then (after a scan of the counts on the card) a write pass.
//
// Replaces no Pallas kernel: the JAX package's collinearity
// (line3dpp_tpu/ops/collinearity.py collinear_pairs, collinear_similarity)
// is jnp under XLA.  It takes the place of ops/collinearity.
// collinear_edges_plain, which works on dense (B, S, S) float32 planes two
// views at a time: ~250 launches, a nonzero and a host copy a batch, about
// 24 planes of 36 MB written and read again a view at S = 3000, 3256
// device events and 15 host syncs a call on the 26-view scene.
//
// What bounds it on the H100: operations.  The 26 views of 3000 segments
// have 1.17e8 pairs i < j; the exact 2D test of a pair (four point-to-line
// distances, the overlap projection, the masks) is about 60 float32
// operations, 7e9 in all: ~0.1 ms at 67 TFLOP/s.  The inputs are ~4 MB and
// the edges a few hundred KB.  The 3D similarity (~110 operations) runs
// only for pairs that pass the 2D test with both estimates valid, a few
// thousand.
//
// Design.  A block is (view, row tile, column tile >= row tile) of
// kTile x kTile pairs, so only the upper triangle is visited: the grid's x
// runs over the T (T + 1) / 2 tile pairs row tile by row tile, its y over
// the views.  Thread r keeps row segment r0 + r in registers (its line's
// dx, dy, x2 y1, y2 x1, clamped length and the pre-test's threshold); the
// column tile's eligible segments (masked in and with an estimate: only
// they can make an edge) are compacted in order into shared memory, their
// endpoints as float4s and their indices, by warp ballots and a prefix
// over the block's four warps, and read by every lane of a warp at once (a
// broadcast).  A row that is not eligible skips the loop, so a warp of
// such rows does no pair work.  On the 26 views 1.85e7 of the 1.17e8 pairs
// i < j are of two eligible segments.
// The pre-test: the numerators |dy px - dx py + x2 y1 - y2 x1| of the
// column's two endpoints against the row's line, computed as the exact
// test computes them, against thr = fl(fl(t Lc) (1 + 2^-20)) in place of
// the division and comparison fl(num / Lc) < t.  It never rejects a pair
// the exact test keeps: fl(num / Lc) < t implies num < t Lc (t is a float
// and rounding is monotone), and t Lc <= fl(t Lc) / (1 - 2^-24) <
// fl(fl(t Lc) (1 + 2^-20)) while fl(t Lc) is a normal float; below that,
// or for a NaN, thr is +inf and the exact test decides
// (chip_smoke.collinear_pretest_keeps, tests/test_torch_kernel_design.py).
// So the common path is ~12 operations a pair of eligible segments and no
// division.  A pair that
// passes takes the exact test in the plain path's order (the four
// distances, then the overlap), then the 3D similarity with both
// estimates recomputed from the inputs (the row's once).  The estimates
// are not staged with the endpoints: 16,633 pairs of the 26 views pass
// the 2D test, where staging would read 11 floats for every column of
// every block.
//
// The count pass writes each (view, row, column tile) piece's edge count;
// the diagonal block also writes the zeros of its rows' pieces left of
// the diagonal, so nothing needs a memset.  An inclusive scan of the
// counts in (view, row, column tile) order (torch.cumsum) gives each
// piece its end; the write pass recomputes only the pieces with edges and
// writes edge n of a piece at end - count + n, in column order.  The
// output is therefore in np.nonzero's order of the dense grid, and no
// atomics take part: two runs give the same bits.
//
// Same bits as the plain path: every operation is a float32 rounding of
// the plain path's expression, in its order (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn: no contraction into FMA), __fsqrt_rn for the
// square root that the plain path takes through float64 (correctly rounded
// both ways), the full-precision expf that torch.exp runs on the card, and
// torch's CUDA clamp, minimum and maximum, which keep a NaN.  Per-segment
// values (dx, dy, x2 y1, y2 x1, the clamped lengths, the 3D direction, the
// similarity denominators) are the same expressions once per segment.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;                      // rows and columns a block
constexpr float kEps = (float)1e-12;            // collinearity.EPS as torch
                                                // casts it to float32
constexpr float kMargin = 1.0f + 0x1p-20f;      // chip_smoke.CL_PRETEST_MARGIN
constexpr float kTiny = 0x1p-126f;              // the least normal float

// torch's CUDA clamp_min / clamp_max with a scalar and minimum / maximum:
// a NaN operand is returned
__device__ __forceinline__ float clamp_lo(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_hi(float v, float hi) {
  return v != v ? v : fminf(v, hi);
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// a segment's 2D line, as collinearity._point_line_dist2d forms it
struct Line {
  float x1, y1, x2, y2, dx, dy, x2y1, y2x1, lc;
};

__device__ __forceinline__ Line make_line(float4 s) {
  Line l;
  l.x1 = s.x;
  l.y1 = s.y;
  l.x2 = s.z;
  l.y2 = s.w;
  l.dx = __fsub_rn(s.z, s.x);
  l.dy = __fsub_rn(s.w, s.y);
  l.x2y1 = __fmul_rn(s.z, s.y);
  l.y2x1 = __fmul_rn(s.w, s.x);
  l.lc = clamp_lo(__fsqrt_rn(__fadd_rn(__fmul_rn(l.dx, l.dx),
                                       __fmul_rn(l.dy, l.dy))), kEps);
  return l;
}

// |dy px - dx py + x2 y1 - y2 x1|: the distance's numerator
__device__ __forceinline__ float numerator(const Line& l, float px, float py) {
  return fabsf(__fsub_rn(__fadd_rn(__fsub_rn(__fmul_rn(l.dy, px),
                                             __fmul_rn(l.dx, py)),
                                   l.x2y1),
                         l.y2x1));
}

// chip_smoke.collinear_pretest_threshold
__device__ __forceinline__ float pretest_threshold(float lc, float t) {
  const float tl = __fmul_rn(lc, t);
  return tl >= kTiny ? __fmul_rn(tl, kMargin) : INFINITY;
}

// collinearity.collinear_pairs for row segment a and column segment b, the
// column's two numerators against the row's line given
__device__ bool collinear(const Line& a, const Line& b, float n21, float n22,
                          float t) {
  // the four distances below t (dmax < t, NaN rejected)
  if (!(__fdiv_rn(numerator(b, a.x1, a.y1), b.lc) < t)) return false;
  if (!(__fdiv_rn(numerator(b, a.x2, a.y2), b.lc) < t)) return false;
  if (!(__fdiv_rn(n21, a.lc) < t)) return false;
  if (!(__fdiv_rn(n22, a.lc) < t)) return false;
  // a's endpoints projected on b: the intervals must not overlap
  const float len2 = clamp_lo(__fadd_rn(__fmul_rn(b.dx, b.dx),
                                        __fmul_rn(b.dy, b.dy)), kEps);
  const float t1 = __fdiv_rn(
      __fadd_rn(__fmul_rn(__fsub_rn(a.x1, b.x1), b.dx),
                __fmul_rn(__fsub_rn(a.y1, b.y1), b.dy)), len2);
  const float t2 = __fdiv_rn(
      __fadd_rn(__fmul_rn(__fsub_rn(a.x2, b.x1), b.dx),
                __fmul_rn(__fsub_rn(a.y2, b.y1), b.dy)), len2);
  const bool overlaps =
      clamp_lo(tmin(t1, t2), 0.0f) <= clamp_hi(tmax(t1, t2), 1.0f);
  return !overlaps;
}

// a segment's 3D estimate, as collinearity.collinear_similarity forms it
struct Est {
  float p1[3], p2[3], dir[3], den1, den2;
};

__device__ Est make_est(const float* __restrict__ P1,
                        const float* __restrict__ P2,
                        const float* __restrict__ d1,
                        const float* __restrict__ d2, int64_t g, float cut,
                        float kreg) {
  Est e;
  float dv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    e.p1[c] = P1[3 * g + c];
    e.p2[c] = P2[3 * g + c];
    dv[c] = __fsub_rn(e.p2[c], e.p1[c]);
  }
  const float lena = clamp_lo(
      __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(dv[0], dv[0]),
                                     __fmul_rn(dv[1], dv[1])),
                           __fmul_rn(dv[2], dv[2]))), kEps);
#pragma unroll
  for (int c = 0; c < 3; ++c) e.dir[c] = __fdiv_rn(dv[c], lena);
  const float s1 = __fmul_rn(tmin(d1[g], cut), kreg);
  const float s2 = __fmul_rn(tmin(d2[g], cut), kreg);
  e.den1 = clamp_lo(__fmul_rn(__fmul_rn(2.0f, s1), s1), kEps);
  e.den2 = clamp_lo(__fmul_rn(__fmul_rn(2.0f, s2), s2), kEps);
  return e;
}

// the distance of P to the 3D line through L0 along the unit dir
__device__ __forceinline__ float p2l(const float* P, const float* L0,
                                     const float* dir) {
  float w[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) w[c] = __fsub_rn(P[c], L0[c]);
  const float w2 = __fadd_rn(__fadd_rn(__fmul_rn(w[0], w[0]),
                                       __fmul_rn(w[1], w[1])),
                             __fmul_rn(w[2], w[2]));
  const float proj = __fadd_rn(__fadd_rn(__fmul_rn(w[0], dir[0]),
                                         __fmul_rn(w[1], dir[1])),
                               __fmul_rn(w[2], dir[2]));
  return __fsqrt_rn(clamp_lo(__fsub_rn(w2, __fmul_rn(proj, proj)), 0.0f));
}

__device__ __forceinline__ float gauss(float d, float den) {
  return expf(__fdiv_rn(__fmul_rn(-d, d), den));
}

// the weight of the pair (a, b): the least of the four endpoint terms
__device__ float similarity(const Est& a, const Est& b) {
  const float sim_a = tmin(gauss(p2l(a.p1, b.p1, b.dir), a.den1),
                           gauss(p2l(a.p2, b.p1, b.dir), a.den2));
  const float sim_b = tmin(gauss(p2l(b.p1, a.p1, a.dir), b.den1),
                           gauss(p2l(b.p2, a.p1, a.dir), b.den2));
  return tmin(sim_a, sim_b);
}

template <bool kWrite>
__global__ void __launch_bounds__(kTile) collinear_kernel(
    const float4* __restrict__ segs,      // (V, S) endpoints
    const uint8_t* __restrict__ mask,     // (V, S)
    const float* __restrict__ P1,         // (V, S, 3)
    const float* __restrict__ P2,         // (V, S, 3)
    const float* __restrict__ d1,         // (V, S)
    const float* __restrict__ d2,         // (V, S)
    const uint8_t* __restrict__ valid,    // (V, S)
    const float* __restrict__ k_reg,      // (V,)
    const float* __restrict__ cut,        // (V,)
    int S, int T, float t_px, float min_aff,
    int64_t* __restrict__ counts,         // (V, S, T)
    const int64_t* __restrict__ ends,     // (V, S, T), the write pass's
    int4* __restrict__ edges) {           // (E,) (view, s1, s2, weight bits)
  __shared__ float4 col[kTile];
  __shared__ int colj[kTile];
  __shared__ int warp_n[kTile / 32];
  const int v = blockIdx.y;
  int b = blockIdx.x, rt = 0;             // tile pairs, row tile by row tile
  while (b >= T - rt) {
    b -= T - rt;
    ++rt;
  }
  const int ct = rt + b;
  const bool diag = ct == rt;
  const int r = threadIdx.x;
  const int i = rt * kTile + r;           // this thread's row
  const int c0 = ct * kTile;
  const int ncol = min(kTile, S - c0);
  const int64_t vs = (int64_t)v * S;
  const int64_t piece = (vs + i) * T + ct;

  // the column tile's eligible segments, compacted in order
  const int64_t g = vs + c0 + r;
  const bool elig = r < ncol && mask[g] && valid[g];
  const unsigned ball = __ballot_sync(0xffffffffu, elig);
  const int lane = r & 31, warp = r >> 5;
  if (lane == 0) warp_n[warp] = __popc(ball);
  __syncthreads();
  int at = __popc(ball & ((1u << lane) - 1u)), neligible = 0;
#pragma unroll
  for (int w = 0; w < kTile / 32; ++w) {
    at += w < warp ? warp_n[w] : 0;
    neligible += warp_n[w];
  }
  if (elig) {
    col[at] = segs[g];
    colj[at] = c0 + r;
  }
  bool row_ok = i < S;
  int64_t n = 0, base = 0;
  if (kWrite) {
    if (row_ok) {
      n = counts[piece];
      base = ends[piece] - n;
    }
    row_ok = n > 0;
  } else if (row_ok && diag) {
    for (int k = 0; k < rt; ++k) counts[(vs + i) * T + k] = 0;
  }
  row_ok = row_ok && mask[vs + i] && valid[vs + i];
  // the barrier also publishes the staged column tile
  if (!__syncthreads_or(row_ok) || neligible == 0) {
    if (!kWrite && i < S) counts[piece] = 0;
    return;
  }

  int64_t m = 0;                          // edges of this piece so far
  if (row_ok) {
    const Line a = make_line(segs[vs + i]);
    const float thr = pretest_threshold(a.lc, t_px);
    const float kreg = k_reg[v], cv = cut[v];
    Est ea;
    bool have_a = false;
    for (int k = 0; k < neligible; ++k) {
      const float4 s = col[k];
      const int j = colj[k];
      if (j <= i) continue;               // pairs i < j only
      const float n21 = numerator(a, s.x, s.y);
      const float n22 = numerator(a, s.z, s.w);
      if (!(n21 <= thr && n22 <= thr)) continue;
      if (!collinear(a, make_line(s), n21, n22, t_px)) continue;
      if (!have_a) {
        ea = make_est(P1, P2, d1, d2, vs + i, cv, kreg);
        have_a = true;
      }
      const float w = similarity(ea, make_est(P1, P2, d1, d2, vs + j, cv,
                                              kreg));
      if (!(w > min_aff)) continue;
      if (kWrite) edges[base + m] = make_int4(v, i, j, __float_as_int(w));
      ++m;
    }
  }
  if (!kWrite && i < S) counts[piece] = m;
}

int launch(bool write, const float* segs, const uint8_t* mask,
           const float* P1, const float* P2, const float* d1, const float* d2,
           const uint8_t* valid, const float* k_reg, const float* cut, int V,
           int S, int T, float t_px, float min_aff, int64_t* counts,
           const int64_t* ends, int32_t* edges, void* stream) {
  if (V < 0 || S < 0 || V > 65535 || T != (S + kTile - 1) / kTile)
    return (int)cudaErrorInvalidValue;
  if (V == 0 || S == 0) return 0;
  const dim3 grid((unsigned)((int64_t)T * (T + 1) / 2), (unsigned)V);
  const float4* s4 = reinterpret_cast<const float4*>(segs);
  int4* e4 = reinterpret_cast<int4*>(edges);
  if (write)
    collinear_kernel<true><<<grid, kTile, 0, (cudaStream_t)stream>>>(
        s4, mask, P1, P2, d1, d2, valid, k_reg, cut, S, T, t_px, min_aff,
        counts, ends, e4);
  else
    collinear_kernel<false><<<grid, kTile, 0, (cudaStream_t)stream>>>(
        s4, mask, P1, P2, d1, d2, valid, k_reg, cut, S, T, t_px, min_aff,
        counts, ends, e4);
  return (int)cudaGetLastError();
}

}  // namespace

// 9 inputs (segments (V, S, 4), mask, P1, P2, d1, d2, valid, k_reg, cut),
// V S T, t_px min_affinity, counts (V, S, T) written, stream
extern "C" int l3d_collinear_count(
    const float* segs, const uint8_t* mask, const float* P1, const float* P2,
    const float* d1, const float* d2, const uint8_t* valid,
    const float* k_reg, const float* cut, int V, int S, int T, float t_px,
    float min_aff, int64_t* counts, void* stream) {
  return launch(false, segs, mask, P1, P2, d1, d2, valid, k_reg, cut, V, S,
                T, t_px, min_aff, counts, nullptr, nullptr, stream);
}

// the same inputs, the counts and their inclusive scan, the (E, 4) int32
// edges written, stream
extern "C" int l3d_collinear_write(
    const float* segs, const uint8_t* mask, const float* P1, const float* P2,
    const float* d1, const float* d2, const uint8_t* valid,
    const float* k_reg, const float* cut, int V, int S, int T, float t_px,
    float min_aff, const int64_t* counts, const int64_t* ends,
    int32_t* edges, void* stream) {
  return launch(true, segs, mask, P1, P2, d1, d2, valid, k_reg, cut, V, S,
                T, t_px, min_aff, const_cast<int64_t*>(counts), ends, edges,
                stream);
}
