// K2: 3D hypothesis scoring of the match table.
//
// Replaces line3dpp_tpu/ops/scoring_pallas.py:_kernel (score_matches_pallas)
// and computes the semantics of the XLA path,
// line3dpp_tpu/ops/scoring.py:_score_chunk, with acosf for both the
// orientation gate and the pairwise angle (the Pallas kernel's polynomial
// acos and |cos| gate are TPU workarounds).  For every match slot m of a
// segment: the hypothesis P = C + r d, the orientation gate
// ang(ray_mid, dir) in (pi/32, 31pi/32), the regularisers reg = (d k)^2 +
// (|P - C_tgt| k_tgt)^2; then over the slots j of every other neighbour
// group, min(sim_angle, sim_position) cut at min_similarity, the maximum per
// group (one target camera), summed over the groups.
//
// One design serves every M = N * k the device memory holds (the
// reference's kNN <= 0 gives M = N * S).  What bounds it on the H100 at the
// cells' M = 160: instruction issue.  A pair (m, j) of valid slots in
// different groups passes only when min(sim_a, sim_p) > min_similarity,
// which almost no pair does (the 26 bundled views: 354 M valid pairs), and
// the exact similarity costs one acosf, three expf and three IEEE
// divisions.  On an all-matches block the zeros (5 B a slot, 2.16 GB on a
// block of 3 views) and the validity read bound it.  Design:
//  * a block of SEG_WARPS warps per segment (score_all_kernel) writes the
//    zeros of its score and validity rows with 16-byte stores and lists its
//    valid slots by reading the validity row 16 bytes a thread (the set
//    bytes ranked by the block's prefix over the threads' counts).  It runs
//    the set-up (slot_setup: hypothesis, orientation gate, regularisers) on
//    those slots only, a slot a thread, compacting the slots that pass the
//    gate, with their group, in ascending slot order into records of 36 B
//    in shared memory (room for `records`).  A segment with no valid slot
//    costs its validity read and the zero writes;
//  * the pair step (pair_step): lanes are own records (32 at a time, the
//    block's warps sharing them); all records are broadcast from shared
//    memory as partners, 32 at a time, through a branch-free pre-test
//    (below) that sets one bit per partner of another group that the exact
//    path might pass; then each lane takes its surviving partners in
//    ascending order, so the warp runs the exact path as often as its
//    busiest lane.  On the 26 bundled views the depth test keeps 0.2% of
//    the pairs and the angle test 53%, 3.6% of the warp steps (32 own
//    slots, one partner) have a surviving lane (chip_smoke.pretest_counts),
//    and on an H100 the flat walk over all partners beat a walk group by
//    group, whose loop per group cost more than its pre-tests;
//  * the exact path is the plain version's expressions unchanged
//    (__fmul_rn/__fadd_rn/__fdiv_rn, acosf, expf, the fold at 90 degrees,
//    sim > min_similarity, the per-group fmaxf), and the groups are summed
//    in ascending order with add_rn.  A group without a passing pair adds
//    0.0, which changes no bit, so skipping it is exact: score3d and valid
//    equal the plain version's bit for bit;
//  * a segment with more valid slots than its room is flagged and finished
//    by the overflow path (score_overflow_kernel), persistent blocks
//    launched behind it that read the flagged count on the device and keep
//    the records in a per-block region of a global scratch: no counting
//    pass, no host read.
//
// The pre-test's margin.  With ms = min_similarity in (0, 1), L = -ln ms,
// tsa = two_sig_a_sqr > 0, the exact path passes a pair only if each of
// expf(q) > ms for q = -fl(fl(e e) / den) (both depths) and q = -fl(fl(ang
// ang) / tsa).  CUDA's expf is within 2 ulp (CUDA Math API), so expf(q) <=
// e^q (1 + 2^-22), hence q > -L - 2^-22, and a correctly rounded quotient
// gives fl(e e) < den (L + 2^-22) / (1 - 2^-24) and likewise for ang^2.
//  * Depth: the pre-test squares the same e = fl(d1 - d1_j) as the exact
//    path and rejects only when fl(e e) > fl(den lp), lp = (L + 2^-20)(1 +
//    2^-20) rounded up to float on the host (in double); fl(den lp) >= den
//    lp (1 - 2^-24) lies above the bound.  den >= 1e-12 keeps it normal.
//  * Angle: the computed, folded angle is then below A = sqrt(tsa (L +
//    2^-22)) / (1 - 2^-24) degrees.  acosf is within 2 ulp, the float DEG
//    and the product add 2^-24 each, the fold at 90 degrees 180 * 2^-21, so
//    the true angle between the lines is below theta' = A (1 + 2^-12) +
//    2^-10 degrees, and |c| > cos theta' for the exact dot c (a clamped |c|
//    = 1 passes too).  The pre-test's dot p (FMAs) and the exact path's dot
//    each lie within 3 * 2^-24 (1 + 2^-21)^2 of the real dot of the two
//    unit vectors, so |p| > cos theta' - 2^-21, and it rejects only when
//    |p| < cos_lo = cos theta' - 2^-18, rounded down.  theta' >= 90
//    degrees: cos_lo = -1, no angle test.
//  * Switches: ms <= 0 (or ms < 2^-100, where expf's results are
//    subnormal, or tsa not positive and finite): cos_lo = -1, lp = +inf,
//    every pair survives.  ms >= 1: sim <= 1 never passes, lp = -1 rejects
//    every pair.  A NaN in the pre-test fails every comparison: kept.
// ops/scoring.py: pretest_thresholds computes cos_lo and lp, and
// pretest_keeps_plain is the same test in torch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float EPS = 1e-12f;
constexpr float PI_1_32 = 0.098174771f;   // reference: commons.h:99
constexpr float PI_31_32 = 3.043417886f;  // reference: commons.h:100
constexpr float DEG = 57.29577951308232f; // 180 / pi

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ float dot3(float a0, float a1, float a2,
                                      float b0, float b1, float b2) {
  return add_rn(add_rn(mul_rn(a0, b0), mul_rn(a1, b1)), mul_rn(a2, b2));
}

__device__ __forceinline__ float clamp1(float x) { return fminf(fmaxf(x, -1.0f), 1.0f); }

constexpr size_t SMEM = 48 << 10; // without the opt-in for more
constexpr unsigned FULL = 0xffffffffu;
constexpr int RECORDS_MAX = 6144; // most records a segment in shared memory

// The set-up of valid slot m of segment vs (view v): the hypothesis, the
// orientation gate, the regularisers (the plain version's expressions).
// Returns whether the slot passes; a = (dx, dy, dz, d1), b = (d2, -, den1,
// den2).
__device__ __forceinline__ bool slot_setup(
    int64_t o, int m, int v, int64_t vs, int N, int knn,
    const float* __restrict__ d_p1, const float* __restrict__ d_p2,
    const float* __restrict__ ray1, const float* __restrict__ ray2,
    const float* __restrict__ raym, const float* __restrict__ C,
    const float* __restrict__ k_reg, const float* __restrict__ tgt_C,
    const float* __restrict__ tgt_k, int check_orientation, float4& ea,
    float4& eb) {
  const float d1 = d_p1[o];
  const float d2 = d_p2[o];
  const float* r1 = ray1 + vs * 3;
  const float* r2 = ray2 + vs * 3;
  const float cx = C[v * 3], cy = C[v * 3 + 1], cz = C[v * 3 + 2];
  // hypothesis endpoints (view.cc:356-371)
  const float a1x = add_rn(cx, mul_rn(r1[0], d1));
  const float a1y = add_rn(cy, mul_rn(r1[1], d1));
  const float a1z = add_rn(cz, mul_rn(r1[2], d1));
  const float a2x = add_rn(cx, mul_rn(r2[0], d2));
  const float a2y = add_rn(cy, mul_rn(r2[1], d2));
  const float a2z = add_rn(cz, mul_rn(r2[2], d2));
  const float vx = sub_rn(a2x, a1x), vy = sub_rn(a2y, a1y), vz = sub_rn(a2z, a1z);
  const float len = __fsqrt_rn(dot3(vx, vy, vz, vx, vy, vz));
  const float inv = div_rn(1.0f, fmaxf(len, EPS));
  const float dx = mul_rn(vx, inv);
  const float dy = mul_rn(vy, inv);
  const float dz = mul_rn(vz, inv);
  bool ok = len > EPS;
  if (check_orientation) {
    // ray-vs-hypothesis angle in (pi/32, 31pi/32) (line3D.cc:811-858)
    const float* rm = raym + vs * 3;
    const float ang = acosf(clamp1(dot3(rm[0], rm[1], rm[2], dx, dy, dz)));
    ok = ok && ang > PI_1_32 && ang < PI_31_32;
  }
  // regularisers of the scored match (line3D.cc:1235-1248)
  const int g = m / knn;
  const float* tc = tgt_C + ((int64_t)v * N + g) * 3;
  const float tk = tgt_k[(int64_t)v * N + g];
  const float kv = k_reg[v];
  const float w1x = sub_rn(a1x, tc[0]), w1y = sub_rn(a1y, tc[1]), w1z = sub_rn(a1z, tc[2]);
  const float w2x = sub_rn(a2x, tc[0]), w2y = sub_rn(a2y, tc[1]), w2z = sub_rn(a2z, tc[2]);
  const float sig1 = mul_rn(d1, kv), sig2 = mul_rn(d2, kv);
  const float sig1t = mul_rn(__fsqrt_rn(dot3(w1x, w1y, w1z, w1x, w1y, w1z)), tk);
  const float sig2t = mul_rn(__fsqrt_rn(dot3(w2x, w2y, w2z, w2x, w2y, w2z)), tk);
  const float reg1 = add_rn(mul_rn(sig1, sig1), mul_rn(sig1t, sig1t));
  const float reg2 = add_rn(mul_rn(sig2, sig2), mul_rn(sig2t, sig2t));
  ea = make_float4(dx, dy, dz, d1);
  eb = make_float4(d2, 0.0f, fmaxf(reg1, EPS), fmaxf(reg2, EPS));
  return ok;
}

// One own slot of a lane, and its running sum over the groups.
struct Own {
  float dx, dy, dz, d1, d2, den1, den2;
  float thr1, thr2;  // the pre-test's depth thresholds (see the note)
  int g;
  float total, best;
  int cur;  // the group whose best is being taken
};

__device__ __forceinline__ Own own_slot(float4 a, float4 b, int g, float lp) {
  Own w;
  w.dx = a.x; w.dy = a.y; w.dz = a.z; w.d1 = a.w;
  w.d2 = b.x; w.den1 = b.z; w.den2 = b.w;
  w.thr1 = mul_rn(w.den1, lp);
  w.thr2 = mul_rn(w.den2, lp);
  w.g = g;
  w.total = 0.0f;
  w.best = 0.0f;
  w.cur = -1;
  return w;
}

// The pairs of own slot w (act: the lane has one) with the n <= 32 partners
// A[0, n) = (dx, dy, dz, d1), B[0, n) = (d2, group, den1, den2), the group
// as B.y's bits: a branch-free pre-test sets one bit per partner of another
// group that the exact path might pass; then each lane takes its survivors
// in ascending order, so the warp runs the exact path as often as its
// busiest lane, the groups come in ascending order and each group's best is
// added when the next group begins (line3D.cc:1250-1275, 1417-1446).
__device__ __forceinline__ void pair_step(
    const float4* A, const float4* B, int n, bool act, Own& w, float cos_lo,
    float two_sig_a_sqr, float min_similarity) {
  // false only where the exact path cannot pass (m, j); j of the own
  // group too.  The depth test, the selective one, comes first.
  auto pre = [&](int j) {
    const float4 pa = A[j];
    const float2 pb = *reinterpret_cast<const float2*>(B + j);
    const float p = fmaf(w.dz, pa.z, fmaf(w.dy, pa.y, w.dx * pa.x));
    const float e1 = sub_rn(w.d1, pa.w), e2 = sub_rn(w.d2, pb.x);
    return !((mul_rn(e1, e1) > w.thr1) | (mul_rn(e2, e2) > w.thr2) |
             (fabsf(p) < cos_lo) | (__float_as_int(pb.y) == w.g));
  };
  unsigned keep = 0;
  if (n == 32) {
#pragma unroll
    for (int u = 0; u < 32; ++u) keep |= (unsigned)pre(u) << u;
  } else {
    for (int u = 0; u < n; ++u) keep |= (unsigned)pre(u) << u;
  }
  if (!act) keep = 0;
  // the exact path, unchanged, for the survivors
  while (__any_sync(FULL, keep)) {
    if (keep) {
      const int j = __ffs(keep) - 1;
      keep &= keep - 1;
      const float4 pa = A[j];
      const float4 pb = B[j];
      const int g = __float_as_int(pb.y);
      if (g != w.cur) {
        // a group with no passing pair adds 0.0, which changes no bit
        w.total = add_rn(w.total, w.best);
        w.best = 0.0f;
        w.cur = g;
      }
      float ang = mul_rn(acosf(clamp1(dot3(w.dx, w.dy, w.dz, pa.x, pa.y, pa.z))), DEG);
      if (ang > 90.0f) ang = sub_rn(180.0f, ang);
      const float sim_a = expf(div_rn(mul_rn(-ang, ang), two_sig_a_sqr));
      const float e1 = sub_rn(w.d1, pa.w);
      const float e2 = sub_rn(w.d2, pb.x);
      const float sim_p = fminf(expf(div_rn(mul_rn(-e1, e1), w.den1)),
                                expf(div_rn(mul_rn(-e2, e2), w.den2)));
      const float sim = fminf(sim_a, sim_p);
      if (sim > min_similarity) w.best = fmaxf(w.best, sim);
    }
  }
}

constexpr int SEG_WARPS = 4;
constexpr int SEG_THREADS = 32 * SEG_WARPS;

// Zeros over p[0, n) by the block, 16-byte stores where aligned.
template <typename T>
__device__ __forceinline__ void zero_row(T* p, int64_t n) {
  constexpr int PER = 16 / sizeof(T);
  const int t = threadIdx.x;
  const int64_t a = ((16 - ((uintptr_t)p & 15)) & 15) / sizeof(T);
  const int64_t head = a < n ? a : n;
  if (t < head) p[t] = T(0);
  const int64_t body = (n - head) / PER;
  uint4* q = reinterpret_cast<uint4*>(p + head);
  for (int64_t i = t; i < body; i += SEG_THREADS)
    q[i] = make_uint4(0, 0, 0, 0);
  const int64_t done = head + body * PER;
  if (t < n - done) p[done + t] = T(0);
}

// The set bytes of a word of bools, one bit each.
__device__ __forceinline__ unsigned byte_bits(unsigned w) {
  const unsigned v = __vcmpne4(w, 0u) & 0x01010101u;
  return (v | v >> 7 | v >> 14 | v >> 21) & 15u;
}

// The block's prefix of one count a thread (a warp scan, then the warps'
// totals through shared memory, double-buffered by the caller's step
// parity): the count before this thread and the block's total.
__device__ __forceinline__ int block_prefix(int cnt, int (*wsum)[SEG_WARPS],
                                            int& parity, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += y;
  }
  int* w = wsum[parity];
  parity ^= 1;
  if (lane == 31) w[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int i = 0; i < SEG_WARPS; ++i) {
    before += i < warp ? w[i] : 0;
    total += w[i];
  }
  return before + incl - cnt;
}

// The valid slots of one row of bools, listed in ascending order into
// SL[0, min(count, cap)) by the block: 16 bytes a thread (2048 slots a
// block step) where the row is aligned, a byte a thread at its ragged
// ends, ranked by the block's prefix over the threads' counts.  Returns
// the count.
__device__ __forceinline__ int list_valid(const uint8_t* row, int M,
                                          int32_t* SL, int cap,
                                          int (*wsum)[SEG_WARPS],
                                          int& parity) {
  const int t = threadIdx.x;
  const int a = (int)((16 - ((uintptr_t)row & 15)) & 15);
  const int head = a < M ? a : M;
  const int body = (M - head) / 16;
  const int tail0 = head + body * 16;
  int nv = 0;
  // one step: this thread's set bits, slot m0 + bit
  auto step = [&](unsigned bits, int m0) {
    int total;
    int r = nv + block_prefix(__popc(bits), wsum, parity, total);
    for (; bits; bits &= bits - 1, ++r)
      if (r < cap) SL[r] = m0 + __ffs(bits) - 1;
    nv += total;
  };
  step(t < head && row[t] != 0, t);
  const uint4* q = reinterpret_cast<const uint4*>(row + head);
  constexpr int U = 2;  // chunks a thread has in flight
  for (int c0 = 0; c0 < body; c0 += SEG_THREADS * U) {
    unsigned bits[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * SEG_THREADS + t;
      bits[u] = 0;
      if (c < body) {
        const uint4 x = __ldg(q + c);
        bits[u] = byte_bits(x.x) | byte_bits(x.y) << 4 |
                  byte_bits(x.z) << 8 | byte_bits(x.w) << 12;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      step(bits[u], head + (c0 + u * SEG_THREADS + t) * 16);
  }
  step(tail0 + t < M && row[tail0 + t] != 0, tail0 + t);
  return nv;
}

// Segment vs by one block: the zeros of its row (``zeros``), its valid
// slots listed, set up (slot_setup) a slot a thread and compacted in place
// in ascending slot order into its records A, B, SL (room for cap; returns
// false, with nothing but the zeros written, when the segment has more
// valid slots), then the pair step with the partners
// broadcast from the records, each warp taking every SEG_WARPS-th group of
// 32 own records, and each passing slot's score.
__device__ __forceinline__ bool score_segment(
    int64_t vs, const float* __restrict__ d_p1, const float* __restrict__ d_p2,
    const uint8_t* __restrict__ valid, const float* __restrict__ ray1,
    const float* __restrict__ ray2, const float* __restrict__ raym,
    const float* __restrict__ C, const float* __restrict__ k_reg,
    const float* __restrict__ tgt_C, const float* __restrict__ tgt_k, int S,
    int M, int N, int knn, float two_sig_a_sqr, float min_similarity,
    int check_orientation, float cos_lo, float lp, float4* A, float4* B,
    int32_t* SL, int cap, bool zeros, int (*wsum)[SEG_WARPS],
    float* __restrict__ score, uint8_t* __restrict__ ok_out) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int v = (int)(vs / S);
  const int64_t o0 = vs * M;
  if (zeros) {
    zero_row(score + o0, M);
    zero_row(ok_out + o0, M);
  }
  int parity = 0;
  const int nv = list_valid(valid + o0, M, SL, cap, wsum, parity);
  if (nv > cap) return false;  // the block's count: uniform
  __syncthreads();

  // set-up of the listed slots; those that pass move down to their rank
  // (every listed slot of a step is read before the prefix's barrier)
  int ng = 0;
  for (int i0 = 0; i0 < nv; i0 += SEG_THREADS) {
    const int i = i0 + t;
    bool ok = false;
    float4 ea, eb;
    int m = 0;
    if (i < nv) {
      m = SL[i];
      ok = slot_setup(o0 + m, m, v, vs, N, knn, d_p1, d_p2, ray1, ray2, raym,
                      C, k_reg, tgt_C, tgt_k, check_orientation, ea, eb);
      eb.y = __int_as_float(m / knn);
    }
    int total;
    const int r = ng + block_prefix(ok, wsum, parity, total);
    if (ok) {
      A[r] = ea;
      B[r] = eb;
      SL[r] = m;
    }
    ng += total;
  }
  __syncthreads();  // the records are read by every warp; the zeros precede

  // pairs: a lane per own record, the partners broadcast 32 at a time
  for (int q0 = warp * 32; q0 < ng; q0 += SEG_THREADS) {
    const int q = q0 + lane;
    const bool act = q < ng;
    const float4 b = B[act ? q : 0];
    Own w = own_slot(A[act ? q : 0], b, __float_as_int(b.y), lp);
    for (int cb = 0; cb < ng; cb += 32)
      pair_step(A + cb, B + cb, min(32, ng - cb), act, w, cos_lo,
                two_sig_a_sqr, min_similarity);
    w.total = add_rn(w.total, w.best);
    if (act) {
      score[o0 + SL[q]] = w.total;
      ok_out[o0 + SL[q]] = 1;
    }
  }
  return true;
}

// A block per segment, its records in shared memory (room for cap); a
// segment with more valid slots is flagged for score_overflow_kernel.
__global__ void __launch_bounds__(SEG_THREADS) score_all_kernel(
    const float* __restrict__ d_p1, const float* __restrict__ d_p2,
    const uint8_t* __restrict__ valid, const float* __restrict__ ray1,
    const float* __restrict__ ray2, const float* __restrict__ raym,
    const float* __restrict__ C, const float* __restrict__ k_reg,
    const float* __restrict__ tgt_C, const float* __restrict__ tgt_k, int S,
    int M, int N, int knn, float two_sig_a_sqr, float min_similarity,
    int check_orientation, float cos_lo, float lp, int cap,
    int32_t* __restrict__ flagged, int* __restrict__ n_flagged,
    float* __restrict__ score, uint8_t* __restrict__ ok_out) {
  extern __shared__ float4 recs[];  // A [cap], B [cap], then SL [cap]
  __shared__ int wsum[2][SEG_WARPS];
  const int64_t vs = blockIdx.x;
  const bool fits = score_segment(
      vs, d_p1, d_p2, valid, ray1, ray2, raym, C, k_reg, tgt_C, tgt_k, S, M,
      N, knn, two_sig_a_sqr, min_similarity, check_orientation, cos_lo, lp,
      recs, recs + cap, reinterpret_cast<int32_t*>(recs + 2 * (size_t)cap),
      cap, true, wsum, score, ok_out);
  if (!fits && threadIdx.x == 0)
    flagged[atomicAdd(n_flagged, 1)] = (int32_t)vs;
}

// Persistent blocks over the flagged segments (their count read on the
// device), each with records for M slots in its region of a global
// scratch; the zeros are score_all_kernel's.
__global__ void __launch_bounds__(SEG_THREADS) score_overflow_kernel(
    const float* __restrict__ d_p1, const float* __restrict__ d_p2,
    const uint8_t* __restrict__ valid, const float* __restrict__ ray1,
    const float* __restrict__ ray2, const float* __restrict__ raym,
    const float* __restrict__ C, const float* __restrict__ k_reg,
    const float* __restrict__ tgt_C, const float* __restrict__ tgt_k, int S,
    int M, int N, int knn, float two_sig_a_sqr, float min_similarity,
    int check_orientation, float cos_lo, float lp,
    const int32_t* __restrict__ flagged, const int* __restrict__ n_flagged,
    float4* __restrict__ rec_a, float4* __restrict__ rec_b,
    int32_t* __restrict__ rec_slot, float* __restrict__ score,
    uint8_t* __restrict__ ok_out) {
  __shared__ int wsum[2][SEG_WARPS];
  const int n = *n_flagged;
  const int64_t base = (int64_t)blockIdx.x * M;
  for (int i = blockIdx.x; i < n; i += gridDim.x) {
    score_segment(flagged[i], d_p1, d_p2, valid, ray1, ray2, raym, C, k_reg,
                  tgt_C, tgt_k, S, M, N, knn, two_sig_a_sqr, min_similarity,
                  check_orientation, cos_lo, lp, rec_a + base, rec_b + base,
                  rec_slot + base, M, false, wsum, score, ok_out);
    __syncthreads();  // the records are refilled for the next segment
  }
}

// Blocks of the overflow path.  Each holds records for M slots in the
// global scratch (36 B a slot: 13.8 MB for all of them at M = 48,000), and
// few segments pass the shared records (none on the all-matches block of
// the 26 views), so a few blocks, not a full card.
constexpr int OVERFLOW_BLOCKS = 8;

}  // namespace

// Blocks of the overflow path; each needs records for M slots (the scratch
// of l3d_score_matches).
extern "C" int64_t l3d_score_overflow_blocks() { return OVERFLOW_BLOCKS; }

// Any M = N * knn: records for min(records, M) valid slots a segment in
// shared memory; where that is below M, the segments with more are listed
// in ``flagged`` (room for V * S) with their count in ``n_flagged`` and
// finished by the overflow path behind it, whose records
// (l3d_score_overflow_blocks() * M of each array) are ``rec_a``,
// ``rec_b``, ``rec_slot``.
extern "C" int l3d_score_matches(
    const float* d_p1, const float* d_p2, const uint8_t* valid,
    const float* ray1, const float* ray2, const float* raym, const float* C,
    const float* k_reg, const float* tgt_C, const float* tgt_k, int V, int S,
    int M, int N, int knn, float two_sig_a_sqr, float min_similarity,
    int check_orientation, float cos_lo, float lp, int records,
    float4* rec_a, float4* rec_b, int32_t* rec_slot, int32_t* flagged,
    int* n_flagged, float* score, uint8_t* ok_out, void* stream) {
  if (M < 1 || knn < 1 || M != N * knn || records < 1 ||
      records > RECORDS_MAX)
    return (int)cudaErrorInvalidValue;
  const int cap = records < M ? records : M;
  const bool overflow = cap < M;
  if (overflow && (rec_a == nullptr || rec_b == nullptr ||
                   rec_slot == nullptr || flagged == nullptr ||
                   n_flagged == nullptr))
    return (int)cudaErrorInvalidValue;
  const int64_t VS = (int64_t)V * S;
  if (VS == 0) return 0;
  if (VS >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (overflow) cudaMemsetAsync(n_flagged, 0, sizeof(int), st);
  const size_t smem = (size_t)cap * (2 * sizeof(float4) + sizeof(int32_t));
  if (smem > SMEM)
    cudaFuncSetAttribute(score_all_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  score_all_kernel<<<(unsigned)VS, SEG_THREADS, smem, st>>>(
      d_p1, d_p2, valid, ray1, ray2, raym, C, k_reg, tgt_C, tgt_k, S, M, N,
      knn, two_sig_a_sqr, min_similarity, check_orientation, cos_lo, lp, cap,
      flagged, n_flagged, score, ok_out);
  if (overflow)
    score_overflow_kernel<<<OVERFLOW_BLOCKS, SEG_THREADS, 0, st>>>(
        d_p1, d_p2, valid, ray1, ray2, raym, C, k_reg, tgt_C, tgt_k, S, M,
        N, knn, two_sig_a_sqr, min_similarity, check_orientation, cos_lo, lp,
        flagged, n_flagged, rec_a, rec_b, rec_slot, score, ok_out);
  return (int)cudaGetLastError();
}
