// K1: epipolar line matching with the k best matches per source segment.
//
// Replaces line3dpp_tpu/ops/matching_pallas.py:_kernel (match_pairs_pallas)
// and computes the semantics of line3dpp_tpu/ops/matching.py:match_pair.
// For a view pair (src, tgt) and every segment pair (s, c): the parameters
// t1, t2 where the epipolar lines of the source endpoints cut the target
// segment, their mutual overlap (kept only where outer_px >= 1), the signs
// of the four plane-ray triangulation depths, and the k best valid matches
// of each source segment by overlap, ties to the lowest target index.
//
// One design serves every k (1 <= k <= S; k = S keeps every match, the
// reference's kNN <= 0).  What bounds it on the H100 at the cells' k:
// instruction issue.  Every candidate (s, c) costs about 36 f32 operations
// before its overlap is known.  P*S*S is 3.7e9 candidates over all 416 pair
// slots of the bundled 26-view scene; the kernel evaluates the valid pairs
// times the unmasked segments of both views, 2.48e9, against about 0.3 GB
// of input and output.  On that scene 2.7% of the candidates cross the
// target segment and 0.74% reach an overlap of 0.25, but a warp of 32
// source segments takes the slow path whenever one lane does: 18% of the
// (warp, target) steps have a lane that crosses
// (tests/measure_torch_k1_k4.py at 4ddabe5).  At k = S the writes bound
// it: 6 x (P, S, S) outputs and the validity, 25 B a slot.
//
//  * The scan (match_list_kernel): a thread per source segment, a block of
//    TILE sources of one pair.  The target view's float4 table (x1, y1,
//    x2 - x1, y2 - y1, zeros for masked targets and past S, which the
//    |e.dq| > eps test rejects) and its lengths stream through shared
//    memory in chunks of CHUNK with cp.async, double-buffered: chunk i + 1
//    is in flight while chunk i is scanned, and each target is a broadcast.
//  * The pre-test: t1, t2 from rcp.approx and one product, and a reject
//    only when even the most favourable values within a proven margin fail
//    the exact tests (pretest_keeps below).  The survivors run the exact
//    path, unchanged: products, sums and quotients in __fmul_rn/__fadd_rn/
//    __fdiv_rn (no FMA contraction) in the order of the plain torch version
//    (ops/matching.py:match_pairs_plain), so the selected set, its order
//    and the values stay bit for bit the plain version's.  The depth-sign
//    fields are read from device memory (L1/L2) on the rare pass path only.
//  * GROUP = 32 targets a step: their pre-tests are independent, and the
//    survivors of the step are then taken in index order, so a warp runs
//    the exact path once for each survivor of its busiest lane, not once
//    for each target that one lane keeps (on the card 4 targets a step
//    took 6.1 ms, 16 took 5.3, 32 took 5.1).
//  * The list: each thread keeps its matches in L = min(k, list_len) slots
//    of shared memory, slot-major.  For k <= L they are the exact top-k as
//    sorted keys (~overlap bits) << 32 | target, ascending = descending
//    overlap with ties to the lowest index, and a candidate must beat the
//    k-th key; for k > L the list holds every passing target in target
//    order, ranked when the row is written.  A writer warp beside the
//    scanning threads writes the zeros of the block's rows while they
//    scan; then a warp per row writes its kept slots, a lane per slot (the
//    first keys with their depths by winner_depths and the validity).
//  * The overflow path (match_all_kernel), for k > L: a row with more than
//    L matches is flagged and finished by a warp per flagged row that lists
//    every passing key by ballot (in shared memory up to LIST_SMEM keys,
//    then in a per-warp region of a global scratch) and sorts it, launched
//    behind the scan on a persistent grid that reads the flagged count on
//    the device.

// The pre-test's margin.  rcp.approx.f32 has an absolute error of at most
// 2^-23 on [1, 2] (PTX ISA), so a relative error below 2^-22 at any input
// with 1e-12 < |b| < 2^100 (its .ftz form changes nothing there); the product -a * r adds 2^-24 and the exact quotient
// fl(-a / b) differs from -a / b by 2^-24 more.  So |t - u| <= 2^-21 |u|
// (up to terms of 2^-40, and 2^-148 where the quotient is subnormal).  The
// pre-test widens each u by M = 2^-12 (|u1| + |u2|) + 2^-100, 512 times
// that, and every bound it computes from them is monotone in the exact
// values: hi <= hi_u + M, lo >= lo_u - M, so inner <= inner_ub and
// outer >= outer_lb as floats.  The exact path accepts only overlap =
// fl(inner / outer) > cut >= 0, hence inner > cut * outer >= cut *
// outer_lb in real numbers, and the pre-test rejects only when inner_ub <=
// (cut * outer_lb)(1 - 2^-20) - 2^-100, which lies below that.  A
// non-finite M or |e.dq| >= 2^100 is always kept.  ops/matching.py:
// pretest_keeps_plain is the same test in torch; the CPU tests hold it
// sound with every quotient moved by 2^-21 either way.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;   // source segments per block, one per thread
constexpr int CHUNK = 512;  // target float4s per shared-memory buffer
constexpr int GROUP = 32;   // targets pre-tested per step (CHUNK % GROUP == 0)
constexpr int ALL_WARPS = 4;        // overflow path: warps per block
constexpr int LIST_SMEM = 1024;     // overflow path: keys per warp in shared
constexpr float EPS = 1e-12f;
constexpr float MU = 0x1p-12f;            // pre-test margin, relative
constexpr float TINY = 0x1p-100f;         // pre-test margin, absolute
constexpr float SHRINK = 1.0f - 0x1p-20f;
constexpr float BIG_B = 0x1p100f;         // |e.dq| beyond: always kept
constexpr float FLT_BIG = 3.40282347e38f;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }

// one MUFU.RCP; for 1e-12 < |x| < 2^100, where the pre-test uses it, input
// and result are normal, so flushing subnormals changes nothing
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float dot3(float a0, float a1, float a2,
                                      float b0, float b1, float b2) {
  return add_rn(add_rn(mul_rn(a0, b0), mul_rn(a1, b1)), mul_rn(a2, b2));
}

// depth = num / den > 0 with a |den| > eps guard (line3D.cc:1187-1191)
__device__ __forceinline__ bool positive_depth(float num, float den) {
  return fabsf(den) > EPS && mul_rn(num, den) > 0.0f;
}

__device__ __forceinline__ float safe(float x) { return fabsf(x) > EPS ? x : EPS; }

struct Epi {
  float e1x, e1y, e1z, e2x, e2y, e2z;
};

// e . q1h and e . dqh of both epipolar lines (the plain version's order)
__device__ __forceinline__ void epi_dots(const Epi& e, float4 q, float& a1,
                                         float& b1, float& a2, float& b2) {
  a1 = add_rn(add_rn(mul_rn(e.e1x, q.x), mul_rn(e.e1y, q.y)), e.e1z);
  b1 = add_rn(mul_rn(e.e1x, q.z), mul_rn(e.e1y, q.w));
  a2 = add_rn(add_rn(mul_rn(e.e2x, q.x), mul_rn(e.e2y, q.y)), e.e2z);
  b2 = add_rn(mul_rn(e.e2x, q.z), mul_rn(e.e2y, q.w));
}

// False only where the exact path must reject the candidate (see the note
// at the top for the margin).  u1, u2 approximate t1, t2; cut >= 0.
__device__ __forceinline__ bool pretest_keeps(float u1, float u2, float cut) {
  const float M = add_rn(mul_rn(MU, add_rn(fabsf(u1), fabsf(u2))), TINY);
  const float lo = fminf(u1, u2), hi = fmaxf(u1, u2);
  const float inner_ub = sub_rn(fminf(add_rn(hi, M), 1.0f),
                                fmaxf(sub_rn(lo, M), 0.0f));
  const float outer_lb = sub_rn(fmaxf(sub_rn(hi, M), 1.0f),
                                fminf(add_rn(lo, M), 0.0f));
  const float thresh = sub_rn(mul_rn(mul_rn(cut, outer_lb), SHRINK), TINY);
  return !((inner_ub <= thresh) & (M <= FLT_BIG));
}

// The source segment's fields the exact path reads (zeros when inactive).
struct Src {
  Epi e;
  float p1x, p1y, p1z, p2x, p2y, p2z;  // endpoint rays
  float nsx, nsy, nsz, ntg;            // plane normal, n_src . (C_src - C_tgt)
};

__device__ __forceinline__ Src load_src(const float* e1t, const float* e2t,
                                        const float* ray1, const float* ray2,
                                        const float* nrm,
                                        const float* num_tgt, int64_t ps,
                                        int64_t src_row, int s) {
  const int64_t a = (ps + s) * 3, b = (src_row + s) * 3;
  Src r;
  r.e = Epi{e1t[a], e1t[a + 1], e1t[a + 2], e2t[a], e2t[a + 1], e2t[a + 2]};
  r.p1x = ray1[b]; r.p1y = ray1[b + 1]; r.p1z = ray1[b + 2];
  r.p2x = ray2[b]; r.p2y = ray2[b + 1]; r.p2z = ray2[b + 2];
  r.nsx = nrm[b]; r.nsy = nrm[b + 1]; r.nsz = nrm[b + 2];
  r.ntg = num_tgt[ps + s];
  return r;
}

// The pre-test of one target: false only where the exact path must reject.
__device__ __forceinline__ bool pretest_target(const Epi& e, float4 q,
                                               float cut) {
  float a1, b1, a2, b2;
  epi_dots(e, q, a1, b1, a2, b2);
  const float ab1 = fabsf(b1), ab2 = fabsf(b2);
  // no branch: the whole test is selects
  const bool z = (ab1 > EPS) & (ab2 > EPS);
  const bool big = fmaxf(ab1, ab2) >= BIG_B;
  const bool loose = pretest_keeps(mul_rn(-a1, rcp_approx(b1)),
                                   mul_rn(-a2, rcp_approx(b2)), cut);
  return z & (big | loose);
}

// The exact path's overlap of a target that passed the pre-test (so |e.dq|
// > eps): false where inner < -eps or outer_px < 1 rejects it; seglen()
// gives the target's length, read only when inner passes.
template <typename Len>
__device__ __forceinline__ bool exact_overlap_by(const Epi& e, float4 q,
                                                 Len seglen, float& overlap) {
  float a1, b1, a2, b2;
  epi_dots(e, q, a1, b1, a2, b2);
  const float t1 = div_rn(-a1, b1);
  const float t2 = div_rn(-a2, b2);
  // mutual overlap of {t1, t2, 0, 1} on the target line
  // (line3D.cc:1086-1165)
  const float lo = fminf(t1, t2), hi = fmaxf(t1, t2);
  const float outer = sub_rn(fmaxf(hi, 1.0f), fminf(lo, 0.0f));
  const float inner = sub_rn(fminf(hi, 1.0f), fmaxf(lo, 0.0f));
  if (!(inner >= -EPS && mul_rn(outer, seglen()) >= 1.0f)) return false;
  overlap = div_rn(inner, fmaxf(outer, EPS));
  return true;
}

// ... with the length read from device memory
__device__ __forceinline__ bool exact_overlap(const Epi& e, float4 q,
                                              const float* seglen_g,
                                              float& overlap) {
  return exact_overlap_by(e, q, [=] { return __ldg(seglen_g); }, overlap);
}

// ... with the length given
__device__ __forceinline__ bool exact_overlap_len(const Epi& e, float4 q,
                                                  float seglen,
                                                  float& overlap) {
  return exact_overlap_by(e, q, [=] { return seglen; }, overlap);
}

// Plane-ray triangulation depth signs (line3D.cc:1168-1193) of target g.
__device__ __forceinline__ bool depth_signs_ok(const Src& r, float nsrc,
                                               const float* nrm,
                                               const float* ray1,
                                               const float* ray2, int64_t g) {
  const float* n3 = nrm + g * 3;
  const float* a3 = ray1 + g * 3;
  const float* b3 = ray2 + g * 3;
  const float nx = __ldg(n3), ny = __ldg(n3 + 1), nz = __ldg(n3 + 2);
  return positive_depth(nsrc, dot3(r.p1x, r.p1y, r.p1z, nx, ny, nz)) &&
         positive_depth(nsrc, dot3(r.p2x, r.p2y, r.p2z, nx, ny, nz)) &&
         positive_depth(r.ntg, dot3(r.nsx, r.nsy, r.nsz, __ldg(a3),
                                    __ldg(a3 + 1), __ldg(a3 + 2))) &&
         positive_depth(r.ntg, dot3(r.nsx, r.nsy, r.nsz, __ldg(b3),
                                    __ldg(b3 + 1), __ldg(b3 + 2)));
}

// The four depths of a winner, target g (row offset) with n_tgt . (C' - C)
// nsrc, recomputed from the global tables.
__device__ __forceinline__ void winner_depths(const Src& r, float nsrc,
                                              const float* nrm,
                                              const float* ray1,
                                              const float* ray2, int64_t g,
                                              float& dp1, float& dp2,
                                              float& dq1, float& dq2) {
  g *= 3;
  const float nx = nrm[g], ny = nrm[g + 1], nz = nrm[g + 2];
  dp1 = div_rn(nsrc, safe(dot3(r.p1x, r.p1y, r.p1z, nx, ny, nz)));
  dp2 = div_rn(nsrc, safe(dot3(r.p2x, r.p2y, r.p2z, nx, ny, nz)));
  dq1 = div_rn(r.ntg, safe(dot3(r.nsx, r.nsy, r.nsz, ray1[g], ray1[g + 1],
                                ray1[g + 2])));
  dq2 = div_rn(r.ntg, safe(dot3(r.nsx, r.nsy, r.nsz, ray2[g], ray2[g + 1],
                                ray2[g + 2])));
}

using Key = unsigned long long;  // a sort key (the shuffles take this type)
constexpr int LIST_PAD = TILE + 1;  // keys from one slot of the lists to the
                                    // next: a warp reading one row's slots
                                    // meets each bank at most twice
constexpr int LIST_MAX = 128;       // longest list the scan takes

// sort key: ascending = overlap descending (overlap > 0), index ascending
__device__ __forceinline__ Key match_key(float overlap, int32_t tc) {
  return ((Key)(~__float_as_uint(overlap)) << 32) | (uint32_t)tc;
}

__device__ __forceinline__ float key_overlap(Key key) {
  return __uint_as_float(~(uint32_t)(key >> 32));
}

// Zeros over q[0, n) by one warp, 16-byte stores where aligned (the
// outputs are 4-byte values).
__device__ __forceinline__ void zero_span(float* q, int64_t n, int lane) {
  int64_t h = (int64_t)(((16 - ((uintptr_t)q & 15)) & 15) >> 2);
  h = h < n ? h : n;
  if (lane < h) q[lane] = 0.0f;
  const int64_t body = (n - h) >> 2;
  float4* q4 = reinterpret_cast<float4*>(q + h);
  for (int64_t i = lane; i < body; i += 32)
    q4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int64_t done = h + (body << 2);
  if (lane < n - done) q[done + lane] = 0.0f;
}

// Zeros over q[0, n) bytes by one warp, 16-byte stores where aligned.
__device__ __forceinline__ void zero_bytes(uint8_t* q, int64_t n, int lane) {
  int64_t h = (int64_t)((16 - ((uintptr_t)q & 15)) & 15);
  h = h < n ? h : n;
  if (lane < h) q[lane] = 0;
  const int64_t body = (n - h) >> 4;
  uint4* q4 = reinterpret_cast<uint4*>(q + h);
  for (int64_t i = lane; i < body; i += 32) q4[i] = make_uint4(0, 0, 0, 0);
  const int64_t done = h + (body << 4);
  if (lane < n - done) q[done + lane] = 0;
}

// Barriers of the scan: its TILE scanning threads only (the writer warp
// does not take part), and all of its threads.
__device__ __forceinline__ void scan_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(TILE) : "memory");
}
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 2, %0;" ::"n"(TILE + 32) : "memory");
}

// The scan: a thread per source segment (the target table and the targets'
// lengths staged through shared memory and broadcast, so the exact path
// reads no device memory, GROUP targets pre-tested a step), each thread's
// kept matches in a list of L in shared memory, slot-major ([slot][thread]).
// k <= L: the list holds the exact top-k as sorted keys, a candidate must
// beat its k-th overlap (thr).  k > L: the list holds every passing target
// in target order (4 B a slot, so more blocks fit an SM), whose keys the
// write phase recomputes by the same exact path and ranks; a row with more
// than L is flagged and left to match_all_kernel.  A writer warp beside the
// TILE scanning threads writes the zeros of the block's rows (one
// contiguous span of each output) by 16-byte stores while they scan, so
// that the writes that bound k = S overlap the scan; then a warp per row
// writes the kept slots, a lane per slot.
__global__ void __launch_bounds__(TILE + 32) match_list_kernel(
    const float4* __restrict__ tq, const uint8_t* __restrict__ mask,
    const float* __restrict__ ray1, const float* __restrict__ ray2,
    const float* __restrict__ nrm, const float* __restrict__ seglen,
    const float* __restrict__ e1t, const float* __restrict__ e2t,
    const float* __restrict__ num_src, const float* __restrict__ num_tgt,
    const int32_t* __restrict__ src_idx, const int32_t* __restrict__ tgt_idx,
    const uint8_t* __restrict__ pair_valid, int S, int k, int L,
    float epipolar_overlap, int32_t* __restrict__ flagged,
    int* __restrict__ n_flagged, int32_t* __restrict__ out_idx,
    float* __restrict__ out_ov, float* __restrict__ out_dp1,
    float* __restrict__ out_dp2, float* __restrict__ out_dq1,
    float* __restrict__ out_dq2, uint8_t* __restrict__ out_ok) {
  extern __shared__ float4 dyn[];
  float4* buf = dyn;  // [2][CHUNK] targets
  float* lens = reinterpret_cast<float*>(dyn + 2 * CHUNK);  // [2][CHUNK]
  // the lists, slot-major [L][LIST_PAD]: k <= L sorted keys, k > L targets
  Key* lk = reinterpret_cast<Key*>(lens + 2 * CHUNK);
  int32_t* lix = reinterpret_cast<int32_t*>(lens + 2 * CHUNK);
  __shared__ int count[TILE];  // keys of each row; -1: flagged

  const int p = blockIdx.x;
  const int64_t ps = (int64_t)p * S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == TILE / 32) {
    // the writer warp: the zeros of the block's rows of every output
    const int64_t o = (ps + (int64_t)blockIdx.y * TILE) * k;
    const int64_t n = (int64_t)min(TILE, S - (int)blockIdx.y * TILE) * k;
    zero_span(reinterpret_cast<float*>(out_idx) + o, n, lane);
    zero_span(out_ov + o, n, lane);
    zero_span(out_dp1 + o, n, lane);
    zero_span(out_dp2 + o, n, lane);
    zero_span(out_dq1 + o, n, lane);
    zero_span(out_dq2 + o, n, lane);
    zero_bytes(out_ok + o, n, lane);
    block_sync();  // the zeros precede the kept slots
    return;
  }
  const int s = blockIdx.y * TILE + threadIdx.x;
  const int64_t src_row = (int64_t)src_idx[p] * S;
  const int64_t tgt_row = (int64_t)tgt_idx[p] * S;
  const bool pair_ok = pair_valid[p] != 0;  // uniform over the block
  bool live = pair_ok && s < S && mask[src_row + s] != 0;
  const bool bounded = k <= L;  // the list is the exact top-k
  Key* my = lk + threadIdx.x;
  int32_t* mix = lix + threadIdx.x;
  int n = 0;
  float thr = 0.0f;  // overlap a candidate must beat: the k-th best so far

  Src r{};
  if (live) r = load_src(e1t, e2t, ray1, ray2, nrm, num_tgt, ps, src_row, s);

  if (pair_ok) {
    const int nchunk = (S + CHUNK - 1) / CHUNK;
    const float4* tab = tq + tgt_row;
    const float* len = seglen + tgt_row;
    auto stage = [&](int chunk) {
      float4* dst = buf + (chunk & 1) * CHUNK;
      float* dl = lens + (chunk & 1) * CHUNK;
      const int base = chunk * CHUNK;
      for (int c = threadIdx.x; c < CHUNK; c += TILE) {
        const int t = base + c;
        cp_async16(dst + c, tab + min(t, S - 1), t < S);
        cp_async4(dl + c, len + min(t, S - 1), t < S);
      }
      cp_async_commit();
    };
    stage(0);
    for (int chunk = 0; chunk < nchunk; ++chunk) {
      if (chunk + 1 < nchunk) {
        stage(chunk + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      scan_sync();
      if (live) {
        const float4* cur = buf + (chunk & 1) * CHUNK;
        const float* cl = lens + (chunk & 1) * CHUNK;
        const int base = chunk * CHUNK;
        const int nt = min(CHUNK, S - base);
        for (int c = 0; c < nt && live; c += GROUP) {
          const float cut = fmaxf(epipolar_overlap, thr);
          unsigned keep = 0;
#pragma unroll
          for (int u = 0; u < GROUP; ++u)
            keep |= (unsigned)pretest_target(r.e, cur[c + u], cut) << u;
          while (keep) {
            const int u = __ffs(keep) - 1;
            keep &= keep - 1;
            const int32_t tc = base + c + u;
            const int64_t g = tgt_row + tc;
            float overlap;
            if (!exact_overlap_len(r.e, cur[c + u], cl[c + u], overlap))
              continue;
            if (!(overlap > epipolar_overlap && overlap > thr)) continue;
            if (!depth_signs_ok(r, __ldg(num_src + ps + tc), nrm, ray1, ray2,
                                g))
              continue;
            if (!bounded) {
              // every key, in target order; more than L: match_all_kernel's
              if (n == L) {
                live = false;
                break;
              }
              mix[n++ * LIST_PAD] = tc;
              continue;
            }
            // insert in ascending key order; a full top-k list drops its
            // last key (a later index never passes an equal overlap)
            const Key key = match_key(overlap, tc);
            int j = n < L ? n : L - 1;
            for (; j > 0 && my[(j - 1) * LIST_PAD] > key; --j)
              my[j * LIST_PAD] = my[(j - 1) * LIST_PAD];
            my[j * LIST_PAD] = key;
            if (n < L) ++n;
            if (n == L) thr = key_overlap(my[(L - 1) * LIST_PAD]);
          }
        }
      }
      scan_sync();  // the buffer is refilled two chunks later
    }
  }

  // the write phase: each row's source fields through the free buffer
  const bool over = pair_ok && s < S && mask[src_row + s] != 0 && !live;
  float* srcf = reinterpret_cast<float*>(buf);  // [16][TILE]
  const float f[16] = {r.e.e1x, r.e.e1y, r.e.e1z, r.e.e2x, r.e.e2y, r.e.e2z,
                       r.p1x, r.p1y, r.p1z, r.p2x, r.p2y, r.p2z,
                       r.nsx, r.nsy, r.nsz, r.ntg};
#pragma unroll
  for (int i = 0; i < 16; ++i) srcf[i * TILE + threadIdx.x] = f[i];
  count[threadIdx.x] = over ? -1 : n;
  if (over) flagged[atomicAdd(n_flagged, 1)] = (int32_t)(ps + s);
  block_sync();  // the stash is complete; the zeros precede the slots

  // k > L: a row's keys come back from its targets (the same exact path)
  // and are ranked in the warp's part of the buffer
  Key* wk = reinterpret_cast<Key*>(srcf + 16 * TILE) + warp * LIST_MAX;
  for (int i = 0; i < 32; ++i) {
    const int row = warp * 32 + i;
    const int sr = blockIdx.y * TILE + row;
    const int c = count[row];
    if (sr >= S || c < 0) continue;
    float g[16];
#pragma unroll
    for (int a = 0; a < 16; ++a) g[a] = srcf[a * TILE + row];
    Src w;
    w.e = Epi{g[0], g[1], g[2], g[3], g[4], g[5]};
    w.p1x = g[6]; w.p1y = g[7]; w.p1z = g[8];
    w.p2x = g[9]; w.p2y = g[10]; w.p2z = g[11];
    w.nsx = g[12]; w.nsy = g[13]; w.nsz = g[14]; w.ntg = g[15];
    const int64_t o = (ps + sr) * k;
    if (!bounded) {
      for (int j = lane; j < c; j += 32) {
        const int32_t idx = lix[j * LIST_PAD + row];
        const int64_t t = tgt_row + idx;
        float ovj;
        exact_overlap(w.e, __ldg(tq + t), seglen + t, ovj);
        wk[j] = match_key(ovj, idx);
      }
      __syncwarp();
    }
    for (int j = lane; j < c; j += 32) {  // the zeros are written
      int32_t idx;
      float ovj;
      int at = j;
      if (bounded) {
        const Key key = lk[j * LIST_PAD + row];
        idx = (int32_t)(uint32_t)key;
        ovj = key_overlap(key);
      } else {
        const Key key = wk[j];
        idx = (int32_t)(uint32_t)key;
        ovj = key_overlap(key);
        at = 0;
        for (int q = 0; q < c; ++q) at += wk[q] < key;
      }
      float dp1, dp2, dq1, dq2;
      winner_depths(w, num_src[ps + idx], nrm, ray1, ray2, tgt_row + idx,
                    dp1, dp2, dq1, dq2);
      out_idx[o + at] = idx;
      out_ov[o + at] = ovj;
      out_dp1[o + at] = dp1;
      out_dp2[o + at] = dp2;
      out_dq1[o + at] = dq1;
      out_dq2[o + at] = dq2;
      out_ok[o + at] = 1;
    }
    __syncwarp();  // the warp's keys are refilled for its next row
  }
}

// ---- the overflow path: a warp per flagged row (pair, source segment)

// The i-th key of a row's list: shared memory below LIST_SMEM, the warp's
// global region beyond.
struct KeyList {
  Key* sh;  // LIST_SMEM keys
  Key* gl;  // the warp's region of next_pow2(S) keys (nullptr: S <=
            // LIST_SMEM, never reached)
  __device__ __forceinline__ Key& operator[](int i) const {
    return i < LIST_SMEM ? sh[i] : gl[i];
  }
};

// Ascending bitonic sort of list[0, n2), n2 a power of two, by one warp.
__device__ void warp_bitonic(const KeyList& list, int n2, int lane) {
  for (int k2 = 2; k2 <= n2; k2 <<= 1) {
    for (int j = k2 >> 1; j > 0; j >>= 1) {
      for (int i = lane; i < n2; i += 32) {
        const int l = i ^ j;
        if (l > i) {
          const Key a = list[i], b = list[l];
          if ((a > b) == ((i & k2) == 0)) {
            list[i] = b;
            list[l] = a;
          }
        }
      }
      __syncwarp();
    }
  }
}

// Ascending bitonic sort of one key per lane over the warp (shuffles).
__device__ __forceinline__ Key lane_bitonic(Key v, int lane) {
#pragma unroll
  for (int k2 = 2; k2 <= 32; k2 <<= 1) {
#pragma unroll
    for (int j = k2 >> 1; j > 0; j >>= 1) {
      const Key o = __shfl_xor_sync(0xffffffffu, v, j);
      // the lower lane of the pair keeps the smaller key when ascending
      const bool lower = (lane & j) == 0;
      const bool up = (lane & k2) == 0;
      v = (lower == up) ? (v < o ? v : o) : (v < o ? o : v);
    }
  }
  return v;
}

// Persistent warps over the rows that match_list_kernel flagged (their
// count read on the device): a lane per target, 32 targets a step through
// the same pre-test and exact path; each passing candidate appends its key
// to the row's list in ascending target order (a ballot, no atomics); the
// list is sorted (shuffles up to 32 keys, a bitonic network over the list
// beyond) and its first k keys give the slots (the zeros after them are
// match_list_kernel's).
__global__ void __launch_bounds__(32 * ALL_WARPS) match_all_kernel(
    const float4* __restrict__ tq, const uint8_t* __restrict__ mask,
    const float* __restrict__ ray1, const float* __restrict__ ray2,
    const float* __restrict__ nrm, const float* __restrict__ seglen,
    const float* __restrict__ e1t, const float* __restrict__ e2t,
    const float* __restrict__ num_src, const float* __restrict__ num_tgt,
    const int32_t* __restrict__ src_idx, const int32_t* __restrict__ tgt_idx,
    const int32_t* __restrict__ flagged, const int* __restrict__ n_flagged,
    int S, int k, float epipolar_overlap, int cap, Key* __restrict__ scratch,
    int32_t* __restrict__ out_idx, float* __restrict__ out_ov,
    float* __restrict__ out_dp1, float* __restrict__ out_dp2,
    float* __restrict__ out_dq1, float* __restrict__ out_dq2,
    uint8_t* __restrict__ out_ok) {
  __shared__ Key lists[ALL_WARPS][LIST_SMEM];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t gw = (int64_t)blockIdx.x * ALL_WARPS + warp;
  const int64_t n_warps = (int64_t)gridDim.x * ALL_WARPS;
  const KeyList list{lists[warp],
                     scratch ? scratch + gw * (int64_t)cap : nullptr};
  // the pre-test's cut: every kept candidate has overlap > max(eo, 0)
  const float cut = fmaxf(epipolar_overlap, 0.0f);
  const unsigned below = (1u << lane) - 1u;
  const int rows = *n_flagged;

  for (int64_t i = gw; i < rows; i += n_warps) {
    const int64_t row = flagged[i];  // a valid pair, an unmasked source
    const int p = (int)(row / S), s = (int)(row % S);
    const int64_t ps = (int64_t)p * S;
    const int64_t src_row = (int64_t)src_idx[p] * S;
    const int64_t tgt_row = (int64_t)tgt_idx[p] * S;
    const Src r = load_src(e1t, e2t, ray1, ray2, nrm, num_tgt, ps, src_row,
                           s);
    int n = 0;  // keys in the list, in ascending target order
    for (int c0 = 0; c0 < S; c0 += 32) {
      const int32_t tc = c0 + lane;
      bool pass = false;
      float overlap = 0.0f;
      if (tc < S) {
        const int64_t g = tgt_row + tc;
        const float4 q = __ldg(tq + g);
        pass = pretest_target(r.e, q, cut) &&
               exact_overlap(r.e, q, seglen + g, overlap) &&
               overlap > epipolar_overlap && overlap > 0.0f &&
               depth_signs_ok(r, __ldg(num_src + ps + tc), nrm, ray1, ray2,
                              g);
      }
      const unsigned bal = __ballot_sync(0xffffffffu, pass);
      if (pass) list[n + __popc(bal & below)] = match_key(overlap, tc);
      n += __popc(bal);
    }
    __syncwarp();
    const int m = min(n, k);
    if (n <= 32) {
      // one key a lane; empty lanes hold the largest key
      Key v = lane < n ? list[lane] : ~0ull;
      v = lane_bitonic(v, lane);
      __syncwarp();
      if (lane < n) list[lane] = v;
    } else {
      int n2 = 64;
      while (n2 < n) n2 <<= 1;
      for (int j = n + lane; j < n2; j += 32) list[j] = ~0ull;
      __syncwarp();
      warp_bitonic(list, n2, lane);
    }
    __syncwarp();
    const int64_t o = (ps + s) * k;
    for (int j = lane; j < m; j += 32) {  // the zeros are the scan's
      const Key key = list[j];
      const int32_t idx = (int32_t)(uint32_t)key;
      const float ovj = key_overlap(key);
      float dp1, dp2, dq1, dq2;
      winner_depths(r, num_src[ps + idx], nrm, ray1, ray2, tgt_row + idx,
                    dp1, dp2, dq1, dq2);
      out_idx[o + j] = idx;
      out_ov[o + j] = ovj;
      out_dp1[o + j] = dp1;
      out_dp2[o + j] = dp2;
      out_dq1[o + j] = dq1;
      out_dq2[o + j] = dq2;
      out_ok[o + j] = 1;
    }
    __syncwarp();  // the list is refilled for the next row
  }
}

int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Blocks of the overflow path: every SM full.
int all_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, match_all_kernel,
                                                32 * ALL_WARPS, 0);
  return sms * (per_sm > 0 ? per_sm : 1);
}

}  // namespace

// The overflow path's global scratch: 8-byte keys (0 when S <= LIST_SMEM,
// where the lists stay in shared memory).
extern "C" int64_t l3d_match_all_scratch(int S) {
  if (S <= LIST_SMEM) return 0;
  return (int64_t)all_blocks() * ALL_WARPS * next_pow2(S);
}

// Any 1 <= knn <= S, with the slots' validity written beside the six
// outputs.  The scan keeps lists of L = min(knn, list_len) keys; for
// knn > L the rows past L are listed in ``flagged`` (room for P * S rows)
// with their count in ``n_flagged``, and the overflow path, launched behind
// it, finishes them (``scratch``: l3d_match_all_scratch(S) keys).
extern "C" int l3d_match_pairs(
    const float* tq, const uint8_t* mask, const float* ray1,
    const float* ray2, const float* nrm, const float* seglen,
    const float* e1, const float* e2, const float* num_src,
    const float* num_tgt, const int32_t* src_idx, const int32_t* tgt_idx,
    const uint8_t* pair_valid, int P, int S, int knn, float epipolar_overlap,
    int list_len, Key* scratch, int32_t* flagged, int* n_flagged,
    int32_t* out_idx, float* out_ov, float* out_dp1, float* out_dp2,
    float* out_dq1, float* out_dq2, uint8_t* out_ok, void* stream) {
  if (knn < 1 || knn > S || list_len < 1 || list_len > LIST_MAX ||
      ((uintptr_t)tq & 15))
    return (int)cudaErrorInvalidValue;
  if (P == 0 || S == 0) return 0;
  const int L = knn < list_len ? knn : list_len;
  const bool overflow = knn > L;
  if (overflow && (flagged == nullptr || n_flagged == nullptr ||
                   (S > LIST_SMEM && scratch == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float4* q4 = reinterpret_cast<const float4*>(tq);
  if (overflow) cudaMemsetAsync(n_flagged, 0, sizeof(int), st);
  const size_t smem = 2 * CHUNK * (sizeof(float4) + sizeof(float)) +
                      (size_t)L * LIST_PAD * (overflow ? 4 : 8);
  if (smem > (48 << 10))
    cudaFuncSetAttribute(match_list_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const dim3 grid(P, (S + TILE - 1) / TILE);
  match_list_kernel<<<grid, TILE + 32, smem, st>>>(
      q4, mask, ray1, ray2, nrm, seglen, e1, e2, num_src, num_tgt, src_idx,
      tgt_idx, pair_valid, S, knn, L, epipolar_overlap, flagged, n_flagged,
      out_idx, out_ov, out_dp1, out_dp2, out_dq1, out_dq2, out_ok);
  if (overflow)
    match_all_kernel<<<all_blocks(), 32 * ALL_WARPS, 0, st>>>(
        q4, mask, ray1, ray2, nrm, seglen, e1, e2, num_src, num_tgt,
        src_idx, tgt_idx, flagged, n_flagged, S, knn, epipolar_overlap,
        next_pow2(S), S > LIST_SMEM ? scratch : nullptr, out_idx, out_ov,
        out_dp1, out_dp2, out_dq1, out_dq2, out_ok);
  return (int)cudaGetLastError();
}
