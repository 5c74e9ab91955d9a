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
// What bounds it on the H100: arithmetic.  Every candidate (s, c) costs
// about 36 f32 operations before its overlap is known (P*S*S candidates,
// about 3.7e9 on the bundled 26-view scene), against about 0.3 GB of
// output.  Design:
//  * one thread per source segment (128 per block) keeps its epipolar
//    lines, rays, plane normal and its top-k list in registers; the list is
//    sorted and insertion is fully unrolled over KMAX slots, so it never
//    touches local memory;
//  * the target segments of the pair stream through shared memory in
//    chunks of CHUNK; all threads of a warp read the same target at once,
//    a broadcast with no bank conflicts;
//  * the depth-sign gates run only for candidates whose overlap passes the
//    threshold and beats the current k-th best, and the depths only for the
//    k winners;
//  * products, sums and quotients use __fmul_rn/__fadd_rn/__fdiv_rn (no FMA
//    contraction) in the order of the plain torch version
//    (ops/matching.py:match_pairs_plain), so on the same inputs both select
//    the same matches and give the same depths bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;   // source segments per block, one per thread
constexpr int CHUNK = 512;  // target segments staged per shared-memory pass
constexpr int KMAX = 16;    // largest k the kernel takes
constexpr float EPS = 1e-12f;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ float dot3(float a0, float a1, float a2,
                                      float b0, float b1, float b2) {
  return add_rn(add_rn(mul_rn(a0, b0), mul_rn(a1, b1)), mul_rn(a2, b2));
}

// depth = num / den > 0 with a |den| > eps guard (line3D.cc:1187-1191)
__device__ __forceinline__ bool positive_depth(float num, float den) {
  return fabsf(den) > EPS && mul_rn(num, den) > 0.0f;
}

__device__ __forceinline__ float safe(float x) { return fabsf(x) > EPS ? x : EPS; }

__global__ void __launch_bounds__(TILE) match_kernel(
    const float* __restrict__ seg,          // (V, S, 4)
    const uint8_t* __restrict__ mask,       // (V, S)
    const float* __restrict__ ray1,         // (V, S, 3)
    const float* __restrict__ ray2,         // (V, S, 3)
    const float* __restrict__ nrm,          // (V, S, 3) segment plane normals
    const float* __restrict__ seglen,       // (V, S)
    const float* __restrict__ e1t,          // (P, S, 3) F p1h
    const float* __restrict__ e2t,          // (P, S, 3) F p2h
    const float* __restrict__ num_src,      // (P, S) per target segment
    const float* __restrict__ num_tgt,      // (P, S) per source segment
    const int32_t* __restrict__ src_idx,    // (P,)
    const int32_t* __restrict__ tgt_idx,    // (P,)
    const uint8_t* __restrict__ pair_valid, // (P,)
    int S, int knn, float epipolar_overlap,
    int32_t* __restrict__ out_idx,          // (P, S, knn)
    float* __restrict__ out_ov, float* __restrict__ out_dp1,
    float* __restrict__ out_dp2, float* __restrict__ out_dq1,
    float* __restrict__ out_dq2) {
  __shared__ float sq1x[CHUNK], sq1y[CHUNK], sdqx[CHUNK], sdqy[CHUNK];
  __shared__ float snx[CHUNK], sny[CHUNK], snz[CHUNK];
  __shared__ float sa1x[CHUNK], sa1y[CHUNK], sa1z[CHUNK];
  __shared__ float sa2x[CHUNK], sa2y[CHUNK], sa2z[CHUNK];
  __shared__ float snum[CHUNK], slen[CHUNK];
  __shared__ uint8_t sok[CHUNK];

  const int p = blockIdx.x;
  const int s = blockIdx.y * TILE + threadIdx.x;
  const int64_t ps = (int64_t)p * S;
  const int64_t src_row = (int64_t)src_idx[p] * S;
  const int64_t tgt_row = (int64_t)tgt_idx[p] * S;
  const bool pair_ok = pair_valid[p] != 0;  // uniform over the block
  const bool active = pair_ok && s < S && mask[src_row + s] != 0;

  // sorted top-k: overlap descending, then index ascending; 0 = empty slot
  float ov[KMAX];
  int32_t ix[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    ov[j] = 0.0f;
    ix[j] = 0;
  }
  float thr = 0.0f;  // overlap a candidate must beat: the k-th best so far

  float e1x = 0, e1y = 0, e1z = 0, e2x = 0, e2y = 0, e2z = 0;
  float p1x = 0, p1y = 0, p1z = 0, p2x = 0, p2y = 0, p2z = 0;
  float nsx = 0, nsy = 0, nsz = 0, ntg = 0;
  if (active) {
    const int64_t a = (ps + s) * 3, b = (src_row + s) * 3;
    e1x = e1t[a]; e1y = e1t[a + 1]; e1z = e1t[a + 2];
    e2x = e2t[a]; e2y = e2t[a + 1]; e2z = e2t[a + 2];
    p1x = ray1[b]; p1y = ray1[b + 1]; p1z = ray1[b + 2];
    p2x = ray2[b]; p2y = ray2[b + 1]; p2z = ray2[b + 2];
    nsx = nrm[b]; nsy = nrm[b + 1]; nsz = nrm[b + 2];
    ntg = num_tgt[ps + s];
  }

  if (pair_ok) {
    for (int base = 0; base < S; base += CHUNK) {
      __syncthreads();
      for (int c = threadIdx.x; c < CHUNK; c += TILE) {
        const int t = base + c;
        if (t < S) {
          const int64_t g = tgt_row + t;
          const float x1 = seg[g * 4], y1 = seg[g * 4 + 1];
          sq1x[c] = x1;
          sq1y[c] = y1;
          sdqx[c] = sub_rn(seg[g * 4 + 2], x1);
          sdqy[c] = sub_rn(seg[g * 4 + 3], y1);
          snx[c] = nrm[g * 3]; sny[c] = nrm[g * 3 + 1]; snz[c] = nrm[g * 3 + 2];
          sa1x[c] = ray1[g * 3]; sa1y[c] = ray1[g * 3 + 1]; sa1z[c] = ray1[g * 3 + 2];
          sa2x[c] = ray2[g * 3]; sa2y[c] = ray2[g * 3 + 1]; sa2z[c] = ray2[g * 3 + 2];
          snum[c] = num_src[ps + t];
          slen[c] = seglen[g];
          sok[c] = mask[g];
        } else {
          sok[c] = 0;
        }
      }
      __syncthreads();
      if (!active) continue;
      const int n = min(CHUNK, S - base);
      for (int c = 0; c < n; ++c) {
        if (!sok[c]) continue;
        const float q1x = sq1x[c], q1y = sq1y[c], dqx = sdqx[c], dqy = sdqy[c];
        // intersection parameters t = -(e . q1h) / (e . dqh)
        const float e1q1 = add_rn(add_rn(mul_rn(e1x, q1x), mul_rn(e1y, q1y)), e1z);
        const float e1dq = add_rn(mul_rn(e1x, dqx), mul_rn(e1y, dqy));
        const float e2q1 = add_rn(add_rn(mul_rn(e2x, q1x), mul_rn(e2y, q1y)), e2z);
        const float e2dq = add_rn(mul_rn(e2x, dqx), mul_rn(e2y, dqy));
        // epipolar line parallel to the target line: overlap 0
        if (!(fabsf(e1dq) > EPS && fabsf(e2dq) > EPS)) continue;
        const float t1 = div_rn(-e1q1, e1dq);
        const float t2 = div_rn(-e2q1, e2dq);
        // mutual overlap of {t1, t2, 0, 1} on the target line
        // (line3D.cc:1086-1165)
        const float lo = fminf(t1, t2), hi = fmaxf(t1, t2);
        const float outer = sub_rn(fmaxf(hi, 1.0f), fminf(lo, 0.0f));
        const float inner = sub_rn(fminf(hi, 1.0f), fmaxf(lo, 0.0f));
        if (!(inner >= -EPS && mul_rn(outer, slen[c]) >= 1.0f)) continue;
        const float overlap = div_rn(inner, fmaxf(outer, EPS));
        if (!(overlap > epipolar_overlap && overlap > thr)) continue;
        // plane-ray triangulation depth signs (line3D.cc:1168-1193)
        const float nsrc = snum[c];
        const float nx = snx[c], ny = sny[c], nz = snz[c];
        if (!(positive_depth(nsrc, dot3(p1x, p1y, p1z, nx, ny, nz)) &&
              positive_depth(nsrc, dot3(p2x, p2y, p2z, nx, ny, nz)) &&
              positive_depth(ntg, dot3(nsx, nsy, nsz, sa1x[c], sa1y[c], sa1z[c])) &&
              positive_depth(ntg, dot3(nsx, nsy, nsz, sa2x[c], sa2y[c], sa2z[c]))))
          continue;
        // insert at slot k-1, then bubble up; an equal overlap never passes
        // an earlier (lower-index) entry
        const int32_t tc = base + c;
#pragma unroll
        for (int j = 0; j < KMAX; ++j)
          if (j == knn - 1) { ov[j] = overlap; ix[j] = tc; }
#pragma unroll
        for (int j = KMAX - 1; j > 0; --j) {
          if (j < knn && ov[j] > ov[j - 1]) {
            const float fo = ov[j]; ov[j] = ov[j - 1]; ov[j - 1] = fo;
            const int32_t io = ix[j]; ix[j] = ix[j - 1]; ix[j - 1] = io;
          }
        }
#pragma unroll
        for (int j = 0; j < KMAX; ++j)
          if (j == knn - 1) thr = ov[j];
      }
    }
  }

  if (s >= S) return;
  const int64_t o = (ps + s) * knn;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j >= knn) break;
    int32_t idx = 0;
    float ovj = 0.0f, dp1 = 0.0f, dp2 = 0.0f, dq1 = 0.0f, dq2 = 0.0f;
    if (ov[j] > 0.0f) {
      // depths of the winners, recomputed from the global tables
      idx = ix[j];
      ovj = ov[j];
      const int64_t g = (tgt_row + idx) * 3;
      const float nx = nrm[g], ny = nrm[g + 1], nz = nrm[g + 2];
      const float nsrc = num_src[ps + idx];
      dp1 = div_rn(nsrc, safe(dot3(p1x, p1y, p1z, nx, ny, nz)));
      dp2 = div_rn(nsrc, safe(dot3(p2x, p2y, p2z, nx, ny, nz)));
      dq1 = div_rn(ntg, safe(dot3(nsx, nsy, nsz, ray1[g], ray1[g + 1], ray1[g + 2])));
      dq2 = div_rn(ntg, safe(dot3(nsx, nsy, nsz, ray2[g], ray2[g + 1], ray2[g + 2])));
    }
    out_idx[o + j] = idx;
    out_ov[o + j] = ovj;
    out_dp1[o + j] = dp1;
    out_dp2[o + j] = dp2;
    out_dq1[o + j] = dq1;
    out_dq2[o + j] = dq2;
  }
}

}  // namespace

extern "C" int l3d_match_pairs(
    const float* seg, const uint8_t* mask, const float* ray1,
    const float* ray2, const float* nrm, const float* seglen,
    const float* e1, const float* e2, const float* num_src,
    const float* num_tgt, const int32_t* src_idx, const int32_t* tgt_idx,
    const uint8_t* pair_valid, int P, int S, int knn, float epipolar_overlap,
    int32_t* out_idx, float* out_ov, float* out_dp1, float* out_dp2,
    float* out_dq1, float* out_dq2, void* stream) {
  if (knn < 1 || knn > KMAX) return (int)cudaErrorInvalidValue;
  if (P == 0 || S == 0) return 0;
  const dim3 grid(P, (S + TILE - 1) / TILE);
  match_kernel<<<grid, TILE, 0, (cudaStream_t)stream>>>(
      seg, mask, ray1, ray2, nrm, seglen, e1, e2, num_src, num_tgt, src_idx,
      tgt_idx, pair_valid, S, knn, epipolar_overlap, out_idx, out_ov,
      out_dp1, out_dp2, out_dq1, out_dq2);
  return (int)cudaGetLastError();
}
