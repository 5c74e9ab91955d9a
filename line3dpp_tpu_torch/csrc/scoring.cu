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
// What bounds it on the H100: the f32 and SFU pipes.  Each pair (m, j) of
// valid slots in different groups costs one acosf and three expf (about 40
// f32 operations); with M = 160 slots a segment has up to M^2 = 25,600
// pairs.  Design: one block per segment (v, s), one thread per slot m, so
// M = 160 is five full warps.  Each slot's direction, depths and validity
// go to shared memory (24 B a slot); each thread then walks the slots of
// the other groups from shared memory (broadcast reads) and keeps its
// per-group maximum in a register.  Invalid slots cost nothing: a thread
// whose own slot is invalid does no pair work, and invalid partners are
// skipped.  The group sum runs in the order of the plain torch version
// (ops/scoring.py:_score_chunk), products and sums avoid FMA contraction,
// so only acosf/expf may differ from torch's in the last bit.

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

__global__ void score_kernel(
    const float* __restrict__ d_p1,      // (V, S, M)
    const float* __restrict__ d_p2,      // (V, S, M)
    const uint8_t* __restrict__ valid,   // (V, S, M)
    const float* __restrict__ ray1,      // (V, S, 3)
    const float* __restrict__ ray2,      // (V, S, 3)
    const float* __restrict__ raym,      // (V, S, 3)
    const float* __restrict__ C,         // (V, 3)
    const float* __restrict__ k_reg,     // (V,)
    const float* __restrict__ tgt_C,     // (V, N, 3) target camera per group
    const float* __restrict__ tgt_k,     // (V, N)
    int S, int M, int N, int knn, float two_sig_a_sqr, float min_similarity,
    int check_orientation,
    float* __restrict__ score,           // (V, S, M)
    uint8_t* __restrict__ ok_out) {      // (V, S, M)
  extern __shared__ float sh[];
  float* sdx = sh;
  float* sdy = sh + M;
  float* sdz = sh + 2 * M;
  float* sd1 = sh + 3 * M;
  float* sd2 = sh + 4 * M;
  uint8_t* sok = reinterpret_cast<uint8_t*>(sh + 5 * M);

  const int64_t vs = blockIdx.x;
  const int v = (int)(vs / S);
  const int m = threadIdx.x;
  const int64_t o = vs * M + m;

  bool ok = false;
  float d1 = 0, d2 = 0, dx = 0, dy = 0, dz = 0, reg1 = 0, reg2 = 0;
  if (m < M) {
    d1 = d_p1[o];
    d2 = d_p2[o];
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
    dx = mul_rn(vx, inv);
    dy = mul_rn(vy, inv);
    dz = mul_rn(vz, inv);
    ok = valid[o] != 0 && len > EPS;
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
    reg1 = add_rn(mul_rn(sig1, sig1), mul_rn(sig1t, sig1t));
    reg2 = add_rn(mul_rn(sig2, sig2), mul_rn(sig2t, sig2t));
    sdx[m] = dx;
    sdy[m] = dy;
    sdz[m] = dz;
    sd1[m] = d1;
    sd2[m] = d2;
    sok[m] = ok;
  }
  __syncthreads();
  if (m >= M) return;

  // per-camera max of min(sim_angle, sim_position), summed over the other
  // cameras (line3D.cc:1250-1275, 1417-1446)
  float total = 0.0f;
  if (ok) {
    const float den1 = fmaxf(reg1, EPS), den2 = fmaxf(reg2, EPS);
    const int own = m / knn;
    for (int g = 0; g < N; ++g) {
      float best = 0.0f;
      if (g != own) {
        for (int j = g * knn; j < (g + 1) * knn; ++j) {
          if (!sok[j]) continue;
          float ang = mul_rn(acosf(clamp1(dot3(dx, dy, dz, sdx[j], sdy[j], sdz[j]))), DEG);
          if (ang > 90.0f) ang = sub_rn(180.0f, ang);
          const float sim_a = expf(div_rn(mul_rn(-ang, ang), two_sig_a_sqr));
          const float e1 = sub_rn(d1, sd1[j]);
          const float e2 = sub_rn(d2, sd2[j]);
          const float sim_p = fminf(expf(div_rn(mul_rn(-e1, e1), den1)),
                                    expf(div_rn(mul_rn(-e2, e2), den2)));
          const float sim = fminf(sim_a, sim_p);
          if (sim > min_similarity) best = fmaxf(best, sim);
        }
      }
      total = add_rn(total, best);
    }
  }
  score[o] = ok ? total : 0.0f;
  ok_out[o] = ok;
}

}  // namespace

extern "C" int l3d_score_matches(
    const float* d_p1, const float* d_p2, const uint8_t* valid,
    const float* ray1, const float* ray2, const float* raym, const float* C,
    const float* k_reg, const float* tgt_C, const float* tgt_k, int V, int S,
    int M, int N, int knn, float two_sig_a_sqr, float min_similarity,
    int check_orientation, float* score, uint8_t* ok_out, void* stream) {
  if (M < 1 || M > 1024 || knn < 1 || M != N * knn) return (int)cudaErrorInvalidValue;
  if (V == 0 || S == 0) return 0;
  const int threads = (M + 31) / 32 * 32;
  const size_t smem = 5 * sizeof(float) * M + M;
  score_kernel<<<(unsigned)((int64_t)V * S), threads, smem, (cudaStream_t)stream>>>(
      d_p1, d_p2, valid, ray1, ray2, raym, C, k_reg, tgt_C, tgt_k, S, M, N,
      knn, two_sig_a_sqr, min_similarity, check_orientation, score, ok_out);
  return (int)cudaGetLastError();
}
