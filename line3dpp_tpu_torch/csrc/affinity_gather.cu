// K3: gather of the match targets' 3D estimates for the affinity stage.
//
// Replaces line3dpp_tpu/ops/affinity_pallas.py:_kernel / _gather_impl
// (gather_target_estimates).  For every match slot (v, s, m) of the source
// views: tv = neighbor_ids[v, m / k], ts = tgt_seg[v, s, m]; the 8 features
// (P1 xyz, P2 xyz, d1, d2) of estimate (tv, ts) and est_valid[tv, ts],
// written as 8 f32 planes and one bool plane of shape (V, S, M).  The
// Pallas kernel's one-hot MXU gather and its d1 = -1 validity encoding are
// TPU workarounds; here validity is read directly.
//
// What bounds it on the H100: memory.  The index plane is read once (4 B a
// slot) and 33 B a slot are written; the estimate table (V*S*32 B, 2.5 MB
// on the bundled scene) stays in L2.  Design: a grid-stride loop, one slot
// per thread and iteration; the table is laid out (V, S, 8) so one
// estimate is two aligned 16-byte loads; neighbouring threads write
// neighbouring addresses of every plane.  A target index outside the table
// gives zeros and false.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void gather_kernel(
    const float4* __restrict__ table,      // (V_tab, S, 8) as (V_tab*S*2) float4
    const uint8_t* __restrict__ est_valid, // (V_tab, S)
    const int32_t* __restrict__ nbr,       // (V, N)
    const int32_t* __restrict__ tgt_seg,   // (V, S, M)
    int V_tab, int S, int M, int N, int knn, int64_t total,
    float* __restrict__ out,               // (8, V, S, M)
    uint8_t* __restrict__ out_valid) {     // (V, S, M)
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int m = (int)(i % M);
    const int64_t v = i / ((int64_t)S * M);
    const int tv = nbr[v * N + m / knn];
    const int ts = tgt_seg[i];
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    uint8_t ok = 0;
    if (tv >= 0 && tv < V_tab && ts >= 0 && ts < S) {
      const int64_t g = (int64_t)tv * S + ts;
      a = table[2 * g];
      b = table[2 * g + 1];
      ok = est_valid[g];
    }
    out[i] = a.x;
    out[total + i] = a.y;
    out[2 * total + i] = a.z;
    out[3 * total + i] = a.w;
    out[4 * total + i] = b.x;
    out[5 * total + i] = b.y;
    out[6 * total + i] = b.z;
    out[7 * total + i] = b.w;
    out_valid[i] = ok;
  }
}

}  // namespace

extern "C" int l3d_gather_target_estimates(
    const float* table, const uint8_t* est_valid, const int32_t* nbr,
    const int32_t* tgt_seg, int V_tab, int S, int V, int M, int N, int knn,
    float* out, uint8_t* out_valid, void* stream) {
  if (knn < 1 || M != N * knn) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)V * S * M;
  if (total == 0) return 0;
  const int threads = 256;
  const int64_t want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 32 ? want : 132 * 32);
  gather_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(table), est_valid, nbr, tgt_seg, V_tab,
      S, M, N, knn, total, out, out_valid);
  return (int)cudaGetLastError();
}

extern "C" const char* l3d_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
