// K5 apply_merge_dense and K6 gather_labels: the two label gathers between
// the LSD detector's connected components and its label sort.
//
// Replace line3dpp_tpu/ops/lsd_gather.py:_merge_kernel (apply_merge_dense)
// and _gather_kernel (gather_sorted).  After K4 labels each tile and the
// border merge builds the map T from tile labels to merged labels, every
// listed pixel needs its merged label T[lab[idx]]:
//   - K5: out[i] = T[lab[i]] for a valid label, INVALID = 2^30 otherwise,
//     over the dense (hp, wp) grid;
//   - K6: out[j] = src[idx[j]] for the int64 flat indices of the pixel list.
// The Pallas kernels exist because a TPU gathers one element at a time:
// they replicate table rows into lanes with one-hot matrix products over a
// VMEM window (the tile for K5; for K6 a window that sorted indices keep
// small, with an overflow count and an XLA fallback).  A GPU thread loads
// any address, so here each is one thread per element with no window, no
// overflow and no order required of idx.
//
// What bounds them on the H100: memory.  K5 reads lab and T and writes out,
// 12 B per grid pixel (59 MB at 1920 x 2560, 18 us at 3.35 TB/s); K6 reads
// an 8 B index and a 4 B value and writes 4 B per listed pixel.  The loads
// of T (tile labels point inside their own tile) and of src at increasing
// indices (round 1) are mostly coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInvalid = 1 << 30;
constexpr int kThreads = 256;

int blocks_for(int64_t n) {
  const int64_t want = (n + kThreads - 1) / kThreads;
  return (int)(want < 132 * 32 ? want : 132 * 32);
}

__global__ void merge_dense(const int* __restrict__ lab,
                            const int* __restrict__ T, int64_t total,
                            int* __restrict__ out) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int l = lab[i];
    out[i] = (l >= 0 && l < total) ? T[l] : kInvalid;
  }
}

__global__ void gather_idx(const int* __restrict__ src,
                           const int64_t* __restrict__ idx, int64_t n,
                           int* __restrict__ out) {
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += (int64_t)gridDim.x * blockDim.x)
    out[j] = src[idx[j]];
}

}  // namespace

extern "C" int l3d_apply_merge_dense(const int* lab, const int* T,
                                     int64_t total, int* out, void* stream) {
  if (total < 0 || total >= kInvalid) return (int)cudaErrorInvalidValue;
  if (total == 0) return (int)cudaSuccess;
  merge_dense<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      lab, T, total, out);
  return (int)cudaGetLastError();
}

extern "C" int l3d_gather_labels(const int* src, const int64_t* idx,
                                 int64_t n, int* out, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  gather_idx<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(src, idx,
                                                                   n, out);
  return (int)cudaGetLastError();
}
