// K5 apply_merge_dense and K6 gather_labels / gather_merged: the label
// gathers between the LSD detector's connected components and its label
// sort.
//
// Replace line3dpp_tpu/ops/lsd_gather.py:_merge_kernel (apply_merge_dense)
// and _gather_kernel (gather_sorted).  After K4 labels each tile and the
// border merge builds the map T from tile labels to merged labels, every
// listed pixel needs its merged label T[lab[idx]]:
//   - K5: out[i] = T[lab[i]] for a valid label, INVALID = 2^30 otherwise,
//     over the dense (hp, wp) grid;
//   - K6 (gather_labels): out[j] = src[idx[j]] for the int64 flat indices
//     of the pixel list;
//   - K6 (gather_merged): out[j] = T[lab[idx[j]]] for a valid label,
//     INVALID otherwise: K5 then K6, bit for bit, over the listed pixels
//     only.  The detector calls this one.
// The Pallas kernels exist because a TPU gathers one element at a time:
// they replicate table rows into lanes with one-hot matrix products over a
// VMEM window (the tile for K5, whose dense pass keeps T's lookup inside
// it; for K6 a window that sorted indices keep small, with an overflow
// count and an XLA fallback).  A GPU thread loads any address, so the
// grid-sized K5 pass, whose result only K6 reads, is not needed: K6 looks
// up T itself.  No window, no overflow, no order required of idx.
//
// What bounds them on the H100: memory.  K5 reads lab and T and writes out,
// 12 B per grid pixel (59 MB at 1920 x 2560, 18 us at 3.35 TB/s);
// gather_merged reads an 8 B index, a 4 B label and a 4 B map entry and
// writes 4 B per listed pixel (20 B; 56 MB at 2.8 M pixels, 17 us).  On the
// facade's 45k pixels it is one launch's latency.  Each thread takes
// kPairs pairs of consecutive indices, read 16 B at a time (a warp reads
// 512 contiguous bytes per pair), all pairs' loads in flight before the
// first label lookup; labels and map entries go through the read-only
// path; the outputs are 8-byte stores.  The loads of lab at increasing indices
// (round 1) and of T (tile labels point inside their own tile) are mostly
// coalesced.  The grid fills the SMs and strides over the rest; no
// scratch, no atomics, no host sync.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInvalid = 1 << 30;
constexpr int kThreads = 256;
constexpr int kPairs = 2;                        // 4 pixels a thread
constexpr int64_t kTile = 2 * kPairs * kThreads;

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

// src[j], and with MAP the merged label T[src[j]] (INVALID for a label
// outside [0, total))
template <bool MAP>
__device__ __forceinline__ int lookup(const int* __restrict__ src,
                                      const int* __restrict__ T,
                                      int64_t total, int64_t j) {
  const int l = __ldg(src + j);
  if (!MAP) return l;
  return (l >= 0 && l < total) ? __ldg(T + l) : kInvalid;
}

// K6: out[j] = src[idx[j]] (MAP: T applied); pair p of a thread covers
// items tile + 2 (p * kThreads + tid) and the next
template <bool MAP>
__global__ void __launch_bounds__(kThreads) gather_kernel(
    const int* __restrict__ src, const int* __restrict__ T,
    const int64_t* __restrict__ idx, int64_t total, int64_t n, int vec,
    int* __restrict__ out) {
  for (int64_t t0 = (int64_t)blockIdx.x * kTile; t0 < n;
       t0 += (int64_t)gridDim.x * kTile) {
    int64_t j[2 * kPairs];
    int v[2 * kPairs];
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const int64_t i0 = t0 + 2 * ((int64_t)p * kThreads + threadIdx.x);
      if (vec && i0 + 1 < n) {
        const longlong2 q =
            __ldg(reinterpret_cast<const longlong2*>(idx + i0));
        j[2 * p] = q.x;
        j[2 * p + 1] = q.y;
      } else {
        j[2 * p] = i0 < n ? idx[i0] : -1;
        j[2 * p + 1] = i0 + 1 < n ? idx[i0 + 1] : -1;
      }
    }
#pragma unroll
    for (int q = 0; q < 2 * kPairs; ++q)
      v[q] = j[q] >= 0 ? lookup<MAP>(src, T, total, j[q]) : 0;
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const int64_t i0 = t0 + 2 * ((int64_t)p * kThreads + threadIdx.x);
      if (vec && i0 + 1 < n) {
        reinterpret_cast<int2*>(out + i0)[0] =
            make_int2(v[2 * p], v[2 * p + 1]);
      } else {
        if (i0 < n) out[i0] = v[2 * p];
        if (i0 + 1 < n) out[i0 + 1] = v[2 * p + 1];
      }
    }
  }
}

template <bool MAP>
int launch_gather(const int* src, const int* T, const int64_t* idx,
                  int64_t total, int64_t n, int* out, cudaStream_t stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  static int per_sm = -1, sms = 0;
  if (per_sm < 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gather_kernel<MAP>, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
  }
  // 16-byte index loads and 8-byte stores where the pointers allow them
  const int vec = ((reinterpret_cast<uintptr_t>(idx) & 15) |
                   (reinterpret_cast<uintptr_t>(out) & 7)) == 0;
  const int64_t tiles = (n + kTile - 1) / kTile;
  const int64_t fill = (int64_t)per_sm * sms;
  gather_kernel<MAP><<<(unsigned)(tiles < fill ? tiles : fill), kThreads, 0,
                       stream>>>(src, T, idx, total, n, vec, out);
  return (int)cudaGetLastError();
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
  return launch_gather<false>(src, nullptr, idx, 0, n, out,
                              (cudaStream_t)stream);
}

extern "C" int l3d_gather_merged(const int* lab, const int* T,
                                 const int64_t* idx, int64_t total, int64_t n,
                                 int* out, void* stream) {
  if (total < 0 || total >= kInvalid) return (int)cudaErrorInvalidValue;
  return launch_gather<true>(lab, T, idx, total, n, out,
                             (cudaStream_t)stream);
}
