// K7 moments, K8 gate_moments, K9 gate_pixels, K10 band_counts and K11
// extents: the LSD rectangle-fit passes over the label-sorted pixel list.
//
// Replace line3dpp_tpu/ops/lsd_fit.py:_moments_kernel (moments),
// _gate_moments_kernel (gate_moments), _gate_kernel (gate_pixels),
// _band_counts_kernel (band_counts) and _extent_kernel (extents).  Every pixel i carries a component slot in
// [0, C]; the slots of real components increase along the list and each
// component is one contiguous run, and slot C (the dump) marks every other
// pixel.  Tables are (C, 8) float32 rows (ct, st, cx, cy, gate, center, 0,
// 0), read as two float4.  The Pallas kernels reach their components
// through one-hot matrix products over a 384-slot window of the table and
// a run-head scatter trick for the minima; both are TPU workarounds, and
// here each pixel reads its row directly and the reductions are exact
// segmented reductions.
//
// What bounds them on the H100: memory.  Each pass streams 4-6 planes of
// 4 B per pixel (2.8 M pixels at 3072 x 2304 on real photos) and writes one
// plane or a small table; the tables are L2-resident.  Design: one thread
// per pixel, a warp reduces the runs it holds with a segmented shuffle scan
// (equal slots are contiguous within a warp), and the last lane of each run
// adds or min-es its run's total into the table with one atomic per run and
// warp.
//   - Sums (K7, K8): the float32 terms w, wx, wy, wx*x, wy*y, wx*y, pix of
//     the JAX package are accumulated in float64 (double atomicAdd) and
//     rounded to float32 at the end.  The sums of w x^2 reach ~1e13 at x ~
//     2560 and the fit subtracts cx^2 from sxx / sw, so float32 atomics in
//     a varying order would move theta from run to run; in float64 the
//     result differs from the plain version's (float64 index_add) only in
//     the last bit of the float32 result, where rounding sits on a tie.
//   - Minima (K11): atomicMin on an order-preserving int encoding of the
//     float; exact, so bit-equal to the plain version.
//   - The gate (K8, K9): one device function, the plain version's
//     expression with __fmul_rn / __fadd_rn so nothing is contracted into
//     an FMA; cosf / sinf are CUDA's full-precision functions.
//   - Band counts (K10): the table row holds (ct, st, cx, cy, mid, width);
//     every pixel evaluates s = 2 (w_proj - mid) and, for each of up to 16
//     bands (lo_w, lo_c, hi_w, hi_c), lo_w width + lo_c <= s <= hi_w width +
//     hi_c, again without contraction, so a pixel on a band's edge falls on
//     the same side as in the plain version.  Per band one __ballot_sync of
//     the predicate; the first lane of each group of equal slots
//     (__match_any_sync) adds the popcount of its group's bits to an int32
//     (C, B) scratch with one integer atomicAdd.  Integer sums do not depend
//     on their order: the result is deterministic and equals the plain
//     version exactly.  The Pallas kernel's limit of 8 bands (its sublane
//     count) does not exist here, so the rescue's 15 bands are one launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e9f;
constexpr int kThreads = 256;

int blocks_for(int64_t n) {
  const int64_t want = (n + kThreads - 1) / kThreads;
  return (int)(want < 132 * 16 ? want : 132 * 16);
}

// keep(pixel) of lsd_fit.gate_pixels_plain
__device__ __forceinline__ float gate_one(const float4* __restrict__ tab,
                                          int s, int C, float x, float y,
                                          float ang, float pix,
                                          bool dump_keep, float cos_tol) {
  if (s >= C) return (dump_keep && pix != 0.f) ? 1.f : 0.f;
  const float4 a = tab[2 * (int64_t)s];        // ct st cx cy
  const float4 b = tab[2 * (int64_t)s + 1];    // gate center - -
  const float dxp = __fsub_rn(x, a.z);
  const float dyp = __fsub_rn(y, a.w);
  const float w = __fsub_rn(
      __fadd_rn(__fmul_rn(-dxp, a.y), __fmul_rn(dyp, a.x)), b.y);
  const float al = fabsf(
      __fadd_rn(__fmul_rn(cosf(ang), a.x), __fmul_rn(sinf(ang), a.y)));
  return (pix != 0.f && fabsf(w) <= b.x && al >= cos_tol) ? 1.f : 0.f;
}

__device__ __forceinline__ void moment_terms(float x, float y, float mag,
                                             float pix, double v[7]) {
  const float w = __fmul_rn(mag, pix);
  const float wx = __fmul_rn(w, x);
  const float wy = __fmul_rn(w, y);
  v[0] = w;
  v[1] = wx;
  v[2] = wy;
  v[3] = __fmul_rn(wx, x);
  v[4] = __fmul_rn(wy, y);
  v[5] = __fmul_rn(wx, y);
  v[6] = pix;
}

// Segmented inclusive scan over the warp's lanes: afterwards the last lane
// of each run of equal keys holds the run's total, which it adds to
// acc[key, :].  key < 0 marks a lane that contributes nothing.
__device__ __forceinline__ void warp_run_add(int key, double v[7],
                                             double* __restrict__ acc) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int k_up = __shfl_up_sync(kFull, key, d);
#pragma unroll
    for (int f = 0; f < 7; ++f) {
      const double u = __shfl_up_sync(kFull, v[f], d);
      if (lane >= d && k_up == key) v[f] += u;
    }
  }
  const int k_dn = __shfl_down_sync(kFull, key, 1);
  if (key >= 0 && (lane == 31 || k_dn != key)) {
#pragma unroll
    for (int f = 0; f < 7; ++f) atomicAdd(acc + (int64_t)key * 7 + f, v[f]);
  }
}

__device__ __forceinline__ int encode(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float decode(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// All loops below walk the pixels a warp at a time (the base index is the
// same for the whole warp), so every lane takes part in the shuffles.
#define FOR_WARP_CHUNKS(n)                                               \
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x + (threadIdx.x & ~31); \
       base < (n); base += (int64_t)gridDim.x * blockDim.x)

__global__ void moments_kernel(const int* __restrict__ slot,
                               const float* __restrict__ xs,
                               const float* __restrict__ ys,
                               const float* __restrict__ mag,
                               const float* __restrict__ pix, int64_t n, int C,
                               double* __restrict__ acc) {
  FOR_WARP_CHUNKS(n) {
    const int64_t i = base + (threadIdx.x & 31);
    int key = -1;
    double v[7] = {0, 0, 0, 0, 0, 0, 0};
    if (i < n) {
      const int s = slot[i];
      if (s >= 0 && s < C) {
        key = s;
        moment_terms(xs[i], ys[i], mag[i], pix[i], v);
      }
    }
    warp_run_add(key, v, acc);
  }
}

__global__ void gate_moments_kernel(
    const int* __restrict__ slot, const float* __restrict__ xs,
    const float* __restrict__ ys, const float* __restrict__ ang,
    const float* __restrict__ mag, const float* __restrict__ pix,
    const float4* __restrict__ tab, int64_t n, int C, bool dump_keep,
    float cos_tol, float* __restrict__ newpix, double* __restrict__ acc) {
  FOR_WARP_CHUNKS(n) {
    const int64_t i = base + (threadIdx.x & 31);
    int key = -1;
    double v[7] = {0, 0, 0, 0, 0, 0, 0};
    if (i < n) {
      const int s = slot[i];
      const float x = xs[i], y = ys[i];
      const float np =
          gate_one(tab, s, C, x, y, ang[i], pix[i], dump_keep, cos_tol);
      newpix[i] = np;
      if (s >= 0 && s < C) {
        key = s;
        moment_terms(x, y, mag[i], np, v);
      }
    }
    warp_run_add(key, v, acc);
  }
}

__global__ void moments_out(const double* __restrict__ acc, int C,
                            float* __restrict__ out) {
  const int64_t total = (int64_t)C * 8;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < total;
       j += (int64_t)gridDim.x * blockDim.x) {
    const int64_t c = j / 8;
    const int f = (int)(j % 8);
    out[j] = f < 7 ? (float)acc[c * 7 + f] : 0.f;
  }
}

__global__ void gate_kernel(const int* __restrict__ slot,
                            const float* __restrict__ xs,
                            const float* __restrict__ ys,
                            const float* __restrict__ ang,
                            const float* __restrict__ pix,
                            const float4* __restrict__ tab, int64_t n, int C,
                            bool dump_keep, float cos_tol,
                            float* __restrict__ newpix) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    newpix[i] = gate_one(tab, slot[i], C, xs[i], ys[i], ang[i], pix[i],
                         dump_keep, cos_tol);
  }
}

constexpr int kMaxBands = 16;

__global__ void band_counts_kernel(const int* __restrict__ slot,
                                   const float* __restrict__ xs,
                                   const float* __restrict__ ys,
                                   const float* __restrict__ pix,
                                   const float4* __restrict__ tab,
                                   const float4* __restrict__ bands, int64_t n,
                                   int C, int B, int* __restrict__ acc) {
  __shared__ float4 sb[kMaxBands];
  if (threadIdx.x < B) sb[threadIdx.x] = bands[threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  FOR_WARP_CHUNKS(n) {
    const int64_t i = base + lane;
    int key = -1;
    bool in = false;
    float s2 = 0.f, width = 0.f;
    if (i < n) {
      const int s = slot[i];
      if (s >= 0 && s < C) {
        key = s;
        const float4 a = tab[2 * (int64_t)s];        // ct st cx cy
        const float4 b = tab[2 * (int64_t)s + 1];    // mid width - -
        const float dxp = __fsub_rn(xs[i], a.z);
        const float dyp = __fsub_rn(ys[i], a.w);
        const float w =
            __fadd_rn(__fmul_rn(-dxp, a.y), __fmul_rn(dyp, a.x));
        s2 = __fmul_rn(2.f, __fsub_rn(w, b.x));
        width = b.y;
        in = pix[i] != 0.f;
      }
    }
    const unsigned peers = __match_any_sync(kFull, key);
    const bool leader = key >= 0 && lane == __ffs(peers) - 1;
    for (int b = 0; b < B; ++b) {
      const float4 t = sb[b];                        // lo_w lo_c hi_w hi_c
      const bool hit = in &&
                       s2 >= __fadd_rn(__fmul_rn(t.x, width), t.y) &&
                       s2 <= __fadd_rn(__fmul_rn(t.z, width), t.w);
      const int cnt = __popc(__ballot_sync(kFull, hit) & peers);
      if (leader && cnt) atomicAdd(acc + (int64_t)key * B + b, cnt);
    }
  }
}

__global__ void band_counts_out(const int* __restrict__ acc, int64_t total,
                                float* __restrict__ out) {
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < total;
       j += (int64_t)gridDim.x * blockDim.x)
    out[j] = (float)acc[j];
}

__global__ void extents_init(int C, int* __restrict__ out) {
  const int64_t total = (int64_t)C * 4;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < total;
       j += (int64_t)gridDim.x * blockDim.x)
    out[j] = encode(kBig);
}

__global__ void extents_kernel(const int* __restrict__ slot,
                               const float* __restrict__ xs,
                               const float* __restrict__ ys,
                               const float* __restrict__ pix,
                               const float4* __restrict__ tab, int64_t n,
                               int C, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  FOR_WARP_CHUNKS(n) {
    const int64_t i = base + lane;
    int key = -1;
    float v[4] = {kBig, kBig, kBig, kBig};
    if (i < n) {
      const int s = slot[i];
      if (s >= 0 && s < C) {
        key = s;
        if (pix[i] != 0.f) {
          const float4 a = tab[2 * (int64_t)s];      // ct st cx cy
          const float dxp = __fsub_rn(xs[i], a.z);
          const float dyp = __fsub_rn(ys[i], a.w);
          const float l =
              __fadd_rn(__fmul_rn(dxp, a.x), __fmul_rn(dyp, a.y));
          const float w =
              __fadd_rn(__fmul_rn(-dxp, a.y), __fmul_rn(dyp, a.x));
          v[0] = l;
          v[1] = w;
          v[2] = -l;
          v[3] = -w;
        }
      }
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int k_up = __shfl_up_sync(kFull, key, d);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float u = __shfl_up_sync(kFull, v[f], d);
        if (lane >= d && k_up == key) v[f] = fminf(v[f], u);
      }
    }
    const int k_dn = __shfl_down_sync(kFull, key, 1);
    if (key >= 0 && (lane == 31 || k_dn != key)) {
#pragma unroll
      for (int f = 0; f < 4; ++f)
        atomicMin(out + (int64_t)key * 4 + f, encode(v[f]));
    }
  }
}

__global__ void extents_out(int C, int* __restrict__ out) {
  const int64_t total = (int64_t)C * 4;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < total;
       j += (int64_t)gridDim.x * blockDim.x)
    reinterpret_cast<float*>(out)[j] = decode(out[j]);
}

}  // namespace

extern "C" int l3d_moments(const int* slot, const float* xs, const float* ys,
                           const float* mag, const float* pix, int n, int C,
                           double* scratch, float* out, void* stream) {
  if (n < 0 || C < 0) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, sizeof(double) * 7 * (size_t)C, s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0)
    moments_kernel<<<blocks_for(n), kThreads, 0, s>>>(slot, xs, ys, mag, pix,
                                                      n, C, scratch);
  moments_out<<<blocks_for((int64_t)C * 8), kThreads, 0, s>>>(scratch, C,
                                                               out);
  return (int)cudaGetLastError();
}

extern "C" int l3d_gate_moments(const int* slot, const float* xs,
                                const float* ys, const float* ang,
                                const float* mag, const float* pix,
                                const float* tables, int n, int C,
                                int dump_keep, float cos_tol, float* newpix,
                                double* scratch, float* out, void* stream) {
  if (n < 0 || C < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (C > 0) {
    cudaError_t err =
        cudaMemsetAsync(scratch, 0, sizeof(double) * 7 * (size_t)C, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (n > 0)
    gate_moments_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        slot, xs, ys, ang, mag, pix, reinterpret_cast<const float4*>(tables),
        n, C, dump_keep != 0, cos_tol, newpix, scratch);
  if (C > 0)
    moments_out<<<blocks_for((int64_t)C * 8), kThreads, 0, s>>>(scratch, C,
                                                                 out);
  return (int)cudaGetLastError();
}

extern "C" int l3d_gate_pixels(const int* slot, const float* xs,
                               const float* ys, const float* ang,
                               const float* pix, const float* tables, int n,
                               int C, int dump_keep, float cos_tol,
                               float* newpix, void* stream) {
  if (n < 0 || C < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  gate_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      slot, xs, ys, ang, pix, reinterpret_cast<const float4*>(tables), n, C,
      dump_keep != 0, cos_tol, newpix);
  return (int)cudaGetLastError();
}

extern "C" int l3d_band_counts(const int* slot, const float* xs,
                               const float* ys, const float* pix,
                               const float* tables, const float* bands, int n,
                               int C, int B, int* scratch, float* out,
                               void* stream) {
  if (n < 0 || C < 0 || B < 1 || B > kMaxBands)
    return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t total = (int64_t)C * B;
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(int) * (size_t)total, s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0)
    band_counts_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        slot, xs, ys, pix, reinterpret_cast<const float4*>(tables),
        reinterpret_cast<const float4*>(bands), n, C, B, scratch);
  band_counts_out<<<blocks_for(total), kThreads, 0, s>>>(scratch, total, out);
  return (int)cudaGetLastError();
}

extern "C" int l3d_extents(const int* slot, const float* xs, const float* ys,
                           const float* pix, const float* tables, int n,
                           int C, float* out, void* stream) {
  if (n < 0 || C < 0) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int* enc = reinterpret_cast<int*>(out);
  extents_init<<<blocks_for((int64_t)C * 4), kThreads, 0, s>>>(C, enc);
  if (n > 0)
    extents_kernel<<<blocks_for(n), kThreads, 0, s>>>(
        slot, xs, ys, pix, reinterpret_cast<const float4*>(tables), n, C,
        enc);
  extents_out<<<blocks_for((int64_t)C * 4), kThreads, 0, s>>>(C, enc);
  return (int)cudaGetLastError();
}
