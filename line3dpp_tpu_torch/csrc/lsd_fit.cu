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
// adds its run's total into the table with one atomic per run and warp (K7,
// K8, K10; K11 reads whole runs instead, below).
//   - Sums (K7, K8): the float32 terms w, wx, wy, wx*x, wy*y, wx*y, pix of
//     the JAX package are accumulated in float64 (double atomicAdd) and
//     rounded to float32 at the end.  The sums of w x^2 reach ~1e13 at x ~
//     2560 and the fit subtracts cx^2 from sxx / sw, so float32 atomics in
//     a varying order would move theta from run to run; in float64 the
//     result differs from the plain version's (float64 index_add) only in
//     the last bit of the float32 result, where rounding sits on a tie.
//   - Minima (K11): one pass over the component runs without atomics (see
//     extents_kernel); exact, so bit-equal to the plain version.
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

// K11: one launch over the component runs, no atomics, no init or decode
// pass.  Each warp owns the runs whose heads lie in its span of 32 * I
// pixels (I consecutive pixels per lane, read with 16-byte loads where the
// planes are aligned, every plane at once); it skips the pixels of a run
// that began before its span (that run's owner reads them) and reads the
// next 32 * OVER pixels with them, so that the run crossing its span's end
// is finished in the same round when it ends there.  Each lane folds its
// pixels' four projections run by run and stores the runs that begin and
// end inside it; a segmented shuffle scan over the lanes finishes the
// rest.  A run going on past those pixels ends before the next component's
// start (starts[c + 1], n for the last component): the warp reads a rest
// of up to a span itself and posts a longer one to its block, which reads
// it with all its threads and one reduction, so the facade's components of
// thousands of pixels take a few rounds of the block's loads, not a warp's
// walk.  The minima compare through the order-preserving int encoding, so
// -0.0 orders below +0.0 as atomicMin on that encoding ordered it, and the
// result is each component's exact minimum: bit-equal to the plain
// version.  A component whose pixels all have pix == 0 gets BIG; the
// blocks past the pixel blocks give BIG to the components with no pixel
// (equal consecutive starts), so that no block waits on that check.

// the minima of the trailing run of key k; whole: every pixel folded in
// has key k
struct RunMin {
  int k;
  int m[4];
  int whole;
};

// b = a (earlier pixels) followed by b
__device__ __forceinline__ void run_combine(const RunMin& a, RunMin& b) {
  const bool same = b.whole && a.k == b.k;
  if (same) {
#pragma unroll
    for (int f = 0; f < 4; ++f) b.m[f] = min(a.m[f], b.m[f]);
  }
  b.whole = same && a.whole;
}

__device__ __forceinline__ RunMin run_shfl_up(const RunMin& r, int d) {
  RunMin o;
  o.k = __shfl_up_sync(kFull, r.k, d);
#pragma unroll
  for (int f = 0; f < 4; ++f) o.m[f] = __shfl_up_sync(kFull, r.m[f], d);
  o.whole = __shfl_up_sync(kFull, r.whole, d);
  return o;
}

__device__ __forceinline__ void store_run(float* __restrict__ out, int k,
                                          const int m[4]) {
  reinterpret_cast<float4*>(out)[k] =
      make_float4(decode(m[0]), decode(m[1]), decode(m[2]), decode(m[3]));
}

// the encoded projections (l, w, -l, -w) of a pixel with table row a =
// (ct, st, cx, cy); BIG where pix == 0 or the pixel is not counted
__device__ __forceinline__ void projections(float4 a, bool counted, float x,
                                            float y, float p, int big,
                                            int v[4]) {
  v[0] = v[1] = v[2] = v[3] = big;
  if (counted && p != 0.f) {
    const float dxp = __fsub_rn(x, a.z);
    const float dyp = __fsub_rn(y, a.w);
    const float l = __fadd_rn(__fmul_rn(dxp, a.x), __fmul_rn(dyp, a.y));
    const float w = __fadd_rn(__fmul_rn(-dxp, a.y), __fmul_rn(dyp, a.x));
    v[0] = encode(l);
    v[1] = encode(w);
    v[2] = encode(-l);
    v[3] = encode(-w);
  }
}

template <typename T> struct Vec4;
template <> struct Vec4<int> { using type = int4; };
template <> struct Vec4<float> { using type = float4; };

// the I values of p at i0.. (those at or past end read as 0)
template <int I, typename T>
__device__ __forceinline__ void load_items(const T* __restrict__ p,
                                           int64_t i0, int64_t end, bool vec,
                                           T (&v)[I]) {
  static_assert(I % 4 == 0, "16-byte loads");
  if (vec && i0 + I <= end) {
#pragma unroll
    for (int q = 0; q < I; q += 4) {
      const auto a = *reinterpret_cast<const typename Vec4<T>::type*>(p + i0 + q);
      v[q] = a.x;
      v[q + 1] = a.y;
      v[q + 2] = a.z;
      v[q + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < I; ++j) v[j] = i0 + j < end ? p[i0 + j] : T(0);
  }
}

// the minima over the pixels of component k among the I at i0.. (none at
// or past end), every plane loaded at once
template <int I>
__device__ __forceinline__ void run_rest(
    const int* __restrict__ slot, const float* __restrict__ xs,
    const float* __restrict__ ys, const float* __restrict__ pix, float4 a,
    int k, int64_t i0, int64_t end, bool vec, int big, int m[4]) {
  int key[I];
  float x[I], y[I], p[I];
  load_items<I>(slot, i0, end, vec, key);
  load_items<I>(xs, i0, end, vec, x);
  load_items<I>(ys, i0, end, vec, y);
  load_items<I>(pix, i0, end, vec, p);
  m[0] = m[1] = m[2] = m[3] = big;
#pragma unroll
  for (int j = 0; j < I; ++j) {
    int v[4];
    projections(a, i0 + j < end && key[j] == k, x[j], y[j], p[j], big, v);
#pragma unroll
    for (int f = 0; f < 4; ++f) m[f] = min(m[f], v[f]);
  }
}

struct Post {
  int k;       // component, -1: none
  int64_t i;   // where the rest of its run begins
  int m[4];    // its minima so far
};

// THREADS per block, I pixels per lane, 32 * OVER pixels read past a warp's
// span
template <int THREADS, int I, int OVER, int MINB>
__global__ void __launch_bounds__(THREADS, MINB) extents_kernel(
    const int* __restrict__ slot, const float* __restrict__ xs,
    const float* __restrict__ ys, const float* __restrict__ pix,
    const float4* __restrict__ tab, const int* __restrict__ starts,
    int64_t n, int C, int64_t blocks, int vec, float* __restrict__ out) {
  constexpr int kWarps = THREADS / 32, kSpan = 32 * I;
  constexpr int kBlockSpan = kWarps * kSpan;
  __shared__ Post s_post[kWarps];
  __shared__ int s_red[kWarps][4];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int big = encode(kBig);

  if (blockIdx.x >= blocks) {
    // components with no pixel
    const int64_t c = (blockIdx.x - blocks) * THREADS + tid;
    if (c < C) {
      const int64_t next = c + 1 < C ? starts[c + 1] : n;
      if (starts[c] >= next) {
        const int m[4] = {big, big, big, big};
        store_run(out, (int)c, m);
      }
    }
    return;
  }

  // ---- the warp's span
  const int64_t w0 = (int64_t)blockIdx.x * kBlockSpan +
                     (int64_t)warp * kSpan;
  Post post{-1, 0, {big, big, big, big}};
  if (w0 < n) {
    const int64_t hi = w0 + kSpan < n ? w0 + kSpan : n;
    const int64_t i0 = w0 + (int64_t)lane * I;
    int key[I];
    float x[I], y[I], p[I];
    load_items<I>(slot, i0, hi, vec != 0, key);
    load_items<I>(xs, i0, hi, vec != 0, x);
    load_items<I>(ys, i0, hi, vec != 0, y);
    load_items<I>(pix, i0, hi, vec != 0, p);
    // the next 32 * OVER pixels, and the pixel before the span
    int ko[OVER];
    float xo[OVER], yo[OVER], po[OVER];
#pragma unroll
    for (int j = 0; j < OVER; ++j) {
      const int64_t io = hi + 32 * j + lane;
      const bool in_o = io < n;
      ko[j] = in_o ? slot[io] : -1;
      xo[j] = in_o ? xs[io] : 0.f;
      yo[j] = in_o ? ys[io] : 0.f;
      po[j] = in_o ? pix[io] : 0.f;
    }
    const int before = (lane == 0 && w0 > 0) ? slot[w0 - 1] : -1;

    const int head = __shfl_sync(kFull, key[0], 0);
    const int skip = __shfl_sync(kFull, before, 0) == head ? head : -1;
    // the run crossing the span's end (the span is full when hi < n)
    const int last = __shfl_sync(kFull, key[I - 1], 31);
    const int first_o = __shfl_sync(kFull, ko[0], 0);
    const int cross = (hi < n && last >= 0 && last < C && last != skip &&
                       first_o == last) ? last : -1;
#pragma unroll
    for (int j = 0; j < I; ++j) {
      const int k = key[j];
      key[j] = (i0 + j < hi && k >= 0 && k < C && k != skip) ? k : -1;
    }
#pragma unroll
    for (int j = 0; j < OVER; ++j) ko[j] = (cross >= 0 && ko[j] == cross) ? cross : -1;

    // fold the lane's pixels run by run
    int kf = key[0], mf[4];
    int kc = key[0], mc[4] = {big, big, big, big};
    bool first = true;
#pragma unroll
    for (int j = 0; j < I; ++j) {
      int v[4];
      const float4 a = key[j] >= 0 ? tab[2 * (int64_t)key[j]] : float4{};
      projections(a, key[j] >= 0, x[j], y[j], p[j], big, v);
      if (j > 0 && key[j] != kc) {
        if (first) {
#pragma unroll
          for (int f = 0; f < 4; ++f) mf[f] = mc[f];
          first = false;
        } else if (kc >= 0) {
          store_run(out, kc, mc);  // began and ended in this lane
        }
        kc = key[j];
#pragma unroll
        for (int f = 0; f < 4; ++f) mc[f] = big;
      }
#pragma unroll
      for (int f = 0; f < 4; ++f) mc[f] = min(mc[f], v[f]);
    }
    if (first) {
#pragma unroll
      for (int f = 0; f < 4; ++f) mf[f] = mc[f];
    }
    // the crossing run's pixels among the next 32 * OVER
    int vo[4] = {big, big, big, big};
    const float4 ao = cross >= 0 ? tab[2 * (int64_t)cross] : float4{};
#pragma unroll
    for (int j = 0; j < OVER; ++j) {
      int v[4];
      projections(ao, ko[j] >= 0, xo[j], yo[j], po[j], big, v);
#pragma unroll
      for (int f = 0; f < 4; ++f) vo[f] = min(vo[f], v[f]);
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) vo[f] = __reduce_min_sync(kFull, vo[f]);
    // it goes on past them when the last of them is still its own
    const bool goes_on = __shfl_sync(kFull, ko[OVER - 1], 31) >= 0;

    // segmented scan of the lanes' last runs
    RunMin inc;
    inc.k = kc;
#pragma unroll
    for (int f = 0; f < 4; ++f) inc.m[f] = mc[f];
    inc.whole = first;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const RunMin a = run_shfl_up(inc, d);
      if (lane >= d) run_combine(a, inc);
    }
    RunMin ex = run_shfl_up(inc, 1);
    if (lane == 0) ex.k = -1;
    const int down = __shfl_down_sync(kFull, key[0], 1);
    const int next = lane < 31 ? down : (cross >= 0 ? cross : -1);
    if (!first && kf >= 0) {
      if (ex.k == kf) {
#pragma unroll
        for (int f = 0; f < 4; ++f) mf[f] = min(mf[f], ex.m[f]);
      }
      store_run(out, kf, mf);  // ended in this lane
    }
    if (first && ex.k == kc) {
#pragma unroll
      for (int f = 0; f < 4; ++f) mc[f] = min(mc[f], ex.m[f]);
    }
    if (kc >= 0 && next != kc) {
      store_run(out, kc, mc);
    } else if (kc >= 0 && lane == 31) {  // kc == cross
#pragma unroll
      for (int f = 0; f < 4; ++f) mc[f] = min(mc[f], vo[f]);
      if (!goes_on) store_run(out, kc, mc);
    }
    if (goes_on) {
      // the crossing run goes on: the warp reads a short rest itself, the
      // block a long one
      const int64_t pos = hi + 32 * OVER;
      const int64_t end = cross + 1 < C ? (int64_t)starts[cross + 1] : n;
      if (end - pos <= kSpan) {
        int m[4];
        run_rest<I>(slot, xs, ys, pix, ao, cross,
                 pos + (int64_t)lane * I, end, vec != 0, big, m);
#pragma unroll
        for (int f = 0; f < 4; ++f) m[f] = __reduce_min_sync(kFull, m[f]);
        if (lane == 31) {
#pragma unroll
          for (int f = 0; f < 4; ++f) mc[f] = min(mc[f], m[f]);
          store_run(out, cross, mc);
        }
      } else if (lane == 31) {
        post.k = cross;
        post.i = pos;
#pragma unroll
        for (int f = 0; f < 4; ++f) post.m[f] = mc[f];
      }
    }
  }
  if (lane == 31) s_post[warp] = post;
  __syncthreads();

  // ---- the runs that go on: the block reads each to its end
  for (int w = 0; w < kWarps; ++w) {
    const Post q = s_post[w];
    if (q.k < 0) continue;
    const int64_t end = q.k + 1 < C ? (int64_t)starts[q.k + 1] : n;
    const float4 a = tab[2 * (int64_t)q.k];
    int m[4] = {big, big, big, big};
#pragma unroll 2
    for (int64_t i = q.i + (int64_t)tid * I; i < end;
         i += THREADS * I) {
      int v[4];
      run_rest<I>(slot, xs, ys, pix, a, q.k, i, end, vec != 0, big, v);
#pragma unroll
      for (int f = 0; f < 4; ++f) m[f] = min(m[f], v[f]);
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) m[f] = __reduce_min_sync(kFull, m[f]);
    if (lane == 0) {
#pragma unroll
      for (int f = 0; f < 4; ++f) s_red[warp][f] = m[f];
    }
    __syncthreads();
    if (tid == 0) {
#pragma unroll
      for (int f = 0; f < 4; ++f) m[f] = q.m[f];
      for (int u = 0; u < kWarps; ++u) {
#pragma unroll
        for (int f = 0; f < 4; ++f) m[f] = min(m[f], s_red[u][f]);
      }
      store_run(out, q.k, m);
    }
    __syncthreads();
  }
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

template <int THREADS, int I, int OVER, int MINB>
int launch_extents(const int* slot, const float* xs, const float* ys,
                   const float* pix, const float* tables, const int* starts,
                   int n, int C, bool vec, float* out, cudaStream_t stream) {
  constexpr int64_t span = THREADS * I;
  const int64_t blocks = ((int64_t)n + span - 1) / span;
  const int64_t all = blocks + ((int64_t)C + THREADS - 1) / THREADS;
  extents_kernel<THREADS, I, OVER, MINB><<<(unsigned)all, THREADS, 0, stream>>>(
      slot, xs, ys, pix, reinterpret_cast<const float4*>(tables), starts, n,
      C, blocks, vec ? 1 : 0, out);
  return (int)cudaGetLastError();
}

extern "C" int l3d_extents(const int* slot, const float* xs, const float* ys,
                           const float* pix, const float* tables,
                           const int* starts, int n, int C, float* out,
                           void* stream) {
  if (n < 0 || C < 0) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const bool vec = ((reinterpret_cast<uintptr_t>(slot) |
                     reinterpret_cast<uintptr_t>(xs) |
                     reinterpret_cast<uintptr_t>(ys) |
                     reinterpret_cast<uintptr_t>(pix)) & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
#ifdef L3D_K11_THREADS
  // one fixed layout, for the sweep of tests/measure_torch_k2_k11.py
  return launch_extents<L3D_K11_THREADS, L3D_K11_I, L3D_K11_OVER,
                        L3D_K11_MINB>(slot, xs, ys, pix, tables, starts, n,
                                      C, vec, out, s);
#endif
  // components of 512 pixels and more on average (the facade's edges, of
  // thousands): wider blocks read the long runs in fewer rounds; else
  // (real photos' round 1, tens of pixels) narrow blocks with 64 pixels
  // read past each span (on an H100 80GB HBM3 at 700 W, in turns by
  // tests/measure_torch_k2_k11.py --k11-layouts: 7.7 against 9.5 us on the
  // facade, 28.8 against 34.2 us at 57% active)
  if ((int64_t)n >= 512 * (int64_t)C)
    return launch_extents<256, 4, 1, 1>(slot, xs, ys, pix, tables, starts, n,
                                        C, vec, out, s);
  return launch_extents<128, 8, 2, 1>(slot, xs, ys, pix, tables, starts, n, C,
                                      vec, out, s);
}
