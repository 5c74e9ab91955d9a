// K7 moments, K8 gate_moments, K9 gate_pixels (and its consume form,
// consume_survivors), K10 band_counts (and its rescue form,
// rescue_counts) and K11 extents: the LSD rectangle-fit passes over the
// label-sorted pixel list.
//
// Replace line3dpp_tpu/ops/lsd_fit.py:_moments_kernel (moments),
// _gate_moments_kernel (gate_moments), _gate_kernel (gate_pixels),
// _band_counts_kernel (band_counts) and _extent_kernel (extents).  Every
// pixel i carries a component slot in [0, C]; the slots of real components
// increase along the list and each component is one contiguous run, and
// slot C (the dump) marks every other pixel.  Tables are (C, 8) float32 rows (ct, st, cx, cy, gate, center, 0,
// 0), read as two float4.  The Pallas kernels reach their components
// through one-hot matrix products over a 384-slot window of the table and
// a run-head scatter trick for the minima; both are TPU workarounds, and
// here each pixel reads its row directly and the reductions are exact
// segmented reductions.
//
// What bounds them on the H100: memory.  Each pass streams 4-6 planes of
// 4 B per pixel (2.8 M pixels at 3072 x 2304 on real photos) and writes one
// plane or a small table; the tables are L2-resident.  K9 is one thread
// per pixel, and its consume form compacts the survivors in the same pass
// (gate_kernel); K7, K8, K10 and K11 read whole component runs through the
// run table (below), with no atomics and no init or output pass.
//   - Sums (K7, K8): the float32 terms w, wx, wy, wx*x, wy*y, wx*y, pix of
//     the JAX package are accumulated in float64 and rounded to float32 at
//     the end.  The sums of w x^2 reach ~1e13 at x ~ 2560 and the fit
//     subtracts cx^2 from sxx / sw, so float32 sums would move theta with
//     the order; in float64 the result differs from the plain version's
//     (float64 index_add) only in the last bit of the float32 result, where
//     rounding sits on a tie.  The order is fixed by the list, so two calls
//     give the same bits (fit_kernel).
//   - Minima (K11): one pass over the component runs without atomics (see
//     extents_kernel); exact, so bit-equal to the plain version.
//   - The gate (K9): the plain version's expression with __fmul_rn /
//     __fadd_rn so nothing is contracted into an FMA; cosf / sinf are
//     CUDA's full-precision functions.  K8 evaluates the same expression
//     on a row it reads once (gate_row), with sincosf, whose bits equal
//     sinf's and cosf's for every float32 argument (chip_smoke.py checks
//     all 2^32 on the card), so K8's newpix equals K9's.
//   - Band counts (K10): integer counts over the component runs, in one
//     pass of their own (counts_kernel); the band thresholds, s = 2 (w_proj
//     - mid) and the rescue's p/2 gate are the plain version's expressions
//     without contraction, so a pixel on a band's edge falls on the same
//     side, and integer sums do not depend on their order: the counts
//     equal the plain version's exactly.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e9f;
constexpr int kThreads = 256;

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

// gate_one's value for a pixel of a real component with table row (a, b),
// for K8: the angle only where the band test passes, with sincosf (one
// argument reduction for both)
__device__ __forceinline__ float gate_row(float4 a, float4 b, float x,
                                          float y, float ang, float pix,
                                          float cos_tol) {
  const float dxp = __fsub_rn(x, a.z);
  const float dyp = __fsub_rn(y, a.w);
  const float w = __fsub_rn(
      __fadd_rn(__fmul_rn(-dxp, a.y), __fmul_rn(dyp, a.x)), b.y);
  if (pix == 0.f || !(fabsf(w) <= b.x)) return 0.f;
  float sn, cs;
  sincosf(ang, &sn, &cs);
  const float al =
      fabsf(__fadd_rn(__fmul_rn(cs, a.x), __fmul_rn(sn, a.y)));
  return al >= cos_tol ? 1.f : 0.f;
}

__device__ __forceinline__ int encode(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float decode(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// K9 in two forms, one routine (gate_kernel<COMPACT, THREADS, ITEMS>).  A
// block works on tiles of THREADS * ITEMS pixels, each warp on 32 * ITEMS
// consecutive ones: item q of lane l is the warp's pixel 32 q + l, so every
// plane is read coalesced and all ITEMS loads of a lane are in flight
// together.
//   - gate_pixels (COMPACT false): newpix = gate_one of each pixel, one
//     pixel a thread; the grid fills the SMs and strides over the tiles.
//   - consume_survivors (COMPACT true): the detector's consume step.  A
//     pixel of a real component is consumed when the gate keeps it with
//     pix = 1 (gate_row: the band test first, the angle only inside the
//     band, sincosf, whose bits equal cosf's and sinf's); a dump pixel
//     never is.  The survivors' (idx, mag, ang) are written in list order,
//     and their count.  One tile a block (256 threads, 2 or 8 pixels a
//     thread, by the list's length against the SMs: lsd_fit.consume_items):
//     each warp ballots its survivors item by item and starts the loads of
//     their index and magnitude only, a prefix over the warps in shared
//     memory gives each warp its offset in the tile, and the tile's offset
//     in the output is found, while those loads are in flight, by decoupled
//     look-back over one status word per tile: the
//     tile posts its count (an aggregate) at once, then sums its
//     predecessors' words, 32 at a time, back to the nearest one that
//     holds an inclusive prefix, and posts its own.  A word is
//     (epoch << 32 | inclusive << 31 | value): the caller passes a new
//     epoch with every call, so the words of an earlier call read as not
//     posted and the buffer needs no memset.  Tiles are blocks in launch
//     order, so a tile waits only on tiles that are running or done.  The
//     ranks are fixed by the list, so the output does not depend on the
//     schedule.  tests/test_torch_kernel_design.py mirrors this split in
//     torch.
// What bounds the consume form: memory, 16 B read per pixel (slot, x, y,
// ang), 12 B read (an 8 B index, mag) and 16 B written per survivor, and
// the table rows.  Switched off in turns at 57% active on an H100 80GB
// HBM3 at 700 W (tests/measure_torch_k6_k9.py --consume-variants at
// d36bf17), the survivor writes cost 13 us of its 55 us, the look-back
// 11 us and the payload loads 8 us.

// the consume form's layout: threads a block, and pixels a thread for
// short lists and for long ones (lsd_fit.consume_items)
constexpr int kConsumeThreads = 256;

struct GateArgs {
  const int* slot;
  const float *xs, *ys, *ang, *pix;     // pix: gate_pixels only
  const float4* tab;
  int64_t n;
  int C, dump_keep;
  float cos_tol;
  float* newpix;                        // gate_pixels' output
  // consume_survivors: the payload, the outputs, the tiles' status words
  const int64_t* idx;
  const float* mag;
  int64_t* idx_out;
  float *mag_out, *ang_out;
  int* count;
  unsigned long long* status;
  unsigned epoch;
};

__device__ __forceinline__ unsigned long long status_word(unsigned epoch,
                                                          bool inclusive,
                                                          int value) {
  return (unsigned long long)epoch << 32 | (inclusive ? 0x80000000ull : 0ull) |
         (unsigned)value;
}

__device__ __forceinline__ void post_status(unsigned long long* p,
                                            unsigned long long w) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w)
               : "memory");
}

__device__ __forceinline__ unsigned long long read_status(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(p)
               : "memory");
  return w;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

// the survivors before tile t (t > 0), by the whole warp: the words of
// t - 1, t - 2, ... 32 at a time (lane 0 the nearest), each window once
// all 32 are posted, summed back to the nearest inclusive one
__device__ int look_back(const unsigned long long* status, int64_t t,
                         unsigned epoch, int lane) {
  int sum = 0;
  for (int64_t k = t - 1;; k -= 32) {
    const int64_t j = k - lane;
    unsigned long long w;
    do {
      // below tile 0 (never reached past tile 0's inclusive word): 0
      w = j >= 0 ? read_status(status + j) : status_word(epoch, true, 0);
    } while (!__all_sync(kFull, (unsigned)(w >> 32) == epoch));
    const unsigned inclusive = __ballot_sync(kFull, (w >> 31) & 1);
    const int v = (int)(w & 0x7fffffffull);
    if (inclusive) {
      const int first = __ffs(inclusive) - 1;
      return sum + warp_sum(lane <= first ? v : 0);
    }
    sum += warp_sum(v);
  }
}

// the consume form's work on tile t, whose warp holds pixels i0 + 32 q
// (this lane's) with slots s, coordinates x, y and angles an
template <int THREADS, int ITEMS>
__device__ __forceinline__ void consume_tile(const GateArgs& a, int64_t t,
                                             int64_t i0, const int (&s)[ITEMS],
                                             const float (&x)[ITEMS],
                                             const float (&y)[ITEMS],
                                             const float (&an)[ITEMS]) {
  constexpr int kWarps = THREADS / 32;
  constexpr int64_t kTile = THREADS * ITEMS;
  __shared__ int s_warp[kWarps];
  __shared__ int s_base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t n = a.n;
  // the survivors and their count in the warp
  unsigned m[ITEMS];
  int cnt = 0;
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    bool alive = i0 + 32 * q < n;
    if (alive && s[q] < a.C) {
      const float4 ra = a.tab[2 * (int64_t)s[q]];
      const float4 rb = a.tab[2 * (int64_t)s[q] + 1];
      alive = gate_row(ra, rb, x[q], y[q], an[q], 1.f, a.cos_tol) == 0.f;
    }
    m[q] = __ballot_sync(kFull, alive);
    cnt += __popc(m[q]);
  }
  // the survivors' payload, loaded while the tile's offset is found
  int64_t id[ITEMS];
  float mg[ITEMS];
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const bool own = m[q] >> lane & 1u;
    id[q] = own ? a.idx[i0 + 32 * q] : 0;
    mg[q] = own ? a.mag[i0 + 32 * q] : 0.f;
  }
  if (lane == 0) s_warp[warp] = cnt;
  __syncthreads();
  if (warp == 0) {
    // the warps' offsets in the tile, the tile's count and its offset
    const int v = lane < kWarps ? s_warp[lane] : 0;
    int inc = v;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int o = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc += o;
    }
    const int agg = __shfl_sync(kFull, inc, kWarps - 1);
    if (lane < kWarps) s_warp[lane] = inc - v;
    int base = 0;
    if (t > 0) {
      if (lane == 0)
        post_status(a.status + t, status_word(a.epoch, false, agg));
      base = look_back(a.status, t, a.epoch, lane);
    }
    if (lane == 0) {
      post_status(a.status + t, status_word(a.epoch, true, base + agg));
      s_base = base;
      if ((t + 1) * kTile >= n) *a.count = base + agg;
    }
  }
  __syncthreads();
  // each survivor at its rank: consecutive lanes on consecutive places
  int64_t r = (int64_t)s_base + s_warp[warp];
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    if (m[q] >> lane & 1u) {
      const int64_t o = r + __popc(m[q] & below);
      a.idx_out[o] = id[q];
      a.mag_out[o] = mg[q];
      a.ang_out[o] = an[q];
    }
    r += __popc(m[q]);
  }
}

template <bool COMPACT, int THREADS, int ITEMS>
__global__ void __launch_bounds__(THREADS) gate_kernel(const GateArgs a) {
  constexpr int64_t kTile = THREADS * ITEMS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, C = a.C;
  const int64_t n = a.n;
  for (int64_t t = blockIdx.x; t * kTile < n; t += gridDim.x) {
    const int64_t i0 = t * kTile + (int64_t)warp * 32 * ITEMS + lane;
    int s[ITEMS];
    float x[ITEMS], y[ITEMS], an[ITEMS];
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      const int64_t i = i0 + 32 * q;
      const bool in = i < n;
      s[q] = in ? a.slot[i] : C;
      x[q] = in ? a.xs[i] : 0.f;
      y[q] = in ? a.ys[i] : 0.f;
      an[q] = in ? a.ang[i] : 0.f;
    }
    if constexpr (COMPACT) {
      consume_tile<THREADS, ITEMS>(a, t, i0, s, x, y, an);
    } else {
#pragma unroll
      for (int q = 0; q < ITEMS; ++q) {
        const int64_t i = i0 + 32 * q;
        if (i < n)
          a.newpix[i] = gate_one(a.tab, s[q], C, x[q], y[q], an[q], a.pix[i],
                                 a.dump_keep != 0, a.cos_tol);
      }
    }
  }
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

// K10: band_counts and its rescue form rescue_counts, one routine
// (counts_kernel<HALF, NB, THREADS, I, MINB>) and one launch over the list,
// with no memset, no output pass and no atomics.  Each warp counts its own
// span of 32 * I pixels (I consecutive a lane, every plane read with
// 16-byte loads where the planes are aligned) and nothing past it.  A
// lane counts its pixels run by run; a run's thresholds are computed where
// the lane's pixels enter it, not per pixel.  With HALF, column 0 is the
// rescue's p/2 retry: K9's gate_one with center = mid, the band
// |w_proj - mid| <= (width > 0 ? width / 2 : -1) and the alignment
// |cos(ang) ct + sin(ang) st| >= cos_tol (sincosf, whose bits are cosf's
// and sinf's); the bands follow in columns 1..  Without it the bands are
// columns 0..  A band holds the pixels with lo_w width + lo_c <= s <=
// hi_w width + hi_c, s = 2 (w_proj - mid); the bands past B never hit.  A
// segmented shuffle scan over the lanes joins the runs that cross lanes,
// their counts packed two to a word (a span holds at most 256 pixels of a
// run), and the lane where a run ends writes its row.  A run that crosses
// spans: each warp whose span it leaves posts its piece, one word per two
// columns tagged with the call's epoch (epoch << 32 | two 16-bit counts),
// so an earlier call's words read as not posted and no memset is needed;
// the warp where the run ends sums the pieces of the warps back to the
// run's head (starts[c] / span), 32 a step, each once it is posted.  A warp
// posts before it waits and waits only on warps of earlier spans: of its
// own block, or of blocks launched before it, which run or have run (as
// K9's consume form relies on), so the facade's runs of thousands of pixels
// are counted by as many warps, not read by one block.  Integer counts: any
// split of the work gives the plain version's counts exactly.  What bounds
// it: memory, 16 B a pixel (slot, x, y, pix; the kernel reads the angle of
// every pixel with them, the function needs it only inside the p/2 band),
// the tables and the (C, cols) output.  Measured on an H100 80GB HBM3 at
// 700 W (tests/measure_torch_k10.py at b2f9d52), it is latency-bound
// instead: 7.3 us on the facade's round 1, 66 us at 57% active against a
// bound of 18 us, where one band alone takes 30 us (the loads, the table
// rows, the scan and the look-back), the other 14 bands 20 us more at
// 104-128 registers, and the p/2 column 16 us.
// tests/test_torch_kernel_design.py mirrors the split in torch.

constexpr int kMaxBands = 16;

struct CountArgs {
  const int* slot;
  const float *xs, *ys, *ang, *pix;  // ang: with the p/2 column only
  const float4* tab;                 // rows (ct st cx cy), (mid width - -)
  const float4* bands;               // (B, 4): lo_w lo_c hi_w hi_c
  const int* starts;
  float* out;                        // (C, cols)
  unsigned long long* words;         // NB / 2 per span, epoch-tagged
  int64_t n;
  int C, B, cols, vec;
  unsigned epoch;
  float cos_tol;
};

// one component's tests: its row and its NBANDS band thresholds
template <int NBANDS>
struct BandTest {
  float4 a;       // ct st cx cy
  float mid, g;   // g: the p/2 band's half-width, -1 where width <= 0
  float lo[NBANDS], hi[NBANDS];
};

template <int NBANDS>
__device__ __forceinline__ void band_test(const CountArgs& a,
                                          const float4* sb, int k,
                                          BandTest<NBANDS>& t) {
  t.a = a.tab[2 * (int64_t)k];
  const float4 b = a.tab[2 * (int64_t)k + 1];  // mid width - -
  t.mid = b.x;
  t.g = b.y > 0.f ? __fmul_rn(0.5f, b.y) : -1.f;
#pragma unroll
  for (int j = 0; j < NBANDS; ++j) {
    const float4 s = sb[j];
    t.lo[j] = __fadd_rn(__fmul_rn(s.x, b.y), s.y);
    t.hi[j] = __fadd_rn(__fmul_rn(s.z, b.y), s.w);
  }
}

// column col's unit in counts of at most 65535 packed two to a word:
// column w in the low half of word w, column w + H in the high half
template <int H>
__device__ __forceinline__ void add_column(unsigned (&m)[H], int col,
                                           bool hit) {
  if (hit) m[col % H] += col < H ? 1u : 0x10000u;
}

// m += the columns of a pixel of component t (pix p at x, y, angle an)
template <bool HALF, int H, int NBANDS>
__device__ __forceinline__ void count_pixel(const BandTest<NBANDS>& t,
                                            float x, float y, float p,
                                            float an, float cos_tol,
                                            unsigned (&m)[H]) {
  if (p == 0.f) return;
  const float dxp = __fsub_rn(x, t.a.z);
  const float dyp = __fsub_rn(y, t.a.w);
  const float d = __fsub_rn(
      __fadd_rn(__fmul_rn(-dxp, t.a.y), __fmul_rn(dyp, t.a.x)), t.mid);
  const float s = __fmul_rn(2.f, d);
#pragma unroll
  for (int j = 0; j < NBANDS; ++j)
    add_column(m, j + (HALF ? 1 : 0), s >= t.lo[j] && s <= t.hi[j]);
  if (HALF && fabsf(d) <= t.g) {
    float sn, cs;
    sincosf(an, &sn, &cs);
    add_column(m, 0,
               fabsf(__fadd_rn(__fmul_rn(cs, t.a.x), __fmul_rn(sn, t.a.y))) >=
                   cos_tol);
  }
}

// row k of the output: the packed counts m, plus the integer counts extra
// where add
template <int NB>
__device__ __forceinline__ void store_counts(const CountArgs& a, int k,
                                             const unsigned (&m)[NB / 2],
                                             const int (&extra)[NB],
                                             bool add) {
  constexpr int H = NB / 2;
  float v[NB];
#pragma unroll
  for (int c = 0; c < NB; ++c)
    v[c] = (float)((int)((m[c % H] >> (16 * (c / H))) & 0xffffu) +
                   (add ? extra[c] : 0));
  float* o = a.out + (int64_t)k * a.cols;
  if (a.vec && a.cols == NB) {
#pragma unroll
    for (int q = 0; q < NB; q += 4)
      reinterpret_cast<float4*>(o)[q / 4] =
          make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
  } else {
#pragma unroll
    for (int c = 0; c < NB; ++c)
      if (c < a.cols) o[c] = v[c];
  }
}

// the trailing run of a stretch of lanes: its component, whether it fills
// the stretch, its packed counts
template <int H>
struct RunCnt {
  int k, whole;
  unsigned m[H];
};

// b = a (earlier lanes) followed by b
template <int H>
__device__ __forceinline__ void run_join(const RunCnt<H>& a, RunCnt<H>& b) {
  const bool same = b.whole && a.k == b.k;
  if (same) {
#pragma unroll
    for (int w = 0; w < H; ++w) b.m[w] += a.m[w];
  }
  b.whole = same && a.whole;
}

template <int H>
__device__ __forceinline__ RunCnt<H> run_shfl(const RunCnt<H>& r, int src) {
  RunCnt<H> o;
  o.k = __shfl_sync(kFull, r.k, src);
  o.whole = __shfl_sync(kFull, r.whole, src);
#pragma unroll
  for (int w = 0; w < H; ++w) o.m[w] = __shfl_sync(kFull, r.m[w], src);
  return o;
}

template <int H>
__device__ __forceinline__ RunCnt<H> run_shfl_up(const RunCnt<H>& r, int d) {
  RunCnt<H> o;
  o.k = __shfl_up_sync(kFull, r.k, d);
  o.whole = __shfl_up_sync(kFull, r.whole, d);
#pragma unroll
  for (int w = 0; w < H; ++w) o.m[w] = __shfl_up_sync(kFull, r.m[w], d);
  return o;
}

// tot = the sum of the pieces posted by the warps of spans [from, to), by
// the whole warp, 32 spans a step: each lane loads its span's words
// together, then reads again only those that do not carry the call's epoch
// yet (their warp still runs)
template <int NB>
__device__ __forceinline__ void sum_pieces(const CountArgs& a, int64_t from,
                                           int64_t to, int lane,
                                           int (&tot)[NB]) {
  constexpr int H = NB / 2;
  const unsigned long long none = (unsigned long long)a.epoch << 32;
#pragma unroll
  for (int c = 0; c < NB; ++c) tot[c] = 0;
  for (int64_t base = from; base < to; base += 32) {
    const int64_t j = base + lane;
    unsigned long long v[H];
#pragma unroll
    for (int w = 0; w < H; ++w)
      v[w] = j < to ? read_status(a.words + j * H + w) : none;
    unsigned m[H];
#pragma unroll
    for (int w = 0; w < H; ++w) {
      // the cap only bounds the wait where a run table that misplaces a
      // run would leave a word unposted
      for (int spin = 0;
           (unsigned)(v[w] >> 32) != a.epoch && spin < (1 << 26); ++spin)
        v[w] = read_status(a.words + j * H + w);
      m[w] = (unsigned)v[w];
    }
    // at most 32 pieces of 256 a half: the halves do not carry
#pragma unroll
    for (int w = 0; w < H; ++w) {
      m[w] = __reduce_add_sync(kFull, m[w]);
      tot[w] += (int)(m[w] & 0xffffu);
      tot[w + H] += (int)(m[w] >> 16);
    }
  }
}

// NB columns (a multiple of 4), THREADS per block, I pixels per lane, at
// least MINB blocks an SM
template <bool HALF, int NB, int THREADS, int I, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
    counts_kernel(const CountArgs a) {
  constexpr int kWarps = THREADS / 32, kSpan = 32 * I, H = NB / 2;
  constexpr int NBANDS = HALF ? NB - 1 : NB;
  static_assert(NB % 4 == 0 && NB <= kMaxBands && I % 4 == 0, "layout");
  __shared__ float4 sb[kMaxBands];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, C = a.C;
  const int64_t n = a.n;
  const int64_t spans = (n + kSpan - 1) / kSpan;
  const int64_t pixel_blocks = (spans + kWarps - 1) / kWarps;

  if (blockIdx.x >= pixel_blocks) {
    // components with no pixel
    const int64_t c = (blockIdx.x - pixel_blocks) * THREADS + tid;
    if (c < C && a.starts[c] >= (c + 1 < C ? (int64_t)a.starts[c + 1] : n)) {
      const unsigned m[H] = {};
      const int none[NB] = {};
      store_counts<NB>(a, (int)c, m, none, false);
    }
    return;
  }
  if (tid < kMaxBands) {
    const float inf = __int_as_float(0x7f800000);
    sb[tid] = tid < a.B ? a.bands[tid] : make_float4(0.f, inf, 0.f, -inf);
  }
  __syncthreads();
  const int64_t g = (int64_t)blockIdx.x * kWarps + warp;  // the span
  if (g >= spans) return;

  const int64_t w0 = g * kSpan, hi = w0 + kSpan < n ? w0 + kSpan : n;
  const int64_t i0 = w0 + (int64_t)lane * I;
  const bool vec = a.vec != 0;
  int key[I];
  float x[I], y[I], p[I], an[I];
  load_items<I>(a.slot, i0, hi, vec, key);
  load_items<I>(a.xs, i0, hi, vec, x);
  load_items<I>(a.ys, i0, hi, vec, y);
  load_items<I>(a.pix, i0, hi, vec, p);
  if (HALF) load_items<I>(a.ang, i0, hi, vec, an);
  // the pixels before and after the span
  const int before = __shfl_sync(kFull,
                                 lane == 0 && w0 > 0 ? a.slot[w0 - 1] : -1, 0);
  const int after = __shfl_sync(kFull, lane == 31 && hi < n ? a.slot[hi] : -1,
                                31);
#pragma unroll
  for (int j = 0; j < I; ++j) {
    const int k = key[j];
    key[j] = (i0 + j < hi && k >= 0 && k < C) ? k : -1;
  }

  // the lane's pixels run by run: mf the first run's counts, mc the last's
  // (at most I a column)
  BandTest<NBANDS> t;
  int kt = -1;
  const int kf = key[0];
  int kc = key[0];
  unsigned mf[H], mc[H];
#pragma unroll
  for (int w = 0; w < H; ++w) mc[w] = 0u;
  const int none[NB] = {};
  bool first = true;
#pragma unroll
  for (int j = 0; j < I; ++j) {
    if (j > 0 && key[j] != kc) {
      if (first) {
#pragma unroll
        for (int w = 0; w < H; ++w) mf[w] = mc[w];
        first = false;
      } else if (kc >= 0) {
        store_counts<NB>(a, kc, mc, none, false);  // began and ended here
      }
      kc = key[j];
#pragma unroll
      for (int w = 0; w < H; ++w) mc[w] = 0u;
    }
    if (key[j] >= 0) {
      if (key[j] != kt) {
        band_test(a, sb, key[j], t);
        kt = key[j];
      }
      count_pixel<HALF>(t, x[j], y[j], p[j], HALF ? an[j] : 0.f, a.cos_tol,
                        mc);
    }
  }
  if (first) {
#pragma unroll
    for (int w = 0; w < H; ++w) mf[w] = mc[w];
  }

  // segmented scan of the lanes' last runs
  RunCnt<H> inc;
  inc.k = kc;
  inc.whole = first;
#pragma unroll
  for (int w = 0; w < H; ++w) inc.m[w] = mc[w];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const RunCnt<H> o = run_shfl_up(inc, d);
    if (lane >= d) run_join(o, inc);
  }
  RunCnt<H> ex = run_shfl_up(inc, 1);
  if (lane == 0) ex.k = -1;
  const int down = __shfl_down_sync(kFull, key[0], 1);
  const int next = lane < 31 ? down : after;
  // a run leaving the span: its piece, for the warp where it ends
  if (lane == 31 && kc >= 0 && next == kc) {
#pragma unroll
    for (int w = 0; w < H; ++w)
      post_status(a.words + g * H + w,
                  (unsigned long long)a.epoch << 32 | inc.m[w]);
  }
  // the run at the span's head, begun in an earlier span: unless it fills
  // the span and goes on, it ends here, and its pieces are summed
  const int head = __shfl_sync(kFull, key[0], 0);
  const RunCnt<H> last = run_shfl(inc, 31);
  const bool begun = head >= 0 && before == head;
  int lb[NB];
  if (begun && !(last.k == head && last.whole && after == head)) {
    sum_pieces<NB>(a, (int64_t)a.starts[head] / kSpan, g, lane, lb);
  } else {
#pragma unroll
    for (int c = 0; c < NB; ++c) lb[c] = 0;
  }
  if (!first && kf >= 0) {
    if (ex.k == kf) {
#pragma unroll
      for (int w = 0; w < H; ++w) mf[w] += ex.m[w];
    }
    store_counts<NB>(a, kf, mf, lb, begun && kf == head);  // ended here
  }
  if (first && ex.k == kc) {
#pragma unroll
    for (int w = 0; w < H; ++w) mc[w] += ex.m[w];
  }
  if (kc >= 0 && next != kc)
    store_counts<NB>(a, kc, mc, lb, begun && kc == head);
}

// K7 moments and K8 gate_moments: one launch over the component runs, one
// routine with and without K9's gate.  Each block owns a stretch of whole
// tiles of T * 4 pixels (4 consecutive ones a thread) and the runs whose
// heads lie in it.  It works through its tiles in turn while the next one
// lands in shared memory (cp.async, each thread its own slots), so the
// loads overlap the arithmetic.  A thread adds its pixels' terms run by run
// into float64 registers and writes the row of a run that begins and ends
// inside it; the runs crossing threads are joined by a segmented scan over
// each warp's lanes, then across the warps and on from the tile before
// (one barrier a tile), and the thread holding a run's last pixel writes
// its row.  The run that began before the block's stretch is skipped (the
// block of its head reads it).  The run going on past its end is read on to
// the next component's start (starts[c + 1], n for the last): its tiles
// land in the buffer after the block's own, each thread sums its pixels,
// and one reduction finishes it.  Every sum is thus formed in an order that
// the list and the number of blocks fix (as many as fit on the card at
// once, at most one a tile): two calls give the same bits.  K8 gates a
// pixel where it is summed (a dump pixel in its own thread) and writes its
// newpix there, once for every pixel, with K9's test (gate_row on the row
// of the thread's first component, read once; gate_one for the others).
// The blocks past the stretches write the zero rows of the components with
// no pixel.

struct FitArgs {
  const int* slot;
  const float *xs, *ys, *ang, *mag, *pix;  // ang: K8 only
  const float4* tab;                       // K8: the gate's tables
  const int* starts;
  float* newpix;                           // K8 only
  float* out;
  int64_t n, tiles, blocks;
  int C, vec, dump_keep;
  float cos_tol;
};

// the last run of a stretch of pixels: its component (-1: none), whether
// it fills the stretch, its sums
struct RunSum {
  int k, whole;
  double m[7];
};

__device__ __forceinline__ bool real(int k, int C) {
  return (unsigned)k < (unsigned)C;
}

// b = a (earlier pixels) followed by b
__device__ __forceinline__ void join(const RunSum& a, RunSum& b) {
  const bool same = b.whole && a.k == b.k;
  if (same) {
#pragma unroll
    for (int f = 0; f < 7; ++f) b.m[f] = a.m[f] + b.m[f];
  }
  b.whole = same && a.whole;
}

// r joined on to the last runs of the warp's earlier lanes (inclusive
// segmented scan), one sum at a time
__device__ __forceinline__ void warp_join(RunSum& r, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int ok = __shfl_up_sync(kFull, r.k, d);
    const int ow = __shfl_up_sync(kFull, r.whole, d);
    const bool same = lane >= d && r.whole && ok == r.k;
#pragma unroll
    for (int f = 0; f < 7; ++f) {
      const double om = __shfl_up_sync(kFull, r.m[f], d);
      if (same) r.m[f] = om + r.m[f];
    }
    if (lane >= d) r.whole = same && ow;
  }
}

__device__ __forceinline__ RunSum run_shfl_up(const RunSum& r, int d) {
  RunSum o;
  o.k = __shfl_up_sync(kFull, r.k, d);
  o.whole = __shfl_up_sync(kFull, r.whole, d);
#pragma unroll
  for (int f = 0; f < 7; ++f) o.m[f] = __shfl_up_sync(kFull, r.m[f], d);
  return o;
}

// the float32 terms of lsd_fit._moment_terms, added in float64
__device__ __forceinline__ void add_terms(double m[7], float x, float y,
                                          float mag, float p) {
  const float w = __fmul_rn(mag, p);
  const float wx = __fmul_rn(w, x), wy = __fmul_rn(w, y);
  m[0] += w;
  m[1] += wx;
  m[2] += wy;
  m[3] += __fmul_rn(wx, x);
  m[4] += __fmul_rn(wy, y);
  m[5] += __fmul_rn(wx, y);
  m[6] += p;
}

__device__ __forceinline__ void store_row(float* out, int k,
                                          const double m[7]) {
  float4* o = reinterpret_cast<float4*>(out) + 2 * (int64_t)k;
  o[0] = make_float4((float)m[0], (float)m[1], (float)m[2], (float)m[3]);
  o[1] = make_float4((float)m[4], (float)m[5], (float)m[6], 0.f);
}

// 4 pixels of every plane: slot, x, y, mag, pix, ang
struct Pixels {
  int k[4];
  float x[4], y[4], mag[4], p[4], ang[4];
};

// this thread's 4 pixels at i0 (none at or past end) copied into its slots
// of the shared buffer, without waiting
template <bool GATE>
__device__ __forceinline__ void stage_pixels(const FitArgs& a, int64_t i0,
                                             int64_t end, float4* buf,
                                             int stride) {
  const void* planes[6] = {a.slot, a.xs, a.ys, a.mag, a.pix, a.ang};
#pragma unroll
  for (int q = 0; q < (GATE ? 6 : 5); ++q) {
    const char* src = static_cast<const char*>(planes[q]) + 4 * i0;
    float4* dst = buf + q * stride;
    if (a.vec && i0 + 4 <= end) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       (unsigned)__cvta_generic_to_shared(dst)),
                   "l"(src));
    } else {
      for (int j = 0; j < 4 && i0 + j < end; ++j)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                         (unsigned)__cvta_generic_to_shared(
                             reinterpret_cast<float*>(dst) + j)),
                     "l"(src + 4 * j));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <bool GATE>
__device__ __forceinline__ void unstage_pixels(const float4* buf, int stride,
                                               Pixels& v) {
  const int4 k = reinterpret_cast<const int4*>(buf)[0];
  const float4 x = buf[stride], y = buf[2 * stride], mg = buf[3 * stride],
               p = buf[4 * stride];
  v.k[0] = k.x, v.k[1] = k.y, v.k[2] = k.z, v.k[3] = k.w;
  v.x[0] = x.x, v.x[1] = x.y, v.x[2] = x.z, v.x[3] = x.w;
  v.y[0] = y.x, v.y[1] = y.y, v.y[2] = y.z, v.y[3] = y.w;
  v.mag[0] = mg.x, v.mag[1] = mg.y, v.mag[2] = mg.z, v.mag[3] = mg.w;
  v.p[0] = p.x, v.p[1] = p.y, v.p[2] = p.z, v.p[3] = p.w;
  if (GATE) {
    const float4 an = buf[5 * stride];
    v.ang[0] = an.x, v.ang[1] = an.y, v.ang[2] = an.z, v.ang[3] = an.w;
  }
}

// pixel j's weight: its pix, or with the gate the gated pix; (ra, rb) is
// the table row of component kr
template <bool GATE>
__device__ __forceinline__ float weight(const FitArgs& a, const Pixels& v,
                                        int j, int kr, float4 ra, float4 rb) {
  if (!GATE) return v.p[j];
  if (v.k[j] == kr)
    return gate_row(ra, rb, v.x[j], v.y[j], v.ang[j], v.p[j], a.cos_tol);
  return gate_one(a.tab, v.k[j], a.C, v.x[j], v.y[j], v.ang[j], v.p[j],
                  a.dump_keep != 0, a.cos_tol);
}

// T threads a block, at least MINB blocks an SM, S tiles in the shared
// buffer (S - 1 landing while one is worked on); the dynamic shared memory
// holds S tiles of 5 planes (6 with the gate)
template <bool GATE, int T, int MINB, int S>
__global__ void __launch_bounds__(T, MINB) fit_kernel(const FitArgs a) {
  constexpr int kWarps = T / 32, kPlanes = GATE ? 6 : 5;
  constexpr int64_t kTile = 4 * T;
  extern __shared__ float4 s_buf[];   // [S][planes][T]
  __shared__ RunSum s_run[2][kWarps], s_carry[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, C = a.C;
  const int64_t n = a.n;

  if (blockIdx.x >= a.blocks) {
    // components with no pixel
    const int64_t c = (blockIdx.x - a.blocks) * T + tid;
    if (c < C && a.starts[c] >= (c + 1 < C ? a.starts[c + 1] : n)) {
      const double zero[7] = {0, 0, 0, 0, 0, 0, 0};
      store_row(a.out, (int)c, zero);
    }
    return;
  }
  // the block's tiles [t0, t1), pixels [c0, c1)
  const int64_t t0 = blockIdx.x * a.tiles / a.blocks;
  const int64_t t1 = (blockIdx.x + 1) * a.tiles / a.blocks;
  const int64_t c0 = t0 * kTile, c1 = t1 * kTile < n ? t1 * kTile : n;
#pragma unroll
  for (int q = 0; q < S - 1; ++q)
    stage_pixels<GATE>(a, c0 + q * kTile + 4 * tid, n,
                       s_buf + q * kPlanes * T + tid, T);
  // the run that began before the block's pixels (the block of its head
  // reads it), and the one going on past them, which the block reads on to
  // the next component's start: pixels [c1, c2), the tiles after its own,
  // which land in the same buffer as they do
  const int head = a.slot[c0], last = a.slot[c1 - 1];
  const int skip =
      (c0 > 0 && real(head, C) && a.slot[c0 - 1] == head) ? head : -1;
  const int after = c1 < n ? a.slot[c1] : -1;
  const int cross =
      (real(last, C) && last != skip && after == last) ? last : -1;
  const int64_t c2 = cross < 0            ? c1
                     : cross + 1 < C ? (int64_t)a.starts[cross + 1]
                                     : n;
  if (tid == 0) s_carry[0] = RunSum{-1, 0, {0, 0, 0, 0, 0, 0, 0}};

  RunSum r;
  for (int64_t t = t0; t < t1; ++t) {
    const int u = (int)(t - t0), cur = u & 1;
    const int64_t b0 = t * kTile, i0 = b0 + 4 * tid, e = i0 + 4;
    const int64_t hi = b0 + kTile < c1 ? b0 + kTile : c1;
    // the tile S - 1 ahead lands while this one is worked on
    stage_pixels<GATE>(a, i0 + (S - 1) * kTile, c2,
                       s_buf + (u + S - 1) % S * kPlanes * T + tid, T);
    // the first pixel after this thread's (a lane's neighbour holds it)
    const int after_lane = lane == 31 && e < n ? a.slot[e] : -1;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 1));
    Pixels v;
    unstage_pixels<GATE>(s_buf + u % S * kPlanes * T + tid, T, v);
    const int kr = real(v.k[0], C) ? v.k[0] : -1;
    float4 ra{}, rb{};
    if (GATE && kr >= 0) {
      ra = a.tab[2 * (int64_t)kr];
      rb = a.tab[2 * (int64_t)kr + 1];
    }
    const int down = __shfl_down_sync(kFull, v.k[0], 1);
    const int next = lane < 31 ? (e < hi ? down : -1) : after_lane;

    // the thread's pixels run by run: mf the first run's sums, r the last's
    r = RunSum{-1, 1, {0, 0, 0, 0, 0, 0, 0}};
    int kf = -1, mine = 0;
    double mf[7] = {0, 0, 0, 0, 0, 0, 0};
    float np[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // the block's pixels: all but those of the skipped run
      const bool own = i0 + j < hi && v.k[j] != skip;
      int k = -1;
      np[j] = 0.f;
      if (own) {
        mine |= 1 << j;
        np[j] = weight<GATE>(a, v, j, kr, ra, rb);
        if (real(v.k[j], C)) k = v.k[j];
      }
      if (j == 0) {
        kf = r.k = k;
      } else if (k != r.k) {
        if (r.whole) {
#pragma unroll
          for (int f = 0; f < 7; ++f) mf[f] = r.m[f];
          r.whole = 0;
        } else if (r.k >= 0) {
          store_row(a.out, r.k, r.m);  // began and ended in this thread
        }
        r.k = k;
#pragma unroll
        for (int f = 0; f < 7; ++f) r.m[f] = 0;
      }
      if (k >= 0) add_terms(r.m, v.x[j], v.y[j], v.mag[j], np[j]);
    }
    if (GATE) {
      if (a.vec && mine == 15) {
        reinterpret_cast<float4*>(a.newpix)[i0 / 4] =
            make_float4(np[0], np[1], np[2], np[3]);
      } else {
        for (int j = 0; j < 4; ++j)
          if (mine >> j & 1) a.newpix[i0 + j] = np[j];
      }
    }

    // join the last runs over the warp's lanes; acc: the stretch from the
    // warp's first pixel to this thread's first run (through the thread
    // when it holds one run), joined on to the earlier warps and tiles
    const int single = r.whole;
    warp_join(r, lane);
    RunSum acc = run_shfl_up(r, 1);
    if (lane == 31) s_run[cur][warp] = r;
    __syncthreads();
    if (single) {
      acc = r;
    } else if (lane == 0) {
      acc = RunSum{kf, 1, {0, 0, 0, 0, 0, 0, 0}};
    }
    for (int w = warp - 1; w >= 0 && acc.whole; --w) join(s_run[cur][w], acc);
    if (acc.whole) join(s_carry[cur], acc);
    if (single) {
      r = acc;
    } else if (kf >= 0) {
      if (acc.k == kf) {
#pragma unroll
        for (int f = 0; f < 7; ++f) mf[f] = acc.m[f] + mf[f];
      }
      store_row(a.out, kf, mf);  // ended in this thread
    }
    const bool goes_on = r.k >= 0 && next == r.k;
    if (r.k >= 0 && !goes_on) store_row(a.out, r.k, r.m);
    // the run reaching into the next tile
    if (tid == T - 1)
      s_carry[cur ^ 1] = goes_on ? r : RunSum{-1, 0, {0, 0, 0, 0, 0, 0, 0}};
  }

  if (cross >= 0) {
    // the run going on past the block's tiles, streamed through the same
    // buffer (each thread its own slots), each thread summing its pixels;
    // one reduction of the shares, in a fixed order, onto the run's sums
    // in the block's tiles
    float4 ra{}, rb{};
    if (GATE) {
      ra = a.tab[2 * (int64_t)cross];
      rb = a.tab[2 * (int64_t)cross + 1];
    }
    double m[7] = {0, 0, 0, 0, 0, 0, 0};
    const int u1 = (int)(t1 - t0), u2 = (int)((c2 + kTile - 1) / kTile - t0);
    for (int u = u1; u < u2; ++u) {
      const int64_t i0 = c0 + u * kTile + 4 * tid;
      stage_pixels<GATE>(a, i0 + (S - 1) * kTile, c2,
                         s_buf + (u + S - 1) % S * kPlanes * T + tid, T);
      asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 1));
      Pixels v;
      unstage_pixels<GATE>(s_buf + u % S * kPlanes * T + tid, T, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (i0 + j < c2 && v.k[j] == cross) {
          const float p = weight<GATE>(a, v, j, cross, ra, rb);
          if (GATE) a.newpix[i0 + j] = p;
          add_terms(m, v.x[j], v.y[j], v.mag[j], p);
        }
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    if (c1 + (int64_t)warp * 128 < c2) {
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
        for (int f = 0; f < 7; ++f) m[f] += __shfl_xor_sync(kFull, m[f], d);
      }
    }
    __syncthreads();  // s_run is read
    if (lane == 0) {
#pragma unroll
      for (int f = 0; f < 7; ++f) s_run[0][warp].m[f] = m[f];
    }
    __syncthreads();
    if (tid == T - 1) {  // holds the run's last pixel in the block's tiles
      for (int w = 0; w < kWarps; ++w) {
#pragma unroll
        for (int f = 0; f < 7; ++f) r.m[f] += s_run[0][w].m[f];
      }
      store_row(a.out, cross, r.m);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

template <bool GATE, int T, int MINB, int S>
int launch_fit_layout(FitArgs a, cudaStream_t stream) {
  constexpr int64_t tile = 4 * T;
  a.vec = ((reinterpret_cast<uintptr_t>(a.slot) |
            reinterpret_cast<uintptr_t>(a.xs) |
            reinterpret_cast<uintptr_t>(a.ys) |
            reinterpret_cast<uintptr_t>(a.ang) |
            reinterpret_cast<uintptr_t>(a.mag) |
            reinterpret_cast<uintptr_t>(a.pix) |
            reinterpret_cast<uintptr_t>(a.newpix)) & 15) == 0;
  const int smem = S * (GATE ? 6 : 5) * T * (int)sizeof(float4);
  static int per_sm = -1, sms = 0;
  if (per_sm < 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fit_kernel<GATE, T, MINB, S>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fit_kernel<GATE, T, MINB, S>, T, smem);
    if (err != cudaSuccess) return (int)err;
  }
  a.tiles = (a.n + tile - 1) / tile;
  a.blocks = a.tiles < (int64_t)per_sm * sms ? a.tiles : (int64_t)per_sm * sms;
  const int64_t grid = a.blocks + (a.C + T - 1) / T;
  if (grid > 0)
    fit_kernel<GATE, T, MINB, S><<<(unsigned)grid, T, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// T threads a block, as lsd_fit.fit_threads chooses: 512 (one block an SM)
// for long runs, 256 (3 blocks an SM) for short ones
template <bool GATE>
int launch_fit(FitArgs a, int threads, cudaStream_t stream) {
  if (threads == 512) return launch_fit_layout<GATE, 512, 1, 2>(a, stream);
  if (threads == 256) return launch_fit_layout<GATE, 256, 3, 2>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int l3d_moments(const int* slot, const float* xs, const float* ys,
                           const float* mag, const float* pix,
                           const int* starts, int n, int C, int threads,
                           float* out, void* stream) {
  if (n < 0 || C < 0) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  return launch_fit<false>({slot, xs, ys, nullptr, mag, pix, nullptr, starts,
                            nullptr, out, n, 0, 0, C, 0, 0, 0.f},
                           threads, (cudaStream_t)stream);
}

extern "C" int l3d_gate_moments(const int* slot, const float* xs,
                                const float* ys, const float* ang,
                                const float* mag, const float* pix,
                                const float* tables, const int* starts, int n,
                                int C, int threads, int dump_keep,
                                float cos_tol, float* newpix, float* out,
                                void* stream) {
  if (n < 0 || C < 0) return (int)cudaErrorInvalidValue;
  return launch_fit<true>({slot, xs, ys, ang, mag, pix,
                           reinterpret_cast<const float4*>(tables), starts,
                           newpix, out, n, 0, 0, C, 0, dump_keep, cos_tol},
                          threads, (cudaStream_t)stream);
}

extern "C" int l3d_gate_pixels(const int* slot, const float* xs,
                               const float* ys, const float* ang,
                               const float* pix, const float* tables, int n,
                               int C, int dump_keep, float cos_tol,
                               float* newpix, void* stream) {
  if (n < 0 || C < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  static int fill = -1;
  if (fill < 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, gate_kernel<false, kThreads, 1>, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    fill = per_sm * sms;
  }
  GateArgs a{};
  a.slot = slot, a.xs = xs, a.ys = ys, a.ang = ang, a.pix = pix;
  a.tab = reinterpret_cast<const float4*>(tables);
  a.n = n, a.C = C, a.dump_keep = dump_keep, a.cos_tol = cos_tol;
  a.newpix = newpix;
  const int64_t tiles = (n + kThreads - 1) / kThreads;
  gate_kernel<false, kThreads, 1><<<(unsigned)(tiles < fill ? tiles : fill),
                                    kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

namespace {

// the consume form at a layout; status: at least one word per tile of
// THREADS * ITEMS pixels; epoch: not 0 and not used by an earlier
// call on these words (their buffer starts zeroed)
template <int THREADS, int ITEMS>
int launch_consume(const GateArgs& a, int64_t status_len,
                   cudaStream_t stream) {
  constexpr int64_t tile = THREADS * ITEMS;
  const int64_t tiles = (a.n + tile - 1) / tile;
  if (a.n < 0 || a.C < 0 || tiles > status_len || a.epoch == 0)
    return (int)cudaErrorInvalidValue;
  if (a.n == 0) return 0;
  gate_kernel<true, THREADS, ITEMS><<<(unsigned)tiles, THREADS, 0, stream>>>(
      a);
  return (int)cudaGetLastError();
}

GateArgs consume_args(const int* slot, const float* xs, const float* ys,
                      const float* ang, const int64_t* idx, const float* mag,
                      const float* tables, int n, int C, float cos_tol,
                      unsigned long long* status, unsigned epoch,
                      int64_t* idx_out, float* mag_out, float* ang_out,
                      int* count) {
  GateArgs a{};
  a.slot = slot, a.xs = xs, a.ys = ys, a.ang = ang;
  a.tab = reinterpret_cast<const float4*>(tables);
  a.n = n, a.C = C, a.cos_tol = cos_tol;
  a.idx = idx, a.mag = mag, a.idx_out = idx_out, a.mag_out = mag_out;
  a.ang_out = ang_out, a.count = count, a.status = status, a.epoch = epoch;
  return a;
}

}  // namespace

extern "C" int l3d_consume_survivors(
    const int* slot, const float* xs, const float* ys, const float* ang,
    const int64_t* idx, const float* mag, const float* tables, int n, int C,
    int items, float cos_tol, unsigned long long* status, int64_t status_len,
    unsigned epoch, int64_t* idx_out, float* mag_out, float* ang_out,
    int* count, void* stream) {
  const GateArgs a =
      consume_args(slot, xs, ys, ang, idx, mag, tables, n, C, cos_tol, status,
                   epoch, idx_out, mag_out, ang_out, count);
  if (items == 2)
    return launch_consume<kConsumeThreads, 2>(a, status_len,
                                              (cudaStream_t)stream);
  if (items == 8)
    return launch_consume<kConsumeThreads, 8>(a, status_len,
                                              (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
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
  // components of 512 pixels and more on average (the facade's edges, of
  // thousands): wider blocks read the long runs in fewer rounds; else
  // (real photos' round 1, tens of pixels) narrow blocks with 64 pixels
  // read past each span (on an H100 80GB HBM3 at 700 W, in turns by
  // tests/measure_torch_k2_k11.py --k11-layouts at f9a3047: 7.7 against
  // 9.5 us on the facade, 28.8 against 34.2 us at 57% active)
  if ((int64_t)n >= 512 * (int64_t)C)
    return launch_extents<256, 4, 1, 1>(slot, xs, ys, pix, tables, starts, n,
                                        C, vec, out, s);
  return launch_extents<128, 8, 2, 1>(slot, xs, ys, pix, tables, starts, n, C,
                                      vec, out, s);
}

namespace {

template <bool HALF, int NB, int THREADS, int I, int MINB>
int launch_counts(const CountArgs& a, cudaStream_t stream) {
  constexpr int64_t span = 32 * I, warps = THREADS / 32;
  const int64_t blocks = ((a.n + span - 1) / span + warps - 1) / warps;
  const int64_t all = blocks + ((int64_t)a.C + THREADS - 1) / THREADS;
  counts_kernel<HALF, NB, THREADS, I, MINB>
      <<<(unsigned)all, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// the layout by the span a warp counts, which lsd_fit.count_span chooses
// from the list's length and the card's SM count: 128 pixels, 4 a lane, 2
// blocks an SM; 256, 8 a lane, 4 blocks an SM
template <bool HALF, int NB>
int launch_counts_for(const CountArgs& a, int span, cudaStream_t stream) {
  if (span == 128) return launch_counts<HALF, NB, 128, 4, 2>(a, stream);
  return launch_counts<HALF, NB, 128, 8, 4>(a, stream);
}

CountArgs count_args(const int* slot, const float* xs, const float* ys,
                     const float* ang, const float* pix, const float* tables,
                     const float* bands, const int* starts, int n, int C,
                     int B, int half, float cos_tol,
                     unsigned long long* words, unsigned epoch, float* out) {
  CountArgs a{};
  a.slot = slot, a.xs = xs, a.ys = ys, a.ang = ang, a.pix = pix;
  a.tab = reinterpret_cast<const float4*>(tables);
  a.bands = reinterpret_cast<const float4*>(bands);
  a.starts = starts, a.out = out, a.words = words, a.epoch = epoch;
  a.n = n, a.C = C, a.B = B, a.cols = B + (half ? 1 : 0), a.cos_tol = cos_tol;
  a.vec = ((reinterpret_cast<uintptr_t>(slot) |
            reinterpret_cast<uintptr_t>(xs) | reinterpret_cast<uintptr_t>(ys) |
            reinterpret_cast<uintptr_t>(pix) |
            reinterpret_cast<uintptr_t>(half ? ang : xs) |
            reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  return a;
}

}  // namespace

// K10: (C, B + half) float32 counts, with half the p/2 column first (ang,
// cos_tol), over the component runs of the table starts; span: the pixels
// a warp counts, 128 or 256 (lsd_fit.count_span); words: at least 8 per
// span, epoch: not 0 and not used by an earlier call on these words (their
// buffer starts zeroed)
extern "C" int l3d_band_counts(const int* slot, const float* xs,
                               const float* ys, const float* ang,
                               const float* pix, const float* tables,
                               const float* bands, const int* starts, int n,
                               int C, int B, int half, int span,
                               float cos_tol, unsigned long long* words,
                               int64_t words_len, unsigned epoch, float* out,
                               void* stream) {
  const int cols = B + (half ? 1 : 0);
  if (n < 0 || C < 0 || B < 1 || cols > kMaxBands || epoch == 0 ||
      (span != 128 && span != 256) ||
      ((int64_t)n + span - 1) / span * (kMaxBands / 2) > words_len)
    return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const CountArgs a = count_args(slot, xs, ys, ang, pix, tables, bands,
                                 starts, n, C, B, half, cos_tol, words, epoch,
                                 out);
  cudaStream_t s = (cudaStream_t)stream;
  if (half) return launch_counts_for<true, 16>(a, span, s);
  if (cols <= 4) return launch_counts_for<false, 4>(a, span, s);
  return launch_counts_for<false, 16>(a, span, s);
}
