// The interval sweep: each cluster's member segments projected onto its 3D
// line, the endpoint events swept over distinct open cameras, and the
// cluster's reference view chosen; one launch, a warp per cluster.
//
// Replaces no Pallas kernel: the JAX package's sweep (line3dpp_tpu/ops/
// sweep.py sweep_all_flat) is host numpy.  It takes the place of the
// port's host stage: two copies of the whole (V, S, 3) ray tables to the
// host, fitting.project_members_onto_lines_np in float64 over every
// member, sweep.sweep_all_flat (three lexsorts over the 2m endpoint events,
// fancy indexing, cumulative sums) and a fourth lexsort for the reference
// views, ~36-44 ms a scene of the 26 cached views on the card's host
// (recon.sweep, traced).
//
// What bounds it on the H100: latency.  The 26-view scene has ~2300
// clusters of 3-61 members, ~16,000-19,000 members in all: each member's
// two rays (24 B), its segment (16 B), its ids and its cluster's line are
// read once, ~1 MB, under 1 us at 3.35 TB/s, and the arithmetic is a few
// dozen float64 operations a member and a sort of at most a few hundred
// keys a cluster.  What the launch takes is the longest cluster's chain of
// dependent steps: two warp sorts and a walk over its events on one lane.
//
// Design.  The members come in cluster order (a stable argsort of the
// member clusters on the host: `bounds` is the CSR offset of each
// cluster), and warp c takes cluster c.  Its lanes
//   1. pick the reference view: the camera of the longest member 2D
//      segment, the first member winning ties, by a warp reduction
//      (glibc's hypotf, which numpy's float32 hypot calls: the float32
//      differences squared and summed in double, the double square root
//      rounded to float);
//   2. project each member's two segment rays onto the line in float64,
//      in numpy's order (three-term sums as (x0 y0 + x1 y1) + x2 y2, each
//      operation rounded on its own: __dmul_rn, __dadd_rn, no FMA), keep
//      the members with |a c - b^2| > 1e-12 for both rays, compacted in
//      member order by ballots, and emit nothing below 3 kept members;
//   3. take the border: the endpoint with the largest |p - 1|, the later
//      event in numpy's event order (all s1 of the kept members in member
//      order, then all s2) winning ties;
//   4. sort the kept members by camera (a bitonic sort of (camera, rank)),
//      so that lane 0 numbers each member's camera by the first sorted
//      position of its camera: the open counts are kept per camera of the
//      cluster's own, and V has no size limit;
//   5. sort the 2n events by (|p - border|, event index), bitonic;
//   6. walk the sorted events on lane 0: a member's first event opens it,
//      its second closes it; a camera's count going 0 -> 1 adds a distinct
//      open camera, 1 -> 0 removes one; an interval starts where the
//      distinct count reaches `visibility` and ends where it drops below.
// Intervals come out in sweep order at the cluster's CSR offset (a
// cluster cannot emit more intervals than it has members), with their
// count; the host compacts them after one read.  The order of floats is
// numpy's (a NaN after every number), so a NaN sorts and wins as it does
// there.
//
// A cluster of at most kCap members keeps its members and events in the
// warp's slice of shared memory; a longer one uses global scratch at its
// own CSR offset (4 m_c event slots, the next power of two of 2 m_c at
// most), with the same code on generic pointers.  Integer and comparison
// logic after the float64 projection, and no atomics: the same bits as
// the numpy path, and two runs give the same bits.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;               // warps (clusters) a block
constexpr int kCap = 128;               // sweep.SMEM_MEMBERS
constexpr int kEvents = 2 * kCap;
// the validity bound of fitting.project_members_onto_lines_np
constexpr double kDenomEps = 1e-12;
constexpr unsigned kFull = 0xffffffffu;

// a warp's slice of shared memory
struct Slice {
  double key[kEvents];                  // sort keys
  double p[kEvents];                    // event parameters: s1, then s2
  int idx[kEvents];                     // sort payloads
  int cam[kCap];                        // kept members' views
  int slot[kCap];                       // their camera's number
  int count[kCap];                      // open members per camera number
  unsigned char seen[kCap];             // a member's first event passed
};

// the global scratch of the clusters past kCap, each at its CSR offset
// m0: key[4 m0 ...], p[2 m0 ...], idx[4 m0 ...], cam, slot, count and
// seen[m0 ...]; 77 bytes a member in all (sweep.SCRATCH_BYTES)
struct Work {
  double* key;
  double* p;
  int* idx;
  int* cam;
  int* slot;
  int* count;
  unsigned char* seen;
};

// numpy's sort order of floats: a NaN after every number, NaNs equal
__device__ __forceinline__ bool fless(double a, double b) {
  return a < b || (b != b && a == a);
}
__device__ __forceinline__ bool fsame(double a, double b) {
  return a == b || (a != a && b != b);
}
// (key, index) pairs as a stable sort orders them
__device__ __forceinline__ bool before(double ka, int ia, double kb,
                                       int ib) {
  return fless(ka, kb) || (fsame(ka, kb) && ia < ib);
}

__device__ __forceinline__ int pow2_at_least(int n) {
  return n <= 1 ? 1 : 1 << (32 - __clz(n - 1));
}

// ascending bitonic sort of n2 (a power of two) (key, idx) pairs by the
// warp; every pair is distinct (the indices are), so the order is total
__device__ void warp_sort(double* key, int* idx, int n2, int lane) {
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = lane; t < n2 / 2; t += 32) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int q = i | j;
        const double ki = key[i], kq = key[q];
        const int ii = idx[i], iq = idx[q];
        if (before(kq, iq, ki, ii) == ((i & k) == 0)) {
          key[i] = kq;
          key[q] = ki;
          idx[i] = iq;
          idx[q] = ii;
        }
      }
      __syncwarp();
    }
  }
}

// glibc's hypotf (sysdeps/ieee754/flt-32/e_hypotf.c), which numpy's
// float32 hypot calls: exact squares, one double rounding of the sum, the
// double square root rounded to float
__device__ __forceinline__ float glibc_hypotf(float x, float y) {
  if (isinf(x) || isinf(y)) return INFINITY;
  if (isnan(x) || isnan(y)) return x + y;
  const double xd = x, yd = y;
  return __double2float_rn(
      __dsqrt_rn(__dadd_rn(__dmul_rn(xd, xd), __dmul_rn(yd, yd))));
}

__device__ __forceinline__ double dot3(const double* a, const double* b) {
  return __dadd_rn(__dadd_rn(__dmul_rn(a[0], b[0]), __dmul_rn(a[1], b[1])),
                   __dmul_rn(a[2], b[2]));
}

// the parameter of the point of the line (P, D) closest to the ray v from
// the camera (w = P - C), and whether |a c - b^2| > 1e-12
__device__ __forceinline__ double line_param(const double* D, double a,
                                             const double* w,
                                             const float* __restrict__ ray,
                                             bool& ok) {
  const double v[3] = {ray[0], ray[1], ray[2]};
  const double b = dot3(D, v), c = dot3(v, v), d = dot3(D, w),
               e = dot3(v, w);
  const double denom = __dsub_rn(__dmul_rn(a, c), __dmul_rn(b, b));
  ok = fabs(denom) > kDenomEps;
  return __ddiv_rn(__dsub_rn(__dmul_rn(b, e), __dmul_rn(c, d)),
                   ok ? denom : 1.0);
}

__global__ void __launch_bounds__(32 * kWarps) sweep_kernel(
    const float* __restrict__ r1,         // (V, S, 3)
    const float* __restrict__ r2,         // (V, S, 3)
    const float* __restrict__ segs,       // (V, S, 4)
    const float* __restrict__ cam_C,      // (V, 3)
    const double* __restrict__ line_P1,   // (C, 3)
    const double* __restrict__ line_dir,  // (C, 3)
    const int* __restrict__ mview,        // (m,) in cluster order
    const int* __restrict__ mseg,         // (m,)
    const int* __restrict__ bounds,       // (C + 1,)
    int C, int m, int S, int visibility, unsigned char* scratch,
    double* __restrict__ out_sa,          // (m,) at each cluster's offset
    double* __restrict__ out_sb,          // (m,)
    int* __restrict__ out_n,              // (C,) intervals a cluster
    int* __restrict__ out_ref) {          // (C,) reference views
  __shared__ Slice slices[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + warp;
  if (c >= C) return;                     // the whole warp
  const int m0 = bounds[c], mc = bounds[c + 1] - m0;

  // 1. the reference view: the longest member 2D segment, the first wins
  float best = 0.0f;
  int bj = -1;
  for (int j = lane; j < mc; j += 32) {
    const float* q = segs + ((int64_t)mview[m0 + j] * S + mseg[m0 + j]) * 4;
    const float len = glibc_hypotf(__fsub_rn(q[2], q[0]),
                                   __fsub_rn(q[3], q[1]));
    if (bj < 0 || fless(best, len)) {
      best = len;
      bj = j;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, off);
    const int oj = __shfl_xor_sync(kFull, bj, off);
    if (oj >= 0 && (bj < 0 || fless(best, ob) ||
                    (fsame(best, ob) && oj < bj))) {
      best = ob;
      bj = oj;
    }
  }
  if (lane == 0) out_ref[c] = bj >= 0 ? mview[m0 + bj] : 0;

  Work w;
  if (mc <= kCap) {
    Slice& s = slices[warp];
    w = Work{s.key, s.p, s.idx, s.cam, s.slot, s.count, s.seen};
  } else {
    double* dbl = reinterpret_cast<double*>(scratch);
    int* ints = reinterpret_cast<int*>(scratch + 48 * (int64_t)m);
    w = Work{dbl + 4 * (int64_t)m0, dbl + 4 * (int64_t)m + 2 * m0,
             ints + 4 * (int64_t)m0, ints + 4 * (int64_t)m + m0,
             ints + 5 * (int64_t)m + m0, ints + 6 * (int64_t)m + m0,
             scratch + 76 * (int64_t)m + m0};
  }

  // 2. the kept members' projections in member order: s1 into p, s2 into
  // key until their count is known
  const double P[3] = {line_P1[3 * c], line_P1[3 * c + 1],
                       line_P1[3 * c + 2]};
  const double D[3] = {line_dir[3 * c], line_dir[3 * c + 1],
                       line_dir[3 * c + 2]};
  const double a = dot3(D, D);
  int n = 0;
  for (int base = 0; base < mc; base += 32) {
    const int j = base + lane;
    bool ok = false;
    double s1 = 0.0, s2 = 0.0;
    int v = 0;
    if (j < mc) {
      v = mview[m0 + j];
      const int64_t g = ((int64_t)v * S + mseg[m0 + j]) * 3;
      const double wv[3] = {__dsub_rn(P[0], (double)cam_C[3 * v]),
                            __dsub_rn(P[1], (double)cam_C[3 * v + 1]),
                            __dsub_rn(P[2], (double)cam_C[3 * v + 2])};
      bool ok1, ok2;
      s1 = line_param(D, a, wv, r1 + g, ok1);
      s2 = line_param(D, a, wv, r2 + g, ok2);
      ok = ok1 && ok2;
    }
    const unsigned ball = __ballot_sync(kFull, ok);
    if (ok) {
      const int r = n + __popc(ball & ((1u << lane) - 1u));
      w.p[r] = s1;
      w.key[r] = s2;
      w.cam[r] = v;
    }
    n += __popc(ball);
  }
  if (n < 3) {
    if (lane == 0) out_n[c] = 0;
    return;
  }
  __syncwarp();
  for (int r = lane; r < n; r += 32) w.p[n + r] = w.key[r];
  __syncwarp();

  // 3. the border: the largest |p - 1|, the later event on ties
  const int ne = 2 * n;
  double far = 0.0;
  int fe = -1;
  for (int e = lane; e < ne; e += 32) {
    const double d = fabs(__dsub_rn(w.p[e], 1.0));
    if (fe < 0 || !fless(d, far)) {
      far = d;
      fe = e;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const double of = __shfl_xor_sync(kFull, far, off);
    const int oe = __shfl_xor_sync(kFull, fe, off);
    if (oe >= 0 && (fe < 0 || fless(far, of) ||
                    (fsame(far, of) && oe > fe))) {
      far = of;
      fe = oe;
    }
  }
  const double border = w.p[fe];

  // 4. the members by camera; lane 0 numbers the cameras
  const int n2 = pow2_at_least(n);
  for (int i = lane; i < n2; i += 32) {
    w.key[i] = i < n ? (double)w.cam[i] : __longlong_as_double(~0ll);
    w.idx[i] = i;
  }
  __syncwarp();
  warp_sort(w.key, w.idx, n2, lane);
  if (lane == 0) {
    int first = 0;
    for (int q = 0; q < n; ++q) {
      if (q > 0 && w.key[q] != w.key[q - 1]) first = q;
      w.slot[w.idx[q]] = first;
      w.count[q] = 0;
      w.seen[q] = 0;
    }
  }
  __syncwarp();

  // 5. the events by (distance to the border, event index)
  const int e2 = pow2_at_least(ne);
  for (int i = lane; i < e2; i += 32) {
    w.key[i] = i < ne ? fabs(__dsub_rn(w.p[i], border))
                      : __longlong_as_double(~0ll);
    w.idx[i] = i;
  }
  __syncwarp();
  warp_sort(w.key, w.idx, e2, lane);

  // 6. the walk
  if (lane == 0) {
    int open = 0, niv = 0;
    bool prev = false;
    double start = 0.0;
    for (int t = 0; t < ne; ++t) {
      const int e = w.idx[t];
      const int r = e < n ? e : e - n;
      const int k = w.slot[r];
      if (!w.seen[r]) {
        w.seen[r] = 1;
        if (w.count[k]++ == 0) ++open;
      } else if (--w.count[k] == 0) {
        --open;
      }
      const bool above = open >= visibility;
      if (above && !prev) {
        start = w.p[e];
      } else if (!above && prev) {
        out_sa[m0 + niv] = start;
        out_sb[m0 + niv] = w.p[e];
        ++niv;
      }
      prev = above;
    }
    out_n[c] = niv;
  }
}

}  // namespace

// 9 inputs (r1, r2 (V, S, 3), segments (V, S, 4), camera centres (V, 3),
// the lines' P1 and unit directions (C, 3) float64, the members' views
// and segments in cluster order (m,), the CSR bounds (C + 1,)), C m S
// visibility, the global scratch (SCRATCH_BYTES x m, or null when no
// cluster has more than kCap members), 4 outputs, stream
extern "C" int l3d_sweep(const float* r1, const float* r2, const float* segs,
                         const float* cam_C, const double* line_P1,
                         const double* line_dir, const int* mview,
                         const int* mseg, const int* bounds, int C, int m,
                         int S, int visibility, unsigned char* scratch,
                         double* out_sa, double* out_sb, int* out_n,
                         int* out_ref, void* stream) {
  if (C < 0 || m < 0 || S < 0 || visibility < 1)
    return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const unsigned blocks = (unsigned)((C + kWarps - 1) / kWarps);
  sweep_kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      r1, r2, segs, cam_C, line_P1, line_dir, mview, mseg, bounds, C, m, S,
      visibility, scratch, out_sa, out_sb, out_n, out_ref);
  return (int)cudaGetLastError();
}
