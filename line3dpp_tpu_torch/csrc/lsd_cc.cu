// K4: tile-local connected components of the LSD detector's aligned-pixel
// graph.
//
// Replaces line3dpp_tpu/ops/lsd_cc.py:_cc_tile_kernel / cc_tiles.  Two
// pixels of the padded (hp, wp) grid are linked when they are 8-neighbours
// in the same (th, tw) tile, both active, and their level-line angles differ
// by at most `tol` (lsd.cpp angle_diff, in float32 with the float32 values
// of 2 pi and pi).  The label of an active pixel is the flat index y * wp + x
// of the smallest pixel of its component within the tile; inactive pixels
// get INVALID = 2^30.  The Pallas kernel sweeps min-labels inside VMEM until
// nothing changes; since the labels depend on the tile graph alone, any
// exact connected-components algorithm gives the same labels bit for bit.
//
// What bounds it on the H100: memory, ideally (angle 4 B + active 1 B read,
// label 4 B written per pixel: 44 MB, 13 us at 1920 x 2560); in practice
// the dependent loads of the union-find's finds.  A union-find whose trees
// live in device memory waits on them at L2 latency, and at a real photo's
// density components chain across the grid, so its trees grow deep.
// Design, a block-based union-find in shared memory:
//   1. cc_local: one block of 1024 threads per patch of (ph, 128) pixels,
//      ph = min(th, 32) (ops/lsd_cc.py:cc_patch), which divides every tile
//      the detector uses, so a patch lies in one tile.  The block loads the
//      patch's angle and active with 16-byte loads and unites each active
//      pixel with its linked backward neighbours inside the patch
//      (union-find on patch-local indices in shared memory, atomicMin
//      hooks the larger root under the smaller, so a root is the smallest
//      local index, and row-major local order is the order of flat
//      indices).  A pixel starts pointing at its first linked neighbour,
//      a union without an atomic; a further link is skipped when a link
//      between the two neighbours (owned by an earlier pixel) already
//      joins them.  On the card that cut dense patches' time by a third.
//      It writes every pixel's patch root as a flat index, INVALID if
//      inactive.  A thread takes 4 pixels: the kernel lasts as long as
//      the busiest patch's slowest thread, and a thick edge makes long
//      chains of finds (with 256 threads of 16 pixels the facade's densest
//      patches made it 1.6 times slower).
//   2. cc_border: one block per patch unites, in device memory, the links
//      that leave the patch for another patch of the same tile: its first
//      row (4 backward links), first column (left, up-left) and last column
//      (up-right): (ph + 128) / (128 ph) of the pixels, 4% at ph = 32.
//   3. cc_flatten: one thread per 4 pixels (16-byte loads) replaces each
//      label by its root, which after step 1 is mostly one load; it stores
//      only the vectors that changed.
// No pixel loop divides by a runtime value: the blocks are 2D and the tile
// tests are made once per block.  Tree pointers only ever decrease, so a
// stale read costs an extra step and never a wrong answer; device-memory
// loads go through L2 (__ldcg).  It always converges: the unconverged-tile
// count the JAX interface returns is 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInvalid = 1 << 30;
constexpr float kTwoPi = 6.28318548202514648f;   // float32(2 pi)
constexpr float kPi = 3.14159274101257324f;      // float32(pi)
constexpr int PW = 128;      // patch width
constexpr int PH_MAX = 32;   // largest patch height
constexpr int LOCAL_THREADS = 1024;
constexpr int BORDER_THREADS = PW + 2 * PH_MAX;

__device__ __forceinline__ float angle_diff(float a, float b) {
  float d = fabsf(__fsub_rn(a, b));
  if (d > kTwoPi) d = __fsub_rn(d, kTwoPi);
  return d > kPi ? __fsub_rn(kTwoPi, d) : d;
}

struct Grid {
  int wp, th, tw, ph;
  float tol;
};

// ---- union-find in shared memory (patch-local indices)
__device__ __forceinline__ int sfind(volatile int* par, int x) {
  int p = par[x];
  while (p != x) {
    const int gp = par[p];
    if (gp != p) par[x] = gp;   // path halving: gp is still an ancestor
    x = p;
    p = gp;
  }
  return x;
}

__device__ __forceinline__ void sunite(int* par, int a, int b) {
  volatile int* vp = par;
  while (true) {
    a = sfind(vp, a);
    b = sfind(vp, b);
    if (a == b) return;
    if (a < b) {
      const int t = a; a = b; b = t;
    }
    // hook the larger root a under b; if a stopped being a root, go on
    // from where it now points
    const int old = atomicMin(par + a, b);
    if (old == a) return;
    a = old;
  }
}

// ---- union-find in device memory (flat indices)
__device__ __forceinline__ int gfind(int* lab, int x) {
  int p;
  while ((p = __ldcg(lab + x)) != x) x = p;
  return x;
}

__device__ __forceinline__ void gunite(int* lab, int a, int b) {
  while (true) {
    a = gfind(lab, a);
    b = gfind(lab, b);
    if (a == b) return;
    if (a < b) {
      const int t = a; a = b; b = t;
    }
    const int old = atomicMin(lab + a, b);
    if (old == a) return;
    a = old;
  }
}

__global__ void __launch_bounds__(LOCAL_THREADS) cc_local(
    const float* __restrict__ angle, const uint8_t* __restrict__ active,
    Grid g, int* __restrict__ labels) {
  __shared__ __align__(16) float sa[PH_MAX * PW];
  __shared__ __align__(16) uint8_t sm[PH_MAX * PW];
  __shared__ int par[PH_MAX * PW];
  const int x0 = blockIdx.x * PW, y0 = blockIdx.y * g.ph;
  const int n = g.ph * PW;
  const int64_t origin = (int64_t)y0 * g.wp + x0;

  for (int i = threadIdx.x; i < g.ph * (PW / 4); i += LOCAL_THREADS) {
    const int r = i / (PW / 4), c = (i % (PW / 4)) * 4;
    reinterpret_cast<float4*>(sa)[i] = __ldg(
        reinterpret_cast<const float4*>(angle + origin + (int64_t)r * g.wp + c));
  }
  for (int i = threadIdx.x; i < g.ph * (PW / 16); i += LOCAL_THREADS) {
    const int r = i / (PW / 16), c = (i % (PW / 16)) * 16;
    reinterpret_cast<uint4*>(sm)[i] = __ldg(
        reinterpret_cast<const uint4*>(active + origin + (int64_t)r * g.wp + c));
  }
  __syncthreads();

  // each pixel starts at its first linked backward neighbour (the
  // smallest index): that link needs no union
  for (int i = threadIdx.x; i < n; i += LOCAL_THREADS) {
    int first = i;
    if (sm[i]) {
      const int c = i % PW;
      const float a = sa[i];
      if (i >= PW && c > 0 && sm[i - PW - 1] &&
          angle_diff(a, sa[i - PW - 1]) <= g.tol) first = i - PW - 1;
      else if (i >= PW && sm[i - PW] && angle_diff(a, sa[i - PW]) <= g.tol)
        first = i - PW;
      else if (i >= PW && c < PW - 1 && sm[i - PW + 1] &&
               angle_diff(a, sa[i - PW + 1]) <= g.tol) first = i - PW + 1;
      else if (c > 0 && sm[i - 1] && angle_diff(a, sa[i - 1]) <= g.tol)
        first = i - 1;
    }
    par[i] = first;
  }
  __syncthreads();

  // the other backward links inside the patch
  for (int i = threadIdx.x; i < n; i += LOCAL_THREADS) {
    if (!sm[i]) continue;
    const int c = i % PW;
    const float a = sa[i];
    const bool ul = i >= PW && c > 0 && sm[i - PW - 1] &&
                    angle_diff(a, sa[i - PW - 1]) <= g.tol;
    const bool u = i >= PW && sm[i - PW] && angle_diff(a, sa[i - PW]) <= g.tol;
    const bool ur = i >= PW && c < PW - 1 && sm[i - PW + 1] &&
                    angle_diff(a, sa[i - PW + 1]) <= g.tol;
    const bool l = c > 0 && sm[i - 1] && angle_diff(a, sa[i - 1]) <= g.tol;
    // a link between two of these neighbours is owned by a pixel before
    // this one, so it already joins them: the union would add nothing
    if (u && ul && !(angle_diff(sa[i - PW], sa[i - PW - 1]) <= g.tol))
      sunite(par, i, i - PW);
    if (ur && (ul || u) &&
        !(u && angle_diff(sa[i - PW + 1], sa[i - PW]) <= g.tol))
      sunite(par, i, i - PW + 1);
    if (l && (ul || u || ur) &&
        !(ul && angle_diff(sa[i - 1], sa[i - PW - 1]) <= g.tol) &&
        !(u && angle_diff(sa[i - 1], sa[i - PW]) <= g.tol))
      sunite(par, i, i - 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += LOCAL_THREADS) {
    const int r = i / PW, c = i % PW;
    int lab = kInvalid;
    if (sm[i]) {
      const int root = sfind(par, i);
      lab = (int)(origin + (int64_t)(root / PW) * g.wp + root % PW);
    }
    labels[origin + (int64_t)r * g.wp + c] = lab;
  }
}

__device__ __forceinline__ void link_across(
    const float* __restrict__ angle, const uint8_t* __restrict__ active,
    float tol, int* labels, int p, int q) {
  if (__ldg(active + q) &&
      angle_diff(__ldg(angle + p), __ldg(angle + q)) <= tol)
    gunite(labels, p, q);
}

__global__ void __launch_bounds__(BORDER_THREADS) cc_border(
    const float* __restrict__ angle, const uint8_t* __restrict__ active,
    Grid g, int* labels) {
  const int x0 = blockIdx.x * PW, y0 = blockIdx.y * g.ph;
  // is the patch above / left / right in the same tile?  (once per block)
  const bool up = y0 % g.th != 0;
  const bool left = x0 % g.tw != 0;
  const bool right = (x0 + PW) % g.tw != 0;
  const int t = threadIdx.x, wp = g.wp;
  int y, x;
  if (t < PW) {
    y = y0;
    x = x0 + t;
  } else if (t < PW + g.ph - 1) {
    y = y0 + 1 + (t - PW);
    x = x0;
  } else if (t < PW + 2 * (g.ph - 1)) {
    y = y0 + 1 + (t - PW - (g.ph - 1));
    x = x0 + PW - 1;
  } else {
    return;
  }
  const int p = y * wp + x;
  if (!__ldg(active + p)) return;
  if (t < PW) {                      // first row
    if (up) {
      if (t > 0 || left) link_across(angle, active, g.tol, labels, p, p - wp - 1);
      link_across(angle, active, g.tol, labels, p, p - wp);
      if (t < PW - 1 || right)
        link_across(angle, active, g.tol, labels, p, p - wp + 1);
    }
    if (t == 0 && left) link_across(angle, active, g.tol, labels, p, p - 1);
  } else if (t < PW + g.ph - 1) {    // first column below the first row
    if (left) {
      link_across(angle, active, g.tol, labels, p, p - 1);
      link_across(angle, active, g.tol, labels, p, p - wp - 1);
    }
  } else if (right) {                // last column below the first row
    link_across(angle, active, g.tol, labels, p, p - wp + 1);
  }
}

__global__ void cc_flatten(int64_t n4, int* labels) {
  int4* lab4 = reinterpret_cast<int4*>(labels);
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int4 v = __ldcg(lab4 + i);
    int e[4] = {v.x, v.y, v.z, v.w};
    bool changed = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (e[k] == kInvalid) continue;
      int r = e[k], next;
      while (r != (next = __ldcg(labels + r))) r = next;
      changed |= r != e[k];
      e[k] = r;
    }
    if (changed) lab4[i] = make_int4(e[0], e[1], e[2], e[3]);
  }
}

}  // namespace

extern "C" int l3d_cc_tiles(const float* angle, const uint8_t* active, int hp,
                            int wp, int th, int tw, int ph, int pw, float tol,
                            int* labels, int* unconverged, void* stream) {
  if (hp <= 0 || wp <= 0 || th <= 0 || tw <= 0 || hp % th || wp % tw ||
      (int64_t)hp * wp >= kInvalid || pw != PW || ph <= 0 || ph > PH_MAX ||
      th % ph || tw % pw || ((uintptr_t)angle & 15) ||
      ((uintptr_t)active & 15) || ((uintptr_t)labels & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(unconverged, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const Grid g{wp, th, tw, ph, tol};
  const dim3 patches(wp / PW, hp / ph);
  cc_local<<<patches, LOCAL_THREADS, 0, s>>>(angle, active, g, labels);
  cc_border<<<patches, BORDER_THREADS, 0, s>>>(angle, active, g, labels);
  const int64_t n4 = (int64_t)hp * wp / 4;
  const int threads = 256;
  const int64_t want = (n4 + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  cc_flatten<<<blocks, threads, 0, s>>>(n4, labels);
  return (int)cudaGetLastError();
}
