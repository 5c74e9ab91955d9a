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
// label 4 B written per pixel: 44 MB, 13 us at 1920 x 2560), but in
// practice the latency of the dependent loads that walk the union-find
// trees.  A 128 x 512 tile of int32 labels is 256 KB, more than a block's
// shared memory, so the labels live in the output array in device memory
// (L2-resident at this size) and the whole grid works at once:
//   1. init: one thread per pixel points the pixel at its smallest linked
//      backward neighbour (up-left, up, up-right, left), or at itself;
//   2. hook: one thread per pixel unites it with each linked backward
//      neighbour (lock-free union-find: the root with the larger index is
//      hooked under the smaller with atomicCAS, so a root is always the
//      smallest index of its set; finds shorten paths as they go, as in
//      ECL-CC by Jaiganesh and Burtscher);
//   3. flatten: every active pixel takes its root as its label.
// Tree pointers only ever decrease, so a stale read costs an extra step and
// never a wrong answer; the loads go through L2 (__ldcg), not L1.  It always
// converges: the unconverged-tile count the JAX interface returns is 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInvalid = 1 << 30;
constexpr float kTwoPi = 6.28318548202514648f;   // float32(2 pi)
constexpr float kPi = 3.14159274101257324f;      // float32(pi)

__device__ __forceinline__ float angle_diff(float a, float b) {
  float d = fabsf(__fsub_rn(a, b));
  if (d > kTwoPi) d = __fsub_rn(d, kTwoPi);
  return d > kPi ? __fsub_rn(kTwoPi, d) : d;
}

struct Grid {
  int hp, wp, th, tw;
  float tol;
};

// Is pixel (y, x) linked to its neighbour (y + dy, x + dx)?
__device__ __forceinline__ bool linked(const float* __restrict__ angle,
                                       const uint8_t* __restrict__ active,
                                       const Grid& g, int y, int x, int dy,
                                       int dx) {
  const int ny = y + dy, nx = x + dx;
  if (ny < 0 || ny >= g.hp || nx < 0 || nx >= g.wp) return false;
  if (ny / g.th != y / g.th || nx / g.tw != x / g.tw) return false;
  const int64_t j = (int64_t)ny * g.wp + nx;
  if (!active[j]) return false;
  return angle_diff(angle[(int64_t)y * g.wp + x], angle[j]) <= g.tol;
}

// backward neighbours, in increasing flat index
__constant__ int kBack[4][2] = {{-1, -1}, {-1, 0}, {-1, 1}, {0, -1}};

__device__ __forceinline__ int find_root(int* parent, int x) {
  int cur = __ldcg(parent + x);
  if (cur != x) {
    int prev = x, next;
    while (cur > (next = __ldcg(parent + cur))) {
      parent[prev] = next;            // path shortening: still an ancestor
      prev = cur;
      cur = next;
    }
  }
  return cur;
}

__global__ void cc_init(const float* __restrict__ angle,
                        const uint8_t* __restrict__ active, Grid g,
                        int* __restrict__ parent) {
  const int64_t total = (int64_t)g.hp * g.wp;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    int p = kInvalid;
    if (active[i]) {
      const int y = (int)(i / g.wp), x = (int)(i % g.wp);
      p = (int)i;
      for (int k = 0; k < 4; ++k) {
        if (linked(angle, active, g, y, x, kBack[k][0], kBack[k][1])) {
          p = (y + kBack[k][0]) * g.wp + x + kBack[k][1];
          break;
        }
      }
    }
    parent[i] = p;
  }
}

__global__ void cc_hook(const float* __restrict__ angle,
                        const uint8_t* __restrict__ active, Grid g,
                        int* parent) {
  const int64_t total = (int64_t)g.hp * g.wp;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    if (!active[i]) continue;
    const int y = (int)(i / g.wp), x = (int)(i % g.wp);
    for (int k = 0; k < 4; ++k) {
      if (!linked(angle, active, g, y, x, kBack[k][0], kBack[k][1]))
        continue;
      int a = find_root(parent, (int)i);
      int b = find_root(parent,
                        (y + kBack[k][0]) * g.wp + x + kBack[k][1]);
      while (a != b) {
        if (a < b) {
          const int old = atomicCAS(parent + b, b, a);
          if (old == b) break;
          b = find_root(parent, old);
        } else {
          const int old = atomicCAS(parent + a, a, b);
          if (old == a) break;
          a = find_root(parent, old);
        }
      }
    }
  }
}

__global__ void cc_flatten(const uint8_t* __restrict__ active, int64_t total,
                           int* parent) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    if (!active[i]) continue;
    int r = __ldcg(parent + i), next;
    while (r > (next = __ldcg(parent + r))) r = next;
    parent[i] = r;
  }
}

}  // namespace

extern "C" int l3d_cc_tiles(const float* angle, const uint8_t* active, int hp,
                            int wp, int th, int tw, float tol, int* labels,
                            int* unconverged, void* stream) {
  if (hp <= 0 || wp <= 0 || th <= 0 || tw <= 0 || hp % th || wp % tw ||
      (int64_t)hp * wp >= kInvalid)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(unconverged, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const Grid g{hp, wp, th, tw, tol};
  const int64_t total = (int64_t)hp * wp;
  const int threads = 256;
  const int64_t want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  cc_init<<<blocks, threads, 0, s>>>(angle, active, g, labels);
  cc_hook<<<blocks, threads, 0, s>>>(angle, active, g, labels);
  cc_flatten<<<blocks, threads, 0, s>>>(active, total, labels);
  return (int)cudaGetLastError();
}
