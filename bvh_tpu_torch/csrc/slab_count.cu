// Slab count: how many of R rays x B boxes pass the slab test, the card's
// isolated ray-box rate (bench.py's ray_aabb_1000 leg: 131,072 rays against
// 1,000 boxes).
//
// Replaces no pallas_call: in the JAX package the leg is one XLA fusion
// (bench.py, slab_all), which keeps the R x B intermediates out of device
// memory. Plain PyTorch operations would write them out, 131 M x 3 floats
// a pass over several passes, and time the memory instead of the test, so
// the leg gets this kernel. The semantics are ray.py::ray_intersects_aabb's:
// t1 = (lo - o) * inv, t2 = (hi - o) * inv on each axis, tmin the largest
// per-axis min, tmax the smallest per-axis max, a hit where
// tmax >= max(tmin, 0); a NaN in any product (a ray in a box's face plane)
// is a miss.
//
// What bounds it on an H100: operations. A test is ~37 float32 operations
// (ops/slab.py::SLAB_COUNT_OPS) on 24 bytes of box, and the rays and boxes
// together are a few MB read once. The design:
//
//   * one ray a thread, its origin and inverse direction in registers;
//   * the boxes staged through shared memory a tile of TILE at a time, one
//     32-byte record a box read as two float4: every lane of a warp reads
//     the same record, a broadcast;
//   * min and max propagate NaN (trace_common.cuh::min_nan, max_nan), so a
//     NaN product makes tmin or tmax NaN and the compare false, as the plain
//     version's explicit NaN test does: fminf and fmaxf would return the
//     other operand and count such a ray as a hit;
//   * a register count a thread, a warp reduction, one atomicAdd a block
//     into a 64-bit word that the wrapper zeroes.
//
// Numerics: built with -fmad=false (ops/_build.py) and the products written
// as (lo - o) * inv, each difference and product rounded once, as the plain
// version rounds them; the count then equals the plain count exactly.

#include "trace_common.cuh"

namespace {

constexpr int BLOCK = 256;  // rays (threads) a block
constexpr int TILE = 1024;  // boxes a block stages at a time: 32 KB

__global__ void __launch_bounds__(BLOCK)
slab_count_kernel(const float* __restrict__ o, const float* __restrict__ inv,
                  int n, const float* __restrict__ lo,
                  const float* __restrict__ hi, int nb,
                  unsigned long long* __restrict__ count) {
  // box k: (lo x, lo y, lo z, hi x) and (hi y, hi z, -, -)
  __shared__ float4 boxes[TILE][2];
  __shared__ unsigned long long warp_sums[BLOCK / 32];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool live = i < n;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, ix = 0.0f, iy = 0.0f, iz = 0.0f;
  if (live) {
    ox = o[3 * i];
    oy = o[3 * i + 1];
    oz = o[3 * i + 2];
    ix = inv[3 * i];
    iy = inv[3 * i + 1];
    iz = inv[3 * i + 2];
  }
  unsigned hits = 0;
  for (int base = 0; base < nb; base += TILE) {
    const int m = min(TILE, nb - base);
    __syncthreads();  // the previous tile is read by every thread
    for (int k = threadIdx.x; k < m; k += BLOCK) {
      const int j = 3 * (base + k);
      boxes[k][0] = make_float4(lo[j], lo[j + 1], lo[j + 2], hi[j]);
      boxes[k][1] = make_float4(hi[j + 1], hi[j + 2], 0.0f, 0.0f);
    }
    __syncthreads();
    if (live) {
      for (int k = 0; k < m; ++k) {
        const float4 u = boxes[k][0];
        const float4 v = boxes[k][1];
        const float t1 = (u.x - ox) * ix;
        const float t2 = (u.w - ox) * ix;
        const float u1 = (u.y - oy) * iy;
        const float u2 = (v.x - oy) * iy;
        const float v1 = (u.z - oz) * iz;
        const float v2 = (v.y - oz) * iz;
        const float tmin = max_nan(max_nan(min_nan(t1, t2), min_nan(u1, u2)),
                                   min_nan(v1, v2));
        const float tmax = min_nan(min_nan(max_nan(t1, t2), max_nan(u1, u2)),
                                   max_nan(v1, v2));
        hits += tmax >= max_nan(tmin, 0.0f) ? 1u : 0u;
      }
    }
  }
  unsigned long long s = hits;
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(FULL, s, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int w = 0; w < BLOCK / 32; ++w) total += warp_sums[w];
    if (total) atomicAdd(count, total);
  }
}

}  // namespace

// o, inv: [n, 3] float32; lo, hi: [nb, 3] float32; count: one uint64 word,
// zeroed by the caller.
extern "C" int slab_count_launch(const float* o, const float* inv, int n,
                                 const float* lo, const float* hi, int nb,
                                 unsigned long long* count, void* stream) {
  if (n <= 0 || nb <= 0) return 0;
  const int grid = (n + BLOCK - 1) / BLOCK;
  slab_count_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(o, inv, n, lo,
                                                              hi, nb, count);
  return (int)cudaGetLastError();
}
