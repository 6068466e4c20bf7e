// The closest-hit tracer's coherence order and ray rows: the sort key of a
// batch of rays in two launches (the origins' bounds, then the key), and the
// rays gathered in the sorted order straight into the walk's 13 ray rows,
// then the un-sorting permutation, in two more (ops/trace.py::make_tracer
// and sort_rays_device; wrapper ops/order.py).
//
// Replaces no pallas_call: in the JAX package these are XLA fusions
// (bvh_tpu/ops/trace.py, sort_rays_device's key and the gather and
// _ray_rows of make_tracer's prologue). Their plain PyTorch form,
// ops/trace.py's _sort_key_plain (bvh/lbvh.py::morton_codes and the octant),
// _order's scatter, _take, ray.py::Ray.create and _prologue, is some 90
// launches a call, each writing its [n] intermediates to device memory.
//
//   key: lo, hi = the origins' amin and amax; extent = max(hi - lo, 1e-30);
//        octant = 4 (dx > 0) + 2 (dy > 0) + (dz > 0);
//        "morton":    m = spread(g(x)) << 2 | spread(g(y)) << 1 | spread(g(z)),
//                     g = clamp(int((o - lo) / extent * 1024), 0, 1023),
//                     key = (m >> 3) << 3 | octant;
//        "octmorton": key = octant << 27 | m >> 3;
//        "octant":    q = int((o - lo) * ((1 / extent) * (2^bits - 1))),
//                     key = octant << 3 bits | qx << 2 bits | qy << bits | qz
//                     (the scale as PyTorch forms c / x: x.reciprocal() * c);
//   rows, thread i of the sorted order, p = perm[i]: d = d[p] / |d[p]| with
//        |d|^2 = (dx^2 + dz^2) + dy^2 (the card's torch.sum over three: two
//        lanes, the first holding x and z), inv = 1 / d clamped to +-1e30,
//        rows o.inv (3), inv (3), t_max = +inf, d (3), o (3) in column i;
//   un-sort, thread i: inv_perm[perm[i]] = i.
//
// What bounds it on an H100: bytes. The key reads o and d once (24 bytes a
// ray; o a second time from L2) and writes 4; the rows and the un-sort read
// perm, o and d (32) and write 13 rows and inv_perm (60): ~0.03 ms of HBM3
// at 1,048,576 rays for both, beside the argsort between them. The design:
//
//   * the bounds without atomics, a fill or a host read: a first pass writes
//     per-block min/max partials (block b of P reads the flat [3n] origins
//     at a stride that is a multiple of 3, so each thread keeps one axis and
//     the loads are coalesced), and every block of the key kernel reduces
//     the P partials itself (P <= 264, 6 KB from L2) before its rays; min and
//     max are exact, so the bounds are amin's and amax's;
//   * the key kernel's blocks (at most 8 an SM) loop over the rays, so that
//     few blocks read the partials; neighbouring threads take neighbouring
//     rays;
//   * the rows kernel reads ray perm[i] (24 bytes, at random where the rays
//     come in no coherent order: ~2.5 32-byte sectors a ray) and writes the
//     13 rows coalesced;
//   * the un-sort's scatter (8 bytes a ray) is a launch of its own: written
//     from the rows kernel it measured 0.277 against 0.207 ms for both
//     launches on 2,097,152 uniform random rays (the benchmark's random
//     cell), 0.040 against 0.045 on 1,048,576 aimed ones (H100, the key,
//     argsort and rows as one CUDA graph, inputs cold in L2); writing it
//     first in the rows kernel, or two or four rays a thread, changed
//     nothing, nor did streaming stores of the rows or a packed copy of the
//     rays to gather from.
//
// Numerics: built with -fmad=false (ops/_build.py), every product, sum and
// quotient rounded on its own in the plain composition's order, IEEE
// division, square root and reciprocal, NaN propagated by the bounds as
// amin and amax propagate it, float -> int by truncation as the card's
// conversion does, and shifts as PyTorch's (0 for a count outside 0..31):
// the key, the order and the rows equal the plain composition's bit for bit.

#include <cstdint>

namespace {

constexpr int BLOCK = 256;         // threads a block, key and rows kernels
constexpr int BOUNDS_BLOCK = 384;  // 3 x 128: one axis a thread
constexpr int MAX_PARTS = 264;     // bounds blocks (2 an SM)
constexpr int UNROLL = 8;          // bounds loads in flight a thread
constexpr int KEY_BLOCKS = 1056;   // key blocks at most (8 an SM)

// amin's and amax's combine: NaN wins
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// PyTorch's << on int32: 0 for a count outside [0, 32)
__device__ __forceinline__ int shl(int a, int b) {
  return (b < 0 || b >= 32) ? 0 : (int)((unsigned)a << b);
}

// bvh/lbvh.py::_expand_bits_10
__device__ __forceinline__ int spread10(int v) {
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}

// Block b's min and max of each axis over the flat origins o[0 .. 3n):
// part[6 b + k] = min of axis k, part[6 b + 3 + k] = max.
__global__ void __launch_bounds__(BOUNDS_BLOCK)
ray_bounds_kernel(const float* __restrict__ o, long long n3,
                  float* __restrict__ part) {
  __shared__ float s_lo[BOUNDS_BLOCK], s_hi[BOUNDS_BLOCK];
  const int t = threadIdx.x;
  const long long stride = (long long)gridDim.x * BOUNDS_BLOCK;  // 3 | stride
  float lo = __int_as_float(0x7F800000), hi = -lo;
  for (long long j = (long long)blockIdx.x * BOUNDS_BLOCK + t; j < n3;
       j += UNROLL * stride) {
    float x[UNROLL];
    x[0] = __ldg(o + j);
#pragma unroll
    for (int u = 1; u < UNROLL; ++u) {
      const long long k = j + u * stride;  // the same axis as j
      x[u] = k < n3 ? __ldg(o + k) : x[0];  // a repeat changes no bound
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      lo = min_nan(lo, x[u]);
      hi = max_nan(hi, x[u]);
    }
  }
  s_lo[t] = lo;
  s_hi[t] = hi;
  // a tree over the 128 threads of each axis: every step a multiple of 3
  for (int s = BOUNDS_BLOCK / 2; s >= 3; s /= 2) {
    __syncthreads();
    if (t < s) {
      s_lo[t] = min_nan(s_lo[t], s_lo[t + s]);
      s_hi[t] = max_nan(s_hi[t], s_hi[t + s]);
    }
  }
  __syncthreads();
  if (t < 3) {
    part[6 * blockIdx.x + t] = s_lo[t];
    part[6 * blockIdx.x + 3 + t] = s_hi[t];
  }
}

// The key of every ray; mode 0 "octant" (bits, cells = 2^bits - 1),
// 1 "morton", 2 "octmorton".
__global__ void __launch_bounds__(BLOCK)
ray_key_kernel(const float* __restrict__ o, const float* __restrict__ d,
               int n, const float* __restrict__ part, int n_parts, int mode,
               int bits, float cells, int* __restrict__ key) {
  __shared__ float s_b[6][BLOCK / 32];
  __shared__ float s_lo[3], s_ext[3], s_scale[3];
  const int t = threadIdx.x;
  // this block's reduction of the partials
  float b[6];
  for (int k = 0; k < 3; ++k) {
    b[k] = __int_as_float(0x7F800000);
    b[3 + k] = -b[k];
  }
  for (int j = t; j < n_parts; j += BLOCK) {
    for (int k = 0; k < 3; ++k) {
      b[k] = min_nan(b[k], __ldg(part + 6 * j + k));
      b[3 + k] = max_nan(b[3 + k], __ldg(part + 6 * j + 3 + k));
    }
  }
  for (int off = 16; off > 0; off /= 2) {
    for (int k = 0; k < 3; ++k) {
      b[k] = min_nan(b[k], __shfl_down_sync(0xFFFFFFFFu, b[k], off));
      b[3 + k] =
          max_nan(b[3 + k], __shfl_down_sync(0xFFFFFFFFu, b[3 + k], off));
    }
  }
  if ((t & 31) == 0) {
    for (int k = 0; k < 6; ++k) s_b[k][t >> 5] = b[k];
  }
  __syncthreads();
  if (t < 3) {
    float lo = s_b[t][0], hi = s_b[3 + t][0];
    for (int w = 1; w < BLOCK / 32; ++w) {
      lo = min_nan(lo, s_b[t][w]);
      hi = max_nan(hi, s_b[3 + t][w]);
    }
    // torch.clamp_min(hi - lo, 1e-30): NaN stays NaN
    const float e = hi - lo;
    const float ext = e != e ? e : fmaxf(e, 1e-30f);
    s_lo[t] = lo;
    s_ext[t] = ext;
    s_scale[t] = (1.0f / ext) * cells;  // x.reciprocal() * c
  }
  __syncthreads();
  for (int i = blockIdx.x * BLOCK + t; i < n; i += gridDim.x * BLOCK) {
    const size_t r = 3 * (size_t)i;
    const float dx = __ldg(d + r), dy = __ldg(d + r + 1), dz = __ldg(d + r + 2);
    const int oct = (dx > 0.0f) * 4 + (dy > 0.0f) * 2 + (dz > 0.0f);
    int g[3];
    for (int k = 0; k < 3; ++k) {
      const float x = __ldg(o + r + k) - s_lo[k];
      if (mode == 0) {
        g[k] = (int)(x * s_scale[k]);
      } else {
        const int c = (int)((x / s_ext[k]) * 1024.0f);
        g[k] = min(max(c, 0), 1023);
      }
    }
    int out;
    if (mode == 0) {
      out = shl(oct, 3 * bits) | shl(g[0], 2 * bits) | shl(g[1], bits) | g[2];
    } else {
      const int m = (spread10(g[0]) << 2) | (spread10(g[1]) << 1) |
                    spread10(g[2]);
      out = mode == 1 ? ((m >> 3) << 3) | oct : (oct << 27) | (m >> 3);
    }
    key[i] = out;
  }
}

// Thread i: ray p = perm[i] (i without perm) normalised and written to
// column i of rows [13, n].
template <bool PERM>
__global__ void __launch_bounds__(BLOCK)
ray_rows_kernel(const float* __restrict__ o, const float* __restrict__ d,
                const long long* __restrict__ perm, int n,
                float* __restrict__ rows) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const long long p = PERM ? __ldg(perm + i) : (long long)i;
  const size_t r = 3 * (size_t)p;
  const float ox = __ldg(o + r), oy = __ldg(o + r + 1), oz = __ldg(o + r + 2);
  float dx = __ldg(d + r), dy = __ldg(d + r + 1), dz = __ldg(d + r + 2);
  // ray.py::Ray.create: d / sqrt(sum(d * d)), then 1 / d
  const float norm = __fsqrt_rn((dx * dx + dz * dz) + dy * dy);
  dx = dx / norm;
  dy = dy / norm;
  dz = dz / norm;
  float inv[3] = {1.0f / dx, 1.0f / dy, 1.0f / dz};
  for (int k = 0; k < 3; ++k) {
    // torch.clamp(inv, -1e30, 1e30): NaN stays NaN
    inv[k] = inv[k] != inv[k] ? inv[k] : fminf(fmaxf(inv[k], -1.0e30f), 1.0e30f);
  }
  const size_t N = (size_t)n;
  float* col = rows + i;
  col[0] = ox * inv[0];
  col[N] = oy * inv[1];
  col[2 * N] = oz * inv[2];
  col[3 * N] = inv[0];
  col[4 * N] = inv[1];
  col[5 * N] = inv[2];
  col[6 * N] = __int_as_float(0x7F800000);
  col[7 * N] = dx;
  col[8 * N] = dy;
  col[9 * N] = dz;
  col[10 * N] = ox;
  col[11 * N] = oy;
  col[12 * N] = oz;
}

// Thread i: inv_perm[perm[i]] = i.
__global__ void __launch_bounds__(BLOCK)
ray_unsort_kernel(const long long* __restrict__ perm, int n,
                  long long* __restrict__ inv_perm) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i < n) inv_perm[__ldg(perm + i)] = i;
}

}  // namespace

// The bounds partials' count for n rays: the float [6 * count] scratch that
// ray_key_launch takes.
extern "C" int ray_bounds_parts(int n) {
  const long long blocks =
      (3LL * n + BOUNDS_BLOCK * 8 - 1) / (BOUNDS_BLOCK * 8);  // >= 8 a thread
  return (int)(blocks < 1 ? 1 : (blocks > MAX_PARTS ? MAX_PARTS : blocks));
}

// o, d: [n, 3] float32, contiguous; part: float [6 * ray_bounds_parts(n)]
// scratch; mode 0 "octant", 1 "morton", 2 "octmorton"; cells: 2^bits - 1 as
// float32 (octant only); key: [n] int32.
extern "C" int ray_key_launch(const float* o, const float* d, int n,
                              float* part, int mode, int bits, float cells,
                              int* key, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int n_parts = ray_bounds_parts(n);
  ray_bounds_kernel<<<n_parts, BOUNDS_BLOCK, 0, s>>>(o, 3LL * n, part);
  const int blocks = (n + BLOCK - 1) / BLOCK;
  ray_key_kernel<<<blocks < KEY_BLOCKS ? blocks : KEY_BLOCKS, BLOCK, 0, s>>>(
      o, d, n, part, n_parts, mode, bits, cells, key);
  return (int)cudaGetLastError();
}

// o, d: [n, 3] float32, contiguous; perm: [n] int64 or null (the identity);
// rows: [13, n] float32; inv_perm: [n] int64 (written where perm is given,
// by a second launch).
extern "C" int ray_rows_launch(const float* o, const float* d,
                               const long long* perm, int n, float* rows,
                               long long* inv_perm, void* stream) {
  if (n <= 0) return 0;
  const int grid = (n + BLOCK - 1) / BLOCK;
  const cudaStream_t s = (cudaStream_t)stream;
  if (perm != nullptr) {
    ray_rows_kernel<true><<<grid, BLOCK, 0, s>>>(o, d, perm, n, rows);
    ray_unsort_kernel<<<grid, BLOCK, 0, s>>>(perm, n, inv_perm);
  } else {
    ray_rows_kernel<false><<<grid, BLOCK, 0, s>>>(o, d, perm, n, rows);
  }
  return (int)cudaGetLastError();
}
