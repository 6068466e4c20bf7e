// Wide (16-ary) group-walk closest-hit and any-hit trace, one thread per ray.
//
// Replaces the TPU kernel bvh_tpu/ops/trace.py::_wide_body (built by
// _make_wide_kernel, launched by _trace_wide_jit), with its walk engine
// _make_mask_walk/_ctz16 and its leaf test _narrow_cluster (shared with the
// entry/exit kernel in trace_common.cuh). The TPU kernel walks one shared
// cursor per packet of rays, keeps the node table in scalar memory and runs
// the leaf test as a matrix product. Here each ray walks on its own, which
// computes the same function:
//
//   * hints (optional): the leaf slots g*K+k listed for the ray's packet are
//     narrowphased first, without a box test (-1 in the packet's first slot
//     turns them off);
//   * per group: slab-test all 16 children against the ray's current bound
//     vb, giving the fired mask; narrowphase every fired leaf bit in
//     ascending order; then visit the fired interior children lowest bit
//     first (a DFS stack of (group, remaining mask), depth WIDE_DMAX);
//   * modes closest, bounded and any (trace_common.cuh). Once vb is -inf
//     (an any-hit ray found its occluder) no box can fire again, so the walk
//     ends after the group in hand: the result is bit for bit that of the
//     full walk.
//
// What bounds it on an H100: the float32 operations of the slab tests and
// the leaf tests (per ray: 16 slab tests per visited group, W triangle
// tests per fired leaf); the tables (a few MB) stay in L2. Threads of a
// warp diverge where their rays walk different subtrees; the caller's
// coherence sort keeps neighbouring rays on similar paths. This first
// version is the simple, exact design: no shared-memory staging, no
// packet frustum, no persistent threads.
//
// Numerics: see trace_common.cuh; the leaf mask is a float VALUE too.

#include "trace_common.cuh"

namespace {

constexpr int K = 16;          // children per group
constexpr int WIDE_DMAX = 16;  // DFS stack depth

struct Tables {
  const float* gnodes;  // [7K+1, Gn]
  const float* groups;  // [G, 16, 128]
  int Gn;
  int W;
  int mode;
};

// Leaf test of the cluster in slot k of group g.
__device__ void narrow_slot(RayState& r, const Tables& tb, int g, int k) {
  const float* col = tb.gnodes + g;
  const int Gn = tb.Gn;
  float ax = __ldg(col + (7 * k + 0) * Gn), ay = __ldg(col + (7 * k + 1) * Gn);
  float az = __ldg(col + (7 * k + 2) * Gn), bx = __ldg(col + (7 * k + 3) * Gn);
  float by = __ldg(col + (7 * k + 4) * Gn), bz = __ldg(col + (7 * k + 5) * Gn);
  int c = (int)(-__ldg(col + (7 * k + 6) * Gn) - 1.0f);
  narrow_cluster(r, tb.groups, tb.W, c, (ax + bx) * 0.5f, (ay + by) * 0.5f,
                 (az + bz) * 0.5f, tb.mode);
}

// Tests group g; narrowphases its fired leaves; returns the fired
// interior bits.
__device__ int enter(RayState& r, const Tables& tb, int g) {
  const float* col = tb.gnodes + g;
  const int Gn = tb.Gn;
  int m = 0;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float* ch = col + 7 * k * Gn;
    if (slab_fires(r, __ldg(ch), __ldg(ch + Gn), __ldg(ch + 2 * Gn),
                   __ldg(ch + 3 * Gn), __ldg(ch + 4 * Gn), __ldg(ch + 5 * Gn)))
      m |= 1 << k;
  }
  int lmask = (int)__ldg(col + 7 * K * Gn);
  int lm = m & lmask;
  while (lm) {
    int k = __ffs(lm) - 1;
    lm &= lm - 1;
    narrow_slot(r, tb, g, k);
  }
  return m & ~lmask;
}

__global__ void wide_trace_kernel(Tables tb, const float* __restrict__ rays,
                                  int n, const int* __restrict__ hints,
                                  int n_hints, const int* __restrict__ gate,
                                  int packet, float* __restrict__ t_out,
                                  int* __restrict__ id_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (gate != nullptr && gate[i / packet] == 0) {
    store_miss(i, t_out, id_out);
    return;
  }
  RayState r = load_ray(rays, n, i);
  if (hints != nullptr) {
    const int* h = hints + (size_t)(i / packet) * n_hints;
    if (h[0] >= 0)
      for (int j = 0; j < n_hints; ++j)
        narrow_slot(r, tb, h[j] >> 4, h[j] & (K - 1));
  }

  int stk_g[WIDE_DMAX];
  int stk_m[WIDE_DMAX];
  int d = 0;
  int gid = 0;
  int mask = enter(r, tb, 0);
  while (!(r.vb == neg_inf())) {
    if (mask == 0) {
      if (d == 0) break;
      --d;
      gid = stk_g[d];
      mask = stk_m[d];
      continue;
    }
    int k = __ffs(mask) - 1;
    mask &= mask - 1;
    int child = (int)__ldg(tb.gnodes + (7 * k + 6) * tb.Gn + gid);
    int m2 = enter(r, tb, child);
    if (m2 != 0) {
      stk_g[d] = gid;
      stk_m[d] = mask;
      ++d;
      gid = child;
      mask = m2;
    }
  }
  store_ray(r, tb.W, i, t_out, id_out);
}

}  // namespace

extern "C" int wide_trace_launch(const float* gnodes, int Gn,
                                 const float* groups, int width,
                                 const float* rays, int n, const int* hints,
                                 int n_hints, const int* gate, int packet,
                                 int mode, float* t_out, int* id_out,
                                 void* stream) {
  if (n <= 0) return 0;
  Tables tb{gnodes, groups, Gn, width, mode};
  const int block = 128;
  const int grid = (n + block - 1) / block;
  wide_trace_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      tb, rays, n, hints, n_hints, gate, packet, t_out, id_out);
  return (int)cudaGetLastError();
}
