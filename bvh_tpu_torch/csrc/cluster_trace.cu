// Legacy ClusterScene closest-hit trace, a warp of 32 rays at a time.
//
// Replaces the TPU kernel bvh_tpu/ops/trace.py::_kernel_body (built by
// _make_kernel, launched by _trace). The TPU kernel walks one shared cursor
// per 1024-ray packet over the entry/exit table in scalar memory and tests a
// fired leaf's 128 triangles against the whole packet as one [packet, 16] x
// [16, 512] product on the matrix unit. Here each ray keeps its own cursor,
// best t and best id, and walks in the same DFS order; per ray the function
// is the plain version's (bvh_tpu_torch/ops/cluster_trace.py):
//
//   * the cursor starts at 0 and runs while it is below Nc. Each node's box
//     is slab-tested as (a - o) * inv with the unclamped inv = 1/d: a ray in
//     a face plane gives 0 * inf = NaN, which the NaN-propagating min/max
//     carry, so that box never fires for it. A box fires when
//     tmax >= max(tmin, 0) and tmin < best, the ray's best t so far;
//   * a fired leaf (entry < 0, meaning -(cluster+1)) is narrowphased with
//     the ray origin in the cluster frame (smem_cc[:, c] for a relative
//     scene, 0 otherwise) as a float pair: hi = o - cc rounded and lo its
//     exact rounding error (TwoSum), so that o - cc = hi + lo exactly in
//     double. Each triangle test forms tv = (hi + lo) - (a' + a_lo) and
//     w = tv x d in double and rounds each to float once (tri_key_frame),
//     where a_lo is the part of the triangle's a - cc that the stored a'
//     (rounded to float32) leaves out (a zero table takes a' as exact).
//     A Morton cluster's centre lies up to ~4e4 units from the world
//     origin, and a ray's origin may lie ~1e5 from the cluster, where
//     float32 keeps ~0.004 of a unit: formed in float, tv and w would
//     round on their own in each triangle, so the two triangles of an
//     edge would see the ray apart and a seam could open between them
//     (the crack class). The cluster's winner is its
//     smallest key (the bits of t with the low 7 bits replaced by the lane;
//     no hit is 0x7F000000, so a t >= 2^127 counts as no hit), and its t
//     replaces the ray's best only when strictly smaller, so a tie goes to
//     the cluster visited first;
//   * the cursor moves to exit at a leaf or a node that did not fire, else to
//     entry. skip_narrow walks without leaf tests (every ray a miss).
//
// Output per ray: best t (+inf on a miss) and the lane id c * 128 + lane
// (-1 on a miss).
//
// What bounds it on an H100: float32 operations. A fired leaf costs 128
// (ray, triangle) tests of 74 operations in float32 equivalents (the
// float64 tv and w count twice), 97% of the work on a random ray, besides
// p = e2 x e1 (9 a triangle, whatever the number of rays); the
// tables (7.7 MB on the 120k-triangle scene) stay in L2. One thread per ray
// wasted most of that: lanes of a warp fire different leaves at different
// steps, so the 128-test loop ran once for every distinct leaf a lane fired,
// with the other lanes masked off, and every lane reloaded the rows and
// recomputed e2 x e1.
//
// The warp schedule. The node table is in DFS entry/exit order, so a ray's
// cursor only grows. Each step the warp takes its smallest live cursor
// (__reduce_min_sync); the lanes at that cursor test the node from one
// broadcast load, the others wait, and lanes that split at a node meet again
// at its exit: the warp steps through the union of its rays' nodes once, in
// table order. When lanes fire a leaf, the warp loads the cluster's rows once,
// coalesced, lane j taking triangles j, j+32, j+64 and j+96, and computes
// each triangle's p = e2 x e1 once, and reads its a_lo. Then, for each fired
// lane in ballot order, it broadcasts that ray (o - cc = hi + lo in double,
// d) with __shfl_sync, every lane tests its four triangles, and
// __reduce_min_sync takes the key
// minimum, which does not depend on the order, so the result is the plain
// version's.
// All 32 lanes stay in the loop until every cursor is done (a lane past n
// starts done): the shuffles and reductions need the whole warp.
//
// Numerics as in trace_common.cuh: -fmad=false, IEEE division, the written
// sum order, NaN-propagating min/max.

#include "trace_common.cuh"

namespace {

constexpr int CW = 128;                 // triangles per cluster
constexpr int TPL = CW / 32;            // triangles per lane in a leaf test
constexpr int LEGACY_SENT = 0x7F000000;  // the legacy kernel's "no hit" key

// ray rows: inv (3, unclamped), d (3), o (3), each [n]
__global__ void __launch_bounds__(128)
    cluster_trace_kernel(const float* __restrict__ nodes, int Nc,
                         const float* __restrict__ cc, int C,
                         const float* __restrict__ tris,
                         const float* __restrict__ a_lo,
                         const float* __restrict__ rays, int n, int relative,
                         int skip_narrow, float* __restrict__ t_out,
                         int* __restrict__ id_out) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < n;
  float ix = 0.0f, iy = 0.0f, iz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f,
        ox = 0.0f, oy = 0.0f, oz = 0.0f;
  if (valid) {
    ix = rays[0 * n + i]; iy = rays[1 * n + i]; iz = rays[2 * n + i];
    dx = rays[3 * n + i]; dy = rays[4 * n + i]; dz = rays[5 * n + i];
    ox = rays[6 * n + i]; oy = rays[7 * n + i]; oz = rays[8 * n + i];
  }
  float best = __int_as_float(0x7F800000);
  int best_id = -1;
  int cursor = valid ? 0 : Nc;
  while (true) {
    // the warp's smallest live cursor (a done lane offers 0xFFFFFFFF)
    const unsigned cmin = __reduce_min_sync(
        FULL, cursor < Nc ? (unsigned)cursor : 0xFFFFFFFFu);
    if (cmin == 0xFFFFFFFFu) break;
    const bool here = (unsigned)cursor == cmin;
    const float* col = nodes + cmin;
    float t1 = (__ldg(col) - ox) * ix;
    float t2 = (__ldg(col + 3 * Nc) - ox) * ix;
    float u1 = (__ldg(col + Nc) - oy) * iy;
    float u2 = (__ldg(col + 4 * Nc) - oy) * iy;
    float v1 = (__ldg(col + 2 * Nc) - oz) * iz;
    float v2 = (__ldg(col + 5 * Nc) - oz) * iz;
    const float entry = __ldg(col + 6 * Nc), exit_ = __ldg(col + 7 * Nc);
    float tmin = nmax(nmax(nmin(t1, t2), nmin(u1, u2)), nmin(v1, v2));
    float tmax = nmin(nmin(nmax(t1, t2), nmax(u1, u2)), nmax(v1, v2));
    const bool fired = here && (tmax >= nmax(tmin, 0.0f)) && (tmin < best);
    const bool leaf = entry < 0.0f;  // the same for the whole warp
    if (leaf && !skip_narrow) {
      const unsigned F = __ballot_sync(FULL, fired);
      if (F) {
        const int c = (int)(-entry - 1.0f);
        float ccx = 0.0f, ccy = 0.0f, ccz = 0.0f;
        if (relative) {
          ccx = __ldg(cc + c);
          ccy = __ldg(cc + C + c);
          ccz = __ldg(cc + 2 * C + c);
        }
        // o - cc exactly: the rounded difference plus its rounding error
        // (two_diff_lo) fits a double
        const double qx = (double)(ox - ccx) + (double)two_diff_lo(ox, ccx),
                     qy = (double)(oy - ccy) + (double)two_diff_lo(oy, ccy),
                     qz = (double)(oz - ccz) + (double)two_diff_lo(oz, ccz);
        const float* tile = tris + (size_t)c * 16 * CW;
        Tri tr[TPL];
        float alx[TPL], aly[TPL], alz[TPL];
#pragma unroll
        for (int s = 0; s < TPL; ++s) {
          const int j = lane + 32 * s;
          tr[s] = load_tri(tile, j);
          const float* al = a_lo + (size_t)c * 3 * CW + j;
          alx[s] = __ldg(al);
          aly[s] = __ldg(al + CW);
          alz[s] = __ldg(al + 2 * CW);
        }
        int km = LEGACY_SENT;
        for (unsigned rest = F; rest; rest &= rest - 1) {
          const int f = __ffs(rest) - 1;
          const double Qx = __shfl_sync(FULL, qx, f),
                       Qy = __shfl_sync(FULL, qy, f),
                       Qz = __shfl_sync(FULL, qz, f);
          const float Dx = __shfl_sync(FULL, dx, f), Dy = __shfl_sync(FULL, dy, f),
                      Dz = __shfl_sync(FULL, dz, f);
          int k = LEGACY_SENT;
#pragma unroll
          for (int s = 0; s < TPL; ++s) {
            // tv = (o - cc) - (a' + a_lo) and w = tv x d in double
            int key = tri_key_frame(tr[s], Qx, Qy, Qz, alx[s], aly[s], alz[s],
                                    Dx, Dy, Dz, CW, lane + 32 * s,
                                    LEGACY_SENT);
            k = key < k ? key : k;
          }
          k = __reduce_min_sync(FULL, k);
          if (lane == f) km = k;
        }
        const float tc = __int_as_float(km & ~(CW - 1));
        if (fired && km < LEGACY_SENT && tc < best) {
          best = tc;
          best_id = c * CW + (km & (CW - 1));
        }
      }
    }
    if (here) cursor = (leaf || !fired) ? (int)exit_ : (int)entry;
  }
  if (valid) {
    t_out[i] = best;
    id_out[i] = best_id;
  }
}

}  // namespace

extern "C" int cluster_trace_launch(const float* nodes, int Nc,
                                    const float* cc, int C, const float* tris,
                                    const float* a_lo, const float* rays,
                                    int n, int relative,
                                    int skip_narrow, float* t_out, int* id_out,
                                    void* stream) {
  if (n <= 0) return 0;
  const int block = 128;
  const int grid = (n + block - 1) / block;
  cluster_trace_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      nodes, Nc, cc, C, tris, a_lo, rays, n, relative, skip_narrow, t_out,
      id_out);
  return (int)cudaGetLastError();
}
