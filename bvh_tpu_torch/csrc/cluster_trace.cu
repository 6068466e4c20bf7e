// Legacy ClusterScene closest-hit trace, one thread per ray.
//
// Replaces the TPU kernel bvh_tpu/ops/trace.py::_kernel_body (built by
// _make_kernel, launched by _trace). The TPU kernel walks one shared cursor
// per 1024-ray packet over the entry/exit table in scalar memory and tests a
// fired leaf's 128 triangles against the whole packet as one [packet, 16] x
// [16, 512] product on the matrix unit. Here each ray walks on its own in
// the same DFS order and runs that product's four bilinear forms for its own
// row (tile_min_key in trace_common.cuh, regrouped around o - a):
//
//   * the cursor starts at 0 and runs while it is below Nc. Each node's box
//     is slab-tested as (a - o) * inv with the unclamped inv = 1/d: a ray in
//     a face plane gives 0 * inf = NaN, which the NaN-propagating min/max
//     carry, so that box never fires for it. A box fires when
//     tmax >= max(tmin, 0) and tmin < best, the ray's best t so far;
//   * a fired leaf (entry < 0, meaning -(cluster+1)) is narrowphased with
//     the ray origin moved to the cluster frame: smem_cc[:, c] for a relative
//     scene, 0 otherwise. The cluster's winner is its smallest key (the bits
//     of t with the low 7 bits replaced by the lane; no hit is 0x7F000000,
//     so a t >= 2^127 counts as no hit), and its t (the key with the lane
//     bits cleared) replaces the ray's best only when strictly smaller, so a
//     tie goes to the cluster visited first;
//   * the cursor moves to exit at a leaf or a node that did not fire, else to
//     entry. skip_narrow walks without leaf tests (every ray a miss).
//
// Output per ray: best t (+inf on a miss) and the lane id c * 128 + lane
// (-1 on a miss).
//
// What bounds it on an H100: float32 operations, 128 triangle tests per
// fired leaf and a slab test per visited node; the tables (7.7 MB of rows on
// the 120k-triangle scene) stay in L2. Neighbouring rays of a coherence-
// sorted batch fire the same leaves, so the rows a warp reads at one lane j
// are one address, served by one broadcast load. This first version is the
// simple, exact design.

#include "trace_common.cuh"

namespace {

constexpr int CW = 128;                 // triangles per cluster
constexpr int LEGACY_SENT = 0x7F000000;  // the legacy kernel's "no hit" key

// ray rows: inv (3, unclamped), d (3), o (3), each [n]
__global__ void cluster_trace_kernel(const float* __restrict__ nodes, int Nc,
                                     const float* __restrict__ cc, int C,
                                     const float* __restrict__ tris,
                                     const float* __restrict__ rays, int n,
                                     int relative, int skip_narrow,
                                     float* __restrict__ t_out,
                                     int* __restrict__ id_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float ix = rays[0 * n + i], iy = rays[1 * n + i], iz = rays[2 * n + i];
  float dx = rays[3 * n + i], dy = rays[4 * n + i], dz = rays[5 * n + i];
  float ox = rays[6 * n + i], oy = rays[7 * n + i], oz = rays[8 * n + i];
  float best = __int_as_float(0x7F800000);
  int best_id = -1;
  int cursor = 0;
  while (cursor < Nc) {
    const float* col = nodes + cursor;
    float t1 = (__ldg(col) - ox) * ix;
    float t2 = (__ldg(col + 3 * Nc) - ox) * ix;
    float u1 = (__ldg(col + Nc) - oy) * iy;
    float u2 = (__ldg(col + 4 * Nc) - oy) * iy;
    float v1 = (__ldg(col + 2 * Nc) - oz) * iz;
    float v2 = (__ldg(col + 5 * Nc) - oz) * iz;
    float entry = __ldg(col + 6 * Nc), exit_ = __ldg(col + 7 * Nc);
    float tmin = nmax(nmax(nmin(t1, t2), nmin(u1, u2)), nmin(v1, v2));
    float tmax = nmin(nmin(nmax(t1, t2), nmax(u1, u2)), nmax(v1, v2));
    bool fired = (tmax >= nmax(tmin, 0.0f)) && (tmin < best);
    bool leaf = entry < 0.0f;
    if (leaf && fired && !skip_narrow) {
      int c = (int)(-entry - 1.0f);
      float ccx = 0.0f, ccy = 0.0f, ccz = 0.0f;
      if (relative) {
        ccx = __ldg(cc + c);
        ccy = __ldg(cc + C + c);
        ccz = __ldg(cc + 2 * C + c);
      }
      int km = tile_min_key(tris + (size_t)c * 16 * CW, CW, ox - ccx,
                            oy - ccy, oz - ccz, dx, dy, dz, LEGACY_SENT);
      float tc = __int_as_float(km & ~(CW - 1));
      if (km < LEGACY_SENT && tc < best) {
        best = tc;
        best_id = c * CW + (km & (CW - 1));
      }
    }
    cursor = (leaf || !fired) ? (int)exit_ : (int)entry;
  }
  t_out[i] = best;
  id_out[i] = best_id;
}

}  // namespace

extern "C" int cluster_trace_launch(const float* nodes, int Nc,
                                    const float* cc, int C, const float* tris,
                                    const float* rays, int n, int relative,
                                    int skip_narrow, float* t_out, int* id_out,
                                    void* stream) {
  if (n <= 0) return 0;
  const int block = 128;
  const int grid = (n + block - 1) / block;
  cluster_trace_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      nodes, Nc, cc, C, tris, rays, n, relative, skip_narrow, t_out, id_out);
  return (int)cudaGetLastError();
}
