// Entry/exit-walk closest-hit and any-hit trace, one thread per ray.
//
// Replaces the TPU kernel bvh_tpu/ops/trace.py::_tight_body (built by
// _make_tight_kernel, launched by _trace_tight), with its node reader
// _read_node and its leaf test _narrow_cluster (shared with the group walk
// in trace_common.cuh). It serves every scene without a usable wide table:
// bf16-packed scenes, bmat scenes, scenes built with wide=False and scenes
// whose wide table was dropped at build. The TPU kernel walks one shared
// cursor per packet over the node table in scalar memory; here each ray
// walks on its own, which computes the same function:
//
//   * hints (optional): the node-table ids listed for the ray's packet are
//     narrowphased first, without a box test (-1 in the packet's first slot
//     turns them off);
//   * the cursor starts at 0 and runs while it is below Nn (the table's
//     width, pad columns included). Each node's box is slab-tested against
//     vb; a leaf (entry < 0, meaning -(cluster+1)) that fires is
//     narrowphased; the cursor then moves to exit at a leaf or a node that
//     did not fire, else to entry;
//   * modes closest, bounded and any (trace_common.cuh); once vb is -inf no
//     box can fire again, so the walk ends there with the full walk's
//     result;
//   * packed tables ([5, Nn]): rows 0-2 hold each axis's (min, max) as the
//     high and low bf16 halves of one float32 word, lo = bits & 0xFFFF0000
//     and hi = bits << 16, rows 3-4 entry and exit; a leaf's frame origin is
//     the raw float value of rows 0-2, against which the scene build stored
//     the group rows. Otherwise the table is [8, Nn] (box lo, box hi, entry,
//     exit) and the frame origin is the box centre.
//
// bmat scenes carry precomputed bilinear forms (bgroups); this kernel
// evaluates the leaf test from groups with the regrouped forms of
// trace_common.cuh instead: the precomputed forms are the reference's
// m = o x d forms and would bring back their edge error at 1e5 coordinates.
//
// What bounds it on an H100: the float32 slab tests (one per visited node)
// and leaf tests (W triangle tests per fired leaf); the tables stay in L2.
// The walk is a chain of dependent node reads, and threads of a warp
// diverge where their rays take different paths; the caller's coherence
// sort keeps neighbouring rays on similar paths. This first version is the
// simple, exact design.

#include "trace_common.cuh"

namespace {

struct Node {
  float ax, ay, az, bx, by, bz;  // box
  float ccx, ccy, ccz;           // a leaf's frame origin
  float entry, exit_;
};

__device__ __forceinline__ Node read_node(const float* __restrict__ nodes,
                                          int Nn, int packed, int cur) {
  const float* col = nodes + cur;
  Node nd;
  if (packed) {
    nd.ccx = __ldg(col);
    nd.ccy = __ldg(col + Nn);
    nd.ccz = __ldg(col + 2 * Nn);
    unpack_pair(nd.ccx, nd.ax, nd.bx);
    unpack_pair(nd.ccy, nd.ay, nd.by);
    unpack_pair(nd.ccz, nd.az, nd.bz);
    nd.entry = __ldg(col + 3 * Nn);
    nd.exit_ = __ldg(col + 4 * Nn);
  } else {
    nd.ax = __ldg(col);
    nd.ay = __ldg(col + Nn);
    nd.az = __ldg(col + 2 * Nn);
    nd.bx = __ldg(col + 3 * Nn);
    nd.by = __ldg(col + 4 * Nn);
    nd.bz = __ldg(col + 5 * Nn);
    nd.ccx = (nd.ax + nd.bx) * 0.5f;
    nd.ccy = (nd.ay + nd.by) * 0.5f;
    nd.ccz = (nd.az + nd.bz) * 0.5f;
    nd.entry = __ldg(col + 6 * Nn);
    nd.exit_ = __ldg(col + 7 * Nn);
  }
  return nd;
}

__global__ void tight_trace_kernel(const float* __restrict__ nodes, int Nn,
                                   int packed, const float* __restrict__ groups,
                                   int W, const float* __restrict__ rays, int n,
                                   const int* __restrict__ hints, int n_hints,
                                   const int* __restrict__ gate, int packet,
                                   int mode, float* __restrict__ t_out,
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
      for (int j = 0; j < n_hints; ++j) {
        Node nd = read_node(nodes, Nn, packed, h[j]);
        narrow_cluster(r, groups, W, (int)(-nd.entry - 1.0f), nd.ccx, nd.ccy,
                       nd.ccz, mode);
      }
  }
  int cursor = 0;
  while (cursor < Nn && !(r.vb == neg_inf())) {
    Node nd = read_node(nodes, Nn, packed, cursor);
    bool fired = slab_fires(r, nd.ax, nd.ay, nd.az, nd.bx, nd.by, nd.bz);
    bool leaf = nd.entry < 0.0f;
    if (leaf && fired)
      narrow_cluster(r, groups, W, (int)(-nd.entry - 1.0f), nd.ccx, nd.ccy,
                     nd.ccz, mode);
    cursor = (leaf || !fired) ? (int)nd.exit_ : (int)nd.entry;
  }
  store_ray(r, W, i, t_out, id_out);
}

}  // namespace

extern "C" int tight_trace_launch(const float* nodes, int Nn, int packed,
                                  const float* groups, int width,
                                  const float* rays, int n, const int* hints,
                                  int n_hints, const int* gate, int packet,
                                  int mode, float* t_out, int* id_out,
                                  void* stream) {
  if (n <= 0) return 0;
  const int block = 128;
  const int grid = (n + block - 1) / block;
  tight_trace_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      nodes, Nn, packed, groups, width, rays, n, hints, n_hints, gate, packet,
      mode, t_out, id_out);
  return (int)cudaGetLastError();
}
