// Entry/exit-walk closest-hit and any-hit trace: one ray a lane, walking in
// lock step, with the leaf tests taken by the whole warp.
//
// Replaces the TPU kernel bvh_tpu/ops/trace.py::_tight_body (built by
// _make_tight_kernel, launched by _trace_tight), with its node reader
// _read_node and its leaf test _narrow_cluster (trace_common.cuh,
// warp_leaves). It serves every scene without a usable wide table:
// bf16-packed scenes, bmat scenes, scenes built with wide=False and scenes
// whose wide table was dropped at build. The TPU kernel walks one shared
// cursor per packet over the node table in scalar memory; here each ray
// walks on its own, which computes the plain version's function
// (bvh_tpu_torch/ops/tight.py::tight_trace_plain):
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
//   * the node records (ops/sweep.py::node_records, read by read_node in
//     trace_common.cuh): packed records hold each axis's bf16 pair word,
//     whose raw value is a leaf's frame origin; f32 records hold box lo and
//     hi, and the frame origin is the box centre.
//
// bmat scenes carry precomputed bilinear forms (bgroups); this kernel
// evaluates the leaf test from groups with the regrouped forms of
// trace_common.cuh instead: the precomputed forms are the reference's
// m = o x d forms and would bring back their edge error at 1e5 coordinates.
//
// What bounds it on an H100: the float32 slab tests (one per visited node)
// and leaf tests (W triangle tests per fired leaf); the tables stay in L2.
// A ray fires about one leaf on aimed rows, but the lanes of a warp fire
// theirs at different steps of the walk, so with one thread a ray the
// warp ran each lane's W triangle tests alone while the others waited
// (about 13 such steps a warp at W = 16, counted with the plain walk:
// 2-3 times the work of the slab steps). As the group walk (wide_trace.cu)
// does, the design changes two things:
//
//   * the loads: one 32-byte record a node, read as two float4, where the
//     table's [8, Nn] rows took 8 (packed: 5) scalar loads from as many
//     cache lines;
//   * the leaf tests: after every step the lanes' fired leaves are tested by
//     the whole warp (warp_leaves: min(W, 32) lanes a leaf), and so are a
//     packet's hinted leaves. A lane has at most one leaf a step, and its
//     leaves are folded in its own order, so results are the plain
//     version's bit for bit.
//
// Each step is branch-free: a lane that is not walking takes it on node 0
// and drops its results, so no branch reconverges every step, and the slab
// test uses one NaN-propagating min or max instruction a term (slab_hit).
// On the three rows kernel_ab.py times, the first took 3-6% off and the
// second 10-18%; testing the fired leaves every 4 steps instead of every
// step (a lane that fired waits) lost 1-2% (PERF.md).
//
// Each lane keeps its own walk (the nodes a warp's rays visit spread, as
// for the group walk), in lock step. All 32 lanes stay in the loop until
// every walk is done (a lane past n, one that has finished and an any-hit
// lane whose vb is -inf take part in the leaf tests without a walk of their
// own): the shuffles and ballots need the whole warp. packet is a power of
// two of at least 128, so a warp's rays share one packet: its gate and
// hints are the same for all its lanes, and a gated-off warp returns at
// once.
//
// The counting build (COUNT true, chosen by the wrapper when it is given
// counter outputs; the reference's count_visits) writes each ray's node
// visits (slab tests) and leaf fires (hinted leaves not counted) beside its
// result, which is the timed build's bit for bit. The timed build is
// compiled without the counters.
//
// The FRAME build (FRAME true, chosen by the wrapper when the scene carries
// a_lo: device builds with wide=False, LBVH builds, refits) tests leaves in
// the exact cluster frame (trace_common.cuh, warp_leaves); a_lo is the
// kernel's last parameter, so the builds without FRAME keep their code.
//
// The SKIP build (SKIP true, chosen by the wrapper for skip_narrow; the
// reference's SKIP_NARROW) is the broadphase-only walk: it tests no leaf
// and seeds no hint, so the bound stays at t_max, every ray misses, and the
// walk visits every node whose box the ray meets below t_max. Set against
// the timed build on the same rows, it measures the leaf tests' share of
// the walk. Only <W, COUNT, false, true> is built: without leaf tests the
// frame is never read. The counting build's fires are the leaves tested,
// 0 here, as the reference counts them.
//
// Numerics: see trace_common.cuh.

#include "trace_common.cuh"

namespace {

template <int W, bool COUNT, bool FRAME, bool SKIP>
__global__ void __launch_bounds__(128)
    tight_trace_kernel(const float4* __restrict__ recs, int nn, int packed,
                       const float* __restrict__ groups, int mode,
                       const float* __restrict__ rays, int n,
                       const int* __restrict__ hints, int n_hints,
                       const int* __restrict__ gate, int packet,
                       float* __restrict__ t_out, int* __restrict__ id_out,
                       int* __restrict__ visits_out,
                       int* __restrict__ fires_out,
                       const float* __restrict__ a_lo) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int base = i - lane;  // the warp's first ray
  if (base >= n) return;
  const bool valid = i < n;
  const int pkt = base / packet;  // the warp's packet
  if (gate != nullptr && gate[pkt] == 0) {
    if (valid) store_miss(i, t_out, id_out);
    return;
  }
  RayState r = {};
  if (valid) r = load_ray(rays, n, i);
  r.bk = SENT;

  if (!SKIP && hints != nullptr && hints[(size_t)pkt * n_hints] >= 0) {
    const int* h = hints + (size_t)pkt * n_hints;
    int j = 0;
    warp_leaves<W, FRAME>(r, groups, a_lo, mode, lane,
                   [&](int& c, float& ccx, float& ccy, float& ccz) {
                     if (!valid || j == n_hints) return false;
                     const Node nd = read_node(recs, packed, h[j++]);
                     c = (int)(-nd.entry - 1.0f);
                     ccx = nd.ccx, ccy = nd.ccy, ccz = nd.ccz;
                     return true;
                   });
  }

  int cursor = 0;
  bool walking = valid && nn > 0 && !(r.vb == neg_inf());
  int n_visits = 0, n_fires = 0;  // the counting build's
  while (__any_sync(FULL, walking)) {
    const Node nd = read_node(recs, packed, walking ? cursor : 0);
    const bool leaf = nd.entry < 0.0f;
    const bool hit = slab_fires(r, nd.ax, nd.ay, nd.az, nd.bx, nd.by, nd.bz);
    const bool fired = walking && hit;
    if (COUNT) {
      n_visits += walking;
      if (!SKIP) n_fires += leaf && fired;
    }
    if (walking) cursor = (leaf || !fired) ? (int)nd.exit_ : (int)nd.entry;
    if (!SKIP) {
      bool fired_leaf = leaf && fired;  // the lane's leaf to test this step
      warp_leaves<W, FRAME>(r, groups, a_lo, mode, lane,
                     [&](int& c, float& ccx, float& ccy, float& ccz) {
                       if (!fired_leaf) return false;
                       fired_leaf = false;
                       c = (int)(-nd.entry - 1.0f);
                       ccx = nd.ccx, ccy = nd.ccy, ccz = nd.ccz;
                       return true;
                     });
    }
    walking = walking && cursor < nn && !(r.vb == neg_inf());
  }
  if (valid) {
    store_ray(r, W, i, t_out, id_out);
    if (COUNT) {
      visits_out[i] = n_visits;
      fires_out[i] = n_fires;
    }
  }
}

template <int W, bool COUNT, bool FRAME, bool SKIP>
void run(int grid, int block, cudaStream_t stream, const float4* recs, int nn,
         int packed, const float* groups, int mode, const float* rays, int n,
         const int* hints, int n_hints, const int* gate, int packet,
         float* t_out, int* id_out, int* visits_out, int* fires_out,
         const float* a_lo) {
  tight_trace_kernel<W, COUNT, FRAME, SKIP><<<grid, block, 0, stream>>>(
      recs, nn, packed, groups, mode, rays, n, hints, n_hints, gate, packet,
      t_out, id_out, visits_out, fires_out, a_lo);
}

template <int W>
int launch(const float* recs, int nn, int packed, const float* groups,
           int mode, const float* rays, int n, const int* hints, int n_hints,
           const int* gate, int packet, float* t_out, int* id_out,
           int* visits_out, int* fires_out, const float* a_lo, int skip,
           cudaStream_t stream) {
  const int block = 128;
  const int grid = (n + block - 1) / block;
  // the build: counting or timed; broadphase only, or in the exact cluster
  // frame or not
  const bool count = visits_out != nullptr, frame = a_lo != nullptr;
  const auto fn = skip    ? (count ? &run<W, true, false, true>
                                   : &run<W, false, false, true>)
                  : count ? (frame ? &run<W, true, true, false>
                                   : &run<W, true, false, false>)
                          : (frame ? &run<W, false, true, false>
                                   : &run<W, false, false, false>);
  fn(grid, block, stream, reinterpret_cast<const float4*>(recs), nn, packed,
     groups, mode, rays, n, hints, n_hints, gate, packet, t_out, id_out,
     visits_out, fires_out, a_lo);
  return (int)cudaGetLastError();
}

}  // namespace

// The floats of a node's record, for the wrapper to check against its own
// layout (ops/sweep.py::node_records).
extern "C" int tight_trace_rec_floats() { return NODE_REC; }

// recs: the node-major table [nn, NODE_REC] (ops/sweep.py::node_records);
// visits_out and fires_out: null (the timed build), or each ray's node
// visits and leaf fires [n] (the counting build); a_lo: null, or the
// scene's exact-frame table [G, 3, 128] (the FRAME build); skip: nonzero
// for the broadphase-only walk (the SKIP build; a_lo is not read).
extern "C" int tight_trace_launch(const float* recs, int nn, int packed,
                                  const float* groups, int width,
                                  const float* rays, int n, const int* hints,
                                  int n_hints, const int* gate, int packet,
                                  int mode, float* t_out, int* id_out,
                                  int* visits_out, int* fires_out,
                                  const float* a_lo, int skip, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (width) {
    case 16:
      return launch<16>(recs, nn, packed, groups, mode, rays, n, hints,
                        n_hints, gate, packet, t_out, id_out, visits_out,
                        fires_out, a_lo, skip, st);
    case 32:
      return launch<32>(recs, nn, packed, groups, mode, rays, n, hints,
                        n_hints, gate, packet, t_out, id_out, visits_out,
                        fires_out, a_lo, skip, st);
    case 64:
      return launch<64>(recs, nn, packed, groups, mode, rays, n, hints,
                        n_hints, gate, packet, t_out, id_out, visits_out,
                        fires_out, a_lo, skip, st);
    case 128:
      return launch<128>(recs, nn, packed, groups, mode, rays, n, hints,
                         n_hints, gate, packet, t_out, id_out, visits_out,
                         fires_out, a_lo, skip, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
