// Wide (16-ary) group-walk closest-hit and any-hit trace: one ray a lane,
// walking in lock step, with the leaf tests taken by the whole warp.
//
// Replaces the TPU kernel bvh_tpu/ops/trace.py::_wide_body (built by
// _make_wide_kernel, launched by _trace_wide_jit), with its walk engine
// _make_mask_walk/_ctz16 and its leaf test _narrow_cluster (trace_common.cuh,
// warp_leaves). The TPU kernel walks one shared cursor per packet of rays,
// keeps the node table in scalar memory and runs the leaf test as a matrix
// product. Here each ray walks on its own, which computes the plain
// version's function (bvh_tpu_torch/ops/wide.py::wide_trace_plain):
//
//   * hints (optional): the leaf slots g*K+k listed for the ray's packet are
//     narrowphased first, without a box test (-1 in the packet's first slot
//     turns them off);
//   * per group: slab-test all 16 children against the ray's current bound
//     vb, giving the fired mask; narrowphase every fired leaf bit in
//     ascending order; then visit the fired interior children lowest bit
//     first (a DFS stack of (group, remaining mask), depth WIDE_DMAX);
//   * subtree entry (start_g, optional; the reference's SUBTREE walk,
//     _wide_body 1468-1494, with the skip pair of _make_mask_walk): the
//     packet's entry groups (sg, sg2) are walked first, each from an empty
//     stack. Phase 1 walks from sg; phase 2 from sg2, never entering sg;
//     phase 3 from group 0, entering neither. A phase whose start is <= 0
//     is not run (group 0 is nobody's child, so ids <= 0 never match a
//     child). When a lane's stack empties before phase 3 it takes the next
//     phase's start step (the 16 children of its start group, no push) in
//     the same loop. A launch without start_g runs the build without the
//     phases (SUBTREE false), whose loop is the plain walk's: the skip
//     compare alone cost the W=128 and any-hit rows 3-4%;
//   * modes closest, bounded and any (trace_common.cuh). Once vb is -inf
//     (an any-hit ray found its occluder) no box can fire again, so the ray
//     walks no further than the group in hand: the result is bit for bit
//     that of the full walk.
//
// What bounds it on an H100: the float32 operations of the slab tests and
// the leaf tests (per ray: 16 slab tests per visited group, W triangle
// tests per fired leaf); the tables (a few MB) stay in L2. Rays of a warp
// share an octant and an origin cell, but their directions spread, so the
// union of the groups its lanes visit is 3-8 times the longest lane's walk
// (counted on the CPU with the plain walk): a warp walking that union
// together would do more work, so each lane keeps its own walk and the
// warp steps in lock step, one group a lane a step. Two things were slow in
// a thread-per-ray form of that walk, and the design changes both:
//
//   * the loads. gnodes [7K+1, Gn] keeps a group in column g, so a lane read
//     its 16 child boxes as 96 scalar loads from 96 cache lines, and one
//     load instruction of the warp touched as many lines as the lanes had
//     distinct groups. The kernel reads a group-major copy instead (built
//     once per table by ops/wide.py::group_records): one 512-byte record a
//     group, the 16 boxes in its first three 128-byte lines, read as 24
//     float4 loads, the payloads and the leaf mask in the fourth;
//   * the leaf tests. Lanes fire leaves at different steps, and a lane that
//     fired one ran its W triangle tests alone while the others waited.
//     Now, after every step's slab tests, the lanes' fired leaves are
//     tested by the whole warp (warp_leaves: min(W, 32) lanes a leaf), each
//     lane's in ascending slot order; the hinted slots of a packet too.
//
// All 32 lanes stay in the loop until every walk is done (a lane past n,
// or one that has finished, takes part in the leaf tests without a walk of
// its own): the shuffles and ballots need the whole warp. packet is a power
// of two of at least 128, so a warp's rays share one packet: its gate,
// hints and subtree entries are the same for all its lanes, and a gated-off
// warp returns at once.
//
// The counting build (COUNT true, chosen by the wrapper when it is given
// counter outputs; the reference's count_visits) writes each ray's group
// tests (slab tests of a group's 16 children) and leaf fires (fired leaf
// slots, hinted leaves not counted) beside its result, which is the timed
// build's bit for bit. The timed build is compiled without the counters.
//
// The FRAME build (FRAME true, chosen by the wrapper when the scene carries
// a_lo: device builds, refits and update deltas) tests leaves in the exact
// cluster frame (trace_common.cuh, warp_leaves); a_lo is the kernel's last
// parameter, so the builds without FRAME keep their code.
//
// Numerics: see trace_common.cuh; payloads and the leaf mask are float
// VALUES and convert with (int).

#include "trace_common.cuh"

namespace {

constexpr int K = 16;          // children per group
constexpr int WIDE_DMAX = 16;  // DFS stack depth
// a group's record in the group-major table, in floats: the 16 boxes amin
// (3), amax (3) at 6k, the payloads at PAY + k, the leaf mask at LMASK
constexpr int REC = 128;
constexpr int PAY = 6 * K;
constexpr int LMASK = 7 * K;

// The fired children of group record rec: bit k where child k's box fires.
__device__ __forceinline__ int slab16(const RayState& r,
                                      const float* __restrict__ rec) {
  const float4* q = reinterpret_cast<const float4*>(rec);
  int m = 0;
#pragma unroll 4
  for (int k = 0; k < K; k += 2) {
    // children k and k + 1: 12 floats in 3 float4
    const float4 u = __ldg(q + 3 * (k / 2));
    const float4 v = __ldg(q + 3 * (k / 2) + 1);
    const float4 w = __ldg(q + 3 * (k / 2) + 2);
    if (slab_fires(r, u.x, u.y, u.z, u.w, v.x, v.y)) m |= 1 << k;
    if (slab_fires(r, v.z, v.w, w.x, w.y, w.z, w.w)) m |= 2 << k;
  }
  return m;
}

// The cluster in slot k of group record rec, and its frame origin (the
// box's centre).
__device__ __forceinline__ void leaf_slot(const float* __restrict__ rec,
                                          int k, int& c, float& ccx,
                                          float& ccy, float& ccz) {
  const float* b = rec + 6 * k;
  ccx = (__ldg(b) + __ldg(b + 3)) * 0.5f;
  ccy = (__ldg(b + 1) + __ldg(b + 4)) * 0.5f;
  ccz = (__ldg(b + 2) + __ldg(b + 5)) * 0.5f;
  c = (int)(-__ldg(rec + PAY + k) - 1.0f);
}

template <int W, bool SUBTREE, bool COUNT, bool FRAME>
__global__ void __launch_bounds__(128)
    wide_trace_kernel(const float* __restrict__ recs,
                      const float* __restrict__ groups, int mode,
                      const float* __restrict__ rays, int n,
                      const int* __restrict__ hints, int n_hints,
                      const int* __restrict__ gate,
                      const int* __restrict__ start_g, int packet,
                      float* __restrict__ t_out, int* __restrict__ id_out,
                      int* __restrict__ tests_out,
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

  if (hints != nullptr && hints[(size_t)pkt * n_hints] >= 0) {
    const int* h = hints + (size_t)pkt * n_hints;
    int j = 0;
    warp_leaves<W, FRAME>(r, groups, a_lo, mode, lane,
                   [&](int& c, float& ccx, float& ccy, float& ccz) {
                     if (!valid || j == n_hints) return false;
                     const int slot = h[j++];
                     leaf_slot(recs + (size_t)(slot >> 4) * REC, slot & (K - 1),
                               c, ccx, ccy, ccz);
                     return true;
                   });
  }

  // the packet's subtree entries; the first phase to run and its start
  int sg = 0, sg2 = 0;
  if (SUBTREE) {
    sg = start_g[2 * pkt];
    sg2 = start_g[2 * pkt + 1];
  }
  int phase = sg > 0 ? 1 : sg2 > 0 ? 2 : 3;
  int stk_g[WIDE_DMAX];
  int stk_m[WIDE_DMAX];
  int d = 0, gid = 0, mask = 0;
  // the group the lane enters this step: the first phase's start
  int g = phase == 1 ? sg : phase == 2 ? sg2 : 0;
  bool entering = valid, start = true;
  int n_tests = 0, n_fires = 0;  // the counting build's
  while (true) {
    const float* rec = recs + (size_t)g * REC;
    int m = 0, lmask = 0;
    if (entering) {
      m = slab16(r, rec);
      lmask = (int)__ldg(rec + LMASK);
      if (COUNT) {
        ++n_tests;
        n_fires += __popc(m & lmask);
      }
    }
    // the fired leaves, lowest slot first, tested by the whole warp
    int lm = m & lmask;
    warp_leaves<W, FRAME>(r, groups, a_lo, mode, lane,
                   [&](int& c, float& ccx, float& ccy, float& ccz) {
                     if (lm == 0) return false;
                     const int k = __ffs(lm) - 1;
                     lm &= lm - 1;
                     leaf_slot(rec, k, c, ccx, ccy, ccz);
                     return true;
                   });
    if (entering) {
      // descend into g if it has fired interior children
      const int m2 = m & ~lmask;
      if (start) {
        gid = g;
        mask = m2;
      } else if (m2) {
        stk_g[d] = gid;
        stk_m[d] = mask;
        ++d;
        gid = g;
        mask = m2;
      }
    }
    start = false;
    // the lane's next group: the lowest remaining fired child of the
    // deepest group that has one, but for the phase's skipped subtrees;
    // once the stack is empty, the next phase's start; none after phase 3
    // or once the bound is -inf
    entering = false;
    if (valid && !(r.vb == neg_inf())) {
      while (true) {
        if (mask == 0) {
          if (d > 0) {
            --d;
            gid = stk_g[d];
            mask = stk_m[d];
            continue;
          }
          if (!SUBTREE || phase == 3) break;
          phase = phase == 1 && sg2 > 0 ? 2 : 3;
          g = phase == 2 ? sg2 : 0;
          entering = start = true;
          break;
        }
        const int k = __ffs(mask) - 1;
        mask &= mask - 1;
        g = (int)__ldg(recs + (size_t)gid * REC + PAY + k);
        // phase 2 skips sg, phase 3 sg and sg2
        if (SUBTREE && phase > 1 && (g == sg || (phase == 3 && g == sg2)))
          continue;
        entering = true;
        break;
      }
    }
    if (!__any_sync(FULL, entering)) break;
  }
  if (valid) {
    store_ray(r, W, i, t_out, id_out);
    if (COUNT) {
      tests_out[i] = n_tests;
      fires_out[i] = n_fires;
    }
  }
}

template <int W, bool SUBTREE, bool COUNT, bool FRAME>
void run(int grid, int block, cudaStream_t stream, const float* recs,
         const float* groups, int mode, const float* rays, int n,
         const int* hints, int n_hints, const int* gate, const int* start_g,
         int packet, float* t_out, int* id_out, int* tests_out,
         int* fires_out, const float* a_lo) {
  wide_trace_kernel<W, SUBTREE, COUNT, FRAME><<<grid, block, 0, stream>>>(
      recs, groups, mode, rays, n, hints, n_hints, gate, start_g, packet,
      t_out, id_out, tests_out, fires_out, a_lo);
}

template <int W, bool SUBTREE, bool COUNT>
decltype(&run<W, false, false, false>) pick_frame(bool frame) {
  return frame ? &run<W, SUBTREE, COUNT, true> : &run<W, SUBTREE, COUNT, false>;
}

template <int W>
int launch(const float* recs, const float* groups, int mode,
           const float* rays, int n, const int* hints, int n_hints,
           const int* gate, const int* start_g, int packet, float* t_out,
           int* id_out, int* tests_out, int* fires_out, const float* a_lo,
           cudaStream_t stream) {
  const int block = 128;
  const int grid = (n + block - 1) / block;
  // the build: with subtree entries or not, counting or timed, in the exact
  // cluster frame or not
  const bool frame = a_lo != nullptr;
  const auto fn = start_g != nullptr
                      ? (tests_out != nullptr ? pick_frame<W, true, true>(frame)
                                              : pick_frame<W, true, false>(frame))
                      : (tests_out != nullptr ? pick_frame<W, false, true>(frame)
                                              : pick_frame<W, false, false>(frame));
  fn(grid, block, stream, recs, groups, mode, rays, n, hints, n_hints, gate,
     start_g, packet, t_out, id_out, tests_out, fires_out, a_lo);
  return (int)cudaGetLastError();
}

}  // namespace

// The floats of a group's record, for the wrapper to check against its own
// layout (ops/wide.py::group_records).
extern "C" int wide_trace_rec_floats() { return REC; }

// recs: the group-major table [Gn, REC] (ops/wide.py::group_records);
// start_g: null, or the packets' subtree entries [p, 2] (closest and
// bounded modes); tests_out and fires_out: null (the timed build), or each
// ray's group tests and leaf fires [n] (the counting build); a_lo: null, or
// the scene's exact-frame table [G, 3, 128] (the FRAME build).
extern "C" int wide_trace_launch(const float* recs, const float* groups,
                                 int width, const float* rays, int n,
                                 const int* hints, int n_hints,
                                 const int* gate, const int* start_g,
                                 int packet, int mode, float* t_out,
                                 int* id_out, int* tests_out, int* fires_out,
                                 const float* a_lo, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (width) {
    case 16:
      return launch<16>(recs, groups, mode, rays, n, hints, n_hints, gate,
                        start_g, packet, t_out, id_out, tests_out, fires_out,
                        a_lo, st);
    case 32:
      return launch<32>(recs, groups, mode, rays, n, hints, n_hints, gate,
                        start_g, packet, t_out, id_out, tests_out, fires_out,
                        a_lo, st);
    case 64:
      return launch<64>(recs, groups, mode, rays, n, hints, n_hints, gate,
                        start_g, packet, t_out, id_out, tests_out, fires_out,
                        a_lo, st);
    case 128:
      return launch<128>(recs, groups, mode, rays, n, hints, n_hints, gate,
                         start_g, packet, t_out, id_out, tests_out,
                         fires_out, a_lo, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
