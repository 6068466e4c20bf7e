// Nearest triangle to each point: the group walk over the wide table and the
// entry/exit walk over the node table, each a warp of 32 points at a time,
// with one warp-cooperative point-triangle test.
//
// Replaces the TPU kernels bvh_tpu/ops/nearest.py::_nearest_wide_body
// (launched by _nearest_wide) and ::_nearest_body (launched by
// _nearest_tight), with their shared narrowphase _point_narrow. The TPU
// kernels walk one shared cursor per packet of points and run the
// narrowphase as one [8, 14W] x [8, P] matrix product. Here each point has
// its own walk state (the point, the bound vb, the packed best key bk and
// the best cluster bc), which computes the plain versions' function
// (bvh_tpu_torch/ops/nearest.py):
//
//   * group walk: per group, the 16 children's squared box distances d2min
//     against vb AS READ BEFORE the group give the fired mask; only then,
//     where refine is on, vb = min(vb, min over the children's farthest-
//     corner distances d2max) (a NaN d2max of an empty slot counts as
//     +inf). Fired leaf bits are narrowphased lowest first, then fired
//     interior bits are entered lowest first (a DFS stack of (group,
//     remaining mask), depth WIDE_DMAX);
//   * entry/exit walk: a cursor over the node table while cursor < Nn (the
//     table's width, pad columns included); per node, where refine is on,
//     vb = min(vb, d2max) FIRST, then fired = d2min < vb; a fired leaf is
//     narrowphased; the cursor moves to exit at a leaf or an unfired node,
//     else to entry;
//   * narrowphase of cluster c (frame origin cc = the leaf box's centre):
//     Ericson's closest-point region cascade (priority A > B > AB > C > AC
//     > BC > face) per triangle, d^2 = |v e1 + w e2 - q|^2 componentwise
//     with q = p' - a', the packed key (the bits of d^2 with the low
//     log2(W) bits replaced by the lane; +inf bits where |e1|^2 = 0 or
//     d^2 is not below +inf), replaced only when strictly smaller, then
//     vb = min(vb, the key's d^2).
//
// The TPU kernel forms d1 = e1.p' - e1.a' through the matrix product; here
// d1 = e1.q and d2 = e2.q directly, the same quantity without the
// cancellation across the cluster frame. Results differ from the
// reference only at rounding level.
//
// What bounds both walks on an H100: float32 operations, 16 box tests of 34
// operations per entered group (one box test of 35 per entry/exit node) and
// a 41-operation cascade per (point, triangle) of a fired leaf, besides
// |e1|^2, e1.e2 and |e2|^2 (15 a triangle, whatever the number of points);
// the tables (a few MB) stay in L2. One thread per point lost most of the
// card to divergence: a lane looped over its own fired leaves while the
// others waited, its cascade branched seven ways, and each lane recomputed
// |e1|^2, e1.e2 and |e2|^2 of every triangle.
//
// The warp schedule. Morton-sorted points of a warp walk nearly the same
// nodes, so the warp steps through the union of its points' nodes once, in
// DFS order: the group walk one group a step (nearest_wide_kernel), testing
// its 16 children for the lanes entering it, the entry/exit walk one node a
// step (nearest_entry_exit_kernel), each from broadcast loads. A fired leaf
// is then narrowphased by the whole warp for the lanes that fired it: the
// cluster's triangles are loaded once, coalesced, with their triangle-only
// terms, min(W, 32) lanes serve one point (two points a pass at W = 16,
// four triangles a lane at W = 128), and the key minimum is a warp
// reduction. The cascade (pair_key) picks its region without branches and
// divides only where the region needs it, so the warp skips a division no
// lane needs (in one-thread form, this cascade made the entry/exit walk
// 2.3x slower than a branchy one). Every lane folds its own leaves in its
// walk's order, so the result is the plain version's bit for bit. All 32
// lanes stay in the loop until every walk is done.
//
// FRAME builds (FRAME true, chosen by the wrapper when the scene carries
// a_lo [G, 3, 128]: device builds, their refits and update deltas, whose
// Morton clusters may lie ~1e5 from their frame origin): the exact cluster
// frame of the trace walks (trace_common.cuh, warp_leaves). The point's lane
// also forms lo, the rounding error of p - cc (two_diff_lo), and the lanes
// serving it take q = ((p' - a') + lo) - a_lo[j], the part of a - cc that
// the stored a' leaves out read from a_lo, so the cascade sees p - a to a
// few ulps of |p - a| where the rounded frame lost up to an ulp of 1e5.
// Only the leaf test takes the frame: the box tests (box_d2min, box_d2max)
// work in global coordinates. a_lo is each kernel's last parameter, so the
// builds without FRAME read none and keep their code.
//
// Counting builds (COUNT true, chosen by the wrapper when it is given
// counter outputs; the reference's count_visits): each point's own walk,
// the steps its lane takes (here) and not the warp's union: group tests
// (or node visits) and fired leaves, written beside its result, which is
// the timed build's bit for bit. The timed builds are compiled without the
// counters.
//
// The bound seed (nearest_seed_kernel, launched before either walk on a
// scene that has the wide table and is not masked): one thread a point
// descends the wide table greedily from the root, testing each group's 16
// children with the walk's box_d2min and box_d2max and moving into the
// child of least d2min (ties to the least d2max, then the lowest slot; a
// NaN or +inf d2min is never taken), until the chosen child is a leaf or
// the group has none to take. The least d2max of every child it tested
// (NaN as +inf), one ulp up, is folded into the point's row: d_max^2 =
// min(d_max^2, seed). Each of those boxes holds a triangle within its
// d2max, so the nearest triangle's leaf L* has d2min(L*) <= d*^2 <= seed,
// and the leaf still fires; the ulp keeps firing the leaf the descent ended
// in and its ancestors, whose d2max may round to that leaf's d2min. The
// walks, which tighten their bound only through the groups they happen to
// enter first, then start from a bound near the answer.
//
// Numerics: built with -fmad=false and IEEE division, every sum written in
// one fixed order, so the kernels agree bit for bit with their plain
// PyTorch versions. min/max propagate NaN like torch.minimum/maximum: empty
// child slots hold NaN boxes and must never fire (fmaxf(NaN, 0) would
// return 0 and fire them). Payloads, entry and exit are float VALUES and
// convert with (int), never with a bit cast.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int K = 16;          // children per group
constexpr int WIDE_DMAX = 16;  // DFS stack depth
constexpr int SENT = 0x7F800000;  // +inf bits: the "no hit" key
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

struct Point {
  float px, py, pz;
  float vb;  // pruning bound, a squared distance
  int bk;    // packed best key
  int bc;    // best cluster
};

// One triangle of a cluster: rows a', e1, e2 and the terms that depend only
// on the triangle, |e1|^2, e1.e2 and |e2|^2.
struct NTri {
  float a0, a1, a2, e10, e11, e12, e20, e21, e22, aa, ab, bb;
};

// The rounding error of x - y: hi + lo == x - y exactly, with hi the
// rounded difference (Knuth's TwoSum of x and -y; trace_common.cuh's
// two_diff_lo, in the same order).
__device__ __forceinline__ float two_diff_lo(float x, float y) {
  const float hi = x - y;
  const float bv = hi - x;
  const float av = hi - bv;
  return (x - av) - (y + bv);
}

__device__ __forceinline__ NTri load_ntri(const float* __restrict__ tile,
                                          int j) {
  NTri t;
  t.a0 = __ldg(tile + 0 * 128 + j);
  t.a1 = __ldg(tile + 1 * 128 + j);
  t.a2 = __ldg(tile + 2 * 128 + j);
  t.e10 = __ldg(tile + 3 * 128 + j);
  t.e11 = __ldg(tile + 4 * 128 + j);
  t.e12 = __ldg(tile + 5 * 128 + j);
  t.e20 = __ldg(tile + 6 * 128 + j);
  t.e21 = __ldg(tile + 7 * 128 + j);
  t.e22 = __ldg(tile + 8 * 128 + j);
  t.aa = (t.e10 * t.e10 + t.e11 * t.e11) + t.e12 * t.e12;
  t.ab = (t.e10 * t.e20 + t.e11 * t.e21) + t.e12 * t.e22;
  t.bb = (t.e20 * t.e20 + t.e21 * t.e21) + t.e22 * t.e22;
  return t;
}

// The packed key of the point (opx, opy, opz), in the cluster frame, against
// triangle j of a W-wide cluster; SENT where |e1|^2 = 0 or d^2 is not below
// +inf. Ericson's region cascade with the region chosen without branches:
// every region test is evaluated and the first that holds wins (priority
// A > B > AB > C > AC > BC > face). Only the two divisions branch: q1 (v on
// edge AB or the face) and q2 (w on edge AC, edge BC or the face) are
// computed where the region needs them, so a warp whose lanes all land at
// vertices skips both. v and w are the values the plain version's
// torch.where chain selects, bit for bit.
//
// FRAME: (lx, ly, lz) is the rounding error of p - cc and (alx, aly, alz)
// the triangle's a_lo, and q = ((p' - a') + lo) - a_lo; without FRAME they
// are not read.
template <int W, bool FRAME>
__device__ __forceinline__ int pair_key(const NTri& t, int j, float opx,
                                        float opy, float opz, float lx,
                                        float ly, float lz, float alx,
                                        float aly, float alz) {
  const float inf = __int_as_float(SENT);
  float qx = opx - t.a0, qy = opy - t.a1, qz = opz - t.a2;
  if (FRAME) {
    qx = (qx + lx) - alx;
    qy = (qy + ly) - aly;
    qz = (qz + lz) - alz;
  }
  float d1 = (t.e10 * qx + t.e11 * qy) + t.e12 * qz;
  float d2 = (t.e20 * qx + t.e21 * qy) + t.e22 * qz;
  float d3 = d1 - t.aa, d4 = d2 - t.ab, d5 = d1 - t.ab, d6 = d2 - t.bb;
  float vc = d1 * d4 - d3 * d2;
  float vb2 = d5 * d2 - d1 * d6;
  float va = d3 * d6 - d5 * d4;
  float d43 = d4 - d3, d56 = d5 - d6;
  // 0 A, 1 B, 2 AB, 3 C, 4 AC, 5 BC, 6 face
  const int reg = (d1 <= 0.0f && d2 <= 0.0f)                    ? 0
                  : (d3 >= 0.0f && d4 <= d3)                    ? 1
                  : (vc <= 0.0f && d1 >= 0.0f && d3 <= 0.0f)    ? 2
                  : (d6 >= 0.0f && d5 <= d6)                    ? 3
                  : (vb2 <= 0.0f && d2 >= 0.0f && d6 <= 0.0f)   ? 4
                  : (va <= 0.0f && d43 >= 0.0f && d56 >= 0.0f)  ? 5
                                                                : 6;
  const float denom = (va + vb2) + vc;
  float q1 = 0.0f, q2 = 0.0f;
  if (reg == 2 || reg == 6)
    q1 = (reg == 2 ? d1 : vb2) / (reg == 2 ? d1 - d3 : denom);
  if (reg >= 4)
    q2 = (reg == 4 ? d2 : reg == 5 ? d43 : vc) /
         (reg == 4 ? d2 - d6 : reg == 5 ? d43 + d56 : denom);
  float v = reg == 1 ? 1.0f : reg == 2 || reg == 6 ? q1 : reg == 5 ? 1.0f - q2
                                                                    : 0.0f;
  float w = reg == 3 ? 1.0f : reg >= 4 ? q2 : 0.0f;
  float fx = (v * t.e10 + w * t.e20) - qx;
  float fy = (v * t.e11 + w * t.e21) - qy;
  float fz = (v * t.e12 + w * t.e22) - qz;
  float dd = (fx * fx + fy * fy) + fz * fz;
  return (t.aa > 0.0f && dd < inf) ? ((__float_as_int(dd) & ~(W - 1)) | j)
                                   : SENT;
}

// Folds the smallest key km of cluster c into the point: replaced only when
// strictly smaller, then vb = min(the best key's d^2, vb).
__device__ __forceinline__ void fold(Point& p, int km, int c, int W) {
  if (km < p.bk) {
    p.bk = km;
    p.bc = c;
  }
  p.vb = nmin(__int_as_float(p.bk & ~(W - 1)), p.vb);
}

__device__ __forceinline__ float box_d2min(const Point& p, float ax, float ay,
                                           float az, float bx, float by,
                                           float bz) {
  float tx = nmax(nmax(ax - p.px, p.px - bx), 0.0f);
  float ty = nmax(nmax(ay - p.py, p.py - by), 0.0f);
  float tz = nmax(nmax(az - p.pz, p.pz - bz), 0.0f);
  return (tx * tx + ty * ty) + tz * tz;
}

__device__ __forceinline__ float box_d2max(const Point& p, float ax, float ay,
                                           float az, float bx, float by,
                                           float bz) {
  float mx = nmax(p.px - ax, bx - p.px);
  float my = nmax(p.py - ay, by - p.py);
  float mz = nmax(p.pz - az, bz - p.pz);
  return (mx * mx + my * my) + mz * mz;
}

__device__ __forceinline__ Point load_point(const float* __restrict__ pts,
                                            int n, int i) {
  // point rows: x, y, z, d_max^2, each [n]
  Point p;
  p.px = pts[0 * n + i];
  p.py = pts[1 * n + i];
  p.pz = pts[2 * n + i];
  p.vb = pts[3 * n + i];
  p.bk = SENT;
  p.bc = 0;
  return p;
}

__device__ __forceinline__ void store_point(const Point& p, int W, int i,
                                            float* __restrict__ d2_out,
                                            int* __restrict__ id_out) {
  d2_out[i] = __int_as_float(p.bk & ~(W - 1));
  id_out[i] = p.bk < SENT ? p.bc * W + (p.bk & (W - 1)) : -1;
}

struct WideTables {
  const float* gnodes;  // [7K+1, Gn]
  const float* groups;  // [G, 16, 128]
  int Gn;
  int refine;
};

// Narrowphase of cluster c (frame origin cc) against the points of the lanes
// in F, the whole warp together: SPAN = min(W, 32) lanes per point, each
// holding W / SPAN of the cluster's triangles (loaded once, coalesced, with
// their |e1|^2, e1.e2 and |e2|^2), 32 / SPAN points a pass. A point's key
// minimum is taken over its SPAN lanes; its own lane folds it. FRAME: the
// exact cluster frame, with the lanes' a_lo read once beside their
// triangles.
template <int W, bool FRAME>
__device__ __forceinline__ void warp_narrow(Point& p, unsigned F,
                                            const float* __restrict__ groups,
                                            const float* __restrict__ a_lo,
                                            int c, float ccx, float ccy,
                                            float ccz, int lane) {
  constexpr int SPAN = W < 32 ? W : 32;  // lanes per point
  constexpr int TPL = W / SPAN;          // triangles per lane
  constexpr int PPP = 32 / SPAN;         // points per pass (1 or 2)
  const int per_row = 128 / W;
  const float* tile =
      groups + (size_t)(c / per_row) * 16 * 128 + (c % per_row) * W;
  const int j0 = lane % SPAN;
  NTri tr[TPL];
#pragma unroll
  for (int s = 0; s < TPL; ++s) tr[s] = load_ntri(tile, j0 + SPAN * s);
  float al[TPL][3];
  if (FRAME) {
    // cluster c's lanes in a_lo [G, 3, 128] (the layout of the a' rows)
    const float* alt =
        a_lo + (size_t)(c / per_row) * 3 * 128 + (c % per_row) * W;
#pragma unroll
    for (int s = 0; s < TPL; ++s) {
      const int j = j0 + SPAN * s;
      al[s][0] = __ldg(alt + j);
      al[s][1] = __ldg(alt + 128 + j);
      al[s][2] = __ldg(alt + 2 * 128 + j);
    }
  }
  // this lane's point in the cluster frame, read by the lanes serving it
  const float opx = p.px - ccx, opy = p.py - ccy, opz = p.pz - ccz;
  // FRAME: the rounding error of p - cc, read the same way
  float lox = 0.0f, loy = 0.0f, loz = 0.0f;
  if (FRAME) {
    lox = two_diff_lo(p.px, ccx);
    loy = two_diff_lo(p.py, ccy);
    loz = two_diff_lo(p.pz, ccz);
  }
  while (F) {
    const int f0 = __ffs(F) - 1;
    F &= F - 1;
    int f1 = -1;
    if (PPP == 2 && F) {
      f1 = __ffs(F) - 1;
      F &= F - 1;
    }
    // this lane serves point f0 (first half) or f1 (second half, f0's again
    // when there is no second point: its result is dropped)
    const int src = (lane >= SPAN && f1 >= 0) ? f1 : f0;
    const float Ox = __shfl_sync(FULL, opx, src),
                Oy = __shfl_sync(FULL, opy, src),
                Oz = __shfl_sync(FULL, opz, src);
    float Lx = 0.0f, Ly = 0.0f, Lz = 0.0f;
    if (FRAME) {
      Lx = __shfl_sync(FULL, lox, src);
      Ly = __shfl_sync(FULL, loy, src);
      Lz = __shfl_sync(FULL, loz, src);
    }
    int k = SENT;
#pragma unroll
    for (int s = 0; s < TPL; ++s) {
      int key = pair_key<W, FRAME>(tr[s], j0 + SPAN * s, Ox, Oy, Oz, Lx, Ly,
                                   Lz, FRAME ? al[s][0] : 0.0f,
                                   FRAME ? al[s][1] : 0.0f,
                                   FRAME ? al[s][2] : 0.0f);
      k = key < k ? key : k;
    }
    if (SPAN == 32) {
      k = __reduce_min_sync(FULL, k);
    } else {
#pragma unroll
      for (int off = SPAN / 2; off > 0; off >>= 1) {
        int o = __shfl_xor_sync(FULL, k, off);
        k = o < k ? o : k;
      }
    }
    const int k0 = __shfl_sync(FULL, k, 0);
    const int k1 = __shfl_sync(FULL, k, PPP == 2 ? SPAN : 0);
    if (lane == f0) fold(p, k0, c, W);
    if (lane == f1) fold(p, k1, c, W);
  }
}

// The group walk, a warp of 32 points at a time. Each lane keeps its own
// DFS stack, bound, best key and best cluster, and enters groups in its own
// order (the plain walk's); a lane's next group carries a key that orders
// groups as a DFS visits them (its path from the root, 4 bits a level from
// the top, then its depth). Each step the warp takes the smallest key: the
// lanes whose next group it is test its 16 children from broadcast loads,
// the others wait, so the warp steps through the union of its points'
// groups once, in DFS order. Then the fired leaf slots of those lanes,
// lowest first: for each, the lanes that fired it narrowphase its cluster
// together (warp_narrow).
template <int W, bool COUNT, bool FRAME>
__global__ void __launch_bounds__(128)
    nearest_wide_kernel(WideTables tb, const float* __restrict__ pts, int n,
                        float* __restrict__ d2_out, int* __restrict__ id_out,
                        int* __restrict__ steps_out,
                        int* __restrict__ fires_out,
                        const float* __restrict__ a_lo) {
  const float inf = __int_as_float(SENT);
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < n;
  Point p = {0.0f, 0.0f, 0.0f, 0.0f, SENT, 0};
  if (valid) p = load_point(pts, n, i);
  const int Gn = tb.Gn;
  int stk_g[WIDE_DMAX];
  int stk_m[WIDE_DMAX];
  int d = 0, gid = 0, mask = 0;
  // the next group to enter, -1 when done, and its DFS-order key (path
  // nibbles of levels 0..13 in bits 63..8, depth in bits 3..0; the root is
  // 0, a done lane ~0)
  int ng = valid ? 0 : -1;
  unsigned long long key = valid ? 0ull : ~0ull;
  int n_steps = 0, n_fires = 0;  // the counting build's
  while (true) {
    const unsigned khi = (unsigned)(key >> 32), klo = (unsigned)key;
    const unsigned mhi = __reduce_min_sync(FULL, khi);
    const unsigned mlo = __reduce_min_sync(FULL, khi == mhi ? klo : ~0u);
    if (mhi == ~0u && mlo == ~0u) break;
    const bool here = khi == mhi && klo == mlo;
    const int g = __shfl_sync(FULL, ng, __ffs(__ballot_sync(FULL, here)) - 1);
    // the 16 children: fired against vb as read before the group, then
    // the refinement
    const float* col = tb.gnodes + g;
    const float vbv = p.vb;
    float ref = vbv;
    int m = 0;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float* ch = col + 7 * k * Gn;
      float ax = __ldg(ch), ay = __ldg(ch + Gn), az = __ldg(ch + 2 * Gn);
      float bx = __ldg(ch + 3 * Gn), by = __ldg(ch + 4 * Gn),
            bz = __ldg(ch + 5 * Gn);
      if (tb.refine) {
        float d2max = box_d2max(p, ax, ay, az, bx, by, bz);
        ref = nmin(ref, d2max == d2max ? d2max : inf);
      }
      if (box_d2min(p, ax, ay, az, bx, by, bz) < vbv) m |= 1 << k;
    }
    if (!here) m = 0;
    if (here && tb.refine) p.vb = ref;
    const int lmask = (int)__ldg(col + 7 * K * Gn);
    const int lm = m & lmask;
    if (COUNT && here) {
      ++n_steps;
      n_fires += __popc(lm);
    }
    for (unsigned todo = __reduce_or_sync(FULL, (unsigned)lm); todo;
         todo &= todo - 1) {
      const int k = __ffs(todo) - 1;
      const unsigned F = __ballot_sync(FULL, (lm >> k) & 1);
      const float* ch = col + 7 * k * Gn;
      float ax = __ldg(ch), ay = __ldg(ch + Gn), az = __ldg(ch + 2 * Gn);
      float bx = __ldg(ch + 3 * Gn), by = __ldg(ch + 4 * Gn),
            bz = __ldg(ch + 5 * Gn);
      int c = (int)(-__ldg(ch + 6 * Gn) - 1.0f);
      warp_narrow<W, FRAME>(p, F, tb.groups, a_lo, c, (ax + bx) * 0.5f,
                            (ay + by) * 0.5f, (az + bz) * 0.5f, lane);
    }
    if (here) {
      // descend into g if it has fired interior children, then find the
      // lane's next group: the lowest remaining fired child of the deepest
      // group that has one
      const int m2 = m & ~lmask;
      if (key == 0) {  // the root
        mask = m2;
      } else if (m2) {
        stk_g[d] = gid;
        stk_m[d] = mask;
        ++d;
        gid = g;
        mask = m2;
      }
      const unsigned long long path = key & ~0xFull;
      ng = -1;
      key = ~0ull;
      while (true) {
        if (mask == 0) {
          if (d == 0) break;
          --d;
          gid = stk_g[d];
          mask = stk_m[d];
          continue;
        }
        const int k = __ffs(mask) - 1;
        mask &= mask - 1;
        ng = (int)__ldg(tb.gnodes + (7 * k + 6) * Gn + gid);
        const unsigned long long keep = d ? ~0ull << (64 - 4 * d) : 0ull;
        key = (path & keep) | ((unsigned long long)k << (60 - 4 * d)) |
              (unsigned long long)(d + 1);
        break;
      }
    }
  }
  if (valid) {
    store_point(p, W, i, d2_out, id_out);
    if (COUNT) {
      steps_out[i] = n_steps;
      fires_out[i] = n_fires;
    }
  }
}

// The entry/exit walk, a warp of 32 points at a time. Each lane keeps its
// own cursor, bound, best key and best cluster. The node table is in DFS
// entry/exit order, so a point's cursor only grows: each step the warp takes
// its smallest live cursor (__reduce_min_sync; a done lane offers
// 0xFFFFFFFF), the lanes at that cursor test the node from one broadcast
// load, refining first (vb = min(vb, d2max)) and then firing on d2min < vb,
// and the others wait; lanes that split at a node meet again at its exit.
// So the warp steps through the union of its points' nodes once, in table
// order. A fired leaf is narrowphased by the whole warp for the lanes that
// fired it (warp_narrow). All 32 lanes stay in the loop until every cursor
// is done (a lane past n starts done).
template <int W, bool COUNT, bool FRAME>
__global__ void __launch_bounds__(128)
    nearest_entry_exit_kernel(const float* __restrict__ nodes, int Nn,
                              const float* __restrict__ groups, int refine,
                              const float* __restrict__ pts, int n,
                              float* __restrict__ d2_out,
                              int* __restrict__ id_out,
                              int* __restrict__ steps_out,
                              int* __restrict__ fires_out,
                              const float* __restrict__ a_lo) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < n;
  Point p = {0.0f, 0.0f, 0.0f, 0.0f, SENT, 0};
  if (valid) p = load_point(pts, n, i);
  // node rows: box lo (3), box hi (3), entry, exit, each [Nn]
  int cursor = valid ? 0 : Nn;
  int n_steps = 0, n_fires = 0;  // the counting build's
  while (true) {
    const unsigned cmin = __reduce_min_sync(
        FULL, cursor < Nn ? (unsigned)cursor : 0xFFFFFFFFu);
    if (cmin == 0xFFFFFFFFu) break;
    const bool here = (unsigned)cursor == cmin;
    const float* col = nodes + cmin;
    const float ax = __ldg(col), ay = __ldg(col + Nn), az = __ldg(col + 2 * Nn);
    const float bx = __ldg(col + 3 * Nn), by = __ldg(col + 4 * Nn),
                bz = __ldg(col + 5 * Nn);
    const float entry = __ldg(col + 6 * Nn), exit_ = __ldg(col + 7 * Nn);
    bool fired = false;
    if (here) {
      const float d2min = box_d2min(p, ax, ay, az, bx, by, bz);
      if (refine) p.vb = nmin(p.vb, box_d2max(p, ax, ay, az, bx, by, bz));
      fired = d2min < p.vb;
    }
    const bool leaf = entry < 0.0f;  // the same for the whole warp
    if (COUNT && here) {
      ++n_steps;
      n_fires += fired && leaf;
    }
    if (leaf) {
      const unsigned F = __ballot_sync(FULL, fired);
      if (F)
        warp_narrow<W, FRAME>(p, F, groups, a_lo, (int)(-entry - 1.0f),
                              (ax + bx) * 0.5f, (ay + by) * 0.5f,
                              (az + bz) * 0.5f, lane);
    }
    if (here) cursor = (leaf || !fired) ? (int)exit_ : (int)entry;
  }
  if (valid) {
    store_point(p, W, i, d2_out, id_out);
    if (COUNT) {
      steps_out[i] = n_steps;
      fires_out[i] = n_fires;
    }
  }
}

// The bound seed, one thread a point (no warp schedule: Morton-sorted lanes
// of a warp mostly descend through the same groups, so the loads
// broadcast). Reads the point's x, y, z and writes its row 3 in place;
// steps_out, where not null, gets the groups it tested. A table is at most
// MAX_DEPTH groups deep, so WIDE_DMAX levels always reach a leaf.
__global__ void __launch_bounds__(128)
    nearest_seed_kernel(const float* __restrict__ gnodes, int Gn,
                        float* __restrict__ pts, int n,
                        int* __restrict__ steps_out) {
  const float inf = __int_as_float(SENT);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // plain loads: the kernel writes the rows it reads
  Point p = {pts[i], pts[n + i], pts[2 * n + i], pts[3 * n + i], SENT, 0};
  float seed = inf;
  int g = 0, n_steps = 0;
  for (int level = 0; level < WIDE_DMAX && Gn > 0; ++level) {
    ++n_steps;
    const float* col = gnodes + g;
    float bmin = inf, bmax = inf;
    int best = -1;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float* ch = col + 7 * k * Gn;
      float ax = __ldg(ch), ay = __ldg(ch + Gn), az = __ldg(ch + 2 * Gn);
      float bx = __ldg(ch + 3 * Gn), by = __ldg(ch + 4 * Gn),
            bz = __ldg(ch + 5 * Gn);
      float d2max = box_d2max(p, ax, ay, az, bx, by, bz);
      d2max = d2max == d2max ? d2max : inf;
      seed = fminf(seed, d2max);
      const float d2min = box_d2min(p, ax, ay, az, bx, by, bz);
      if (d2min < bmin || (d2min == bmin && d2max < bmax)) {
        bmin = d2min;
        bmax = d2max;
        best = k;
      }
    }
    if (best < 0) break;
    if (((int)__ldg(col + 7 * K * Gn) >> best) & 1) break;  // a leaf
    g = (int)__ldg(col + (7 * best + 6) * Gn);
  }
  if (seed < inf) seed = __int_as_float(__float_as_int(seed) + 1);
  pts[3 * n + i] = nmin(p.vb, seed);
  if (steps_out != nullptr) steps_out[i] = n_steps;
}

// The build: counting or timed, in the exact cluster frame or not.
template <int W, bool COUNT, bool FRAME>
void run_wide(int grid, cudaStream_t stream, const WideTables& tb,
              const float* pts, int n, float* d2_out, int* id_out,
              int* steps_out, int* fires_out, const float* a_lo) {
  nearest_wide_kernel<W, COUNT, FRAME><<<grid, 128, 0, stream>>>(
      tb, pts, n, d2_out, id_out, steps_out, fires_out, a_lo);
}

template <int W>
int launch_wide(const WideTables& tb, const float* pts, int n, float* d2_out,
                int* id_out, int* steps_out, int* fires_out,
                const float* a_lo, cudaStream_t stream) {
  const int grid = (n + 127) / 128;
  const bool frame = a_lo != nullptr;
  const auto fn =
      steps_out != nullptr
          ? (frame ? &run_wide<W, true, true> : &run_wide<W, true, false>)
          : (frame ? &run_wide<W, false, true> : &run_wide<W, false, false>);
  fn(grid, stream, tb, pts, n, d2_out, id_out, steps_out, fires_out, a_lo);
  return (int)cudaGetLastError();
}

template <int W, bool COUNT, bool FRAME>
void run_entry_exit(int grid, cudaStream_t stream, const float* nodes, int Nn,
                    const float* groups, int refine, const float* pts, int n,
                    float* d2_out, int* id_out, int* steps_out,
                    int* fires_out, const float* a_lo) {
  nearest_entry_exit_kernel<W, COUNT, FRAME><<<grid, 128, 0, stream>>>(
      nodes, Nn, groups, refine, pts, n, d2_out, id_out, steps_out,
      fires_out, a_lo);
}

template <int W>
int launch_entry_exit(const float* nodes, int Nn, const float* groups,
                      int refine, const float* pts, int n, float* d2_out,
                      int* id_out, int* steps_out, int* fires_out,
                      const float* a_lo, cudaStream_t stream) {
  const int grid = (n + 127) / 128;
  const bool frame = a_lo != nullptr;
  const auto fn = steps_out != nullptr
                      ? (frame ? &run_entry_exit<W, true, true>
                               : &run_entry_exit<W, true, false>)
                      : (frame ? &run_entry_exit<W, false, true>
                               : &run_entry_exit<W, false, false>);
  fn(grid, stream, nodes, Nn, groups, refine, pts, n, d2_out, id_out,
     steps_out, fires_out, a_lo);
  return (int)cudaGetLastError();
}

}  // namespace

// steps_out and fires_out: null (the timed builds), or each point's group
// tests (node visits) and leaf fires [n] (the counting builds); a_lo: null,
// or the scene's exact-frame table [G, 3, 128] (the FRAME builds).
extern "C" int nearest_wide_launch(const float* gnodes, int Gn,
                                   const float* groups, int width, int refine,
                                   const float* pts, int n, float* d2_out,
                                   int* id_out, int* steps_out,
                                   int* fires_out, const float* a_lo,
                                   void* stream) {
  if (n <= 0) return 0;
  WideTables tb{gnodes, groups, Gn, refine};
  cudaStream_t st = (cudaStream_t)stream;
  switch (width) {
    case 16:
      return launch_wide<16>(tb, pts, n, d2_out, id_out, steps_out,
                             fires_out, a_lo, st);
    case 32:
      return launch_wide<32>(tb, pts, n, d2_out, id_out, steps_out,
                             fires_out, a_lo, st);
    case 64:
      return launch_wide<64>(tb, pts, n, d2_out, id_out, steps_out,
                             fires_out, a_lo, st);
    case 128:
      return launch_wide<128>(tb, pts, n, d2_out, id_out, steps_out,
                              fires_out, a_lo, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bound seed over the wide table gnodes [7K+1, Gn], in place on the point
// rows pts [4, n]; steps_out: null, or each point's group tests [n].
extern "C" int nearest_seed_launch(const float* gnodes, int Gn, float* pts,
                                   int n, int* steps_out, void* stream) {
  if (n <= 0) return 0;
  nearest_seed_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      gnodes, Gn, pts, n, steps_out);
  return (int)cudaGetLastError();
}

extern "C" int nearest_entry_exit_launch(const float* nodes, int Nn,
                                         const float* groups, int width,
                                         int refine, const float* pts, int n,
                                         float* d2_out, int* id_out,
                                         int* steps_out, int* fires_out,
                                         const float* a_lo, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (width) {
    case 16:
      return launch_entry_exit<16>(nodes, Nn, groups, refine, pts, n, d2_out,
                                   id_out, steps_out, fires_out, a_lo, st);
    case 32:
      return launch_entry_exit<32>(nodes, Nn, groups, refine, pts, n, d2_out,
                                   id_out, steps_out, fires_out, a_lo, st);
    case 64:
      return launch_entry_exit<64>(nodes, Nn, groups, refine, pts, n, d2_out,
                                   id_out, steps_out, fires_out, a_lo, st);
    case 128:
      return launch_entry_exit<128>(nodes, Nn, groups, refine, pts, n,
                                    d2_out, id_out, steps_out, fires_out,
                                    a_lo, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
