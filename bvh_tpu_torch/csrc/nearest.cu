// Nearest triangle to each point, one thread per point: the group walk over
// the wide table and the entry/exit walk over the node table, sharing one
// point-triangle narrowphase.
//
// Replaces the TPU kernels bvh_tpu/ops/nearest.py::_nearest_wide_body
// (launched by _nearest_wide) and ::_nearest_body (launched by
// _nearest_tight), with their shared narrowphase _point_narrow. The TPU
// kernels walk one shared cursor per packet of points and run the
// narrowphase as one [8, 14W] x [8, P] matrix product. Here each point
// walks on its own with its state in registers (the point, the bound vb,
// the packed best key bk and the best cluster bc), which computes the same
// function:
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
// What bounds it on an H100: the float32 operations of the box tests (16
// per visited group, 18 or 34 operations each) and of the narrowphase (W
// cascades per fired leaf). The tables (a few MB) stay in L2. Threads of a
// warp diverge where their points walk different subtrees or land in
// different regions of a triangle; the caller's Morton sort keeps
// neighbouring points on similar paths. This first version is the simple,
// exact design: no shared-memory staging, no packet walk.
//
// Numerics: built with -fmad=false and IEEE division, every sum written in
// one fixed order, so the kernels agree bit for bit with their plain
// PyTorch versions (bvh_tpu_torch/ops/nearest.py). min/max propagate NaN
// like torch.minimum/maximum: empty child slots hold NaN boxes and must
// never fire (fmaxf(NaN, 0) would return 0 and fire them). Payloads, entry
// and exit are float VALUES and convert with (int), never with a bit cast.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int K = 16;          // children per group
constexpr int WIDE_DMAX = 16;  // DFS stack depth
constexpr int SENT = 0x7F800000;  // +inf bits: the "no hit" key

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

// Narrowphase of cluster c (frame origin cc) against one point.
__device__ void point_narrow(Point& p, const float* __restrict__ groups,
                             int W, int c, float ccx, float ccy, float ccz) {
  const float inf = __int_as_float(SENT);
  float opx = p.px - ccx, opy = p.py - ccy, opz = p.pz - ccz;
  const int per_row = 128 / W;
  const float* tile =
      groups + (size_t)(c / per_row) * 16 * 128 + (c % per_row) * W;
  int bk = p.bk;
  for (int j = 0; j < W; ++j) {
    float a0 = __ldg(tile + 0 * 128 + j), a1 = __ldg(tile + 1 * 128 + j);
    float a2 = __ldg(tile + 2 * 128 + j), e10 = __ldg(tile + 3 * 128 + j);
    float e11 = __ldg(tile + 4 * 128 + j), e12 = __ldg(tile + 5 * 128 + j);
    float e20 = __ldg(tile + 6 * 128 + j), e21 = __ldg(tile + 7 * 128 + j);
    float e22 = __ldg(tile + 8 * 128 + j);
    float qx = opx - a0, qy = opy - a1, qz = opz - a2;
    float d1 = (e10 * qx + e11 * qy) + e12 * qz;
    float d2 = (e20 * qx + e21 * qy) + e22 * qz;
    float aa = (e10 * e10 + e11 * e11) + e12 * e12;
    float bc = (e10 * e20 + e11 * e21) + e12 * e22;
    float cc = (e20 * e20 + e21 * e21) + e22 * e22;
    float d3 = d1 - aa, d4 = d2 - bc, d5 = d1 - bc, d6 = d2 - cc;
    float v, w;
    if (d1 <= 0.0f && d2 <= 0.0f) {  // vertex A
      v = 0.0f;
      w = 0.0f;
    } else if (d3 >= 0.0f && d4 <= d3) {  // vertex B
      v = 1.0f;
      w = 0.0f;
    } else {
      float vc = d1 * d4 - d3 * d2;
      if (vc <= 0.0f && d1 >= 0.0f && d3 <= 0.0f) {  // edge AB
        v = d1 / (d1 - d3);
        w = 0.0f;
      } else if (d6 >= 0.0f && d5 <= d6) {  // vertex C
        v = 0.0f;
        w = 1.0f;
      } else {
        float vb2 = d5 * d2 - d1 * d6;
        if (vb2 <= 0.0f && d2 >= 0.0f && d6 <= 0.0f) {  // edge AC
          v = 0.0f;
          w = d2 / (d2 - d6);
        } else {
          float va = d3 * d6 - d5 * d4;
          if (va <= 0.0f && (d4 - d3) >= 0.0f && (d5 - d6) >= 0.0f) {  // BC
            float t = (d4 - d3) / ((d4 - d3) + (d5 - d6));
            v = 1.0f - t;
            w = t;
          } else {  // face
            float denom = (va + vb2) + vc;
            v = vb2 / denom;
            w = vc / denom;
          }
        }
      }
    }
    float fx = (v * e10 + w * e20) - qx;
    float fy = (v * e11 + w * e21) - qy;
    float fz = (v * e12 + w * e22) - qz;
    float dd = (fx * fx + fy * fy) + fz * fz;
    if (aa > 0.0f && dd < inf) {
      int key = (__float_as_int(dd) & ~(W - 1)) | j;
      if (key < bk) {
        bk = key;
        p.bc = c;
      }
    }
  }
  p.bk = bk;
  p.vb = nmin(__int_as_float(bk & ~(W - 1)), p.vb);
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
  int W;
  int refine;
};

// Tests group g: fired mask against vb as read before the group, then the
// bound refinement; narrowphases the fired leaves; returns the fired
// interior bits.
__device__ int enter(Point& p, const WideTables& tb, int g) {
  const float inf = __int_as_float(SENT);
  const float* col = tb.gnodes + g;
  const int Gn = tb.Gn;
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
  if (tb.refine) p.vb = ref;
  int lmask = (int)__ldg(col + 7 * K * Gn);
  int lm = m & lmask;
  while (lm) {
    int k = __ffs(lm) - 1;
    lm &= lm - 1;
    const float* ch = col + 7 * k * Gn;
    float ax = __ldg(ch), ay = __ldg(ch + Gn), az = __ldg(ch + 2 * Gn);
    float bx = __ldg(ch + 3 * Gn), by = __ldg(ch + 4 * Gn),
          bz = __ldg(ch + 5 * Gn);
    int c = (int)(-__ldg(ch + 6 * Gn) - 1.0f);
    point_narrow(p, tb.groups, tb.W, c, (ax + bx) * 0.5f, (ay + by) * 0.5f,
                 (az + bz) * 0.5f);
  }
  return m & ~lmask;
}

__global__ void nearest_wide_kernel(WideTables tb,
                                    const float* __restrict__ pts, int n,
                                    float* __restrict__ d2_out,
                                    int* __restrict__ id_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Point p = load_point(pts, n, i);
  int stk_g[WIDE_DMAX];
  int stk_m[WIDE_DMAX];
  int d = 0;
  int gid = 0;
  int mask = enter(p, tb, 0);
  while (true) {
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
    int m2 = enter(p, tb, child);
    if (m2 != 0) {
      stk_g[d] = gid;
      stk_m[d] = mask;
      ++d;
      gid = child;
      mask = m2;
    }
  }
  store_point(p, tb.W, i, d2_out, id_out);
}

__global__ void nearest_entry_exit_kernel(const float* __restrict__ nodes,
                                          int Nn,
                                          const float* __restrict__ groups,
                                          int W, int refine,
                                          const float* __restrict__ pts, int n,
                                          float* __restrict__ d2_out,
                                          int* __restrict__ id_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Point p = load_point(pts, n, i);
  // node rows: box lo (3), box hi (3), entry, exit, each [Nn]
  int cursor = 0;
  while (cursor < Nn) {
    const float* col = nodes + cursor;
    float ax = __ldg(col), ay = __ldg(col + Nn), az = __ldg(col + 2 * Nn);
    float bx = __ldg(col + 3 * Nn), by = __ldg(col + 4 * Nn),
          bz = __ldg(col + 5 * Nn);
    float entry = __ldg(col + 6 * Nn), exit_ = __ldg(col + 7 * Nn);
    float d2min = box_d2min(p, ax, ay, az, bx, by, bz);
    if (refine) p.vb = nmin(p.vb, box_d2max(p, ax, ay, az, bx, by, bz));
    bool fired = d2min < p.vb;
    bool leaf = entry < 0.0f;
    if (leaf && fired)
      point_narrow(p, groups, W, (int)(-entry - 1.0f), (ax + bx) * 0.5f,
                   (ay + by) * 0.5f, (az + bz) * 0.5f);
    cursor = (leaf || !fired) ? (int)exit_ : (int)entry;
  }
  store_point(p, W, i, d2_out, id_out);
}

}  // namespace

extern "C" int nearest_wide_launch(const float* gnodes, int Gn,
                                   const float* groups, int width, int refine,
                                   const float* pts, int n, float* d2_out,
                                   int* id_out, void* stream) {
  if (n <= 0) return 0;
  WideTables tb{gnodes, groups, Gn, width, refine};
  const int block = 128;
  const int grid = (n + block - 1) / block;
  nearest_wide_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      tb, pts, n, d2_out, id_out);
  return (int)cudaGetLastError();
}

extern "C" int nearest_entry_exit_launch(const float* nodes, int Nn,
                                         const float* groups, int width,
                                         int refine, const float* pts, int n,
                                         float* d2_out, int* id_out,
                                         void* stream) {
  if (n <= 0) return 0;
  const int block = 128;
  const int grid = (n + block - 1) / block;
  nearest_entry_exit_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      nodes, Nn, groups, width, refine, pts, n, d2_out, id_out);
  return (int)cudaGetLastError();
}
