// What the two closest/any-hit trace kernels share (wide_trace.cu, the group
// walk, and tight_trace.cu, the entry/exit walk): the per-ray state, the
// NaN-propagating min/max, the bf16-pair unpack, the slab test of a box and
// the leaf test of a cluster in warp form (warp_leaves). The entry/exit walk
// and the sweep gate (sweep.cu) also share the node record of an entry/exit
// table (read_node), and the sweep the slab test (slab_hit); the legacy
// cluster trace (cluster_trace.cu) takes the min/max and the triangle test
// in the exact cluster frame (load_tri, tri_key_frame).
//
// The leaf test replaces the TPU kernel's bvh_tpu/ops/trace.py::
// _narrow_cluster: Moller-Trumbore of one ray against the W triangles of
// cluster c (rows a', e1, e2 of groups [G, 16, 128], relative to the
// cluster's frame origin cc, at lanes (c mod 128/W)*W + j), the packed key
// (the bits of t with the low log2(W) bits replaced by the lane, kept when
// strictly smaller), then the update of the pruning bound vb:
//
//   closest: vb = the key's t;
//   bounded: vb = min(the key's t, vb);
//   any:     vb = -inf if the key's t < t_max, else t_max (a ray with an
//            occluder inside its bound fires no box again).
//
// The four bilinear forms are regrouped around the origin in the triangle's
// own frame, tv = o' - a' (= o - a, exact where o' and a' are): det = d.p,
// u.det = e2.w, v.det = -e1.w, t.det = -tv.p with p = e2 x e1 and
// w = tv x d. The TPU kernel sums terms of the size of the cluster frame (m
// = o x d and cc x d, up to 1e5) and loses up to ~1e-3 of a unit at
// triangle edges; this form keeps edge tests exact to float rounding of the
// triangle's own size.
//
// Numerics: the kernels are built with -fmad=false, so every product rounds
// on its own as in the plain PyTorch versions (bvh_tpu_torch/ops/wide.py,
// ops/tight.py), and each sum keeps the written order. min/max propagate NaN
// like torch.minimum/maximum: empty child slots hold NaN boxes and must
// never fire (fminf would return the other operand and fire them). Payloads,
// entry and exit pointers are float VALUES and convert with (int).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float EPS = 1.1920928955078125e-07f;  // float32 machine epsilon
constexpr int SENT = 0x7F800000;                // +inf bits: "no hit" key
constexpr int MODE_CLOSEST = 0;
constexpr int MODE_BOUNDED = 1;
constexpr int MODE_ANY = 2;
constexpr unsigned FULL = 0xFFFFFFFFu;  // every lane of a warp

__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xFF800000); }

// One word of a bf16-packed node table: the box min in the high half (bits
// & 0xFFFF0000), the box max in the low half (bits << 16).
__device__ __forceinline__ void unpack_pair(float w, float& lo, float& hi) {
  unsigned bits = (unsigned)__float_as_int(w);
  lo = __int_as_float((int)(bits & 0xFFFF0000u));
  hi = __int_as_float((int)(bits << 16));
}

// One node of an entry/exit table, read from its node-major record (two
// float4, ops/sweep.py::node_records): the box, a leaf's frame origin and
// the entry and exit pointers. A packed record holds each axis's bf16 pair
// word, unpacked here, and that raw word is the frame origin, against which
// the scene build stored the leaf's group rows; an f32 record holds box lo
// and hi, and the frame origin is the box's centre.
constexpr int NODE_REC = 8;  // floats a node record

struct Node {
  float ax, ay, az, bx, by, bz;  // box
  float ccx, ccy, ccz;           // a leaf's frame origin
  float entry, exit_;
};

__device__ __forceinline__ Node read_node(const float4* __restrict__ recs,
                                          bool packed, int cur) {
  const float4 u = __ldg(recs + 2 * cur);
  const float4 v = __ldg(recs + 2 * cur + 1);
  Node nd;
  if (packed) {
    nd.ccx = u.x;
    nd.ccy = u.y;
    nd.ccz = u.z;
    unpack_pair(u.x, nd.ax, nd.bx);
    unpack_pair(u.y, nd.ay, nd.by);
    unpack_pair(u.z, nd.az, nd.bz);
  } else {
    nd.ax = u.x;
    nd.ay = u.y;
    nd.az = u.z;
    nd.bx = u.w;
    nd.by = v.x;
    nd.bz = v.y;
    nd.ccx = (nd.ax + nd.bx) * 0.5f;
    nd.ccy = (nd.ay + nd.by) * 0.5f;
    nd.ccz = (nd.az + nd.bz) * 0.5f;
  }
  nd.entry = v.z;
  nd.exit_ = v.w;
  return nd;
}

struct RayState {
  float oix, oiy, oiz, ix, iy, iz;  // o * inv, inv (clamped to +-1e30)
  float dx, dy, dz, ox, oy, oz;     // d, o
  float tmx;  // t_max
  float vb;   // pruning bound
  int bk;     // packed best key
  int bc;     // best cluster
};

// ray rows: oi(3) inv(3) t_max d(3) o(3), each [n]
__device__ __forceinline__ RayState load_ray(const float* __restrict__ rays,
                                             int n, int i) {
  RayState r;
  r.oix = rays[0 * n + i]; r.oiy = rays[1 * n + i]; r.oiz = rays[2 * n + i];
  r.ix = rays[3 * n + i]; r.iy = rays[4 * n + i]; r.iz = rays[5 * n + i];
  r.tmx = rays[6 * n + i];
  r.dx = rays[7 * n + i]; r.dy = rays[8 * n + i]; r.dz = rays[9 * n + i];
  r.ox = rays[10 * n + i]; r.oy = rays[11 * n + i]; r.oz = rays[12 * n + i];
  r.vb = r.tmx;
  r.bk = SENT;
  r.bc = 0;
  return r;
}

__device__ __forceinline__ void store_ray(const RayState& r, int W, int i,
                                          float* __restrict__ t_out,
                                          int* __restrict__ id_out) {
  t_out[i] = __int_as_float(r.bk & ~(W - 1));
  id_out[i] = r.bk < SENT ? r.bc * W + (r.bk & (W - 1)) : -1;
}

__device__ __forceinline__ void store_miss(int i, float* __restrict__ t_out,
                                           int* __restrict__ id_out) {
  t_out[i] = __int_as_float(SENT);
  id_out[i] = -1;
}

// NaN-propagating min and max in one instruction each (PTX min.NaN and
// max.NaN, sm_80 and later: NaN if either operand is NaN). Where only
// comparisons read the result, as in the slab test, they decide exactly as
// nmin/nmax and torch.minimum/maximum do: a NaN compares false whatever its
// bits, and +0 and -0 compare equal.
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// The slab test of a box (lo a, hi b) against a ray (o * inv, inv) and a
// bound: the box is entered in front of the origin and before the bound.
// A NaN box (an empty slot) never passes. The trace walks (slab_fires) and
// the sweep gate share it.
__device__ __forceinline__ bool slab_hit(float ax, float ay, float az,
                                         float bx, float by, float bz,
                                         float oix, float oiy, float oiz,
                                         float ix, float iy, float iz,
                                         float bound) {
  float t1 = ax * ix - oix;
  float t2 = bx * ix - oix;
  float u1 = ay * iy - oiy;
  float u2 = by * iy - oiy;
  float v1 = az * iz - oiz;
  float v2 = bz * iz - oiz;
  float tmin = max_nan(max_nan(min_nan(t1, t2), min_nan(u1, u2)),
                       min_nan(v1, v2));
  float tmax = min_nan(min_nan(max_nan(t1, t2), max_nan(u1, u2)),
                       max_nan(v1, v2));
  return (tmax >= max_nan(tmin, 0.0f)) && (tmin < bound);
}

__device__ __forceinline__ bool slab_fires(const RayState& r, float ax,
                                           float ay, float az, float bx,
                                           float by, float bz) {
  return slab_hit(ax, ay, az, bx, by, bz, r.oix, r.oiy, r.oiz, r.ix, r.iy,
                  r.iz, r.vb);
}

// One triangle of a cluster: rows a', e1, e2 (triangle j at tile[row * 128
// + j]) and p = e2 x e1.
struct Tri {
  float a0, a1, a2, e10, e11, e12, e20, e21, e22, p0, p1, p2;
};

__device__ __forceinline__ Tri load_tri(const float* __restrict__ tile,
                                        int j) {
  Tri t;
  t.a0 = __ldg(tile + 0 * 128 + j);
  t.a1 = __ldg(tile + 1 * 128 + j);
  t.a2 = __ldg(tile + 2 * 128 + j);
  t.e10 = __ldg(tile + 3 * 128 + j);
  t.e11 = __ldg(tile + 4 * 128 + j);
  t.e12 = __ldg(tile + 5 * 128 + j);
  t.e20 = __ldg(tile + 6 * 128 + j);
  t.e21 = __ldg(tile + 7 * 128 + j);
  t.e22 = __ldg(tile + 8 * 128 + j);
  t.p0 = t.e21 * t.e12 - t.e22 * t.e11;
  t.p1 = t.e22 * t.e10 - t.e20 * t.e12;
  t.p2 = t.e20 * t.e11 - t.e21 * t.e10;
  return t;
}

// The packed key of one ray, direction d and origin tv = o' - a' in the
// triangle's frame, against triangle t at lane j of a W-wide cluster; sent
// where it misses. The reciprocal of det is taken only where the test
// passes, so a warp whose lanes all miss skips it.
// tri_key_w takes w = tv x d formed by the caller (the FRAME builds form it
// in double).
__device__ __forceinline__ int tri_key_w(const Tri& t, float tvx, float tvy,
                                         float tvz, float w0, float w1,
                                         float w2, float dx, float dy,
                                         float dz, int W, int j, int sent) {
  float det = (t.p0 * dx + t.p1 * dy) + t.p2 * dz;
  float udet = (t.e20 * w0 + t.e21 * w1) + t.e22 * w2;
  float vdet = -((t.e10 * w0 + t.e11 * w1) + t.e12 * w2);
  float tdet = -((t.p0 * tvx + t.p1 * tvy) + t.p2 * tvz);
  bool ok = !(det < EPS) && udet >= 0.0f && udet <= det && vdet >= 0.0f &&
            (udet + vdet) <= det && tdet > EPS * det;
  int key = sent;
  if (ok) key = (__float_as_int(tdet * (1.0f / det)) & ~(W - 1)) | j;
  return key;
}

__device__ __forceinline__ int tri_key(const Tri& t, float tvx, float tvy,
                                       float tvz, float dx, float dy, float dz,
                                       int W, int j, int sent) {
  return tri_key_w(t, tvx, tvy, tvz, tvy * dz - tvz * dy, tvz * dx - tvx * dz,
                   tvx * dy - tvy * dx, dx, dy, dz, W, j, sent);
}

// The FRAME builds' tv and w = tv x d (ops/wide.py::narrow_keys(frame=)),
// and the legacy walk's:
// o - cc as the exact double sum of the broadcast pair (o', lo), a - cc as
// a' + a_lo, their difference and the cross product with d in double, then
// tv and w rounded to float once each. Formed in float, tv ~ 1e5 would
// carry a rounding of its own in every triangle and w = tv x d the rounding
// of products ~1e5, so the two triangles of an edge would see the ray up to
// ~0.006 of a unit apart, and a seam would open between them. w is of the
// size of the ray's offset from a', so its one rounding here is small.
__device__ __forceinline__ int tri_key_frame(const Tri& t, double ox,
                                             double oy, double oz, float alx,
                                             float aly, float alz, float dx,
                                             float dy, float dz, int W, int j,
                                             int sent) {
  const double tx = ox - ((double)t.a0 + (double)alx);
  const double ty = oy - ((double)t.a1 + (double)aly);
  const double tz = oz - ((double)t.a2 + (double)alz);
  const double ex = dx, ey = dy, ez = dz;
  return tri_key_w(t, (float)tx, (float)ty, (float)tz,
                   (float)(ty * ez - tz * ey), (float)(tz * ex - tx * ez),
                   (float)(tx * ey - ty * ex), dx, dy, dz, W, j, sent);
}

// The rounding error of x - y: hi + lo == x - y exactly, with hi the
// rounded difference (Knuth's TwoSum of x and -y; the order of
// ops/cluster_trace.py::two_diff and of cluster_trace.cu).
__device__ __forceinline__ float two_diff_lo(float x, float y) {
  const float hi = x - y;
  const float bv = hi - x;
  const float av = hi - bv;
  return (x - av) - (y + bv);
}

// The rows of cluster c in groups [G, 16, 128]: lanes (c mod 128/W)*W + j.
__device__ __forceinline__ const float* cluster_tile(
    const float* __restrict__ groups, int W, int c) {
  const int per_row = 128 / W;
  return groups + (size_t)(c / per_row) * 16 * 128 + (c % per_row) * W;
}

// Cluster c's lanes in a_lo [G, 3, 128] (the layout of groups' a' rows).
__device__ __forceinline__ const float* cluster_tile3(
    const float* __restrict__ a_lo, int W, int c) {
  const int per_row = 128 / W;
  return a_lo + (size_t)(c / per_row) * 3 * 128 + (c % per_row) * W;
}

// Folds cluster c's smallest key km into the ray: it replaces the best key
// only when strictly smaller, then the bound is updated.
__device__ __forceinline__ void fold_key(RayState& r, int km, int c, int W,
                                         int mode) {
  if (km < r.bk) {
    r.bk = km;
    r.bc = c;
  }
  float nt = __int_as_float(r.bk & ~(W - 1));
  if (mode == MODE_ANY)
    r.vb = nt < r.tmx ? neg_inf() : r.tmx;
  else if (mode == MODE_BOUNDED)
    r.vb = nmin(nt, r.vb);
  else
    r.vb = nt;
}

// The leaf test in warp form (both trace walks): every lane has its own list
// of leaves to test, and the whole warp tests them together, pair by pair.
// next(c, ccx, ccy, ccz) gives the lane's next cluster and its frame origin,
// false once the lane has none left; every lane must call this function.
// Each pass takes the lowest lanes that have a leaf pending: SPAN = min(W,
// 32) lanes serve one (ray, cluster) pair, so W = 16 takes two pairs a pass
// and W = 128 gives each lane four triangles. A lane loads its triangles of
// the pair's cluster (coalesced over the SPAN lanes) and computes p = e2 x e1
// once for them; the pair's owner broadcasts the ray's origin in the
// cluster's frame and its direction (the values the plain versions' leaf
// test uses), the key minimum is taken over the SPAN lanes, and the owner
// folds it. A lane's leaves are folded in its own order, so the result is
// that of testing them one by one in the lane, bit for bit.
//
// FRAME (scenes that carry a_lo [G, 3, 128], laid out as the a' rows of
// groups: every scene the port builds or loads, since a ray whose origin
// lies ~1e5 from a leaf rounds o - cc whoever built the scene, and a device
// build's Morton cluster may lie as far from its frame origin, where a'
// rounds too): the exact cluster frame.
// The owner also broadcasts the rounding error lo of o - cc (two_diff), and
// each lane forms tv = (o - cc) - (a - cc) and w = tv x d in double from the
// pair (o', lo) and its triangle's (a', a_lo), a_lo being the part of
// a - cc that the stored a' leaves out (tri_key_frame). A build without
// FRAME reads no a_lo and compiles to the code it had before the flag.
template <int W, bool FRAME, typename Next>
__device__ __forceinline__ void warp_leaves(RayState& r,
                                            const float* __restrict__ groups,
                                            const float* __restrict__ a_lo,
                                            int mode, int lane, Next next) {
  constexpr int SPAN = W < 32 ? W : 32;  // lanes per pair
  constexpr int TPL = W / SPAN;          // triangles per lane
  constexpr int PPP = 32 / SPAN;         // pairs per pass (1 or 2)
  const int j0 = lane % SPAN;
  int c = 0;
  float ccx = 0.0f, ccy = 0.0f, ccz = 0.0f;
  bool has = next(c, ccx, ccy, ccz);
  while (true) {
    unsigned F = __ballot_sync(FULL, has);
    if (F == 0) break;
    const int f0 = __ffs(F) - 1;
    F &= F - 1;
    const int f1 = (PPP == 2 && F) ? __ffs(F) - 1 : -1;
    // this lane serves pair f0 (first half) or f1 (second half, f0's again
    // when there is no second pair: its result is dropped)
    const int src = (lane >= SPAN && f1 >= 0) ? f1 : f0;
    const int C = __shfl_sync(FULL, c, src);
    const float Ox = __shfl_sync(FULL, r.ox - ccx, src),
                Oy = __shfl_sync(FULL, r.oy - ccy, src),
                Oz = __shfl_sync(FULL, r.oz - ccz, src);
    const float Dx = __shfl_sync(FULL, r.dx, src),
                Dy = __shfl_sync(FULL, r.dy, src),
                Dz = __shfl_sync(FULL, r.dz, src);
    float Lx = 0.0f, Ly = 0.0f, Lz = 0.0f;
    if (FRAME) {
      Lx = __shfl_sync(FULL, two_diff_lo(r.ox, ccx), src);
      Ly = __shfl_sync(FULL, two_diff_lo(r.oy, ccy), src);
      Lz = __shfl_sync(FULL, two_diff_lo(r.oz, ccz), src);
    }
    const float* tile = cluster_tile(groups, W, C);
    // FRAME: o - cc exactly (o' + lo fits a double)
    const double Qx = FRAME ? (double)Ox + (double)Lx : 0.0,
                 Qy = FRAME ? (double)Oy + (double)Ly : 0.0,
                 Qz = FRAME ? (double)Oz + (double)Lz : 0.0;
    int k = SENT;
#pragma unroll
    for (int s = 0; s < TPL; ++s) {
      const int j = j0 + SPAN * s;
      const Tri t = load_tri(tile, j);
      int key;
      if (FRAME) {
        const float* al = cluster_tile3(a_lo, W, C) + j;
        key = tri_key_frame(t, Qx, Qy, Qz, __ldg(al), __ldg(al + 128),
                            __ldg(al + 2 * 128), Dx, Dy, Dz, W, j, SENT);
      } else {
        key = tri_key(t, Ox - t.a0, Oy - t.a1, Oz - t.a2, Dx, Dy, Dz, W, j,
                      SENT);
      }
      k = key < k ? key : k;
    }
    if (SPAN == 32) {
      k = __reduce_min_sync(FULL, k);
    } else {
#pragma unroll
      for (int off = SPAN / 2; off > 0; off >>= 1) {
        const int o = __shfl_xor_sync(FULL, k, off);
        k = o < k ? o : k;
      }
    }
    const int k0 = __shfl_sync(FULL, k, 0);
    const int k1 = __shfl_sync(FULL, k, PPP == 2 ? SPAN : 0);
    if (lane == f0 || lane == f1) {
      fold_key(r, lane == f0 ? k0 : k1, c, W, mode);
      has = next(c, ccx, ccy, ccz);
    }
  }
}

}  // namespace
