// The closest-hit trace's epilogue in one launch: the bound mask, the
// winner's triangle id, its exact (u, v, t) and the answer written to the
// caller's row (ops/trace.py::_epilogue; wrapper ops/epilogue.py).
//
// Replaces no pallas_call: in the JAX package the same glue after the walk
// (bvh_tpu/ops/trace.py, trace_closest_hit_tight's epilogue and
// make_tracer's) is one XLA fusion. Its plain PyTorch form,
// ops/trace.py::_epilogue_plain (_shape_ids, _finish with
// ray.py::ray_intersects_triangle, _unpermute), is some 90 elementwise
// launches a call, each writing its [n] intermediates to device memory; this
// kernel reads each input once and writes the four answers once.
//
// Per answer row j, from the walk's row i = inv[j] (make_tracer's un-sort)
// or i = j:
//
//   t   = t_walk[i], +inf where bounded and not t < t_max (ray row 6);
//   id  = tri_map[clamp(lane[i], 0, n_map - 1)] where t is finite, else -1;
//   with the triangle table (a, b, c), where t is finite: Moller-Trumbore
//         of ray i (rows 7-9 d, rows 10-12 o) against triangle max(id, 0),
//         u and v through its selects, t replaced where the recompute's
//         distance is finite; u = v = 0 otherwise.
//
// What bounds it on an H100: bytes, ~100 a ray with the recompute and the
// un-sort (t and lane 8, tri_map 4, the winner's 36, o and d 24, inv 8,
// the answers 16), ~0.03 ms of HBM3 at 1,048,576 rays; a few dozen float32
// operations a ray are nothing beside them. The design:
//
//   * one answer row a thread, so the four answers are written coalesced;
//     with the un-sort, thread j reads the walk's row inv[j] at random. The
//     walk has just written t and lane (8 bytes a ray, 8-16 MB), and they
//     are read from L2; the other way round, thread i of the walk's order
//     writing row perm[i], scatters 16 bytes a ray into 4 partial sectors
//     and measured slower on every cell's shape with an un-sort (device ms
//     a call, H100, aimed 0.030 against 0.026, random rays 0.073 against
//     0.043);
//   * every value that does not wait on the id (t, lane, the six ray rows)
//     is loaded before the dependent gathers of tri_map and of the winner's
//     vertices, and a miss reads neither the id nor the vertices nor the
//     rays; the triangle tables (4-9 MB on the benchmark's scenes) stay in
//     the 50 MB L2;
//   * the vertices are read through each table's row stride, so the path
//     tracer's [n, 9] table is one 36-byte row a winner and no per-call
//     concatenation is made.
//
// Numerics: built with -fmad=false (ops/_build.py), every product and
// difference rounded on its own, each dot product summed (x + y) + z,
// 1 / det by IEEE division and the selects of ray.py written out in the
// same order: the answers equal the plain composition's bit for bit.

#include "trace_common.cuh"

namespace {

constexpr int BLOCK = 256;  // rays (threads) a block

__device__ __forceinline__ bool finite(float x) {
  return fabsf(x) < __int_as_float(SENT);  // false for inf and NaN
}

// ray.py::_dot: the products rounded, summed (x + y) + z
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return (ax * bx + ay * by) + az * bz;
}

template <bool EXACT, bool BOUNDED, bool UNSORT>
__global__ void __launch_bounds__(BLOCK)
closest_epilogue_kernel(const float* __restrict__ rows, int n,
                        const float* __restrict__ t_walk,
                        const int* __restrict__ lane,
                        const int* __restrict__ tri_map, int n_map,
                        const float* __restrict__ ta,
                        const float* __restrict__ tb,
                        const float* __restrict__ tc, long long sa,
                        long long sb, long long sc,
                        const long long* __restrict__ inv,
                        float* __restrict__ t_out, float* __restrict__ u_out,
                        float* __restrict__ v_out, int* __restrict__ id_out) {
  const int j = blockIdx.x * BLOCK + threadIdx.x;
  if (j >= n) return;
  const size_t N = (size_t)n;
  const long long i = UNSORT ? __ldg(inv + j) : (long long)j;
  float t = __ldg(t_walk + i);
  const int l = __ldg(lane + i);
  if (BOUNDED) {
    // a leaf hit at t >= t_max is a miss (the slab test prunes boxes)
    const float tm = __ldg(rows + 6 * N + i);
    t = t < tm ? t : __int_as_float(SENT);
  }
  int id = -1;
  float u = 0.0f, v = 0.0f;
  if (finite(t)) {
    float dx = 0.0f, dy = 0.0f, dz = 0.0f, ox = 0.0f, oy = 0.0f, oz = 0.0f;
    if (EXACT) {
      dx = __ldg(rows + 7 * N + i);
      dy = __ldg(rows + 8 * N + i);
      dz = __ldg(rows + 9 * N + i);
      ox = __ldg(rows + 10 * N + i);
      oy = __ldg(rows + 11 * N + i);
      oz = __ldg(rows + 12 * N + i);
    }
    id = __ldg(tri_map + min(max(l, 0), n_map - 1));
    if (EXACT) {
      const long long k = id < 0 ? 0 : id;  // the plain gather's clamp
      const float* pa = ta + k * sa;
      const float* pb = tb + k * sb;
      const float* pc = tc + k * sc;
      const float ax = __ldg(pa), ay = __ldg(pa + 1), az = __ldg(pa + 2);
      const float bx = __ldg(pb), by = __ldg(pb + 1), bz = __ldg(pb + 2);
      const float cx = __ldg(pc), cy = __ldg(pc + 1), cz = __ldg(pc + 2);
      // ray.py::_moller_trumbore
      const float abx = bx - ax, aby = by - ay, abz = bz - az;
      const float acx = cx - ax, acy = cy - ay, acz = cz - az;
      const float px = dy * acz - dz * acy;  // d x (c - a)
      const float py = dz * acx - dx * acz;
      const float pz = dx * acy - dy * acx;
      const float det = dot3(abx, aby, abz, px, py, pz);
      const bool cull = det < EPS;
      const float inv_det = 1.0f / (cull ? 1.0f : det);
      const float tox = ox - ax, toy = oy - ay, toz = oz - az;
      const float uu = dot3(tox, toy, toz, px, py, pz) * inv_det;
      const float qx = toy * abz - toz * aby;  // (o - a) x (b - a)
      const float qy = toz * abx - tox * abz;
      const float qz = tox * aby - toy * abx;
      const float vv = dot3(dx, dy, dz, qx, qy, qz) * inv_det;
      const float dist = dot3(acx, acy, acz, qx, qy, qz) * inv_det;
      // ray.py::ray_intersects_triangle's selects, then _finish's
      const bool u_bad = (uu < 0.0f) | (uu > 1.0f);
      const bool v_bad = (vv < 0.0f) | (uu + vv > 1.0f);
      const bool miss = cull | u_bad | v_bad | (dist <= EPS);
      u = cull ? 0.0f : uu;
      v = (cull | u_bad) ? 0.0f : vv;
      if (!miss && finite(dist)) t = dist;
    }
  }
  t_out[j] = t;
  u_out[j] = u;
  v_out[j] = v;
  id_out[j] = id;
}

template <bool EXACT, bool BOUNDED, bool UNSORT>
void launch(int grid, cudaStream_t s, const float* rows, int n,
            const float* t, const int* lane, const int* tri_map, int n_map,
            const float* ta, const float* tb, const float* tc, long long sa,
            long long sb, long long sc, const long long* inv, float* t_out,
            float* u_out, float* v_out, int* id_out) {
  closest_epilogue_kernel<EXACT, BOUNDED, UNSORT><<<grid, BLOCK, 0, s>>>(
      rows, n, t, lane, tri_map, n_map, ta, tb, tc, sa, sb, sc, inv, t_out,
      u_out, v_out, id_out);
}

}  // namespace

// rows: the kernels' ray rows [13, n] float32 (row 6 t_max, rows 7-9 d,
// rows 10-12 o) in the walk's order; t, lane: the walk's [n] answers;
// tri_map: [n_map] int32, n_map >= 1; ta, tb, tc: the triangle table's
// (a, b, c), row k at ta + k * sa (floats), or ta null for no recompute
// (u = v = 0); inv: [n] int64, answer row j from the walk's row inv[j], or
// null for answer row j from row j; t_out, u_out, v_out, id_out: [n].
extern "C" int closest_epilogue_launch(
    const float* rows, int n, const float* t, const int* lane,
    const int* tri_map, int n_map, const float* ta, const float* tb,
    const float* tc, long long sa, long long sb, long long sc, int bounded,
    const long long* inv, float* t_out, float* u_out, float* v_out,
    int* id_out, void* stream) {
  if (n <= 0) return 0;
  const int grid = (n + BLOCK - 1) / BLOCK;
  const cudaStream_t s = (cudaStream_t)stream;
  const int code = (ta != nullptr) * 4 + (bounded != 0) * 2 + (inv != nullptr);
#define EPILOGUE_CASE(c, e, b, u)                                            \
  case c:                                                                    \
    launch<e, b, u>(grid, s, rows, n, t, lane, tri_map, n_map, ta, tb, tc,   \
                    sa, sb, sc, inv, t_out, u_out, v_out, id_out);           \
    break;
  switch (code) {
    EPILOGUE_CASE(0, false, false, false)
    EPILOGUE_CASE(1, false, false, true)
    EPILOGUE_CASE(2, false, true, false)
    EPILOGUE_CASE(3, false, true, true)
    EPILOGUE_CASE(4, true, false, false)
    EPILOGUE_CASE(5, true, false, true)
    EPILOGUE_CASE(6, true, true, false)
    EPILOGUE_CASE(7, true, true, true)
  }
#undef EPILOGUE_CASE
  return (int)cudaGetLastError();
}
