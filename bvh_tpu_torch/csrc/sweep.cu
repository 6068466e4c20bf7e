// Sweep gate: one bit per packet of rays, "does any ray of the packet reach
// any leaf box within its t_max".
//
// Replaces the TPU kernel bvh_tpu/ops/trace.py::_sweep_body (built by
// _make_sweep_kernel, launched by _sweep_tight, exit_on_fire=True). The TPU
// kernel walks one shared cursor per packet over the entry/exit node table
// in scalar memory and stops at the first leaf any ray reaches. Here each
// ray runs the same stackless entry/exit walk on its own until a leaf box
// passes; a block-wide OR and one atomic OR per block give the packet's
// bit. The two agree because every parent box contains its children's
// boxes, so a ray that reaches a leaf passes every box above it.
//
// Options: a packed [5, Nn] table (rows 0-2 each axis's (min, max) as the
// high and low bf16 halves of one float32 word, rows 3-4 entry and exit;
// as tight_trace.cu reads it), and a pre-gate: a packet whose pre-gate is
// 0 reports "not fired" without a walk.
//
// What bounds it on an H100: the float32 slab tests of the walk (per ray,
// one per visited node); the node table (tens of KB) stays in cache. Rays
// that leave early idle in their warp. This first version is the simple,
// exact design.
//
// Numerics: built with -fmad=false (each product rounds on its own, as in
// the plain PyTorch version, bvh_tpu_torch/ops/sweep.py); min/max propagate
// NaN like torch.minimum/maximum. Entry and exit pointers are float VALUES
// and convert with (int).

#include "trace_common.cuh"

namespace {

constexpr int BLOCK = 128;  // divides every packet (a power of two >= 128)

__global__ void sweep_kernel(const float* __restrict__ nodes, int nn,
                             int packed, const float* __restrict__ rays, int n,
                             const int* __restrict__ pre_gate, int packet,
                             int* __restrict__ gate) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int fired = 0;
  if (i < n && (pre_gate == nullptr || pre_gate[i / packet] != 0)) {
    // ray rows: oi(3) inv(3) t_max, each [n]
    float oix = rays[0 * n + i], oiy = rays[1 * n + i], oiz = rays[2 * n + i];
    float ix = rays[3 * n + i], iy = rays[4 * n + i], iz = rays[5 * n + i];
    float tmx = rays[6 * n + i];
    int cur = 0;
    while (cur < nn) {
      float ax, ay, az, bx, by, bz, entry, exit_;
      if (packed) {
        unpack_pair(__ldg(nodes + 0 * nn + cur), ax, bx);
        unpack_pair(__ldg(nodes + 1 * nn + cur), ay, by);
        unpack_pair(__ldg(nodes + 2 * nn + cur), az, bz);
        entry = __ldg(nodes + 3 * nn + cur);
        exit_ = __ldg(nodes + 4 * nn + cur);
      } else {
        ax = __ldg(nodes + 0 * nn + cur), ay = __ldg(nodes + 1 * nn + cur);
        az = __ldg(nodes + 2 * nn + cur), bx = __ldg(nodes + 3 * nn + cur);
        by = __ldg(nodes + 4 * nn + cur), bz = __ldg(nodes + 5 * nn + cur);
        entry = __ldg(nodes + 6 * nn + cur);
        exit_ = __ldg(nodes + 7 * nn + cur);
      }
      float t1 = ax * ix - oix;
      float t2 = bx * ix - oix;
      float u1 = ay * iy - oiy;
      float u2 = by * iy - oiy;
      float v1 = az * iz - oiz;
      float v2 = bz * iz - oiz;
      float tmin = nmax(nmax(nmin(t1, t2), nmin(u1, u2)), nmin(v1, v2));
      float tmax = nmin(nmin(nmax(t1, t2), nmax(u1, u2)), nmax(v1, v2));
      bool useful = (tmax >= nmax(tmin, 0.0f)) && (tmin < tmx);
      if (useful && entry < 0.0f) {
        fired = 1;
        break;
      }
      cur = useful ? (int)entry : (int)exit_;
    }
  }
  if (__syncthreads_or(fired) && threadIdx.x == 0)
    atomicOr(gate + (blockIdx.x * BLOCK) / packet, 1);
}

}  // namespace

extern "C" int sweep_gate_launch(const float* nodes, int nn, int packed,
                                 const float* rays, int n,
                                 const int* pre_gate, int packet, int* gate,
                                 void* stream) {
  if (n <= 0) return 0;
  const int grid = (n + BLOCK - 1) / BLOCK;
  sweep_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      nodes, nn, packed, rays, n, pre_gate, packet, gate);
  return (int)cudaGetLastError();
}
