// Sweep gate: one bit per packet of rays, "does any ray of the packet reach
// any leaf box within its t_max".
//
// Replaces the TPU kernel bvh_tpu/ops/trace.py::_sweep_body (built by
// _make_sweep_kernel, launched by _sweep_tight, exit_on_fire=True). The TPU
// kernel walks one shared cursor per packet over the entry/exit node table
// in scalar memory and stops at the first leaf any ray reaches. Here each
// ray runs the same stackless entry/exit walk on its own, one ray a
// thread, and the packet's bit is the OR of the rays' (every parent box
// contains its children's boxes, so a ray that reaches a leaf passes every
// box above it). A shared cursor over a warp's union of nodes would take 3
// (rays in random directions) to 20 (aimed rays) times the steps of the
// rays' own walks, counted with the plain walk on the main path's rows, so
// each ray keeps its own walk.
//
// What bounds it on an H100: where no ray of a packet fires, the slab tests
// of every ray's whole walk (the node table, tens of KB, stays in cache);
// where one fires, only the shortest walk to a fire. The design does two
// things about that:
//
//   * the loads: one 32-byte record a node (ops/sweep.py::node_records),
//     read as two float4, so a lane's step touches one sector where the
//     table's [8, Nn] rows took 8 scalar loads from 8 cache lines;
//   * exits once the packet's bit is known. The gate is an OR over the
//     packet's rays, so any schedule that finds one firing ray gives the
//     same bit, and stopping there is exact. A thread that reaches a leaf
//     box sets a flag in shared memory and the packet's output word (which
//     the wrapper zeroes; the kernel only ever writes 1 there); every
//     CHECK_EVERY steps each thread reads both (the word with a volatile
//     read, so it sees other blocks' writes) and stops if either is set. A
//     block whose packet's word is set already stops at its start.
//
// Each thread walks and leaves on its own, with no vote: on the random
// rows a warp-wide exit checked every step took 11% longer than every 4
// steps, and a warp-wide check every 4 steps 11% longer than the threads'
// own checks, which tie with it on the aimed rows. The slab test's
// NaN-propagating min and max instructions (slab_hit) then took 13% off the
// random rows and 18% off the first chained part's (kernel_ab.py, PERF.md).
//
// Options: a packed table (the record holds each axis's bf16 pair word, as
// tight_trace.cu reads it), and a pre-gate: a packet whose pre-gate is 0
// reports "not fired" without a walk.
//
// Numerics: built with -fmad=false (each product rounds on its own, as in
// the plain PyTorch version, bvh_tpu_torch/ops/sweep.py); the slab test
// (trace_common.cuh, slab_hit) decides NaN as torch.minimum/maximum do.
// Entry and exit pointers are float VALUES and convert with (int).

#include "trace_common.cuh"

namespace {

constexpr int BLOCK = 128;  // divides every packet (a power of two >= 128)
constexpr int CHECK_EVERY = 4;  // steps between two checks of the exits

__global__ void __launch_bounds__(BLOCK)
    sweep_kernel(const float4* __restrict__ recs, int nn, int packed,
                 const float* __restrict__ rays, int n,
                 const int* __restrict__ pre_gate, int packet, int* gate) {
  // 1 once the block has nothing left to find: its packet is pre-gated
  // off, or some ray of the packet has fired
  __shared__ int stop;
  volatile int* vstop = &stop;
  const int pkt = blockIdx.x * BLOCK / packet;
  volatile int* word = gate + pkt;
  if (threadIdx.x == 0)
    stop = (pre_gate != nullptr && pre_gate[pkt] == 0) || *word != 0;
  __syncthreads();
  if (*vstop) return;  // no barrier follows, so threads may leave apart
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n || nn <= 0) return;
  // ray rows: oi(3) inv(3) t_max, each [n]
  const float oix = rays[0 * n + i], oiy = rays[1 * n + i],
              oiz = rays[2 * n + i];
  const float ix = rays[3 * n + i], iy = rays[4 * n + i], iz = rays[5 * n + i];
  const float tmx = rays[6 * n + i];
  int cur = 0;
  for (int step = 1;; ++step) {
    const Node nd = read_node(recs, packed, cur);
    const bool useful = slab_hit(nd.ax, nd.ay, nd.az, nd.bx, nd.by, nd.bz,
                                 oix, oiy, oiz, ix, iy, iz, tmx);
    if (useful && nd.entry < 0.0f) {
      // the packet's bit is 1: tell this block's threads and the others
      *vstop = 1;
      *word = 1;
      return;
    }
    cur = useful ? (int)nd.entry : (int)nd.exit_;
    if (cur >= nn) return;
    if (step % CHECK_EVERY == 0 && (*vstop != 0 || *word != 0)) return;
  }
}

}  // namespace

// The floats of a node's record, for the wrapper to check against its own
// layout (ops/sweep.py::node_records).
extern "C" int sweep_rec_floats() { return NODE_REC; }

// recs: the node-major table [nn, NODE_REC] (ops/sweep.py::node_records);
// gate: [ceil(n / packet)] int32, zeroed by the caller.
extern "C" int sweep_gate_launch(const float* recs, int nn, int packed,
                                 const float* rays, int n,
                                 const int* pre_gate, int packet, int* gate,
                                 void* stream) {
  if (n <= 0) return 0;
  const int grid = (n + BLOCK - 1) / BLOCK;
  sweep_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(recs), nn, packed, rays, n, pre_gate,
      packet, gate);
  return (int)cudaGetLastError();
}
