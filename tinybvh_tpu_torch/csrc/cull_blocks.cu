// Kernel G: coarse block tier of the packet2 frustum cull.
//
// Replaces the TPU kernel tinybvh_tpu/traverse/packet2.py::
// _cull_blocks_kernel (the probes' inline pallas_call,
// benchmarks/packet2_probe.py:116-148, benchmarks/cull_stage_probe.py:61).
// For each group of TB = 8 tiles it tests the union box of every
// 128-segment block against each tile's 4 frustum planes and writes 1 for
// the blocks that meet any of the 8 frusta (and whose id is < n_blocks).
// cull_tiles runs the same tier as array ops, as the JAX package does.
//
// What bounds it on this card: launch latency and, for large scenes, the
// plane tests themselves: at grid16 (200 groups, 685 blocks) 1.1M
// (block, tile) tests of 4 x 3 x (2 mul + 2 add) rounded on their own.
// The block boxes (24 bytes a block, shared by every group) come from L2.
//
// What the design does about it: a 2-D grid, one CTA per (group, chunk of
// kChunk = 128 block ids), one thread per block id, so that a scene with
// many blocks spreads over more CTAs (grid16: 200 x 6) instead of
// lengthening each thread's loop. Each thread issues its box loads first;
// the CTA stages the 28 descriptor lanes the test reads of the group's 8
// tiles in shared memory, and each tile's row is read at its use in 7
// vector loads (a broadcast); a thread stops at the first tile that sees
// its block. With no loop over block ids nothing is hoisted into
// registers (holding all 8 descriptors took 253 registers, 2 CTAs an SM),
// and __launch_bounds__ holds the kernel to 64 registers a thread.
// Coalesced box reads and mask writes. The plane test is common.cuh's
// frustum_outside, shared with kernel A, so the two tiers round every
// multiply and add the same way (the JAX _frustum_pass order) and cannot
// drift; the mask equals the plain PyTorch twin's bit for bit.
#include "common.cuh"

namespace tbvh {
namespace {

constexpr int kChunk = kLanes;    // block ids a CTA, one a thread
constexpr int kRow = kDThr + 4;   // descriptor lanes the plane test reads

__global__ void __launch_bounds__(kChunk, 8)
cull_blocks_kernel(const float* __restrict__ desc,
                   const float* __restrict__ blo,
                   const float* __restrict__ bhi, int* __restrict__ mask,
                   int nbpad, int n_blocks) {
  const int g = blockIdx.x;
  const int id = blockIdx.y * kChunk + threadIdx.x;
  bool todo = id < n_blocks;
  float lo[3], hi[3];
  if (todo) {  // the box's loads first
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lo[k] = blo[(size_t)k * nbpad + id];
      hi[k] = bhi[(size_t)k * nbpad + id];
    }
  }
  __shared__ float4 sd[kTB][kRow / 4];
  float* sdf = reinterpret_cast<float*>(sd);
  for (int e = threadIdx.x; e < kTB * kRow; e += kChunk)
    sdf[e] = desc[(size_t)(g * kTB + e / kRow) * 128 + e % kRow];
  __syncthreads();
  bool any = false;
#pragma unroll 1
  for (int t = 0; t < kTB && todo; ++t) {
    float d[kRow];  // this tile's planes, 7 vector reads
#pragma unroll
    for (int c = 0; c < kRow / 4; ++c) {
      const float4 v = sd[t][c];
      d[4 * c] = v.x;
      d[4 * c + 1] = v.y;
      d[4 * c + 2] = v.z;
      d[4 * c + 3] = v.w;
    }
    if (!frustum_outside(d, lo, hi)) any = true, todo = false;
  }
  mask[(size_t)g * nbpad + id] = any ? 1 : 0;
}

}  // namespace
}  // namespace tbvh

// desc (G*8, 128) f32, blo/bhi (3, nbpad) f32 -> mask (G, 1, nbpad) i32.
extern "C" int tbvh_cull_blocks(const float* desc, const float* blo,
                                const float* bhi, int* mask, int G, int nbpad,
                                int n_blocks, void* stream) {
  if (G <= 0 || nbpad <= 0 || nbpad % tbvh::kLanes)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(G, nbpad / tbvh::kChunk);  // nbpad is a multiple of it
  tbvh::cull_blocks_kernel<<<grid, tbvh::kChunk, 0, (cudaStream_t)stream>>>(
      desc, blo, bhi, mask, nbpad, n_blocks);
  return (int)cudaGetLastError();
}

// Kernel G's resources (see common.cuh kernel_occupancy).
extern "C" int tbvh_cull_blocks_occupancy(int* out) {
  return tbvh::kernel_occupancy(
      reinterpret_cast<const void*>(&tbvh::cull_blocks_kernel),
      tbvh::kChunk, 0, out);
}
