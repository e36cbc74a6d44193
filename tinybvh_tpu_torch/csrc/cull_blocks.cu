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
// read of the block boxes (24 bytes a block, shared by every group, so
// they come from L2). The work is 8 x 4 x 6 flops per (group, block).
//
// What the design does about it: one CTA per group, the 8 tile
// descriptors in shared memory, one thread per block id striding over
// nbpad, coalesced box reads and mask writes. The plane test is
// common.cuh's frustum_outside, shared with kernel A, so the two tiers
// round every multiply and add the same way (the JAX _frustum_pass order)
// and cannot drift; the mask equals the plain PyTorch twin's bit for bit.
#include "common.cuh"

namespace tbvh {
namespace {

__global__ void __launch_bounds__(kLanes)
cull_blocks_kernel(const float* __restrict__ desc,
                   const float* __restrict__ blo,
                   const float* __restrict__ bhi, int* __restrict__ mask,
                   int nbpad, int n_blocks) {
  const int g = blockIdx.x;
  __shared__ float sd[kTB][kDLanes];
  for (int i = threadIdx.x; i < kTB * kDLanes; i += kLanes) {
    const int t = i / kDLanes, c = i % kDLanes;
    sd[t][c] = desc[(size_t)(g * kTB + t) * 128 + c];
  }
  __syncthreads();
  for (int id = threadIdx.x; id < nbpad; id += kLanes) {
    float lo[3], hi[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lo[k] = blo[(size_t)k * nbpad + id];
      hi[k] = bhi[(size_t)k * nbpad + id];
    }
    bool any = false;
#pragma unroll
    for (int t = 0; t < kTB; ++t) any |= !frustum_outside(sd[t], lo, hi);
    mask[(size_t)g * nbpad + id] = (any && id < n_blocks) ? 1 : 0;
  }
}

}  // namespace
}  // namespace tbvh

// desc (G*8, 128) f32, blo/bhi (3, nbpad) f32 -> mask (G, 1, nbpad) i32.
extern "C" int tbvh_cull_blocks(const float* desc, const float* blo,
                                const float* bhi, int* mask, int G, int nbpad,
                                int n_blocks, void* stream) {
  if (G <= 0 || nbpad <= 0 || nbpad % tbvh::kLanes)
    return (int)cudaErrorInvalidValue;
  tbvh::cull_blocks_kernel<<<G, tbvh::kLanes, 0, (cudaStream_t)stream>>>(
      desc, blo, bhi, mask, nbpad, n_blocks);
  return (int)cudaGetLastError();
}

// Kernel G's resources (see common.cuh kernel_occupancy).
extern "C" int tbvh_cull_blocks_occupancy(int* out) {
  return tbvh::kernel_occupancy(
      reinterpret_cast<const void*>(&tbvh::cull_blocks_kernel), tbvh::kLanes,
      0, out);
}
