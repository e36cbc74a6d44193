// Kernel A: fine frustum cull of the packet2 pipeline.
//
// Replaces the TPU kernel tinybvh_tpu/traverse/packet2.py::_cull_kernel
// (with _frustum_pass and the butterfly _compact_left), called from
// cull_tiles. For each tile it walks its group's worklist of 128-segment
// blocks (a group is TB = 8 tiles), tests every segment's union box
// against the tile's 4 frustum planes and reach cap, and appends the
// survivors' keys (f32 bits of the origin-box distance with the low
// leaf_bits cleared | segment id) to the tile's list.
//
// What bounds it on this card: latency. The work is small (~3,200 block
// steps of 128 segments x 8 tiles at the API's shapes, a few µs of fp32
// issue), but each step is a chain of dependent loads (the worklist entry,
// then six box loads) followed by a compaction whose running offset
// depends on the step before. One CTA per group, as on the TPU, puts
// 200 CTAs and a serial walk of ~16 such steps on 132 SMs: nothing hides
// the chain.
//
// What the design does about it: one CTA of 128 threads per tile (1,600
// CTAs at the API's shapes, all resident at once), one thread per segment
// lane, the tile's descriptor in registers; kSteps = 4 worklist blocks a
// step, so each thread has 4 x 6 independent box loads in flight, and one
// barrier per step (the warp counts are double-buffered). The group's
// boxes are re-read from L2 by each of its tiles (~8 x 3 KB per block).
// The TPU's butterfly compaction becomes a warp ballot + popcount and a
// prefix over (block, warp) counts in shared memory: survivors land in
// worklist order, lane order, so the output is deterministic (no
// atomics). Counting goes on past k_cap while only the first k_cap keys
// are written; the tail is padded with I32MAX. Multiplies and adds are
// rounded separately (__fmul_rn / __fadd_rn, no FMA contraction) in the
// JAX kernel's order, so the keys equal the plain PyTorch twin's bit for
// bit. The plane test is common.cuh's frustum_outside, shared with kernel
// G.
#include "common.cuh"

namespace tbvh {
namespace {

constexpr int kSteps = 4;  // worklist blocks a step

__global__ void __launch_bounds__(kLanes)
cull_kernel(const int* __restrict__ nblk, const int* __restrict__ wl,
            const float* __restrict__ desc, const float* __restrict__ llo,
            const float* __restrict__ lhi, int* __restrict__ keys,
            int* __restrict__ cnt, int max_blocks, int spad, int n_leaves,
            int k_cap, int leaf_bits) {
  constexpr int kWarps = kLanes / 32;
  const int tile = blockIdx.x;
  const int g = tile / kTB;
  const int lane = threadIdx.x;
  const int warp = lane >> 5;
  const unsigned below = (1u << (lane & 31)) - 1u;
  __shared__ int warp_cnt[2][kSteps][kWarps];
  float d[kDLanes];
#pragma unroll
  for (int c = 0; c < kDLanes; ++c) d[c] = desc[(size_t)tile * 128 + c];

  int total = 0;
  const int nb = min(nblk[g], max_blocks);
  const int* gwl = wl + (size_t)g * max_blocks;
  for (int j0 = 0, buf = 0; j0 < nb; j0 += kSteps, buf ^= 1) {
    float lo[kSteps][3], hi[kSteps][3];
    int seg[kSteps];
    bool in[kSteps];
#pragma unroll
    for (int b = 0; b < kSteps; ++b) {
      const bool blk_in = j0 + b < nb;
      seg[b] = (blk_in ? gwl[j0 + b] : 0) * kLanes + lane;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        lo[b][k] = blk_in ? llo[(size_t)k * spad + seg[b]] : 0.f;
        hi[b][k] = blk_in ? lhi[(size_t)k * spad + seg[b]] : 0.f;
      }
      in[b] = blk_in && seg[b] < n_leaves;
    }
    bool ok[kSteps];
    int key[kSteps];
    unsigned bal[kSteps];
#pragma unroll
    for (int b = 0; b < kSteps; ++b) {
      const bool outside = frustum_outside(d, lo[b], hi[b]);
      // conservative origin-box -> segment-box distance
      float g2 = 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float gk = fmaxf(__fsub_rn(d[kDOlo + k], hi[b][k]),
                         __fsub_rn(lo[b][k], d[kDOhi + k]));
        gk = fmaxf(gk, 0.f);
        g2 = __fadd_rn(g2, __fmul_rn(gk, gk));
      }
      const float lb = __fsqrt_rn(g2);
      ok[b] = !outside && in[b] && lb < d[kDTcap];
      key[b] = ((__float_as_int(lb) >> leaf_bits) << leaf_bits) | seg[b];
      bal[b] = __ballot_sync(0xffffffffu, ok[b]);
      if ((lane & 31) == 0) warp_cnt[buf][b][warp] = __popc(bal[b]);
    }
    // one barrier a step: the next step writes the other buffer, and the
    // one after it only once every thread has passed the next barrier
    __syncthreads();
#pragma unroll
    for (int b = 0; b < kSteps; ++b) {
      int before = 0, sum = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int c = warp_cnt[buf][b][w];
        before += w < warp ? c : 0;
        sum += c;
      }
      const int pos = total + before + __popc(bal[b] & below);
      if (ok[b] && pos < k_cap) keys[(size_t)tile * k_cap + pos] = key[b];
      total += sum;
    }
  }
  int* row = keys + (size_t)tile * k_cap;
  for (int i = min(total, k_cap) + lane; i < k_cap; i += kLanes)
    row[i] = kI32Max;
  if (lane == 0) cnt[tile] = total;
}

}  // namespace
}  // namespace tbvh

// nblk (G,) i32, wl (G, max_blocks) i32, desc (G*8, 128) f32,
// llo/lhi (3, spad) f32 -> keys (G*8, k_cap) i32, cnt (G*8,) i32.
extern "C" int tbvh_cull(const int* nblk, const int* wl, const float* desc,
                         const float* llo, const float* lhi, int* keys,
                         int* cnt, int G, int max_blocks, int spad,
                         int n_leaves, int k_cap, int leaf_bits,
                         void* stream) {
  if (G <= 0 || max_blocks <= 0 || k_cap <= 0 || spad % tbvh::kLanes ||
      leaf_bits <= 0 || leaf_bits >= 31)
    return (int)cudaErrorInvalidValue;
  tbvh::cull_kernel<<<G * tbvh::kTB, tbvh::kLanes, 0,
                      (cudaStream_t)stream>>>(nblk, wl, desc, llo, lhi, keys,
                                              cnt, max_blocks, spad, n_leaves,
                                              k_cap, leaf_bits);
  return (int)cudaGetLastError();
}

// Kernel A's resources (see common.cuh kernel_occupancy).
extern "C" int tbvh_cull_occupancy(int* out) {
  return tbvh::kernel_occupancy(
      reinterpret_cast<const void*>(&tbvh::cull_kernel), tbvh::kLanes, 0,
      out);
}
