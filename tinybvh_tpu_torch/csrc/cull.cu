// Kernel A: fine frustum cull of the packet2 pipeline.
//
// Replaces the TPU kernel tinybvh_tpu/traverse/packet2.py::_cull_kernel
// (with _frustum_pass and the butterfly _compact_left), called from
// cull_tiles. For each group of TB = 8 tiles it walks the group's
// worklist of 128-segment blocks, tests every segment's union box against
// each tile's 4 frustum planes and reach cap, and appends the survivors'
// keys (f32 bits of the origin-box distance with the low leaf_bits
// cleared | segment id) to each tile's list.
//
// What bounds it on this card: memory traffic and latency of the
// worklist walk. Each block step reads 128 segment boxes (3 KB, one
// coalesced 24-byte box per thread) and does ~8 x 40 flops per segment;
// the 50 MB L2 holds the segment tables of every scene up to a few
// million triangles, so blocks shared by neighbouring groups come from
// L2. The serial dependence is the running per-tile output offset.
//
// What the design does about it: one CTA per group, one thread per
// segment lane, the 8 tile descriptors in shared memory. The TPU's
// butterfly compaction becomes a warp ballot + popcount and a 4-warp
// prefix in shared memory: survivors land in worklist order, lane order,
// so the output is deterministic (no atomics). Counting goes on past
// k_cap while only the first k_cap keys are written; the tail is padded
// with I32MAX. Multiplies and adds are rounded separately (__fmul_rn /
// __fadd_rn, no FMA contraction) in the JAX kernel's order, so the
// survivor sets equal the plain PyTorch twin's bit for bit.
#include "common.cuh"

namespace tbvh {
namespace {

__global__ void __launch_bounds__(kLanes)
cull_kernel(const int* __restrict__ nblk, const int* __restrict__ wl,
            const float* __restrict__ desc, const float* __restrict__ llo,
            const float* __restrict__ lhi, int* __restrict__ keys,
            int* __restrict__ cnt, int max_blocks, int spad, int n_leaves,
            int k_cap, int leaf_bits) {
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const int warp = lane >> 5;
  const unsigned below = (1u << (lane & 31)) - 1u;
  __shared__ float sd[kTB][kDLanes];
  __shared__ int warp_cnt[kTB][kLanes / 32];
  for (int i = lane; i < kTB * kDLanes; i += kLanes) {
    const int t = i / kDLanes, c = i % kDLanes;
    sd[t][c] = desc[(size_t)(g * kTB + t) * 128 + c];
  }
  __syncthreads();

  int total[kTB];
#pragma unroll
  for (int t = 0; t < kTB; ++t) total[t] = 0;
  const int nb = min(nblk[g], max_blocks);
  for (int j = 0; j < nb; ++j) {
    const int blk = wl[(size_t)g * max_blocks + j];
    const int seg = blk * kLanes + lane;
    float lo[3], hi[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lo[k] = llo[(size_t)k * spad + seg];
      hi[k] = lhi[(size_t)k * spad + seg];
    }
    const bool in_range = seg < n_leaves;
    bool ok[kTB];
    int key[kTB];
    unsigned bal[kTB];
#pragma unroll
    for (int t = 0; t < kTB; ++t) {
      bool outside = false;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float dist = -sd[t][kDThr + p];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int q = p * 3 + k;
          dist = __fadd_rn(__fadd_rn(dist, __fmul_rn(sd[t][kDPosn + q], hi[k])),
                           __fmul_rn(sd[t][kDNegn + q], lo[k]));
        }
        outside |= dist < 0.f;
      }
      // conservative origin-box -> segment-box distance
      float g2 = 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float gk = fmaxf(__fsub_rn(sd[t][kDOlo + k], hi[k]),
                         __fsub_rn(lo[k], sd[t][kDOhi + k]));
        gk = fmaxf(gk, 0.f);
        g2 = __fadd_rn(g2, __fmul_rn(gk, gk));
      }
      const float lb = __fsqrt_rn(g2);
      ok[t] = !outside && in_range && lb < sd[t][kDTcap];
      key[t] = ((__float_as_int(lb) >> leaf_bits) << leaf_bits) | seg;
      bal[t] = __ballot_sync(0xffffffffu, ok[t]);
      if ((lane & 31) == 0) warp_cnt[t][warp] = __popc(bal[t]);
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kTB; ++t) {
      int before = 0, sum = 0;
#pragma unroll
      for (int w = 0; w < kLanes / 32; ++w) {
        const int c = warp_cnt[t][w];
        before += w < warp ? c : 0;
        sum += c;
      }
      const int pos = total[t] + before + __popc(bal[t] & below);
      if (ok[t] && pos < k_cap)
        keys[(size_t)(g * kTB + t) * k_cap + pos] = key[t];
      total[t] += sum;
    }
    __syncthreads();  // warp_cnt is rewritten by the next block
  }
#pragma unroll
  for (int t = 0; t < kTB; ++t) {
    int* row = keys + (size_t)(g * kTB + t) * k_cap;
    for (int i = min(total[t], k_cap) + lane; i < k_cap; i += kLanes)
      row[i] = kI32Max;
    if (lane == 0) cnt[g * kTB + t] = total[t];
  }
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
  tbvh::cull_kernel<<<G, tbvh::kLanes, 0, (cudaStream_t)stream>>>(
      nblk, wl, desc, llo, lhi, keys, cnt, max_blocks, spad, n_leaves, k_cap,
      leaf_bits);
  return (int)cudaGetLastError();
}
