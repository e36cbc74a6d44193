// Kernel C: triple-product Möller–Trumbore over pre-gathered triangle rows
// (the fused=False path of the packet2 pipeline).
//
// Replaces the TPU kernel tinybvh_tpu/traverse/packet2.py::_mt_kernel,
// called from mt_resolve. Per tile of 256 rays, the tile's triangle rows
// were gathered beforehand into geom (T, K4, 48) in list order. The
// kernel walks them in blocks of 128 rows while the block's gate is <= the
// tile's max best t, computes det, u', v', t' of each (row, ray) pair as
// 12-lane dots with the ray features f = [d, o x d, o, 1, 0, 0], and keeps
// each ray's closest t and the row it came from.
//
// What bounds it on this card: fp32 issue rate. A block is 128 x 48 f32
// (24 KB) shared by all 256 rays, ~2 x 4 x 12 flops per (row, ray) pair;
// reading geom from device memory costs K4 x 192 bytes per tile, which is
// small against the K4 x 256 x ~110 flops. K4 = 4 x max_leaves reaches
// 2048 rows (384 KB) at the API's budget, over a CTA's 227 KB of shared
// memory, so blocks are streamed, not held. K = 12 is far below what wgmma
// is for, and the ray path stays IEEE fp32, so there are no tensor cores.
//
// What the design does about it: one CTA per tile, one ray per thread with
// its 12 features (computed in-kernel, as on the TPU) and best hit in
// registers. Each 128-row block is copied into shared memory with 16-byte
// loads and read back as a broadcast (all threads read the same row, no
// bank conflicts). The gate compares with the CTA-wide max of best t taken
// before the block (NaN propagates, and then the loop stops, as jnp's
// `gate <= t_far` does). Within a block the first row of the minimum wins
// (jnp.argmin); across blocks only a strictly smaller t replaces the best.
// The hit test and the IEEE division ts / ad follow the JAX kernel; every
// multiply and add is rounded separately in lane order (common.cuh
// signed_terms; kernel B's tri_terms in mt_fused.cu computes the same
// terms from float4 reads), so results equal the plain PyTorch
// twin's bit for bit. A simple kernel: cp.async double buffering is later
// work.
#include "common.cuh"

namespace tbvh {
namespace {

constexpr int kTriBlk = 128;  // rows per block (packet2.py TRI_BLK)
constexpr int kRow = 48;      // [G_det | G_u | G_v | G_t]

__global__ void __launch_bounds__(kTile)
mt_gathered_kernel(const float* __restrict__ o_t, const float* __restrict__ d_t,
                   const float* __restrict__ geom, const float* __restrict__ lbg,
                   const float* __restrict__ tmax, float* __restrict__ t_out,
                   int* __restrict__ i_out, int k4, int nb) {
  __shared__ __align__(16) float rows[kTriBlk * kRow];
  __shared__ float red[kTile / 32];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t ray = (size_t)tile * kTile + tid;

  const float* ot = o_t + (size_t)tile * 3 * kTile + tid;
  const float* dt = d_t + (size_t)tile * 3 * kTile + tid;
  const float ox = ot[0], oy = ot[kTile], oz = ot[2 * kTile];
  const float dx = dt[0], dy = dt[kTile], dz = dt[2 * kTile];
  const float f[12] = {dx, dy, dz,
                       __fsub_rn(__fmul_rn(oy, dz), __fmul_rn(oz, dy)),
                       __fsub_rn(__fmul_rn(oz, dx), __fmul_rn(ox, dz)),
                       __fsub_rn(__fmul_rn(ox, dy), __fmul_rn(oy, dx)),
                       ox, oy, oz, 1.f, 0.f, 0.f};

  float best_t = tmax[tile];
  int best_i = 0;
  const float4* src = reinterpret_cast<const float4*>(
      geom + (size_t)tile * k4 * kRow);
  const float* gates = lbg + (size_t)tile * nb;
  constexpr int kVec = kTriBlk * kRow / 4;  // float4 per block

  for (int blk = 0; blk < nb; ++blk) {
    const float t_far = block_max(best_t, red);  // ends with a barrier
    if (!(gates[blk] <= t_far)) break;
    float4* dst = reinterpret_cast<float4*>(rows);
    const float4* bsrc = src + (size_t)blk * kVec;
    for (int e = tid; e < kVec; e += kTile) dst[e] = bsrc[e];
    __syncthreads();
    float m = __int_as_float(0x7f800000);  // +inf: row 0 always sets it
    int am = 0;
    for (int r = 0; r < kTriBlk; ++r) {
      const SignedTerms s = signed_terms(rows + r * kRow, f);
      const float tt = s.hit ? __fdiv_rn(s.ts, s.ad > 0.f ? s.ad : 1.f) : kFar;
      // first minimum wins; a NaN is the minimum, as in jnp.argmin
      if (tt < m || (tt != tt && m == m)) {
        m = tt;
        am = r;
      }
    }
    if (m < best_t) {
      best_t = m;
      best_i = blk * kTriBlk + am;
    }
    __syncthreads();  // rows is rewritten by the next block
  }
  t_out[ray] = best_t;
  i_out[ray] = best_i;
}

}  // namespace
}  // namespace tbvh

// o_t, d_t (T, 3, 256) f32, geom (T, k4, 48) f32, lbg (T, 1, nb) f32,
// tmax (T, 1, 1) f32 -> t (T, 256) f32, idx (T, 256) i32.
extern "C" int tbvh_mt_gathered(const float* o_t, const float* d_t,
                                const float* geom, const float* lbg,
                                const float* tmax, float* t, int* idx, int T,
                                int k4, int nb, void* stream) {
  if (T <= 0 || k4 <= 0 || k4 % tbvh::kTriBlk || nb != k4 / tbvh::kTriBlk)
    return (int)cudaErrorInvalidValue;
  tbvh::mt_gathered_kernel<<<T, tbvh::kTile, 0, (cudaStream_t)stream>>>(
      o_t, d_t, geom, lbg, tmax, t, idx, k4, nb);
  return (int)cudaGetLastError();
}
