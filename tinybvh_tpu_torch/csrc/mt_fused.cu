// Kernel B: fused gather + triple-product Möller–Trumbore of the packet2
// pipeline.
//
// Replaces the TPU kernel tinybvh_tpu/traverse/packet2.py::
// _mt_fused_kernel / _mt_fused_tile, called from mt_resolve_fused. Per
// tile of 256 rays it walks the tile's pre-decoded triangle-row offsets
// in super-blocks ordered near to far; for every (triangle, ray) pair it
// computes det, u, v, t as 12-term dots of the triangle's row with the
// ray's features f = [d, o x d, o, 1, 0, 0]; it keeps each ray's closest
// hit with its u, v and prim id, and stops once the next super-block's
// distance gate exceeds every ray's best t (any-hit: once every ray is
// below the cutoff).
//
// What bounds it on this card: fp32 issue rate and the serial walk. A
// row costs ~2 x 4 x 12 multiply-adds per ray against 392 bytes of row
// data shared by all 256 rays, so the arithmetic intensity is high; the
// time goes to fp32 instructions and to the per-super-block barriers of
// the tile-wide early exit. K = 12 is far below what wgmma is for, and
// the ray path must stay IEEE fp32, so there are no tensor cores.
//
// What the design does about it: one CTA per tile, one ray per thread
// with its 12 features and best hit in registers. Each super-block is
// streamed through shared memory in chunks of 64 rows (the TPU's
// (2*tri_blk, 128) double buffer is 256 KB at tri_blk = 256, over the
// 227 KB a CTA can have), staging only the lanes in use (0-97 for
// pack = 2, 0-48 for pack = 1). All threads read the same row from
// shared memory (broadcast, no bank conflicts). Row addresses are 64-bit.
// The gate of the next super-block is compared with the CTA-wide max of
// best t taken before the current block (NaN propagates, so a NaN gate
// passes), exactly as on the TPU. Multiplies and adds are rounded
// separately (__fmul_rn / __fadd_rn, no FMA contraction) in lane order,
// so results equal the plain PyTorch twin's bit for bit.
#include "common.cuh"

namespace tbvh {
namespace {

constexpr int kChunk = 64;     // rows staged per chunk
constexpr int kMaxLanes = 98;  // [A 0:48 | B 48:96 | pidA 96 | pidB 97]

// MT for the triangle at lanes [base, base+48) of row g.
__device__ __forceinline__ void mt_half(const float* g, int base,
                                        const float* f, bool live, float& tt,
                                        float& u, float& v) {
  const SignedTerms s = signed_terms(g + base, f);
  const float inv = __fdiv_rn(1.f, s.ad > 0.f ? s.ad : 1.f);
  tt = (s.hit && live) ? __fmul_rn(s.ts, inv) : kFar;
  u = __fmul_rn(s.us, inv);
  v = __fmul_rn(s.vs, inv);
}

__global__ void __launch_bounds__(kTile)
mt_fused_kernel(const int* __restrict__ offs, const int* __restrict__ counts,
                const float* __restrict__ lbg, const float* __restrict__ tmax,
                const float* __restrict__ ff, const float* __restrict__ t0,
                const float* __restrict__ gtab, float* __restrict__ t_out,
                int* __restrict__ i_out, float* __restrict__ u_out,
                float* __restrict__ v_out, int* __restrict__ p_out, int k_cap,
                int nb, int tri_blk, int rps, int pack, int any_hit) {
  __shared__ float rows[kChunk * kMaxLanes];
  __shared__ long long row_addr[kChunk];
  __shared__ float red[kTile / 32];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t ray = (size_t)tile * kTile + tid;

  float f[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) f[k] = ff[((size_t)tile * 12 + k) * kTile + tid];
  float best_t = t0[ray], best_u = 0.f, best_v = 0.f;
  int best_i = 0, best_p = -1;

  const int count = min(counts[tile], k_cap);
  const int kpb = tri_blk / rps;
  const int nsb = (count + kpb - 1) / kpb;
  const int live_rows = count * rps;
  const int nl = pack == 2 ? kMaxLanes : 49;
  const int pid_a = pack == 2 ? 96 : 48;
  const float cutoff = tmax[tile];
  const int* toffs = offs + (size_t)tile * k_cap;

  for (int sb = 0; sb < nsb; ++sb) {
    const float t_far = block_max(best_t, red);
    const float gate_n = lbg[(size_t)tile * nb + min(sb + 1, nb - 1)];
    bool nxt = (sb + 1 < nsb) && !(gate_n > t_far);
    if (any_hit) nxt = nxt && (t_far >= cutoff);
    for (int c0 = 0; c0 < tri_blk; c0 += kChunk) {
      const int nrows = min(kChunk, tri_blk - c0);
      __syncthreads();  // the previous chunk is consumed
      if (tid < nrows) {
        const int r = c0 + tid;
        row_addr[tid] = (long long)toffs[sb * kpb + r / rps] + r % rps;
      }
      __syncthreads();
      for (int e = tid; e < nrows * nl; e += kTile) {
        const int r = e / nl, l = e - r * nl;
        rows[r * nl + l] = gtab[(size_t)row_addr[r] * 128 + l];
      }
      __syncthreads();
      for (int r = 0; r < nrows; ++r) {
        const float* g = rows + r * nl;
        const int row = sb * tri_blk + c0 + r;
        const bool live = row < live_rows;
        float tt, uu, vv;
        mt_half(g, 0, f, live, tt, uu, vv);
        int pp = __float_as_int(g[pid_a]);
        if (pack == 2) {
          float tb, ub, vb;
          mt_half(g, 48, f, live, tb, ub, vb);
          if (tb < tt) {  // B wins only with a strictly smaller t
            tt = tb;
            uu = ub;
            vv = vb;
            pp = __float_as_int(g[97]);
          }
        }
        if (tt < best_t) {  // rows in order: the first minimum wins
          best_t = tt;
          best_i = row;
          best_u = uu;
          best_v = vv;
          best_p = pp;
        }
      }
    }
    if (!nxt) break;
  }
  t_out[ray] = best_t;
  i_out[ray] = best_i;
  u_out[ray] = best_u;
  v_out[ray] = best_v;
  p_out[ray] = best_p;
}

}  // namespace
}  // namespace tbvh

// offs (T, k_cap) i32, counts (T,) i32, lbg (T, nb) f32, tmax (T,) f32,
// ff (T, 12, 256) f32, t0 (T, 256) f32, gtab (rows, 128) f32
// -> t, u, v (T, 256) f32; idx, prim (T, 256) i32.
extern "C" int tbvh_mt_fused(const int* offs, const int* counts,
                             const float* lbg, const float* tmax,
                             const float* ff, const float* t0,
                             const float* gtab, float* t, int* idx, float* u,
                             float* v, int* prim, int T, int k_cap, int nb,
                             int tri_blk, int rps, int pack, int any_hit,
                             void* stream) {
  if (T <= 0 || nb <= 0 || (pack != 1 && pack != 2) || rps <= 0 ||
      rps > tri_blk || tri_blk % rps || k_cap % (tri_blk / rps))
    return (int)cudaErrorInvalidValue;
  tbvh::mt_fused_kernel<<<T, tbvh::kTile, 0, (cudaStream_t)stream>>>(
      offs, counts, lbg, tmax, ff, t0, gtab, t, idx, u, v, prim, k_cap, nb,
      tri_blk, rps, pack, any_hit);
  return (int)cudaGetLastError();
}
