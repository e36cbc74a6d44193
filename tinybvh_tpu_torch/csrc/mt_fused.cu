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
// What bounds it on this card: the fp32 issue rate. A test is four
// 12-lane dots (48 multiplies, 48 adds) plus ~15 instructions of sign
// flip and hit test; the row it reads (48 lanes) is shared by all 256
// rays. Every multiply and add is rounded on its own (__fmul_rn /
// __fadd_rn, no FMA) so that the results equal the plain PyTorch twin's
// bit for bit; that halves the fp32 rate the bound assumes, so the floor
// of this design is about twice the bound. K = 12 is far below what wgmma
// is for, and the ray path stays IEEE fp32: no tensor cores.
//
// What the design does about it:
//  - rows are staged 32 at a time at a padded stride (100 lanes for pack
//    = 2: [A 0:48 | B 48:96 | pidA | pidB | 2 pad]; 52 for pack = 1) in a
//    16-byte aligned buffer by 16-byte cp.async, and each 12-lane group is
//    read as three float4 broadcasts: 12 shared loads per triangle, not 48;
//  - two rays a thread (128 threads a tile), so each float4 read feeds
//    both, with registers capped so that 24 warps stay resident per SM (as
//    many as one ray a thread leaves). A ray keeps only its best t and
//    winner (row, triangle) in registers; the IEEE division runs only
//    where a pair hits (a miss gives kFar, which never wins), and u, v and
//    the prim id are computed once per ray at the end, from the winner's
//    row in device memory, with the same arithmetic;
//  - what can only give kFar is skipped: rows past the live rows of the
//    last super-block, and all-zero triangles (padding leaves and the
//    dead-key sentinel, ~30% of the tests at the API's shapes), flagged
//    per 32-row chunk by one warp ballot. kFar wins only over a best t
//    above kFar: zero triangles are skipped only in super-blocks whose CTA
//    max before the block is <= kFar, and a ray whose best t is still
//    above kFar at the end takes the first dead row, exactly as the full
//    walk does;
//  - tiles differ in length (1 to k_cap / kpb super-blocks), and CTAs
//    start in blockIdx order, so a long tile left for the last wave would
//    run alone. A one-CTA pre-pass (common.cuh tile_order) counting-sorts
//    the tiles by super-block count, longest first, once per launch, and
//    CTA r runs the r-th tile of that order.
// The gate of the next super-block is compared with the CTA-wide max of
// best t taken before the current block (NaN propagates, so a NaN gate
// passes), exactly as on the TPU. Rows are walked in order and only a
// strictly smaller t replaces the best, so the first minimum wins.
//
// Opacity micromaps (omap_s = S > 0; the TPU kernel's omap_s mode,
// packet2.py:1044-1058) are a second instantiation (OMAP = true), so the
// main path's kernel is unchanged. Each triangle's S x S cell bits ride
// in its row, 16 to an f32 word (pack 2: words of A from lane 98, of B
// from 98 + nw; pack 1: from lane 48, the prim id after them). A pair
// that hits geometrically takes u and v from the one division the hit
// already needs, and hits only if the bit of its cell (floor(u S),
// floor(v S)), clamped to the grid, is set; a transparent hit gives kFar,
// as a miss. A zero triangle never hits, so skipping it stays exact
// whatever its words hold. What bounds this mode is the main loop's work
// (it runs at B's rate per test) plus the tests that transparent cells
// let through the gates. S is a launch argument, so the design keeps
// what depends on it out of the loop:
//  - rows are staged up to their last word (omap_vec float4: 27 for S =
//    8, pack 2; 17 for S = 16, pack 1) at a constant stride of 33 float4,
//    a warp a row and a lane a float4, each row's table address found
//    once by one lane (no division by a runtime stride, and every row
//    address a constant multiple);
//  - the cell's bit is read, after the dots, only for a pair whose t
//    would replace the ray's best (or whose kFar would: a best above
//    kFar), so ~1% of the tests read a word and the rest run B's loop.
#include "common.cuh"

#include <cstdint>

namespace tbvh {
namespace {

constexpr int kChunk = 32;               // rows per chunk: one lane per row
constexpr int kRays = 2;                 // rays per thread
constexpr int kThreads = kTile / kRays;  // threads per tile
constexpr int kWarps = kThreads / 32;
constexpr int kMinCtas = 24 * 32 / kThreads;  // 24 resident warps a SM

// Words per triangle of an S x S micromap, and the float4 a staged row
// needs to reach the last of them.
__host__ __device__ constexpr int omap_words(int s) {
  return (s * s + 15) / 16;
}
__host__ __device__ constexpr int omap_vec(int pack, int s) {
  return pack == 2 ? (98 + 2 * omap_words(s) + 3) / 4
                   : (49 + omap_words(s) + 3) / 4;
}

template <int PACK, bool OMAP>
struct RowLayout {
  // float4 staged per row without micromaps: [A 0:48 | B 48:96 | pidA |
  // pidB | 2 pad] (100 floats) for pack = 2, 52 floats for pack = 1
  static constexpr int kCopy = PACK == 2 ? 25 : 13;
  // float4 from one staged row to the next; with micromaps 33, which
  // holds any row's omap_vec float4 and is odd, so that the zero test's
  // one-lane-per-row float4 reads fall in 8 distinct bank groups
  static constexpr int kVec = OMAP ? 33 : kCopy;
  static constexpr int kPidA = PACK == 2 ? 96 : 48;     // without words
  static constexpr int kPidB = 97;
};

// The best hit of one ray: its t and the winner, 2 x row + (1 for
// triangle B), or -1. u, v and the prim id are read back from the
// winner's row once, at the end.
struct Best {
  float t;
  int w;
};

// The micromap bit of a pair that hits geometrically: u = u' / det and
// v = v' / det (as the winner's are computed), the cell (floor(u S),
// floor(v S)) clamped to [0, S - 1], its bit b = iu S + iv in word b >> 4
// (≙ packet2.py:1049-1058; twin: packet2.py _omap_opaque).
__device__ __forceinline__ bool omap_opaque(const SignedTerms& s, float inv,
                                            const float* words, int omap_s) {
  const float sf = (float)omap_s;
  const int iu = min(max(__float2int_rz(__fmul_rn(__fmul_rn(s.us, inv), sf)),
                         0), omap_s - 1);
  const int iv = min(max(__float2int_rz(__fmul_rn(__fmul_rn(s.vs, inv), sf)),
                         0), omap_s - 1);
  const int bit = iu * omap_s + iv;
  return (__float2int_rz(words[bit >> 4]) >> (bit & 15)) & 1;
}

// The triangle `tri` (0: A, 1: B) of row `row` (its 48 lanes at g; with
// OMAP its micromap words at `words`) against the thread's rays: where
// its t is strictly below a ray's best (rows in order: the first minimum
// wins), it becomes the best.
template <bool OMAP>
__device__ __forceinline__ void consider(const float4* g, const float* words,
                                         int omap_s,
                                         const float (&f)[kRays][12],
                                         int row, int tri,
                                         Best (&b)[kRays]) {
  SignedTerms s[kRays];
  tri_terms<kRays>(g, f, s);
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    float tt = kFar;  // a miss; it still wins over a best t above kFar
    if (s[q].hit) {
      const float inv = __fdiv_rn(1.f, s[q].ad);
      tt = __fmul_rn(s[q].ts, inv);
      // a transparent hit gives kFar, as a miss: the cell's bit is read
      // only where the hit's t or kFar would replace the ray's best
      if (OMAP && (tt < b[q].t || kFar < b[q].t) &&
          !omap_opaque(s[q], inv, words, omap_s))
        tt = kFar;
    }
    if (tt < b[q].t) b[q] = Best{tt, 2 * row + tri};
  }
}

template <int PACK, bool OMAP>
__global__ void __launch_bounds__(kThreads, kMinCtas)
mt_fused_kernel(const int* __restrict__ order,
                const int* __restrict__ offs, const int* __restrict__ counts,
                const float* __restrict__ lbg, const float* __restrict__ tmax,
                const float* __restrict__ ff, const float* __restrict__ t0,
                const float* __restrict__ gtab, float* __restrict__ t_out,
                int* __restrict__ i_out, float* __restrict__ u_out,
                float* __restrict__ v_out, int* __restrict__ p_out, int k_cap,
                int nb, int tri_blk, int rps, int any_hit, int omap_s) {
  using L = RowLayout<PACK, OMAP>;
  __shared__ float4 rows[kChunk * L::kVec];
  // float4 copied per row; micromap word lanes of A and B; prim id lanes
  const int n_copy = OMAP ? omap_vec(PACK, omap_s) : L::kCopy;
  const int nw = OMAP ? omap_words(omap_s) : 0;
  const int wcol_a = PACK == 2 ? 98 : 48, wcol_b = 98 + nw;
  const int pid_a = PACK == 2 ? L::kPidA : 48 + nw;
  __shared__ float red[2][kWarps];
  const int tile = order[blockIdx.x];
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  float f[kRays][12];
  Best b[kRays];
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    const size_t ray = (size_t)tile * kTile + tid + q * kThreads;
#pragma unroll
    for (int k = 0; k < 12; ++k)
      f[q][k] = ff[((size_t)tile * 12 + k) * kTile + tid + q * kThreads];
    b[q] = Best{t0[ray], -1};
  }

  const int count = min(counts[tile], k_cap);
  const int kpb = tri_blk / rps;
  const int nsb = (count + kpb - 1) / kpb;
  const int live_rows = count * rps;
  const float cutoff = tmax[tile];
  const int* toffs = offs + (size_t)tile * k_cap;
  const float4* gtab4 = reinterpret_cast<const float4*>(gtab);

  int sb = 0;
  while (sb < nsb) {
    // the CTA max of best t before this super-block
    const float gate_n = lbg[(size_t)tile * nb + min(sb + 1, nb - 1)];
    float m = b[0].t;
#pragma unroll
    for (int q = 1; q < kRays; ++q) m = nan_max(m, b[q].t);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) red[sb & 1][tid >> 5] = m;
    // rows past the live rows of the last super-block can only give kFar
    const int sb_rows = sb == nsb - 1 ? live_rows - sb * tri_blk : tri_blk;
    bool nxt = false, skip_zero = false;
    for (int c0 = 0; c0 < sb_rows; c0 += kChunk) {
      const int nrows = min(kChunk, sb_rows - c0);
      __syncthreads();  // the previous chunk is consumed
      if (OMAP) {
        // lane r finds the table row of the chunk's row r once; warp w
        // then copies rows w, w + kWarps, ..., one float4 a lane
        int src = 0;
        if (lane < nrows) {
          const int row = sb * tri_blk + c0 + lane;
          const int key = row / rps;
          src = toffs[key] + (row - key * rps);
        }
        for (int r = tid >> 5; r < nrows; r += kWarps) {
          const long long g = __shfl_sync(0xffffffffu, src, r);
          if (lane < n_copy)
            cp_async16(rows + r * L::kVec + lane, gtab4 + g * 32 + lane);
        }
      } else {
        for (int e = tid; e < nrows * L::kCopy; e += kThreads) {
          const int r = e / L::kCopy;
          const int row = sb * tri_blk + c0 + r;
          const int key = row / rps;
          const long long g = (long long)toffs[key] + (row - key * rps);
          cp_async16(rows + e, gtab4 + g * 32 + (e - r * L::kCopy));
        }
      }
      cp_async_wait_all();
      __syncthreads();  // this chunk (and the CTA max) is visible
      if (c0 == 0) {
        float t_far = red[sb & 1][0];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) t_far = nan_max(t_far, red[sb & 1][w]);
        nxt = (sb + 1 < nsb) && !(gate_n > t_far);
        if (any_hit) nxt = nxt && (t_far >= cutoff);
        // kFar (all a zero triangle can give) cannot beat a best t <= kFar
        skip_zero = t_far <= kFar;
      }
      // all-zero triangles of this chunk, one lane per row
      unsigned zero_a = 0u, zero_b = 0u;
      if (skip_zero) {
        bool za = lane < nrows, zb = za;
        if (lane < nrows) {
          const float4* g = rows + lane * L::kVec;
#pragma unroll
          for (int v = 0; v < 12; ++v) {
            const float4 w = g[v];
            za = za && w.x == 0.f && w.y == 0.f && w.z == 0.f && w.w == 0.f;
          }
          if (PACK == 2) {
#pragma unroll
            for (int v = 12; v < 24; ++v) {
              const float4 w = g[v];
              zb = zb && w.x == 0.f && w.y == 0.f && w.z == 0.f &&
                   w.w == 0.f;
            }
          }
        }
        zero_a = __ballot_sync(0xffffffffu, za);
        zero_b = PACK == 2 ? __ballot_sync(0xffffffffu, zb) : 0u;
      }
      for (int r = 0; r < nrows; ++r) {
        const float4* g = rows + r * L::kVec;
        const float* gf = reinterpret_cast<const float*>(g);
        const int row = sb * tri_blk + c0 + r;
        // A, then B against the running best: B replaces A only with a
        // strictly smaller t, as min(A, B) and then the best would
        if (!((zero_a >> r) & 1u))
          consider<OMAP>(g, gf + wcol_a, omap_s, f, row, 0, b);
        if (PACK == 2 && !((zero_b >> r) & 1u))
          consider<OMAP>(g + 12, gf + wcol_b, omap_s, f, row, 1, b);
      }
    }
    if (!nxt) break;
    ++sb;
  }
  // The rows past live_rows in the last super-block were not walked: a
  // dead row gives kFar, and the first one wins where best t > kFar.
  if (nsb > 0 && sb == nsb - 1 && live_rows < nsb * tri_blk) {
#pragma unroll
    for (int q = 0; q < kRays; ++q)
      if (b[q].t > kFar) b[q] = Best{kFar, 2 * live_rows};
  }
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    const size_t ray = (size_t)tile * kTile + tid + q * kThreads;
    float u = 0.f, v = 0.f;
    int row = 0, prim = -1;
    if (b[q].w >= 0) {
      // the winner's signed terms again, from its row in device memory
      row = b[q].w >> 1;
      const int tri = b[q].w & 1, key = row / rps;
      const float4* g =
          gtab4 + ((long long)toffs[key] + row - key * rps) * 32;
      float fq[1][12];
#pragma unroll
      for (int k = 0; k < 12; ++k) fq[0][k] = f[q][k];
      SignedTerms s[1];
      tri_terms<1>(g + 12 * tri, fq, s);
      const float inv = __fdiv_rn(1.f, s[0].ad > 0.f ? s[0].ad : 1.f);
      u = __fmul_rn(s[0].us, inv);
      v = __fmul_rn(s[0].vs, inv);
      prim = __float_as_int(reinterpret_cast<const float*>(
          g)[tri ? L::kPidB : pid_a]);
    }
    t_out[ray] = b[q].t;
    i_out[ray] = row;
    u_out[ray] = u;
    v_out[ray] = v;
    p_out[ray] = prim;
  }
}

const void* kernel_for(int pack, bool omap) {
  if (omap)
    return pack == 2 ? reinterpret_cast<const void*>(&mt_fused_kernel<2, true>)
                     : reinterpret_cast<const void*>(&mt_fused_kernel<1, true>);
  return pack == 2 ? reinterpret_cast<const void*>(&mt_fused_kernel<2, false>)
                   : reinterpret_cast<const void*>(&mt_fused_kernel<1, false>);
}

}  // namespace
}  // namespace tbvh

// offs (T, k_cap) i32, counts (T,) i32, lbg (T, nb) f32, tmax (T,) f32,
// ff (T, 12, 256) f32, t0 (T, 256) f32, gtab (rows, 128) f32, 16-byte
// aligned -> t, u, v (T, 256) f32; idx, prim (T, 256) i32. omap_s > 0:
// the rows carry S x S micromaps (their words must fit the row). The
// tile order lives in T ints taken from the stream's memory pool for the
// launch.
extern "C" int tbvh_mt_fused(const int* offs, const int* counts,
                             const float* lbg, const float* tmax,
                             const float* ff, const float* t0,
                             const float* gtab, float* t, int* idx, float* u,
                             float* v, int* prim, int T, int k_cap, int nb,
                             int tri_blk, int rps, int pack, int any_hit,
                             int omap_s, void* stream) {
  if (T <= 0 || nb <= 0 || (pack != 1 && pack != 2) || rps <= 0 ||
      rps > tri_blk || tri_blk % rps || k_cap % (tri_blk / rps) ||
      reinterpret_cast<std::uintptr_t>(gtab) % 16 || omap_s < 0 ||
      omap_s > 64 || 4 * tbvh::omap_vec(pack, omap_s) > 128)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int* order = nullptr;
  cudaError_t err = cudaMallocAsync(&order, sizeof(int) * T, s);
  if (err != cudaSuccess) return (int)err;
  tbvh::tile_order<<<1, tbvh::kOrderThreads, 0, s>>>(counts, T, k_cap,
                                                     tri_blk / rps, order);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    void* args[] = {&order, &offs, &counts, &lbg, &tmax, &ff,
                    &t0,    &gtab, &t,      &idx, &u,    &v,
                    &prim,  &k_cap, &nb,    &tri_blk, &rps, &any_hit,
                    &omap_s};
    err = cudaLaunchKernel(tbvh::kernel_for(pack, omap_s > 0), dim3(T),
                           dim3(tbvh::kThreads), args, 0, s);
    const cudaError_t last = cudaGetLastError();  // clears a refused launch
    if (err == cudaSuccess) err = last;
  }
  const cudaError_t freed = cudaFreeAsync(order, s);
  return (int)(err != cudaSuccess ? err : freed);
}

// Kernel B's resources for `pack`, without and with micromaps (see
// common.cuh kernel_occupancy).
extern "C" int tbvh_mt_fused_occupancy(int pack, int* out) {
  if (pack != 1 && pack != 2) return (int)cudaErrorInvalidValue;
  return tbvh::kernel_occupancy(tbvh::kernel_for(pack, false),
                                tbvh::kThreads, 0, out);
}

extern "C" int tbvh_mt_fused_omap_occupancy(int pack, int* out) {
  if (pack != 1 && pack != 2) return (int)cudaErrorInvalidValue;
  return tbvh::kernel_occupancy(tbvh::kernel_for(pack, true),
                                tbvh::kThreads, 0, out);
}
