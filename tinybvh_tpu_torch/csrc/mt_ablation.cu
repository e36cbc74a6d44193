// Kernel I: kernel B's tile loop in eight variants, each with one part
// taken out, to split B's time on this card by subtraction (see
// probes/mt_ablation.py, which holds the plain twin and the driver).
//
// Replaces the TPU kernel benchmarks/mt_ablation_probe.py::
// _ablation_kernel. Per tile of 256 rays it walks the tile's leaf keys in
// super-blocks of 128 rows (32 leaves of 4 rows). The next super-block
// runs only while sb + 1 < nsb and not lbg[min(sb + 1, nb - 1)] > the
// tile's max best t before sb (NaN passes). Per (row, ray): four 12-lane
// dots of lanes 0:48 of the row with f = [d, o x d, o, 1, 0, 0] in lane
// order (every multiply and add rounded on its own), the sign flip, the
// hit test and t = ts * (1 / ad); per super-block the first minimum over
// its rows (dead rows, past the tile's count, give kFar; a NaN t makes
// the minimum NaN), which replaces the ray's best only when strictly
// smaller. The variants:
//   full      the rows of each key's leaf, the key's low 18 bits clamped
//             to max_leaf_row;
//   seg8/32   the rows of 8 / 32 leaves from each group's first key,
//             clamped to max_leaf_row - (span - 1);
//   bigdma    rows 0:128 whatever the keys;
//   nodma     no copy in the loop: rows 0:128, staged once before it
//             (the TPU kernel's no-copy buffer is never written; here it
//             is defined, so nodma equals bigdma bit for bit);
//   mathonly  no copy, as nodma; best t = min(best t, min over rows of
//             det + u' + v' + t'), walking every row of every
//             super-block, best row 0;
//   bf16      no copy; rows 0:128 and f rounded to bf16 once, the four
//             dots on the tensor cores (mma.sync m16n8k16, rays as M,
//             rows as N, K = 12 padded to 16, f32 accumulation), then the
//             full epilogue. A probe only: the ray path stays IEEE fp32;
//   skeleton  no walk: t = tmax + d.x, i = count.
//
// What bounds it on this card: the fp32 issue rate, as for kernel B (96
// operations of dots and ~16 of epilogue per (row, ray), no FMA, so the
// floor of this design is about twice the bound), except skeleton (bytes)
// and bf16 (the epilogue in fp32). The design takes kernel B's loop
// (csrc/mt_fused.cu), so that subtraction splits a loop shaped like B's:
//  - two rays a thread, 128 threads a tile: each float4 broadcast of a row
//    feeds both rays (the same mt_dots / tri_terms as B, common.cuh);
//  - rows staged 32 at a time by 16-byte cp.async, single-buffered as in
//    B (sync, copy, wait, sync, compute): the copy terms of the split are
//    B's kind of copy;
//  - only live rows are staged and walked; a dead row could only give
//    kFar, which wins where the minimum of the live rows is above kFar,
//    at the first dead row (as B's mt_fused.cu "first dead row" rule);
//  - registers capped for 7 CTAs (28 warps) an SM: 1,600 equal tiles fill
//    924 slots and then 676 (6 CTAs would leave a third wave of 16
//    tiles; 8 would cap the registers at 64);
//  - every variant runs at those 7 CTAs an SM, in the same two waves: one
//    whose registers and shared memory would let more CTAs in (mathonly,
//    skeleton) is launched with unused dynamic shared memory that keeps
//    them out (pin_smem), so that a difference of two variants' times is
//    one of their loops, not of their residency;
//  - the staging buffer is static shared memory (6 KB for the copying
//    variants, 24 KB for the no-copy ones, 28 KB for bf16).
// Where it departs from B on purpose: the minimum over a super-block
// costs a miss nothing (B compares every pair's t with the ray's best):
// only a hit updates it, one branch a row for both rays, and the first
// miss, which stands for all misses and dead rows (they give kFar), is
// the count of leading hit rows. So its epilogue term is a lower bound
// of B's. I also walks 4-row leaves of one triangle a row, skips no zero
// triangle (B's ballot) and needs no tile order (its tiles are equal);
// mathonly still computes every row.
#include "common.cuh"

#include <cstdint>

namespace tbvh {
namespace {

constexpr int kBlk = 128;                 // rows per super-block (TRI_BLK)
constexpr int kLpb = kBlk / 4;            // leaf keys per super-block
constexpr int kChunk = 32;                // rows per staged chunk
constexpr int kRowV = 12;                 // float4 per staged row (lanes 0:48)
constexpr int kLeafMask = (1 << 18) - 1;  // packet2 _LEAF_BITS
constexpr int kRays = 2;                  // rays per thread
constexpr int kThreads = kTile / kRays;   // threads per tile
constexpr int kWarps = kThreads / 32;
constexpr int kMinCtas = 7;               // resident CTAs an SM
// bf16: a staged row holds, per dot, its six bf16 pairs (lanes 2p, 2p + 1)
// and two zero words (K = 12 padded to 16), at a stride of 36 words (the
// fragment loads of 8 rows x 4 pairs then hit 32 banks); a ray's packed
// features likewise, at 8 words
constexpr int kBfRow = 36;
constexpr int kBfRay = 8;

enum Variant {
  kFull = 0, kSeg8, kSeg32, kBigDma, kNoDma, kMathOnly, kBf16, kSkeleton,
  kVariants
};

__host__ __device__ constexpr bool copies(int v) { return v <= kBigDma; }

// The staging buffer's float4 (static shared memory, at most 28 KB): a
// 32-row chunk for the copying variants, rows 0:128 for nodma and
// mathonly; bf16 its packed rows and features and each ray's (min, row)
// of a super-block.
__host__ __device__ constexpr int smem_f4(int v) {
  return v == kSkeleton ? 1
         : copies(v)    ? kChunk * kRowV
         : v == kBf16   ? (kBlk * kBfRow + kTile * kBfRay) / 4 + kTile / 2
                        : kBlk * kRowV;
}

// The gtab_pad row that row r of super-block sb stages.
template <int V>
__device__ __forceinline__ int src_row(const int* tkeys, int sb, int r,
                                       int max_leaf_row) {
  if (V == kFull) {
    const int leaf = min(tkeys[sb * kLpb + (r >> 2)] & kLeafMask,
                         max_leaf_row);
    return leaf * 4 + (r & 3);
  } else if (V == kSeg8 || V == kSeg32) {
    constexpr int span = V == kSeg8 ? 8 : 32;
    const int grp = r / (4 * span);
    const int leaf = min(tkeys[sb * kLpb + grp * span] & kLeafMask,
                         max_leaf_row - (span - 1));
    return leaf * 4 + r - grp * 4 * span;
  }
  return r;
}

// cp.async of lanes 0:48 of rows c0 .. c0 + nrows of super-block sb.
template <int V>
__device__ __forceinline__ void stage(float4* buf, const float4* gtab4,
                                      const int* tkeys, int sb, int c0,
                                      int nrows, int max_leaf_row) {
  for (int e = threadIdx.x; e < nrows * kRowV; e += kThreads) {
    const int r = e / kRowV;
    const long long row = src_row<V>(tkeys, sb, c0 + r, max_leaf_row);
    cp_async16(buf + e, gtab4 + row * 32 + (e - r * kRowV));
  }
}

// (t, row) of two candidates: the smaller t, the lower row on a tie.
__device__ __forceinline__ void take_min(float& m, int& am, float m2,
                                         int am2) {
  if (m2 < m || (m2 == m && am2 < am)) {
    m = m2;
    am = am2;
  }
}

// One ray's running first minimum (m, am) over a super-block's rows, in
// order, with row `row`'s terms s, where a hit gives ts / ad and a miss
// (or a dead row, !live) kFar; a NaN t sets `nan` (the super-block's
// minimum is then NaN).
__device__ __forceinline__ void consider(const SignedTerms& s, bool live,
                                         int row, float& m, int& am,
                                         bool& nan) {
  float tt = kFar;
  if (s.hit && live) {
    tt = __fmul_rn(s.ts, __fdiv_rn(1.f, s.ad));
    nan |= tt != tt;
  }
  if (tt < m) {
    m = tt;
    am = row;
  }
}

// The same minimum over the hits alone: a miss costs nothing here. Every
// miss gives kFar, so the first one stands for all; while every row so
// far has hit, `run` counts them, and at the end of the walk row `run`
// (a miss, or the first dead row) gives kFar (see kfar_rows).
__device__ __forceinline__ void consider_hit(const SignedTerms& s, int row,
                                             float& m, int& am, int& run,
                                             bool& nan) {
  if (s.hit) {
    const float tt = __fmul_rn(s.ts, __fdiv_rn(1.f, s.ad));
    nan |= tt != tt;
    if (tt < m) {
      m = tt;
      am = row;
    }
    if (row == run) ++run;
  }
}

// consider_hit's minimum joined with the rows that gave kFar, the first
// of which is row `run` where there is one (run < kBlk: a miss, or the
// rows past `live`, which were not walked).
__device__ __forceinline__ void kfar_rows(int run, float& m, int& am) {
  if (run < kBlk && (kFar < m || (kFar == m && run < am))) {
    m = kFar;
    am = run;
  }
}

// bf16: the tile's rows 0:128 and features, rounded to bf16 and packed for
// the mma fragments (see kBfRow), written once before the walk.
__device__ __forceinline__ void pack_bf16(unsigned* rows_bf,
                                          unsigned* feat_bf,
                                          const float* gtab,
                                          const float (&f)[kRays][12]) {
  for (int e = threadIdx.x; e < kBlk * 4 * kBfRay; e += kThreads) {
    const int r = e / (4 * kBfRay), k = e % (4 * kBfRay);
    const int q = k / kBfRay, p = k % kBfRay;
    const float* src = gtab + (size_t)r * 128 + q * 12 + 2 * p;
    rows_bf[r * kBfRow + k] =
        p < 6 ? pack_bf16x2(bf16_bits(src[0]), bf16_bits(src[1])) : 0u;
  }
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    unsigned* dst = feat_bf + (threadIdx.x + q * kThreads) * kBfRay;
#pragma unroll
    for (int p = 0; p < kBfRay; ++p)
      dst[p] = p < 6 ? pack_bf16x2(bf16_bits(f[q][2 * p]),
                                   bf16_bits(f[q][2 * p + 1]))
                     : 0u;
  }
}

// bf16: the first minimum (t, row) over rows 0 .. live of the staged rows
// of each of the warp's 64 rays (rays warp * 64 + 16 mt + g, + 8), by the
// tensor cores; a NaN t gives NaN. Written to res_m / res_i by ray.
__device__ __forceinline__ void bf16_block(const unsigned* rows_bf,
                                           const unsigned* feat_bf,
                                           int live, float* res_m,
                                           int* res_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int ntiles = (live + 7) / 8;
#pragma unroll 1
  for (int mt = 0; mt < 4; ++mt) {
    const int ray0 = warp * 64 + mt * 16 + g;
    const unsigned* f0 = feat_bf + ray0 * kBfRay;
    const unsigned* f1 = f0 + 8 * kBfRay;
    const unsigned a[4] = {f0[c], f1[c], f0[c + 4], f1[c + 4]};
    float m[2] = {__int_as_float(0x7f800000), __int_as_float(0x7f800000)};
    int am[2] = {0, 0};
    bool nan[2] = {false, false};
#pragma unroll 1
    for (int nt = 0; nt < ntiles; ++nt) {
      const unsigned* b_row = rows_bf + (nt * 8 + g) * kBfRow;
      float acc[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned b[2] = {b_row[q * kBfRay + c],
                               b_row[q * kBfRay + c + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
        mma_bf16_m16n8k16(acc[q], a, b);
      }
      // element e: ray g (+ 8 for e >= 2), row nt * 8 + 2c + (e & 1)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sg = acc[0][e] >= 0.f ? 1.f : -1.f;
        SignedTerms s;
        s.ad = __fmul_rn(acc[0][e], sg);
        s.us = __fmul_rn(acc[1][e], sg);
        s.vs = __fmul_rn(acc[2][e], sg);
        s.ts = __fmul_rn(acc[3][e], sg);
        s.hit = s.us >= 0.f && s.vs >= 0.f &&
                __fadd_rn(s.us, s.vs) <= s.ad && s.ts > 0.f && s.ad > 0.f;
        const int row = nt * 8 + 2 * c + (e & 1);
        consider(s, row < live, row, m[e >> 1], am[e >> 1], nan[e >> 1]);
      }
    }
    // across the 4 lanes of a quad, then one lane writes
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        take_min(m[j], am[j], __shfl_xor_sync(0xffffffffu, m[j], off),
                 __shfl_xor_sync(0xffffffffu, am[j], off));
        nan[j] = __shfl_xor_sync(0xffffffffu, (int)nan[j], off) || nan[j];
      }
      if (c == 0) {
        res_m[ray0 + 8 * j] = nan[j] ? __int_as_float(0x7fffffff) : m[j];
        res_i[ray0 + 8 * j] = am[j];
      }
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads, kMinCtas)
ablation_kernel(const int* __restrict__ keys, const int* __restrict__ counts,
                const float* __restrict__ lbg, const float* __restrict__ tmax,
                const float* __restrict__ o_t, const float* __restrict__ d_t,
                const float* __restrict__ gtab, float* __restrict__ t_out,
                int* __restrict__ i_out, int k_cap, int nb,
                int max_leaf_row) {
  __shared__ float4 smem[smem_f4(V)];
  __shared__ float red[2][kWarps];
  const int tile = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int count = min(counts[tile], k_cap);
  const int nsb = (count + kLpb - 1) / kLpb;
  const float tm = tmax[tile];
  float f[kRays][12];
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    const float* o = o_t + (size_t)tile * 3 * kTile + tid + q * kThreads;
    const float* d = d_t + (size_t)tile * 3 * kTile + tid + q * kThreads;
    const float ox = o[0], oy = o[kTile], oz = o[2 * kTile];
    const float dx = d[0], dy = d[kTile], dz = d[2 * kTile];
    const float fq[12] = {dx, dy, dz,
                          __fsub_rn(__fmul_rn(oy, dz), __fmul_rn(oz, dy)),
                          __fsub_rn(__fmul_rn(oz, dx), __fmul_rn(ox, dz)),
                          __fsub_rn(__fmul_rn(ox, dy), __fmul_rn(oy, dx)),
                          ox, oy, oz, 1.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 12; ++k) f[q][k] = fq[k];
  }
  if (V == kSkeleton) {
#pragma unroll
    for (int q = 0; q < kRays; ++q) {
      const size_t ray = (size_t)tile * kTile + tid + q * kThreads;
      t_out[ray] = __fadd_rn(__fadd_rn(0.f, tm), f[q][0]);
      i_out[ray] = count;
    }
    return;
  }
  float best_t[kRays] = {tm, tm};
  int best_i[kRays] = {0, 0};
  const int* tkeys = keys + (size_t)tile * k_cap;
  const float4* gtab4 = reinterpret_cast<const float4*>(gtab);
  unsigned* rows_bf = reinterpret_cast<unsigned*>(smem);
  unsigned* feat_bf = rows_bf + kBlk * kBfRow;
  float* res_m = reinterpret_cast<float*>(feat_bf + kTile * kBfRay);
  int* res_i = reinterpret_cast<int*>(res_m + kTile);

  // the no-copy buffer: rows 0:128, staged once (bf16: rounded and packed)
  if (nsb > 0) {
    if (V == kNoDma || V == kMathOnly) {
      stage<kBigDma>(smem, gtab4, tkeys, 0, 0, kBlk, max_leaf_row);
      cp_async_wait_all();
    } else if (V == kBf16) {
      pack_bf16(rows_bf, feat_bf, gtab, f);
    }
  }
  for (int sb = 0; sb < nsb; ++sb) {
    // the CTA max of best t before this super-block (mathonly: no gate)
    float gate_n = 0.f;
    if (V != kMathOnly) {
      gate_n = lbg[(size_t)tile * nb + min(sb + 1, nb - 1)];
      const float m = warp_nan_max(nan_max(best_t[0], best_t[1]));
      if (lane == 0) red[sb & 1][tid >> 5] = m;
    }
    // rows past the tile's count (in its last super-block) are dead
    const int live = V == kMathOnly || sb < nsb - 1 ? kBlk
                                                    : count * 4 - sb * kBlk;
    bool nxt = sb + 1 < nsb;
    float m[kRays];
    int am[kRays] = {0, 0}, run[kRays] = {0, 0};
    bool nan[kRays] = {false, false};
#pragma unroll
    for (int q = 0; q < kRays; ++q) m[q] = __int_as_float(0x7f800000);
    if (V == kBf16) {
      __syncthreads();  // the packed rows and the CTA max are visible
      float t_far = red[sb & 1][0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) t_far = nan_max(t_far, red[sb & 1][w]);
      nxt = nxt && !(gate_n > t_far);
      bf16_block(rows_bf, feat_bf, live, res_m, res_i);
      __syncthreads();  // every ray's (min, row) is written
#pragma unroll
      for (int q = 0; q < kRays; ++q) {
        m[q] = res_m[tid + q * kThreads];
        am[q] = res_i[tid + q * kThreads];
      }
    } else {
      for (int c0 = 0; c0 < live; c0 += kChunk) {
        const int nrows = min(kChunk, live - c0);
        if (copies(V)) {
          __syncthreads();  // the previous chunk is consumed
          stage<V>(smem, gtab4, tkeys, sb, c0, nrows, max_leaf_row);
          cp_async_wait_all();
          __syncthreads();  // this chunk (and the CTA max) is visible
        } else if (c0 == 0) {
          __syncthreads();  // the CTA max (and the no-copy rows) visible
        }
        if (V != kMathOnly && c0 == 0) {
          float t_far = red[sb & 1][0];
#pragma unroll
          for (int w = 1; w < kWarps; ++w)
            t_far = nan_max(t_far, red[sb & 1][w]);
          nxt = nxt && !(gate_n > t_far);
        }
        const float4* rows = copies(V) ? smem : smem + c0 * kRowV;
        for (int r = 0; r < nrows; ++r) {
          const float4* g = rows + r * kRowV;
          const int row = c0 + r;
          if (V == kMathOnly) {
            float acc[kRays][4];
            mt_dots<kRays>(g, f, acc);
#pragma unroll
            for (int q = 0; q < kRays; ++q) {
              const float s = __fadd_rn(
                  __fadd_rn(__fadd_rn(acc[q][0], acc[q][1]), acc[q][2]),
                  acc[q][3]);
              m[q] = row == 0 ? s : nan_min(m[q], s);
            }
          } else {
            SignedTerms s[kRays];
            tri_terms<kRays>(g, f, s);
            if (s[0].hit || s[1].hit) {  // one branch a row, rarely taken
#pragma unroll
              for (int q = 0; q < kRays; ++q)
                consider_hit(s[q], row, m[q], am[q], run[q], nan[q]);
            }
          }
        }
      }
    }
    if (V == kMathOnly) {
#pragma unroll
      for (int q = 0; q < kRays; ++q) best_t[q] = nan_min(best_t[q], m[q]);
    } else {
#pragma unroll
      for (int q = 0; q < kRays; ++q) {
        if (V != kBf16) {
          kfar_rows(run[q], m[q], am[q]);
        } else if (live < kBlk && m[q] > kFar) {
          // the dead rows past the last n-tile: the first gives kFar
          m[q] = kFar;
          am[q] = live;
        }
        if (!nan[q] && m[q] < best_t[q]) {
          best_t[q] = m[q];
          best_i[q] = sb * kBlk + am[q];
        }
      }
    }
    if (!nxt) break;
  }
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    const size_t ray = (size_t)tile * kTile + tid + q * kThreads;
    t_out[ray] = best_t[q];
    i_out[ray] = best_i[q];
  }
}

template <int V>
const void* kernel_of() {
  return reinterpret_cast<const void*>(&ablation_kernel<V>);
}

const void* kernel_for(int v) {
  switch (v) {
    case kFull: return kernel_of<kFull>();
    case kSeg8: return kernel_of<kSeg8>();
    case kSeg32: return kernel_of<kSeg32>();
    case kBigDma: return kernel_of<kBigDma>();
    case kNoDma: return kernel_of<kNoDma>();
    case kMathOnly: return kernel_of<kMathOnly>();
    case kBf16: return kernel_of<kBf16>();
    case kSkeleton: return kernel_of<kSkeleton>();
    default: return nullptr;
  }
}

// The dynamic shared memory (never used) with which kernel `fn` runs at
// most kMinCtas CTAs an SM: 0 where its registers or static shared memory
// already hold it there, else the least multiple of 256 bytes that does,
// with the shared memory carveout at its maximum so that the count does
// not depend on the driver's choice of it. -1 on an error.
int pin_smem(const void* fn) {
  int ctas = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, kThreads, 0)
      != cudaSuccess)
    return -1;
  if (ctas <= kMinCtas) return 0;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared) != cudaSuccess)
    return -1;
  for (int dyn = 256; dyn <= 48 * 1024; dyn += 256) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, kThreads,
                                                      dyn) != cudaSuccess)
      return -1;
    if (ctas <= kMinCtas) return dyn;
  }
  return -1;
}

// pin_smem of each variant, found once (-2: not yet).
int pinned_smem(int v) {
  static int pinned[kVariants] = {-2, -2, -2, -2, -2, -2, -2, -2};
  if (pinned[v] == -2) pinned[v] = pin_smem(kernel_for(v));
  return pinned[v];
}

}  // namespace
}  // namespace tbvh

// keys (T, k_cap) i32, counts (T,) i32, lbg (T, nb) f32, tmax (T,) f32,
// o_t, d_t (T, 3, 256) f32, gtab (rows, 128) f32, 16-byte aligned, rows
// >= 128 -> t (T, 256) f32, i (T, 256) i32; variant: 0 full, 1 seg8, 2
// seg32, 3 bigdma, 4 nodma, 5 mathonly, 6 bf16, 7 skeleton.
extern "C" int tbvh_mt_ablation(const int* keys, const int* counts,
                                const float* lbg, const float* tmax,
                                const float* o_t, const float* d_t,
                                const float* gtab, float* t, int* idx, int T,
                                int k_cap, int nb, int rows, int variant,
                                void* stream) {
  if (T <= 0 || nb <= 0 || k_cap <= 0 || k_cap % tbvh::kLpb ||
      rows < tbvh::kBlk || variant < 0 || variant >= tbvh::kVariants ||
      reinterpret_cast<std::uintptr_t>(gtab) % 16)
    return (int)cudaErrorInvalidValue;
  const int max_leaf_row = rows / 4 - 1;
  const int dyn = tbvh::pinned_smem(variant);
  if (dyn < 0) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {&keys, &counts, &lbg,  &tmax,  &o_t, &d_t,
                  &gtab, &t,      &idx,  &k_cap, &nb,  (void*)&max_leaf_row};
  const cudaError_t err = cudaLaunchKernel(
      tbvh::kernel_for(variant), dim3(T), dim3(tbvh::kThreads), args,
      (size_t)dyn, (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return (int)(err != cudaSuccess ? err : last);
}

// Kernel I's resources for `variant` as it is launched, with the dynamic
// shared memory that pins it to 7 CTAs an SM (see common.cuh
// kernel_occupancy).
extern "C" int tbvh_mt_ablation_occupancy(int variant, int* out) {
  if (variant < 0 || variant >= tbvh::kVariants)
    return (int)cudaErrorInvalidValue;
  const int dyn = tbvh::pinned_smem(variant);
  if (dyn < 0) return (int)cudaErrorInvalidConfiguration;
  return tbvh::kernel_occupancy(tbvh::kernel_for(variant), tbvh::kThreads,
                                dyn, out);
}
