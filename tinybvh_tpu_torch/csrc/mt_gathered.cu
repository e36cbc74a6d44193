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
// What bounds it on this card: fp32 throughput. Each (row, ray) pair is
// four 12-lane dots, the sign flip, the hit test and a division, and a
// row (192 B) is shared by the tile's 256 rays. Every multiply and add is
// rounded on its own in the JAX order (no FMA), so that the kernel equals
// the plain PyTorch twin bit for bit; that halves the fp32 rate the bound
// assumes. K4 = 4 x max_leaves reaches 2048 rows (384 KB) a tile, so rows
// are streamed, not held; K = 12 is far below what wgmma is for, and the
// ray path stays IEEE fp32, so there are no tensor cores.
//
// What the design does about it (the design of kernel D, leaf_resolve.cu):
//  - rows that can only miss are not tested. A row misses every ray when
//    its det lanes (0-11) are all zero (det = +0, or NaN when a feature is
//    not finite: ad > 0 fails), or when a lane 10 or 11 of any of its four
//    parts is not finite (that part's product with f = 0 is NaN, and a NaN
//    det, u', v' or t' fails the hit test). Warp k checks part k of the
//    chunk's 32 rows, one lane a row, and ballots give the chunk's live
//    rows as one 32-bit mask; the math walks its set bits, in row order;
//  - two rays a thread (128 threads a tile, consecutive rays, so that a
//    warp's 64 rays are close in the image), so each of a row's 12 float4
//    broadcasts from shared memory feeds both;
//  - the dots of a live row drop the lanes whose ray feature is a
//    constant: lane 9 (f = 1) adds the row's value itself, and lanes 10
//    and 11 (f = 0, the row's value finite) add a signed zero. Rows of the
//    form build_packet_aux writes (G_det = [n, 0...], G_u and G_v zero
//    past lane 5, G_t zero outside lanes 6-9) skip their zero lanes too,
//    where every feature of the tile's rays is finite (then each skipped
//    product is a signed zero). Adding a signed zero changes a sum only
//    where the sum is zero, and then only the sign of that zero: det >= 0
//    and ad > 0 do not read it, nor do us >= 0, vs >= 0, us + vs <= ad and
//    ts > 0, and a hit's t = ts / ad has ts > 0. So no output bit moves;
//  - after det and u' (and again after v') the warp votes: where no ray of
//    the warp can still hit the row, the rest of it is not computed;
//  - the division runs only on the pairs that hit;
//  - the rows stream through a ring of four 32-row slots (6 KB each) by
//    16-byte cp.async, two chunks in flight while one is listed and
//    tested; the gate is checked at each 128-row block boundary, and
//    chunks copied past the point where the gate stops are never read;
//  - tiles run longest first (common.cuh tile_order) by the count of
//    leading blocks whose gate is <= the tile's tmax, an upper bound of the
//    blocks the tile walks (its max best t never exceeds tmax).
//
// The JAX reductions are kept exactly. Per 128-row block, the minimum of
// the rows' t (a miss gives kFar) with its first row, a NaN being the
// minimum (jnp.argmin); across blocks only a strictly smaller t replaces
// the best; the gate compares each block's entry gate with the CTA-wide
// NaN-propagating max of best t taken before the block. The kernel keeps
// per ray and block the minimum over its hits (NaN rule, first row), the
// first row that misses (a tested miss, or a skipped row: the first clear
// bit of the chunk masks), and combines them at the block's end: a kFar
// row is the minimum unless a hit is below kFar or NaN, and then its row
// is the first of the misses and of the hits at exactly kFar. That is row
// 0 of a block whose rays all miss, as in the twin, which matters when
// tmax > kFar; a hit past kFar (t = 1e31) is never the minimum of a block
// that also holds a miss. A single scan over the blocks is not equal: a
// NaN hides the real hits of its own block only.
#include <cfloat>

#include "common.cuh"

namespace tbvh {
namespace {

constexpr int kTriBlk = 128;              // rows per gate block (TRI_BLK)
constexpr int kRow = 48;                  // [G_det | G_u | G_v | G_t]
constexpr int kVec = kRow / 4;            // float4 per row
constexpr int kRays = 2;                  // rays per thread
constexpr int kThreads = kTile / kRays;   // threads per tile
constexpr int kSub = 32;                  // rows per ring slot: one ballot
constexpr int kSubs = kTriBlk / kSub;     // slots per gate block
constexpr int kStages = 4;                // ring slots (6 KB each)
constexpr int kMinCtas = 24 * 32 / kThreads;  // 24 resident warps a SM
constexpr int kNone = kTriBlk;            // "no such row" within a block

// Ten lanes (a, b, c = lanes 0-11) of a row part dotted with the ray
// features f[0..8], then lane 9's value (f = 1); lanes 10-11 (f = 0) are
// dropped. Lane order, each product and sum rounded on its own.
__device__ __forceinline__ float dot10(const float4& a, const float4& b,
                                       const float4& c,
                                       const float (&f)[9]) {
  float s = __fmul_rn(a.x, f[0]);
  s = __fadd_rn(s, __fmul_rn(a.y, f[1]));
  s = __fadd_rn(s, __fmul_rn(a.z, f[2]));
  s = __fadd_rn(s, __fmul_rn(a.w, f[3]));
  s = __fadd_rn(s, __fmul_rn(b.x, f[4]));
  s = __fadd_rn(s, __fmul_rn(b.y, f[5]));
  s = __fadd_rn(s, __fmul_rn(b.z, f[6]));
  s = __fadd_rn(s, __fmul_rn(b.w, f[7]));
  s = __fadd_rn(s, __fmul_rn(c.x, f[8]));
  return __fadd_rn(s, c.y);
}

// Lanes 0-5 of a row part (a, b) dotted with f (G_u and G_v of the
// build_packet_aux form).
__device__ __forceinline__ float dot6(const float4& a, const float4& b,
                                      const float (&f)[9]) {
  float s = __fmul_rn(a.x, f[0]);
  s = __fadd_rn(s, __fmul_rn(a.y, f[1]));
  s = __fadd_rn(s, __fmul_rn(a.z, f[2]));
  s = __fadd_rn(s, __fmul_rn(a.w, f[3]));
  s = __fadd_rn(s, __fmul_rn(b.x, f[4]));
  return __fadd_rn(s, __fmul_rn(b.y, f[5]));
}

__device__ __forceinline__ bool is_finite(float x) {
  return fabsf(x) <= FLT_MAX;
}

__device__ __forceinline__ bool zero4(const float4& v) {
  return v.x == 0.f && v.y == 0.f && v.z == 0.f && v.w == 0.f;
}

__device__ __forceinline__ float flip(float x, unsigned sign) {
  return __uint_as_float(__float_as_uint(x) ^ sign);
}

// cp.async of chunk c's 32 rows (16-byte aligned) into slot.
__device__ __forceinline__ void stage_rows(float4* slot, const float4* src,
                                           int c) {
  const float4* csrc = src + (size_t)c * kSub * kVec;
  for (int e = threadIdx.x; e < kSub * kVec; e += kThreads)
    cp_async16(slot + e, csrc + e);
}

// One live row (12 float4 at g, `row` within its block) against this
// thread's rays: per ray the minimum over its hits (mh, ah: a NaN is the
// minimum, the first row wins) and the first row that misses (nh).
// sparse: the row has build_packet_aux's form and the features are
// finite, so only its nonzero lanes are multiplied.
__device__ __forceinline__ void test_row(const float4* g, bool sparse,
                                         int row, const float (&f)[kRays][9],
                                         float (&mh)[kRays],
                                         int (&ah)[kRays], int (&nh)[kRays]) {
  float ad[kRays], us[kRays], vs[kRays];
  unsigned sg[kRays];
  bool ok[kRays];
  {
    const float4 d0 = g[0], u0 = g[3], u1 = g[4];
    float det[kRays], up[kRays];
    if (sparse) {
#pragma unroll
      for (int q = 0; q < kRays; ++q) {
        det[q] = __fadd_rn(__fadd_rn(__fmul_rn(d0.x, f[q][0]),
                                     __fmul_rn(d0.y, f[q][1])),
                           __fmul_rn(d0.z, f[q][2]));
        up[q] = dot6(u0, u1, f[q]);
      }
    } else {
      const float4 d1 = g[1], d2 = g[2], u2 = g[5];
#pragma unroll
      for (int q = 0; q < kRays; ++q) {
        det[q] = dot10(d0, d1, d2, f[q]);
        up[q] = dot10(u0, u1, u2, f[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kRays; ++q) {
      // the twin's s = det >= 0 ? 1 : -1, as the sign bit of det: the two
      // differ only at det = -0 or NaN, where ad > 0 fails either way
      sg[q] = __float_as_uint(det[q]) & 0x80000000u;
      ad[q] = flip(det[q], sg[q]);
      us[q] = flip(up[q], sg[q]);
      ok[q] = ad[q] > 0.f && us[q] >= 0.f;
    }
  }
  bool any = false;
#pragma unroll
  for (int q = 0; q < kRays; ++q) any |= ok[q];
  if (!__any_sync(0xffffffffu, any)) {  // no ray of the warp hits it
#pragma unroll
    for (int q = 0; q < kRays; ++q) nh[q] = min(nh[q], row);
    return;
  }
  {
    const float4 v0 = g[6], v1 = g[7];
    const float4 v2 = sparse ? v1 : g[8];
#pragma unroll
    for (int q = 0; q < kRays; ++q) {
      vs[q] = flip(sparse ? dot6(v0, v1, f[q]) : dot10(v0, v1, v2, f[q]),
                   sg[q]);
      ok[q] = ok[q] && vs[q] >= 0.f && __fadd_rn(us[q], vs[q]) <= ad[q];
    }
  }
  any = false;
#pragma unroll
  for (int q = 0; q < kRays; ++q) any |= ok[q];
  if (!__any_sync(0xffffffffu, any)) {
#pragma unroll
    for (int q = 0; q < kRays; ++q) nh[q] = min(nh[q], row);
    return;
  }
  const float4 t1 = g[10], t2 = g[11];
  const float4 t0 = sparse ? t1 : g[9];
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    const float tp =
        sparse ? __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(t1.z, f[q][6]),
                                               __fmul_rn(t1.w, f[q][7])),
                                     __fmul_rn(t2.x, f[q][8])),
                           t2.y)
               : dot10(t0, t1, t2, f[q]);
    const float ts = flip(tp, sg[q]);
    if (ok[q] && ts > 0.f) {
      const float tt = __fdiv_rn(ts, ad[q]);
      if (tt < mh[q] || (tt != tt && mh[q] == mh[q])) {
        mh[q] = tt;
        ah[q] = row;
      }
    } else {
      nh[q] = min(nh[q], row);
    }
  }
}

// Each tile's upper bound of the blocks it walks, for the longest-first
// order: the count of leading blocks whose gate is <= tmax.
__global__ void __launch_bounds__(128)
gate_extent(const float* __restrict__ lbg, const float* __restrict__ tmax,
            int T, int nb, int* __restrict__ counts) {
  const int tile = blockIdx.x * 128 + threadIdx.x;
  if (tile >= T) return;
  const float* g = lbg + (size_t)tile * nb;
  const float tm = tmax[tile];
  int n = 0;
  while (n < nb && g[n] <= tm) ++n;
  counts[tile] = n;
}

__global__ void __launch_bounds__(kThreads, kMinCtas)
mt_gathered_kernel(const int* __restrict__ order,
                   const float* __restrict__ o_t,
                   const float* __restrict__ d_t,
                   const float* __restrict__ geom,
                   const float* __restrict__ lbg,
                   const float* __restrict__ tmax, float* __restrict__ t_out,
                   int* __restrict__ i_out, int k4, int nb) {
  __shared__ float4 rows[kStages][kSub * kVec];
  // per warp (row part) of the chunk being listed: its live and its
  // build_packet_aux-form ballots; the warps' max best t before a block
  __shared__ unsigned live_s[kThreads / 32], form_s[kThreads / 32];
  __shared__ float red[kThreads / 32];
  const int tile = order[blockIdx.x];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // rays 2 tid and 2 tid + 1 of the tile: f = [d, o x d, o]
  float f[kRays][9];
  bool fin = true;
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    const float* ot = o_t + (size_t)tile * 3 * kTile + 2 * tid + q;
    const float* dt = d_t + (size_t)tile * 3 * kTile + 2 * tid + q;
    const float ox = ot[0], oy = ot[kTile], oz = ot[2 * kTile];
    const float dx = dt[0], dy = dt[kTile], dz = dt[2 * kTile];
    const float v[9] = {dx, dy, dz,
                        __fsub_rn(__fmul_rn(oy, dz), __fmul_rn(oz, dy)),
                        __fsub_rn(__fmul_rn(oz, dx), __fmul_rn(ox, dz)),
                        __fsub_rn(__fmul_rn(ox, dy), __fmul_rn(oy, dx)),
                        ox, oy, oz};
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      f[q][k] = v[k];
      fin = fin && is_finite(v[k]);
    }
  }
  // the zero lanes of build_packet_aux rows may be skipped only where
  // every feature of the tile is finite
  const bool sparse_ok = __syncthreads_and(fin);

  const float t0 = tmax[tile];
  float best_t[kRays], mh[kRays];
  int best_i[kRays], ah[kRays], nh[kRays];
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    best_t[q] = t0;
    best_i[q] = 0;
  }

  const float4* src =
      reinterpret_cast<const float4*>(geom) + (size_t)tile * k4 * kVec;
  const float* gates = lbg + (size_t)tile * nb;
  const int n_chunks = k4 / kSub;
  // chunk c is cp.async group c; a group is committed (maybe empty) for
  // every chunk index, so the wait below counts the same in every thread
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) stage_rows(rows[c], src, c);
    cp_async_commit();
  }
  for (int blk = 0; blk < nb; ++blk) {
    // the CTA's max best t before this block (read after the barrier)
    float v = best_t[0];
#pragma unroll
    for (int q = 1; q < kRays; ++q) v = nan_max(v, best_t[q]);
    v = warp_nan_max(v);
    if (lane == 0) red[warp] = v;
#pragma unroll
    for (int q = 0; q < kRays; ++q) {
      mh[q] = __int_as_float(0x7f800000);  // +inf
      ah[q] = 0;
      nh[q] = kNone;
    }
    int first_dead = kNone;  // the block's first skipped row
    bool stop = false;
#pragma unroll 1
    for (int s = 0; s < kSubs; ++s) {
      const int c = blk * kSubs + s;
      const int slot = c % kStages;
      cp_async_wait_group<kStages - 2>();  // this thread's part of chunk c
      __syncthreads();  // chunk c visible; every thread is past chunk c - 1
      if (s == 0) {
        float t_far = red[0];
#pragma unroll
        for (int w = 1; w < kThreads / 32; ++w)
          t_far = nan_max(t_far, red[w]);
        if (!(gates[blk] <= t_far)) {  // the same in every thread
          stop = true;
          break;
        }
      }
      const int next = c + kStages - 1;  // into chunk c - 1's slot
      if (next < n_chunks) stage_rows(rows[next % kStages], src, next);
      cp_async_commit();
      {
        // warp k checks part k (lanes 12k..12k+11) of row `lane`
        const float4* p = rows[slot] + lane * kVec + warp * 3;
        const float4 a = p[0], b = p[1], e = p[2];
        bool live = is_finite(e.z) && is_finite(e.w);
        bool form;
        if (warp == 0) {
          live = live && !(zero4(a) && zero4(b) && zero4(e));
          form = a.w == 0.f && zero4(b) && zero4(e);
        } else if (warp < 3) {
          form = b.z == 0.f && b.w == 0.f && zero4(e);
        } else {
          form = zero4(a) && b.x == 0.f && b.y == 0.f && e.z == 0.f &&
                 e.w == 0.f;
        }
        const unsigned lb = __ballot_sync(0xffffffffu, live);
        const unsigned fb = __ballot_sync(0xffffffffu, form);
        if (lane == 0) {
          live_s[warp] = lb;
          form_s[warp] = fb;
        }
      }
      __syncthreads();  // the chunk's masks are written
      unsigned live = live_s[0], form = form_s[0];
#pragma unroll
      for (int w = 1; w < kThreads / 32; ++w) {
        live &= live_s[w];
        form &= form_s[w];
      }
      if (first_dead == kNone && ~live)
        first_dead = s * kSub + __ffs(~live) - 1;
      const float4* chunk = rows[slot];
      for (unsigned m = live; m; m &= m - 1) {
        const int r = __ffs(m) - 1;
        test_row(chunk + r * kVec, sparse_ok && ((form >> r) & 1u),
                 s * kSub + r, f, mh, ah, nh);
      }
    }
    if (stop) break;
#pragma unroll
    for (int q = 0; q < kRays; ++q) {
      // the block's minimum and its first row: kFar at the first miss
      // unless a hit is below kFar or NaN (jnp.min / jnp.argmin)
      float m = mh[q];
      int am = ah[q];
      const int miss = min(nh[q], first_dead);
      if (m == m && miss < kNone && !(m < kFar)) {
        am = m == kFar ? min(am, miss) : miss;
        m = kFar;
      }
      if (m < best_t[q]) {
        best_t[q] = m;
        best_i[q] = blk * kTriBlk + am;
      }
    }
  }
  cp_async_wait_all();  // no copy lands after the CTA is gone
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    const size_t ray = (size_t)tile * kTile + 2 * tid + q;
    t_out[ray] = best_t[q];
    i_out[ray] = best_i[q];
  }
}

}  // namespace
}  // namespace tbvh

// o_t, d_t (T, 3, 256) f32, geom (T, k4, 48) f32 (16-byte aligned),
// lbg (T, 1, nb) f32, tmax (T, 1, 1) f32 -> t (T, 256) f32, idx (T, 256)
// i32. The tile order lives in 2T ints taken from the stream's memory
// pool for the launch.
extern "C" int tbvh_mt_gathered(const float* o_t, const float* d_t,
                                const float* geom, const float* lbg,
                                const float* tmax, float* t, int* idx, int T,
                                int k4, int nb, void* stream) {
  if (T <= 0 || k4 <= 0 || k4 % tbvh::kTriBlk || nb != k4 / tbvh::kTriBlk)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int* counts = nullptr;  // T extents, then the T-tile order
  cudaError_t err = cudaMallocAsync(&counts, sizeof(int) * 2 * T, s);
  if (err != cudaSuccess) return (int)err;
  int* order = counts + T;
  tbvh::gate_extent<<<(T + 127) / 128, 128, 0, s>>>(lbg, tmax, T, nb, counts);
  tbvh::tile_order<<<1, tbvh::kOrderThreads, 0, s>>>(counts, T, nb, 1, order);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    tbvh::mt_gathered_kernel<<<T, tbvh::kThreads, 0, s>>>(
        order, o_t, d_t, geom, lbg, tmax, t, idx, k4, nb);
    err = cudaGetLastError();
  }
  const cudaError_t freed = cudaFreeAsync(counts, s);
  return (int)(err != cudaSuccess ? err : freed);
}

// Kernel C's resources (see common.cuh kernel_occupancy).
extern "C" int tbvh_mt_gathered_occupancy(int* out) {
  return tbvh::kernel_occupancy(
      reinterpret_cast<const void*>(&tbvh::mt_gathered_kernel),
      tbvh::kThreads, 0, out);
}
