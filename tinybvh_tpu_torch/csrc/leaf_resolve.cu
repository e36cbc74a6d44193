// Kernels D and E: dense per-tile leaf resolve of the v1 packet engine
// (traverse/leaf_resolve.py).
//
// Replaces the TPU kernels of tinybvh_tpu/traverse/pallas_leaf.py:
//   D  `_kernel_v2` (wide=false) and `_kernel_v3` (wide=true), called from
//      leaf_resolve_v2: every ray of a 256-ray tile against the tile's K4
//      triangle rows (T, K4, 12) = [v0 | e1 | e2 | pad], dead rows zeroed;
//      out: closest t and its row position in the list;
//   E  `_kernel`, called from leaf_resolve: the same per leaf over x-major
//      (T, K, 48) rows [v0x*4 | v0y*4 | v0z*4 | e1.. | e2.. | pad] with a
//      live flag per leaf; out: closest t and rows[j] * 4 + lane.
//
// What bounds them on this card: fp32 issue rate. Each (row, ray) pair is
// ~56 flops of classic Möller–Trumbore, and a row (48 B for D, 192 B per
// 4 triangles for E) is shared by all 256 rays of the tile, so device
// memory traffic is K4 x 48 B per tile against K4 x 256 x 56 flops. The
// arithmetic is common.cuh classic_mt (D) and its staged copy test_tri
// (E): every product and sum rounded on its own in the JAX order (no FMA)
// and an IEEE reciprocal, so the kernels equal the plain PyTorch twins
// bit for bit; that halves the fp32 rate the bound assumes, so the floor
// of this design is about twice the bound. Inputs are finite (make_rays
// validates rays, the tables are built from finite triangles), so no NaN
// rule is needed. Tie rules are the JAX kernels':
//   D-v2: the first minimum in row order (a sequential strict-< scan);
//   D-v3: the least key (t, idx % B, idx / B), B = 256, 128 or 32 as the
//         largest that divides K4 (the TPU kernel's per-sublane running
//         best, then its argmin over sublanes);
//   E:    per leaf the first lane of the minimum, across leaves strict <.
//
// What D's design does about it:
//  - rows that can only miss are not tested. The v1 engine's lists hold
//    the live leaves first and I32MAX padding after them, gathered as
//    zero rows, and leaves of fewer than 4 triangles add zero rows: at the
//    engine's shapes ~84% of the rows are dead. A row whose e2 is zero has
//    h = d x e2 = 0, so det = 0 (or NaN) and |det| > 1e-9 fails: it misses
//    for every ray. One thread a row flags the live rows of each 128-row
//    chunk by warp ballots into a list of its live rows, and the math
//    walks only the list, in row order. This is exact: a miss gives
//    kFar, which never replaces the best under the strict <, and v3's
//    tie test ignores misses, so a ray that hits nothing still returns
//    (kFar, 0). The signature stays JAX's: the kernel finds the live rows
//    itself, and a dead chunk costs only its copy and one ballot;
//  - two rays a thread (128 threads a tile), so each row's three float4
//    broadcasts from shared memory feed both; registers capped so that
//    at least 24 warps stay resident per SM (the shared ring allows 32);
//  - the chunks stream through a ring of four 6 KB slots by 16-byte
//    cp.async, three chunks in flight while one is tested, so the copy of
//    the dead tail overlaps the live rows' math;
//  - tiles differ in live length, so a pre-pass samples 32 rows of each
//    tile for its extent and common.cuh tile_order sorts the tiles,
//    longest first (the order is a heuristic; the results do not depend
//    on it);
//  - the IEEE division stays on every live pair. An exact pre-test on
//    the numerators (tn and det of one sign; un or vn of the other sign
//    only where |un| >= 2^-20 and |det| <= 2^100, since a u or v that
//    rounds to -0 passes >= 0) skips it only where all 64 rays of a warp
//    reject the triangle; tried on the card, its compares on every pair
//    cost more than the divisions it skipped. __frcp_rn, equal bit for
//    bit, was slower too.
//
// What E's design does about it (D's, over x-major leaves):
//  - triangles that can only miss are not tested: a dead leaf (live <= 0)
//    and, inside a live leaf, a triangle whose e2 is zero (h = d x e2 = 0,
//    so det = 0 or NaN and |det| > 1e-9 fails for every ray). Warp l
//    checks triangle l of each of the chunk's 32 leaves, one lane a leaf,
//    and its ballot is the chunk's mask of live triangles l; the math
//    walks the leaves with any bit set, in order, and in each the set
//    lanes. E's signature takes any mask, so no order of the live leaves
//    is assumed;
//  - a leaf's 9 fields are read as 9 float4 (each field's 4 lanes), which
//    feed up to 4 triangles x 2 rays (two rays a thread, 128 threads,
//    consecutive rays, so that a warp's 64 rays are close in the image);
//  - after u (and again after v) the warp votes: where no ray of the warp
//    can still hit the triangle, its q, v and t are not computed (those
//    rays miss, as classic_mt would say);
//  - geom and live stream through a ring of four 32-leaf slots (6 KB) by
//    cp.async, two chunks in flight while one is listed and tested;
//  - tiles run longest first (common.cuh tile_order) by their live leaves,
//    counted exactly by a pre-pass over live;
//  - the tie rule: per leaf the first lane of the minimum, across leaves
//    only a strictly smaller t. A hit has t > 0, so no t is NaN, and the
//    two rules together equal one strict-< scan over (leaf, lane) in
//    order from kFar, which the kernel runs over the tested triangles
//    (a skipped one would give kFar, which never wins); the packed winner
//    is rows[leaf] * 4 + lane, or 0 where nothing hits.
#include "common.cuh"

namespace tbvh {
namespace {

constexpr int kRowD = 12;                 // floats per triangle row (D)
constexpr int kVecD = kRowD / 4;          // float4 per row
constexpr int kRaysD = 2;                 // rays per thread (D)
constexpr int kThreadsD = kTile / kRaysD; // threads per tile (D)
constexpr int kChunkD = kThreadsD;        // rows per chunk: one a thread
constexpr int kStagesD = 4;               // ring slots (6 KB each)
constexpr int kMinCtasD = 24 * 32 / kThreadsD;  // 24 resident warps a SM
constexpr int kSegsD = 32;                // extent samples a tile (order)
constexpr int kVecE = 12;                 // float4 per leaf row (E)
constexpr int kRaysE = 2;                 // rays per thread (E)
constexpr int kThreadsE = kTile / kRaysE; // threads per tile (E)
constexpr int kChunkE = 32;               // leaves per chunk: one ballot
constexpr int kStagesE = 4;               // ring slots (6 KB each)
constexpr int kMinCtasE = 24 * 32 / kThreadsE;  // 24 resident warps a SM

__device__ __forceinline__ void load_ray(const float* o_t, const float* d_t,
                                         int tile, int ray, float o[3],
                                         float d[3]) {
  const float* ot = o_t + (size_t)tile * 3 * kTile + ray;
  const float* dt = d_t + (size_t)tile * 3 * kTile + ray;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = ot[k * kTile];
    d[k] = dt[k * kTile];
  }
}

// cp.async of chunk c's rows (at most kChunkD, 16-byte aligned) into slot.
__device__ __forceinline__ void stage_rows(float4* slot, const float4* src,
                                           int c, int k4) {
  const int n = min(kChunkD, k4 - c * kChunkD);
  const float4* csrc = src + (size_t)c * kChunkD * kVecD;
  for (int e = threadIdx.x; e < n * kVecD; e += kThreadsD)
    cp_async16(slot + e, csrc + e);
}

// Each tile's estimated live extent, for the longest-first order: lane l
// of the tile's warp samples the first row of segment l of its 32
// segments of K4 / 32 rows (the first triangle of a leaf, which is never
// zero, where the rows are whole leaves), and the count is one past the
// last segment whose sample is live. Only the order reads it; the kernel
// tests every row itself.
__global__ void __launch_bounds__(128)
tile_extent(const float* __restrict__ geom, int T, int k4,
            int* __restrict__ counts) {
  const int tile = blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (tile >= T) return;  // the whole warp
  const float* g =
      geom + ((size_t)tile * k4 + (size_t)lane * (k4 / kSegsD)) * kRowD;
  const bool is_live = g[6] != 0.f || g[7] != 0.f || g[8] != 0.f;
  const unsigned m = __ballot_sync(0xffffffffu, is_live);
  if (lane == 0) counts[tile] = 32 - __clz(m);
}

template <bool kWide>
__global__ void __launch_bounds__(kThreadsD, kMinCtasD)
leaf_resolve_v2_kernel(const int* __restrict__ order,
                       const float* __restrict__ o_t,
                       const float* __restrict__ d_t,
                       const float* __restrict__ geom, float* __restrict__ t_out,
                       int* __restrict__ i_out, int k4, int bsz) {
  __shared__ float4 rows[kStagesD][kChunkD * kVecD];
  // per warp of a chunk: its live rows in order, and their count
  __shared__ unsigned char live_rows[kStagesD][kChunkD];
  __shared__ int live_n[kStagesD][kChunkD / 32];
  const int tile = order[blockIdx.x];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float o[kRaysD][3], d[kRaysD][3], best_t[kRaysD];
  int best_i[kRaysD];
#pragma unroll
  for (int q = 0; q < kRaysD; ++q) {
    load_ray(o_t, d_t, tile, tid + q * kThreadsD, o[q], d[q]);
    best_t[q] = kFar;
    best_i[q] = 0;
  }

  const float4* src =
      reinterpret_cast<const float4*>(geom) + (size_t)tile * k4 * kVecD;
  const int n_chunks = (k4 + kChunkD - 1) / kChunkD;
  // chunk c is cp.async group c; a group is committed (maybe empty) for
  // every chunk index, so the wait below counts the same in every thread
#pragma unroll
  for (int c = 0; c < kStagesD - 1; ++c) {
    if (c < n_chunks) stage_rows(rows[c], src, c, k4);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    const int slot = c % kStagesD;
    cp_async_wait_group<kStagesD - 2>();  // this thread's part of chunk c
    __syncthreads();  // chunk c visible; every thread is past chunk c - 1
    const int next = c + kStagesD - 1;    // into chunk c - 1's slot
    if (next < n_chunks) stage_rows(rows[next % kStagesD], src, next, k4);
    cp_async_commit();
    // live rows of chunk c, one thread a row: e2 (lanes 6-8) not zero
    const int n = min(kChunkD, k4 - c * kChunkD);
    bool is_live = false;
    if (tid < n) {
      const float4 b = rows[slot][tid * kVecD + 1];
      const float4 e = rows[slot][tid * kVecD + 2];
      is_live = b.z != 0.f || b.w != 0.f || e.x != 0.f;
    }
    const unsigned m = __ballot_sync(0xffffffffu, is_live);
    if (is_live)
      live_rows[slot][warp * 32 + __popc(m & ((1u << lane) - 1u))] = tid;
    if (lane == 0) live_n[slot][warp] = __popc(m);
    __syncthreads();  // the chunk's live rows are listed
    const float4* chunk = rows[slot];
#pragma unroll 1
    for (int w = 0; w < kChunkD / 32; ++w) {
      const unsigned char* list = live_rows[slot] + w * 32;
      const int n_w = live_n[slot][w];
      for (int j = 0; j < n_w; ++j) {
        const int r = list[j];
        const float4* g = chunk + r * kVecD;
        const float4 g0 = g[0], g1 = g[1], g2 = g[2];
        const float tri[9] = {g0.x, g0.y, g0.z, g0.w, g1.x,
                              g1.y, g1.z, g1.w, g2.x};
        const int idx = c * kChunkD + r;
#pragma unroll
        for (int q = 0; q < kRaysD; ++q) {
          const float t = classic_mt(o[q], d[q], tri);
          // live rows arrive in order: a later row with an equal t wins
          // only when its sublane idx % B is smaller (v3's key; B is a
          // power of two); v2 keeps the first. Misses (t = kFar) never
          // win, so their tie test is skipped.
          const bool better =
              t < best_t[q] ||
              (kWide && t == best_t[q] && t < kFar &&
               (idx & (bsz - 1)) < (best_i[q] & (bsz - 1)));
          if (better) {
            best_t[q] = t;
            best_i[q] = idx;
          }
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kRaysD; ++q) {
    const size_t ray = (size_t)tile * kTile + tid + q * kThreadsD;
    t_out[ray] = best_t[q];
    i_out[ray] = best_i[q];
  }
}

const void* resolve_v2_kernel_for(int wide) {
  return wide ? reinterpret_cast<const void*>(&leaf_resolve_v2_kernel<true>)
              : reinterpret_cast<const void*>(&leaf_resolve_v2_kernel<false>);
}

// Each tile's live leaves (live > 0), for the longest-first order of
// kernel E: one warp a tile.
__global__ void __launch_bounds__(128)
live_count(const int* __restrict__ live, int T, int k,
           int* __restrict__ counts) {
  const int tile = blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (tile >= T) return;  // the whole warp
  const int* l = live + (size_t)tile * k;
  int n = 0;
  for (int j0 = 0; j0 < k; j0 += 32) {
    const int j = j0 + lane;
    n += __popc(__ballot_sync(0xffffffffu, j < k && l[j] > 0));
  }
  if (lane == 0) counts[tile] = n;
}

// One lane (triangle) of an x-major leaf: component l of each field.
__device__ __forceinline__ float lane_of(const float4& v, int l) {
  return l == 0 ? v.x : l == 1 ? v.y : l == 2 ? v.z : v.w;
}

// cp.async of chunk c's leaves (at most kChunkE: 12 float4 and a live
// flag each) into slot.
__device__ __forceinline__ void stage_leaves(float4* slot, int* live_slot,
                                             const float4* src,
                                             const int* live, int c, int k) {
  const int n = min(kChunkE, k - c * kChunkE);
  const float4* csrc = src + (size_t)c * kChunkE * kVecE;
  for (int e = threadIdx.x; e < n * kVecE; e += kThreadsE)
    cp_async16(slot + e, csrc + e);
  if ((int)threadIdx.x < n)
    cp_async4(live_slot + threadIdx.x, live + c * kChunkE + threadIdx.x);
}

// One triangle g = [v0 | e1 | e2] (lane l of leaf `jl / 4`) against this
// thread's rays: common.cuh classic_mt's arithmetic in its order, in three
// stages. After u (and again after v) the warp votes, and where no ray of
// the warp can still hit, the rest is not computed: those rays miss, as
// classic_mt's hit test would say. (leaf, lane) arrive in order, so a
// strict < keeps the first minimum.
__device__ __forceinline__ void test_tri(const float (&o)[kRaysE][3],
                                         const float (&d)[kRaysE][3],
                                         const float (&g)[9], int jl,
                                         float (&best_t)[kRaysE],
                                         int (&best_j)[kRaysE]) {
  float hx[kRaysE], hy[kRaysE], hz[kRaysE], inv[kRaysE], u[kRaysE];
  float sx[kRaysE], sy[kRaysE], sz[kRaysE];
  bool ok[kRaysE];
  bool any = false;
#pragma unroll
  for (int q = 0; q < kRaysE; ++q) {
    hx[q] = __fsub_rn(__fmul_rn(d[q][1], g[8]), __fmul_rn(d[q][2], g[7]));
    hy[q] = __fsub_rn(__fmul_rn(d[q][2], g[6]), __fmul_rn(d[q][0], g[8]));
    hz[q] = __fsub_rn(__fmul_rn(d[q][0], g[7]), __fmul_rn(d[q][1], g[6]));
    const float det = __fadd_rn(
        __fadd_rn(__fmul_rn(g[3], hx[q]), __fmul_rn(g[4], hy[q])),
        __fmul_rn(g[5], hz[q]));
    const bool okd = fabsf(det) > 1e-9f;
    inv[q] = __fdiv_rn(1.f, okd ? det : 1.f);
    sx[q] = __fsub_rn(o[q][0], g[0]);
    sy[q] = __fsub_rn(o[q][1], g[1]);
    sz[q] = __fsub_rn(o[q][2], g[2]);
    u[q] = __fmul_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(sx[q], hx[q]),
                            __fmul_rn(sy[q], hy[q])),
                  __fmul_rn(sz[q], hz[q])),
        inv[q]);
    ok[q] = okd && u[q] >= 0.f;
    any |= ok[q];
  }
  if (!__any_sync(0xffffffffu, any)) return;  // no ray of the warp hits it
  float qx[kRaysE], qy[kRaysE], qz[kRaysE];
  any = false;
#pragma unroll
  for (int q = 0; q < kRaysE; ++q) {
    qx[q] = __fsub_rn(__fmul_rn(sy[q], g[5]), __fmul_rn(sz[q], g[4]));
    qy[q] = __fsub_rn(__fmul_rn(sz[q], g[3]), __fmul_rn(sx[q], g[5]));
    qz[q] = __fsub_rn(__fmul_rn(sx[q], g[4]), __fmul_rn(sy[q], g[3]));
    const float v = __fmul_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(d[q][0], qx[q]),
                            __fmul_rn(d[q][1], qy[q])),
                  __fmul_rn(d[q][2], qz[q])),
        inv[q]);
    ok[q] = ok[q] && v >= 0.f && __fadd_rn(u[q], v) <= 1.f;
    any |= ok[q];
  }
  if (!__any_sync(0xffffffffu, any)) return;
#pragma unroll
  for (int q = 0; q < kRaysE; ++q) {
    const float t = __fmul_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(g[6], qx[q]), __fmul_rn(g[7], qy[q])),
                  __fmul_rn(g[8], qz[q])),
        inv[q]);
    if (ok[q] && t > 0.f && t < best_t[q]) {
      best_t[q] = t;
      best_j[q] = jl;
    }
  }
}

__global__ void __launch_bounds__(kThreadsE, kMinCtasE)
leaf_resolve_kernel(const int* __restrict__ order,
                    const float* __restrict__ o_t,
                    const float* __restrict__ d_t,
                    const float* __restrict__ geom,
                    const int* __restrict__ live,
                    const int* __restrict__ rows_in, float* __restrict__ t_out,
                    int* __restrict__ pk_out, int k) {
  __shared__ float4 g_s[kStagesE][kChunkE * kVecE];
  __shared__ int live_s[kStagesE][kChunkE];
  // per triangle lane l of a leaf (one warp each): bit j set where leaf j
  // of the chunk being listed is live and its triangle l is not zero
  __shared__ unsigned tri_s[4];
  const int tile = order[blockIdx.x];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float o[kRaysE][3], d[kRaysE][3], best_t[kRaysE];
  int best_j[kRaysE];  // leaf * 4 + lane of the best, -1 before a hit
#pragma unroll
  for (int q = 0; q < kRaysE; ++q) {
    load_ray(o_t, d_t, tile, 2 * tid + q, o[q], d[q]);
    best_t[q] = kFar;
    best_j[q] = -1;
  }

  const float4* src =
      reinterpret_cast<const float4*>(geom) + (size_t)tile * k * kVecE;
  const int* tlive = live + (size_t)tile * k;
  const int n_chunks = (k + kChunkE - 1) / kChunkE;
  // chunk c is cp.async group c (see leaf_resolve_v2_kernel)
#pragma unroll
  for (int c = 0; c < kStagesE - 1; ++c) {
    if (c < n_chunks) stage_leaves(g_s[c], live_s[c], src, tlive, c, k);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    const int slot = c % kStagesE;
    cp_async_wait_group<kStagesE - 2>();  // this thread's part of chunk c
    __syncthreads();  // chunk c visible; every thread is past chunk c - 1
    const int next = c + kStagesE - 1;    // into chunk c - 1's slot
    if (next < n_chunks)
      stage_leaves(g_s[next % kStagesE], live_s[next % kStagesE], src, tlive,
                   next, k);
    cp_async_commit();
    {
      // warp l checks triangle l of leaf `lane`: live, and e2 not zero (a
      // zero e2 gives h = 0, so det = 0 or NaN and |det| > 1e-9 fails)
      const int n = min(kChunkE, k - c * kChunkE);
      bool ok = false;
      if (lane < n && live_s[slot][lane] > 0) {
        const float* e2 =
            reinterpret_cast<const float*>(g_s[slot] + lane * kVecE) + 24 +
            warp;
        ok = e2[0] != 0.f || e2[4] != 0.f || e2[8] != 0.f;
      }
      const unsigned b = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) tri_s[warp] = b;
    }
    __syncthreads();  // the chunk's triangle masks are written
    unsigned tm[4];
#pragma unroll
    for (int l = 0; l < 4; ++l) tm[l] = tri_s[l];
    const float4* chunk = g_s[slot];
    for (unsigned m = tm[0] | tm[1] | tm[2] | tm[3]; m; m &= m - 1) {
      const int j = __ffs(m) - 1;
      const float4* g = chunk + j * kVecE;
      float4 fv[9];
#pragma unroll
      for (int e = 0; e < 9; ++e) fv[e] = g[e];
      const int jl = (c * kChunkE + j) * 4;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        if (!((tm[l] >> j) & 1u)) continue;  // the same in every thread
        float tri[9];
#pragma unroll
        for (int e = 0; e < 9; ++e) tri[e] = lane_of(fv[e], l);
        test_tri(o, d, tri, jl + l, best_t, best_j);
      }
    }
  }
  cp_async_wait_all();  // no copy lands after the CTA is gone
#pragma unroll
  for (int q = 0; q < kRaysE; ++q) {
    const size_t ray = (size_t)tile * kTile + 2 * tid + q;
    const int bj = best_j[q];
    t_out[ray] = best_t[q];
    pk_out[ray] = bj < 0 ? 0
                         : (int)((unsigned)rows_in[(size_t)tile * k + (bj >> 2)]
                                     * 4u +
                                 (unsigned)(bj & 3));
  }
}

}  // namespace
}  // namespace tbvh

// o_t, d_t (T, 3, 256) f32, geom (T, k4, 12) f32 (16-byte aligned),
// k4 % 32 == 0, bsz the v3 block (256, 128 or 32; read when wide != 0)
// -> t (T, 256) f32, idx (T, 256) i32. The tile order lives in 2T ints
// taken from the stream's memory pool for the launch.
extern "C" int tbvh_leaf_resolve_v2(const float* o_t, const float* d_t,
                                    const float* geom, float* t, int* idx,
                                    int T, int k4, int wide, int bsz,
                                    void* stream) {
  if (T <= 0 || k4 <= 0 || k4 % 32 ||
      (wide && (bsz <= 0 || (bsz & (bsz - 1)) || k4 % bsz)))
    return (int)cudaErrorInvalidValue;
  if (!wide) bsz = 1;
  const cudaStream_t s = (cudaStream_t)stream;
  int* counts = nullptr;  // T extents, then the T-tile order
  cudaError_t err = cudaMallocAsync(&counts, sizeof(int) * 2 * T, s);
  if (err != cudaSuccess) return (int)err;
  int* order = counts + T;
  tbvh::tile_extent<<<(T + 3) / 4, 128, 0, s>>>(geom, T, k4, counts);
  tbvh::tile_order<<<1, tbvh::kOrderThreads, 0, s>>>(counts, T, tbvh::kSegsD,
                                                     1, order);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    void* args[] = {&order, &o_t, &d_t, &geom, &t, &idx, &k4, &bsz};
    err = cudaLaunchKernel(tbvh::resolve_v2_kernel_for(wide), dim3(T),
                           dim3(tbvh::kThreadsD), args, 0, s);
    const cudaError_t last = cudaGetLastError();  // clears a refused launch
    if (err == cudaSuccess) err = last;
  }
  const cudaError_t freed = cudaFreeAsync(counts, s);
  return (int)(err != cudaSuccess ? err : freed);
}

// Kernel D's resources for the v2 (wide = 0) or v3 body (see common.cuh
// kernel_occupancy).
extern "C" int tbvh_leaf_resolve_v2_occupancy(int wide, int* out) {
  return tbvh::kernel_occupancy(tbvh::resolve_v2_kernel_for(wide),
                                tbvh::kThreadsD, 0, out);
}

// o_t, d_t (T, 3, 256) f32, geom (T, k, 48) f32 (16-byte aligned),
// live (T, k) i32, rows (T, k) i32 -> t (T, 256) f32, packed (T, 256) i32.
// The tile order lives in 2T ints taken from the stream's memory pool for
// the launch.
extern "C" int tbvh_leaf_resolve(const float* o_t, const float* d_t,
                                 const float* geom, const int* live,
                                 const int* rows, float* t, int* pk, int T,
                                 int k, void* stream) {
  if (T <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int* counts = nullptr;  // T live counts, then the T-tile order
  cudaError_t err = cudaMallocAsync(&counts, sizeof(int) * 2 * T, s);
  if (err != cudaSuccess) return (int)err;
  int* order = counts + T;
  const int kpb = (k + tbvh::kOrderThreads - 3) / (tbvh::kOrderThreads - 2);
  tbvh::live_count<<<(T + 3) / 4, 128, 0, s>>>(live, T, k, counts);
  tbvh::tile_order<<<1, tbvh::kOrderThreads, 0, s>>>(counts, T, k, kpb,
                                                     order);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    tbvh::leaf_resolve_kernel<<<T, tbvh::kThreadsE, 0, s>>>(
        order, o_t, d_t, geom, live, rows, t, pk, k);
    err = cudaGetLastError();
  }
  const cudaError_t freed = cudaFreeAsync(counts, s);
  return (int)(err != cudaSuccess ? err : freed);
}

// Kernel E's resources (see common.cuh kernel_occupancy).
extern "C" int tbvh_leaf_resolve_occupancy(int* out) {
  return tbvh::kernel_occupancy(
      reinterpret_cast<const void*>(&tbvh::leaf_resolve_kernel),
      tbvh::kThreadsE, 0, out);
}
