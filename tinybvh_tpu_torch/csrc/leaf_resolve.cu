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
// arithmetic is common.cuh classic_mt, shared by D and E: every product
// and sum rounded on its own in the JAX order (no FMA) and an IEEE
// reciprocal, so the kernels equal the plain PyTorch twins bit for bit;
// that halves the fp32 rate the bound assumes, so the floor of this
// design is about twice the bound. Inputs are finite (make_rays validates
// rays, the tables are built from finite triangles), so no NaN rule is
// needed. Tie rules are the JAX kernels':
//   D-v2: the first minimum in row order (a sequential strict-< scan);
//   D-v3: the least key (t, idx % B, idx / B), B = 256, 128 or 32 as the
//         largest that divides K4 (the TPU kernel's per-sublane running
//         best, then its argmin over sublanes);
//   E:    per leaf the first lane of the minimum, across leaves strict <.
//
// What D's design does about it (E keeps the one-ray-a-thread design):
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
constexpr int kRowE = 48;    // floats per leaf row (E)
constexpr int kChunkE = 64;  // leaves per shared-memory chunk (12 KB)

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

__global__ void __launch_bounds__(kTile)
leaf_resolve_kernel(const float* __restrict__ o_t,
                    const float* __restrict__ d_t,
                    const float* __restrict__ geom, const int* __restrict__ live,
                    const int* __restrict__ rows_in, float* __restrict__ t_out,
                    int* __restrict__ pk_out, int k) {
  __shared__ __align__(16) float g_s[kChunkE * kRowE];
  __shared__ int live_s[kChunkE];
  __shared__ int row_s[kChunkE];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  float o[3], d[3];
  load_ray(o_t, d_t, tile, tid, o, d);

  float best_t = kFar;
  int best_pk = 0;
  const float4* src =
      reinterpret_cast<const float4*>(geom + (size_t)tile * k * kRowE);
  float4* dst = reinterpret_cast<float4*>(g_s);
  for (int c0 = 0; c0 < k; c0 += kChunkE) {
    const int n = min(kChunkE, k - c0);
    const float4* csrc = src + (size_t)c0 * (kRowE / 4);
    for (int e = tid; e < n * (kRowE / 4); e += kTile) dst[e] = csrc[e];
    if (tid < n) {
      live_s[tid] = live[(size_t)tile * k + c0 + tid];
      row_s[tid] = rows_in[(size_t)tile * k + c0 + tid];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      if (live_s[j] <= 0) continue;  // a dead leaf never hits
      const float* g = g_s + j * kRowE;
      float m = kFar;
      int lane = 0;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const float tri[9] = {g[l],      g[4 + l],  g[8 + l],
                              g[12 + l], g[16 + l], g[20 + l],
                              g[24 + l], g[28 + l], g[32 + l]};
        const float t = classic_mt(o, d, tri);
        if (t < m) {
          m = t;
          lane = l;
        }
      }
      if (m < best_t) {
        best_t = m;
        best_pk = row_s[j] * 4 + lane;
      }
    }
    __syncthreads();
  }
  const size_t ray = (size_t)tile * kTile + tid;
  t_out[ray] = best_t;
  pk_out[ray] = best_pk;
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
extern "C" int tbvh_leaf_resolve(const float* o_t, const float* d_t,
                                 const float* geom, const int* live,
                                 const int* rows, float* t, int* pk, int T,
                                 int k, void* stream) {
  if (T <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  tbvh::leaf_resolve_kernel<<<T, tbvh::kTile, 0, (cudaStream_t)stream>>>(
      o_t, d_t, geom, live, rows, t, pk, k);
  return (int)cudaGetLastError();
}
