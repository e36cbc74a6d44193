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
// memory traffic is K4 x 48 B per tile against K4 x 256 x 56 flops. A
// whole tile at K4 = 2048 is 96 KB (D) and at K = 512 leaves 96 KB (E),
// which would cap an SM at two CTAs; the TPU kernels held it in VMEM.
//
// What the design does about it: one CTA per tile, one ray per thread, its
// best (t, index) in registers. The tile's rows are streamed through
// shared memory in chunks of 12 KB with 16-byte loads and read back as
// broadcasts (every thread reads the same row: no bank conflicts). The
// arithmetic is common.cuh classic_mt, shared by D and E: every product
// and sum rounded on its own in the JAX order, an IEEE reciprocal, so the
// kernels equal the plain PyTorch twins bit for bit. Inputs are finite
// (make_rays validates rays, the tables are built from finite triangles),
// so no NaN rule is needed. Tie rules are the JAX kernels':
//   D-v2: the first minimum in row order (a sequential strict-< scan);
//   D-v3: the least key (t, idx % B, idx / B), B = 256, 128 or 32 as the
//         largest that divides K4 (the TPU kernel's per-sublane running
//         best, then its argmin over sublanes);
//   E:    per leaf the first lane of the minimum, across leaves strict <.
// A simple kernel: D tests every row, dead rows included (det = 0 never
// hits); skipping them, and cp.async double buffering, are later work.
#include "common.cuh"

namespace tbvh {
namespace {

constexpr int kRowD = 12;    // floats per triangle row (D)
constexpr int kChunkD = 256; // rows per shared-memory chunk (12 KB)
constexpr int kRowE = 48;    // floats per leaf row (E)
constexpr int kChunkE = 64;  // leaves per shared-memory chunk (12 KB)

__device__ __forceinline__ void load_ray(const float* o_t, const float* d_t,
                                         int tile, int tid, float o[3],
                                         float d[3]) {
  const float* ot = o_t + (size_t)tile * 3 * kTile + tid;
  const float* dt = d_t + (size_t)tile * 3 * kTile + tid;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = ot[k * kTile];
    d[k] = dt[k * kTile];
  }
}

template <bool kWide>
__global__ void __launch_bounds__(kTile)
leaf_resolve_v2_kernel(const float* __restrict__ o_t,
                       const float* __restrict__ d_t,
                       const float* __restrict__ geom, float* __restrict__ t_out,
                       int* __restrict__ i_out, int k4, int bsz) {
  __shared__ __align__(16) float rows[kChunkD * kRowD];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  float o[3], d[3];
  load_ray(o_t, d_t, tile, tid, o, d);

  float best_t = kFar;
  int best_i = 0;
  const float4* src =
      reinterpret_cast<const float4*>(geom + (size_t)tile * k4 * kRowD);
  float4* dst = reinterpret_cast<float4*>(rows);
  for (int c0 = 0; c0 < k4; c0 += kChunkD) {
    const int n = min(kChunkD, k4 - c0);
    const float4* csrc = src + (size_t)c0 * (kRowD / 4);
    for (int e = tid; e < n * (kRowD / 4); e += kTile) dst[e] = csrc[e];
    __syncthreads();
    for (int r = 0; r < n; ++r) {
      const float t = classic_mt(o, d, rows + r * kRowD);
      const int idx = c0 + r;
      // rows arrive in order: a later row with an equal t wins only when
      // its sublane idx % B is smaller (v3's key; B is a power of two);
      // v2 keeps the first. Misses (t = kFar) never win, so their tie
      // test is skipped.
      const bool better =
          t < best_t || (kWide && t == best_t && t < kFar &&
                         (idx & (bsz - 1)) < (best_i & (bsz - 1)));
      if (better) {
        best_t = t;
        best_i = idx;
      }
    }
    __syncthreads();  // rows is rewritten by the next chunk
  }
  const size_t ray = (size_t)tile * kTile + tid;
  t_out[ray] = best_t;
  i_out[ray] = best_i;
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
// -> t (T, 256) f32, idx (T, 256) i32.
extern "C" int tbvh_leaf_resolve_v2(const float* o_t, const float* d_t,
                                    const float* geom, float* t, int* idx,
                                    int T, int k4, int wide, int bsz,
                                    void* stream) {
  if (T <= 0 || k4 <= 0 || k4 % 32 ||
      (wide && (bsz <= 0 || (bsz & (bsz - 1)) || k4 % bsz)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (wide)
    tbvh::leaf_resolve_v2_kernel<true>
        <<<T, tbvh::kTile, 0, s>>>(o_t, d_t, geom, t, idx, k4, bsz);
  else
    tbvh::leaf_resolve_v2_kernel<false>
        <<<T, tbvh::kTile, 0, s>>>(o_t, d_t, geom, t, idx, k4, 1);
  return (int)cudaGetLastError();
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
