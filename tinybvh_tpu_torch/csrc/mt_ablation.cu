// Kernel I: kernel B's tile loop in eight variants, each with one part
// taken out, to split B's time on this card by subtraction (see
// probes/mt_ablation.py, which holds the plain twin and the driver).
//
// Replaces the TPU kernel benchmarks/mt_ablation_probe.py::
// _ablation_kernel. Per tile of 256 rays (one CTA, one thread per ray) it
// walks the tile's leaf keys in super-blocks of 128 rows (32 leaves of 4
// rows), stages lanes 0:48 of each row of gtab_pad (the only lanes the
// math reads) into a 2-slot shared-memory ring by 16-byte cp.async, and
// issues super-block sb + 1 while sb computes. The next super-block is
// staged and walked only while sb + 1 < nsb and not lbg[min(sb + 1, nb -
// 1)] > the CTA's max best t (NaN passes). Per (row, ray): four 12-lane
// dots of the row with f = [d, o x d, o, 1, 0, 0] in lane order (every
// multiply and add rounded on its own), the sign flip, the hit test and
// t = ts * (1 / ad); the first minimum over the rows wins, and replaces
// the ray's best only when strictly smaller. The variants:
//   full      one copy group per leaf: 4 rows at leaf * 4, the leaf being
//             the key's low 18 bits clamped to max_leaf_row;
//   seg8/32   one group per 8 / 32 leaves, anchored at the group's first
//             key, clamped to max_leaf_row - (span - 1) (rows >= 128,
//             so the clamp is never negative);
//   bigdma    rows 0:128 whatever the keys;
//   nodma     no copy;
//   mathonly  no copy; best t = min(best t, min over rows of det + u' +
//             v' + t'), walking every super-block, best i left at 0;
//   bf16      no copy; g and f rounded to bf16 and the four dots run on
//             the tensor cores (mma.sync m16n8k16, K = 12 padded to 16,
//             f32 accumulation), then the full epilogue. A probe only:
//             the ray path stays IEEE fp32;
//   skeleton  no walk: t = tmax + d.x, i = count.
// The TPU kernel's no-copy variants read a buffer that nothing wrote, so
// their result there is undefined. Here it is defined: before its tile
// loop, a CTA with a super-block to walk fills both ring slots once with
// rows 0:128 (what bigdma copies). So nodma equals bigdma bit for bit, and
// mathonly and bf16 do their arithmetic on real triangles.
//
// What bounds it on this card: the fp32 issue rate, as for kernel B (96
// operations of dots and ~16 of epilogue per (row, ray), no FMA), except
// skeleton (bytes only) and bf16 (the dots at the tensor-core rate, the
// epilogue in fp32). The ring is 2 x 128 x 48 x 4 B = 48 KB of dynamic
// shared memory; every thread reads the same row at once (a broadcast),
// as 12 float4 loads.
#include "common.cuh"

#include <cstdint>

namespace tbvh {
namespace {

constexpr int kBlk = 128;            // rows per super-block (TRI_BLK)
constexpr int kLpb = kBlk / 4;       // leaf keys per super-block
constexpr int kRowF = 48;            // lanes of a row that the math reads
constexpr int kRowV = kRowF / 4;     // float4 per staged row
constexpr int kSlot = kBlk * kRowV;  // float4 per ring slot
constexpr int kLeafMask = (1 << 18) - 1;  // packet2 _LEAF_BITS
constexpr int kWarps = kTile / 32;

enum Variant {
  kFull = 0, kSeg8, kSeg32, kBigDma, kNoDma, kMathOnly, kBf16, kSkeleton,
  kVariants
};

__host__ __device__ constexpr bool copies(int v) { return v <= kBigDma; }

// Dynamic shared bytes: the ring; bf16 adds each ray's (min, row) of a
// super-block.
constexpr int smem_bytes(int v) {
  return 2 * kSlot * 16 + (v == kBf16 ? kTile * 8 : 0);
}

// The gtab_pad row that row r of super-block sb's ring slot holds.
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

// cp.async of lanes 0:48 of super-block sb's 128 rows into `slot`.
template <int V>
__device__ __forceinline__ void stage(float4* slot, const float4* gtab4,
                                      const int* tkeys, int sb,
                                      int max_leaf_row) {
  for (int e = threadIdx.x; e < kSlot; e += kTile) {
    const int r = e / kRowV;
    const long long row = src_row<V>(tkeys, sb, r, max_leaf_row);
    cp_async16(slot + e, gtab4 + row * 32 + (e - r * kRowV));
  }
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

// t of one (row, ray) from its four dots: ts / ad where the ray hits a
// live row, else kFar.
__device__ __forceinline__ float hit_t(float det, float up, float vp,
                                       float tp, bool live) {
  const float s = det >= 0.f ? 1.f : -1.f;
  const float ad = __fmul_rn(det, s), us = __fmul_rn(up, s),
              vs = __fmul_rn(vp, s), ts = __fmul_rn(tp, s);
  const bool hit = us >= 0.f && vs >= 0.f && __fadd_rn(us, vs) <= ad &&
                   ts > 0.f && ad > 0.f;
  return hit && live ? __fmul_rn(ts, __fdiv_rn(1.f, ad)) : kFar;
}

// The four 12-lane dots of the row at g (12 float4) with f, in lane order.
__device__ __forceinline__ void dots(const float4* g, const float (&f)[12],
                                     float (&acc)[4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) acc[a] = 0.f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 w = g[a * 3 + j];
      float x = acc[a];
      x = __fadd_rn(x, __fmul_rn(w.x, f[4 * j]));
      x = __fadd_rn(x, __fmul_rn(w.y, f[4 * j + 1]));
      x = __fadd_rn(x, __fmul_rn(w.z, f[4 * j + 2]));
      x = __fadd_rn(x, __fmul_rn(w.w, f[4 * j + 3]));
      acc[a] = x;
    }
  }
}

// A fragment (rows m0 + g, m0 + g + 8; lanes q * 12 + 2c, +1, +8, +9 of
// the staged rows, zero past lane 11) of one dot, rounded to bf16.
__device__ __forceinline__ void a_frag(const float* buf, int m0, int q,
                                       int g, int c, unsigned (&a)[4]) {
  const float* lo = buf + (m0 + g) * kRowF + q * 12;
  const float* hi = lo + 8 * kRowF;
  const int k = 2 * c;
  a[0] = pack_bf16x2(bf16_bits(lo[k]), bf16_bits(lo[k + 1]));
  a[1] = pack_bf16x2(bf16_bits(hi[k]), bf16_bits(hi[k + 1]));
  a[2] = k + 8 < 12 ? pack_bf16x2(bf16_bits(lo[k + 8]), bf16_bits(lo[k + 9]))
                    : 0u;
  a[3] = k + 8 < 12 ? pack_bf16x2(bf16_bits(hi[k + 8]), bf16_bits(hi[k + 9]))
                    : 0u;
}

// (t, row) of two candidates: the smaller t, the lower row on a tie.
__device__ __forceinline__ void take_min(float& m, int& am, float m2,
                                         int am2) {
  if (m2 < m || (m2 == m && am2 < am)) {
    m = m2;
    am = am2;
  }
}

template <int V>
__global__ void __launch_bounds__(kTile)
ablation_kernel(const int* __restrict__ keys, const int* __restrict__ counts,
                const float* __restrict__ lbg, const float* __restrict__ tmax,
                const float* __restrict__ o_t, const float* __restrict__ d_t,
                const float* __restrict__ gtab, float* __restrict__ t_out,
                int* __restrict__ i_out, int k_cap, int nb,
                int max_leaf_row) {
  extern __shared__ float4 ring[];
  __shared__ float red[kWarps];
  const int tile = blockIdx.x, tid = threadIdx.x;
  const size_t ray = (size_t)tile * kTile + tid;
  const int count = min(counts[tile], k_cap);
  const int nsb = (count + kLpb - 1) / kLpb;
  const float* o = o_t + (size_t)tile * 3 * kTile + tid;
  const float* d = d_t + (size_t)tile * 3 * kTile + tid;
  const float ox = o[0], oy = o[kTile], oz = o[2 * kTile];
  const float dx = d[0], dy = d[kTile], dz = d[2 * kTile];
  const float tm = tmax[tile];
  if (V == kSkeleton) {
    t_out[ray] = __fadd_rn(__fadd_rn(0.f, tm), dx);
    i_out[ray] = count;
    return;
  }
  const float f[12] = {dx, dy, dz,
                       __fsub_rn(__fmul_rn(oy, dz), __fmul_rn(oz, dy)),
                       __fsub_rn(__fmul_rn(oz, dx), __fmul_rn(ox, dz)),
                       __fsub_rn(__fmul_rn(ox, dy), __fmul_rn(oy, dx)),
                       ox, oy, oz, 1.f, 0.f, 0.f};
  float best_t = tm;
  int best_i = 0;
  const int* tkeys = keys + (size_t)tile * k_cap;
  const float4* gtab4 = reinterpret_cast<const float4*>(gtab);

  // bf16: the B fragments (f of the warp's 4 n-tiles of 8 rays, k = 2c,
  // 2c + 1, 2c + 8, 2c + 9), through the ring before it is filled
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, c = lane & 3;
  unsigned bfr[4][2];
  if (V == kBf16) {
    float* fs = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int k = 0; k < 12; ++k) fs[k * kTile + tid] = f[k];
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const float* fr = fs + warp * 32 + nt * 8 + g;
      const int k = 2 * c;
      bfr[nt][0] = pack_bf16x2(bf16_bits(fr[k * kTile]),
                               bf16_bits(fr[(k + 1) * kTile]));
      bfr[nt][1] = k + 8 < 12
                       ? pack_bf16x2(bf16_bits(fr[(k + 8) * kTile]),
                                     bf16_bits(fr[(k + 9) * kTile]))
                       : 0u;
    }
    __syncthreads();  // the ring is overwritten next
  }

  if (nsb > 0) {
    if (copies(V)) {
      stage<V>(ring, gtab4, tkeys, 0, max_leaf_row);
    } else {  // the defined no-copy buffer: rows 0:128 in both slots
      stage<kBigDma>(ring, gtab4, tkeys, 0, max_leaf_row);
      stage<kBigDma>(ring + kSlot, gtab4, tkeys, 0, max_leaf_row);
    }
  }
  int sb = 0;
  bool run = nsb > 0;
  while (run) {
    cp_async_wait_all();
    __syncthreads();  // super-block sb is staged; sb - 1 is consumed
    const float4* buf = ring + (sb & 1) * kSlot;
    bool nxt;
    if (V == kMathOnly) {
      nxt = sb + 1 < nsb;
    } else {
      const float t_far = block_max(best_t, red);
      const float gate_n = lbg[(size_t)tile * nb + min(sb + 1, nb - 1)];
      nxt = sb + 1 < nsb && !(gate_n > t_far);
      if (copies(V) && nxt)
        stage<V>(ring + ((sb + 1) & 1) * kSlot, gtab4, tkeys, sb + 1,
                 max_leaf_row);
    }
    const int live_rows = count * 4 - sb * kBlk;
    if (V == kMathOnly) {
      float m = 0.f;
      for (int r = 0; r < kBlk; ++r) {
        float acc[4];
        dots(buf + r * kRowV, f, acc);
        const float s =
            __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
        m = r == 0 ? s : nan_min(m, s);
      }
      best_t = nan_min(best_t, m);
    } else if (V == kBf16) {
      float* res_m = reinterpret_cast<float*>(ring + 2 * kSlot);
      int* res_i = reinterpret_cast<int*>(res_m + kTile);
      const float* rows = reinterpret_cast<const float*>(buf);
      float m[4][2];
      int am[4][2];
#pragma unroll
      for (int mt = 0; mt < kBlk / 16; ++mt) {
        float acc[4][4][4];  // [dot][n-tile][fragment element]
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          unsigned a[4];
          a_frag(rows, mt * 16, q, g, c, a);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[q][nt][e] = 0.f;
            mma_bf16_m16n8k16(acc[q][nt], a, bfr[nt]);
          }
        }
        // element e of a fragment: row g (+8 for e >= 2), ray 2c + (e & 1)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = mt * 16 + g + (e >= 2 ? 8 : 0);
            const float tt = hit_t(acc[0][nt][e], acc[1][nt][e],
                                   acc[2][nt][e], acc[3][nt][e],
                                   r < live_rows);
            const int j = e & 1;
            if (mt == 0 && e < 2) {
              m[nt][j] = tt;
              am[nt][j] = r;
            } else if (tt < m[nt][j]) {  // rows in increasing order
              m[nt][j] = tt;
              am[nt][j] = r;
            }
          }
        }
      }
      // across the 8 lanes of a column group, then one lane writes
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            take_min(m[nt][j], am[nt][j],
                     __shfl_xor_sync(0xffffffffu, m[nt][j], off),
                     __shfl_xor_sync(0xffffffffu, am[nt][j], off));
          if (g == 0) {
            const int rr = warp * 32 + nt * 8 + 2 * c + j;
            res_m[rr] = m[nt][j];
            res_i[rr] = am[nt][j];
          }
        }
      }
      __syncthreads();
      if (res_m[tid] < best_t) {
        best_t = res_m[tid];
        best_i = sb * kBlk + res_i[tid];
      }
    } else {
      float m = kFar;
      int am = 0;
      for (int r = 0; r < kBlk; ++r) {
        float acc[4];
        dots(buf + r * kRowV, f, acc);
        const float tt = hit_t(acc[0], acc[1], acc[2], acc[3],
                               r < live_rows);
        if (r == 0 || tt < m) {  // the first minimum
          m = tt;
          am = r;
        }
      }
      if (m < best_t) {
        best_t = m;
        best_i = sb * kBlk + am;
      }
    }
    ++sb;
    run = nxt;
  }
  t_out[ray] = best_t;
  i_out[ray] = best_i;
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

// Dynamic shared memory past 48 KB needs the kernel's opt-in, once.
cudaError_t opt_in(int v) {
  static bool done[kVariants] = {};
  if (done[v]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel_for(v), cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(v));
  done[v] = err == cudaSuccess;
  return err;
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
  cudaError_t err = tbvh::opt_in(variant);
  if (err != cudaSuccess) return (int)err;
  const int max_leaf_row = rows / 4 - 1;
  void* args[] = {&keys, &counts, &lbg,  &tmax,  &o_t, &d_t,
                  &gtab, &t,      &idx,  &k_cap, &nb,  (void*)&max_leaf_row};
  err = cudaLaunchKernel(tbvh::kernel_for(variant), dim3(T),
                         dim3(tbvh::kTile), args, tbvh::smem_bytes(variant),
                         (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return (int)(err != cudaSuccess ? err : last);
}

// Kernel I's resources for `variant` (see common.cuh kernel_occupancy).
extern "C" int tbvh_mt_ablation_occupancy(int variant, int* out) {
  if (variant < 0 || variant >= tbvh::kVariants)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = tbvh::opt_in(variant);
  if (err != cudaSuccess) return (int)err;
  return tbvh::kernel_occupancy(tbvh::kernel_for(variant), tbvh::kTile,
                                tbvh::smem_bytes(variant), out);
}
