// Shared constants and device functions of the packet kernels (see
// traverse/packet2.py, traverse/leaf_resolve.py and
// traverse/frustum_walk.py) and of the probes' kernels (probes/). Every
// multiply and add is rounded separately (__fmul_rn / __fadd_rn, no FMA
// contraction) in the order of the JAX kernels, so the kernels agree with
// the plain PyTorch twins bit for bit; the one exception is the bf16
// tensor-core product (mma_bf16_m16n8k16), which only the probes use.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tbvh {

constexpr int kTB = 8;          // tiles per cull group
constexpr int kLanes = 128;     // segments per cull block
constexpr int kTile = 256;      // rays per tile
constexpr int kI32Max = 0x7fffffff;
constexpr float kFar = 1e30f;   // BVH_FAR

// cull descriptor lanes (packet2.py _D_*)
constexpr int kDPosn = 0;
constexpr int kDNegn = 12;
constexpr int kDThr = 24;
constexpr int kDOlo = 28;
constexpr int kDOhi = 31;
constexpr int kDTcap = 34;
constexpr int kDLanes = 35;

// Plane test of kernels A and G (≙ JAX _frustum_pass, negated): true when
// the box [lo, hi] lies outside any of the 4 planes of the tile whose
// descriptor lanes are d. Twin: packet2.py _frustum_outside.
__device__ __forceinline__ bool frustum_outside(const float* d,
                                                const float lo[3],
                                                const float hi[3]) {
  bool outside = false;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float dist = -d[kDThr + p];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int q = p * 3 + k;
      dist = __fadd_rn(__fadd_rn(dist, __fmul_rn(d[kDPosn + q], hi[k])),
                       __fmul_rn(d[kDNegn + q], lo[k]));
    }
    outside |= dist < 0.f;
  }
  return outside;
}

// Sign-flipped Möller–Trumbore terms of one triangle row against one ray
// (det >= 0): tri_terms below computes them as 12-lane dots of the row [G_det|G_u|G_v|G_t] with the ray features f = [d, o x d,
// o, 1, 0, 0] in lane order. Twin: packet2.py _signed_terms.
struct SignedTerms {
  float ad, us, vs, ts;
  bool hit;
};

// The four 12-lane dots det, u', v', t' of one triangle row (48 lanes at
// g, read as 12 float4) with RPT rays' features, in lane order, every
// multiply and add rounded on its own: each float4 read feeds all RPT
// rays. Kernel I's mathonly variant reads them raw.
template <int RPT>
__device__ __forceinline__ void mt_dots(const float4* g,
                                        const float (&f)[RPT][12],
                                        float (&acc)[RPT][4]) {
#pragma unroll
  for (int q = 0; q < RPT; ++q)
#pragma unroll
    for (int a = 0; a < 4; ++a) acc[q][a] = 0.f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 w = g[a * 3 + j];
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        float x = acc[q][a];
        x = __fadd_rn(x, __fmul_rn(w.x, f[q][4 * j]));
        x = __fadd_rn(x, __fmul_rn(w.y, f[q][4 * j + 1]));
        x = __fadd_rn(x, __fmul_rn(w.z, f[q][4 * j + 2]));
        x = __fadd_rn(x, __fmul_rn(w.w, f[q][4 * j + 3]));
        acc[q][a] = x;
      }
    }
  }
}

// Signed MT terms of one triangle against RPT rays: mt_dots, the sign
// flip and the hit test (≙ packet2.py _signed_terms). Kernels B and I.
template <int RPT>
__device__ __forceinline__ void tri_terms(const float4* g,
                                          const float (&f)[RPT][12],
                                          SignedTerms (&s)[RPT]) {
  float acc[RPT][4];
  mt_dots<RPT>(g, f, acc);
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const float sg = acc[q][0] >= 0.f ? 1.f : -1.f;
    SignedTerms& r = s[q];
    r.ad = __fmul_rn(acc[q][0], sg);
    r.us = __fmul_rn(acc[q][1], sg);
    r.vs = __fmul_rn(acc[q][2], sg);
    r.ts = __fmul_rn(acc[q][3], sg);
    r.hit = r.us >= 0.f && r.vs >= 0.f && __fadd_rn(r.us, r.vs) <= r.ad &&
            r.ts > 0.f && r.ad > 0.f;
  }
}

// Classic Möller–Trumbore of kernels D and E (≙ the expression of the JAX
// leaf kernels, tinybvh_tpu/traverse/pallas_leaf.py:120-135): one ray
// (o, d) against one triangle g = [v0x v0y v0z e1x e1y e1z e2x e2y e2z],
// every product and sum rounded on its own in the JAX order, and the
// reciprocal an IEEE division. Returns t, or kFar where there is no hit.
// Twin: traverse/leaf_resolve.py _classic_mt.
__device__ __forceinline__ float classic_mt(const float o[3], const float d[3],
                                            const float g[9]) {
  const float hx = __fsub_rn(__fmul_rn(d[1], g[8]), __fmul_rn(d[2], g[7]));
  const float hy = __fsub_rn(__fmul_rn(d[2], g[6]), __fmul_rn(d[0], g[8]));
  const float hz = __fsub_rn(__fmul_rn(d[0], g[7]), __fmul_rn(d[1], g[6]));
  const float det = __fadd_rn(
      __fadd_rn(__fmul_rn(g[3], hx), __fmul_rn(g[4], hy)), __fmul_rn(g[5], hz));
  const bool okd = fabsf(det) > 1e-9f;
  const float inv = __fdiv_rn(1.f, okd ? det : 1.f);
  const float sx = __fsub_rn(o[0], g[0]);
  const float sy = __fsub_rn(o[1], g[1]);
  const float sz = __fsub_rn(o[2], g[2]);
  const float u = __fmul_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(sx, hx), __fmul_rn(sy, hy)),
                __fmul_rn(sz, hz)),
      inv);
  const float qx = __fsub_rn(__fmul_rn(sy, g[5]), __fmul_rn(sz, g[4]));
  const float qy = __fsub_rn(__fmul_rn(sz, g[3]), __fmul_rn(sx, g[5]));
  const float qz = __fsub_rn(__fmul_rn(sx, g[4]), __fmul_rn(sy, g[3]));
  const float v = __fmul_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(d[0], qx), __fmul_rn(d[1], qy)),
                __fmul_rn(d[2], qz)),
      inv);
  const float t = __fmul_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(g[6], qx), __fmul_rn(g[7], qy)),
                __fmul_rn(g[8], qz)),
      inv);
  const bool hit = okd && u >= 0.f && v >= 0.f && __fadd_rn(u, v) <= 1.f &&
                   t > 0.f;
  return hit ? t : kFar;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

// Max of v over the 32 lanes of a warp (NaN-propagating).
__device__ __forceinline__ float warp_nan_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// CTA-wide max of v over a kTile-thread CTA (NaN-propagating, as jnp.max
// and torch.amax). red: kTile / 32 floats of shared memory.
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_nan_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kTile / 32; ++w) r = nan_max(r, red[w]);
  __syncthreads();  // red is reused by the next call
  return r;
}

// One 16-byte copy from device to shared memory that bypasses the
// registers (cp.async, L1 not allocated).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// One 4-byte copy from device to shared memory (cp.async, through L1).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// Waits for every cp.async of this thread (commits them first, by PTX).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Closes this thread's pending cp.async copies into one group.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two bf16 values (raw bits) in one 32-bit register, `lo` in the low half:
// the element with the lower index of an mma fragment pair.
__device__ __forceinline__ unsigned pack_bf16x2(unsigned short lo,
                                                unsigned short hi) {
  return (unsigned)lo | ((unsigned)hi << 16);
}

// The bits of x rounded to bf16, to nearest even (as torch's .to(bfloat16)).
__device__ __forceinline__ unsigned short bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// d += a * b on the tensor cores: one warp-wide m16n8k16 product of bf16
// inputs with f32 accumulation (mma.sync, row-major A, column-major B).
// With g = lane / 4 and c = lane % 4, a lane holds
//   a[0] = A[g][2c, 2c+1], a[1] = A[g+8][2c, 2c+1],
//   a[2] = A[g][2c+8, 2c+9], a[3] = A[g+8][2c+8, 2c+9];
//   b[0] = B[2c, 2c+1][g], b[1] = B[2c+8, 2c+9][g];
//   d = {D[g][2c], D[g][2c+1], D[g+8][2c], D[g+8][2c+1]}.
// The products are exact; the order of the additions is the hardware's.
__device__ __forceinline__ void mma_bf16_m16n8k16(float (&d)[4],
                                                  const unsigned (&a)[4],
                                                  const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

namespace {

constexpr int kOrderThreads = 1024;  // tile_order's CTA, and its bins

// The tiles in descending order of counts[t] / kpb (clamped to [0,
// k_cap]; bins past kOrderThreads - 2 share the last one): a counting
// sort in one CTA, for kernels whose tiles differ in length, so that the
// longest start first and no long tile is left for the last wave. The
// order within a bin is free, since a tile's result does not depend on
// the CTA that runs it.
__global__ void __launch_bounds__(kOrderThreads)
tile_order(const int* __restrict__ counts, int T, int k_cap, int kpb,
           int* __restrict__ order) {
  __shared__ int next[kOrderThreads];  // per bin: its count, then its slot
  __shared__ int wsum[kOrderThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  auto bin = [&](int t) {
    const int c = max(min(counts[t], k_cap), 0);
    return min((c + kpb - 1) / kpb, kOrderThreads - 1);
  };
  next[tid] = 0;
  __syncthreads();
  for (int t = tid; t < T; t += kOrderThreads) atomicAdd(&next[bin(t)], 1);
  __syncthreads();
  // thread i holds bin kOrderThreads - 1 - i: an exclusive prefix over the
  // bins in descending order gives each bin's first slot
  const int h = next[kOrderThreads - 1 - tid];
  int inc = h;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += n;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  int first = inc - h;
  for (int w = 0; w < warp; ++w) first += wsum[w];
  next[kOrderThreads - 1 - tid] = first;
  __syncthreads();
  for (int t = tid; t < T; t += kOrderThreads)
    order[atomicAdd(&next[bin(t)], 1)] = t;
}

}  // namespace

// Resources of a kernel at its launch shape (threads per CTA, dynamic
// shared bytes), for the occupancy line of chip_smoke.py: out = {threads,
// registers per thread, static shared bytes, dynamic shared bytes, local
// (spill) bytes per thread, resident CTAs per SM}. Returns a cudaError_t.
inline int kernel_occupancy(const void* fn, int threads, int dyn_smem,
                            int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, threads,
                                                        dyn_smem);
  if (err != cudaSuccess) return (int)err;
  const int vals[6] = {threads, a.numRegs, (int)a.sharedSizeBytes, dyn_smem,
                       (int)a.localSizeBytes, ctas};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
  return 0;
}

}  // namespace tbvh
