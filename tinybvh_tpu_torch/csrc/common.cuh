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

// Triple-product Möller–Trumbore terms of kernel C (kernel B's tri_terms in
// mt_fused.cu computes the same terms from float4 reads): det, u', v', t'
// as 12-lane dots of one triangle's 48-lane row g ([G_det|G_u|G_v|G_t])
// with the ray features f = [d, o x d, o, 1, 0, 0], in lane order, then
// sign-flipped so det >= 0. Twin: packet2.py _signed_terms.
struct SignedTerms {
  float ad, us, vs, ts;
  bool hit;
};

__device__ __forceinline__ SignedTerms signed_terms(const float* g,
                                                    const float* f) {
  float det = 0.f, up = 0.f, vp = 0.f, tp = 0.f;
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    det = __fadd_rn(det, __fmul_rn(g[k], f[k]));
    up = __fadd_rn(up, __fmul_rn(g[12 + k], f[k]));
    vp = __fadd_rn(vp, __fmul_rn(g[24 + k], f[k]));
    tp = __fadd_rn(tp, __fmul_rn(g[36 + k], f[k]));
  }
  const float s = det >= 0.f ? 1.f : -1.f;
  SignedTerms r;
  r.ad = __fmul_rn(det, s);
  r.us = __fmul_rn(up, s);
  r.vs = __fmul_rn(vp, s);
  r.ts = __fmul_rn(tp, s);
  r.hit = r.us >= 0.f && r.vs >= 0.f && __fadd_rn(r.us, r.vs) <= r.ad &&
          r.ts > 0.f && r.ad > 0.f;
  return r;
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

// CTA-wide max of v over a kTile-thread CTA (NaN-propagating, as jnp.max
// and torch.amax). red: kTile / 32 floats of shared memory.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
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

// Waits for every cp.async of this thread (commits them first, by PTX).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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
