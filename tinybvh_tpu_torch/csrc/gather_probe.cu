// Kernel H: the in-kernel gather forms of the TPU gather probes, one CUDA
// kernel per form (see probes/gather.py, which holds the plain twins).
//
// Replaces the TPU kernels of benchmarks/pallas_gather_probe.py (`kernel`,
// `kernel2`) and benchmarks/pallas_gather_probe2.py (`kA`, `kB`, `kB2`,
// `kC`, `kE`, `kA100`, `kC100`, `kD`). On the TPU they asked which
// per-lane gathers Mosaic lowers and what each costs; on the H100 every
// one is an ordinary gather, from shared memory where the table fits and
// from device memory (resident in L2) where it does not:
//   row    out[r] = table[idx[r], :]: 16-byte loads, 12 per 48-lane row;
//   col    out[r] = a[r, col[r]]: one thread per row;
//   lane   o[f, l] = t[f, i[f, l]] (A, B, B2): the (8, W) table staged in
//          shared memory (4 KB for A, 32 KB for B and B2);
//   sub    o[s, l] = t[i[s, l], l] (C): the (512, 128) table (256 KB, more
//          than one SM's shared memory) read from device memory;
//   flat   o = flat[i] (E);
//   chain  100 rounds of A on a shared-memory accumulator, a barrier
//          between rounds (each round reads the whole previous one);
//   sum    acc = sum over s of t[(i + s) % N, l] (C100), added in order of
//          s from zero with __fadd_rn, so it equals the twin bit for bit;
//   onehot (D) ten products onehot(idx) @ t on the tensor cores
//          (mma.sync m16n8k16, bf16 in, f32 accumulation): the one-hot
//          tile is built in registers, t read from device memory. Every
//          partial sum holds one nonzero product (a bf16 value times at
//          most 10), so the result is 10 * t[idx] exactly.
//
// What bounds them on this card: every table is at most 1.6 MB, so the
// bytes take well under a microsecond and each launch is bound by its
// fixed cost (launch, one wave, the chain's 100 barriers). The one-hot
// product is the exception: it does 2 * 256 * N * 96 * 10 operations to
// move 256 * 96 values, bound by the tensor-core rate; it is the TPU's
// workaround, kept to be timed, not a way to gather on this card.
#include "common.cuh"

#include <cstdint>

namespace tbvh {
namespace {

constexpr int kThreads = 256;
constexpr int kF = 8;        // rows of the lane-gather tables (sublanes)
constexpr int kW = 128;      // lanes of the A and chain tables
constexpr int kCta = kF * kW;  // one thread per element of an (8, 128) block

int blocks(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

__global__ void row_gather(const float4* __restrict__ table,
                           const int* __restrict__ idx,
                           float4* __restrict__ out, int R, int C4) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)R * C4) return;
  const int r = (int)(e / C4), q = (int)(e - (long long)r * C4);
  out[e] = table[(long long)idx[r] * C4 + q];
}

__global__ void col_gather(const float* __restrict__ a,
                           const int* __restrict__ col,
                           float* __restrict__ out, int R, int C) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < R) out[r] = a[(long long)r * C + col[r]];
}

// o (kF, OW)[f, l] = t (kF, TW)[f, i[f, l]], the table in shared memory.
template <int TW>
__global__ void __launch_bounds__(kCta)
lane_gather(const float* __restrict__ t, const int* __restrict__ i,
            float* __restrict__ o, int OW) {
  __shared__ float tab[kF * TW];
  for (int e = threadIdx.x; e < kF * TW; e += kCta) tab[e] = t[e];
  __syncthreads();
  for (int e = threadIdx.x; e < kF * OW; e += kCta)
    o[e] = tab[(e / OW) * TW + i[e]];
}

__global__ void sublane_gather(const float* __restrict__ t,
                               const int* __restrict__ i,
                               float* __restrict__ o, int S, int W) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < S * W) o[e] = t[(long long)i[e] * W + e % W];
}

__global__ void flat_take(const float* __restrict__ flat,
                          const int* __restrict__ i, float* __restrict__ o,
                          int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) o[e] = flat[i[e]];
}

// `rounds` chained lane gathers of an (8, 128) accumulator by the same
// indices: acc[f, l] <- acc[f, i[f, l]], one thread per element.
__global__ void __launch_bounds__(kCta)
chain_gather(const float* __restrict__ t, const int* __restrict__ i,
             float* __restrict__ o, int rounds) {
  __shared__ float acc[2][kCta];
  const int e = threadIdx.x;
  const int src = (e / kW) * kW + i[e];
  acc[0][e] = t[e];
  __syncthreads();
  int cur = 0;
  for (int r = 0; r < rounds; ++r) {
    acc[cur ^ 1][e] = acc[cur][src];
    cur ^= 1;
    __syncthreads();
  }
  o[e] = acc[cur][e];
}

// o[s, l] = sum over s' < rounds of t[(i[s, l] + s') % N, l], in order of
// s' from zero, each add rounded on its own.
__global__ void sum_gather(const float* __restrict__ t,
                           const int* __restrict__ i, float* __restrict__ o,
                           int S, int W, int N, int rounds) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= S * W) return;
  const int l = e % W, base = i[e];
  float acc = 0.f;
  for (int s = 0; s < rounds; ++s)
    acc = __fadd_rn(acc, t[(long long)((base + s) % N) * W + l]);
  o[e] = acc;
}

// o (M, F) f32 = sum over `reps` of onehot(idx) (M, N) @ t (N, F) bf16 on
// the tensor cores. One warp per 16 x 8 output tile; the one-hot A
// fragment is compared into registers, B read from device memory.
__global__ void onehot_matmul(const unsigned short* __restrict__ t,
                              const int* __restrict__ idx,
                              float* __restrict__ o, int M, int N, int F,
                              int reps) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int n_tiles = F / 8;
  if (warp >= (M / 16) * n_tiles) return;
  const int m0 = (warp / n_tiles) * 16, n0 = (warp % n_tiles) * 8;
  const int id_lo = idx[m0 + g], id_hi = idx[m0 + g + 8];
  constexpr unsigned short kOne = 0x3f80;  // 1.0 in bf16
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  for (int rep = 0; rep < reps; ++rep) {
    for (int k0 = 0; k0 < N; k0 += 16) {
      const int k = k0 + 2 * c;
      unsigned a[4];
      a[0] = pack_bf16x2(id_lo == k ? kOne : 0, id_lo == k + 1 ? kOne : 0);
      a[1] = pack_bf16x2(id_hi == k ? kOne : 0, id_hi == k + 1 ? kOne : 0);
      a[2] = pack_bf16x2(id_lo == k + 8 ? kOne : 0,
                         id_lo == k + 9 ? kOne : 0);
      a[3] = pack_bf16x2(id_hi == k + 8 ? kOne : 0,
                         id_hi == k + 9 ? kOne : 0);
      const unsigned short* tc = t + (long long)k * F + n0 + g;
      unsigned b[2];
      b[0] = pack_bf16x2(tc[0], tc[F]);
      b[1] = pack_bf16x2(tc[8 * F], tc[9 * F]);
      mma_bf16_m16n8k16(d, a, b);
    }
  }
  float* out = o + (long long)(m0 + g) * F + n0 + 2 * c;
  out[0] = d[0];
  out[1] = d[1];
  out[8 * F] = d[2];
  out[8 * F + 1] = d[3];
}

int launched() { return (int)cudaGetLastError(); }

}  // namespace
}  // namespace tbvh

// Every entry: device pointers, the shape, the stream; returns a
// cudaError_t (0 when the launch was taken). Shapes are checked by the
// wrappers (probes/gather.py); indices must lie inside their tables.

// table (M, C) f32 with C % 4 == 0 and 16-byte rows, idx (R,) -> (R, C).
extern "C" int tbvh_gather_row(const float* table, const int* idx,
                               float* out, int R, int C, void* stream) {
  if (R <= 0 || C <= 0 || C % 4 ||
      reinterpret_cast<std::uintptr_t>(table) % 16 ||
      reinterpret_cast<std::uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const int C4 = C / 4;
  tbvh::row_gather<<<tbvh::blocks((long long)R * C4, tbvh::kThreads),
                     tbvh::kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(table), idx,
      reinterpret_cast<float4*>(out), R, C4);
  return tbvh::launched();
}

// a (R, C) f32, col (R,) -> (R,).
extern "C" int tbvh_gather_col(const float* a, const int* col, float* out,
                               int R, int C, void* stream) {
  if (R <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  tbvh::col_gather<<<tbvh::blocks(R, tbvh::kThreads), tbvh::kThreads, 0,
                     (cudaStream_t)stream>>>(a, col, out, R, C);
  return tbvh::launched();
}

// t (8, TW) f32 with TW 128 or 1024, i (8, OW) -> (8, OW).
extern "C" int tbvh_gather_lane(const float* t, const int* i, float* o,
                                int TW, int OW, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (OW <= 0) return (int)cudaErrorInvalidValue;
  if (TW == 128)
    tbvh::lane_gather<128><<<1, tbvh::kCta, 0, s>>>(t, i, o, OW);
  else if (TW == 1024)
    tbvh::lane_gather<1024><<<1, tbvh::kCta, 0, s>>>(t, i, o, OW);
  else
    return (int)cudaErrorInvalidValue;
  return tbvh::launched();
}

// t (N, W) f32, i (S, W) -> (S, W).
extern "C" int tbvh_gather_sublane(const float* t, const int* i, float* o,
                                   int S, int W, void* stream) {
  if (S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  tbvh::sublane_gather<<<tbvh::blocks(S * W, tbvh::kThreads),
                         tbvh::kThreads, 0, (cudaStream_t)stream>>>(
      t, i, o, S, W);
  return tbvh::launched();
}

// flat (N,) f32, i (n,) -> (n,).
extern "C" int tbvh_gather_flat(const float* flat, const int* i, float* o,
                                int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  tbvh::flat_take<<<tbvh::blocks(n, tbvh::kThreads), tbvh::kThreads, 0,
                    (cudaStream_t)stream>>>(flat, i, o, n);
  return tbvh::launched();
}

// t, i, o (8, 128): `rounds` chained lane gathers.
extern "C" int tbvh_gather_chain(const float* t, const int* i, float* o,
                                 int rounds, void* stream) {
  if (rounds < 0) return (int)cudaErrorInvalidValue;
  tbvh::chain_gather<<<1, tbvh::kCta, 0, (cudaStream_t)stream>>>(t, i, o,
                                                                 rounds);
  return tbvh::launched();
}

// t (N, W) f32, i (S, W) in [0, N) -> (S, W): `rounds` shifted sums.
extern "C" int tbvh_gather_sum(const float* t, const int* i, float* o, int S,
                               int W, int N, int rounds, void* stream) {
  if (S <= 0 || W <= 0 || N <= 0 || rounds < 0)
    return (int)cudaErrorInvalidValue;
  tbvh::sum_gather<<<tbvh::blocks(S * W, tbvh::kThreads), tbvh::kThreads, 0,
                     (cudaStream_t)stream>>>(t, i, o, S, W, N, rounds);
  return tbvh::launched();
}

// t (N, F) bf16 bits, idx (M,) -> (M, F) f32: `reps` one-hot products
// summed; M % 16 == 0, N % 16 == 0, F % 8 == 0.
extern "C" int tbvh_gather_onehot(const unsigned short* t, const int* idx,
                                  float* o, int M, int N, int F, int reps,
                                  void* stream) {
  if (M <= 0 || N <= 0 || F <= 0 || M % 16 || N % 16 || F % 8 || reps < 0)
    return (int)cudaErrorInvalidValue;
  const int warps = (M / 16) * (F / 8);
  tbvh::onehot_matmul<<<tbvh::blocks(warps * 32LL, 128), 128, 0,
                        (cudaStream_t)stream>>>(t, idx, o, M, N, F, reps);
  return tbvh::launched();
}
