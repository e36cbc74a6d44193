// Kernel H: the in-kernel gather forms of the TPU gather probes, one CUDA
// kernel per form (see probes/gather.py, which holds the plain twins).
//
// Replaces the TPU kernels of benchmarks/pallas_gather_probe.py (`kernel`,
// `kernel2`) and benchmarks/pallas_gather_probe2.py (`kA`, `kB`, `kB2`,
// `kC`, `kE`, `kA100`, `kC100`, `kD`). On the TPU they asked which
// per-lane gathers Mosaic lowers and what each costs; on the H100 every
// one is an ordinary gather, from shared memory where the table fits and
// from device memory (resident in L2) where it does not:
//   row    out[r] = table[idx[r], :]: a CTA of (row words, rows), one
//          16-byte word a thread where the rows allow it (see below);
//   col    out[r] = a[r, col[r]]: four lanes a row, each loading a
//          32-byte sector of the row with the row's index in the same
//          phase, where the rows are short (see below);
//   lane   o[f, l] = t[f, i[f, l]] (A, B, B2): one row of the table per
//          CTA of a (output slice, row) grid, staged in shared memory with
//          the CTA's indices in the same phase (see below);
//   sub    o[s, l] = t[i[s, l], l] (C): the (512, 128) table (256 KB, more
//          than one SM's shared memory) read from L2 after the index, one
//          output a thread of a (lane slice, index row) grid (see below);
//   flat   o = flat[i] (E): a table of up to 8,192 floats copied whole into
//          each CTA's shared memory with its indices in the same phase,
//          any other read from L2 after the index (see below);
//   chain  A composed 100 times (A100): o[f, l] = t[f, i^100(l)], the
//          index map composed by doubling in shared memory, one warp a
//          row (see below);
//   sum    acc = sum over s of t[(i + s) % N, l] (C100), added in order of
//          s from zero with __fadd_rn, so it equals the twin bit for bit;
//          at the probe's shape its table's 8-column slices staged in
//          shared memory, its 100 loads issued before the adds (see below);
//   onehot (D) ten products onehot(idx) @ t on the tensor cores (wgmma,
//          bf16 in, f32 accumulation), see below.
//
// What bounds them on this card: every table is at most 1.6 MB, so the
// bytes take well under a microsecond and each launch is bound by its
// fixed cost (launch, one wave) plus its dependent chain: A100's
// composition steps, C100's 100 dependent adds. `tbvh_gather_empty`
// times the launch alone.
//
// The one-hot form (D) is the TPU's workaround for a gather, kept to time
// the method: o (M, F) f32 = sum over 10 reps of onehot(idx) (M, N) @ t
// (N, F) bf16, F = 96. Its result is exactly 10 * t[idx], but the method
// is 2 * 10 * M * N * F bf16 operations (4 G at N = 8,192), so what bounds
// it is the tensor cores' bf16 rate. The design keeps every product on
// the tensor cores over the full N (no one-hot fragment is skipped, the
// ten are not folded into a scale) and spreads them over the card:
//  - the grid splits N into slabs of 64 rows of t and M into blocks of
//    64 rows: N / 64 x M / 64 CTAs of one warpgroup (128 at N = 2,048, 512
//    at 8,192), so every SM has work;
//  - a CTA stages its slab (12 KB) once into shared memory by 16-byte
//    cp.async, already in the layout wgmma reads without swizzle: 8 x 8
//    core matrices of 128 contiguous bytes (8 rows of t, 8 columns each),
//    K-adjacent ones 128 B apart, N-adjacent ones 64 x 16 B apart. A TMA
//    tensor map would write the same 12 KB from one thread, but the copy
//    is a small part of the CTA's time and cp.async needs no tensor map
//    encoded on the host;
//  - the one-hot A fragments are compared into registers from idx once
//    (the same for all ten reps), and each rep issues one wgmma
//    m64n96k16 per 16 rows of the slab with B read from shared memory in
//    its transposed (N-major) form: t is (N, F) row-major. All 10 x 4
//    products of a CTA run back to back on one accumulator, one commit,
//    one wait;
//  - the CTAs' partial sums are combined exactly without atomics: for a
//    row whose index lies in another slab every one-hot entry of this
//    slab is zero, so this slab's partial is exactly +0 (t is finite) and
//    adds nothing; each CTA stores the rows whose index lies in its slab,
//    and every output row has exactly one such CTA. Within it each
//    product has one nonzero term (1 x a bf16 value), and k * v for k <=
//    10 needs at most 12 significand bits, so every partial sum is exact
//    in any order and the result equals the plain twin bit for bit.
#include "common.cuh"

#include <cstdint>

namespace tbvh {
namespace {

constexpr int kThreads = 256;
constexpr int kF = 8;        // rows of the lane-gather tables (sublanes)
constexpr int kW = 128;      // lanes of the A and chain tables

int blocks(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
}

// ---- row: whole rows by index ----------------------------------------------
//
// out (R, C)[r, :] = table (M, C)[idx[r], :], any shape. A CTA of (x, y)
// threads copies y rows, x words a row: the row's index, then its words
// from L2, then the stores; no division, two dependent round trips. Three
// paths, chosen by the C entry from the shape (its `path` can force one):
//   rows (C % 4 == 0, C <= kRowMaxC, table and out 16-byte aligned, M * C
//     and R * C below 2^31): one 16-byte word a thread, 32-bit offsets;
//     (12, 21) CTAs, 196 of them, at the probe's (8192, 48) by 4,096;
//   general, any other shape: one float a thread, 64-bit offsets, (47, 5)
//     CTAs at 47 columns; rows past kRowThreads floats loop;
//   earlier (forced only): one 16-byte word a thread of a 1-D grid, its
//     row by a 64-bit divide, kept so that phase 14 times it beside the
//     rows path.
// On an H100 80GB HBM3 at 700 W (one CUDA graph of 200 launches; PERF.md,
// Findings) the rows path took 0.001628-0.001646 ms of device time at the
// probe's shape against 0.001692-0.001720 for the earlier design, and
// 0.03775-0.03780 ms at 262,144 indices into 1,048,576 rows (201 MB, four
// times L2) against 0.03810-0.03815: 76% of that shape's byte bound, the
// rest DRAM's own cost for 192-byte rows picked at random. Rejected:
// CTAs of 120 or 504 threads (0.00164, 0.00166); a warp per 8, 16 or 32
// rows (one index load a lane, the row's index by a shuffle, every load
// before the stores) 0.00167-0.00221, slower the fewer its warps; whole
// rows copied into shared memory by `cp.async.bulk` on one mbarrier and
// stored by one bulk store 0.00205-0.00253 (0.0373 at the large shape).
constexpr int kRowThreads = 256;
constexpr int kRowMaxC = 4 * kRowThreads;  // floats of a row, rows path

template <typename V, typename Off, bool kWide>
__global__ void __launch_bounds__(kRowThreads)
row_gather(const V* __restrict__ table, const int* __restrict__ idx,
           V* __restrict__ out, int R, int n) {  // n words a row
  const Off r = (Off)blockIdx.x * blockDim.y + threadIdx.y;
  if (r >= R) return;
  const Off src = (Off)idx[r] * n, dst = r * n;
  // blockDim.x = min(n, kRowThreads): every thread has a word; only a row
  // of more words (kWide) loops, since a loop, even one never taken
  // again, cost the rows path 0.00006 ms at the probe's shape
  Off q = threadIdx.x;
  out[dst + q] = table[src + q];
  if (kWide)
    for (q += blockDim.x; q < n; q += blockDim.x)
      out[dst + q] = table[src + q];
}

// The CTA of a row of n words: min(n, kRowThreads) words by as many rows
// as make kRowThreads threads (at least one).
dim3 row_block(int n) {
  const int x = n < kRowThreads ? n : kRowThreads;
  return dim3(x, x < kRowThreads ? kRowThreads / x : 1);
}

template <typename V, typename Off, bool kWide>
void launch_rows(const V* table, const int* idx, V* out, int R, int n,
                 cudaStream_t s) {
  const dim3 block = row_block(n);
  row_gather<V, Off, kWide><<<blocks(R, block.y), block, 0, s>>>(
      table, idx, out, R, n);
}

__global__ void row_gather_earlier(const float4* __restrict__ table,
                                   const int* __restrict__ idx,
                                   float4* __restrict__ out, int R, int C4) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)R * C4) return;
  const int r = (int)(e / C4), q = (int)(e - (long long)r * C4);
  out[e] = table[(long long)idx[r] * C4 + q];
}

// ---- col: one element of each row -----------------------------------------
//
// out (R,)[r] = a (R, C)[r, col[r]]. Two paths, chosen by the C entry from
// the shape:
//   rows (C % 4 == 0, C <= kColRowMax, a 16-byte aligned, R * C <=
//     kColRowFloats): kColLanes lanes a row, lane p loading its 32-byte
//     sector of the row (16-byte words 2p and 2p + 1) while it loads
//     col[r] (one address for the row's lanes); the lane whose words hold
//     column col[r] picks the word, then the float, by selects (no dynamic
//     register index, no local memory) and stores. One L2 round trip, no
//     shared memory, no barrier; CTAs of 128 threads, 32 rows each (128
//     CTAs at the probe's (4096, 32));
//   general, any other shape: one thread a row, col[r], then a[r, col[r]]
//     from L2: two dependent round trips, one 32-byte sector a row.
// On an H100 80GB HBM3 at 700 W the rows path took 0.001409-0.001415 ms of
// device time at the probe's shape, the general one 0.001488. It reads the
// whole row, four times the sectors the general one reads, so the rows
// path stops at a megabyte of rows: at 12,288 rows of 32 the two tie
// (0.001538-0.001541 against 0.001533-0.001543), at 16,384 the general one
// leads (0.001572-0.001583 against 0.001608-0.001613), at 131,072 by far
// (0.002430 against 0.003596). Rejected: one thread a row holding its whole row in
// registers, 0.001648-0.002321 (32 lines a warp instruction); 8 or 2 lanes
// a row 0.001411 / 0.001585; the rows staged in shared memory by cp.async
// with their indices, 0.001475 (PERF.md, Findings).
constexpr int kColRowMax = 32;      // floats of a row on the rows path
constexpr int kColLanes = 4;        // lanes a row
constexpr int kColWords = kColRowMax / 4 / kColLanes;  // 16-byte words a lane
constexpr int kColThreads = 128;
constexpr long long kColRowFloats = 1 << 18;  // rows path: a's floats (1 MB)

__global__ void __launch_bounds__(kColThreads)
col_gather_rows(const float* __restrict__ a, const int* __restrict__ col,
                float* __restrict__ out, int R, int C4) {
  const long long g = (long long)blockIdx.x * kColThreads + threadIdx.x;
  const int r = (int)(g / kColLanes), part = (int)(g % kColLanes);
  if (r >= R) return;
  const int k = col[r];
  const float4* row = reinterpret_cast<const float4*>(a) + (long long)r * C4;
  float4 w[kColWords];
#pragma unroll
  for (int p = 0; p < kColWords; ++p) {
    const int j = part * kColWords + p;
    w[p] = j < C4 ? row[j] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // the index and the words load in one phase: the empty asm needs both
  // (a load used only under the branch below may otherwise sink into it,
  // behind the index)
#pragma unroll
  for (int p = 0; p < kColWords; ++p)
    asm volatile("" ::"r"(k), "f"(w[p].x), "f"(w[p].y), "f"(w[p].z),
                 "f"(w[p].w));
  const int j = k >> 2;
  if (j / kColWords != part) return;
  float4 x = w[0];
#pragma unroll
  for (int p = 1; p < kColWords; ++p)
    if (j % kColWords == p) x = w[p];
  const int c = k & 3;
  out[r] = c == 0 ? x.x : c == 1 ? x.y : c == 2 ? x.z : x.w;
}

__global__ void col_gather(const float* __restrict__ a,
                           const int* __restrict__ col,
                           float* __restrict__ out, int R, int C) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < R) out[r] = a[(long long)r * C + col[r]];
}

// ---- A: lane gathers of an (8, 128) table -------------------------------
//
// o (kF, OW)[f, l] = t (kF, kW)[f, i[f, l]]. A few KB move, so a launch is
// bound by its fixed cost and its dependent chain, not by bytes. The grid
// is (OW / 128 slices, 8 rows), one output a thread: 8 CTAs of 128 threads
// at the probe's shape (OW = 128). A CTA stages its row (512 B, one scalar
// load a thread, so t needs no alignment) while the same thread's index
// load is in flight: one L2 round trip, a barrier over 4 warps, a shared
// lookup and a coalesced store. The last slice may be partial: its threads
// past OW stage their lane of the row and store nothing. On an H100 80GB
// HBM3 at 700 W this took 0.001185 ms of device time at the probe's shape.
// Rejected: one warp a (row, 32 outputs) taking t[f, k] from lane k / 4's
// float4 by four shuffles, no shared memory and no barrier, 0.001216 with
// four warps a CTA and 0.001252-0.001265 with one; the row staged by 32
// 16-byte loads 0.001227; one CTA of 1,024 threads for the whole table,
// its index loads after its barrier, 0.001646 (PERF.md, Findings).
__global__ void __launch_bounds__(kW)
lane_gather(const float* __restrict__ t, const int* __restrict__ i,
            float* __restrict__ o, int OW) {
  __shared__ float row[kW];
  const int f = blockIdx.y;
  const int l = blockIdx.x * kW + threadIdx.x;
  const bool live = l < OW;
  const long long e = (long long)f * OW + l;
  const int k = live ? i[e] : 0;
  row[threadIdx.x] = t[f * kW + threadIdx.x];
  __syncthreads();
  if (live) o[e] = row[k];
}

// ---- B, B2: lane gathers of an (8, 1024) table ---------------------------
//
// o (kF, OW)[f, l] = t (kF, 1024)[f, i[f, l]]. A few KB move, so a launch
// is bound by its fixed cost and its dependent chain, not by bytes. The
// grid is (OW / 256 slices, 8 rows), one output a thread: 32 CTAs for B
// (OW = 1,024), 8 for B2 (OW = 128). A CTA stages only its row (4 KB, one
// 16-byte load a thread; rows are 4,096 B apart, so each is aligned when t
// is) and loads its own index in the same phase, so the chain is one L2
// round trip, one barrier, a shared lookup and a coalesced store. The last
// slice may be partial: its threads past OW stage their part of the row
// and store nothing. Reading t[f, i] from L2 after the index instead (no
// staging, two dependent round trips) took 1.08-1.12x as long at both
// shapes, and one CTA staging the whole 32 KB table 1.6-2.2x (PERF.md,
// Findings).
constexpr int kLaneRow = 1024;               // lanes of the B and B2 tables
constexpr int kLaneThreads = kLaneRow / 4;   // one float4 of the row a thread

__global__ void __launch_bounds__(kLaneThreads)
lane_gather_row(const float* __restrict__ t, const int* __restrict__ i,
                float* __restrict__ o, int OW) {
  __shared__ __align__(16) float row[kLaneRow];
  const int f = blockIdx.y;
  const int l = blockIdx.x * kLaneThreads + threadIdx.x;
  const bool live = l < OW;
  const long long e = (long long)f * OW + l;
  const int k = live ? i[e] : 0;
  reinterpret_cast<float4*>(row)[threadIdx.x] =
      reinterpret_cast<const float4*>(t + f * kLaneRow)[threadIdx.x];
  __syncthreads();
  if (live) o[e] = row[k];
}

// ---- C: sublane gathers of an (N, W) table --------------------------------
//
// o (S, W)[s, l] = t (N, W)[i[s, l], l], any shape: the index, then
// t[i, l] from L2, two dependent round trips, on a (W / 128 lane slices,
// S index rows) grid of 128 threads, one output a thread (8 CTAs at the
// probe's (512, 128), S = 8), index rows past 65,535 split evenly over
// grid z: no loop, no runtime division, 64-bit offsets. On 65,543 index
// rows the count of CTAs sets the time, not idle lanes: W = 1 and W = 128
// took the same time, and halving the CTAs halved it (0.0809 -> 0.0416
// ms at W = 128); no caller sends so many.
// On an H100 80GB HBM3 at 700 W the grid took 0.001367-0.001375 ms of
// device time at the probe's shape against 0.001428 for the earlier form
// (a 1-D grid over the outputs, the lane by a runtime `%`, a 32-bit
// `S * W`), and was the fastest form at every shape timed (N 100 to 4,096,
// S 1 to 32). The indices range over all N rows, so staging the table
// costs a CTA one L2 line a row: rejected, column slices staged by
// cp.async with the indices (2, 4 or 8 columns a CTA, 0.00155-0.00186),
// and row blocks staged with every index of their slice, each output
// stored by the CTA that holds its row (0.00147-0.00163); the grid looping
// over index rows instead of grid z 0.001418-0.001428 (PERF.md, Findings).
constexpr int kSubThreads = 128;
constexpr int kGridYMax = 65535;

__global__ void __launch_bounds__(kSubThreads)
sublane_gather(const float* __restrict__ t, const int* __restrict__ i,
               float* __restrict__ o, int S, int W) {
  const int l = blockIdx.x * kSubThreads + threadIdx.x;
  const long long s = (long long)blockIdx.z * gridDim.y + blockIdx.y;
  if (l >= W || s >= S) return;
  const long long e = s * W + l;
  o[e] = t[(long long)i[e] * W + l];
}

// ---- E: flat take --------------------------------------------------------
//
// o = flat (N,)[i], n outputs of any index shape, one a thread in CTAs of
// 256. Two paths, chosen by the C entry from the shape:
//   staged (N <= kFlatStageMax, N % 4 == 0, flat 16-byte aligned, and the
//     CTAs' copies together at most kFlatStageCopies floats): each CTA
//     copies the whole table into dynamic shared memory (N * 4 B) by
//     16-byte cp.async, N / 1,024 a thread (2 at the probe's N = 2,048)
//     as straight-line predicated copies, while the thread's index load
//     is in flight; then one barrier, a shared lookup and a coalesced
//     store: one L2 round trip on the chain;
//   general, any other shape: the index, then flat[i] from L2, two
//     dependent round trips.
// On an H100 80GB HBM3 at 700 W the staged path took 0.001290 ms of device
// time at the probe's shape and the general one 0.001380. Rejected: CTAs
// of 128 threads (4 copies a thread, twice the copies) 0.001322, of 512
// 0.001308; the copies as a runtime loop 0.001296 (0.001394 against
// 0.001361 at N = 8,192); 16-byte loads into registers, then shared
// stores, 0.001307. The copies grow with the CTAs: the two paths came
// within 4% of each other at 16 MB in all (131,072 outputs of 8,192
// floats), and at 32 MB (1,048,576 of 2,048) the staged form took 1.54x
// the general one (PERF.md, Findings).
constexpr int kFlatStageMax = 8192;          // floats a CTA stages (32 KB)
constexpr int kFlatCopies = kFlatStageMax / 4 / kThreads;  // a thread's most
constexpr long long kFlatStageCopies = 1 << 22;  // floats all CTAs copy

__global__ void __launch_bounds__(kThreads)
flat_take_staged(const float* __restrict__ flat, const int* __restrict__ i,
                 float* __restrict__ o, int n, int N) {
  extern __shared__ __align__(16) float tab[];
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int k = e < n ? i[e] : 0;
#pragma unroll
  for (int u = 0; u < kFlatCopies; ++u) {
    const int q = threadIdx.x + u * kThreads;
    if (q < N / 4) cp_async16(tab + 4 * q, flat + 4 * q);
  }
  // the index is loaded while the copies fly: the empty asm needs it
  // before the wait (a load of read-only data may otherwise sink below it)
  asm volatile("" ::"r"(k));
  cp_async_wait_all();
  __syncthreads();
  if (e < n) o[e] = tab[k];
}

__global__ void flat_take(const float* __restrict__ flat,
                          const int* __restrict__ i, float* __restrict__ o,
                          int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) o[e] = flat[i[e]];
}

// ---- A100: `rounds` chained lane gathers of an (8, 128) block ----------
//
// acc <- t, then `rounds` times acc[f, l] <- acc[f, i[f, l]], with t and i
// fixed: o[f, l] = t[f, i^R(l)], R = rounds, where i^R is row f's index
// map composed R times. Only indices are composed and one float is read,
// so any order of composition gives the twin's bits. One warp a row (a
// CTA each), 4 lanes of the row a thread; the row's map and values sit in
// shared memory, and a warp needs no block-wide barrier. The map is
// composed by doubling: r <- id, p <- i; for each bit of R from the
// lowest, r <- p o r where the bit is set, then p <- p o p: 6 squarings
// and 3 applications for R = 100 (64 + 32 + 4), each a shared load of the
// thread's own 4 lanes and, for p, a store behind __syncwarp (p's two
// halves alternate, so a squaring never overwrites what another lane
// still reads). Each lane following its own chain of R dependent shared
// loads instead took twice as long at R = 100 (PERF.md, Findings).
constexpr int kChainK = kW / 32;  // lanes of a row a thread holds

__global__ void __launch_bounds__(32)
chain_gather(const float* __restrict__ t, const int* __restrict__ i,
             float* __restrict__ o, int rounds) {
  __shared__ int pw[2][kW];
  __shared__ float row[kW];
  const int lane = threadIdx.x;
  const int base = blockIdx.x * kW;
  int r[kChainK], p[kChainK];
#pragma unroll
  for (int k = 0; k < kChainK; ++k) {
    const int l = lane + 32 * k;
    p[k] = i[base + l];
    row[l] = t[base + l];
    pw[0][l] = p[k];
    r[k] = l;
  }
  __syncwarp();
  int cur = 0;
  for (unsigned n = rounds; n != 0;) {
    if (n & 1u)
#pragma unroll
      for (int k = 0; k < kChainK; ++k) r[k] = pw[cur][r[k]];
    n >>= 1;
    if (n == 0) break;
#pragma unroll
    for (int k = 0; k < kChainK; ++k) p[k] = pw[cur][p[k]];
#pragma unroll
    for (int k = 0; k < kChainK; ++k) pw[cur ^ 1][lane + 32 * k] = p[k];
    cur ^= 1;
    __syncwarp();
  }
#pragma unroll
  for (int k = 0; k < kChainK; ++k) o[base + lane + 32 * k] = row[r[k]];
}

// ---- C100: `rounds` shifted sublane gathers, summed ---------------------
//
// o[s, l] = sum over s' < rounds of t[(i[s, l] + s') % N, l], added in
// order of s' from zero, each add rounded on its own (__fadd_rn), as the
// twin adds. The adds are one dependent chain a thread (~4 cycles each);
// the loads are not, so all of them are issued before the adds. Two
// paths, chosen by the C entry from the shape:
//   staged, at the probe's R = 100 (kSumR; N >= R, W % 8 == 0, N <= 1024,
//     at most 32 index rows, t 16-byte aligned): CTA x stages columns
//     [8x, 8x + 8) of every row (one 32-byte sector a row) into shared
//     memory by 16-byte cp.async, rows 0 .. R - 1 again after row N - 1
//     (19.6 KB at N = 512), so no window wraps; the 100 loads, unrolled at
//     compile time, are shared loads at constant offsets, all in flight
//     before the 100 adds; W / 8 = 16 CTAs of 256 threads at the probe's
//     shape, one output a thread;
//   general, any other shape and R: one warp a CTA reads its rows from
//     device memory (L2), in batches of 16 loads before their adds, a
//     compare a row for the wrap (`%` where R > N).
// Reading the probe's 100 rows from L2, all unrolled and in flight, took
// 1.5x the staged time (PERF.md, Findings).
constexpr int kSumR = 100;          // the probe's rounds, unrolled
constexpr int kSumBatch = 16;       // loads before their adds, general path
constexpr int kSumCols = 8;         // columns a staged CTA holds
constexpr int kSumMaxN = 1024;      // rows a staged CTA holds (+ kSumR)
constexpr int kSumThreads = 256;    // a staged CTA
constexpr int kSumGenThreads = 32;  // a general CTA

// Row base + s of N (base in [0, N)): one compare when s < N.
__device__ __forceinline__ int wrap_row(int base, int s, int N, bool once) {
  const int r = base + s;
  return once ? (r >= N ? r - N : r) : r % N;
}

// Sum over s < R of col[(base + s) * stride], a table whose rows repeat
// past N - 1.
template <int R>
__device__ __forceinline__ float fixed_sum(const float* col, int stride,
                                           int base) {
  float v[R];
#pragma unroll
  for (int s = 0; s < R; ++s) v[s] = col[(base + s) * stride];
  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < R; ++s) acc = __fadd_rn(acc, v[s]);
  return acc;
}

// The same at any `rounds`, rows (base + s) % N, in batches of kSumBatch.
__device__ __forceinline__ float any_sum(const float* col, int stride,
                                         int base, int N, int rounds) {
  const bool once = rounds <= N;
  float acc = 0.f;
  for (int s0 = 0; s0 < rounds; s0 += kSumBatch) {
    float v[kSumBatch];
#pragma unroll
    for (int k = 0; k < kSumBatch; ++k)
      if (s0 + k < rounds) v[k] = col[wrap_row(base, s0 + k, N, once) * stride];
#pragma unroll
    for (int k = 0; k < kSumBatch; ++k)
      if (s0 + k < rounds) acc = __fadd_rn(acc, v[k]);
  }
  return acc;
}

__global__ void __launch_bounds__(kSumGenThreads)
sum_gather_general(const float* __restrict__ t, const int* __restrict__ i,
                   float* __restrict__ o, int S, int W, int N, int rounds) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < S * W) o[e] = any_sum(t + e % W, W, i[e], N, rounds);
}

// CTA x: columns [8x, 8x + 8) of every row as tab[row][8], rows 0 .. R - 1
// staged again after row N - 1; rounds == R <= N and S * 8 <= kSumThreads
// (one output a thread).
template <int R>
__global__ void __launch_bounds__(kSumThreads)
sum_gather_staged(const float* __restrict__ t, const int* __restrict__ i,
                  float* __restrict__ o, int S, int W, int N) {
  __shared__ __align__(16) float tab[(kSumMaxN + R) * kSumCols];
  const int c0 = blockIdx.x * kSumCols;
  const int n_out = S * kSumCols;
  auto out_index = [&](int e) {
    return (e / kSumCols) * W + c0 + e % kSumCols;
  };
  // the first output's index, loaded while the copies fly: the empty asm
  // needs it before the wait (a load of read-only data may otherwise sink
  // below it)
  const int base = threadIdx.x < n_out ? i[out_index(threadIdx.x)] : 0;
  for (int q = threadIdx.x; q < (N + R) * 2; q += kSumThreads) {
    const int row = q >> 1;
    cp_async16(tab + q * 4, t + (long long)(row < N ? row : row - N) * W +
                                c0 + (q & 1) * 4);
  }
  asm volatile("" ::"r"(base));
  cp_async_wait_all();
  __syncthreads();
  if (threadIdx.x < n_out)
    o[out_index(threadIdx.x)] =
        fixed_sum<R>(tab + threadIdx.x % kSumCols, kSumCols, base);
}

__global__ void empty_kernel() {}

constexpr int kOhF = 96;     // columns of t and of the output (wgmma N)
constexpr int kOhSlab = 64;  // rows of t a CTA stages: 4 k-steps of 16
constexpr int kOhKs = kOhSlab / 16;
constexpr int kOhM = 64;     // output rows a CTA: one warpgroup's wgmma M

// wgmma operand descriptor of shared memory at p without swizzle: lbo the
// bytes between core matrices adjacent in K, sbo in M or N.
__device__ __forceinline__ uint64_t smem_desc(const void* p, unsigned lbo,
                                              unsigned sbo) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d (64 x 96 f32, the warpgroup's accumulator) += A (64 x 16 bf16, this
// thread's fragment a, laid out per warp as mma.sync m16n8k16's) @ B (16 x
// 96 bf16 at desc, N-major: imm-trans-b = 1). Thread (warp w, g = lane /
// 4, c = lane % 4) holds d[4j + {0, 1}] = D[16w + g][8j + 2c + {0, 1}]
// and d[4j + {2, 3}] = D[16w + g + 8][8j + 2c + {0, 1}].
__device__ __forceinline__ void wgmma_m64n96k16(float (&d)[48],
                                                const unsigned (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// o (M, F) f32 = sum over `reps` of onehot(idx) (M, N) @ t (N, F) bf16 on
// the tensor cores: CTA (x, y) stages rows [64x, 64x + 64) of t and runs
// output rows [64y, 64y + 64); it stores the rows whose index lies in its
// slab (the note at the head of this file says why that is exact).
__global__ void __launch_bounds__(128)
onehot_wgmma(const unsigned short* __restrict__ t, const int* __restrict__ idx,
             float* __restrict__ o, int N, int reps) {
  __shared__ __align__(128) unsigned short slab[kOhSlab * kOhF];
  const int n0 = blockIdx.x * kOhSlab;
  const int rows = min(kOhSlab, N - n0);  // a multiple of 16
  const int tid = threadIdx.x;
  // row k, columns 8nb..8nb+7 of the slab -> core matrix (k / 8, nb), row
  // k % 8: element (nb * kOhSlab + k) * 8
  for (int e = tid; e < rows * (kOhF / 8); e += 128) {
    const int k = e / (kOhF / 8), nb = e - k * (kOhF / 8);
    cp_async16(slab + (nb * kOhSlab + k) * 8,
               t + (long long)(n0 + k) * kOhF + nb * 8);
  }
  cp_async_wait_all();
  // the copies (generic proxy) must be visible to wgmma (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int r_lo = blockIdx.y * kOhM + warp * 16 + g, r_hi = r_lo + 8;
  const int id_lo = idx[r_lo] - n0, id_hi = idx[r_hi] - n0;
  constexpr unsigned short kOne = 0x3f80;  // 1.0 in bf16
  unsigned a[kOhKs][4];
#pragma unroll
  for (int ks = 0; ks < kOhKs; ++ks) {
    const int k = ks * 16 + 2 * c;
    a[ks][0] = pack_bf16x2(id_lo == k ? kOne : 0, id_lo == k + 1 ? kOne : 0);
    a[ks][1] = pack_bf16x2(id_hi == k ? kOne : 0, id_hi == k + 1 ? kOne : 0);
    a[ks][2] = pack_bf16x2(id_lo == k + 8 ? kOne : 0,
                           id_lo == k + 9 ? kOne : 0);
    a[ks][3] = pack_bf16x2(id_hi == k + 8 ? kOne : 0,
                           id_hi == k + 9 ? kOne : 0);
  }
  float d[48];
#pragma unroll
  for (int i = 0; i < 48; ++i) d[i] = 0.f;
  // K-adjacent core matrices 128 B apart, N-adjacent kOhSlab * 16 B
  const uint64_t desc = smem_desc(slab, 128, kOhSlab * 16);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  for (int rep = 0; rep < reps; ++rep) {
#pragma unroll
    for (int ks = 0; ks < kOhKs; ++ks)
      // k-step ks: core-matrix rows 2ks, 2ks + 1 (256 B further)
      if (ks * 16 < rows) wgmma_m64n96k16(d, a[ks], desc + ks * (256 >> 4));
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

  const bool own_lo = id_lo >= 0 && id_lo < rows;
  const bool own_hi = id_hi >= 0 && id_hi < rows;
  float* out_lo = o + (long long)r_lo * kOhF + 2 * c;
  float* out_hi = o + (long long)r_hi * kOhF + 2 * c;
#pragma unroll
  for (int j = 0; j < kOhF / 8; ++j) {
    if (own_lo)
      *reinterpret_cast<float2*>(out_lo + 8 * j) =
          make_float2(d[4 * j], d[4 * j + 1]);
    if (own_hi)
      *reinterpret_cast<float2*>(out_hi + 8 * j) =
          make_float2(d[4 * j + 2], d[4 * j + 3]);
  }
}

int launched() { return (int)cudaGetLastError(); }

}  // namespace
}  // namespace tbvh

// Every entry: device pointers, the shape, the stream; returns a
// cudaError_t (0 when the launch was taken). Shapes are checked by the
// wrappers (probes/gather.py); indices must lie inside their tables.

// The rows path takes these shapes (see above).
static bool row_words_ok(const float* table, const float* out, int M,
                         int R, int C) {
  return C % 4 == 0 && C <= tbvh::kRowMaxC &&
         reinterpret_cast<std::uintptr_t>(table) % 16 == 0 &&
         reinterpret_cast<std::uintptr_t>(out) % 16 == 0 &&
         (long long)M * C <= tbvh::kI32Max &&
         (long long)R * C <= tbvh::kI32Max;
}

// table (M, C) f32, idx (R,) in [0, M) -> out (R, C): by the rows path
// where the shape allows it, else by the general one (`path` 0); `path` 1
// forces the general path, 2 the earlier design (the rows path's shapes
// only).
extern "C" int tbvh_gather_row(const float* table, const int* idx,
                               float* out, int M, int R, int C, int path,
                               void* stream) {
  const bool words = row_words_ok(table, out, M, R, C);
  if (M <= 0 || R <= 0 || C <= 0 || path < 0 || path > 2 ||
      (path == 2 && !words))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (path == 0 && words)
    tbvh::launch_rows<float4, int, false>(
        reinterpret_cast<const float4*>(table), idx,
        reinterpret_cast<float4*>(out), R, C / 4, s);
  else if (path < 2 && C <= tbvh::kRowThreads)
    tbvh::launch_rows<float, long long, false>(table, idx, out, R, C, s);
  else if (path < 2)
    tbvh::launch_rows<float, long long, true>(table, idx, out, R, C, s);
  else
    tbvh::row_gather_earlier<<<tbvh::blocks((long long)R * (C / 4),
                                            tbvh::kThreads),
                               tbvh::kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(table), idx,
        reinterpret_cast<float4*>(out), R, C / 4);
  return tbvh::launched();
}

// a (R, C) f32, col (R,) in [0, C) -> (R,): by the rows path where the
// shape allows it (see above), else by the general one.
extern "C" int tbvh_gather_col(const float* a, const int* col, float* out,
                               int R, int C, void* stream) {
  if (R <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (C % 4 == 0 && C <= tbvh::kColRowMax &&
      reinterpret_cast<std::uintptr_t>(a) % 16 == 0 &&
      (long long)R * C <= tbvh::kColRowFloats)
    tbvh::col_gather_rows<<<tbvh::blocks((long long)R * tbvh::kColLanes,
                                         tbvh::kColThreads),
                            tbvh::kColThreads, 0, s>>>(a, col, out, R, C / 4);
  else
    tbvh::col_gather<<<tbvh::blocks(R, tbvh::kThreads), tbvh::kThreads, 0,
                       s>>>(a, col, out, R, C);
  return tbvh::launched();
}

// t (8, TW) f32 with TW 128 or 1024 (then 16-byte aligned), i (8, OW) ->
// (8, OW).
extern "C" int tbvh_gather_lane(const float* t, const int* i, float* o,
                                int TW, int OW, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (OW <= 0) return (int)cudaErrorInvalidValue;
  if (TW == tbvh::kW) {
    const dim3 grid(tbvh::blocks(OW, tbvh::kW), tbvh::kF);
    tbvh::lane_gather<<<grid, tbvh::kW, 0, s>>>(t, i, o, OW);
  } else if (TW == tbvh::kLaneRow &&
             reinterpret_cast<std::uintptr_t>(t) % 16 == 0) {
    const dim3 grid(tbvh::blocks(OW, tbvh::kLaneThreads), tbvh::kF);
    tbvh::lane_gather_row<<<grid, tbvh::kLaneThreads, 0, s>>>(t, i, o, OW);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return tbvh::launched();
}

// t (N, W) f32, i (S, W) in [0, N) -> (S, W).
extern "C" int tbvh_gather_sublane(const float* t, const int* i, float* o,
                                   int S, int W, void* stream) {
  if (S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const int z = tbvh::blocks(S, tbvh::kGridYMax);
  const dim3 grid(tbvh::blocks(W, tbvh::kSubThreads), tbvh::blocks(S, z), z);
  tbvh::sublane_gather<<<grid, tbvh::kSubThreads, 0, (cudaStream_t)stream>>>(
      t, i, o, S, W);
  return tbvh::launched();
}

// flat (N,) f32, i (n,) in [0, N) -> (n,): by the staged path where the
// shape allows it (see above), else by the general one.
extern "C" int tbvh_gather_flat(const float* flat, const int* i, float* o,
                                int n, int N, void* stream) {
  if (n <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int grid = tbvh::blocks(n, tbvh::kThreads);
  if (N <= tbvh::kFlatStageMax && N % 4 == 0 &&
      reinterpret_cast<std::uintptr_t>(flat) % 16 == 0 &&
      (long long)grid * N <= tbvh::kFlatStageCopies)
    tbvh::flat_take_staged<<<grid, tbvh::kThreads, N * sizeof(float), s>>>(
        flat, i, o, n, N);
  else
    tbvh::flat_take<<<grid, tbvh::kThreads, 0, s>>>(flat, i, o, n);
  return tbvh::launched();
}

// t, i, o (8, 128): `rounds` (>= 0) chained lane gathers.
extern "C" int tbvh_gather_chain(const float* t, const int* i, float* o,
                                 int rounds, void* stream) {
  if (rounds < 0) return (int)cudaErrorInvalidValue;
  tbvh::chain_gather<<<tbvh::kF, 32, 0, (cudaStream_t)stream>>>(t, i, o,
                                                               rounds);
  return tbvh::launched();
}

// t (N, W) f32, i (S, W) in [0, N) -> (S, W): `rounds` (>= 0) shifted
// sums, by the staged path where the shape allows it (see above), else
// by the general one.
extern "C" int tbvh_gather_sum(const float* t, const int* i, float* o, int S,
                               int W, int N, int rounds, void* stream) {
  if (S <= 0 || W <= 0 || N <= 0 || rounds < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (rounds == tbvh::kSumR && N >= rounds && N <= tbvh::kSumMaxN &&
      W % tbvh::kSumCols == 0 && S * tbvh::kSumCols <= tbvh::kSumThreads &&
      reinterpret_cast<std::uintptr_t>(t) % 16 == 0)
    tbvh::sum_gather_staged<tbvh::kSumR>
        <<<W / tbvh::kSumCols, tbvh::kSumThreads, 0, s>>>(t, i, o, S, W, N);
  else
    tbvh::sum_gather_general<<<tbvh::blocks((long long)S * W,
                                            tbvh::kSumGenThreads),
                               tbvh::kSumGenThreads, 0, s>>>(t, i, o, S, W,
                                                             N, rounds);
  return tbvh::launched();
}

// An empty kernel of one warp: the device time of a launch alone.
extern "C" int tbvh_gather_empty(void* stream) {
  tbvh::empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return tbvh::launched();
}

// The resources of the row kernel at C columns (the rows path where C is
// a multiple of 4 up to kRowMaxC, else the general one), of the col
// kernel's rows path, of the sublane kernel, of
// the lane kernel at table width TW (128: A; 1024: B, B2), of the flat
// take's staged path at table length N, of the chain kernel and of the
// sum kernel's staged path (the probe's).
extern "C" int tbvh_gather_row_occupancy(int C, int* out) {
  if (C <= 0) return (int)cudaErrorInvalidValue;
  const bool words = C % 4 == 0 && C <= tbvh::kRowMaxC;
  const dim3 b = tbvh::row_block(words ? C / 4 : C);
  const void* fn =
      words ? reinterpret_cast<const void*>(
                  &tbvh::row_gather<float4, int, false>)
      : C <= tbvh::kRowThreads
          ? reinterpret_cast<const void*>(
                &tbvh::row_gather<float, long long, false>)
          : reinterpret_cast<const void*>(
                &tbvh::row_gather<float, long long, true>);
  return tbvh::kernel_occupancy(fn, b.x * b.y, 0, out);
}

extern "C" int tbvh_gather_col_occupancy(int* out) {
  return tbvh::kernel_occupancy(
      reinterpret_cast<const void*>(&tbvh::col_gather_rows),
      tbvh::kColThreads, 0, out);
}

extern "C" int tbvh_gather_sublane_occupancy(int* out) {
  return tbvh::kernel_occupancy(
      reinterpret_cast<const void*>(&tbvh::sublane_gather),
      tbvh::kSubThreads, 0, out);
}

extern "C" int tbvh_gather_lane_occupancy(int TW, int* out) {
  if (TW == tbvh::kW)
    return tbvh::kernel_occupancy(
        reinterpret_cast<const void*>(&tbvh::lane_gather), tbvh::kW, 0, out);
  if (TW == tbvh::kLaneRow)
    return tbvh::kernel_occupancy(
        reinterpret_cast<const void*>(&tbvh::lane_gather_row),
        tbvh::kLaneThreads, 0, out);
  return (int)cudaErrorInvalidValue;
}

extern "C" int tbvh_gather_flat_occupancy(int N, int* out) {
  if (N <= 0 || N > tbvh::kFlatStageMax) return (int)cudaErrorInvalidValue;
  return tbvh::kernel_occupancy(
      reinterpret_cast<const void*>(&tbvh::flat_take_staged), tbvh::kThreads,
      N * (int)sizeof(float), out);
}

extern "C" int tbvh_gather_chain_occupancy(int* out) {
  return tbvh::kernel_occupancy(
      reinterpret_cast<const void*>(&tbvh::chain_gather), 32, 0, out);
}

extern "C" int tbvh_gather_sum_occupancy(int* out) {
  return tbvh::kernel_occupancy(
      reinterpret_cast<const void*>(&tbvh::sum_gather_staged<tbvh::kSumR>),
      tbvh::kSumThreads, 0, out);
}

// t (N, 96) bf16 bits (16-byte aligned), idx (M,) in [0, N) -> (M, 96)
// f32: `reps` one-hot products summed; M % 64 == 0, N % 16 == 0.
extern "C" int tbvh_gather_onehot(const unsigned short* t, const int* idx,
                                  float* o, int M, int N, int F, int reps,
                                  void* stream) {
  if (M <= 0 || N <= 0 || F != tbvh::kOhF || M % tbvh::kOhM || N % 16 ||
      reps < 0 || reinterpret_cast<std::uintptr_t>(t) % 16)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + tbvh::kOhSlab - 1) / tbvh::kOhSlab, M / tbvh::kOhM);
  tbvh::onehot_wgmma<<<grid, 128, 0, (cudaStream_t)stream>>>(t, idx, o, N,
                                                              reps);
  return tbvh::launched();
}

// The one-hot kernel's resources (see common.cuh kernel_occupancy).
extern "C" int tbvh_gather_onehot_occupancy(int* out) {
  return tbvh::kernel_occupancy(
      reinterpret_cast<const void*>(&tbvh::onehot_wgmma), 128, 0, out);
}
