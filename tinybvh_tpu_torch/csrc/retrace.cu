// Kernel R: the packet path's exact retrace, one thread a ray, depth first
// over the BVH8.
//
// Replaces no TPU kernel. The JAX package runs this engine as XLA array
// ops (tinybvh_tpu/traverse/wavefront.py::intersect_wavefront, a
// level-synchronous frontier of (ray, node) pairs), and the port's plain
// twin is that loop in torch (traverse/wavefront.py): ~90 small ops a
// tree level, a host sync a level, and a frontier capped at wf_cap_factor
// pairs a ray. This kernel takes the design of upstream's GPU traversal
// instead (traverse_cwbvh.cl, traverse.cl: a thread a ray, a short
// stack): every ray of a tile the packet pass flagged is traced again in
// one launch, and its exact hit is written over the packet pass's.
//
// The result is the wavefront's. A ray keeps the least key (t, leaf depth,
// leaf row * 4 + lane), the winner that folding level by level gives: the
// shallowest level that reaches the least t, then the least packed id. A
// child is pruned only where it cannot hold a smaller key: its entry is
// past the best t, or equal to it with every leaf below at least as deep
// as the best one's. The slab test is _slab8's and the leaf test
// core/intersect.py's moller_trumbore, each product and sum rounded on its
// own in torch's order (a sum over an axis of 3 as torch's reduction on
// the card takes it: (x0 + x2) + x1), so t, u and v equal the wavefront's
// bit for bit; u and v come from the winning test, which is the
// wavefront's final re-intersection of its winner, since u and v do not
// depend on the t they are tested against. Micromaps drop a hit whose
// cell is transparent, as omap_cells does. Any hit stops at the first hit
// in (0, t_max). A child at depth MAX_LEVELS (64) that could hold a hit
// is not walked and flags its tile, as the wavefront flags a frontier
// left at that level; a tile no ray of which was cut is cleared in the
// overflow mask.
//
// What bounds it on this card: the visits' dependent loads and their
// instructions. A node visit reads 224 bytes (8 child boxes, 8 child
// words) and a leaf visit 144 (4 triangles), from L2 at the benchmark's
// scene (its 65,536 triangles' tables take ~3 MB of the 50 MB), then ~250
// (node) or ~200 (leaf) instructions that depend on them; a warp runs
// until its longest ray is done. The operation bound counts 235
// operations a node visit (8 slab tests of 6 subtracts, 6 multiplies, 10
// min / max and 5 compares, and 19 compare-exchanges) and 240 a leaf
// visit (4 tests of 24 adds or subtracts, 27 multiplies, a division and
// 8 compares), over the visits the kernel counts.
//
// What the design does about it:
//  - one CTA of 256 threads a tile, a ray a thread: a tile's rays are
//    coherent (camera tiles, or sorted by the coherence sort), so a
//    warp's rays visit much the same nodes and its loads hit the same
//    lines; a tile the packet pass resolved exits at its first
//    instruction, so one launch covers the batch without a host-side
//    list of tiles;
//  - nearest child first (a 19-comparator sorting network on the
//    surviving children's entries), so the best t shrinks early and
//    prunes the rest, which are tested again, against the best key, when
//    they are popped;
//  - the stack in local memory (cached in L1), kStack entries: 7 x 63 + 1
//    hold the deepest stack a tree can ask for, since a node at depth 63
//    or deeper pushes nothing (a node visit pops one entry and pushes at
//    most 8, so the stack never holds more than 7 x depth + 1);
//  - no host round trip and no memset: the counters (visits, leaf
//    visits, deepest stack) sum in registers and go out with one atomic
//    each a warp into a device buffer the caller keeps; the launch's last
//    CTA publishes the sums in the buffer's second half and zeroes the
//    first for the next launch. The kernel allocates nothing.
#include <cstdint>

#include "common.cuh"

namespace tbvh {
namespace {

constexpr int kMaxLevels = 64;           // traverse/wavefront.py MAX_LEVELS
constexpr int kEmptySlot = -2147483647;  // layouts/mbvh.py EMPTY_SLOT
constexpr int kStack = 512;  // traverse/retrace.py STACK
static_assert(kStack >= 7 * (kMaxLevels - 1) + 1,
              "the deepest stack a tree below MAX_LEVELS can ask for");

// (x0 + x2) + x1: torch's (..., 3).sum(-1) on the card, where two threads
// share the three inputs (ATen's Reduce.cuh block width for 3 is 2).
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return __fadd_rn(__fadd_rn(x0, x2), x1);
}

__device__ __forceinline__ float mul_sub(float a, float b, float c,
                                         float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

// core/intersect.py moller_trumbore of one ray against the triangle of
// raw vertices tri = [v0 | v1 | v2] with t_cur = t_max; u and v are set
// whether or not it hits.
__device__ __forceinline__ bool moller_trumbore(const float o[3],
                                                const float d[3],
                                                const float* tri,
                                                float t_max, float& t,
                                                float& u, float& v) {
  float e1[3], e2[3], s[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    e1[k] = __fsub_rn(tri[3 + k], tri[k]);
    e2[k] = __fsub_rn(tri[6 + k], tri[k]);
    s[k] = __fsub_rn(o[k], tri[k]);
  }
  const float hx = mul_sub(d[1], e2[2], d[2], e2[1]);
  const float hy = mul_sub(d[2], e2[0], d[0], e2[2]);
  const float hz = mul_sub(d[0], e2[1], d[1], e2[0]);
  const float det =
      sum3(__fmul_rn(e1[0], hx), __fmul_rn(e1[1], hy), __fmul_rn(e1[2], hz));
  const bool ok = fabsf(det) > 1e-9f;
  const float inv = __fdiv_rn(1.f, ok ? det : 1.f);  // torch's reciprocal
  u = __fmul_rn(
      sum3(__fmul_rn(s[0], hx), __fmul_rn(s[1], hy), __fmul_rn(s[2], hz)),
      inv);
  const float qx = mul_sub(s[1], e1[2], s[2], e1[1]);
  const float qy = mul_sub(s[2], e1[0], s[0], e1[2]);
  const float qz = mul_sub(s[0], e1[1], s[1], e1[0]);
  v = __fmul_rn(
      sum3(__fmul_rn(d[0], qx), __fmul_rn(d[1], qy), __fmul_rn(d[2], qz)),
      inv);
  t = __fmul_rn(sum3(__fmul_rn(e2[0], qx), __fmul_rn(e2[1], qy),
                     __fmul_rn(e2[2], qz)),
                inv);
  return ok && u >= 0.f && v >= 0.f && __fadd_rn(u, v) <= 1.f && t > 0.f &&
         t < t_max;
}

// Whether an entry at `e` whose leaves lie at depth `dep` or deeper can
// hold a smaller key than the best (bt, bd); bd = -1 before any hit, when
// only e < t_max counts. An entry at or past BVH_FAR is a miss (_slab8).
__device__ __forceinline__ bool may_win(float e, int dep, float bt, int bd) {
  return e < kFar && (e < bt || (e == bt && dep <= bd));
}

__device__ __forceinline__ void order2(float& ka, int& wa, float& kb,
                                       int& wb) {
  if (kb < ka) {
    const float k = ka;
    const int w = wa;
    ka = kb, wa = wb, kb = k, wb = w;
  }
}

// Batcher's odd-even merge sort of 8 (entry, child word) pairs by entry.
__device__ __forceinline__ void sort8(float (&k)[8], int (&w)[8]) {
  constexpr int kPairs[19][2] = {{0, 1}, {2, 3}, {4, 5}, {6, 7}, {0, 2},
                                 {1, 3}, {4, 6}, {5, 7}, {1, 2}, {5, 6},
                                 {0, 4}, {1, 5}, {2, 6}, {3, 7}, {2, 4},
                                 {3, 5}, {1, 2}, {3, 4}, {5, 6}};
#pragma unroll
  for (int p = 0; p < 19; ++p)
    order2(k[kPairs[p][0]], w[kPairs[p][0]], k[kPairs[p][1]],
           w[kPairs[p][1]]);
}

// Counters of one ray's walk.
struct Walk {
  unsigned pairs = 0, leaves = 0;  // visits (nodes and leaves), leaf visits
  int peak = 1;                    // the deepest stack
  bool cut = false;                // a child left at MAX_LEVELS
};

// Ray r's exact hit (closest, or any with any_hit), written into its
// outputs.
__device__ __forceinline__ void trace_ray(
    size_t r, const float* __restrict__ o_, const float* __restrict__ d_,
    const float* __restrict__ rd_, float t_max,
    const float4* __restrict__ bounds, const int4* __restrict__ child,
    const float4* __restrict__ leaf_tris, const int* __restrict__ leaf_prim,
    const unsigned char* __restrict__ omap, int omap_s,
    float* __restrict__ t_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int* __restrict__ p_out,
    unsigned char* __restrict__ occ, int any_hit, Walk& walk) {
  float o[3], d[3], rd[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = o_[3 * r + k];
    d[k] = d_[3 * r + k];
    rd[k] = rd_[3 * r + k];
  }
  float bt = t_max, bu = 0.f, bv = 0.f;  // the best key (bt, bd, bid)
  int bd = -1, bid = kI32Max;
  int2 st[kStack];             // (child word, entry bits)
  unsigned char sdep[kStack];  // its depth
  st[0] = make_int2(0, 0);     // root row 0, entry 0
  sdep[0] = 0;
  int sp = 1;
  while (sp > 0) {
    --sp;
    const int c = st[sp].x, dep = sdep[sp];
    if (!may_win(__int_as_float(st[sp].y), dep, bt, bd)) continue;
    ++walk.pairs;
    if (c >= 0) {  // a node: its surviving children, nearest on top
      float4 b[12];
#pragma unroll
      for (int q = 0; q < 12; ++q) b[q] = __ldg(bounds + (size_t)c * 12 + q);
      const int4 k0 = __ldg(child + (size_t)c * 2);
      const int4 k1 = __ldg(child + (size_t)c * 2 + 1);
      const float* bf = reinterpret_cast<const float*>(b);
      int w[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
      float e[8];
      const int cd = dep + 1;
      bool any = false;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float t1x = __fmul_rn(__fsub_rn(bf[j], o[0]), rd[0]);
        const float t2x = __fmul_rn(__fsub_rn(bf[24 + j], o[0]), rd[0]);
        const float t1y = __fmul_rn(__fsub_rn(bf[8 + j], o[1]), rd[1]);
        const float t2y = __fmul_rn(__fsub_rn(bf[32 + j], o[1]), rd[1]);
        const float t1z = __fmul_rn(__fsub_rn(bf[16 + j], o[2]), rd[2]);
        const float t2z = __fmul_rn(__fsub_rn(bf[40 + j], o[2]), rd[2]);
        const float tmin =
            nan_max(nan_max(nan_min(t1x, t2x), nan_min(t1y, t2y)),
                    nan_min(t1z, t2z));
        const float tmax =
            nan_min(nan_min(nan_max(t1x, t2x), nan_max(t1y, t2y)),
                    nan_max(t1z, t2z));
        const bool hit = w[j] != kEmptySlot && tmax >= tmin && tmax >= 0.f &&
                         may_win(tmin, cd, bt, bd);
        e[j] = hit ? tmin : __int_as_float(0x7f800000);  // +inf sorts last
        any |= hit;
      }
      if (!any) continue;
      if (cd >= kMaxLevels) {
        walk.cut = true;  // the wavefront's frontier left at MAX_LEVELS
        continue;
      }
      sort8(e, w);
#pragma unroll
      for (int j = 7; j >= 0; --j) {
        if (e[j] < kFar) {
          st[sp] = make_int2(w[j], __float_as_int(e[j]));
          sdep[sp] = (unsigned char)cd;
          ++sp;
        }
      }
      walk.peak = max(walk.peak, sp);
    } else {  // a leaf: its 4 triangles in lane order
      const int row = -c - 1;
      ++walk.leaves;
      bool stop = false;
      float4 lt[9];  // the leaf's 4 triangles, 9 floats each
#pragma unroll
      for (int q = 0; q < 9; ++q) lt[q] = __ldg(leaf_tris + (size_t)row * 9 + q);
      const float* lf = reinterpret_cast<const float*>(lt);
#pragma unroll
      for (int lane = 0; lane < 4; ++lane) {
        float t, u, v;
        bool hit = moller_trumbore(o, d, lf + 9 * lane, t_max, t, u, v);
        if (hit && omap_s > 0) {
          const int iu = min(max((int)__fmul_rn(u, (float)omap_s), 0),
                             omap_s - 1);
          const int iv = min(max((int)__fmul_rn(v, (float)omap_s), 0),
                             omap_s - 1);
          hit = omap[(((size_t)row * 4 + lane) * omap_s + iu) * omap_s + iv];
        }
        const int id = row * 4 + lane;
        if (hit && (t < bt || (t == bt && (dep < bd ||
                                           (dep == bd && id < bid))))) {
          bt = t, bd = dep, bid = id, bu = u, bv = v;
          if (any_hit) {
            stop = true;
            break;
          }
        }
      }
      if (stop) break;
    }
  }

  if (any_hit) {
    occ[r] = bd >= 0;
  } else {
    const bool found = bd >= 0;
    t_out[r] = found ? bt : kFar;
    u_out[r] = found ? bu : 0.f;
    v_out[r] = found ? bv : 0.f;
    p_out[r] = found ? __ldg(leaf_prim + bid) : -1;
  }
}

// stats: 8 u64, [0, 3) the sums of the launch in flight (visits, leaf
// visits, deepest stack), [3] the CTAs done, [4, 7) the last launch's
// sums.
__global__ void __launch_bounds__(kTile, 2)
retrace_kernel(const float* __restrict__ o_, const float* __restrict__ d_,
               const float* __restrict__ rd_, const float* __restrict__ tmax_,
               float tmax_s, const float4* __restrict__ bounds,
               const int4* __restrict__ child,
               const float4* __restrict__ leaf_tris,
               const int* __restrict__ leaf_prim,
               const unsigned char* __restrict__ omap, int omap_s,
               unsigned char* __restrict__ ovf, float* __restrict__ t_out,
               float* __restrict__ u_out, float* __restrict__ v_out,
               int* __restrict__ p_out, unsigned char* __restrict__ occ,
               unsigned long long* __restrict__ stats, int any_hit) {
  const int tile = blockIdx.x;
  if (ovf[tile]) {  // else resolved by the packet pass
    const size_t r = (size_t)tile * kTile + threadIdx.x;
    Walk walk;
    trace_ray(r, o_, d_, rd_, tmax_ != nullptr ? tmax_[r] : tmax_s, bounds,
              child, leaf_tris, leaf_prim, omap, omap_s, t_out, u_out, v_out,
              p_out, occ, any_hit, walk);
    unsigned long long wp = walk.pairs, wl = walk.leaves;
    int wk = walk.peak;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      wp += __shfl_xor_sync(0xffffffffu, wp, off);
      wl += __shfl_xor_sync(0xffffffffu, wl, off);
      wk = max(wk, __shfl_xor_sync(0xffffffffu, wk, off));
    }
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(stats, wp);
      atomicAdd(stats + 1, wl);
      atomicMax(stats + 2, (unsigned long long)wk);
    }
    const int tile_cut = __syncthreads_or(walk.cut);
    if (threadIdx.x == 0) ovf[tile] = tile_cut ? 1 : 0;
  }
  // the last CTA publishes the sums and zeroes them for the next launch
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(stats + 3, 1ull) == (unsigned long long)gridDim.x - 1;
  __syncthreads();
  if (last && threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) stats[4 + k] = atomicExch(stats + k, 0ull);
    stats[3] = 0;
  }
}

}  // namespace
}  // namespace tbvh

// o, d, rd (R, 3) f32, R = T * 256; tmax (R,) f32, or null for tmax_s on
// every ray; bounds (M, 48) f32, child (M, 8) i32, leaf_tris (L, 4, 3, 3)
// f32, all 16-byte aligned; leaf_prim (L, 4) i32; omap (L, 4, S, S) bool
// or null (omap_s = 0); ovf (T,) bool, read and then rewritten for the
// tiles it flags. Closest hit: t, u, v (R,) f32 and prim (R,) i32
// rewritten on those tiles' rays (occ null); any hit: occ (R,) bool (t,
// u, v, prim null). stats: 8 u64, zero at first use, one launch at a time
// (see retrace_kernel); after the launch [4, 7) hold its visits, leaf
// visits and deepest stack.
extern "C" int tbvh_retrace(const float* o, const float* d, const float* rd,
                            const float* tmax, float tmax_s,
                            const float* bounds, const int* child,
                            const float* leaf_tris, const int* leaf_prim,
                            const unsigned char* omap, unsigned char* ovf,
                            float* t, float* u, float* v, int* prim,
                            unsigned char* occ, unsigned long long* stats,
                            int T, int omap_s, int any_hit, void* stream) {
  if (T <= 0 || omap_s < 0 || (omap_s > 0) != (omap != nullptr) ||
      stats == nullptr ||
      (any_hit ? occ == nullptr : (t == nullptr || prim == nullptr)) ||
      reinterpret_cast<std::uintptr_t>(bounds) % 16 ||
      reinterpret_cast<std::uintptr_t>(child) % 16 ||
      reinterpret_cast<std::uintptr_t>(leaf_tris) % 16)
    return (int)cudaErrorInvalidValue;
  void* args[] = {&o,    &d,   &rd,  &tmax, &tmax_s, &bounds, &child,
                  &leaf_tris, &leaf_prim, &omap, &omap_s, &ovf, &t, &u,
                  &v,    &prim, &occ, &stats, &any_hit};
  cudaError_t err = cudaLaunchKernel(
      reinterpret_cast<const void*>(&tbvh::retrace_kernel), dim3(T),
      dim3(tbvh::kTile), args, 0, (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return (int)(err != cudaSuccess ? err : last);
}

// Kernel R's resources (see common.cuh kernel_occupancy).
extern "C" int tbvh_retrace_occupancy(int* out) {
  return tbvh::kernel_occupancy(
      reinterpret_cast<const void*>(&tbvh::retrace_kernel), tbvh::kTile, 0,
      out);
}
