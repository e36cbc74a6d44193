// Kernel F: per-tile depth-first BVH8 walk against the tile's 4 frustum
// planes, collecting the tile's leaf list (traverse/frustum_walk.py).
//
// Replaces the TPU kernel tinybvh_tpu/traverse/pallas_frustum.py::_kernel,
// called from collect_tile_leaves_pallas (phase 1 of the v1 packet engine
// with phase1_pallas). Per tile: pop a node from a 64-entry stack, test its
// 8 child boxes against the 4 planes (a box is outside a plane when
// -ndoto[p] + sum_k n[p][k] * (n[p][k] > 0 ? hi[k] : lo[k]) < 0, summed
// k = 0, 1, 2), append leaf children to the tile's list and push node
// children, in child-slot order.
//
// What bounds it on this card: neither bytes nor flops but latency. Each
// pop is a dependent chain (stack read, node row read from device memory
// or L2, 8 box tests, ranks, writes), and a tile's pops are sequential.
// The node tables of a 64k-triangle BVH8 (~5k nodes, 224 B each) fit in
// L2 many times over; the TPU kernel held them in VMEM.
//
// What the design does about it: one warp per tile, four tiles per CTA so
// many walks are in flight on each SM to hide each other's latency. Lanes
// 0-7 test one child each; a warp ballot plus popc gives each lane its
// exclusive rank among the leaf or node children (the TPU kernel's
// roll-based prefix). The stack lives in shared memory, the leaf list is
// written straight to device memory. The walk reproduces the JAX kernel's
// exactly, overflow included: pushes land at sp + rank only when < 64,
// leaves at cnt + rank only when < K; then cnt and sp advance by the full
// counts, overflow is sp >= 64 or cnt > K, and sp is clamped to 63. The
// box test rounds every product and sum on its own in the JAX order, so
// the lists equal the plain PyTorch twin's. Inputs are finite (planes of
// validated rays, boxes of finite triangles), so no NaN rule is needed.
// Each node is pushed at most once (by its one parent), so a walk makes at
// most as many pops as the tree has nodes; max_steps (given by the
// wrapper, and used by the twin too) only guards against a malformed tree.
#include "common.cuh"

namespace tbvh {
namespace {

constexpr int kStack = 64;         // pallas_frustum.py STACK
constexpr int kWarpsPerCta = 4;    // tiles per CTA
constexpr int kEmptySlot = -2147483647;  // layouts/mbvh.py EMPTY_SLOT

__global__ void __launch_bounds__(32 * kWarpsPerCta)
frustum_walk_kernel(const float* __restrict__ bounds,
                    const int* __restrict__ child,
                    const float* __restrict__ planes,
                    const float* __restrict__ ndoto, int* __restrict__ leaves,
                    int* __restrict__ counts, int T, int K, int max_steps) {
  __shared__ int stack_s[kWarpsPerCta][kStack];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kWarpsPerCta + warp;
  if (tile >= T) return;  // a whole warp leaves together
  int* stk = stack_s[warp];
  int* lst = leaves + (size_t)tile * K;

  float n[4][3], nd[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
#pragma unroll
    for (int k = 0; k < 3; ++k) n[p][k] = planes[(size_t)tile * 12 + p * 3 + k];
    nd[p] = -ndoto[(size_t)tile * 4 + p];
  }
  for (int e = lane; e < K; e += 32) lst[e] = kI32Max;
  if (lane == 0) stk[0] = 0;  // root
  __syncwarp();

  int sp = 1, cnt = 0, steps = 0;
  bool ovf = false;
  const unsigned below = (1u << lane) - 1u;
  while (sp > 0) {
    if (steps++ >= max_steps) {
      ovf = true;
      break;
    }
    sp -= 1;
    const int node = stk[sp];
    __syncwarp();  // every lane has read the top before any push lands
    bool is_leaf = false, is_node = false;
    int kid = 0;
    if (lane < 8) {
      kid = child[(size_t)node * 8 + lane];
      const float* b = bounds + (size_t)node * 48 + lane;
      float lo[3], hi[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        lo[k] = b[k * 8];
        hi[k] = b[(3 + k) * 8];
      }
      bool outside = false;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float dist = nd[p];
#pragma unroll
        for (int k = 0; k < 3; ++k)
          dist = __fadd_rn(dist,
                           __fmul_rn(n[p][k], n[p][k] > 0.f ? hi[k] : lo[k]));
        outside |= dist < 0.f;
      }
      const bool valid = !outside && kid != kEmptySlot;
      is_leaf = valid && kid < 0;
      is_node = valid && kid >= 0;
    }
    const unsigned lm = __ballot_sync(0xffffffffu, is_leaf);
    const unsigned nm = __ballot_sync(0xffffffffu, is_node);
    if (is_leaf) {
      const int pos = cnt + __popc(lm & below);
      if (pos < K) lst[pos] = -kid - 1;
    }
    if (is_node) {
      const int pos = sp + __popc(nm & below);
      if (pos < kStack) stk[pos] = kid;
    }
    __syncwarp();  // pushes land before the next pop
    cnt += __popc(lm);
    sp += __popc(nm);
    ovf = ovf || sp >= kStack || cnt > K;
    sp = min(sp, kStack - 1);
  }
  if (lane == 0) counts[tile] = (ovf || cnt > K) ? -1 : cnt;
}

}  // namespace
}  // namespace tbvh

// bounds (M, 48) f32 [lo x|y|z, hi x|y|z] x 8 children, child (M, 8) i32,
// planes (T, 4, 3) f32, ndoto (T, 1, 4) f32 -> leaves (T, K) i32 (I32MAX
// padded), counts (T,) i32 (-1 on overflow).
extern "C" int tbvh_frustum_walk(const float* bounds, const int* child,
                                 const float* planes, const float* ndoto,
                                 int* leaves, int* counts, int T, int K,
                                 int max_steps, void* stream) {
  if (T <= 0 || K <= 0 || max_steps <= 0) return (int)cudaErrorInvalidValue;
  const int ctas = (T + tbvh::kWarpsPerCta - 1) / tbvh::kWarpsPerCta;
  tbvh::frustum_walk_kernel<<<ctas, 32 * tbvh::kWarpsPerCta, 0,
                              (cudaStream_t)stream>>>(
      bounds, child, planes, ndoto, leaves, counts, T, K, max_steps);
  return (int)cudaGetLastError();
}

// Kernel F's resources (see common.cuh kernel_occupancy).
extern "C" int tbvh_frustum_walk_occupancy(int* out) {
  return tbvh::kernel_occupancy(
      reinterpret_cast<const void*>(&tbvh::frustum_walk_kernel),
      32 * tbvh::kWarpsPerCta, 0, out);
}
