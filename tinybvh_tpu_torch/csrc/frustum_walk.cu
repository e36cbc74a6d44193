// Kernel F: per-tile depth-first BVH8 walk against the tile's 4 frustum
// planes, collecting the tile's leaf list (traverse/frustum_walk.py).
//
// Replaces the TPU kernel tinybvh_tpu/traverse/pallas_frustum.py::_kernel,
// called from collect_tile_leaves_pallas (phase 1 of the v1 packet engine
// with phase1_pallas). Per tile: pop a node from a 64-entry stack, test its
// 8 child boxes against the 4 planes (a box is outside a plane when
// -ndoto[p] + sum_k n[p][k] * (n[p][k] > 0 ? hi[k] : lo[k]) < 0, summed
// k = 0, 1, 2), append leaf children to the tile's list and push node
// children, in child-slot order, so that they pop highest slot first.
//
// What bounds it on this card: neither bytes nor flops but latency. Walked
// pop by pop, a tile is a dependent chain (stack read, node row from L2,
// 8 box tests, ranks, pushes) of up to ~200 pops on a 64k-triangle BVH8,
// ~0.3 us each, and the kernel lasts as long as its longest tile.
//
// What the design does about it: the list is a function of the tile's
// visible tree alone, so one CTA per tile expands that tree breadth first
// into shared memory, a "record" per visible node (its visible leaf and
// node slots, each slot's leaf id or child record, its parent link): 2
// (record, slot) pairs a thread a step, every load of a level independent
// of the others, one shared-memory allocation a warp for the children it
// found, and warps with no pair left skip the step. The chain is the
// tree's depth (~6 levels), not its pops. Then three passes over the
// records, each with every record in parallel and each walking at most
// the depth up the parent links: the subtree leaf counts (each record adds
// its leaves to itself and its ancestors), each record's "pre" (the leaves
// the walk lists between its parent's pop and its own: the parent's
// leaves, then the subtrees of its node siblings in higher slots, which
// pop first), and each record's list position (the sum of "pre" up its
// chain), where its leaves are written in slot order. A record's stack
// position in the sequential walk is its parent's plus its rank among the
// parent's node children, so the stack overflow of the sequential walk
// (sp + pushes >= 64 at a pop) is found exactly; so is the list overflow
// (more than K leaves: the first K are kept, the count is -1). A tile
// whose stack overflows, or whose records pass kCap, kMaxLevels or
// max_steps (a malformed tree, e.g. one with a cycle, reaches the last
// two), walks the present sequential way inside the same kernel
// (walk_sequential), so every list and count equals the plain twin's,
// overflow included. 256 records (13 KB) a CTA and at most 32 registers
// a thread keep 16 CTAs on an SM, so 2,112 tiles are in flight at once.
// The box test rounds every product and sum on its own in the JAX order.
// Inputs are finite (planes of validated rays, boxes of finite triangles),
// so no NaN rule is needed. max_steps (given by the wrapper, and used by
// the twin too) only guards the sequential walk against a malformed tree.
#include "common.cuh"

namespace tbvh {
namespace {

constexpr int kStack = 64;         // pallas_frustum.py STACK
constexpr int kThreads = 128;      // one tile per CTA
constexpr int kPairs = 2;          // (record, slot) pairs a thread a step
constexpr int kCap = 256;          // records a tile may hold
constexpr int kMaxLevels = 64;     // levels a tile may hold
constexpr int kEmptySlot = -2147483647;  // layouts/mbvh.py EMPTY_SLOT

// The tile's visible tree, one record per visible node (the root first).
struct Records {
  int node[kCap];    // BVH8 node id; the stack of walk_sequential
  int meta[kCap];    // visible leaf slots | visible node slots << 8
  int pos[kCap];     // stack position at the node's pop, then its "pre"
  int sub[kCap];     // leaves in the node's visible subtree
  int link[kCap];    // parent record * 8 + slot in the parent (root: -1)
  int val[kCap][8];  // per visible slot: leaf id, or the child's record
  int n;             // records allocated
  int seq;           // 1: the tile takes walk_sequential
};

// True when the box [lo, hi] lies outside any of the tile's 4 planes
// (normals n, offsets nd = -ndoto). Every product and sum is rounded on
// its own, in the JAX order.
__device__ __forceinline__ bool box_outside(const float (&n)[4][3],
                                            const float (&nd)[4],
                                            const float (&lo)[3],
                                            const float (&hi)[3]) {
  bool outside = false;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float dist = nd[p];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      dist = __fadd_rn(dist, __fmul_rn(n[p][k], n[p][k] > 0.f ? hi[k] : lo[k]));
    outside |= dist < 0.f;
  }
  return outside;
}

// The JAX kernel's walk, pop by pop, on one warp (lanes 0-7 test a child
// each; a ballot plus popc gives each lane its rank among the leaf or
// node children). Pushes land at sp + rank only when < 64, leaves at cnt
// + rank only when < K; then cnt and sp advance by the full counts,
// overflow is sp >= 64 or cnt > K, and sp is clamped to 63. Returns the
// tile's count (-1 on overflow).
__device__ int walk_sequential(const float* __restrict__ bounds,
                               const int* __restrict__ child,
                               const float (&n)[4][3], const float (&nd)[4],
                               int* __restrict__ lst, int* stk, int K,
                               int max_steps, int lane) {
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
      const bool valid = !box_outside(n, nd, lo, hi) && kid != kEmptySlot;
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
  return (ovf || cnt > K) ? -1 : cnt;
}

__global__ void __launch_bounds__(kThreads, 16)
frustum_walk_kernel(const float* __restrict__ bounds,
                    const int* __restrict__ child,
                    const float* __restrict__ planes,
                    const float* __restrict__ ndoto, int* __restrict__ leaves,
                    int* __restrict__ counts, int K, int max_steps,
                    int* __restrict__ seq_tiles) {
  __shared__ Records R;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int grp = lane & ~7;  // first lane of this thread's record
  const int slot = lane & 7;  // q & 7 for every pair q of this thread
  const unsigned below = (1u << slot) - 1u;
  int* lst = leaves + (size_t)tile * K;

  float n[4][3], nd[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
#pragma unroll
    for (int k = 0; k < 3; ++k) n[p][k] = planes[(size_t)tile * 12 + p * 3 + k];
    nd[p] = -ndoto[(size_t)tile * 4 + p];
  }
  if (tid == 0) {
    R.node[0] = 0;  // the root
    R.pos[0] = 0;
    R.sub[0] = 0;
    R.link[0] = -1;
    R.n = 1;
    R.seq = 0;
  }
  __syncthreads();

  // expand the visible tree level by level: records [lb, le)
  int lb = 0, le = 1, nlev = 0;
  bool sequential = false;
  while (true) {
    for (int q0 = lb * 8; q0 < le * 8; q0 += kThreads * kPairs) {
      // pairs q0 + s * kThreads + tid; a warp with none at s skips s
      bool on[kPairs];
      int rec[kPairs], kid[kPairs];
      float lo[kPairs][3], hi[kPairs][3];
#pragma unroll
      for (int s = 0; s < kPairs; ++s) {  // every load of the step first
        const int q = q0 + s * kThreads + tid;
        on[s] = q - lane < le * 8;  // the same in every lane of the warp
        rec[s] = q < le * 8 ? q >> 3 : -1;
        kid[s] = kEmptySlot;
        if (rec[s] >= 0) {
          const int node = R.node[rec[s]];
          kid[s] = child[(size_t)node * 8 + slot];
          const float* b = bounds + (size_t)node * 48 + slot;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            lo[s][k] = b[k * 8];
            hi[s][k] = b[(3 + k) * 8];
          }
        }
      }
      unsigned lw[kPairs], nw[kPairs];
      int n_new = 0;
#pragma unroll
      for (int s = 0; s < kPairs; ++s) {
        lw[s] = nw[s] = 0u;
        if (on[s]) {
          const bool valid = rec[s] >= 0 && kid[s] != kEmptySlot &&
                             !box_outside(n, nd, lo[s], hi[s]);
          lw[s] = __ballot_sync(0xffffffffu, valid && kid[s] < 0);
          nw[s] = __ballot_sync(0xffffffffu, valid && kid[s] >= 0);
          n_new += __popc(nw[s]);
        }
      }
      // one allocation a warp for the node children of all its records
      int base = 0;
      if (lane == 0 && n_new) base = atomicAdd(&R.n, n_new);
      base = __shfl_sync(0xffffffffu, base, 0);
#pragma unroll
      for (int s = 0; s < kPairs; ++s) {
        if (!on[s]) continue;
        const unsigned lm = (lw[s] >> grp) & 0xffu;
        const unsigned nm = (nw[s] >> grp) & 0xffu;
        if (slot == 0 && rec[s] >= 0) {
          R.meta[rec[s]] = (int)(lm | (nm << 8));
          if (R.pos[rec[s]] + __popc(nm) >= kStack) R.seq = 1;  // overflow
        }
        if ((nm >> slot) & 1u) {
          const int rank = __popc(nm & below);
          const int c = base + __popc(nw[s] & ((1u << grp) - 1u)) + rank;
          if (c < kCap) {
            R.node[c] = kid[s];
            R.pos[c] = R.pos[rec[s]] + rank;
            R.sub[c] = 0;
            R.link[c] = rec[s] * 8 + slot;
          }
          R.val[rec[s]][slot] = c;
        } else if ((lm >> slot) & 1u) {
          R.val[rec[s]][slot] = -kid[s] - 1;
        }
        base += __popc(nw[s]);
      }
    }
    __syncthreads();
    const int nrec = R.n;
    const bool over = R.seq != 0;
    __syncthreads();  // every thread has read R.n before it grows again
    ++nlev;
    if (over || nrec > kCap || nrec > max_steps) {
      sequential = true;
      break;
    }
    if (nrec == le) break;  // the last level has no node children
    if (nlev == kMaxLevels) {
      sequential = true;
      break;
    }
    lb = le;
    le = nrec;
  }
  if (sequential) {
    if (tid < 32) {
      const int c = walk_sequential(bounds, child, n, nd, lst, R.node, K,
                                    max_steps, lane);
      if (lane == 0) {
        counts[tile] = c;
        if (seq_tiles) atomicAdd(seq_tiles, 1);
      }
    }
    return;
  }
  const int nrec = le;

  // each record's leaves counted into its own subtree and every
  // ancestor's (the chain of links is at most the tree's depth)
  for (int r = tid; r < nrec; r += kThreads) {
    const int nl = __popc((unsigned)R.meta[r] & 0xffu);
    if (nl)
      for (int a = r; a >= 0; a = R.link[a] >> 3) atomicAdd(&R.sub[a], nl);
  }
  __syncthreads();
  const int total = R.sub[0];
  for (int e = min(total, K) + tid; e < K; e += kThreads) lst[e] = kI32Max;
  if (tid == 0) counts[tile] = total > K ? -1 : total;
  // "pre" of each record: the leaves the walk lists between its parent's
  // pop and its own: the parent's leaves, then the subtrees of its node
  // siblings in higher slots (popped first)
  for (int r = tid + 1; r < nrec; r += kThreads) {
    const int lk = R.link[r];
    const int p = lk >> 3;
    const unsigned meta = (unsigned)R.meta[p];
    const unsigned higher = (meta >> 8) & (0xfeu << (lk & 7)) & 0xffu;
    int pre = __popc(meta & 0xffu);
#pragma unroll
    for (int t = 1; t < 8; ++t)
      if ((higher >> t) & 1u) pre += R.sub[R.val[p][t]];
    R.pos[r] = pre;  // the stack positions are no longer needed
  }
  __syncthreads();
  // a record's first list position is the sum of "pre" up its chain (the
  // root's is 0); its leaves follow in slot order (the first K are kept)
  for (int r = tid; r < nrec; r += kThreads) {
    int o = 0;
    for (int a = r; a > 0; a = R.link[a] >> 3) o += R.pos[a];
    unsigned lm = (unsigned)R.meta[r] & 0xffu;
    for (int j = 0; lm; ++j, lm &= lm - 1) {
      if (o + j < K) lst[o + j] = R.val[r][__ffs(lm) - 1];
    }
  }
}

int launch(const float* bounds, const int* child, const float* planes,
           const float* ndoto, int* leaves, int* counts, int T, int K,
           int max_steps, int* seq_tiles, void* stream) {
  if (T <= 0 || K <= 0 || max_steps <= 0) return (int)cudaErrorInvalidValue;
  frustum_walk_kernel<<<T, kThreads, 0, (cudaStream_t)stream>>>(
      bounds, child, planes, ndoto, leaves, counts, K, max_steps, seq_tiles);
  return (int)cudaGetLastError();
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
  return tbvh::launch(bounds, child, planes, ndoto, leaves, counts, T, K,
                      max_steps, nullptr, stream);
}

// The same launch, adding to *seq_tiles (device int) the tiles that took
// the sequential walk.
extern "C" int tbvh_frustum_walk_seq(const float* bounds, const int* child,
                                     const float* planes, const float* ndoto,
                                     int* leaves, int* counts, int T, int K,
                                     int max_steps, int* seq_tiles,
                                     void* stream) {
  return tbvh::launch(bounds, child, planes, ndoto, leaves, counts, T, K,
                      max_steps, seq_tiles, stream);
}

// Kernel F's resources (see common.cuh kernel_occupancy).
extern "C" int tbvh_frustum_walk_occupancy(int* out) {
  return tbvh::kernel_occupancy(
      reinterpret_cast<const void*>(&tbvh::frustum_walk_kernel),
      tbvh::kThreads, 0, out);
}
