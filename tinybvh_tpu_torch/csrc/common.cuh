// Shared constants of the packet2 kernels (see traverse/packet2.py).
#pragma once

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

}  // namespace tbvh
