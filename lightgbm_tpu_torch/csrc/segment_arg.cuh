// The segment a partition, histogram or route-gather launch works on, read
// on the card (ops/partition.SEG_* modes).
//
// The per-split host loop hands each launch a small device array: [src,
// start, cnt, col] (partitions, the route gather) or [plane, start, cnt]
// (histograms). The device tree loop (learner.DeviceTreeLoop with
// ops/chain.ChainSplit) hands every launch of a split the split's header
// instead, ops/partition.ONE_KERNEL_HDR = [src, start, cnt, col,
// left_smaller, depth, live, parent_slot], and the histograms also the
// partition's left count lt, so that no value passes through the host:
//   kSegPlain    seg is the small array itself;
//   kSegParent   the header's parent segment [src, start, cnt, col];
//   kSegRoute    the same on the route plane (col 0: the resident layout's
//                partition routes the slim rows on plane 0);
//   kSegSmaller  the smaller child's segment in buffer 1 - src: [start,
//                start + lt) when left_smaller, else [start + lt, start +
//                cnt).
// A header whose live word is 0 gives an empty segment (cnt 0): the
// launch then writes nothing but its zero results.
#pragma once

#include <stdint.h>

namespace lgbt_seg {

constexpr int kSegPlain = 0;
constexpr int kSegParent = 1;
constexpr int kSegRoute = 2;
constexpr int kSegSmaller = 3;

struct Seg {
  int src, start, cnt, col;
};

// kHasCol: a plain seg has its fourth word (partitions, the route gather;
// a histogram's has three).
template <bool kHasCol>
__device__ __forceinline__ Seg read_seg(const int* __restrict__ seg,
                                        const int* __restrict__ lt,
                                        int mode) {
  if (mode == kSegPlain) {
    return Seg{seg[0], seg[1], seg[2], kHasCol ? seg[3] : 0};
  }
  const bool live = seg[6] != 0;
  if (mode == kSegSmaller) {
    const int n = live ? *lt : 0;
    const bool ls = seg[4] != 0;
    return Seg{1 - seg[0], ls ? seg[1] : seg[1] + n,
               live ? (ls ? n : seg[2] - n) : 0, 0};
  }
  return Seg{seg[0], seg[1], live ? seg[2] : 0,
             mode == kSegRoute ? 0 : seg[3]};
}

__host__ __forceinline__ bool seg_mode_ok(int mode) {
  return mode >= kSegPlain && mode <= kSegSmaller;
}

}  // namespace lgbt_seg
