// Device code of the advanced monotone method's per-candidate bounds
// (ops/monotone.adv_bounds_of), shared by csrc/monotone.cu (mono_bounds:
// the bounds of a split's children for the split scan) and
// csrc/split_commit.cu (the re-clamp of a picked split to its leaf's
// current bounds at one (feature, bin)).
//
// A leaf's state is its (F, B) rows lo = cons_lo[leaf], hi =
// cons_hi[leaf] and its box [rlo[f], rhi[f]) a feature. The functions are
// the torch twin's operations in the order and with the semantics that
// decide its bits: min and max propagate NaN (torch.minimum, amin); the
// extremum over every feature but f is the two-extremum rule over
// torch.sort's stable order (NaN last, -0 == +0, ties in index order).
// No arithmetic: min, max, compare and copy only.
#pragma once

#include <math.h>
#include <stdint.h>

namespace lgbt_mono {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBins = 256;

// torch semantics: maximum/minimum propagate NaN (fmaxf does not).
__device__ __forceinline__ float tmax(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// The ascending order of torch.sort: NaN after everything.
__device__ __forceinline__ bool sort_less(float a, float b) {
  return isnan(b) ? !isnan(a) : a < b;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o; o >>= 1) v = tmin(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = tmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// hi_f[g] = min of row g of hi over the box's bins, lo_f[g] = max of row g
// of lo, for every feature g (a warp a feature; +/-inf outside the box).
// Ends with __syncthreads.
__device__ void row_extrema(const float* lo, const float* hi,
                            const int32_t* rlo, const int32_t* rhi, int F,
                            int B, float* hi_f, float* lo_f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int g = warp; g < F; g += blockDim.x >> 5) {
    const int r0 = rlo[g], r1 = rhi[g];
    float mn = INFINITY, mx = -INFINITY;
    for (int b = lane; b < B; b += 32) {
      const bool inr = b >= r0 && b < r1;
      mn = tmin(mn, inr ? hi[(size_t)g * B + b] : INFINITY);
      mx = tmax(mx, inr ? lo[(size_t)g * B + b] : -INFINITY);
    }
    mn = warp_min(mn);
    mx = warp_max(mx);
    if (lane == 0) {
      hi_f[g] = mn;
      lo_f[g] = mx;
    }
  }
  __syncthreads();
}

// The whole-range bounds of feature f from every other feature: hi_exc the
// min of hi_f over g != f and +inf, lo_exc the max of lo_f over g != f and
// -inf, by the twin's rule: sort [hi_f, +inf] (stable, ascending), hi1 and
// hi2 its first two; hi_exc = hi2 where hi_f[f] == hi1 and hi1 occurs once
// in hi_f, else hi1 (and for lo the last two of [lo_f, -inf]). One thread.
__device__ void exclude_one(const float* hi_f, const float* lo_f, int F,
                            int f, float* hi_exc, float* lo_exc) {
  // hi: sorted[0] is the first smallest (ties in index order), sorted[1]
  // the first smallest of the rest
  int i1 = 0;
  float v1 = F > 0 ? hi_f[0] : INFINITY;
  for (int g = 1; g <= F; ++g) {
    const float v = g < F ? hi_f[g] : INFINITY;
    if (sort_less(v, v1)) {
      v1 = v;
      i1 = g;
    }
  }
  float v2 = INFINITY;
  bool have = false;
  for (int g = 0; g <= F; ++g) {
    if (g == i1) continue;
    const float v = g < F ? hi_f[g] : INFINITY;
    if (!have || sort_less(v, v2)) {
      v2 = v;
      have = true;
    }
  }
  // lo: sorted[-1] is the last largest (ties: the highest index),
  // sorted[-2] the last largest of the rest
  int j1 = 0;
  float w1 = F > 0 ? lo_f[0] : -INFINITY;
  for (int g = 1; g <= F; ++g) {
    const float w = g < F ? lo_f[g] : -INFINITY;
    if (!sort_less(w, w1)) {
      w1 = w;
      j1 = g;
    }
  }
  float w2 = -INFINITY;
  have = false;
  for (int g = 0; g <= F; ++g) {
    if (g == j1) continue;
    const float w = g < F ? lo_f[g] : -INFINITY;
    if (!have || !sort_less(w, w2)) {
      w2 = w;
      have = true;
    }
  }
  int n_hi = 0, n_lo = 0;
  for (int g = 0; g < F; ++g) {
    n_hi += hi_f[g] == v1;
    n_lo += lo_f[g] == w1;
  }
  *hi_exc = (hi_f[f] == v1 && n_hi == 1) ? v2 : v1;
  *lo_exc = (lo_f[f] == w1 && n_lo == 1) ? w2 : w1;
}

// The four bounds (lo_l, up_l, lo_r, up_r) of the candidate (f, t) of one
// leaf, on every thread of the block (blockDim.x == kThreads, B <=
// kMaxBins): hi_f / lo_f are F floats each of shared memory, red 8 *
// kWarps + 2 floats. The prefix (bins <= t) and shifted suffix (bins > t)
// extrema of row f are block reductions.
__device__ void bound_at(const float* lo, const float* hi,
                         const int32_t* rlo, const int32_t* rhi, int F,
                         int B, int f, int t, float* hi_f, float* lo_f,
                         float* red, float out[4]) {
  row_extrema(lo, hi, rlo, rhi, F, B, hi_f, lo_f);
  if (threadIdx.x == 0) {
    exclude_one(hi_f, lo_f, F, f, &red[8 * kWarps], &red[8 * kWarps + 1]);
  }
  const int b = threadIdx.x;
  const int r0 = rlo[f], r1 = rhi[f];
  const bool inr = b < B && b >= r0 && b < r1;
  const float hv = inr ? hi[(size_t)f * B + b] : INFINITY;
  const float lv = inr ? lo[(size_t)f * B + b] : -INFINITY;
  float v[4] = {b <= t ? hv : INFINITY, b <= t ? lv : -INFINITY,
                b > t ? hv : INFINITY, b > t ? lv : -INFINITY};
  v[0] = warp_min(v[0]);
  v[1] = warp_max(v[1]);
  v[2] = warp_min(v[2]);
  v[3] = warp_max(v[3]);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    for (int k = 0; k < 4; ++k) red[k * kWarps + warp] = v[k];
  }
  __syncthreads();
  float pre_hi = INFINITY, pre_lo = -INFINITY, suf_hi = INFINITY,
        suf_lo = -INFINITY;
  for (int w = 0; w < kWarps; ++w) {
    pre_hi = tmin(pre_hi, red[w]);
    pre_lo = tmax(pre_lo, red[kWarps + w]);
    suf_hi = tmin(suf_hi, red[2 * kWarps + w]);
    suf_lo = tmax(suf_lo, red[3 * kWarps + w]);
  }
  const float hi_exc = red[8 * kWarps], lo_exc = red[8 * kWarps + 1];
  out[0] = tmax(lo_exc, pre_lo);
  out[1] = tmin(hi_exc, pre_hi);
  out[2] = tmax(lo_exc, suf_lo);
  out[3] = tmin(hi_exc, suf_hi);
  __syncthreads();     // red and hi_f / lo_f are free again
}

}  // namespace lgbt_mono
