// The advanced monotone method's state work on the card, for Hopper
// (sm_90a): two entry points, one launch each, between the split commit
// and the split scan of the device tree loop (and in the per-split host
// loop on the card).
//
// Replaces the XLA of the JAX builder's _adv_bounds_of and _adv_commit
// (lightgbm_tpu/learner.py), which run inside its lax.while_loop; there is
// no Pallas kernel. The state of a tree of L leaves, F features and B bins
// is the (L, F) i32 bin boxes rng_lo / rng_hi (leaf l holds the bins
// [rng_lo, rng_hi) of feature f) and the (L, F, B) f32 per-bin bounds
// cons_lo / cons_hi.
//
//   mono_bounds: ops/monotone.adv_bounds_of of one or two leaves (a
//     split's children: the leaf in a device word, usually the split
//     header's, and the new leaf; or one forced split's leaf) into the
//     (nodes, 4, F, B) [lo_l, up_l, lo_r, up_r] bounds that the split scan
//     (csrc/split_scan.cu) reads per candidate. up_l[f, t] = min(hi_exc[f],
//     min of cons_hi[leaf, f, b] over the box's bins b <= t), up_r the
//     same over b > t, lo_* with max; hi_exc[f] / lo_exc[f] the whole-box
//     extremum over every other feature. With the live word 0 nothing is
//     written.
//   mono_commit: ops/monotone.adv_commit's writes of a committed split
//     (its live and leaf words, its children's outputs, the new leaf s +
//     1), after the split commit (csrc/split_commit.cu) cut the boxes: the
//     new leaf's rows inherit the parent's, then each child, left then
//     right, writes its output as a bound into every leaf whose box it
//     covers in all dimensions but one (along each monotone dimension,
//     beyond its own range) and into every leaf wholly ordered against it
//     in a monotone dimension and overlapping it in all others but one
//     (along that other dimension, inside its range).
//
// No arithmetic: min, max, compare and copy in the twin's order
// (monotone.cuh), so both equal their plain twins (ops/monotone.
// mono_bounds_plain, mono_commit_plain) bit for bit.
//
// Design. mono_bounds: one block of 256 threads (a thread a bin) per
// (feature f, node). The exclude-one extremum crosses features, so every
// block first reduces all F rows of its leaf (a warp a row, into shared
// memory: 8F bytes), then thread 0 takes the two extrema, then the block
// scans row f's prefix and suffix min / max with warp shuffles. The F-fold
// redundant reduction reads the leaf's rows from L2 (57 KB at F = 28,
// B = 256): cheaper than a second launch. mono_commit: one block per (leaf
// l, kCommitFeats features); the block counts, over all F, the
// features its row's box is not covered by / does not overlap / is ordered
// against each child in (block-wide atomics in shared memory), then
// updates its share of row l. The parent's block also writes the new
// leaf's row from the parent's old values (the inheritance), and the new
// leaf's block writes nothing: no block reads a row that another writes.
//
// What bounds them on this card: mono_bounds latency (it writes 4 x F x B
// floats a node: 0.23 MB for two nodes at F = 28, B = 256, ~0.07 us at
// 3.35 TB/s); mono_commit bytes: it reads and writes both (L, F, B) arrays
// once, 29 MB at L = 255, F = 28, B = 256 (~9 us at 3.35 TB/s).
#include <cuda_runtime.h>
#include <stdint.h>

#include "monotone.cuh"
#include "smem.cuh"

// Field order and types must match ops/monotone.py MonoBoundsArgs.
struct MonoBoundsArgs {
  const float* cons_lo;       // (L, F, B)
  const float* cons_hi;
  const int32_t* rng_lo;      // (L, F)
  const int32_t* rng_hi;
  const int32_t* leaf0;       // node 0's leaf (a device word)
  const int32_t* live;        // the live word, or null: live
  float* out;                 // (nodes, 4, F, B)
  int32_t leaf1, nodes, L, F, B;
};

// Field order and types must match ops/monotone.py MonoCommitArgs.
struct MonoCommitArgs {
  float* cons_lo;             // (L, F, B)
  float* cons_hi;
  const int32_t* rng_lo;      // (L, F), cut by the split commit
  const int32_t* rng_hi;
  const int8_t* monotone;     // (F,)
  const int32_t* words;       // (2,) live, leaf
  const float* outs;          // (2,) the children's outputs
  int32_t new_leaf, L, F, B;
};

namespace {

using namespace lgbt_mono;

constexpr int kCommitFeats = 4;   // features of one mono_commit block

__global__ void __launch_bounds__(kThreads)
mono_bounds_kernel(const MonoBoundsArgs a) {
  extern __shared__ float smem[];
  __shared__ float s_exc[2];
  __shared__ float s_tot[4][kWarps];
  __shared__ float s_suf[2][kMaxBins + 1];
  if (a.live != nullptr && a.live[0] == 0) return;
  const int f = blockIdx.x, node = blockIdx.y;
  const int F = a.F, B = a.B;
  const int leaf = node == 0 ? a.leaf0[0] : a.leaf1;
  const size_t row = (size_t)leaf * F;
  const float* lo = a.cons_lo + row * B;
  const float* hi = a.cons_hi + row * B;
  const int32_t* rlo = a.rng_lo + row;
  const int32_t* rhi = a.rng_hi + row;
  float* hi_f = smem;
  float* lo_f = smem + F;
  row_extrema(lo, hi, rlo, rhi, F, B, hi_f, lo_f);
  if (threadIdx.x == 0) exclude_one(hi_f, lo_f, F, f, &s_exc[0], &s_exc[1]);

  const int b = threadIdx.x, lane = b & 31, warp = b >> 5;
  const bool inr = b < B && b >= rlo[f] && b < rhi[f];
  const float hv = inr ? hi[(size_t)f * B + b] : INFINITY;
  const float lv = inr ? lo[(size_t)f * B + b] : -INFINITY;
  // inclusive prefix (bins <= b) and suffix (bins >= b) min / max
  float pre_hi = hv, pre_lo = lv, suf_hi = hv, suf_lo = lv;
  for (int o = 1; o < 32; o <<= 1) {
    const float a0 = __shfl_up_sync(kFull, pre_hi, o);
    const float a1 = __shfl_up_sync(kFull, pre_lo, o);
    const float a2 = __shfl_down_sync(kFull, suf_hi, o);
    const float a3 = __shfl_down_sync(kFull, suf_lo, o);
    if (lane >= o) {
      pre_hi = tmin(a0, pre_hi);
      pre_lo = tmax(a1, pre_lo);
    }
    if (lane + o < 32) {
      suf_hi = tmin(suf_hi, a2);
      suf_lo = tmax(suf_lo, a3);
    }
  }
  if (lane == 31) {
    s_tot[0][warp] = pre_hi;
    s_tot[1][warp] = pre_lo;
  }
  if (lane == 0) {
    s_tot[2][warp] = suf_hi;
    s_tot[3][warp] = suf_lo;
  }
  __syncthreads();
  for (int w = 0; w < warp; ++w) {
    pre_hi = tmin(s_tot[0][w], pre_hi);
    pre_lo = tmax(s_tot[1][w], pre_lo);
  }
  for (int w = warp + 1; w < kWarps; ++w) {
    suf_hi = tmin(suf_hi, s_tot[2][w]);
    suf_lo = tmax(suf_lo, s_tot[3][w]);
  }
  s_suf[0][b] = suf_hi;
  s_suf[1][b] = suf_lo;
  __syncthreads();
  if (b >= B) return;
  // the right child's bins are (t, B): the suffix shifted one left
  const float sh = b + 1 < B ? s_suf[0][b + 1] : INFINITY;
  const float sl = b + 1 < B ? s_suf[1][b + 1] : -INFINITY;
  const float hi_exc = s_exc[0], lo_exc = s_exc[1];
  float* o = a.out + ((size_t)node * 4 * F + f) * B + b;
  const size_t plane = (size_t)F * B;
  o[0] = tmax(lo_exc, pre_lo);
  o[plane] = tmin(hi_exc, pre_hi);
  o[2 * plane] = tmax(lo_exc, sl);
  o[3 * plane] = tmin(hi_exc, sh);
}

// The per-feature tests of a leaf box [r0, r1) against a child box [c0,
// c1) in a feature of constraint m.
struct BoxTests {
  bool cover, ov, ub_ord, lb_ord;
};

__device__ __forceinline__ BoxTests box_tests(int r0, int r1, int c0,
                                              int c1, int m) {
  BoxTests t;
  t.cover = c0 <= r0 && r1 <= c1;
  t.ov = r0 < c1 && c0 < r1;
  t.ub_ord = (m > 0 && r1 <= c0) || (m < 0 && r0 >= c1);
  t.lb_ord = (m > 0 && r0 >= c1) || (m < 0 && r1 <= c0);
  return t;
}

__global__ void __launch_bounds__(kThreads)
mono_commit_kernel(const MonoCommitArgs a) {
  // [row][child][not covered, no overlap, ub_ord, lb_ord] counts over F
  __shared__ int s_cnt[2][2][4];
  if (a.words[0] == 0) return;
  const int leaf = a.words[1], nw = a.new_leaf;
  const int l = blockIdx.x;
  if (l == nw) return;            // the parent's block writes its rows
  const int F = a.F, B = a.B;
  const int rows = l == leaf ? 2 : 1;
  const int row_of[2] = {l, nw};
  const int child_of[2] = {leaf, nw};
  if (threadIdx.x < 16) (&s_cnt[0][0][0])[threadIdx.x] = 0;
  __syncthreads();
  int cnt[2][2][4] = {};
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    const int m = a.monotone[f];
    for (int r = 0; r < rows; ++r) {
      const int r0 = a.rng_lo[(size_t)row_of[r] * F + f];
      const int r1 = a.rng_hi[(size_t)row_of[r] * F + f];
      for (int c = 0; c < 2; ++c) {
        const BoxTests t = box_tests(
            r0, r1, a.rng_lo[(size_t)child_of[c] * F + f],
            a.rng_hi[(size_t)child_of[c] * F + f], m);
        cnt[r][c][0] += !t.cover;
        cnt[r][c][1] += !t.ov;
        cnt[r][c][2] += t.ub_ord;
        cnt[r][c][3] += t.lb_ord;
      }
    }
  }
  for (int r = 0; r < rows; ++r) {
    for (int c = 0; c < 2; ++c) {
      for (int k = 0; k < 4; ++k) {
        if (cnt[r][c][k]) atomicAdd(&s_cnt[r][c][k], cnt[r][c][k]);
      }
    }
  }
  __syncthreads();
  const int f0 = blockIdx.y * kCommitFeats;
  const int nf = min(kCommitFeats, F - f0);
  if (nf <= 0) return;
  const float outs[2] = {a.outs[0], a.outs[1]};
  for (int e = threadIdx.x; e < nf * B; e += blockDim.x) {
    const int f = f0 + e / B, b = e % B;
    const int m = a.monotone[f];
    const bool inc = m > 0, dec = m < 0;
    const size_t src = ((size_t)l * F + f) * B + b;
    const float x_hi = a.cons_hi[src], x_lo = a.cons_lo[src];
    for (int r = 0; r < rows; ++r) {
      const int r0 = a.rng_lo[(size_t)row_of[r] * F + f];
      const int r1 = a.rng_hi[(size_t)row_of[r] * F + f];
      float hi = x_hi, lo = x_lo;
      for (int c = 0; c < 2; ++c) {
        const int c0 = a.rng_lo[(size_t)child_of[c] * F + f];
        const int c1 = a.rng_hi[(size_t)child_of[c] * F + f];
        const BoxTests t = box_tests(r0, r1, c0, c1, m);
        const int* n = s_cnt[r][c];
        const float out = outs[c];
        // along the monotone dimension f, beyond the child's range
        const bool cov_exc = n[0] == 0 || (n[0] == 1 && !t.cover);
        const bool below = b < c0, above = b >= c1;
        if (cov_exc && ((inc && below) || (dec && above))) hi = tmin(hi, out);
        if (cov_exc && ((inc && above) || (dec && below))) lo = tmax(lo, out);
        // along the free dimension f, inside the child's range
        const bool free_gate = n[1] - (t.ov ? 0 : 1) == 1;
        const bool in_rng = b >= c0 && b < c1;
        if (n[2] - (int)t.ub_ord > 0 && free_gate && in_rng) {
          hi = tmin(hi, out);
        }
        if (n[3] - (int)t.lb_ord > 0 && free_gate && in_rng) {
          lo = tmax(lo, out);
        }
      }
      const size_t dst = ((size_t)row_of[r] * F + f) * B + b;
      a.cons_hi[dst] = hi;
      a.cons_lo[dst] = lo;
    }
  }
}

}  // namespace

extern "C" {

const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// F x nodes blocks of 256 threads on `stream`. Returns a cudaError_t code
// (0 on success).
int mono_bounds(const MonoBoundsArgs* args, void* stream) {
  const MonoBoundsArgs a = *args;
  if (a.F < 1 || a.B < 1 || a.B > kMaxBins || a.L < 1 || a.nodes < 1 ||
      a.nodes > 2 || a.leaf0 == nullptr || a.leaf1 < 0 || a.leaf1 >= a.L) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 2 * (size_t)a.F * sizeof(float);
  if (smem > 48 * 1024) {
    thread_local int raised[lgbt_smem::kMaxDevices] = {};
    const cudaError_t e = lgbt_smem::raise_once(
        reinterpret_cast<const void*>(mono_bounds_kernel), raised);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  mono_bounds_kernel<<<dim3(a.F, a.nodes), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// L x ceil(F / 4) blocks of 256 threads on `stream`. Returns a cudaError_t
// code (0 on success).
int mono_commit(const MonoCommitArgs* args, void* stream) {
  const MonoCommitArgs a = *args;
  if (a.F < 1 || a.B < 1 || a.B > kMaxBins || a.L < 2 || a.new_leaf < 1 ||
      a.new_leaf >= a.L) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(a.L, (a.F + kCommitFeats - 1) / kCommitFeats);
  mono_commit_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
