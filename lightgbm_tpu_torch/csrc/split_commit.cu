// The bookkeeping between two one-kernel splits of the device tree loop,
// in one launch, for Hopper (sm_90a).
//
// Replaces the XLA body of the JAX builder's lax.while_loop
// (lightgbm_tpu/learner.py, the split loop of build_tree_partitioned:
// argmax of the best gains, the split log, leaf sums and outputs, depths,
// the basic monotone bounds, the segment table and histogram pool) and, in
// this package, the torch ops of the per-split host loop
// (learner.build_tree_partitioned). Commit s of a tree of L leaves:
//
//   (a) when split s - 1 ran (its header's live word), apply its
//       one-kernel split outputs: both children's segments (the left one
//       keeps the parent's slot, the right one is slot s), their
//       histograms into the pool, and their best splits into the table,
//       with gain -inf where max_depth > 0 and depth >= max_depth;
//   (b) when s < L - 1, pick split s: leaf = the first maximum of the best
//       gains in torch.argmax's order (NaN above everything), live =
//       (split s - 1 ran, or s = 0) and gain > 0;
//   (c) when live, record log entry s (leaf, feature, bin, kind,
//       default_left, gain, the children's sums and the go-left row), the
//       children's leaf sums, outputs and depth, the basic monotone bounds
//       (both children bounded by the midpoint of their outputs,
//       monotone_constraints.hpp:327), and num_splits += 1;
//   (d) write header row s and pair row s of the one-kernel split
//       (ops/partition.ONE_KERNEL_HDR, PAIR_WORDS): [src, start, cnt, col,
//       left_smaller, depth, live, leaf] and the children's sums, outputs
//       and bounds. With live 0 the split is a no-op.
//
// Block 0 does (a)'s scalar writes, then (b)-(d); every block copies a
// share of the two child histograms into the pool. Nothing is read back
// to the host: a tree is a fixed sequence of launches (commit, split) x
// (L - 1) and a final commit, which a CUDA graph holds. The arithmetic is
// torch's op for op (the midpoint (lo + ro) * 0.5, NaN-propagating max and
// min; built with -fmad=false), so the state equals the host loop's and
// its plain twin's (ops/commit.split_commit_plain) bit for bit.
//
// What bounds it: latency. It moves two child histograms (2 x F x B x 12 B
// read and written, 0.34 MB at F = 28, B = 255: ~0.2 us at 3.35 TB/s) and
// a few hundred scalars; the pick is one block-wide argmax over L gains.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Field order and types must match ops/commit.py CommitArgs.
struct CommitArgs {
  // the one-kernel split's outputs (ops/partition.SplitOut)
  const int32_t* lt;          // (1,)
  const float* hists;         // (2, F, B, 3)
  const float* fout;          // (18,)
  const int64_t* iout;        // (6,)
  const uint8_t* bout;        // (2 + 2B,)
  // tree state (ops/commit.TreeState)
  int32_t* seg_tab;           // (L, 3) start, cnt, parity
  float* hist_pool;           // (L, F, B, 3)
  float* best_gain;           // (L,)
  int64_t* best_feature;      // (L,)
  int64_t* best_bin;
  int64_t* best_kind;
  uint8_t* best_dl;           // (L,) bool
  uint8_t* best_go;           // (L, B) bool
  float* best_ls;             // (L, 3)
  float* best_rs;
  float* best_lo;             // (L,)
  float* best_ro;
  float* leaf_sum;            // (L, 3)
  float* leaf_out;            // (L,)
  float* leaf_lower;
  float* leaf_upper;
  int32_t* depth;             // (L,)
  int32_t* log_leaf;          // (L - 1,)
  int32_t* log_feat;
  int32_t* log_bin;
  int32_t* log_kind;
  uint8_t* log_dl;            // (L - 1,) bool
  float* log_gain;            // (L - 1,)
  float* log_ls;              // (L - 1, 3)
  float* log_rs;
  uint8_t* log_go;            // (L - 1, B) bool
  int32_t* num_splits;        // (1,)
  int32_t* hdr;               // (L, 8)
  float* pair;                // (L, 12)
  const int8_t* monotone;     // (F,)
  int32_t s, L, F, B, max_depth, has_monotone;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kHdr = 8;
constexpr int kPair = 12;

// torch semantics: maximum/minimum propagate NaN (fmaxf does not).
__device__ __forceinline__ float tmax(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// torch.argmax's order: NaN above everything, then the larger value, then
// the smaller index.
__device__ __forceinline__ bool better(float g1, int i1, float g0, int i0) {
  const bool n1 = isnan(g1), n0 = isnan(g0);
  if (n1 != n0) return n1;
  if (n1) return i1 < i0;
  return g1 > g0 || (g1 == g0 && i1 < i0);
}

// The first maximum of gain[0 .. n) over the block; every thread gets it.
__device__ int block_argmax(const float* gain, int n, float* s_g, int* s_i) {
  float g = -INFINITY;
  int idx = INT32_MAX;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (better(gain[i], i, g, idx)) {
      g = gain[i];
      idx = i;
    }
  }
  for (int o = 16; o; o >>= 1) {
    const float g2 = __shfl_down_sync(kFull, g, o);
    const int i2 = __shfl_down_sync(kFull, idx, o);
    if (better(g2, i2, g, idx)) {
      g = g2;
      idx = i2;
    }
  }
  if ((threadIdx.x & 31) == 0) {
    s_g[threadIdx.x >> 5] = g;
    s_i[threadIdx.x >> 5] = idx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      if (better(s_g[w], s_i[w], g, idx)) {
        g = s_g[w];
        idx = s_i[w];
      }
    }
    s_i[0] = idx;
  }
  __syncthreads();
  return s_i[0];
}

__global__ void __launch_bounds__(kThreads)
split_commit_kernel(const CommitArgs a) {
  __shared__ float s_g[kWarps];
  __shared__ int s_i[kWarps];
  const int s = a.s, F = a.F, B = a.B;
  const int32_t* ph = a.hdr + (size_t)(s - 1) * kHdr;   // split s - 1
  const bool prev_live = s > 0 && ph[6] != 0;
  const int pleaf = prev_live ? ph[7] : 0;
  const size_t hsize = (size_t)F * B * 3;

  // ---- (a) the child histograms into the pool, every block a share ----
  if (prev_live) {
    float* to_left = a.hist_pool + (size_t)pleaf * hsize;
    float* to_right = a.hist_pool + (size_t)s * hsize;
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
         i < hsize; i += (size_t)gridDim.x * blockDim.x) {
      to_left[i] = a.hists[i];
      to_right[i] = a.hists[hsize + i];
    }
  }
  if (blockIdx.x != 0) return;
  const int t = threadIdx.x;

  // ---- (a) the scalar state of split s - 1 ----
  if (prev_live) {
    if (t == 0) {
      const int lt = a.lt[0];
      const int start = ph[1], cnt = ph[2], npar = 1 - ph[0];
      a.seg_tab[s * 3 + 0] = start + lt;
      a.seg_tab[s * 3 + 1] = cnt - lt;
      a.seg_tab[s * 3 + 2] = npar;
      a.seg_tab[pleaf * 3 + 1] = lt;
      a.seg_tab[pleaf * 3 + 2] = npar;
      const bool cut = a.max_depth > 0 && ph[5] >= a.max_depth;
      for (int c = 0; c < 2; ++c) {
        const int slot = c == 0 ? pleaf : s;
        a.best_gain[slot] = cut ? -INFINITY : a.fout[c];
        a.best_feature[slot] = a.iout[c];
        a.best_bin[slot] = a.iout[2 + c];
        a.best_kind[slot] = a.iout[4 + c];
        a.best_dl[slot] = a.bout[c];
        for (int k = 0; k < 3; ++k) {
          a.best_ls[slot * 3 + k] = a.fout[2 + c * 3 + k];
          a.best_rs[slot * 3 + k] = a.fout[8 + c * 3 + k];
        }
        a.best_lo[slot] = a.fout[14 + c];
        a.best_ro[slot] = a.fout[16 + c];
      }
    }
    for (int b = t; b < B; b += blockDim.x) {
      a.best_go[(size_t)pleaf * B + b] = a.bout[2 + b];
      a.best_go[(size_t)s * B + b] = a.bout[2 + B + b];
    }
  }
  if (s >= a.L - 1) return;      // the final commit only applies
  __syncthreads();               // the table is whole before the pick

  // ---- (b) pick split s ----
  const int leaf = block_argmax(a.best_gain, a.L, s_g, s_i);
  const bool live = (s == 0 || prev_live) && a.best_gain[leaf] > 0.f;
  const int nw = s + 1;
  int32_t* hdr = a.hdr + (size_t)s * kHdr;
  if (!live) {
    if (t == 0) hdr[6] = 0;
    return;
  }
  // ---- (c) record, (d) header ----
  for (int b = t; b < B; b += blockDim.x) {
    a.log_go[(size_t)s * B + b] = a.best_go[(size_t)leaf * B + b];
  }
  if (t != 0) return;
  const int64_t feat = a.best_feature[leaf];
  const float* ls = a.best_ls + leaf * 3;
  const float* rs = a.best_rs + leaf * 3;
  const float lo = a.best_lo[leaf], ro = a.best_ro[leaf];
  a.log_leaf[s] = leaf;
  a.log_feat[s] = (int32_t)feat;
  a.log_bin[s] = (int32_t)a.best_bin[leaf];
  a.log_kind[s] = (int32_t)a.best_kind[leaf];
  a.log_dl[s] = a.best_dl[leaf];
  a.log_gain[s] = a.best_gain[leaf];
  float* pr = a.pair + (size_t)s * kPair;
  for (int k = 0; k < 3; ++k) {
    const float l = ls[k], r = rs[k];
    a.log_ls[s * 3 + k] = l;
    a.log_rs[s * 3 + k] = r;
    a.leaf_sum[leaf * 3 + k] = l;
    a.leaf_sum[nw * 3 + k] = r;
    pr[k] = l;
    pr[3 + k] = r;
  }
  a.leaf_out[leaf] = lo;
  a.leaf_out[nw] = ro;
  const int d = a.depth[leaf] + 1;
  a.depth[leaf] = d;
  a.depth[nw] = d;
  if (a.has_monotone) {
    const int mono = a.monotone[feat];
    const float mid = (lo + ro) * 0.5f;
    const float lo_p = a.leaf_lower[leaf], up_p = a.leaf_upper[leaf];
    a.leaf_lower[leaf] = mono < 0 ? tmax(lo_p, mid) : lo_p;
    a.leaf_upper[leaf] = mono > 0 ? tmin(up_p, mid) : up_p;
    a.leaf_lower[nw] = mono > 0 ? tmax(lo_p, mid) : lo_p;
    a.leaf_upper[nw] = mono < 0 ? tmin(up_p, mid) : up_p;
  }
  a.num_splits[0] += 1;
  pr[6] = lo;
  pr[7] = ro;
  pr[8] = a.leaf_lower[leaf];
  pr[9] = a.leaf_lower[nw];
  pr[10] = a.leaf_upper[leaf];
  pr[11] = a.leaf_upper[nw];
  hdr[0] = a.seg_tab[leaf * 3 + 2];
  hdr[1] = a.seg_tab[leaf * 3 + 0];
  hdr[2] = a.seg_tab[leaf * 3 + 1];
  hdr[3] = (int32_t)feat;
  hdr[4] = ls[2] <= rs[2] ? 1 : 0;
  hdr[5] = d;
  hdr[6] = 1;
  hdr[7] = leaf;
}

}  // namespace

extern "C" {

const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Commit args->s of a tree on `stream` with `blocks` blocks (block 0 does
// the scalar work, all of them copy the histograms). Returns a
// cudaError_t code (0 on success).
int split_commit(const CommitArgs* args, int blocks, void* stream) {
  const CommitArgs a = *args;
  if (a.s < 0 || a.s >= a.L || a.L < 2 || a.F < 1 || a.B < 1 ||
      blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  split_commit_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
