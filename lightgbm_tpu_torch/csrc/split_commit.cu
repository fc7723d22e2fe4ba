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
//       (split s - 1 ran, or s = 0) and gain > 0. While the tree's forced splits hold (its forcing word,
//       s < n_forced), the pick is forced split s, the forced-split scan of
//       its leaf f_leaf (csrc/split_scan.cu, one node), when that scan
//       found a valid split (gain > -inf), and the round is live even
//       without a positive best gain; when it found none, the forcing word
//       clears and the round picks the best split as above, live when its
//       gain is > -inf (pick_forced and the `valid` commit of the JAX
//       package's build_tree_partitioned, lightgbm_tpu/learner.py). A round that is not live writes
//       nothing but its header's live word, and no later round is live;
//   (c) when live, record log entry s (leaf, feature, bin, kind,
//       default_left, gain, the children's sums and the go-left row), the
//       children's leaf sums, outputs and depth, the basic monotone bounds
//       (both children bounded by the midpoint of their outputs,
//       monotone_constraints.hpp:327), the features used on the children's
//       path (the parent's and the split's, when track_used: interaction
//       constraints), the split feature in the tree's used set (CEGB), and
//       num_splits += 1;
//   (d) write header row s and pair row s of the split (ops/partition.
//       ONE_KERNEL_HDR, PAIR_WORDS): [src, start, cnt, col, left_smaller,
//       depth, live, leaf] and the children's sums, outputs and bounds; col
//       is the split feature's column of the work rows, through the (F,)
//       column map (EFB: the feature's bundle; none: the feature itself).
//       With live 0 the split is a no-op.
//
// The split's outputs come from the one-kernel split or from the chain's
// split scan (ops/chain.ChainSplit); the child histograms and the pool are
// in the work rows' column space (HF columns of HB bins: the bundles with
// EFB), the best-split tables and the log in feature space (B bins).
//
// Block 0 does (a)'s scalar writes, then (b)-(d); every block copies a
// share of the two child histograms into the pool. Nothing is read back
// to the host: a tree is a fixed sequence of launches (commit, split) x
// (L - 1) and a final commit, which a CUDA graph holds. The arithmetic is
// torch's op for op (the midpoint (lo + ro) * 0.5, NaN-propagating max and
// min; built with -fmad=false), so the state equals the host loop's and
// its plain twin's (ops/commit.split_commit_plain) bit for bit.
//
// What bounds it: latency. It moves two child histograms (2 x HF x HB x 12 B
// read and written, 0.34 MB at F = 28, B = 255: ~0.2 us at 3.35 TB/s) and
// a few hundred scalars; the pick is one block-wide argmax over L gains.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Field order and types must match ops/commit.py CommitArgs.
struct CommitArgs {
  // the one-kernel split's outputs (ops/partition.SplitOut)
  const int32_t* lt;          // (1,)
  const float* hists;         // (2, HF, HB, 3)
  const float* fout;          // (18,)
  const int64_t* iout;        // (6,)
  const uint8_t* bout;        // (2 + 2B,)
  // tree state (ops/commit.TreeState)
  int32_t* seg_tab;           // (L, 3) start, cnt, parity
  float* hist_pool;           // (L, HF, HB, 3)
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
  const int32_t* col_map;     // (F,) the feature's column, or null: itself
  uint8_t* leaf_used;         // (L, F) bool features used on each path
  uint8_t* tree_used;         // (F,) bool features the model has used
  int32_t* force_live;        // (1,) the tree's forced splits still hold
  const float* ffout;         // the forced-split scan's outputs (SplitOut,
  const int64_t* fiout;       // child 0), or null without forced splits
  const uint8_t* fbout;
  int32_t s, L, F, B, HF, HB, max_depth, has_monotone, n_forced, f_leaf,
      track_used;
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
  const int s = a.s, B = a.B;
  const int32_t* ph = a.hdr + (size_t)(s - 1) * kHdr;   // split s - 1
  const bool prev_live = s > 0 && ph[6] != 0;
  const int pleaf = prev_live ? ph[7] : 0;
  const size_t hsize = (size_t)a.HF * a.HB * 3;

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
  const int best = block_argmax(a.best_gain, a.L, s_g, s_i);
  const bool cont = s == 0 || prev_live;
  const bool forcing = cont && s < a.n_forced && a.force_live[0] != 0;
  const bool fok = forcing && a.ffout[0] > -INFINITY;   // NaN: not valid
  const float g_best = a.best_gain[best];
  // the picked split: the forced scan's child 0, or the best table's row
  const int leaf = fok ? a.f_leaf : best;
  const float gain = fok ? a.ffout[0] : g_best;
  const bool live = cont && (g_best > 0.f || forcing) && gain > -INFINITY;
  const int nw = s + 1;
  int32_t* hdr = a.hdr + (size_t)s * kHdr;
  __syncthreads();               // every thread has read the forcing word
  if (a.n_forced > 0 && t == 0 && !(live && !(forcing && !fok))) {
    a.force_live[0] = 0;
  }
  if (!live) {
    if (t == 0) hdr[6] = 0;
    return;
  }
  const int64_t feat = fok ? a.fiout[0] : a.best_feature[leaf];
  // ---- (c) record, (d) header ----
  const uint8_t* go = fok ? a.fbout + 2 : a.best_go + (size_t)leaf * B;
  for (int b = t; b < B; b += blockDim.x) {
    a.log_go[(size_t)s * B + b] = go[b];
  }
  if (a.track_used) {
    uint8_t* up = a.leaf_used + (size_t)leaf * a.F;
    uint8_t* un = a.leaf_used + (size_t)nw * a.F;
    for (int f = t; f < a.F; f += blockDim.x) {
      const uint8_t u = (up[f] != 0 || f == feat) ? 1 : 0;
      up[f] = u;
      un[f] = u;
    }
  }
  if (t != 0) return;
  const float* ls = fok ? a.ffout + 2 : a.best_ls + leaf * 3;
  const float* rs = fok ? a.ffout + 8 : a.best_rs + leaf * 3;
  const float lo = fok ? a.ffout[14] : a.best_lo[leaf];
  const float ro = fok ? a.ffout[16] : a.best_ro[leaf];
  a.log_leaf[s] = leaf;
  a.log_feat[s] = (int32_t)feat;
  a.log_bin[s] = (int32_t)(fok ? a.fiout[2] : a.best_bin[leaf]);
  a.log_kind[s] = (int32_t)(fok ? a.fiout[4] : a.best_kind[leaf]);
  a.log_dl[s] = fok ? a.fbout[0] : a.best_dl[leaf];
  a.log_gain[s] = gain;
  a.tree_used[feat] = 1;
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
  hdr[3] = a.col_map != nullptr ? a.col_map[feat] : (int32_t)feat;
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
      a.HF < 1 || a.HB < 1 || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  split_commit_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
