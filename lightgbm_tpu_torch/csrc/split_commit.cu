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
//   (c) when live, under the intermediate and advanced monotone methods
//       first re-clamp the picked split's outputs to its leaf's current
//       bounds (the scalar bounds; advanced: ops/monotone.adv_bounds_of of
//       the leaf at the split's (feature, bin), csrc/monotone.cuh
//       bound_at) and swap them where the sibling order fails (the JAX
//       tree loop's re-clamp); then record log entry s (leaf, feature,
//       bin, kind, default_left, gain, the children's sums and the
//       go-left row), the children's leaf sums, outputs and depth, the
//       monotone state: the basic method's bounds (both children bounded
//       by the midpoint of their outputs, monotone_constraints.hpp:327);
//       the intermediate method's (the new child inherits the parent's
//       scalar bounds, the boxes are cut, and each child bounds every
//       box-overlapping leaf wholly below or above it: a thread a leaf);
//       the advanced method's box cut (its per-bin bounds are the next
//       launch's, csrc/monotone.cu mono_commit); the features used on the children's
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
// `pooled` (fixed when the learner is built): the split scan already wrote
// the children into the pool (csrc/split_scan.cu, fold mode), so (a) skips
// the copy.
//
// Design (PR 20, from the stamps of PR 10's kernel at L = 255, F = 28:
// pool copy 1.0 us, scalar apply 1.5, pick 1.0, record 2.0, all but the
// copy in block 0's thread 0 or behind block barriers): block 0's warp 0
// does the scalar work with its lanes side by side: (a)'s table writes a
// lane a word, the pick as a warp argmax with shuffles (the new children's
// gains taken from registers, not read back), the picked leaf's dependent
// reads issued by lanes together and broadcast with shuffles, and the
// record, pair and header writes a lane a word; its other warps copy the
// routing rows. Block barriers are left only where the monotone methods
// (their arithmetic unchanged) need the whole block. Where the copy stays
// (the one-kernel split, EFB bundles), blocks 1.. copy the two children
// with 16-byte loads and stores, as many blocks as cover it in one wave.
// Nothing is read back to the host: a tree is a fixed sequence of launches
// (commit, split) x (L - 1) and a final commit, which a CUDA graph holds.
// The arithmetic is torch's op for op (the midpoint (lo + ro) * 0.5,
// NaN-propagating max and min; built with -fmad=false), so the state
// equals the host loop's and its plain twin's
// (ops/commit.split_commit_plain) bit for bit.
//
// What bounds it: latency. It moves two child histograms where it copies
// them (2 x HF x HB x 12 B read and written, 0.34 MB at F = 28, B = 255:
// ~0.2 us at 3.35 TB/s) and a few hundred scalars; the pick is one warp's
// argmax over L gains. The advanced re-clamp reduces the picked leaf's
// (F, B) bound rows in block 0 (a warp a feature), the intermediate
// refresh reads the (L, F) boxes twice a child.
//
// A measurement path: given a stamps buffer, thread 0 of each block
// writes %globaltimer at its entry and, in block 0, after (a), after the
// pick and at its end; a copy block at the end of its copy
// (ops/commit.COMMIT_PHASES); with a null pointer it writes nothing.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "monotone.cuh"
#include "smem.cuh"

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
  int32_t* rng_lo;            // (L, F) each leaf's bin box [lo, hi)
  int32_t* rng_hi;
  const float* cons_lo;       // (L, F, B) advanced bounds (mono_method 2)
  const float* cons_hi;
  uint64_t* stamps;           // null, or (blocks, kStamps) %globaltimer ns
  int32_t s, L, F, B, HF, HB, max_depth, has_monotone, n_forced, f_leaf,
      track_used, mono_method,   // 0 basic, 1 intermediate, 2 advanced
      pooled;                    // the split scan pooled the children
};

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kHdr = 8;
constexpr int kPair = 12;
constexpr int kStamps = 5;            // stamp slots per block

__device__ __forceinline__ void stamp(const CommitArgs& a, int i) {
  if (a.stamps != nullptr && threadIdx.x == 0) {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.stamps[(size_t)blockIdx.x * kStamps + i] = t;
  }
}

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

// A gain's place in better()'s order as an unsigned word: NaN above
// everything, then the value (-0 and +0 tie, as `>` has them).
__device__ __forceinline__ uint32_t order_bits(float g) {
  if (isnan(g)) return 0xffffffffu;
  const uint32_t u = __float_as_uint(g == 0.f ? 0.f : g);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Blocks 1..: the two child histograms into the pool rows of the parent
// (the left child) and of slot s (the right one), 16-byte loads and stores
// where the rows are aligned; one thread writes an element of both rows,
// left then right, as the twin does (the right one wins where the rows
// are one).
__device__ void copy_children(const CommitArgs& a, int pleaf) {
  const size_t hsize = (size_t)a.HF * a.HB * 3;
  float* dl = a.hist_pool + (size_t)pleaf * hsize;
  float* dr = a.hist_pool + (size_t)a.s * hsize;
  const float* sr = a.hists + hsize;
  const size_t step = (size_t)(gridDim.x - 1) * blockDim.x;
  const size_t first = (size_t)(blockIdx.x - 1) * blockDim.x + threadIdx.x;
  const bool aligned = (hsize & 3) == 0 &&
      (((uintptr_t)a.hists | (uintptr_t)a.hist_pool) & 15) == 0;
  if (aligned) {
    const float4* l4 = reinterpret_cast<const float4*>(a.hists);
    const float4* r4 = reinterpret_cast<const float4*>(sr);
    for (size_t i = first; i < (hsize >> 2); i += step) {
      const float4 l = l4[i], r = r4[i];
      reinterpret_cast<float4*>(dl)[i] = l;
      reinterpret_cast<float4*>(dr)[i] = r;
    }
  } else {
    for (size_t i = first; i < hsize; i += step) {
      const float l = a.hists[i], r = sr[i];
      dl[i] = l;
      dr[i] = r;
    }
  }
}

// The record's words of the picked split that warp 0 read: its gain and
// default-left flag, the children's sums, the leaf's depth and segment,
// the tree's split count, the leaf's and the new leaf's bounds [lower
// leaf, upper leaf, lower new, upper new].
struct Rec {
  float gain, sums[6], bounds[4];
  int dl, depth, seg[3], splits;
};

// The picked split as block 0's warp 0 resolved it, for the other warps
// where the monotone methods or the used features need the whole block.
struct Pick {
  int live, leaf, feat, tbin, kind;
  float lo, ro;
};

__global__ void __launch_bounds__(kThreads, 1)
split_commit_kernel(const CommitArgs a) {
  extern __shared__ float smem[];   // advanced: 2F + 8 x 8 + 2 floats
  __shared__ Pick sp;
  const int s = a.s, B = a.B, L = a.L, F = a.F;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int32_t* ph = a.hdr + (size_t)(s > 0 ? s - 1 : 0) * kHdr;
  const int method = a.has_monotone ? a.mono_method : 0;
  // the whole block takes part after the pick only for these
  const bool block_work = method != 0 || a.track_used != 0;
  const bool picks = s < L - 1;          // the final commit only applies
  const bool forced = s < a.n_forced;
  // ---- round A: warp 0 issues every read that needs no pick at once:
  // split s - 1's header and outputs (read whether or not it ran), the
  // best gains, the forcing words ----
  const int p6 = s > 0 ? ph[6] : 0, p7 = ph[7];
  // lane 1 + 13c + k: child c's word k of the best table (0 its gain, 1-3
  // its feature, bin and kind, 4 its default-left flag, 5-10 its sums,
  // 11-12 its outputs); lane 0 the left count, 27-29 ph[0..2], 30 ph[5]:
  // each lane's address first, then one load a word type, so no lane's
  // load waits on another's
  const int c = (lane - 1) / 13, fld = (lane - 1) % 13;
  const bool mine = lane >= 1 && lane <= 26;
  int64_t v64 = 0;
  int v8 = 0, pw = 0;
  float v32 = 0.f;
  float ng[2] = {0.f, 0.f};
  constexpr int kPer = 8;        // gains a lane loads ahead of its compares
  float gv[kPer];
  int fl = 0;
  float f0 = 0.f;
  if (warp == 0) {
    if (s > 0) {
      const int64_t* p64 = mine && fld >= 1 && fld <= 3
          ? a.iout + (fld - 1) * 2 + c : nullptr;
      const uint8_t* p8 = mine && fld == 4 ? a.bout + c : nullptr;
      const float* p32 = !mine || fld < 5 ? nullptr
          : fld < 8 ? a.fout + 2 + c * 3 + fld - 5
          : fld < 11 ? a.fout + 8 + c * 3 + fld - 8
          : a.fout + 14 + (fld - 11) * 2 + c;
      const int32_t* pi = lane == 0 ? a.lt
          : lane >= 27 && lane <= 29 ? ph + lane - 27
          : lane == 30 ? ph + 5 : nullptr;
      ng[0] = a.fout[0];
      ng[1] = a.fout[1];
      if (p64 != nullptr) v64 = *p64;
      if (p8 != nullptr) v8 = *p8;
      if (p32 != nullptr) v32 = *p32;
      if (pi != nullptr) pw = *pi;
    }
    if (picks) {
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int i = u * 32 + lane;
        gv[u] = i < L ? a.best_gain[i] : -INFINITY;
      }
      if (forced) {
        fl = a.force_live[0];
        f0 = a.ffout[0];
      }
    }
  }
  const bool prev_live = s > 0 && p6 != 0;     // split s - 1 ran
  const int pleaf = prev_live ? p7 : 0;
  stamp(a, 0);
  if (blockIdx.x != 0) {
    if (prev_live && !a.pooled) copy_children(a, pleaf);
    stamp(a, 4);
    return;
  }
  // ---- (a) split s - 1's routing rows (every thread) ----
  if (prev_live) {
    for (int b = t; b < B; b += blockDim.x) {
      a.best_go[(size_t)pleaf * B + b] = a.bout[2 + b];
      a.best_go[(size_t)s * B + b] = a.bout[2 + B + b];
    }
  }
  if (warp != 0 && !(block_work && picks)) return;
  float lo = 0.f, ro = 0.f;
  int leaf = 0, feat = 0, tbin = 0, kind = 0, live = 0;
  Rec rec;
  if (warp == 0) {
    const int dcut = __shfl_sync(kFull, pw, 30);
    const bool cut = prev_live && a.max_depth > 0 && dcut >= a.max_depth;
    // the children's gains into the best table
    const float ng0 = cut ? -INFINITY : ng[0], ng1 = cut ? -INFINITY : ng[1];
    if (prev_live) {
      // ---- (a) the scalar state of split s - 1, a lane a word ----
      const int lt = __shfl_sync(kFull, pw, 0);
      const int src = __shfl_sync(kFull, pw, 27);
      const int start = __shfl_sync(kFull, pw, 28);
      const int cnt = __shfl_sync(kFull, pw, 29);
      if (lane == 0) {
        const int npar = 1 - src;
        a.seg_tab[s * 3 + 0] = start + lt;
        a.seg_tab[s * 3 + 1] = cnt - lt;
        a.seg_tab[s * 3 + 2] = npar;
        a.seg_tab[pleaf * 3 + 1] = lt;
        a.seg_tab[pleaf * 3 + 2] = npar;
      }
      // child 0's lanes write, then child 1's (its row wins where the
      // slots are one, as in the twin): a store a word type
      const int slot = c == 0 ? pleaf : s;
      float* d32 = !mine ? nullptr
          : fld == 0 ? a.best_gain + slot
          : fld >= 5 && fld < 8 ? a.best_ls + slot * 3 + fld - 5
          : fld >= 8 && fld < 11 ? a.best_rs + slot * 3 + fld - 8
          : fld == 11 ? a.best_lo + slot
          : fld == 12 ? a.best_ro + slot : nullptr;
      int64_t* d64 = !mine || fld < 1 || fld > 3 ? nullptr
          : (fld == 1 ? a.best_feature : fld == 2 ? a.best_bin
                                                 : a.best_kind) + slot;
      uint8_t* d8 = mine && fld == 4 ? a.best_dl + slot : nullptr;
      const float f32 = fld == 0 ? (c == 0 ? ng0 : ng1) : v32;
      for (int cc = 0; cc < 2; ++cc) {
        if (c == cc) {
          if (d32 != nullptr) *d32 = f32;
          if (d64 != nullptr) *d64 = v64;
          if (d8 != nullptr) *d8 = (uint8_t)v8;
        }
        __syncwarp();
      }
    }
    stamp(a, 1);
    if (!picks) return;
    // ---- (b) pick split s: the first maximum of the best gains, the new
    // children's from registers (child 1's where the slots are one) ----
    float g = -INFINITY;
    int best = INT32_MAX;
    for (int i0 = 0; i0 < L; i0 += 32 * kPer) {
      if (i0 > 0) {
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int i = i0 + u * 32 + lane;
          gv[u] = i < L ? a.best_gain[i] : -INFINITY;
        }
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int i = i0 + u * 32 + lane;
        if (i >= L) continue;
        const float gi = prev_live && i == s ? ng1
                       : prev_live && i == pleaf ? ng0 : gv[u];
        if (better(gi, i, g, best)) {
          g = gi;
          best = i;
        }
      }
    }
    {
      // the warp's first maximum: two reductions (the gain's order, then
      // the smaller index among the lanes that hold it) and the winning
      // lane's own gain
      const uint32_t hi = order_bits(g);
      const uint32_t lo = 0x7fffffffu - (uint32_t)best;
      const uint32_t hmax = __reduce_max_sync(kFull, hi);
      const uint32_t lmax = __reduce_max_sync(kFull, hi == hmax ? lo : 0u);
      const int src =
          __ffs(__ballot_sync(kFull, hi == hmax && lo == lmax)) - 1;
      g = __shfl_sync(kFull, g, src);
      best = __shfl_sync(kFull, best, src);
    }
    const bool cont = s == 0 || prev_live;
    const bool forcing = cont && forced && fl != 0;
    const bool fok = forcing && f0 > -INFINITY;   // NaN: not valid
    // the picked split: the forced scan's child 0, or the best table's row
    leaf = fok ? a.f_leaf : best;
    const float gain = fok ? f0 : g;
    live = cont && (g > 0.f || forcing) && gain > -INFINITY;
    const int nw = s + 1;
    if (lane == 0) {
      if (a.n_forced > 0 && !(live && !(forcing && !fok))) {
        a.force_live[0] = 0;
      }
      if (!live) a.hdr[(size_t)s * kHdr + 6] = 0;
    }
    // ---- round B: the picked row, the record's words and the routing
    // row, read by lanes side by side ----
    const float* lsp = fok ? a.ffout + 2 : a.best_ls + leaf * 3;
    const float* rsp = fok ? a.ffout + 8 : a.best_rs + leaf * 3;
    // split s - 1's rows of the best table were written above: their
    // routing rows are the split outputs'
    const uint8_t* go = fok ? a.fbout + 2
        : prev_live && leaf == s ? a.bout + 2 + B
        : prev_live && leaf == pleaf ? a.bout + 2
        : a.best_go + (size_t)leaf * B;
    // lanes 0-2 the split's feature, bin and kind (64-bit words), 3 its
    // default-left flag, 4-5 its outputs, 6-11 its children's sums, 12 the
    // leaf's depth, 13-15 its segment, 16-19 the two leaves' bounds, 20 the
    // split count: each lane's address, then one load a word type
    const int64_t* q64 = !live || lane > 2 ? nullptr
        : fok ? a.fiout + lane * 2
        : (lane == 0 ? a.best_feature : lane == 1 ? a.best_bin
                                                  : a.best_kind) + leaf;
    const uint8_t* q8 = live && lane == 3
        ? (fok ? a.fbout : a.best_dl + leaf) : nullptr;
    const void* q32 = nullptr;
    if (live && lane >= 4 && lane <= 20) {
      q32 = lane == 4 ? (fok ? a.ffout + 14 : a.best_lo + leaf)
          : lane == 5 ? (fok ? a.ffout + 16 : a.best_ro + leaf)
          : lane < 9 ? lsp + lane - 6
          : lane < 12 ? rsp + lane - 9
          : lane == 12 ? (const void*)(a.depth + leaf)
          : lane < 16 ? (const void*)(a.seg_tab + leaf * 3 + lane - 13)
          : lane == 16 ? a.leaf_lower + leaf
          : lane == 17 ? a.leaf_upper + leaf
          : lane == 18 ? a.leaf_lower + nw
          : lane == 19 ? a.leaf_upper + nw
          : (const void*)a.num_splits;
    }
    // three registers: a load into one waits for no other
    int64_t w64 = 0;
    int w8 = 0, w32 = 0;
    if (q64 != nullptr) w64 = *q64;
    if (q8 != nullptr) w8 = *q8;
    if (q32 != nullptr) w32 = *reinterpret_cast<const int*>(q32);
    if (live) {
      // the routing row in chunks of 8 bytes a lane, each chunk's loads
      // ahead of its stores
      for (int b0 = 0; b0 < B; b0 += 32 * 8) {
        uint8_t gb[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int b = b0 + u * 32 + lane;
          gb[u] = b < B ? go[b] : 0;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int b = b0 + u * 32 + lane;
          if (b < B) a.log_go[(size_t)s * B + b] = gb[u];
        }
      }
    }
    const int w = lane < 3 ? (int)w64 : lane == 3 ? w8 : w32;
    feat = __shfl_sync(kFull, w, 0);
    tbin = __shfl_sync(kFull, w, 1);
    kind = __shfl_sync(kFull, w, 2);
    rec.dl = __shfl_sync(kFull, w, 3);
    lo = __int_as_float(__shfl_sync(kFull, w, 4));
    ro = __int_as_float(__shfl_sync(kFull, w, 5));
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      rec.sums[k] = __int_as_float(__shfl_sync(kFull, w, 6 + k));
    }
    rec.depth = __shfl_sync(kFull, w, 12);
#pragma unroll
    for (int k = 0; k < 3; ++k) rec.seg[k] = __shfl_sync(kFull, w, 13 + k);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      rec.bounds[k] = __int_as_float(__shfl_sync(kFull, w, 16 + k));
    }
    rec.splits = __shfl_sync(kFull, w, 20);
    rec.gain = gain;
    if (lane == 0 && block_work) {
      sp.live = live;
      sp.leaf = leaf;
      sp.feat = feat;
      sp.tbin = tbin;
      sp.kind = kind;
      sp.lo = lo;
      sp.ro = ro;
    }
  }
  if (block_work) {
    __syncthreads();             // the pick is every thread's
    live = sp.live;
    leaf = sp.leaf;
    feat = sp.feat;
    tbin = sp.tbin;
    kind = sp.kind;
    lo = sp.lo;
    ro = sp.ro;
  }
  stamp(a, 2);
  if (!live) return;
  const int nw = s + 1;
  if (method != 0) {
    // ---- (c) the re-clamp to the leaf's current bounds, then the swap
    float bl[4];
    if (method == 2) {
      const size_t row = (size_t)leaf * F;
      lgbt_mono::bound_at(a.cons_lo + row * B, a.cons_hi + row * B,
                          a.rng_lo + row, a.rng_hi + row, F, B, feat, tbin,
                          smem, smem + F, smem + 2 * F, bl);
    } else {
      bl[0] = bl[2] = a.leaf_lower[leaf];
      bl[1] = bl[3] = a.leaf_upper[leaf];
    }
    const float wl = tmin(tmax(lo, bl[0]), bl[1]);
    const float wr = tmin(tmax(ro, bl[2]), bl[3]);
    const int mono = a.monotone[feat];
    const bool swap = (mono > 0 && wl > wr) || (mono < 0 && wl < wr);
    lo = swap ? wr : wl;
    ro = swap ? wl : wr;
  }
  if (a.track_used) {
    uint8_t* up = a.leaf_used + (size_t)leaf * F;
    uint8_t* un = a.leaf_used + (size_t)nw * F;
    for (int f = t; f < F; f += blockDim.x) {
      const uint8_t u = (up[f] != 0 || f == feat) ? 1 : 0;
      up[f] = u;
      un[f] = u;
    }
  }
  if (method != 0) {
    // ---- the boxes: a numerical winner cuts the split feature's ----
    __syncthreads();     // every thread has read the leaf's bounds
    if (method == 1 && t == 0) {
      a.leaf_lower[nw] = a.leaf_lower[leaf];
      a.leaf_upper[nw] = a.leaf_upper[leaf];
    }
    for (int f = t; f < F; f += blockDim.x) {
      const int p_rlo = a.rng_lo[(size_t)leaf * F + f];
      const int p_rhi = a.rng_hi[(size_t)leaf * F + f];
      const bool cutf = kind == 0 && f == feat;
      a.rng_lo[(size_t)nw * F + f] = cutf ? tbin + 1 : p_rlo;
      a.rng_hi[(size_t)nw * F + f] = p_rhi;
      if (cutf) a.rng_hi[(size_t)leaf * F + f] = tbin + 1;
    }
    __syncthreads();
    if (method == 1) {
      // ---- the neighbour refresh: child c (left, then right) bounds
      // every leaf that overlaps its box in all features but one and lies
      // wholly below (above) it in a monotone one
      for (int l = t; l < L; l += blockDim.x) {
        const int32_t* lr0 = a.rng_lo + (size_t)l * F;
        const int32_t* lr1 = a.rng_hi + (size_t)l * F;
        float up = a.leaf_upper[l], lw = a.leaf_lower[l];
        for (int ch = 0; ch < 2; ++ch) {
          const size_t crow = (size_t)(ch == 0 ? leaf : nw) * F;
          const int32_t* c0 = a.rng_lo + crow;
          const int32_t* c1 = a.rng_hi + crow;
          int nfalse = 0;
          for (int f = 0; f < F; ++f) {
            nfalse += !(lr0[f] < c1[f] && c0[f] < lr1[f]);
          }
          bool hi_m = false, lo_m = false;
          for (int f = 0; f < F; ++f) {
            const bool ov = lr0[f] < c1[f] && c0[f] < lr1[f];
            const bool ov_exc = nfalse == 0 || (nfalse == 1 && !ov);
            const int m = a.monotone[f];
            const bool below = lr1[f] <= c0[f], above = lr0[f] >= c1[f];
            hi_m |= ov_exc && ((m > 0 && below) || (m < 0 && above));
            lo_m |= ov_exc && ((m > 0 && above) || (m < 0 && below));
          }
          const float out = ch == 0 ? lo : ro;
          if (hi_m) up = tmin(up, out);
          if (lo_m) lw = tmax(lw, out);
        }
        a.leaf_upper[l] = up;
        a.leaf_lower[l] = lw;
      }
      __syncthreads();
    }
  }
  if (warp != 0) return;
  // ---- (c) the log, leaf and pair rows, (d) the header: a lane a word,
  // from the words warp 0 read with the pick ----
  if (method != 0) {             // the refresh may have moved the bounds
    float bv = 0.f;
    if (lane < 4) {
      bv = lane & 1 ? a.leaf_upper[lane < 2 ? leaf : nw]
                    : a.leaf_lower[lane < 2 ? leaf : nw];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) rec.bounds[k] = __shfl_sync(kFull, bv, k);
  }
  int iv = feat;
  if (lane == 0 && a.col_map != nullptr) {
    iv = a.col_map[feat];
  } else if (lane == 1 && a.has_monotone) {
    iv = a.monotone[feat];
  }
  const int col = __shfl_sync(kFull, iv, 0), mono = __shfl_sync(kFull, iv, 1);
  const int cd = rec.depth + 1;      // the children's depth
  float lo_p = rec.bounds[0], up_p = rec.bounds[1];
  float lo_n = rec.bounds[2], up_n = rec.bounds[3];
  if (a.has_monotone && method == 0) {
    // basic method: both children bounded by the split midpoint
    const float mid = (lo + ro) * 0.5f;
    lo_n = mono > 0 ? tmax(lo_p, mid) : lo_p;
    up_n = mono < 0 ? tmin(up_p, mid) : up_p;
    lo_p = mono < 0 ? tmax(lo_p, mid) : lo_p;
    up_p = mono > 0 ? tmin(up_p, mid) : up_p;
  }
  float* pr = a.pair + (size_t)s * kPair;
  int32_t* hdr = a.hdr + (size_t)s * kHdr;
  // each lane's targets first (up to three 32-bit words and a byte, in
  // registers), then one store a target: the lanes' paths hold no memory
  // operation
  int* d0 = nullptr;
  int* d1 = nullptr;
  int* d2 = nullptr;
  int v0 = 0, v1 = 0, v2 = 0;
  uint8_t* db = nullptr;
  uint8_t bv = 0;
  const bool basic = a.has_monotone && method == 0;
  const int fi = __float_as_int(lo), ri = __float_as_int(ro);
  if (lane == 0) {
    d0 = a.log_leaf + s; v0 = leaf; d1 = hdr + 7; v1 = leaf;
  } else if (lane == 1) {
    d0 = a.log_feat + s; v0 = feat;
  } else if (lane == 2) {
    d0 = a.log_bin + s; v0 = tbin;
  } else if (lane == 3) {
    d0 = a.log_kind + s; v0 = kind;
  } else if (lane == 4) {
    db = a.log_dl + s; bv = (uint8_t)rec.dl;
  } else if (lane == 5) {
    d0 = reinterpret_cast<int*>(a.log_gain + s);
    v0 = __float_as_int(rec.gain);
  } else if (lane == 6) {
    db = a.tree_used + feat; bv = 1;
  } else if (lane == 7) {
    d0 = a.num_splits; v0 = rec.splits + 1;
  } else if (lane == 8) {
    d0 = reinterpret_cast<int*>(a.leaf_out + leaf); v0 = fi;
    d1 = reinterpret_cast<int*>(pr + 6); v1 = fi;
  } else if (lane == 9) {
    d0 = reinterpret_cast<int*>(a.leaf_out + nw); v0 = ri;
    d1 = reinterpret_cast<int*>(pr + 7); v1 = ri;
  } else if (lane == 10) {
    d0 = a.depth + leaf; v0 = cd; d1 = hdr + 5; v1 = cd;
  } else if (lane == 11) {
    d0 = a.depth + nw; v0 = cd; d1 = hdr + 6; v1 = 1;
  } else if (lane < 16) {
    // the pair row's bounds [lower leaf, lower new, upper leaf, upper
    // new]; the basic method's midpoint bounds into the leaves too
    const int j = lane - 12;
    const float bnd = j == 0 ? lo_p : j == 1 ? lo_n : j == 2 ? up_p : up_n;
    float* leaf_b = (j & 2 ? a.leaf_upper : a.leaf_lower) + (j & 1 ? nw
                                                                   : leaf);
    d0 = reinterpret_cast<int*>(pr + 8 + j); v0 = __float_as_int(bnd);
    if (basic) {
      d1 = reinterpret_cast<int*>(leaf_b); v1 = v0;
    }
  } else if (lane == 16) {
    d0 = hdr; v0 = rec.seg[2]; d1 = hdr + 1; v1 = rec.seg[0];
  } else if (lane == 17) {
    d0 = hdr + 2; v0 = rec.seg[1]; d1 = hdr + 3; v1 = col;
  } else if (lane == 18) {
    d0 = hdr + 4; v0 = rec.sums[2] <= rec.sums[5] ? 1 : 0;
  } else if (lane < 25) {        // the children's sums
    const int k = lane - 19, j = k % 3;
    const float sk = k == 0 ? rec.sums[0] : k == 1 ? rec.sums[1]
                   : k == 2 ? rec.sums[2] : k == 3 ? rec.sums[3]
                   : k == 4 ? rec.sums[4] : rec.sums[5];
    v0 = v1 = v2 = __float_as_int(sk);
    d0 = reinterpret_cast<int*>((k < 3 ? a.log_ls : a.log_rs) + s * 3 + j);
    d1 = reinterpret_cast<int*>(a.leaf_sum + (k < 3 ? leaf : nw) * 3 + j);
    d2 = reinterpret_cast<int*>(pr + k);
  }
  if (d0 != nullptr) *d0 = v0;
  if (d1 != nullptr) *d1 = v1;
  if (d2 != nullptr) *d2 = v2;
  if (db != nullptr) *db = bv;
  stamp(a, 3);
}

}  // namespace

extern "C" {

const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Commit args->s of a tree on `stream` with `blocks` blocks (block 0 does
// the scalar work; blocks 1.. copy the histograms unless args->pooled).
// Returns a cudaError_t code (0 on success).
int split_commit(const CommitArgs* args, int blocks, void* stream) {
  const CommitArgs a = *args;
  if (a.s < 0 || a.s >= a.L || a.L < 2 || a.F < 1 || a.B < 1 ||
      a.HF < 1 || a.HB < 1 || blocks < 1 || (!a.pooled && blocks < 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the advanced re-clamp's row extrema and reductions in block 0
  const size_t smem = a.has_monotone && a.mono_method == 2
      ? (2 * (size_t)a.F + 8 * (kThreads / 32) + 2) * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    thread_local int raised[lgbt_smem::kMaxDevices] = {};
    const cudaError_t rc = lgbt_smem::raise_once(
        reinterpret_cast<const void*>(split_commit_kernel), raised);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  split_commit_kernel<<<blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
