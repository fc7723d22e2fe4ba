// One split in one cooperative launch, for Hopper (sm_90a): the partition
// of the parent's segment, the smaller child's histogram and both
// children's split scan.
//
// Replaces the TPU kernel lightgbm_tpu/ops/partition.py:
// one_kernel_split_planes (pallas_call "one_kernel_split_planes", body
// _one_kernel_split_kernel), in both of its modes: planes (entry point
// one_kernel_split) and resident (entry point one_kernel_split_resident,
// the TPU kernel's resident_planes argument). Same contract: work is the
// (2, W, Npad) u8 plane pair of ops/partition.py; seg = [src, start, cnt,
// col]; the parent's rows [start, start + cnt) of plane src are routed
// into plane 1 - src by the (B,) go-left table, left rows first; the
// smaller child (the left one when left_smaller) gets a fresh histogram,
// the larger one is parent minus smaller; then ops/split.find_best_split
// runs on both children with node_depth = depth, and each child's
// SplitInfo is written out.
//
// Resident mode: work is the slim pair (W = 17, csrc/resident.cuh) and
// col is the split column of the resident bin planes res (F, npad_res).
// Before each partition tile is counted, the block that owns it gathers
// its rows' route bytes res[col][ridx] into plane 0 of plane src (the
// route gather of csrc/resident_route.cu: 4-lane words, 5 per thread,
// their loads issued together; the same block scatters that tile later,
// so no grid barrier is added); phase A then routes on plane 0, and phase
// B gathers the smaller child's bins through ridx (segment_hist.cuh
// ResidentRows). The routed bytes equal the route gather + K3 chain's, and
// the child histograms equal K4 planes' on the same rows, bit for bit.
//
// Phases; every phase walks its work items grid-stride, so any co-resident
// grid size gives the same result:
//   A. partition: (resident: the tile's route gather, then) K3's
//      per-tile count and stable scatter (segment_partition.cuh) over
//      4096-row tiles. After a grid barrier each block sums the per-tile
//      counts of the tiles before its own (integer sums: the tile-order
//      prefix) and their total, lt. The routed bytes and lt equal
//      partition_segment's. Grid barrier.
//   B. smaller-child histogram: K4's work items (segment_hist.cuh
//      hist_chunk) over (chunk, 2-feature group), the chunk count read on
//      the card from the smaller child's true row count, so there are no
//      empty items. Each writes its chunk partial. Grid barrier.
//   C. per (child, feature) item, one thread per bin: the feature's chunk
//      partials summed in chunk order and hi + lo (K4's reduce), the
//      child's row (the sums, or parent - sums for the larger child),
//      then every split candidate of the feature as find_best_split
//      evaluates them (numerical thresholds in both missing directions,
//      one-vs-rest and many-vs-many categorical prefixes), keeping the
//      first maximum of each kind. Each item then takes a ticket (an
//      atomic counter after a __threadfence); the block that takes the
//      last one picks each child's flat first maximum over (kind, feature,
//      bin), kind outermost, in one block-wide reduction, and builds the
//      routing table, the child sums and the outputs.
// hist_left and hist_right are bit-equal to K3 + K4 + the torch
// subtraction on the same input: the same code sums the same values in an
// order fixed by the rows alone (no float atomics), whatever the grid.
// Phase C follows torch's arithmetic op by op: this file is compiled with
// -fmad=false so no multiply-add is contracted, and the scalar
// hyperparameters arrive as the float32 values torch would use. Prefix
// sums accumulate in double and round each to float, as torch's CPU
// cumsum does, one thread per channel (on the card torch's cumsum sums in
// float in another order, so gains agree with the twin on the card at a
// tolerance, not bit for bit). NaN gains are never live;
// torch.maximum/minimum propagate NaN and so do the helpers here; the
// stable many-vs-many orders are ranks (count of smaller keys plus equal
// keys at a lower bin, NaN last).
//
// Why one cooperative launch: a stable partition needs a scan across
// blocks, the histogram needs the routed rows, the scan needs the whole
// histogram, and on Hopper nothing carries from block to block without a
// grid barrier, a ticket or another launch. A launch with <<<>>> would
// leave grid.sync() undefined; the entry point launches with
// cudaLaunchCooperativeKernel and sizes the grid to the blocks that fit
// on the card at once (occupancy x SMs, queried once per device and
// shared-memory size).
//
// What bounds it on this card: bytes at the root, latency on small
// segments. The function must read and write each parent row once (80 B
// per row at W = 40: 160 MB at the 2M-row root split) and read the
// parent and child histograms (~3 x F x B x 12 B, 0.26 MB): ~0.048 ms at
// 3.35 TB/s. This design reads the smaller child's rows a second time in
// phase B (40 B per row) and writes and reads its chunk partials (143 KB
// each way per 2048 rows). On the many small segments of a 255-leaf tree
// the time is latency: 3 grid barriers (~1 us each), the scatter's
// load-store rounds (2 rows x 8 planes per round), a chunk's tiles, and
// phase C's sequential per-channel prefix sums (256 steps). In resident
// mode the function moves the slim payload (17 B per row each way), each
// parent row's gathered route byte and the smaller child's F gathered
// bins: 2 x 17 x N + N + F x n_small bytes and the histograms, ~0.0285 ms
// at the 2M root.
//
// A measurement path: given a stamps buffer, thread 0 of each block writes
// %globaltimer at the kernel's entry, before and after each grid barrier,
// after phase C's items and (the block that takes the last ticket) at its
// end (ops/partition.ONE_KERNEL_PHASES); with a null pointer it writes
// nothing.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "segment_hist.cuh"
#include "segment_partition.cuh"

namespace cg = cooperative_groups;

// Field order and types must match ops/partition.py OneKernelArgs.
struct OneKernelArgs {
  uint8_t* work;
  const int32_t* seg;          // [src, start, cnt, col]
  const uint8_t* table;        // (table_bins,) bool
  const float* parent;         // (F, B, 3)
  const int32_t* num_bins;     // FeatureMeta columns, (F,) each
  const uint8_t* movable;
  const int32_t* missing_bin;
  const uint8_t* is_cat;
  const int8_t* monotone;
  const float* penalty;
  const uint8_t* fmask;        // (F,) bool
  const float* sums2;          // (2, 3)
  const float* outs2;          // (2,)
  const float* lows2;
  const float* ups2;
  int32_t* counts;             // scratch (part tiles,)
  float* partial;              // scratch (chunks, F, B, nch)
  int32_t* done;               // scratch (1,): phase C's ticket, 0 at rest
  float* cand_gain;            // scratch (2, 4, F)
  int32_t* cand_bin;           // scratch (2, 4, F)
  uint8_t* num_dl;             // scratch (2, F, B)
  uint8_t* rank;               // scratch (2, 2, F, B)
  int32_t* lt;                 // (1,)
  float* hist_left;            // (F, B, 3)
  float* hist_right;
  float* gain;                 // (2,)
  int64_t* feature;            // (2,)
  int64_t* bin;
  int64_t* kind;
  uint8_t* default_left;       // (2,) bool
  uint8_t* go_left;            // (2, B) bool
  float* left_sum;             // (2, 3)
  float* right_sum;
  float* left_output;          // (2,)
  float* right_output;
  const uint8_t* res;          // resident mode: (F, npad_res) bin planes
  uint64_t* stamps;            // null, or (grid, kStamps) %globaltimer ns
  int32_t W, npad, table_bins, left_smaller, depth, F, B, nch, groups,
      max_cat_to_onehot, has_categorical, has_monotone, use_mono_penalty,
      npad_res;
  float lambda_l1, lambda_l2, two_l1, l2_cat, min_data_in_leaf,
      min_sum_hessian, min_gain_to_split, max_delta_step, cat_smooth, cat_l2,
      min_data_per_group, path_smooth, monotone_penalty, max_cat_threshold;
};

namespace {

constexpr int kThreads = lgbt_part::kPartThreads;   // 256, one per bin
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBins = 256;
constexpr float kEpsilon = 1e-15f;   // ops/split.py K_EPSILON
constexpr int kItemFeats = 2;        // features of a phase B work item
constexpr int kStamps = 9;           // stamp slots per block

// Thread 0 of the block writes %globaltimer into its slot i of the
// measurement path's stamps; with a null pointer it does nothing.
__device__ __forceinline__ void stamp(const OneKernelArgs& a, int i) {
  if (a.stamps != nullptr && threadIdx.x == 0) {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.stamps[(size_t)blockIdx.x * kStamps + i] = t;
  }
}

// ------------------------------------------------------------ float helpers
// torch semantics: maximum/minimum/clamp propagate NaN (fmaxf does not).
__device__ __forceinline__ float tmax(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float tsign(float x) {   // torch.sign: NaN -> 0
  return (float)((0.f < x) - (x < 0.f));
}

// calc_leaf_output: -TL1(g) / (h + l2 + extra), clipped by max_delta_step
__device__ __forceinline__ float leaf_output(const OneKernelArgs& a, float g,
                                             float h, float extra) {
  const float denom = (h + a.lambda_l2) + extra;
  float w = 0.f;
  if (denom > 0.f) {
    const float t = tsign(g) * tmax(fabsf(g) - a.lambda_l1, 0.f);
    w = (-t) / fmaxf(denom, 1e-38f);
  }
  if (a.max_delta_step > 0.f) {
    w = tmin(tmax(w, -a.max_delta_step), a.max_delta_step);
  }
  return w;
}

// _smoothed: w * n/(n+s) + parent * (1 - n/(n+s))
__device__ __forceinline__ float smoothed(const OneKernelArgs& a, float w,
                                          float cnt, float po) {
  if (!(a.path_smooth > 0.f)) return w;
  const float n = tmax(cnt, 1.f);
  const float alpha = n / (n + a.path_smooth);
  return w * alpha + po * (1.f - alpha);
}

// GetLeafGainGivenOutput with l2 = lambda_l2 (+ cat_l2)
__device__ __forceinline__ float gain_given(const OneKernelArgs& a, float g,
                                            float h, float w, float l2) {
  const float x = (2.f * g) * w;
  const float y = ((h + l2) * w) * w;
  return -(x + y) - a.two_l1 * fabsf(w);
}

// _split_gain_pair -> gain; *ok false on a monotone violation. Numerical
// candidates (cat = false) carry the monotone test and bounds when the
// model has monotone constraints; categorical ones use cat_l2.
__device__ __forceinline__ float split_gain(const OneKernelArgs& a, float gl,
                                            float hl, float cl, float gr,
                                            float hr, float cr, bool cat,
                                            float po, float lo, float up,
                                            int mono, bool* ok) {
  const float extra = cat ? a.cat_l2 : 0.f;
  const float l2 = cat ? a.l2_cat : a.lambda_l2;
  float wl = smoothed(a, leaf_output(a, gl, hl, extra), cl, po);
  float wr = smoothed(a, leaf_output(a, gr, hr, extra), cr, po);
  *ok = true;
  if (!cat && a.has_monotone) {
    *ok = !((mono > 0 && wl > wr) || (mono < 0 && wl < wr));
    wl = tmin(tmax(wl, lo), up);
    wr = tmin(tmax(wr, lo), up);
  }
  return gain_given(a, gl, hl, wl, l2) + gain_given(a, gr, hr, wr, l2);
}

__device__ __forceinline__ bool data_ok(const OneKernelArgs& a, float cl,
                                        float hl, float cr, float hr) {
  return cl >= a.min_data_in_leaf && cr >= a.min_data_in_leaf &&
         hl >= a.min_sum_hessian && hr >= a.min_sum_hessian;
}

// First-maximum order of torch.argmax: NaN above everything, then the
// larger value, then the smaller index.
__device__ __forceinline__ bool better(float g1, int i1, float g0, int i0) {
  const bool n1 = isnan(g1), n0 = isnan(g0);
  if (n1 != n0) return n1;
  if (n1) return i1 < i0;
  return g1 > g0 || (g1 == g0 && i1 < i0);
}

// Stable ascending order with NaN last (torch.argsort(stable=True)).
__device__ __forceinline__ bool key_less(float x, float y) {
  return isnan(y) ? !isnan(x) : x < y;
}
__device__ __forceinline__ bool key_equal(float x, float y) {
  return (isnan(x) && isnan(y)) || x == y;
}

// Sum of v[0 .. n) over the block, returned to every thread.
__device__ __forceinline__ int block_sum(const int32_t* v, int n, int* s_red) {
  int x = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) x += v[i];
  for (int o = 16; o; o >>= 1) x += __shfl_down_sync(kFull, x, o);
  __syncthreads();     // s_red is free
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = x;
  __syncthreads();
  int t = 0;
  for (int w = 0; w < kWarps; ++w) t += s_red[w];
  return t;
}

// First maximum (value, index) over the block; thread 0 gets the result.
__device__ __forceinline__ void block_argmax(float* g, int* i, float* s_g,
                                             int* s_i) {
  for (int o = 16; o; o >>= 1) {
    const float g2 = __shfl_down_sync(kFull, *g, o);
    const int i2 = __shfl_down_sync(kFull, *i, o);
    if (better(g2, i2, *g, *i)) {
      *g = g2;
      *i = i2;
    }
  }
  __syncthreads();     // s_g / s_i are free
  if ((threadIdx.x & 31) == 0) {
    s_g[threadIdx.x >> 5] = *g;
    s_i[threadIdx.x >> 5] = *i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      if (better(s_g[w], s_i[w], *g, *i)) {
        *g = s_g[w];
        *i = s_i[w];
      }
    }
  }
}

// Inclusive prefix sum of x[0 .. n) into y, accumulated in double and
// rounded to float per element (torch's CPU cumsum).
__device__ __forceinline__ void prefix_sum(const float* x, float* y, int n) {
  double acc = 0.0;
  for (int b = 0; b < n; ++b) {
    acc += (double)x[b];
    y[b] = (float)acc;
  }
}

// Phase C shared memory, in floats (ranks and counts reuse float slots).
struct ScanSmem {
  float* h;        // (3, kMaxBins) the feature's histogram, bins >= nb zero
  float* nm;       // (3, kMaxBins) with the movable-missing bin zeroed
  float* cum;      // (3, kMaxBins) prefix of nm
  float* sorted;   // (2, 3, kMaxBins) h in many-vs-many order, then prefix
  float* key;      // (2, kMaxBins) ascending keys, then negated descending
  float* red_g;    // (kWarps,)
  int* red_i;      // (kWarps,)
  int* misc;       // (kWarps,)
};

__device__ __forceinline__ ScanSmem scan_smem(float* smem) {
  ScanSmem s;
  s.h = smem;
  s.nm = s.h + 3 * kMaxBins;
  s.cum = s.nm + 3 * kMaxBins;
  s.sorted = s.cum + 3 * kMaxBins;
  s.key = s.sorted + 6 * kMaxBins;
  s.red_g = s.key + 2 * kMaxBins;
  s.red_i = reinterpret_cast<int*>(s.red_g + kWarps);
  s.misc = s.red_i + kWarps;
  return s;
}

// The monotone depth penalty of find_best_split for node depth d.
__device__ __forceinline__ float depth_penalty(const OneKernelArgs& a) {
  const float p = a.monotone_penalty;
  const float d = (float)a.depth;
  if (p >= d + 1.f) return kEpsilon;
  if (p <= 1.f) return (1.f - p / powf(2.f, d)) + kEpsilon;
  return (1.f - powf(2.f, (p - 1.f) - d)) + kEpsilon;
}

// Phase C item: every candidate of feature f for child c, whose histogram
// row (g, h, cnt) of bin threadIdx.x is hv (zero past B); writes each
// kind's first maximum (gain after the live test and penalties, bin), the
// per-bin default-left flags and the many-vs-many ranks.
__device__ void scan_feature(const OneKernelArgs& a, int c, int f,
                             float* smem, const float hv[3]) {
  const ScanSmem s = scan_smem(smem);
  const int B = a.B, F = a.F;
  const int b = threadIdx.x;
  const int nb = a.num_bins[f];
  const bool movable = a.movable[f] != 0;
  const int mb = a.missing_bin[f];
  const bool is_cat = a.is_cat[f] != 0;
  const int mono = a.monotone[f];
  const float tg = a.sums2[c * 3], th = a.sums2[c * 3 + 1],
              tc = a.sums2[c * 3 + 2];
  const float po = a.outs2[c], lo = a.lows2[c], up = a.ups2[c];
  const float neg = -INFINITY;
  // leaf_objective_value of the parent (this child)
  const float pgain = gain_given(a, tg, th, leaf_output(a, tg, th, 0.f),
                                 a.lambda_l2);

  __syncthreads();     // shared memory is free
  if (b < B) {
    for (int k = 0; k < 3; ++k) {
      const float v = b < nb ? hv[k] : 0.f;
      s.h[k * kMaxBins + b] = v;
      s.nm[k * kMaxBins + b] = (movable && b == mb) ? 0.f : v;
    }
  }
  __syncthreads();
  if (b < 3) prefix_sum(s.nm + b * kMaxBins, s.cum + b * kMaxBins, B);
  float miss[3] = {0.f, 0.f, 0.f};
  if (movable && mb >= 0 && mb < B) {
    for (int k = 0; k < 3; ++k) miss[k] = s.h[k * kMaxBins + mb];
  }
  __syncthreads();

  // ---- numerical thresholds, both missing directions ----
  float num = neg;
  bool dl = false;
  if (b < B) {
    const bool t_valid = b < nb - 1 && !is_cat;
    float gdir[2];
    for (int d = 0; d < 2; ++d) {
      const float gl = d ? s.cum[b] + miss[0] : s.cum[b];
      const float hl = d ? s.cum[kMaxBins + b] + miss[1] : s.cum[kMaxBins + b];
      const float cl = d ? s.cum[2 * kMaxBins + b] + miss[2]
                         : s.cum[2 * kMaxBins + b];
      const float gr = tg - gl, hr = th - hl, cr = tc - cl;
      bool ok;
      const float gain = split_gain(a, gl, hl, cl, gr, hr, cr, false, po, lo,
                                    up, mono, &ok);
      const bool live = ok && data_ok(a, cl, hl, cr, hr);
      const bool valid = t_valid && (d == 0 || movable);
      gdir[d] = (live && valid) ? gain - pgain : neg;
    }
    num = tmax(gdir[0], gdir[1]);
    dl = gdir[1] > gdir[0];
    if (is_cat) num = neg;
    a.num_dl[((size_t)c * F + f) * B + b] = dl ? 1 : 0;
  }

  // ---- categorical: one-vs-rest and many-vs-many prefixes ----
  float oh = neg, mvm[2] = {neg, neg};
  int rank[2] = {b, b};
  if (a.has_categorical) {
    const bool cat_bin_ok = is_cat && b < nb - 1;
    const bool use_onehot = is_cat && (nb - 1 <= a.max_cat_to_onehot);
    const float g_b = b < B ? s.h[b] : 0.f;
    const float h_b = b < B ? s.h[kMaxBins + b] : 0.f;
    const float c_b = b < B ? s.h[2 * kMaxBins + b] : 0.f;
    if (b < B) {
      bool ok;
      const float gr = tg - g_b, hr = th - h_b, cr = tc - c_b;
      const float gain = split_gain(a, g_b, h_b, c_b, gr, hr, cr, true, po,
                                    lo, up, 0, &ok);
      const bool live = data_ok(a, c_b, h_b, cr, hr) && cat_bin_ok &&
                        use_onehot && c_b > 0.f;
      oh = live ? gain - pgain : neg;
    }
    const bool group_ok = b < B && cat_bin_ok &&
                          c_b >= a.min_data_per_group && !use_onehot;
    const float ratio = g_b / (h_b + a.cat_smooth);
    if (b < B) {
      s.key[b] = group_ok ? ratio : INFINITY;
      s.key[kMaxBins + b] = group_ok ? -ratio : INFINITY;
    }
    const int n_groups = __syncthreads_count(group_ok);
    if (b < B) {
      for (int d = 0; d < 2; ++d) {
        const float* key = s.key + d * kMaxBins;
        const float kb = key[b];
        int r = 0;
        for (int j = 0; j < B; ++j) {
          r += key_less(key[j], kb) || (j < b && key_equal(key[j], kb));
        }
        rank[d] = r;
        for (int k = 0; k < 3; ++k) {
          s.sorted[(d * 3 + k) * kMaxBins + r] = s.h[k * kMaxBins + b];
        }
      }
    }
    __syncthreads();
    if (b < 6) {
      float* v = s.sorted + b * kMaxBins;
      prefix_sum(v, v, B);
    }
    __syncthreads();
    if (b < B) {
      const float k1 = (float)(b + 1);
      for (int d = 0; d < 2; ++d) {
        const float gl = s.sorted[(d * 3) * kMaxBins + b];
        const float hl = s.sorted[(d * 3 + 1) * kMaxBins + b];
        const float cl = s.sorted[(d * 3 + 2) * kMaxBins + b];
        const float gr = tg - gl, hr = th - hl, cr = tc - cl;
        bool ok;
        const float gain = split_gain(a, gl, hl, cl, gr, hr, cr, true, po, lo,
                                      up, 0, &ok);
        const bool live = k1 <= a.max_cat_threshold &&
                          k1 < (float)n_groups && data_ok(a, cl, hl, cr, hr);
        mvm[d] = live ? gain - pgain : neg;
      }
    }
  }
  if (b < B) {
    for (int d = 0; d < 2; ++d) {
      a.rank[(((size_t)c * 2 + d) * F + f) * B + b] = (uint8_t)rank[d];
    }
  }

  // ---- live test, feature penalty, monotone depth penalty; per kind max
  const bool fm = a.fmask[f] != 0;
  const float pen_f = a.penalty[f];
  const bool mono_pen = a.use_mono_penalty && mono != 0;
  const float dpen = mono_pen ? depth_penalty(a) : 1.f;
  const float stacked[4] = {num, oh, mvm[0], mvm[1]};
  for (int kind = 0; kind < 4; ++kind) {
    const float v = stacked[kind];
    float adj = v * pen_f;
    if (mono_pen) adj = adj * dpen;
    float g = (b < B && v > neg && fm) ? adj : neg;
    int i = b < B ? b : kMaxBins + b;
    block_argmax(&g, &i, s.red_g, s.red_i);
    if (threadIdx.x == 0) {
      a.cand_gain[((size_t)c * 4 + kind) * F + f] = g;
      a.cand_bin[((size_t)c * 4 + kind) * F + f] = i;
    }
  }
}

// Phase C, second part, run by the block that finished the last scan
// item: child c's winner over (kind, feature, bin), its routing table,
// sums and outputs. Other blocks wrote the scan's outputs and the child
// histograms in this launch; they are read from L2 (__ldcg), never
// through this SM's L1. The winner is a block-wide first maximum in
// better()'s order over the flat index (kind * F + f) * B + bin, with
// kind outermost: the same candidate torch.argmax takes.
__device__ void finish_child(const OneKernelArgs& a, int c, float* smem) {
  const ScanSmem s = scan_smem(smem);
  const int B = a.B, F = a.F;
  const int b = threadIdx.x;
  __syncthreads();     // shared memory is free
  float g = -INFINITY;
  int idx = INT_MAX;
  for (int t = threadIdx.x; t < 4 * F; t += blockDim.x) {
    const size_t j = (size_t)c * 4 * F + t;
    const float g2 = __ldcg(a.cand_gain + j);
    const int i2 = t * B + __ldcg(a.cand_bin + j);
    if (better(g2, i2, g, idx)) {
      g = g2;
      idx = i2;
    }
  }
  block_argmax(&g, &idx, s.red_g, s.red_i);
  if (threadIdx.x == 0) {
    s.red_g[0] = g;
    s.misc[0] = idx / (F * B);
    s.misc[1] = (idx % (F * B)) / B;
    s.misc[2] = idx % B;
  }
  __syncthreads();
  const float best = s.red_g[0];
  const int kind = s.misc[0], feat = s.misc[1], tbin = s.misc[2];
  const int nb = a.num_bins[feat];
  const bool dl = __ldcg(a.num_dl + ((size_t)c * F + feat) * B + tbin) != 0;
  const float* hist = (c == 0 ? a.hist_left : a.hist_right) +
                      (size_t)feat * B * 3;
  if (b < B) {
    bool go;
    if (kind == 0) {
      go = b <= tbin;
      if (a.movable[feat] && b == a.missing_bin[feat]) go = dl;
    } else if (kind == 1) {
      go = b == tbin;
    } else {
      go = __ldcg(a.rank + (((size_t)c * 2 + (kind - 2)) * F + feat) * B +
                  b) <= tbin;
    }
    a.go_left[(size_t)c * B + b] = go ? 1 : 0;
    for (int k = 0; k < 3; ++k) {
      s.h[k * kMaxBins + b] = (go && b < nb) ? __ldcg(hist + b * 3 + k) : 0.f;
    }
  }
  __syncthreads();
  if (b < 3) {          // left sums in bin order
    float acc = 0.f;
    for (int j = 0; j < B; ++j) acc += s.h[b * kMaxBins + j];
    s.nm[b] = acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const float ls[3] = {s.nm[0], s.nm[1], s.nm[2]};
    float rs[3];
    for (int k = 0; k < 3; ++k) rs[k] = a.sums2[c * 3 + k] - ls[k];
    const float extra = kind > 0 ? a.cat_l2 : 0.f;
    const float po = a.outs2[c];
    float wl = smoothed(a, leaf_output(a, ls[0], ls[1], extra), ls[2], po);
    float wr = smoothed(a, leaf_output(a, rs[0], rs[1], extra), rs[2], po);
    if (a.has_monotone) {
      wl = tmin(tmax(wl, a.lows2[c]), a.ups2[c]);
      wr = tmin(tmax(wr, a.lows2[c]), a.ups2[c]);
    }
    a.gain[c] = best > a.min_gain_to_split ? best : -INFINITY;
    a.feature[c] = feat;
    a.bin[c] = tbin;
    a.kind[c] = kind;
    a.default_left[c] = (kind == 0 && dl) ? 1 : 0;
    for (int k = 0; k < 3; ++k) {
      a.left_sum[c * 3 + k] = ls[k];
      a.right_sum[c * 3 + k] = rs[k];
    }
    a.left_output[c] = wl;
    a.right_output[c] = wr;
  }
}

// Phase C item: the reduce of feature f's chunk partials (one thread per
// bin, its NCH channels summed in chunk order, four chunks' loads in
// flight), hi + lo, and child c's histogram row: the smaller child's sums
// or parent - them. Writes the row to hist_left / hist_right and returns
// it in hv (zero past B).
template <int kNch>
__device__ __forceinline__ void child_bins(const OneKernelArgs& a, int c,
                                           int f, int chunks, float hv[3]) {
  const int b = threadIdx.x;
  hv[0] = hv[1] = hv[2] = 0.f;
  if (b >= a.B) return;
  const size_t fb = (size_t)f * a.B + b;
  const size_t stride = (size_t)a.F * a.B * kNch;
  float v[kNch];
#pragma unroll
  for (int k = 0; k < kNch; ++k) v[k] = 0.f;
  const float* p = a.partial + fb * kNch;
  int q = 0;
  for (; q + 4 <= chunks; q += 4, p += 4 * stride) {
    float x[4][kNch];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int k = 0; k < kNch; ++k) x[i][k] = p[i * stride + k];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int k = 0; k < kNch; ++k) v[k] += x[i][k];
    }
  }
  for (; q < chunks; ++q, p += stride) {
#pragma unroll
    for (int k = 0; k < kNch; ++k) v[k] += p[k];
  }
  const float small[3] = {kNch == 5 ? v[0] + v[1] : v[0],
                          kNch == 5 ? v[2] + v[3] : v[1],
                          kNch == 5 ? v[4] : v[2]};
  const bool is_small = (c == 0) == (a.left_smaller != 0);
  float* out = (c == 0 ? a.hist_left : a.hist_right) + fb * 3;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    hv[k] = is_small ? small[k] : a.parent[fb * 3 + k] - small[k];
    out[k] = hv[k];
  }
}

// Phase B item, not inlined: the histogram's loop gets the kernel's whole
// register budget instead of sharing it with values that phases A and C
// keep live (inlined, the planes mode spilled inside it).
template <int kNch, class L>
__device__ __noinline__ void phase_b_item(const L lay, int start, int cnt,
                                          int F, int B, int f0, int chunk,
                                          float* smem, float* partial) {
  lgbt_hist::hist_chunk<kNch, kThreads, kItemFeats>(lay, start, cnt, F, B,
                                                    f0, chunk, smem, partial);
}

template <bool kResident, int kNch>
__global__ void __launch_bounds__(kThreads, 2)
one_kernel_split_kernel(const OneKernelArgs a) {
  using namespace lgbt_part;
  using namespace lgbt_hist;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  __shared__ uint8_t s_tbl[256];
  __shared__ int s_warp[kPartWarps];
  __shared__ int s_red[kWarps];
  __shared__ int s_last;
  const int src = a.seg[0], start = a.seg[1], cnt = a.seg[2];
  // resident: seg[3] is the resident column, the partition routes plane 0
  const int col = kResident ? lgbt_res::kRoute : a.seg[3];
  uint8_t* srcp = a.work + (size_t)src * a.W * a.npad;
  uint8_t* dstp = a.work + (size_t)(1 - src) * a.W * a.npad;
  const int ntiles = (cnt + kPartTile - 1) / kPartTile;
  stamp(a, 0);

  // ---- A. partition ----
  load_table(s_tbl, a.table, a.table_bins);
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    if (kResident) {
      // the tile's 4096 rows are at most 1025 words: 5 per thread
      lgbt_res::route_gather<5>(
          srcp, a.npad, start, cnt, a.res, a.npad_res, a.seg[3],
          (long)t * kPartTile, (long)(t + 1) * kPartTile, threadIdx.x,
          kThreads);
      __syncthreads();   // the tile's route bytes are written
    }
    const int n = part_count_tile<false>(srcp, a.W, a.npad, start, cnt, col,
                                         s_tbl, t, s_warp);
    if (threadIdx.x == 0) a.counts[t] = n;
  }
  stamp(a, 1);
  grid.sync();
  stamp(a, 2);
  const int lt = block_sum(a.counts, ntiles, s_red);
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int before = block_sum(a.counts, t, s_red);
    part_scatter_tile<false>(srcp, dstp, a.W, a.npad, start, cnt, col, lt,
                             s_tbl, t, before, s_warp);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.lt = lt;
  stamp(a, 3);
  grid.sync();
  stamp(a, 4);

  // ---- B. the smaller child's chunk partials, sized by its true count ----
  const int small_start = a.left_smaller ? start : start + lt;
  const int small_cnt = a.left_smaller ? lt : cnt - lt;
  const int chunks = hist_chunks(small_cnt);
  // the groups of a chunk are neighbouring items: blocks in flight share
  // the chunk's rows in L2
  for (int it = blockIdx.x; it < chunks * a.groups; it += gridDim.x) {
    const int chunk = it / a.groups, f0 = (it % a.groups) * kItemFeats;
    if constexpr (kResident) {
      const ResidentRows lay{dstp, a.npad, a.res, a.npad_res};
      phase_b_item<kNch>(lay, small_start, small_cnt, a.F, a.B, f0, chunk,
                         smem, a.partial);
    } else {
      const PackedRows<false> lay{dstp, a.W, a.npad, a.F};
      phase_b_item<kNch>(lay, small_start, small_cnt, a.F, a.B, f0, chunk,
                         smem, a.partial);
    }
  }
  stamp(a, 5);
  grid.sync();
  stamp(a, 6);

  // ---- C. per (child, feature): reduce, subtract, scan; then the block
  // that finishes the last item takes both children's winners ----
  bool last = false;
  for (int it = blockIdx.x; it < 2 * a.F; it += gridDim.x) {
    const int c = it / a.F, f = it % a.F;
    float hv[3];
    child_bins<kNch>(a, c, f, chunks, hv);
    scan_feature(a, c, f, smem, hv);
    __threadfence();     // this item's outputs are visible grid-wide
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(a.done, 1) == 2 * a.F - 1;
    __syncthreads();
    last = last || s_last;
  }
  stamp(a, 7);
  if (last) {
    __threadfence();
    finish_child(a, 0, smem);
    finish_child(a, 1, smem);
    if (threadIdx.x == 0) *a.done = 0;   // ready for the next launch
    stamp(a, 8);
  }
}

size_t smem_bytes(const OneKernelArgs& a) {
  const size_t hist = lgbt_hist::hist_smem_bytes(a.B, a.nch, kItemFeats);
  const size_t scan = (17 * kMaxBins + 3 * kWarps) * sizeof(float);
  return hist > scan ? hist : scan;
}

// The cooperative grid of one kernel for `smem` bytes of dynamic shared
// memory on the current device: the blocks that fit at once (occupancy x
// SMs). The queries run once per (kernel, device, smem) and thread; a
// tree's splits all share one smem size.
template <bool kResident, int kNch>
cudaError_t cooperative_grid(size_t smem, int* grid) {
  thread_local int cached_dev = -1, cached_grid = 0;
  thread_local size_t cached_smem = 0;
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev == cached_dev && smem == cached_smem) {
    *grid = cached_grid;
    return cudaSuccess;
  }
  e = cudaFuncSetAttribute(one_kernel_split_kernel<kResident, kNch>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, one_kernel_split_kernel<kResident, kNch>, kThreads, smem);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  cached_dev = dev;
  cached_smem = smem;
  cached_grid = per_sm * sms;
  *grid = cached_grid;
  return cudaSuccess;
}

template <bool kResident, int kNch>
int launch_nch(const OneKernelArgs& a, void* stream) {
  const size_t smem = smem_bytes(a);
  int grid = 0;
  cudaError_t e = cooperative_grid<kResident, kNch>(smem, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* kargs[] = {const_cast<OneKernelArgs*>(&a)};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(one_kernel_split_kernel<kResident, kNch>),
      dim3(grid), dim3(kThreads), kargs, smem,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <bool kResident>
int launch_split(const OneKernelArgs* args, void* stream) {
  const OneKernelArgs a = *args;
  if (a.B < 1 || a.B > kMaxBins || (a.nch != 3 && a.nch != 5) ||
      a.groups != (a.F + kItemFeats - 1) / kItemFeats ||
      (kResident && (a.res == nullptr || a.npad_res < 1 ||
                     a.W != lgbt_res::kWidth || a.npad % 4 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return a.nch == 5 ? launch_nch<kResident, 5>(a, stream)
                    : launch_nch<kResident, 3>(a, stream);
}

// Writes the cluster size each block of a cooperative launch sees, after
// a grid barrier (one_kernel_cluster_probe).
__global__ void cluster_probe_kernel(int* out) {
  cg::this_grid().sync();
  if (threadIdx.x == 0) out[blockIdx.x] = cg::this_cluster().num_blocks();
}

}  // namespace

extern "C" {

// Whether the card takes a thread block cluster dimension together with
// the cooperative launch attribute: launches a 2-block probe with both
// (clusters of 2) and waits for it. Returns the launch's cudaError_t code;
// on success out[0..1] hold the cluster size each block saw.
int one_kernel_cluster_probe(void* out, void* stream) {
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = 2;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2);
  cfg.blockDim = dim3(32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  cudaError_t e = cudaLaunchKernelEx(&cfg, cluster_probe_kernel,
                                     static_cast<int*>(out));
  if (e != cudaSuccess) {
    cudaGetLastError();    // a refused launch must not fail the next one
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaStreamSynchronize(cfg.stream));
}


const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One split, one cooperative launch on `stream` (planes mode). Returns a
// cudaError_t code (0 on success).
int one_kernel_split(const OneKernelArgs* args, void* stream) {
  return launch_split<false>(args, stream);
}

// The same in resident mode: args->work is the slim pair, args->res the
// resident bin planes.
int one_kernel_split_resident(const OneKernelArgs* args, void* stream) {
  return launch_split<true>(args, stream);
}

}  // extern "C"
