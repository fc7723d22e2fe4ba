// The split scan of ops/split.find_best_split over both children of a
// split, one feature of one child per work item: the device code of phase
// C of the one-kernel split (csrc/one_kernel_split.cu) and of the split
// scan kernel (csrc/split_scan.cu), which include it.
//
// The functions are templates on the kernel's argument struct A, which
// holds the scan's fields under these names: the FeatureMeta columns
// (num_bins, movable, missing_bin, is_cat, monotone, penalty), the search
// masks fmask (child c's row at c * mask_stride: 0 for one mask the
// children share, F for a mask a child), rand_thr (null, or (2, F):
// extra-trees, the one numerical threshold bin each feature may take) and
// cegb (null, or (2, F): the CEGB penalty subtracted from each feature's
// gains after the feature and depth penalties, the order of
// ops/split.find_best_split), the
// children's sums2 / outs2 / lows2 / ups2, the scratch cand_gain /
// cand_bin / num_dl / rank, the child histograms hist_left / hist_right,
// the SplitOut fields (gain, feature, bin, kind, default_left, go_left,
// left_sum, right_sum, left_output, right_output), F, B and the scalar
// hyperparameters of ops/partition._hyper_fields.
//
// kTorchOrder picks the summation order the scan follows. false: torch's
// on the CPU (prefix sums accumulated in double, the winner's left sums in
// bin order), the one-kernel split's order since it was ported. true:
// torch's on the card, so that the scan is bit-equal to find_best_split
// run there on the same histograms: prefix sums in float, one bin after
// another (torch's cumsum over a dim that is not the innermost), the
// winner's left sums in the order of torch.sum over the bins of a (2, B,
// 3) tensor (torch_row_sum), the missing bin's sums from +0. A struct with
// an `adv` field (the split scan's) may carry the advanced monotone
// method's per-candidate child bounds (adv_of). Everything
// else is elementwise and follows torch op by op; the files that include
// this one are built with -fmad=false.
#pragma once

#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace lgbt_scan {

constexpr int kScanThreads = 256;    // one thread a bin (up to 256 bins)
constexpr int kWarps = kScanThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBins = 256;
constexpr float kEpsilon = 1e-15f;   // ops/split.py K_EPSILON
// Phase C shared memory of one block at one bin a thread, in floats
// (ScanSmem).
constexpr int kScanSmemFloats = 17 * kMaxBins + 3 * kWarps;

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
template <class A>
__device__ __forceinline__ float leaf_output(const A& a, float g,
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
template <class A>
__device__ __forceinline__ float smoothed(const A& a, float w,
                                          float cnt, float po) {
  if (!(a.path_smooth > 0.f)) return w;
  const float n = tmax(cnt, 1.f);
  const float alpha = n / (n + a.path_smooth);
  return w * alpha + po * (1.f - alpha);
}

// GetLeafGainGivenOutput with l2 = lambda_l2 (+ cat_l2)
template <class A>
__device__ __forceinline__ float gain_given(const A& a, float g,
                                            float h, float w, float l2) {
  const float x = (2.f * g) * w;
  const float y = ((h + l2) * w) * w;
  return -(x + y) - a.two_l1 * fabsf(w);
}

// The per-candidate child bounds of the advanced monotone method: the
// (nodes, 4, F, B) [lo_l, up_l, lo_r, up_r] field `adv` of an argument
// struct that has one (csrc/split_scan.cu), null for a struct without it
// (the one-kernel split, which the advanced method never runs).
template <class A>
__device__ __forceinline__ auto adv_of(const A& a, int) -> decltype(a.adv) {
  return a.adv;
}
template <class A>
__device__ __forceinline__ const float* adv_of(const A&, long) {
  return nullptr;
}

// _split_gain_pair -> gain; *ok false on a monotone violation. Numerical
// candidates (cat = false) carry the monotone test and bounds when the
// model has monotone constraints: the node's [lo, up], or, with `cb` (the
// candidate's lo_l, up_l, lo_r, up_r; the advanced method), each child's
// own bounds and the sibling order re-checked after the clamp;
// categorical ones use cat_l2.
template <class A>
__device__ __forceinline__ float split_gain(const A& a, float gl,
                                            float hl, float cl, float gr,
                                            float hr, float cr, bool cat,
                                            float po, float lo, float up,
                                            int mono, bool* ok,
                                            const float* cb = nullptr) {
  const float extra = cat ? a.cat_l2 : 0.f;
  const float l2 = cat ? a.l2_cat : a.lambda_l2;
  float wl = smoothed(a, leaf_output(a, gl, hl, extra), cl, po);
  float wr = smoothed(a, leaf_output(a, gr, hr, extra), cr, po);
  *ok = true;
  if (!cat && a.has_monotone) {
    *ok = !((mono > 0 && wl > wr) || (mono < 0 && wl < wr));
    if (cb != nullptr) {
      wl = tmin(tmax(wl, cb[0]), cb[1]);
      wr = tmin(tmax(wr, cb[2]), cb[3]);
      *ok = *ok && !((mono > 0 && wl > wr) || (mono < 0 && wl < wr));
    } else {
      wl = tmin(tmax(wl, lo), up);
      wr = tmin(tmax(wr, lo), up);
    }
  }
  return gain_given(a, gl, hl, wl, l2) + gain_given(a, gr, hr, wr, l2);
}

template <class A>
__device__ __forceinline__ bool data_ok(const A& a, float cl,
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

// Inclusive prefix sum of x[0 .. n) into y. kTorchOrder: accumulated in
// float, one element after another (torch's cumsum on the card over a dim
// that is not the innermost one); else in double and rounded to float per
// element (torch's CPU cumsum).
template <bool kTorchOrder>
__device__ __forceinline__ void prefix_sum(const float* x, float* y, int n) {
  if (kTorchOrder) {
    float acc = 0.f;
    for (int b = 0; b < n; ++b) {
      acc = acc + x[b];
      y[b] = acc;
    }
    return;
  }
  double acc = 0.0;
  for (int b = 0; b < n; ++b) {
    acc += (double)x[b];
    y[b] = (float)acc;
  }
}

// Sum of x[0 .. n) (n <= kMaxBins) in the order of torch.sum over the
// middle dim of a contiguous (2, n, 3) float tensor on the card (its
// reduce kernel's configuration for that shape): for n < 256 one thread
// holds four accumulators, element i going to accumulator i % 4, added
// ((a0 + a1) + a2) + a3; for n = 256, 128 threads each sum elements t and
// t + 128 that way, then a tree over the threads (offsets 64, 32, .., 1).
// Every accumulator starts at +0.
__device__ __forceinline__ float torch_row_sum(const float* x, int n) {
  if (n < 256) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < n; ++i) acc[i & 3] = acc[i & 3] + x[i];
    return ((acc[0] + acc[1]) + acc[2]) + acc[3];
  }
  float v[128];
  for (int t = 0; t < 128; ++t) {
    const float a0 = 0.f + x[t], a1 = 0.f + x[t + 128];
    v[t] = ((a0 + a1) + 0.f) + 0.f;
  }
  for (int off = 64; off > 0; off >>= 1) {
    for (int t = 0; t < off; ++t) v[t] = v[t] + v[t + off];
  }
  return v[0];
}

// Phase C shared memory, in floats (ranks and counts reuse float slots),
// for kBpt bins a thread: every per-bin row holds kBpt * kScanThreads
// floats (kMaxBins at kBpt = 1).
struct ScanSmem {
  float* h;        // (3, S) the feature's histogram, bins >= nb zero
  float* nm;       // (3, S) with the movable-missing bin zeroed
  float* cum;      // (3, S) prefix of nm
  float* sorted;   // (2, 3, S) h in many-vs-many order, then prefix
  float* key;      // (2, S) ascending keys, then negated descending
  float* red_g;    // (kWarps,)
  int* red_i;      // (kWarps,)
  int* misc;       // (kWarps,)
};

// Shared memory of phase C at kBpt bins a thread, in floats.
__host__ __device__ constexpr int scan_smem_floats(int bpt) {
  return 17 * kScanThreads * bpt + 3 * kWarps;
}

template <int kBpt = 1>
__device__ __forceinline__ ScanSmem scan_smem(float* smem) {
  constexpr int S = kBpt * kScanThreads;
  ScanSmem s;
  s.h = smem;
  s.nm = s.h + 3 * S;
  s.cum = s.nm + 3 * S;
  s.sorted = s.cum + 3 * S;
  s.key = s.sorted + 6 * S;
  s.red_g = s.key + 2 * S;
  s.red_i = reinterpret_cast<int*>(s.red_g + kWarps);
  s.misc = s.red_i + kWarps;
  return s;
}

// The monotone depth penalty of find_best_split for node depth d.
template <class A>
__device__ __forceinline__ float depth_penalty(const A& a,
                                               int depth) {
  const float p = a.monotone_penalty;
  const float d = (float)depth;
  if (p >= d + 1.f) return kEpsilon;
  if (p <= 1.f) return (1.f - p / powf(2.f, d)) + kEpsilon;
  return (1.f - powf(2.f, (p - 1.f) - d)) + kEpsilon;
}

// A rank (the many-vs-many position of a bin) in the struct's rank type:
// u8 in the one-kernel split (B <= 256), u16 in the split scan.
template <class A>
__device__ __forceinline__ void put_rank(const A& a, size_t at, int r) {
  using R = typename std::remove_const<
      typename std::remove_pointer<decltype(a.rank)>::type>::type;
  a.rank[at] = static_cast<R>(r);
}

// Phase C item: every candidate of feature f for child c. Thread t owns
// bins t + j * kScanThreads (j < kBpt), whose histogram rows (g, h, cnt)
// are hv[j * 3 .. j * 3 + 3) (zero past B); writes each kind's first
// maximum (gain after the live test and penalties, bin), the per-bin
// default-left flags and the many-vs-many ranks. At kBpt = 1 (B <= 256)
// it is the one-thread-a-bin scan the one-kernel split runs; past 256
// bins each thread keeps its bins' candidates and first takes its own
// maximum (in bin order, better()'s order), so the block's winner is the
// same first maximum. The prefix sums stay one thread a channel, one bin
// after another: torch's cumsum on the card adds in that order.
template <bool kTorchOrder, int kBpt, class A>
__device__ void scan_feature_n(const A& a, int c, int f, int depth,
                               float* smem, const float* hv) {
  constexpr int S = kBpt * kScanThreads;
  const ScanSmem s = scan_smem<kBpt>(smem);
  const int B = a.B, F = a.F;
  const int t = threadIdx.x;
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
#pragma unroll
  for (int j = 0; j < kBpt; ++j) {
    const int b = t + j * kScanThreads;
    if (b < B) {
      for (int k = 0; k < 3; ++k) {
        const float v = b < nb ? hv[j * 3 + k] : 0.f;
        s.h[k * S + b] = v;
        s.nm[k * S + b] = (movable && b == mb) ? 0.f : v;
      }
    }
  }
  __syncthreads();
  if (t < 3) {
    prefix_sum<kTorchOrder>(s.nm + t * S, s.cum + t * S, B);
  }
  float miss[3] = {0.f, 0.f, 0.f};
  if (movable && mb >= 0 && mb < B) {
    // torch sums the masked bins from +0: a -0 missing bin gives +0
    for (int k = 0; k < 3; ++k) {
      miss[k] = kTorchOrder ? 0.f + s.h[k * S + mb] : s.h[k * S + mb];
    }
  }
  __syncthreads();

  // ---- numerical thresholds, both missing directions ----
  float num[kBpt];
  const float* adv = adv_of(a, 0);
#pragma unroll
  for (int j = 0; j < kBpt; ++j) {
    const int b = t + j * kScanThreads;
    num[j] = neg;
    if (b >= B) continue;
    float cb[4];
    if (adv != nullptr) {
      const size_t plane = (size_t)F * B;
      const float* p = adv + (size_t)c * 4 * plane + (size_t)f * B + b;
      for (int k = 0; k < 4; ++k) cb[k] = p[k * plane];
    }
    const bool t_valid = b < nb - 1 && !is_cat &&
                         (a.rand_thr == nullptr ||
                          b == a.rand_thr[(size_t)c * F + f]);
    float gdir[2];
    for (int d = 0; d < 2; ++d) {
      const float gl = d ? s.cum[b] + miss[0] : s.cum[b];
      const float hl = d ? s.cum[S + b] + miss[1] : s.cum[S + b];
      const float cl = d ? s.cum[2 * S + b] + miss[2] : s.cum[2 * S + b];
      const float gr = tg - gl, hr = th - hl, cr = tc - cl;
      bool ok;
      const float gain = split_gain(a, gl, hl, cl, gr, hr, cr, false, po, lo,
                                    up, mono, &ok,
                                    adv != nullptr ? cb : nullptr);
      const bool live = ok && data_ok(a, cl, hl, cr, hr);
      const bool valid = t_valid && (d == 0 || movable);
      gdir[d] = (live && valid) ? gain - pgain : neg;
    }
    num[j] = tmax(gdir[0], gdir[1]);
    const bool dl = gdir[1] > gdir[0];
    if (is_cat) num[j] = neg;
    a.num_dl[((size_t)c * F + f) * B + b] = dl ? 1 : 0;
  }

  // ---- categorical: one-vs-rest and many-vs-many prefixes ----
  float oh[kBpt], mvm[kBpt][2];
  int rank[kBpt][2];
#pragma unroll
  for (int j = 0; j < kBpt; ++j) {
    const int b = t + j * kScanThreads;
    oh[j] = mvm[j][0] = mvm[j][1] = neg;
    rank[j][0] = rank[j][1] = b;
  }
  if (a.has_categorical) {
    const bool use_onehot = is_cat && (nb - 1 <= a.max_cat_to_onehot);
    int n_groups = 0;
#pragma unroll
    for (int j = 0; j < kBpt; ++j) {
      const int b = t + j * kScanThreads;
      const bool cat_bin_ok = is_cat && b < nb - 1;
      const float g_b = b < B ? s.h[b] : 0.f;
      const float h_b = b < B ? s.h[S + b] : 0.f;
      const float c_b = b < B ? s.h[2 * S + b] : 0.f;
      if (b < B) {
        bool ok;
        const float gr = tg - g_b, hr = th - h_b, cr = tc - c_b;
        const float gain = split_gain(a, g_b, h_b, c_b, gr, hr, cr, true, po,
                                      lo, up, 0, &ok);
        const bool live = data_ok(a, c_b, h_b, cr, hr) && cat_bin_ok &&
                          use_onehot && c_b > 0.f;
        oh[j] = live ? gain - pgain : neg;
      }
      const bool group_ok = b < B && cat_bin_ok &&
                            c_b >= a.min_data_per_group && !use_onehot;
      const float ratio = g_b / (h_b + a.cat_smooth);
      if (b < B) {
        s.key[b] = group_ok ? ratio : INFINITY;
        s.key[S + b] = group_ok ? -ratio : INFINITY;
      }
      n_groups += __syncthreads_count(group_ok);
    }
#pragma unroll
    for (int j = 0; j < kBpt; ++j) {
      const int b = t + j * kScanThreads;
      if (b >= B) continue;
      for (int d = 0; d < 2; ++d) {
        const float* key = s.key + d * S;
        const float kb = key[b];
        int r = 0;
        for (int i = 0; i < B; ++i) {
          r += key_less(key[i], kb) || (i < b && key_equal(key[i], kb));
        }
        rank[j][d] = r;
        for (int k = 0; k < 3; ++k) {
          s.sorted[(d * 3 + k) * S + r] = s.h[k * S + b];
        }
      }
    }
    __syncthreads();
    if (t < 6) {
      float* v = s.sorted + t * S;
      prefix_sum<kTorchOrder>(v, v, B);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kBpt; ++j) {
      const int b = t + j * kScanThreads;
      if (b >= B) continue;
      const float k1 = (float)(b + 1);
      for (int d = 0; d < 2; ++d) {
        const float gl = s.sorted[(d * 3) * S + b];
        const float hl = s.sorted[(d * 3 + 1) * S + b];
        const float cl = s.sorted[(d * 3 + 2) * S + b];
        const float gr = tg - gl, hr = th - hl, cr = tc - cl;
        bool ok;
        const float gain = split_gain(a, gl, hl, cl, gr, hr, cr, true, po, lo,
                                      up, 0, &ok);
        const bool live = k1 <= a.max_cat_threshold &&
                          k1 < (float)n_groups && data_ok(a, cl, hl, cr, hr);
        mvm[j][d] = live ? gain - pgain : neg;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kBpt; ++j) {
    const int b = t + j * kScanThreads;
    if (b >= B) continue;
    for (int d = 0; d < 2; ++d) {
      put_rank(a, (((size_t)c * 2 + d) * F + f) * B + b, rank[j][d]);
    }
  }

  // ---- live test, feature penalty, monotone depth penalty; per kind max
  const bool fm = a.fmask[(size_t)c * a.mask_stride + f] != 0;
  const float pen_f = a.penalty[f];
  const bool mono_pen = a.use_mono_penalty && mono != 0;
  const float dpen = mono_pen ? depth_penalty(a, depth) : 1.f;
  const float cegb = a.cegb != nullptr ? a.cegb[(size_t)c * F + f] : 0.f;
  for (int kind = 0; kind < 4; ++kind) {
    float g = neg;
    int i = S + t;
#pragma unroll
    for (int j = 0; j < kBpt; ++j) {
      const int b = t + j * kScanThreads;
      const float v = kind == 0 ? num[j] : kind == 1 ? oh[j]
                                         : mvm[j][kind - 2];
      float adj = v * pen_f;
      if (mono_pen) adj = adj * dpen;
      if (a.cegb != nullptr) adj = adj - cegb;
      const float gj = (b < B && v > neg && fm) ? adj : neg;
      const int ij = b < B ? b : S + b;
      if (j == 0 || better(gj, ij, g, i)) {
        g = gj;
        i = ij;
      }
    }
    block_argmax(&g, &i, s.red_g, s.red_i);
    if (threadIdx.x == 0) {
      a.cand_gain[((size_t)c * 4 + kind) * F + f] = g;
      a.cand_bin[((size_t)c * 4 + kind) * F + f] = i;
    }
  }
}

// The one-thread-a-bin scan (B <= kMaxBins), bin threadIdx.x's histogram
// row hv.
template <bool kTorchOrder, class A>
__device__ void scan_feature(const A& a, int c, int f, int depth,
                             float* smem, const float hv[3]) {
  scan_feature_n<kTorchOrder, 1>(a, c, f, depth, smem, hv);
}

// Phase C, second part, run by the block that finished the last scan
// item: child c's winner over (kind, feature, bin), its routing table,
// sums and outputs. Other blocks wrote the scan's outputs and the child
// histograms in this launch; they are read from L2 (__ldcg), never
// through this SM's L1. The winner is a block-wide first maximum in
// better()'s order over the flat index (kind * F + f) * B + bin, with
// kind outermost: the same candidate torch.argmax takes. The winner's
// left sums follow ops/split.find_best_split: up to 256 bins torch.sum's
// order on the card (torch_row_sum; in bin order off kTorchOrder), past
// 256 bins the last of a prefix sum, one bin after another (the twin's
// cumsum there).
template <bool kTorchOrder, int kBpt = 1, class A>
__device__ void finish_child(const A& a, int c, float* smem) {
  constexpr int S = kBpt * kScanThreads;
  const ScanSmem s = scan_smem<kBpt>(smem);
  const int B = a.B, F = a.F;
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
  for (int b = threadIdx.x; b < B; b += kScanThreads) {
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
      s.h[k * S + b] = (go && b < nb) ? __ldcg(hist + b * 3 + k) : 0.f;
    }
  }
  __syncthreads();
  if (threadIdx.x < 3) {   // left sums
    const float* x = s.h + threadIdx.x * S;
    if (kBpt > 1) {        // the last prefix sum, as prefix_sum adds
      if (kTorchOrder) {
        float acc = 0.f;
        for (int j = 0; j < B; ++j) acc = acc + x[j];
        s.nm[threadIdx.x] = acc;
      } else {
        double acc = 0.0;
        for (int j = 0; j < B; ++j) acc += (double)x[j];
        s.nm[threadIdx.x] = (float)acc;
      }
    } else if (kTorchOrder) {
      s.nm[threadIdx.x] = torch_row_sum(x, B);
    } else {
      float acc = 0.f;
      for (int j = 0; j < B; ++j) acc += x[j];
      s.nm[threadIdx.x] = acc;
    }
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
    const float* adv = adv_of(a, 0);
    if (a.has_monotone && adv != nullptr) {
      // the winner's own bounds, whatever its kind (find_best_split)
      const size_t plane = (size_t)F * B;
      const float* p = adv + (size_t)c * 4 * plane + (size_t)feat * B + tbin;
      wl = tmin(tmax(wl, p[0]), p[plane]);
      wr = tmin(tmax(wr, p[2 * plane]), p[3 * plane]);
    } else if (a.has_monotone) {
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

}  // namespace lgbt_scan
