// The split scan of both children of a split in one launch, for Hopper
// (sm_90a): the third launch of the three-launch chain (partition, the
// smaller child's histogram, the scan) in the device tree loop, with the
// sibling's subtraction folded in, and the forced-split scan of one leaf
// before a forced split's commit.
//
// Replaces lightgbm_tpu/ops/split.py find_best_split, which the JAX
// builder runs as XLA inside its lax.while_loop (no Pallas kernel), and in
// this package ops/split.find_best_split on a (2, F, B, 3) batch. Same
// contract: the two children's histograms, the split's pair row [sums (2,
// 3), outputs (2,), lower (2,), upper (2,)] (ops/partition.PAIR_WORDS),
// the FeatureMeta columns, the search masks and the node depth -> each
// child's best split (gain, feature, bin, kind, default_left, go_left (B,),
// left_sum, right_sum, left_output, right_output) in the SplitOut buffers
// of ops/partition.py, which the split commit (csrc/split_commit.cu)
// reads. The depth and a live word come from device words (the split's
// header, ops/partition.ONE_KERNEL_HDR words 5 and 6, or a forced leaf's
// depth and the tree's forcing word); with live 0 every CTA returns at
// once and nothing is written. Each child may have its own search mask,
// extra-trees threshold bins and CEGB penalties (ops/node.py), (2, F)
// each; `nodes` = 1 scans the first child only (a forced split's leaf).
//
// Two input modes. Direct: the (nodes, F, B, 3) children (left, right).
// Fold (the chain without EFB bundles, and the dense builder's split): the
// smaller child's (F, B, 3) histogram and the (P, F, B, 3) pool whose row
// hdr[7] is the parent's; the kernel forms the sibling as parent - small
// (the one f32 subtraction of torch's `pool[parent] - small`), orders the
// two by hdr[4] (left_smaller) and writes them into the pool: the left
// child over the parent's row, the right child into row `new_slot`, the
// rows the split commit copied them to before (it now skips the copy).
//
// Results are bit-equal to find_best_split run by torch on the card on the
// same histograms: prefix sums in float, one bin after another (torch's
// cumsum over a dim that is not the innermost); the winner's left sums in
// the order of torch.sum over the bins of a (2, B, 3) tensor (four strided
// accumulators below 256 bins, 128 pairs and a tree at 256, the last of a
// prefix sum past 256: split_scan.cuh torch_row_sum); the many-vs-many
// orders of torch.argsort(stable=True) (NaN last); the first maximum over
// (kind, feature, bin) of torch.argmax. Built with -fmad=false: no
// multiply-add is contracted, as torch's elementwise ops round each
// operation. The scalar arithmetic is split_scan.cuh's (leaf_output,
// split_gain, ...), which the one-kernel split's phase C also runs.
//
// Design. One thread block cluster of up to 16 CTAs (Hopper's
// non-portable size; a card that does not schedule it refuses the launch,
// which raises) of 512 threads. A CTA holds up to two teams of 256 threads, one team a
// feature covering both children, a thread a bin: the team that reads a
// parent's row is the one that overwrites it, behind its own named
// barrier. Features loop where they outnumber the cluster's teams (F =
// 137: 16 x 2 teams, five rounds; past 256 bins fewer teams fit a CTA's
// shared memory). A team issues its scalars' loads with its rows', stages
// the rows into shared memory with 16-byte loads (a scalar head and tail
// where a row is not 16-byte aligned: rows are B x 12 bytes), folds and
// pools them, lays each channel out channel-major with find_best_split's
// zeroed bins and runs the six channel chains (2 children x 3 channels) in
// six threads with the running sum in a register and 16-byte shared
// loads, computes each bin's candidates for both children straight-line,
// and each (child, kind)'s first maximum with two warp reductions
// (redux.sync over the gain's order, then the index), which it writes
// into the leader CTA's tables through distributed shared memory. One
// cluster barrier replaces PR 11's global ticket; the leader's two teams
// then finish the two children in parallel from local tables: the first
// maximum, the routing table and the winner's left sums from its row
// (12 threads as torch's four accumulators), the outputs. The
// categorical many-vs-many order is a bitonic sort of (key, bin) over the
// feature's num_bins by the team (PR 11 counted B compares a bin), and
// runs only where a group exists.
//
// Shape choice, from the stamps (PERF.md section 6, PR 20; device ms at
// F = 28, B = 255 on an H100). PR 11's kernel: 0.0146, its finish 6.1 us
// of 12.5 stamped, gains 3.7, chains 1.1, staging 0.8. A warp a feature
// in clusters of 7: 0.0229 (gains 8.2 us: one warp a scheduler waits out
// every dependent instruction; chains 4.1). Teams of 128 threads: 0.0171
// (each thread four candidates in turn). Teams of 256, a bin a thread, in
// clusters of up to 16: 0.0140 (F = 28 on 14 SMs in one round), then the
// maxima by redux.sync in place of five shuffle rounds each: 0.0121.
// Summing the winners' left bins in every team ahead of the barrier (in
// place of the leader's finish) measured 0.0129, so the leader sums.
//
// What bounds it on this card: latency. It reads two (F, B, 3) histograms
// (0.17 MB at F = 28, B = 255: ~0.05 us at 3.35 TB/s), writes two in fold
// mode, and does ~10 operations a candidate. Its time is the chains (B
// dependent adds), the gains (~16 candidates a lane), one cluster barrier
// and the finish's dependent reads.
//
// A measurement path: given a stamps buffer, thread 0 of each CTA writes
// %globaltimer at the kernel's entry, after its first item's staged rows,
// pool writes, chains and candidates, after its items, after the cluster
// barrier, and (the leader) after the pick and at its end
// (ops/scan.SCAN_PHASES); with a null pointer it writes nothing.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "split_scan.cuh"
#include "smem.cuh"

namespace cg = cooperative_groups;

// Field order and types must match ops/scan.py SplitScanArgs.
struct SplitScanArgs {
  const float* hists;          // direct: (nodes, F, B, 3) the children;
                               // fold: (F, B, 3) the smaller child
  float* pool;                 // fold: (P, F, B, 3) histogram pool; or null
  const int32_t* hdr;          // fold: the split's header (hdr[4], hdr[7])
  const int32_t* live;         // the live word (the header's hdr[6])
  const int32_t* depth;        // the children's depth (the header's hdr[5])
  const int32_t* num_bins;     // FeatureMeta columns, (F,) each
  const uint8_t* movable;
  const int32_t* missing_bin;
  const uint8_t* is_cat;
  const int8_t* monotone;
  const float* penalty;
  const uint8_t* fmask;        // child c's (F,) bool mask at c * mask_stride
  const int32_t* rand_thr;     // null, or (2, F) extra-trees threshold bins
  const float* cegb;           // null, or (2, F) CEGB gain penalties
  const float* sums2;          // (2, 3)
  const float* outs2;          // (2,)
  const float* lows2;
  const float* ups2;
  const float* adv;            // null, or (nodes, 4, F, B) per-candidate
                               // [lo_l, up_l, lo_r, up_r] (advanced
                               // monotone: csrc/monotone.cu mono_bounds)
  uint16_t* rank;              // scratch (2, 2, F, B) many-vs-many ranks
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
  uint64_t* stamps;            // null, or (C, kStamps) %globaltimer ns
  int32_t F, B, max_cat_to_onehot, has_categorical, has_monotone,
      use_mono_penalty, mask_stride, nodes, new_slot,
      ws, rounds;              // the launch shape, set by split_scan
  float lambda_l1, lambda_l2, two_l1, l2_cat, min_data_in_leaf,
      min_sum_hessian, min_gain_to_split, max_delta_step, cat_smooth, cat_l2,
      min_data_per_group, path_smooth, monotone_penalty, max_cat_threshold;
};

namespace {

using namespace lgbt_scan;   // the scalar arithmetic (split_scan.cuh)

constexpr int kThreads = 512;        // 16 warps: up to two teams
constexpr int kTeam = 256;           // a team: one feature, a bin a thread
constexpr int kTeamWarps = kTeam / 32;
constexpr int kMaxTeams = kThreads / kTeam;
constexpr int kMaxCluster = 16;      // Hopper's non-portable size
constexpr int kMaxB = 3072;
constexpr int kStamps = 9;           // stamp slots per CTA
constexpr int kRegion = 16;          // floats a bin of a team's shared
                                     // memory: H0 3, H1 3, work 10
constexpr int kCands = 8;            // (child, kind) candidates an item

__device__ __forceinline__ void stamp(const SplitScanArgs& a, int i) {
  if (a.stamps != nullptr && threadIdx.x == 0) {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.stamps[(size_t)blockIdx.x * kStamps + i] = t;
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Named barrier of team t (kTeam threads).
__device__ __forceinline__ void team_sync(int t) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + t), "r"(kTeam) : "memory");
}

__host__ __device__ constexpr int padded(int B) { return (B + 31) & ~31; }

// A gain's place in better()'s order as an unsigned word: NaN above
// everything, then the value (-0 and +0 tie, as `>` has them).
__device__ __forceinline__ uint32_t order_bits(float g) {
  if (isnan(g)) return 0xffffffffu;
  const uint32_t u = __float_as_uint(g == 0.f ? 0.f : g);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The first maximum in better()'s order over the warp (with a default-left
// flag carried along): every lane gets it. Two reductions (the gain's
// order, then the smaller index among the lanes that hold it) and the
// winning lane's own words, so no chain of compares.
__device__ __forceinline__ void warp_best(float* g, int* i, int* dl) {
  const uint32_t hi = order_bits(*g);
  const uint32_t lo = 0x7fffffffu - (uint32_t)*i;    // smaller i: larger
  const uint32_t hmax = __reduce_max_sync(kFull, hi);
  const uint32_t lmax = __reduce_max_sync(kFull, hi == hmax ? lo : 0u);
  const int src = __ffs(__ballot_sync(kFull, hi == hmax && lo == lmax)) - 1;
  *g = __shfl_sync(kFull, *g, src);
  *i = __shfl_sync(kFull, *i, src);
  *dl = __shfl_sync(kFull, *dl, src);
}

// Floats from row r up to its first 16-byte boundary (at most n).
__device__ __forceinline__ int head_of(const float* r, int n) {
  return min(n, (int)(((16 - ((uintptr_t)r & 15)) & 15) >> 2));
}

// Stage n floats of a global row into shared memory by the team, 16-byte
// loads over its aligned interior (a scalar head and tail), chunk by chunk,
// a chunk's loads ahead of its stores; `then` runs between the first
// chunk's loads and stores.
template <class Then>
__device__ __forceinline__ void team_stage(float* __restrict__ d,
                                           const float* __restrict__ s,
                                           int n, int gt, Then then) {
  constexpr int U = 2;
  const int h = head_of(s, n);
  const int m = (n - h) >> 2;
  const float4* v = reinterpret_cast<const float4*>(s + h);
  float tail[2] = {0.f, 0.f};
  if (gt < h) tail[0] = s[gt];
  const int rest = h + 4 * m + gt;
  if (rest < n) tail[1] = s[rest];
  for (int j0 = 0; j0 == 0 || j0 < m; j0 += kTeam * U) {
    float4 x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * kTeam + gt;
      if (j < m) x[u] = v[j];
    }
    if (j0 == 0) then();
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * kTeam + gt;
      if (j < m) {
        float* o = d + h + 4 * j;
        o[0] = x[u].x; o[1] = x[u].y; o[2] = x[u].z; o[3] = x[u].w;
      }
    }
  }
  if (gt < h) d[gt] = tail[0];
  if (rest < n) d[rest] = tail[1];
}

// Stage two rows (s1 may be null): every load of the first row's first
// chunk is issued before the second row's (whose address may wait on the
// header), then the second row, then the rest of the first.
__device__ void team_stage2(float* d0, const float* s0, float* d1,
                            const float* s1, int n, int gt) {
  team_stage(d0, s0, n, gt, [&] {
    if (s1 != nullptr) team_stage(d1, s1, n, gt, [] {});
  });
}

// Store n floats of shared memory into a global row by the team, 16-byte
// stores over its aligned interior.
__device__ void team_store(float* __restrict__ d,
                           const float* __restrict__ s, int n, int gt) {
  const int h = head_of(d, n);
  const int m = (n - h) >> 2;
  float4* v = reinterpret_cast<float4*>(d + h);
  for (int j = gt; j < m; j += kTeam) {
    const float* x = s + h + 4 * j;
    v[j] = make_float4(x[0], x[1], x[2], x[3]);
  }
  if (gt < h) d[gt] = s[gt];
  for (int i = h + 4 * m + gt; i < n; i += kTeam) d[i] = s[i];
}

// Inclusive prefix sum of v[0 .. n) in place (n a multiple of 16, v
// 16-byte aligned), in float, one element after another (torch's cumsum
// on the card), 16-byte loads and stores, each chunk's loads ahead of its
// adds.
__device__ __forceinline__ void chain4(float* v, int n) {
  float4* v4 = reinterpret_cast<float4*>(v);
  float acc = 0.f;
  for (int j0 = 0; j0 < n / 4; j0 += 4) {
    float4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = v4[j0 + u];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      acc = acc + x[u].x;
      x[u].x = acc;
      acc = acc + x[u].y;
      x[u].y = acc;
      acc = acc + x[u].z;
      x[u].z = acc;
      acc = acc + x[u].w;
      x[u].w = acc;
      v4[j0 + u] = x[u];
    }
  }
}

// (key, bin) order of torch.argsort(stable=True) with NaN last.
__device__ __forceinline__ bool pair_less(float ka, int ia, float kb,
                                          int ib) {
  return key_less(ka, kb) || (key_equal(ka, kb) && ia < ib);
}

// Bitonic sort of (key[i], idx[i]), i < n2 (a power of two), ascending in
// pair_less, by team t.
__device__ void team_sort(float* key, int* idx, int n2, int t, int gt) {
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = gt; i < n2; i += kTeam) {
        const int ij = i ^ j;
        if (ij > i) {
          const float ka = key[i], kb = key[ij];
          const int ia = idx[i], ib = idx[ij];
          const bool up = (i & k) == 0;
          if (pair_less(kb, ib, ka, ia) == up) {
            key[i] = kb;
            key[ij] = ka;
            idx[i] = ib;
            idx[ij] = ia;
          }
        }
      }
      team_sync(t);
    }
  }
}

// Sum of v over team t (every thread gets it); cnt is the team's shared
// counter.
__device__ int team_count(int v, int* cnt, int t, int gt) {
  if (gt == 0) *cnt = 0;
  team_sync(t);
  v = __reduce_add_sync(kFull, v);
  if ((gt & 31) == 0 && v != 0) atomicAdd(cnt, v);
  team_sync(t);
  const int total = *cnt;
  team_sync(t);                 // the counter is free again
  return total;
}

// The per-feature values an item reads.
struct Feat {
  int f, nb, mb, mono;
  bool movable, is_cat, mono_pen;
  float pen, dpen;
};

// One child's values an item reads: its sums, output and bounds, the
// parent gain, its mask, threshold bin and CEGB penalty for the feature.
struct Child {
  float tg, th, tc, po, lo, up, pgain, cegb;
  bool fm;
  int thr;
};

// A candidate's gain after the live test and the penalties: -inf where it
// is not live or the child's mask excludes the feature.
__device__ __forceinline__ float adjusted(const SplitScanArgs& a,
                                          const Feat& ft, const Child& ch,
                                          float v) {
  float adj = v * ft.pen;
  if (ft.mono_pen) adj = adj * ft.dpen;
  if (a.cegb != nullptr) adj = adj - ch.cegb;
  return (v > -INFINITY && ch.fm) ? adj : -INFINITY;
}

// A thread's running first maximum of one (child, kind).
struct Best {
  float g = -INFINITY;
  int i = INT_MAX, dl = 0;
  __device__ void take(float g2, int i2, int d2 = 0) {
    if (better(g2, i2, g, i)) {
      g = g2;
      i = i2;
      dl = d2;
    }
  }
};

// The categorical scan of child c of a categorical feature by team t:
// one-vs-rest into best[1], and where a group exists both many-vs-many
// orders into best[2], best[3] (each thread's own candidates).
__device__ __forceinline__ void scan_categorical(
    const SplitScanArgs& a, const Feat& ft,
                                 const Child& ch, int c, const float* H,
                                 float* W, int Bp, int t, int gt, int* cnt,
                                 Best* best) {
  const int B = a.B, F = a.F, f = ft.f, nb = ft.nb;
  const bool use_onehot = nb - 1 <= a.max_cat_to_onehot;
  const float neg = -INFINITY;
  auto val = [&](int b, int k) { return b < nb ? H[3 * b + k] : 0.f; };
  int groups = 0;
  for (int b = gt; b < B; b += kTeam) {
    const float gv = val(b, 0), hv = val(b, 1), cv = val(b, 2);
    const bool cat_bin_ok = b < nb - 1;
    float oh = neg;
    if (cat_bin_ok && use_onehot) {
      bool ok;
      const float gr = ch.tg - gv, hr = ch.th - hv, cr = ch.tc - cv;
      const float gain = split_gain(a, gv, hv, cv, gr, hr, cr, true, ch.po,
                                    ch.lo, ch.up, 0, &ok);
      const bool live = data_ok(a, cv, hv, cr, hr) && cv > 0.f;
      oh = live ? gain - ch.pgain : neg;
    }
    best[1].take(adjusted(a, ft, ch, oh), b);
    groups += cat_bin_ok && cv >= a.min_data_per_group && !use_onehot;
  }
  const int n_groups = team_count(groups, cnt, t, gt);
  if (n_groups == 0) return;    // every many-vs-many gain is -inf
  // the orders: a bitonic sort of the feature's bins [0, ns); the bins past
  // ns (key +inf) follow its +inf keys and precede its NaN keys
  const int ns = min(nb, B);
  int n2 = 1;
  while (n2 < ns) n2 <<= 1;
  const int nl = n_groups - 1;             // live positions are below it
  float* sorted = W;                       // (2, 3, Bp) sorted, then prefix
  float* key = W + 6 * Bp;                 // (n2,) scratch
  int* idx = reinterpret_cast<int*>(key + n2);
  for (int d = 0; d < 2; ++d) {
    for (int i = gt; i < n2; i += kTeam) {
      float kv = NAN;
      if (i < ns) {
        const float gv = val(i, 0), hv = val(i, 1), cv = val(i, 2);
        const bool group_ok = i < nb - 1 && cv >= a.min_data_per_group;
        const float ratio = gv / (hv + a.cat_smooth);
        kv = group_ok ? (d == 0 ? ratio : -ratio) : INFINITY;
      }
      key[i] = kv;
      idx[i] = i < ns ? i : INT_MAX;
    }
    team_sync(t);
    team_sort(key, idx, n2, t, gt);
    int nans = 0;
    for (int i = gt; i < ns; i += kTeam) nans += isnan(key[i]) ? 1 : 0;
    const int fin = ns - team_count(nans, cnt, t, gt);  // non-NaN keys
    uint16_t* rk = a.rank + (((size_t)c * 2 + d) * F + f) * B;
    for (int r = gt; r < ns; r += kTeam) {
      rk[idx[r]] = (uint16_t)(r < fin ? r : r + (B - ns));
    }
    for (int b = ns + gt; b < B; b += kTeam) {
      rk[b] = (uint16_t)(fin + b - ns);
    }
    for (int r = gt; r < nl; r += kTeam) {
      const int b = r < fin ? idx[r]
          : (r < fin + (B - ns) ? ns + (r - fin) : idx[r - (B - ns)]);
      for (int k = 0; k < 3; ++k) {
        sorted[(d * 3 + k) * Bp + r] = b < B ? val(b, k) : 0.f;
      }
    }
    team_sync(t);
  }
  // positions past nl (not written) feed only positions past nl
  if (gt < 6) chain4(sorted + gt * Bp, (nl + 15) & ~15);
  team_sync(t);
  for (int d = 0; d < 2; ++d) {
    for (int r = gt; r < nl; r += kTeam) {
      const float k1 = (float)(r + 1);
      const float gl = sorted[(d * 3) * Bp + r];
      const float hl = sorted[(d * 3 + 1) * Bp + r];
      const float cl = sorted[(d * 3 + 2) * Bp + r];
      const float gr = ch.tg - gl, hr = ch.th - hl, cr = ch.tc - cl;
      bool ok;
      const float gain = split_gain(a, gl, hl, cl, gr, hr, cr, true, ch.po,
                                    ch.lo, ch.up, 0, &ok);
      const bool live = k1 <= a.max_cat_threshold &&
                        k1 < (float)n_groups && data_ok(a, cl, hl, cr, hr);
      best[2 + d].take(adjusted(a, ft, ch, live ? gain - ch.pgain : neg), r);
    }
  }
  team_sync(t);                 // the work area is free again
}

// The candidate tables: each (child, kind, feature)'s gain and bin and
// each (child, feature)'s numerical default-left flag, in the leader CTA
// (a team writes its feature's through distributed shared memory).
struct Cand {
  float* g;      // (2, 4, F)
  int* b;        // (2, 4, F)
  int* dl;       // (2, F)
};

// Words of the candidate tables for F features.
__host__ __device__ constexpr int cand_words(int F) { return 18 * F; }

// The numerical candidates of bin b of both children in kDirs missing
// directions (2 where the feature's missing bin moves), straight-line, so
// that the children's and the directions' chains interleave; bins past a
// live threshold are evaluated and masked.
template <int kDirs>
__device__ __forceinline__ void numerical_bin(const SplitScanArgs& a,
                                              const Feat& ft,
                                              const Child* ch, const float* W,
                                              int Bp, const float (*miss)[3],
                                              int b, int nodes,
                                              Best (*best)[4]) {
  const int B = a.B;
  const float neg = -INFINITY;
  const bool in_range = b < ft.nb - 1;
  const size_t plane = (size_t)a.F * B;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (c >= nodes) break;
    const Child& cc = ch[c];
    const float* cum = W + c * 3 * Bp;
    const bool valid = in_range && (a.rand_thr == nullptr || b == cc.thr);
    float cb[4];
    if (a.adv != nullptr) {
      const float* p = a.adv + (size_t)c * 4 * plane + (size_t)ft.f * B + b;
      for (int k = 0; k < 4; ++k) cb[k] = p[k * plane];
    }
    float gdir[2] = {neg, neg};
#pragma unroll
    for (int d = 0; d < kDirs; ++d) {
      const float gl = d ? cum[b] + miss[c][0] : cum[b];
      const float hl = d ? cum[Bp + b] + miss[c][1] : cum[Bp + b];
      const float cl = d ? cum[2 * Bp + b] + miss[c][2] : cum[2 * Bp + b];
      const float gr = cc.tg - gl, hr = cc.th - hl, cr = cc.tc - cl;
      bool ok;
      const float gain = split_gain(a, gl, hl, cl, gr, hr, cr, false, cc.po,
                                    cc.lo, cc.up, ft.mono, &ok,
                                    a.adv != nullptr ? cb : nullptr);
      const bool live = valid && ok && data_ok(a, cl, hl, cr, hr);
      gdir[d] = live ? gain - cc.pgain : neg;
    }
    best[c][0].take(adjusted(a, ft, cc, tmax(gdir[0], gdir[1])), b,
                    gdir[1] > gdir[0] ? 1 : 0);
  }
}

// One feature's item by team t: stage (in fold mode also subtract, order
// and pool) its rows, then every candidate of both children; each (child,
// kind)'s first maximum into the leader's candidate tables. red is the
// team's (kTeamWarps, kCands, 3) reduction scratch, cnt its counter.
__device__ __forceinline__ void scan_item(const SplitScanArgs& a, int f,
                                          int depth,
                          int parent, bool ls, float* reg, int Bp,
                          const Cand& cand, int t, int gt,
                          float* red, int* cnt, bool first) {
  const int B = a.B, F = a.F, n = 3 * B, nodes = a.nodes;
  float* H0 = reg;
  float* H1 = reg + 3 * Bp;
  float* W = reg + 6 * Bp;
  // the feature's and the children's scalars, loaded beside the rows (as
  // raw words: nothing waits on them before the rows are staged)
  const uint8_t mov_w = a.movable[f], cat_w = a.is_cat[f];
  const int8_t mono_w = a.monotone[f];
  const int nb_w = a.num_bins[f], mb_w = a.missing_bin[f];
  const float pen_w = a.penalty[f];
  uint8_t fm_w[2] = {0, 0};
  Child ch[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (c >= nodes) break;
    fm_w[c] = a.fmask[(size_t)c * a.mask_stride + f];
    ch[c].cegb = a.cegb != nullptr ? a.cegb[(size_t)c * F + f] : 0.f;
    ch[c].thr = a.rand_thr != nullptr ? a.rand_thr[(size_t)c * F + f] : -1;
    ch[c].tg = a.sums2[c * 3];
    ch[c].th = a.sums2[c * 3 + 1];
    ch[c].tc = a.sums2[c * 3 + 2];
    ch[c].po = a.outs2[c];
    ch[c].lo = a.lows2[c];
    ch[c].up = a.ups2[c];
  }
  const size_t row = (size_t)f * n;
  if (a.pool != nullptr) {
    const size_t hsize = (size_t)F * n;
    float* prow = a.pool + (size_t)parent * hsize + row;
    team_stage2(H0, a.hists + row, H1, prow, n, gt);
    team_sync(t);
    if (first) stamp(a, 1);
    for (int i = gt; i < n; i += kTeam) {
      const float sm = H0[i], lg = H1[i] - sm;
      H0[i] = ls ? sm : lg;
      H1[i] = ls ? lg : sm;
    }
    team_sync(t);                // every read of the parent's row is done
    team_store(prow, H0, n, gt);
    team_store(a.pool + (size_t)a.new_slot * hsize + row, H1, n, gt);
  } else {
    team_stage2(H0, a.hists + row, H1,
                nodes == 2 ? a.hists + (size_t)F * n + row : nullptr, n, gt);
    team_sync(t);
    if (first) stamp(a, 1);
  }
  Feat ft;
  ft.f = f;
  ft.nb = nb_w;
  ft.movable = mov_w != 0;
  ft.mb = mb_w;
  ft.is_cat = cat_w != 0;
  ft.mono = mono_w;
  ft.pen = pen_w;
  ft.mono_pen = a.use_mono_penalty && ft.mono != 0;
#pragma unroll
  for (int c = 0; c < 2; ++c) ch[c].fm = fm_w[c] != 0;
  if (first) stamp(a, 2);
  ft.dpen = ft.mono_pen ? depth_penalty(a, depth) : 1.f;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (c >= nodes) break;
    // leaf_objective_value of the parent (this child)
    ch[c].pgain = gain_given(a, ch[c].tg, ch[c].th,
                             leaf_output(a, ch[c].tg, ch[c].th, 0.f),
                             a.lambda_l2);
  }
  const float neg = -INFINITY;
  const int nb = ft.nb, mb = ft.mb;
  const bool has_miss = ft.movable && mb >= 0 && mb < B;
  Best best[2][4];
  if (!ft.is_cat) {
    // ---- the numerical prefixes: each child's channels channel-major
    // into the work area with find_best_split's zeroed bins (past
    // num_bins, the movable missing bin), then a chain a channel ----
    const int skip = ft.movable ? mb : -1;
    for (int i = gt; i < nodes * Bp; i += kTeam) {
      const int c = i / Bp, b = i - c * Bp;
      const float* H = c ? H1 : H0;
      const bool on = b < B && b < nb && b != skip;
      for (int k = 0; k < 3; ++k) {
        W[(c * 3 + k) * Bp + b] = on ? H[3 * b + k] : 0.f;
      }
    }
    team_sync(t);
    if (gt < 3 * nodes) chain4(W + gt * Bp, Bp);
    team_sync(t);
  }
  if (first) stamp(a, 3);
  if (!ft.is_cat) {
    // ---- numerical thresholds, both missing directions, the two
    // children side by side ----
    float miss[2][3];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float* H = c ? H1 : H0;
      for (int k = 0; k < 3; ++k) {
        // torch sums the masked bins from +0: a -0 missing bin gives +0
        miss[c][k] = has_miss && c < nodes
            ? 0.f + (mb < nb ? H[3 * mb + k] : 0.f) : 0.f;
      }
    }
    for (int b = gt; b < B; b += kTeam) {
      if (ft.movable) {
        numerical_bin<2>(a, ft, ch, W, Bp, miss, b, nodes, best);
      } else {
        numerical_bin<1>(a, ft, ch, W, Bp, miss, b, nodes, best);
      }
    }
  } else if (a.has_categorical) {
    // ---- categorical: one-vs-rest and many-vs-many prefixes ----
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (c >= nodes) break;
      scan_categorical(a, ft, ch[c], c, c ? H1 : H0, W, Bp, t, gt, cnt,
                       best[c]);
    }
  }
  if (first) stamp(a, 4);
  // ---- each (child, kind)'s first maximum over the team ----
  const int warp = gt >> 5, lane = gt & 31;
#pragma unroll
  for (int q = 0; q < kCands; ++q) {
    Best& bq = best[q >> 2][q & 3];
    warp_best(&bq.g, &bq.i, &bq.dl);
    if (lane == 0) {
      float* r = red + (warp * kCands + q) * 3;
      r[0] = bq.g;
      r[1] = __int_as_float(bq.i);
      r[2] = __int_as_float(bq.dl);
    }
  }
  team_sync(t);
  if (gt < kCands && (gt >> 2) < nodes) {
    Best bq;
    for (int w = 0; w < kTeamWarps; ++w) {
      const float* r = red + (w * kCands + gt) * 3;
      bq.take(r[0], __float_as_int(r[1]), __float_as_int(r[2]));
    }
    // no candidate at all (every gain -inf): the first bin, as argmax
    if (bq.i == INT_MAX) {
      bq.g = neg;
      bq.i = 0;
    }
    const int c = gt >> 2, kind = gt & 3;
    cand.g[(c * 4 + kind) * F + f] = bq.g;
    cand.b[(c * 4 + kind) * F + f] = bq.i;
    if (ft.is_cat) bq.dl = 0;
    if (kind == 0) cand.dl[c * F + f] = bq.dl;
  }
  team_sync(t);                  // the reduction scratch is free again
}

// The routing table and the winner's left sums from its histogram row
// (global memory; the many-vs-many ranks, 256 bins and past).
__device__ void finish_sums(const SplitScanArgs& a, int c, int kind,
                            int feat, int tbin, bool dl, int parent,
                            float* X, int Bp, float* T, float* s_sum) {
  const int B = a.B, F = a.F, gt = threadIdx.x & (kTeam - 1);
  const int nb = a.num_bins[feat];
  const size_t n = (size_t)3 * B;
  const float* hist = a.pool != nullptr
      ? a.pool + ((size_t)(c == 0 ? parent : a.new_slot) * F + feat) * n
      : a.hists + ((size_t)c * F + feat) * n;
  const bool movable = a.movable[feat] != 0;
  const int mb = a.missing_bin[feat];
  const uint16_t* rk = a.rank + (((size_t)c * 2 + (kind >= 2 ? kind - 2 : 0))
                                 * F + feat) * B;
  // two bins a thread a chunk: every load of a chunk (the winner's row, its
  // ranks) ahead of its stores
  for (int b0 = 0; b0 < B; b0 += 2 * kTeam) {
    float h[2][3];
    int r[2] = {0, 0};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int b = b0 + u * kTeam + gt;
      for (int k = 0; k < 3; ++k) {
        h[u][k] = b < B ? __ldcg(hist + 3 * b + k) : 0.f;
      }
      if (kind >= 2 && b < B) r[u] = __ldcg(rk + b);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int b = b0 + u * kTeam + gt;
      if (b >= B) continue;
      bool go;
      if (kind == 0) {
        go = b <= tbin;
        if (movable && b == mb) go = dl;
      } else if (kind == 1) {
        go = b == tbin;
      } else {
        go = r[u] <= tbin;
      }
      a.go_left[(size_t)c * B + b] = go ? 1 : 0;
      const bool take = go && b < nb;
      for (int k = 0; k < 3; ++k) X[k * Bp + b] = take ? h[u][k] : 0.f;
    }
  }
  team_sync(c);
  const int lane = threadIdx.x & 31, wg = gt >> 5;
  if (B > 256) {          // the last of a prefix sum, one bin after another
    if (wg == 0 && lane < 3) {
      const float* x = X + lane * Bp;
      float acc = 0.f;
      for (int i0 = 0; i0 < B; i0 += 16) {
        float v[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) v[u] = i0 + u < B ? x[i0 + u] : 0.f;
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          if (i0 + u < B) acc = acc + v[u];
        }
      }
      s_sum[lane] = acc;
    }
  } else if (B == 256) {  // 128 pairs, then a tree over them
    if (gt < 128) {
      for (int k = 0; k < 3; ++k) {
        const float a0 = 0.f + X[k * Bp + gt];
        const float a1 = 0.f + X[k * Bp + gt + 128];
        T[k * 128 + gt] = ((a0 + a1) + 0.f) + 0.f;
      }
    }
    team_sync(c);
    for (int off = 64; off > 0; off >>= 1) {
      if (gt < off) {
        for (int k = 0; k < 3; ++k) {
          T[k * 128 + gt] = T[k * 128 + gt] + T[k * 128 + gt + off];
        }
      }
      team_sync(c);
    }
    if (gt < 3) s_sum[gt] = T[gt * 128];
  } else if (wg == 0) {   // four strided accumulators a channel
    const int k = lane >> 2, q = lane & 3;
    float acc = 0.f;
    if (lane < 12) {
      const float* x = X + k * Bp;
      constexpr int U = 8;
      for (int i0 = q; i0 < B; i0 += 4 * U) {
        float v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          v[u] = i0 + 4 * u < B ? x[i0 + 4 * u] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (i0 + 4 * u < B) acc = acc + v[u];
        }
      }
    }
    const int base = lane & ~3;
    const float a0 = __shfl_sync(kFull, acc, base);
    const float a1 = __shfl_sync(kFull, acc, base + 1);
    const float a2 = __shfl_sync(kFull, acc, base + 2);
    const float a3 = __shfl_sync(kFull, acc, base + 3);
    if (lane < 12 && q == 0) s_sum[k] = ((a0 + a1) + a2) + a3;
  }
  team_sync(c);
}

// Child c's outputs from the winner and its left sums s_sum (thread 0 of
// the team).
__device__ void finish_outputs(const SplitScanArgs& a, int c, float best,
                               int kind, int feat, int tbin, bool dl,
                               const float* s_sum) {
  const int B = a.B, F = a.F;
  if ((threadIdx.x & (kTeam - 1)) == 0) {
    const float ls[3] = {s_sum[0], s_sum[1], s_sum[2]};
    float rs[3];
    for (int k = 0; k < 3; ++k) rs[k] = a.sums2[c * 3 + k] - ls[k];
    const float extra = kind > 0 ? a.cat_l2 : 0.f;
    const float po = a.outs2[c];
    float wl = smoothed(a, leaf_output(a, ls[0], ls[1], extra), ls[2], po);
    float wr = smoothed(a, leaf_output(a, rs[0], rs[1], extra), rs[2], po);
    if (a.has_monotone && a.adv != nullptr) {
      // the winner's own bounds, whatever its kind (find_best_split)
      const size_t plane = (size_t)F * B;
      const float* p = a.adv + (size_t)c * 4 * plane + (size_t)feat * B +
                       tbin;
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

// Child c's finish in the leader CTA's team c, from the winner (kind,
// feat, tbin, dl) over (kind, feature, bin) and its gain `best`: the
// routing table, the left sums in torch.sum's order, the outputs. X is
// (3, Bp) and T (3, 128) of the leader's shared memory, s_sum (3,).
__device__ void finish_one(const SplitScanArgs& a, int c, float best,
                           int kind, int feat, int tbin, bool dl,
                           int parent, float* X, int Bp, float* T,
                           float* s_sum) {
  finish_sums(a, c, kind, feat, tbin, dl, parent, X, Bp, T, s_sum);
  finish_outputs(a, c, best, kind, feat, tbin, dl, s_sum);
}

__global__ void __launch_bounds__(kThreads)
split_scan_kernel(const SplitScanArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_red[kMaxTeams][kTeamWarps * kCands * 3];
  __shared__ int s_cnt[kMaxTeams];
  __shared__ float s_g[2][kTeamWarps];
  __shared__ int s_i[2][kTeamWarps];
  __shared__ int s_d[2][kTeamWarps];
  __shared__ float s_sum[2][3];
  // the header's words read together: every CTA reads the same live word,
  // and a dead split writes nothing
  const bool fold = a.pool != nullptr;
  const int live = a.live[0], depth = a.depth[0];
  const int parent = fold ? a.hdr[7] : 0;
  const bool ls = fold ? a.hdr[4] != 0 : true;
  if (live == 0) return;
  stamp(a, 0);
  cg::cluster_group cluster = cg::this_cluster();
  const int crank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int F = a.F, B = a.B, Bp = padded(B);
  const int t = threadIdx.x / kTeam, gt = threadIdx.x % kTeam;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tw = a.ws;
  Cand local;                    // this CTA's tables (the leader's are used)
  local.g = smem + (size_t)tw * kRegion * Bp;
  local.b = reinterpret_cast<int*>(local.g + 8 * F);
  local.dl = local.b + 8 * F;
  Cand lead;                     // the leader's, through the cluster
  lead.g = cluster.map_shared_rank(local.g, 0);
  lead.b = cluster.map_shared_rank(local.b, 0);
  lead.dl = cluster.map_shared_rank(local.dl, 0);
  if (t < tw) {
    float* reg = smem + (size_t)t * kRegion * Bp;
    for (int r = 0; r < a.rounds; ++r) {
      const int f = (r * csize + crank) * tw + t;
      if (f >= F) break;
      scan_item(a, f, depth, parent, ls, reg, Bp, lead, t, gt, s_red[t],
                &s_cnt[t], r == 0);
    }
  }
  stamp(a, 5);
  cluster_arrive();     // the candidates and the pooled rows are visible
  cluster_wait();
  stamp(a, 6);
  if (crank != 0) return;
  // ---- the leader: team c picks child c's first maximum over (kind,
  // feature, bin) from its own tables ----
  const int c = t;
  float g = -INFINITY;
  int idx = INT_MAX, dl = 0;
  if (c < a.nodes) {
    for (int q = gt; q < 4 * F; q += kTeam) {
      const int kind = q / F, f = q % F;
      const float g2 = local.g[(c * 4 + kind) * F + f];
      const int i2 = q * B + local.b[(c * 4 + kind) * F + f];
      if (better(g2, i2, g, idx)) {
        g = g2;
        idx = i2;
        dl = kind == 0 ? local.dl[c * F + f] : 0;
      }
    }
    warp_best(&g, &idx, &dl);
    if (lane == 0) {
      s_g[c][warp % kTeamWarps] = g;
      s_i[c][warp % kTeamWarps] = idx;
      s_d[c][warp % kTeamWarps] = dl;
    }
    team_sync(c);
    g = s_g[c][0];
    idx = s_i[c][0];
    dl = s_d[c][0];
    for (int w = 1; w < kTeamWarps; ++w) {
      if (better(s_g[c][w], s_i[c][w], g, idx)) {
        g = s_g[c][w];
        idx = s_i[c][w];
        dl = s_d[c][w];
      }
    }
  }
  stamp(a, 7);
  if (c < a.nodes) {
    const int kind = idx / (F * B), feat = (idx % (F * B)) / B;
    float* X = smem + (size_t)c * 3 * Bp;          // the leader's regions
    float* T = smem + (size_t)6 * Bp + c * 3 * 128;
    finish_one(a, c, g, kind, feat, idx % B, dl != 0, parent, X, Bp, T,
               s_sum[c]);
  }
  stamp(a, 8);
}

// The launch shape for F features of B bins in clusters of at most
// max_c CTAs: teams a CTA (ceil(F / max_c), at most 2, fewer where their
// shared memory does not fit `room` bytes), the cluster's CTAs and the
// item rounds; the dynamic shared memory in *bytes. False where one team
// does not fit.
bool plan(int F, int B, int room, int max_c, int* tw, int* csize,
          int* rounds, size_t* bytes) {
  const size_t region = (size_t)kRegion * padded(B) * sizeof(float);
  const size_t tables = (size_t)cand_words(F) * sizeof(float);
  int w = (F + max_c - 1) / max_c;
  w = w < 1 ? 1 : (w > kMaxTeams ? kMaxTeams : w);
  for (; w >= 1; --w) {
    const int need_c = (F + w - 1) / w;
    const int c = need_c < max_c ? need_c : max_c;
    const size_t need = w * region + tables;
    if (need <= (size_t)room) {
      *tw = w;
      *csize = c;
      *rounds = (F + c * w - 1) / (c * w);
      *bytes = need;
      return true;
    }
  }
  return false;
}

// The launch shape on the current device: clusters of up to 16 CTAs
// (Hopper's non-portable size, allowed once a device).
cudaError_t shape(int F, int B, int* tw, int* csize, int* rounds,
                  size_t* bytes) {
  thread_local int raised[lgbt_smem::kMaxDevices] = {};
  thread_local bool wide[lgbt_smem::kMaxDevices] = {};
  int room = 0;
  const void* fn = reinterpret_cast<const void*>(split_scan_kernel);
  cudaError_t e = lgbt_smem::raise_once(&fn, 1, raised, &room);
  if (e != cudaSuccess) return e;
  if (F < 1 || B < 1 || B > kMaxB) return cudaErrorInvalidConfiguration;
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (!wide[dev]) {
    e = cudaFuncSetAttribute(split_scan_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return e;
    wide[dev] = true;
  }
  if (!plan(F, B, room, kMaxCluster, tw, csize, rounds, bytes)) {
    return cudaErrorInvalidConfiguration;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One split scan on `stream`: one cluster of up to 16 CTAs of 512 threads,
// up to two teams of 256 threads (a feature each) a CTA.
// Returns a cudaError_t code (0 on success).
int split_scan(const SplitScanArgs* args, void* stream) {
  SplitScanArgs a = *args;
  const bool fold = a.pool != nullptr;
  if (a.F < 1 || a.B < 1 || a.B > kMaxB || a.live == nullptr ||
      a.depth == nullptr || a.nodes < 1 || a.nodes > 2 ||
      a.hists == nullptr || a.rank == nullptr ||
      (a.mask_stride != 0 && a.mask_stride != a.F) ||
      (fold && (a.hdr == nullptr || a.nodes != 2 || a.new_slot < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int csize = 0;
  size_t bytes = 0;
  cudaError_t e = shape(a.F, a.B, &a.ws, &csize, &a.rounds, &bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, split_scan_kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape split_scan takes for F features of B bins, into out:
// [teams a CTA, CTAs of the cluster, item rounds, dynamic shared bytes].
// Returns a cudaError_t code (0 on success).
int split_scan_shape(int F, int B, int* out) {
  size_t bytes = 0;
  const cudaError_t e = shape(F, B, &out[0], &out[1], &out[2], &bytes);
  out[3] = static_cast<int>(bytes);
  return static_cast<int>(e);
}

}  // extern "C"
