// Forest-at-once ensemble inference, for Hopper (sm_90a): one walk
// kernel, templated on what a row holds, with two entry points.
//   forest_predict: (N, F) i32 BIN-space rows and the ForestPack (B8).
//   forest_raw: (N, F) f32 raw rows and the PackedSplits tables, the
//     raw-threshold walk.
// Both share the grid, the staging, the link walk, the linear leaves and
// the sums below; a row type (BinRow, RawRow) gives the step's test, the
// category key and the entry's links.
//
// forest_raw replaces the XLA function lightgbm_tpu/ops/predict.py:
// predict_raw_impl (its _route_tree fori_loop and the grouped sums),
// which the JAX serving session jits for any model without a BIN-space
// pack: a model read from its text, a replica's published model, an
// online continue-mode candidate trained on other bins. Its contract is
// the port's plain twin ops/predict.predict_raw_impl: the numerical test
// v <= threshold in f32, NaN -> 0 unless the missing type is NaN (then
// the default direction), |v| <= 1e-35 -> the default direction under
// the Zero missing type, categorical set membership of int(v)
// (non-finite values as -1). Its entries (ops/forest.raw_walk) hold
// {feature | categorical << 31, the f32 threshold's bits, missing type |
// default_left << 2 | next_right << 3, next_left}: 29- and 32-bit links,
// so any depth walks. One class is summed as below; K classes walk all
// groups in one span, so each class chains its groups in order from 0.f
// as the twin does: without linear leaves it equals the twin bit for bit.
//
// forest_predict:
// Replaces the TPU kernel lightgbm_tpu/ops/forest.py:forest_predict_impl
// (pallas_call "forest_predict", inner `kernel`). Same contract: (N, F) i32
// inner-feature bins (+ (N, F) f32 raw rows for linear leaves) and the
// split-major (R rounds, T trees) ForestPack tables -> (N, K) f32 raw
// scores. Every branch of the TPU kernel is here: numerical `b <= tbin`,
// the movable-missing override to default_left, categorical set membership
// (cat_bins), multiclass via tree_class, and linear leaves with the NaN-row
// rule (a NaN in any used feature falls back to the plain leaf value).
//
// What bounds it on this card: not bytes. The inputs are N*F*4 bytes of
// bins read once and N*K*4 bytes written (65,536 rows x 28 features: ~7.6
// MB, ~0.0024 ms at 3.35 TB/s). The work is the routing: each (row, tree)
// pair follows the ~depth splits on its root-to-leaf path, a chain of
// dependent shared-memory reads, so the kernel is bound by latency and
// integer issue, and on small batches by how many SMs it occupies.
//
// Design: a walk per (row, tree) along child links, lanes over trees.
//   walk tables (ops/forest.forest_walk, derived once per pack and kept
//     beside it): per round and tree a 16-byte entry {feature |
//     categorical << 31, tbin, miss, next_left | next_right << 16}, where
//     miss is the movable-missing bin only if its default direction
//     differs from the threshold's (else INT_MIN, which no bin equals), so
//     a numerical step is go = (b <= tbin) != (b == miss). next_left[r] is the
//     first later round that splits the same slot (a row that goes left
//     keeps its slot), next_right[r] the first later round that splits
//     slot r + 1; only rounds below min(num_splits, R) are linked, so
//     padded rounds are never followed, and 0xffff ends the walk. A walk
//     starts at the tree's first round that splits slot 0 (0xffff for a
//     tree without splits: its rows stay at slot 0) and ends at slot[r] if
//     the row went left at its last round r, else r + 1: the slot the TPU
//     kernel's front update reaches after all R rounds.
//   grid (ops/forest.forest_plan): block (c, s) takes row chunk c through
//     the span s of tree groups (8 trees a group; one group a span for
//     one class, K for K classes), a group at a time. It stages the
//     group's entries and leaf values in shared memory (~40 KB at 255
//     leaves) with cp.async, round-major (a set's 8 lanes read 8 different
//     16-byte bank groups), then walks its chunk in passes of 32 rows: a
//     warp takes 4 rows, thread = (row, lane = tree of the group). Each
//     warp stages its own rows' bins (4 x F i32, contiguous),
//     double-buffered by cp.async, so divergent walks read shared memory
//     and no barrier waits for the block's slowest walk; where a pass's
//     bins do not fit beside the tables (wide F), the walks read them from
//     device memory. The rows are cut into as many chunks as fill one wave
//     with every span, so small batches spread over the SMs too. A
//     numerical step is 13 instructions; the categorical set test is
//     compiled only into the kernel for packs that have categorical
//     rounds.
//   tables in device memory (the raw walk only): a group whose entries
//     and leaf values do not fit a block's shared memory (more than
//     ops/forest.FOREST_MAX_ROUNDS rounds) is walked from device memory,
//     entry by entry; only the passes' rows are staged.
//   sums: the 8 lanes of a row hold its group's 8 leaf values; three
//     __shfl_xor_sync steps (xor 4, 2, 1) leave ((v0+v4)+(v2+v6))+
//     ((v1+v5)+(v3+v7)) in lane 0: the oracle's halving association
//     (ops/predict.halving_sum). Multiclass: lane k % 8 sums class k's
//     values over the group's trees in tree order from 0.f (non-class
//     trees add 0.f); the span's groups are chained in group order (the same lane
//     adds each group's sum to its (span, row, class) partial). Each block
//     writes its (span, row, class) partials; the block that takes a
//     chunk's last ticket (a counter after __threadfence) sums them in
//     span order from 0.f and zeroes the ticket. One class has one group
//     a span, so its groups are chained in order from 0.f: it equals the
//     plain twin bit for bit. Every result repeats run to run (no atomics
//     on values).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smem.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTB = 8;                       // trees of a group, lanes of a set
constexpr int kWarpRows = 32 / kTB;          // rows of a warp in a pass
constexpr int kPassRows = kThreads / kTB;    // rows of a pass
constexpr int kEnd = 0xffff;                 // BIN links: the walk ends
constexpr int kRawEnd = (1 << 29) - 1;       // raw links: the walk ends
constexpr int kFeatMask = 0x7fffffff;        // sign bit: categorical round
constexpr float kZero = 1e-35f;              // ops/predict.K_ZERO in f32
constexpr unsigned kFull = 0xffffffffu;

struct WalkArgs {
  const void* rows;            // (n, F) i32 bins or f32 raw values
  const float* X;              // (n, F) raw rows, linear leaves only
  int n, F;
  const int4* nodes;           // (R, T) walk entries
  const int* first;            // (T,)
  const float* value_of_slot;  // (T, L)
  const int* tree_class;       // (T,)
  const int* cats;             // (R, T, Kc) left-routing set, pad -2
  const float* const_of_slot;  // (T, L)
  const float* coeff;          // (T, L, Km)
  const int* coeff_feat;       // (T, L, Km)
  const float* coeff_mask;     // (T, L, Km)
  int R, T, L, K, Kc, Km;
  int has_linear;
  int rows_per_block;          // a multiple of kPassRows
  int span;                    // tree groups of a block
  float* part;                 // (spans, n, K) partials
  unsigned* ticket;            // (chunks,), zero between launches
  float* out;                  // (n, K)
};

// A BIN-space row (forest_predict): entry {feature | cat, tbin, miss,
// next_left | next_right << 16}; miss is INT_MIN where the movable-missing
// bin keeps the threshold's direction.
struct BinRow {
  using Elem = int;
  __device__ static bool numerical(int4 e, int c) {
    return (c <= e.y) != (c == e.z);
  }
  __device__ static int cat_key(int c) { return c; }
  __device__ static int next(int4 e, bool go) {
    const unsigned w = static_cast<unsigned>(e.w);
    return static_cast<int>(go ? w & 0xffffu : w >> 16);
  }
};

// A raw f32 row (forest_raw): ops/predict._route_trees' decision,
// operation for operation.
struct RawRow {
  using Elem = float;
  __device__ static bool numerical(int4 e, float v) {
    const int mt = e.z & 3;
    const bool dl = (e.z >> 2) & 1;
    const bool nan = isnan(v);
    const float u = (nan && mt != 2) ? 0.f : v;
    bool go = u <= __int_as_float(e.y);
    if (mt == 2 && nan) go = dl;
    if (mt == 1 && fabsf(u) <= kZero) go = dl;
    return go;
  }
  __device__ static int cat_key(float v) {
    return isfinite(v) ? static_cast<int>(v) : -1;
  }
  __device__ static int next(int4 e, bool go) {
    return go ? e.w : static_cast<int>(static_cast<unsigned>(e.z) >> 3);
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait(bool one_in_flight) {
  if (one_in_flight) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

// Copy `words` 4-byte words from 16-byte aligned `src` to 16-byte aligned
// `dst` with the `lanes` threads from `lane`: 16 bytes a thread, the tail 4.
__device__ __forceinline__ void stage_words(int* dst, const int* src,
                                            int words, int lane, int lanes) {
  const int vec = words >> 2;
  for (int k = lane; k < vec; k += lanes) {
    cp_async16(dst + 4 * k, src + 4 * k);
  }
  for (int k = 4 * vec + lane; k < words; k += lanes) {
    cp_async4(dst + k, src + k);
  }
}

// Whether a row with value c goes left at round r of tree t (entry e).
// Categorical rounds exist only in a kCat instantiation: the test in
// every walk's loop made the walk up to 1.8x slower.
template <class Row, bool kCat>
__device__ __forceinline__ bool goes_left(const WalkArgs& a, int4 e,
                                          typename Row::Elem c, int r,
                                          int t) {
  if (kCat && e.x < 0) {
    const int key = Row::cat_key(c);
    const int* cb = a.cats + ((size_t)r * a.T + t) * a.Kc;
    bool go = false;
    for (int k = 0; k < a.Kc; ++k) go |= (__ldg(cb + k) == key);
    return go;
  }
  return Row::numerical(e, c);
}

// kStaged: the passes' rows in shared memory; kShared: the group's
// entries and leaf values in shared memory (else read from device memory).
template <class Row, bool kStaged, bool kCat, bool kShared>
__global__ void __launch_bounds__(kThreads, 4)
forest_walk_kernel(WalkArgs a) {
  using Elem = typename Row::Elem;
  extern __shared__ __align__(16) unsigned char s_dyn[];
  __shared__ int s_first[kTB];
  __shared__ int s_cls[kTB];
  __shared__ int s_last;
  const int R = a.R, L = a.L, F = a.F;
  // round-major: a set's 8 lanes read 8 different 16-byte bank groups
  int4* s_node = reinterpret_cast<int4*>(s_dyn);                // (R, kTB)
  float* s_val = reinterpret_cast<float*>(s_node + kTB * R);     // (L, kTB)
  int* s_rows = kShared ? reinterpret_cast<int*>(s_val + kTB * L)
                        : reinterpret_cast<int*>(s_dyn);  // (warps, 2, rows)
  const int warp_words = kWarpRows * F;
  const Elem* rows = static_cast<const Elem*>(a.rows);

  const int chunk = blockIdx.x, sp = blockIdx.y, spans = gridDim.y;
  const int g_lo = sp * a.span, g_hi = min(a.T / kTB, g_lo + a.span);
  const int row_lo = chunk * a.rows_per_block;
  const int row_hi = min(a.n, row_lo + a.rows_per_block);
  const int passes = (row_hi - row_lo + kPassRows - 1) / kPassRows;
  const int warp = threadIdx.x >> 5;
  const unsigned lane = threadIdx.x & 31;
  const int set = lane / kTB, j = lane % kTB;
  int* w_rows = s_rows + warp * 2 * warp_words;
  // each warp stages its own rows of a pass: no block barrier per pass
  auto stage = [&](int p, int b) {
    const int r0 = row_lo + p * kPassRows + warp * kWarpRows;
    if (r0 < row_hi) {
      stage_words(w_rows + b * warp_words,
                  reinterpret_cast<const int*>(rows + (size_t)r0 * F),
                  min(kWarpRows, row_hi - r0) * F, lane, 32);
    }
  };

  for (int grp = g_lo; grp < g_hi; ++grp) {
    const int t0 = grp * kTB;
    const int t = t0 + j;
    __syncthreads();                 // the last group's tables are free
    // the group's entries and leaf values, transposed to (round, tree)
    // and (slot, tree): one commit group
    if (kShared) {
      for (int k = threadIdx.x; k < kTB * R; k += kThreads) {
        cp_async16(s_node + k,
                   a.nodes + (size_t)(k / kTB) * a.T + t0 + k % kTB);
      }
      for (int k = threadIdx.x; k < kTB * L; k += kThreads) {
        cp_async4(s_val + k,
                  a.value_of_slot + (size_t)(t0 + k % kTB) * L + k / kTB);
      }
    }
    cp_async_commit();
    if (kStaged) stage(0, 0);
    cp_async_commit();
    if (threadIdx.x < kTB) {
      s_first[threadIdx.x] = a.first[t0 + threadIdx.x];
      s_cls[threadIdx.x] = a.tree_class[t0 + threadIdx.x];
    }
    cp_async_wait(kStaged);          // the tables' group
    __syncthreads();

    int b = 0;
    for (int p = 0; p < passes; ++p) {
      const int r0 = row_lo + p * kPassRows + warp * kWarpRows;
      if (r0 >= row_hi) break;       // this warp has no rows left
      const bool more = kStaged && p + 1 < passes;
      if (more) {
        stage(p + 1, b ^ 1);
        cp_async_commit();
      }
      if (kStaged) {
        cp_async_wait(more);
        __syncwarp();
      }
      const int row = r0 + set;
      const bool live = row < row_hi;
      float v = 0.f;
      if (live) {
        const Elem* brow =
            kStaged ? reinterpret_cast<const Elem*>(w_rows + b * warp_words) +
                          set * F
                    : rows + (size_t)row * F;
        const int4* nd = s_node + j;  // the lane's tree, round-major
        const int4* gd = a.nodes + t;
        int r = s_first[j], state = 0;
        while (r < R) {               // an end link (> R) ends it
          const int4 e = kShared ? nd[r * kTB] : __ldg(gd + (size_t)r * a.T);
          const bool go =
              goes_left<Row, kCat>(a, e, brow[e.x & kFeatMask], r, t);
          if (!go) state = r + 1;
          r = Row::next(e, go);
        }
        v = kShared ? s_val[state * kTB + j]
                    : __ldg(a.value_of_slot + (size_t)t * L + state);
        if (a.has_linear) {
          const size_t o = (size_t)t * L + state;
          const float* cf = a.coeff + o * a.Km;
          const int* fi = a.coeff_feat + o * a.Km;
          const float* cm = a.coeff_mask + o * a.Km;
          const float* xrow = a.X + (size_t)row * F;
          bool nanrow = false;
          float contrib = 0.f;
          for (int k = 0; k < a.Km; ++k) {
            if (!(__ldg(cm + k) > 0.5f)) continue;
            const float z = __ldg(xrow + __ldg(fi + k));
            if (isnan(z)) nanrow = true;
            else contrib += z * __ldg(cf + k);
          }
          if (!nanrow) v = __ldg(a.const_of_slot + o) + contrib;
        }
      }
      if (a.K == 1) {
        v += __shfl_xor_sync(kFull, v, 4);
        v += __shfl_xor_sync(kFull, v, 2);
        v += __shfl_xor_sync(kFull, v, 1);
        if (live && j == 0) a.part[(size_t)sp * a.n + row] = v;
      } else {
        float w[kTB];
#pragma unroll
        for (int i = 0; i < kTB; ++i) {
          w[i] = __shfl_sync(kFull, v, (lane & ~(kTB - 1u)) | i);
        }
        if (live) {
          for (int k = j; k < a.K; k += kTB) {
            float g = 0.f;
#pragma unroll
            for (int i = 0; i < kTB; ++i) g += (s_cls[i] == k) ? w[i] : 0.f;
            // this lane wrote the span's earlier groups' sum here
            float* pk = a.part + ((size_t)sp * a.n + row) * a.K + k;
            *pk = grp == g_lo ? g : *pk + g;
          }
        }
      }
      if (kStaged) {
        __syncwarp();                // the buffer is free for a later pass
        b ^= 1;
      }
    }
  }

  // the chunk's last block sums the spans' partials in span order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(a.ticket + chunk, 1u) == (unsigned)(spans - 1);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const size_t stride = (size_t)a.n * a.K;
  const int items = (row_hi - row_lo) * a.K;
  for (int i = threadIdx.x; i < items; i += kThreads) {
    const size_t o = (size_t)row_lo * a.K + i;
    float s = 0.f;
    for (int g = 0; g < spans; ++g) s += __ldcg(a.part + g * stride + o);
    a.out[o] = s;
  }
  if (threadIdx.x == 0) a.ticket[chunk] = 0;
}

// The instantiations an entry point launches: every (staged, cat) pair,
// and for the raw rows the device-memory tables too.
template <class Row, bool kShared>
void variants(const void** fns) {
  fns[0] = reinterpret_cast<const void*>(
      forest_walk_kernel<Row, true, false, kShared>);
  fns[1] = reinterpret_cast<const void*>(
      forest_walk_kernel<Row, false, false, kShared>);
  fns[2] = reinterpret_cast<const void*>(
      forest_walk_kernel<Row, true, true, kShared>);
  fns[3] = reinterpret_cast<const void*>(
      forest_walk_kernel<Row, false, true, kShared>);
}

// Raise every variant's dynamic shared-memory limit once (smem.cuh);
// `limit` is then the most a launch of any variant may ask for.
cudaError_t raise_smem(int* limit) {
  thread_local int raised[lgbt_smem::kMaxDevices] = {};
  const void* fns[12];
  variants<BinRow, true>(fns);
  variants<RawRow, true>(fns + 4);
  variants<RawRow, false>(fns + 8);
  return lgbt_smem::raise_once(fns, 12, raised, limit);
}

template <class Row, bool kShared>
void launch(const WalkArgs& a, dim3 grid, int smem, cudaStream_t s,
            int staged, int has_cat) {
  if (staged && has_cat) {
    forest_walk_kernel<Row, true, true, kShared>
        <<<grid, kThreads, smem, s>>>(a);
  } else if (staged) {
    forest_walk_kernel<Row, true, false, kShared>
        <<<grid, kThreads, smem, s>>>(a);
  } else if (has_cat) {
    forest_walk_kernel<Row, false, true, kShared>
        <<<grid, kThreads, smem, s>>>(a);
  } else {
    forest_walk_kernel<Row, false, false, kShared>
        <<<grid, kThreads, smem, s>>>(a);
  }
}

// The checks and arguments both entry points share; returns the status
// of a refused plan, else cudaSuccess with `a` filled.
cudaError_t prepare(WalkArgs* a, const void* rows, const void* X, int n,
                    int F, const void* nodes, const void* first,
                    const void* value_of_slot, const void* tree_class,
                    const void* cats, const void* const_of_slot,
                    const void* coeff, const void* coeff_feat,
                    const void* coeff_mask, int R, int T, int L, int K,
                    int Kc, int Km, int has_linear, int rows_per_block,
                    int chunks, int span, int smem, void* part, void* ticket,
                    void* out) {
  if (n < 1 || F < 1 || R < 1 || L != R + 1 || T < kTB || T % kTB ||
      K < 1 || rows_per_block < kPassRows ||
      rows_per_block % kPassRows || chunks < 1 ||
      (long long)chunks * rows_per_block < n || span < 1 || smem < 0 ||
      reinterpret_cast<uintptr_t>(rows) % 16 ||
      reinterpret_cast<uintptr_t>(nodes) % 16) {
    return cudaErrorInvalidValue;
  }
  int limit = 0;
  cudaError_t e = raise_smem(&limit);
  if (e != cudaSuccess) return e;
  if (smem > limit) return cudaErrorInvalidValue;
  a->rows = rows;
  a->X = static_cast<const float*>(X);
  a->n = n;
  a->F = F;
  a->nodes = static_cast<const int4*>(nodes);
  a->first = static_cast<const int*>(first);
  a->value_of_slot = static_cast<const float*>(value_of_slot);
  a->tree_class = static_cast<const int*>(tree_class);
  a->cats = static_cast<const int*>(cats);
  a->const_of_slot = static_cast<const float*>(const_of_slot);
  a->coeff = static_cast<const float*>(coeff);
  a->coeff_feat = static_cast<const int*>(coeff_feat);
  a->coeff_mask = static_cast<const float*>(coeff_mask);
  a->R = R;
  a->T = T;
  a->L = L;
  a->K = K;
  a->Kc = Kc;
  a->Km = Km;
  a->has_linear = has_linear;
  a->rows_per_block = rows_per_block;
  a->span = span;
  a->part = static_cast<float*>(part);
  a->ticket = static_cast<unsigned*>(ticket);
  a->out = static_cast<float*>(out);
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// staged, rows_per_block, chunks, span and the dynamic shared memory smem
// come from ops/forest.forest_plan; part and ticket from its scratch. A
// plan whose smem exceeds what this card lets a block take is refused.
int forest_predict(const void* bins, const void* X, int n, int F,
                   const void* nodes, const void* first,
                   const void* value_of_slot, const void* tree_class,
                   const void* cat_bins, const void* const_of_slot,
                   const void* coeff, const void* coeff_feat,
                   const void* coeff_mask, int R, int T, int L, int K, int Kc,
                   int Km, int has_cat, int has_linear, int staged,
                   int rows_per_block, int chunks, int span, int smem,
                   void* part,
                   void* ticket, void* out, void* stream) {
  if (R >= kEnd || (K == 1 && span != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  WalkArgs a;
  cudaError_t e = prepare(&a, bins, X, n, F, nodes, first, value_of_slot,
                          tree_class, cat_bins, const_of_slot, coeff,
                          coeff_feat, coeff_mask, R, T, L, K, Kc, Km,
                          has_linear, rows_per_block, chunks, span, smem,
                          part, ticket, out);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(chunks, (T / kTB + span - 1) / span);
  launch<BinRow, true>(a, grid, smem, static_cast<cudaStream_t>(stream),
                       staged, has_cat);
  return static_cast<int>(cudaGetLastError());
}

// The raw walk over (n, F) f32 rows X, which the linear leaves read too;
// cat_values is (R, T, Kc). The plan is ops/forest.forest_plan's with
// raw=True: span 1 for one class, every group for K classes (each class
// then chains its groups in order), and shared = 0 where the group's
// tables do not fit a block's shared memory.
int forest_raw(const void* X, int n, int F, const void* nodes,
               const void* first, const void* value_of_slot,
               const void* tree_class, const void* cat_values,
               const void* const_of_slot, const void* coeff,
               const void* coeff_feat, const void* coeff_mask, int R, int T,
               int L, int K, int Kc, int Km, int has_cat, int has_linear,
               int staged, int shared, int rows_per_block, int chunks,
               int span, int smem, void* part, void* ticket, void* out,
               void* stream) {
  const int groups = T / kTB;
  if (R >= kRawEnd || Kc < 1 || Km < 1 || (K == 1 && span != 1) ||
      (K > 1 && span != groups)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  WalkArgs a;
  cudaError_t e = prepare(&a, X, X, n, F, nodes, first, value_of_slot,
                          tree_class, cat_values, const_of_slot, coeff,
                          coeff_feat, coeff_mask, R, T, L, K, Kc, Km,
                          has_linear, rows_per_block, chunks, span, smem,
                          part, ticket, out);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(chunks, (groups + span - 1) / span);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shared) {
    launch<RawRow, true>(a, grid, smem, s, staged, has_cat);
  } else {
    launch<RawRow, false>(a, grid, smem, s, staged, has_cat);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
