// Forest-at-once ensemble inference in BIN space, for Hopper (sm_90a).
//
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
// bins read once and N*K*4 bytes written; the node tables (~0.75 MB at 100
// trees x 255 leaves) stay in L2. The work is the routing front: every row
// runs R rounds per tree (a compare against the split's slot each round,
// and a bin read + threshold test on the ~depth rounds that move it), so
// the kernel is bound by integer issue rate and shared-memory latency.
//
// Design: one thread per row, 128 rows per block. The TPU kernel's one-hot
// MXU gather has no reason to exist here -- a thread reads bins[row, f]
// directly (the row's 4F bytes stay in L1 after the first touch). Trees are
// walked in groups of TB = 8 (the oracle's tree_batch): the group's node
// tables are staged into shared memory with coalesced reads along T (the
// (R, T) layout puts a group's 8 trees of one round in one 32-byte sector),
// so each routing round reads a broadcast shared-memory word instead of a
// strided global one. A row's leaf values are summed per group in the
// oracle's association ((v0+v4)+(v2+v6))+((v1+v5)+(v3+v7)) and the group
// partials in tree order, with no atomics: results repeat run to run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;  // threads (= rows) per block
constexpr int kTB = 8;      // trees per staged group (tree_batch)

struct ForestArgs {
  const int* bins;            // (n, F)
  const float* X;             // (n, F) raw rows, linear leaves only
  int n, F;
  const int* slot;            // (R, T)
  const int* feature;         // (R, T)
  const int* tbin;            // (R, T)
  const int* kind;            // (R, T)
  const int* default_left;    // (R, T)
  const int* miss_bin;        // (R, T)
  const int* movable;         // (R, T)
  const int* num_splits;      // (T,)
  const float* value_of_slot; // (T, L)
  const int* tree_class;      // (T,)
  const int* cat_bins;        // (R, T, Kc), pad -2
  const float* const_of_slot; // (T, L)
  const float* coeff;         // (T, L, Km)
  const int* coeff_feat;      // (T, L, Km)
  const float* coeff_mask;    // (T, L, Km)
  int R, T, L, K, Kc, Km;
  int has_cat, has_linear;
  float* out;                 // (n, K)
};

__global__ void __launch_bounds__(kRows)
forest_predict_kernel(ForestArgs a) {
  // shared layout per group: 5 int tables (kTB, R) then values (kTB, L)
  extern __shared__ int smem[];
  const int R = a.R, L = a.L;
  int* s_slot = smem;
  int* s_feat = s_slot + kTB * R;
  int* s_tbin = s_feat + kTB * R;
  int* s_miss = s_tbin + kTB * R;
  int* s_flag = s_miss + kTB * R;  // bit0 categorical, bit1 dl, bit2 movable
  float* s_val = reinterpret_cast<float*>(s_flag + kTB * R);
  __shared__ int s_ns[kTB];
  __shared__ int s_cls[kTB];

  const int tid = threadIdx.x;
  const int row = blockIdx.x * kRows + tid;
  const bool live = row < a.n;
  const int* brow = a.bins + (size_t)(live ? row : 0) * a.F;
  const float* xrow = a.X + (size_t)(live ? row : 0) * a.F;
  float score1 = 0.f;  // K == 1 accumulator; K > 1 accumulates in a.out

  if (live && a.K > 1) {
    for (int k = 0; k < a.K; ++k) a.out[(size_t)row * a.K + k] = 0.f;
  }

  for (int t0 = 0; t0 < a.T; t0 += kTB) {
    __syncthreads();  // the previous group's tables are no longer read
    for (int i = tid; i < R * kTB; i += kRows) {
      const int r = i / kTB, j = i % kTB;
      const size_t src = (size_t)r * a.T + t0 + j;
      s_slot[j * R + r] = a.slot[src];
      s_feat[j * R + r] = a.feature[src];
      s_tbin[j * R + r] = a.tbin[src];
      s_miss[j * R + r] = a.miss_bin[src];
      s_flag[j * R + r] = (a.kind[src] > 0 ? 1 : 0)
                          | (a.default_left[src] == 1 ? 2 : 0)
                          | (a.movable[src] == 1 ? 4 : 0);
    }
    for (int i = tid; i < L * kTB; i += kRows) {
      s_val[i] = a.value_of_slot[(size_t)t0 * L + i];
    }
    if (tid < kTB) {
      s_ns[tid] = min(a.num_splits[t0 + tid], R);
      s_cls[tid] = a.tree_class[t0 + tid];
    }
    __syncthreads();
    if (!live) continue;

    float v[kTB];
#pragma unroll
    for (int j = 0; j < kTB; ++j) {
      const int t = t0 + j;
      const int* sl = s_slot + j * R;
      const int* sf = s_feat + j * R;
      const int* sb = s_tbin + j * R;
      const int* sm = s_miss + j * R;
      const int* sg = s_flag + j * R;
      const int ns = s_ns[j];
      int front = 0;
      for (int r = 0; r < ns; ++r) {
        if (front != sl[r]) continue;
        const int b = __ldg(brow + sf[r]);
        const int fl = sg[r];
        bool go;
        if (a.has_cat && (fl & 1)) {
          const int* cb = a.cat_bins + ((size_t)r * a.T + t) * a.Kc;
          go = false;
          for (int k = 0; k < a.Kc; ++k) go |= (__ldg(cb + k) == b);
        } else {
          go = b <= sb[r];
          if ((fl & 4) && b == sm[r]) go = (fl & 2) != 0;
        }
        if (!go) front = r + 1;
      }
      float val = s_val[j * L + front];
      if (a.has_linear) {
        const size_t o = (size_t)t * L + front;
        const float* cf = a.coeff + o * a.Km;
        const int* fi = a.coeff_feat + o * a.Km;
        const float* cm = a.coeff_mask + o * a.Km;
        bool nanrow = false;
        float contrib = 0.f;
        for (int k = 0; k < a.Km; ++k) {
          if (!(__ldg(cm + k) > 0.5f)) continue;
          const float z = __ldg(xrow + __ldg(fi + k));
          if (isnan(z)) nanrow = true;
          else contrib += z * __ldg(cf + k);
        }
        if (!nanrow) val = __ldg(a.const_of_slot + o) + contrib;
      }
      v[j] = val;
    }
    if (a.K == 1) {
      score1 += ((v[0] + v[4]) + (v[2] + v[6])) + ((v[1] + v[5]) + (v[3] + v[7]));
    } else {
      for (int k = 0; k < a.K; ++k) {
        float g = 0.f;
#pragma unroll
        for (int j = 0; j < kTB; ++j) g += (s_cls[j] == k) ? v[j] : 0.f;
        a.out[(size_t)row * a.K + k] += g;
      }
    }
  }
  if (live && a.K == 1) a.out[row] = score1;
}

}  // namespace

extern "C" {

const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int forest_predict(const void* bins, const void* X, int n, int F,
                   const void* slot, const void* feature, const void* tbin,
                   const void* kind, const void* default_left,
                   const void* miss_bin, const void* movable,
                   const void* num_splits, const void* value_of_slot,
                   const void* tree_class, const void* cat_bins,
                   const void* const_of_slot, const void* coeff,
                   const void* coeff_feat, const void* coeff_mask,
                   int R, int T, int L, int K, int Kc, int Km,
                   int has_cat, int has_linear, void* out, void* stream) {
  ForestArgs a;
  a.bins = static_cast<const int*>(bins);
  a.X = static_cast<const float*>(X);
  a.n = n;
  a.F = F;
  a.slot = static_cast<const int*>(slot);
  a.feature = static_cast<const int*>(feature);
  a.tbin = static_cast<const int*>(tbin);
  a.kind = static_cast<const int*>(kind);
  a.default_left = static_cast<const int*>(default_left);
  a.miss_bin = static_cast<const int*>(miss_bin);
  a.movable = static_cast<const int*>(movable);
  a.num_splits = static_cast<const int*>(num_splits);
  a.value_of_slot = static_cast<const float*>(value_of_slot);
  a.tree_class = static_cast<const int*>(tree_class);
  a.cat_bins = static_cast<const int*>(cat_bins);
  a.const_of_slot = static_cast<const float*>(const_of_slot);
  a.coeff = static_cast<const float*>(coeff);
  a.coeff_feat = static_cast<const int*>(coeff_feat);
  a.coeff_mask = static_cast<const float*>(coeff_mask);
  a.R = R;
  a.T = T;
  a.L = L;
  a.K = K;
  a.Kc = Kc;
  a.Km = Km;
  a.has_cat = has_cat;
  a.has_linear = has_linear;
  a.out = static_cast<float*>(out);
  if (T % kTB != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kTB * (5 * R + L) * 4;  // group tables + leaf values
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        forest_predict_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (n + kRows - 1) / kRows;
  forest_predict_kernel<<<grid, kRows, smem,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
