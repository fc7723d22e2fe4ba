// The Gram sums of every leaf's ridge system for linear trees, for Hopper
// (sm_90a): the batched leaf fit's one pass over the rows.
//
// Replaces no Pallas kernel: the JAX package accumulates these sums as XLA
// (lightgbm_tpu/linear/fit.py fit_leaves_impl, chunked one-hot
// contractions at Precision.HIGHEST), then solves all leaves with one
// batched jnp.linalg.solve. Same contract as its plain twin
// linear/fit.py gram_sums_plain: the raw features X
// (N, ldx) f32 (NaN kept), every row's leaf row_leaf (N,) i32, the
// gradient and hessian channels ghc (N, 3) f32 (columns 0 and 1; out-of-bag
// rows carry zeros), each leaf's branch-path features feat_idx (L, km) i32
// with feat_mask (L, km) u8 -> per leaf l, with kp1 = km + 1 and z the
// row's masked features followed by a 1 (the intercept):
//   A[l] = sum over rows on l of (z_i * z_j) * wh   (kp1, kp1)
//   B[l] = sum over rows on l of z_i * wg           (kp1,)
//   cnt[l] = rows on l, vcnt[l] = rows on l with no NaN in l's features
// where wh = h * valid and wg = g * valid (valid: no NaN in the row's
// masked features; a NaN feature's z is 0). Out: (L, W) f32 with W =
// kp1 * kp1 + kp1 + 2, the row [A, B, cnt, vcnt].
//
// Deterministic: no float atomics. Each sum adds its rows in a fixed
// order: slice s of the rows (rows_per_slice rows, in row order) gives
// partial (s, l), and the reduce adds partials 0, 1, .., S - 1. The twin
// sums in another order, so the two agree within the f32 summation bound
// of linear/fit.gram_sum_bound, not bit for bit. Built with -fmad=false:
// each product is rounded before it is added, as the twin rounds it.
//
// What bounds it on this card: bytes. The function needs row_leaf for
// every row (4 B), the row's g and h (8 B) and its k features (4k B): ~12 +
// 4k bytes a row, ~45 MB at 2M rows and k = 8, 0.013 ms at 3.35 TB/s;
// kp1^2 multiply-adds a row (~0.2 GFLOP, under the bytes).
//
// Design: gram_partial's block (g, s) holds G leaves' accumulators (W
// floats each) in shared memory, one warp a leaf, and reads the row leaves
// of slice s a 256-row tile at a time. Each warp finds its leaf's rows of
// the tile with one ballot per 32 rows and takes them in row order: the
// row's km features go to a per-warp buffer (one lane a feature), a warp
// vote finds a NaN, and each lane adds its own entries of A and B (kp1^2 /
// 32 a lane), so no two threads write one accumulator. The leaves' row
// leaves are read once per group of G leaves (G = 8 at km <= 32), not once
// per leaf. A warp's rows form a chain of dependent loads (the tile's
// leaves, then the row's features), so the grid asks for enough row
// slices (~4096 blocks) that many warps wait at once; the leaf's feature
// columns sit in shared memory and a row's g, h and features load
// together. gram_reduce then adds the S partials of each (leaf, entry) in
// slice order.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;          // row leaves staged at once
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
constexpr int kReduceThreads = 256;

__global__ void gram_partial(const float* __restrict__ X, int ldx,
                             const int32_t* __restrict__ row_leaf,
                             const float* __restrict__ ghc, long long N,
                             const int32_t* __restrict__ feat_idx,
                             const uint8_t* __restrict__ feat_mask, int L,
                             int km, int G, long long rows_per_slice,
                             float* __restrict__ partial) {
  extern __shared__ float smem[];
  const int kp1 = km + 1;
  const int W = kp1 * kp1 + kp1 + 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int l0 = blockIdx.x * G;
  const int s = blockIdx.y;
  float* acc = smem + (size_t)warp * W;
  float* z = smem + (size_t)G * W + (size_t)warp * kp1;
  int* s_leaf = reinterpret_cast<int*>(smem + (size_t)G * W +
                                       (size_t)G * kp1);
  // the warp's leaf's feature table: its column, or -1 where masked
  int* s_col = s_leaf + kTile + warp * km;
  const int leaf = l0 + warp;
  const bool have = leaf < L;
  for (int e = lane; e < W; e += 32) acc[e] = 0.f;
  for (int k = lane; k < km; k += 32) {
    s_col[k] = have && feat_mask[(size_t)leaf * km + k]
                   ? feat_idx[(size_t)leaf * km + k] : -1;
  }
  const long long r0 = (long long)s * rows_per_slice;
  const long long r1 = min(N, r0 + rows_per_slice);
  for (long long t0 = r0; t0 < r1; t0 += kTile) {
    __syncthreads();                 // the previous tile is consumed
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
      const long long row = t0 + i;
      int v = -1;
      if (row < r1) {
        const int lf = row_leaf[row];
        v = (lf >= l0 && lf < l0 + G) ? lf - l0 : -1;
      }
      s_leaf[i] = v;
    }
    __syncthreads();
    if (!have) continue;
    for (int c = 0; c < kTile / 32; ++c) {
      unsigned m = __ballot_sync(kFull, s_leaf[c * 32 + lane] == warp);
      while (m) {                    // this leaf's rows, in row order
        const int src = __ffs(m) - 1;
        m &= m - 1;
        const long long row = t0 + c * 32 + src;
        // the row's g and h and its features, loaded together
        const float hr = ghc[row * 3 + 1], gr = ghc[row * 3];
        bool nan_row = false;
        for (int k = lane; k < km; k += 32) {
          float v = 0.f;
          const int col = s_col[k];
          if (col >= 0) {
            const float x = X[row * ldx + col];
            if (isnan(x)) {
              nan_row = true;
            } else {
              v = x;
            }
          }
          z[k] = v;
        }
        if (lane == 0) z[km] = 1.f;
        const float valid = __any_sync(kFull, nan_row) ? 0.f : 1.f;
        __syncwarp();                // z is written
        const float wh = hr * valid;
        const float wg = gr * valid;
        const int nA = kp1 * kp1;
        for (int e = lane; e < nA; e += 32) {
          const int i = e / kp1, j = e - i * kp1;
          acc[e] = acc[e] + (z[i] * z[j]) * wh;
        }
        for (int e = lane; e < kp1; e += 32) {
          acc[nA + e] = acc[nA + e] + z[e] * wg;
        }
        if (lane == 0) {
          acc[W - 2] = acc[W - 2] + 1.f;
          acc[W - 1] = acc[W - 1] + valid;
        }
        __syncwarp();                // z is free for the next row
      }
    }
  }
  if (have) {
    __syncwarp();
    float* out = partial + ((size_t)s * L + leaf) * W;
    for (int e = lane; e < W; e += 32) out[e] = acc[e];
  }
}

// out[e] = partial[0][e] + partial[1][e] + ... in slice order, from +0.
__global__ void __launch_bounds__(kReduceThreads)
gram_reduce(const float* __restrict__ partial, int S, long long LW,
            float* __restrict__ out) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < LW; e += step) {
    float v = 0.f;
    for (int s = 0; s < S; ++s) v = v + partial[(size_t)s * LW + e];
    out[e] = v;
  }
}

cudaError_t raise_smem() {
  thread_local bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (raised[dev]) return cudaSuccess;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(gram_partial,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin);
  if (e != cudaSuccess) return e;
  raised[dev] = true;
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The (L, W) Gram rows of every leaf into out, through the (S, L, W)
// scratch partial: G leaves a block (32 * G threads), S row slices of
// rows_per_slice rows (linear/fit.gram_plan sizes both). Returns a
// cudaError_t code (0 on success).
int linear_gram(const void* X, int ldx, const void* row_leaf,
                const void* ghc, long long N, const void* feat_idx,
                const void* feat_mask, int L, int km, int G, int S,
                long long rows_per_slice, void* partial, void* out,
                void* stream) {
  if (L < 1 || km < 1 || G < 1 || G > 32 || S < 1 || N < 0 || ldx < 1 ||
      rows_per_slice < 1 || (long long)S * rows_per_slice < N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = raise_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int kp1 = km + 1;
  const long long W = (long long)kp1 * kp1 + kp1 + 2;
  const size_t smem =
      ((size_t)G * W + (size_t)G * kp1 + kTile + (size_t)G * km) * 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((L + G - 1) / G, S);
  gram_partial<<<grid, 32 * G, smem, st>>>(
      static_cast<const float*>(X), ldx,
      static_cast<const int32_t*>(row_leaf), static_cast<const float*>(ghc),
      N, static_cast<const int32_t*>(feat_idx),
      static_cast<const uint8_t*>(feat_mask), L, km, G, rows_per_slice,
      static_cast<float*>(partial));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long LW = (long long)L * W;
  const long long want = (LW + kReduceThreads - 1) / kReduceThreads;
  const int blocks = (int)(want < 4096 ? want : 4096);
  gram_reduce<<<blocks, kReduceThreads, 0, st>>>(
      static_cast<const float*>(partial), S, LW, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
