// LambdaRank's pairwise lambdas, one block per query, for Hopper (sm_90a).
//
// Replaces no pallas_call: the JAX package computes these gradients in XLA
// (lightgbm_tpu/objective.py:595 LambdarankNDCG._bucket_lambdas and the
// scatter of get_gradients, :652): queries bucketed by padded length, a
// stable argsort of each padded row, and about fifteen (Q_b, K, P_b) f32
// pair tensors per bucket. At an MSLR-like shape (2.27M rows, ~120-document
// queries, truncation 30) that is ~77M padded pair elements per tensor:
// ported op for op to torch (ops/rank.lambdarank_gradients_plain, the
// twin) it moves several GB and runs a few hundred launches an iteration.
//
// Here block q takes query q, rows [qb[q], qb[q+1]), n documents:
//   1. its scores and label gains are staged in shared memory (a query of
//      more than smem_docs documents works in a global scratch of 5 words
//      a row at its own rows' offsets instead: no query is refused);
//   2. each document's rank is counted: the documents with a higher score,
//      or an equal score and a lower slot; a NaN score comes after every
//      number, and NaNs keep their slot order. That is the stable argsort
//      of -score the JAX package takes, ties (+0 and -0 too) and NaNs
//      included (at iteration 0 every score is 0 and the ranks are the
//      slots). The scores and gains are written in rank order, with each
//      rank's slot;
//   3. the thread that owns rank r (r = tid, tid + 256, ...) sums, rank by
//      rank in ascending order: its pairs as the higher-ranked side with
//      every rank below it when r < K, then its pairs as the lower side
//      with each rank above it inside the top K. With no NaN score, K =
//      min(truncation_level, n) (ops/rank.py says why that is the JAX
//      package's K); a NaN document sits after the padding of the JAX
//      package's bucket, so its rank there is P_b - n + r, and K counts
//      it in the top only where that rank is (top_ranks). A pair counts
//      when the two gains differ; its lambda and hessian are the JAX
//      package's arithmetic in its order: p = 1 / (1 + exp(sig * (s_hi -
//      s_lo))), |dNDCG| = |disc_i - disc_j| * |gain_i - gain_j| *
//      inv_max_dcg, lam = -sig * p * |dNDCG|, hess = sig^2 * p * (1 - p) *
//      |dNDCG| (built with -fmad=false);
//   4. with lambdarank_norm, the query's sum of |grad| comes from a
//      fixed-order block reduction (each thread's ranks in order, a warp
//      shuffle tree, the warps in order), and both grad and hess are
//      scaled by log2(1 + norm) / norm;
//   5. each rank writes its row's two words: grad * w and max(hess,
//      1e-20) * w (w the row's weight, or 1; a NaN hess stays NaN, as
//      jnp.maximum keeps it).
// No atomics and a fixed summation order: training on the card is
// bit-deterministic run to run. The sums run in another order than XLA's
// and torch's reductions, so the kernel equals its twin within a
// tolerance (ops/rank.LAMBDA_RTOL).
//
// What bounds it: on MSLR-like data the per-row bytes (score, gain and
// weight read, grad and hess written: ~20 B a row, 45 MB, ~0.014 ms at
// 3.35 TB/s) and the pair arithmetic (~59M pairs an iteration, ~25 f32
// operations and one exp each, computed once from each side here: ~0.02 ms
// at 67 TFLOP/s). The rank count costs n^2 comparisons a query, from
// shared memory. Its design is the simple one that is right; the
// measured time stands beside the bound in PERF.md.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemDocsMax = 1024;   // ops/rank.RANK_SMEM_DOCS

// the JAX package's padded query lengths (objective._BUCKET_LADDER); past
// its last rung, multiples of 256
__constant__ int kLadder[] = {8,   16,  24,  32,  48,  64,  96,
                              128, 160, 192, 224, 256, 320, 384,
                              448, 512, 640, 768, 1024};
constexpr int kRungs = sizeof(kLadder) / sizeof(kLadder[0]);

__device__ int bucket_len(int n) {
  for (int i = 0; i < kRungs; ++i)
    if (n <= kLadder[i]) return kLadder[i];
  return (n + 255) / 256 * 256;
}

// How many of a query's ranks are in the top: the JAX package keeps ranks
// below K_b = min(trunc, P_b) of its padded row, where the n_fin numeric
// documents take ranks 0 .. n_fin - 1, the padding the next P_b - n, and
// the NaN documents the last n - n_fin. Ranks stay in order, so the top
// is the first K ranks here. trunc is min(truncation_level, the longest
// query), the JAX package's.
__device__ int top_ranks(int n, int n_fin, int trunc) {
  const int p_b = bucket_len(n);
  const int k_b = min(trunc, p_b);
  return min(n_fin, k_b) + max(0, min(n, k_b - (p_b - n)) - n_fin);
}

__global__ void __launch_bounds__(kThreads) rank_lambdas_kernel(
    const float* __restrict__ score, const float* __restrict__ gains,
    const int32_t* __restrict__ qb, const float* __restrict__ inv_max_dcg,
    const float* __restrict__ discount, const float* __restrict__ weight,
    float* __restrict__ grad, float* __restrict__ hess, float* scratch,
    long long n_rows, int smem_docs, float sig, float sig2, int trunc,
    int norm) {
  extern __shared__ float smem[];
  __shared__ float s_red[kThreads / 32];
  __shared__ float s_scale;
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int start = qb[q];
  const int n = qb[q + 1] - start;
  // the query's arrays: slot order (sp, gp) and rank order (ss, gs, the
  // rank's slot dr, its sums gr, hr)
  const float* sp;
  const float* gp;
  float *ss, *gs, *gr, *hr;
  int* dr;
  if (n <= smem_docs) {   // uniform across the block
    float* s_slot = smem;
    float* g_slot = smem + smem_docs;
    ss = smem + 2 * smem_docs;
    gs = smem + 3 * smem_docs;
    gr = smem + 4 * smem_docs;
    hr = smem + 5 * smem_docs;
    dr = reinterpret_cast<int*>(smem + 6 * smem_docs);
    for (int d = tid; d < n; d += kThreads) {
      s_slot[d] = score[start + d];
      g_slot[d] = gains[start + d];
    }
    sp = s_slot;
    gp = g_slot;
    __syncthreads();
  } else {
    sp = score + start;
    gp = gains + start;
    ss = scratch + start;
    gs = scratch + n_rows + start;
    gr = scratch + 2 * n_rows + start;
    hr = scratch + 3 * n_rows + start;
    dr = reinterpret_cast<int*>(scratch + 4 * n_rows) + start;
  }
  // the numeric scores (a uniform loop: its barriers count them)
  int n_fin = 0;
  for (int b = 0; b < n; b += kThreads)
    n_fin += __syncthreads_count(b + tid < n && !isnan(sp[b + tid]));
  // 2. ranks by counting: the stable descending order of the scores. A
  // NaN compares false with everything, so the count over every slot
  // gives a number its rank among the numbers; a NaN comes after them,
  // the NaNs in slot order.
  for (int d = tid; d < n; d += kThreads) {
    const float sd = sp[d];
    int r = 0;
    if (!isnan(sd)) {
      for (int e = 0; e < n; ++e) {
        const float se = sp[e];
        r += (se > sd) || (se == sd && e < d);
      }
    } else {
      r = n_fin;
      for (int e = 0; e < d; ++e) r += isnan(sp[e]);
    }
    ss[r] = sd;
    gs[r] = gp[d];
    dr[r] = d;
  }
  __syncthreads();
  // 3. each rank's lambdas, in a fixed order
  const int K = top_ranks(n, n_fin, trunc);
  const float inv = inv_max_dcg[q];
  float abs_sum = 0.f;
  for (int r = tid; r < n; r += kThreads) {
    const float s_r = ss[r], g_r = gs[r], d_r = discount[r];
    float lam_hi = 0.f, h_hi = 0.f;
    if (r < K) {
      for (int j = r + 1; j < n; ++j) {
        const float g_j = gs[j];
        if (g_j == g_r) continue;
        const float sgn = g_r > g_j ? 1.f : -1.f;
        const float d = sgn * (s_r - ss[j]);
        const float p = 1.f / (1.f + expf(sig * d));
        const float dn = fabsf(d_r - discount[j]) * fabsf(g_r - g_j) * inv;
        const float lam = -sig * p * dn;
        lam_hi += lam * sgn;
        h_hi += sig2 * p * (1.f - p) * dn;
      }
    }
    float lam_lo = 0.f, h_lo = 0.f;
    const int top = min(K, r);
    for (int i = 0; i < top; ++i) {
      const float g_i = gs[i];
      if (g_i == g_r) continue;
      const float sgn = g_i > g_r ? 1.f : -1.f;
      const float d = sgn * (ss[i] - s_r);
      const float p = 1.f / (1.f + expf(sig * d));
      const float dn = fabsf(discount[i] - d_r) * fabsf(g_i - g_r) * inv;
      const float lam = -sig * p * dn;
      lam_lo += -lam * sgn;
      h_lo += sig2 * p * (1.f - p) * dn;
    }
    const float g = lam_hi + lam_lo;
    gr[r] = g;
    hr[r] = h_hi + h_lo;
    abs_sum += fabsf(g);
  }
  // 4. the query's norm: a block reduction in a fixed order
  for (int o = 16; o > 0; o >>= 1)
    abs_sum += __shfl_down_sync(0xffffffffu, abs_sum, o);
  if ((tid & 31) == 0) s_red[tid >> 5] = abs_sum;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) total += s_red[w];
    s_scale = (norm && total > 0.f)
                  ? log2f(1.f + total) / fmaxf(total, 1e-20f)
                  : 1.f;
  }
  __syncthreads();
  const float scale = s_scale;
  // 5. the rows' own words
  for (int r = tid; r < n; r += kThreads) {
    const int row = start + dr[r];
    const float w = weight != nullptr ? weight[row] : 1.f;
    const float h = hr[r] * scale;
    grad[row] = gr[r] * scale * w;
    hess[row] = (h < 1e-20f ? 1e-20f : h) * w;
  }
}

}  // namespace

extern "C" {

const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The lambdas of num_queries queries (boundaries qb, (Q+1,) i32) on
// `stream`: grad and hess (n_rows,) f32 from score (n_rows,) f32, the rows'
// label gains, each query's inverse max DCG and the discount table (at
// least the longest query's length), trunc = min(truncation_level, the
// longest query). A query may be empty. weight may be null; scratch (5 *
// n_rows words) may be null when no query is longer than smem_docs.
// Returns a cudaError_t code (0 on success).
int rank_lambdas(const float* score, const float* gains, const int32_t* qb,
                 const float* inv_max_dcg, const float* discount,
                 const float* weight, float* grad, float* hess,
                 float* scratch, long long n_rows, int num_queries,
                 int smem_docs, float sig, float sig2, int trunc, int norm,
                 void* stream) {
  if (num_queries <= 0) return 0;
  if (smem_docs < 0 || smem_docs > kSmemDocsMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(smem_docs) * 7 * sizeof(float);
  rank_lambdas_kernel<<<num_queries, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      score, gains, qb, inv_max_dcg, discount, weight, grad, hess, scratch,
      n_rows, smem_docs, sig, sig2, trunc, norm);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
