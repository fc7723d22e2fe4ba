// The per-node inputs of the split scan, for Hopper (sm_90a): each node's
// feature mask, extra-trees threshold bins and CEGB gain penalties, drawn
// and computed on the card in one launch.
//
// Replaces the node_inputs / allowed_mask / cegb_penalty code of the JAX
// package's tree loop (lightgbm_tpu/learner.py _make_best_for and
// build_tree_partitioned), XLA there, which the split scan reads:
//
//   mask[c, f]  = fmask[f]
//                 & (by-node sampling: rank(u_f) < kth, u = uniform(
//                    fold_in(key, 2r + 1000 + leaf_c), (F,)), rank the
//                    stable double argsort: #{j : u_j < u_f, or u_j == u_f
//                    and j < f})
//                 & (interaction constraints: f lies in a set compatible
//                    with the features used on the path: set s is
//                    compatible when every used feature is in it)
//   thr[c, f]   = int(uniform(fold_in(key_extra, 2r + 1 + leaf_c), (F,))_f
//                     * max(num_bins[f] - 1, 1))      (extra-trees)
//   delta[c, f] = tradeoff * (penalty_split * cnt_c
//                             + coupled[f] * !tree_used[f])   (CEGB)
//
// for the P (1 or 2) children c of round r: leaf_0 the split's leaf (read
// from the split's device header, or given), leaf_1 the new leaf; key_extra
// = fold_in(key, 2000 + extra_seed), both keys' words in a (4,) int64
// device buffer that a tree fills before it runs, so a CUDA graph reads
// this tree's keys at every replay. With the live word 0 nothing is
// written. The draws are prng.py's bit for bit (node_draws.cuh), the rest
// torch's elementwise arithmetic op for op (built with -fmad=false), so the
// outputs equal the plain twin's (ops/node.node_inputs_plain) bit for bit.
//
// Design: one block per node; the block draws the node's F uniforms into
// shared memory, then each thread ranks its features against all F by
// counting (F^2 compares a node: 19k at F = 137), checks the constraint
// sets (S x F reads, one block-wide AND a set, each set's verdict in the
// node's row of the compat scratch, so S has no bound) and writes its
// features.
// What bounds it: latency (a few microseconds); it reads and writes a few
// kilobytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "node_draws.cuh"

// Field order and types must match ops/node.py NodeArgs.
struct NodeArgs {
  const int64_t* keys;        // (4,) the tree key's words, the extra key's
  const int32_t* live;        // the split's live word, or null: live
  const int32_t* leaf_ptr;    // child 0's leaf, or null: leaf0
  const float* sums;          // (P, 3) the children's g, h, cnt
  const uint8_t* used;        // (L, F) bool features used on the path, or
                              // null; row leaf_0 is the children's
  const uint8_t* tree_used;   // (F,) bool features the model used, or null
  const uint8_t* fmask;       // (F,) bool the tree's feature mask
  const int32_t* num_bins;    // (F,)
  const uint8_t* sets;        // (S, F) bool constraint sets, or null
  const float* coupled;       // (F,) CEGB coupled penalties
  uint8_t* mask;              // (P, F) bool out
  int32_t* thr;               // (P, F) out, or null: no extra-trees
  float* delta;               // (P, F) out, or null: no CEGB
  uint8_t* compat;            // (2, S) scratch: the sets compatible with
                              // each node's path (with sets)
  int32_t F, P, r, leaf0, leaf1, S, kth, bynode;
  float tradeoff, penalty_split;
};

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
node_inputs_kernel(const NodeArgs a) {
  extern __shared__ float s_u[];       // (F,) uniforms
  if (a.live != nullptr && a.live[0] == 0) return;
  const int c = blockIdx.x, F = a.F;
  const int leaf_split = a.leaf_ptr != nullptr ? a.leaf_ptr[0] : a.leaf0;
  const int leaf = c == 0 ? leaf_split : a.leaf1;
  const uint32_t k0 = (uint32_t)a.keys[0], k1 = (uint32_t)a.keys[1];
  const uint32_t e0 = (uint32_t)a.keys[2], e1 = (uint32_t)a.keys[3];
  if (a.bynode) {
    uint32_t n0, n1;
    lgbt_draws::fold_in(k0, k1, (uint32_t)(a.r * 2 + 1000 + leaf), &n0,
                        &n1);
    for (int f = threadIdx.x; f < F; f += blockDim.x) {
      s_u[f] = lgbt_draws::uniform01(n0, n1, (uint32_t)f);
    }
    __syncthreads();
  }
  // interaction constraints: set s is compatible with the path when every
  // used feature lies in it (one block-wide AND a set, written by thread 0
  // into the node's row of the scratch, read back after the barrier)
  uint8_t* compat = a.sets != nullptr ? a.compat + (size_t)c * a.S
                                      : nullptr;
  if (a.sets != nullptr) {
    const uint8_t* used = a.used + (size_t)leaf_split * F;
    for (int s = 0; s < a.S; ++s) {
      int ok = 1;
      for (int f = threadIdx.x; f < F; f += blockDim.x) {
        if (used[f] && !a.sets[(size_t)s * F + f]) ok = 0;
      }
      const int all = __syncthreads_and(ok);
      if (threadIdx.x == 0) compat[s] = all ? 1 : 0;
    }
    __syncthreads();
  }
  uint32_t x0 = 0u, x1 = 0u;
  if (a.thr != nullptr) {
    lgbt_draws::fold_in(e0, e1, (uint32_t)(a.r * 2 + 1 + leaf), &x0, &x1);
  }
  const float cnt = a.delta != nullptr ? a.sums[c * 3 + 2] : 0.f;
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    bool m = a.fmask[f] != 0;
    if (a.bynode) {
      const float uf = s_u[f];
      int rank = 0;
      for (int j = 0; j < F; ++j) {
        const float uj = s_u[j];
        rank += (uj < uf) || (uj == uf && j < f);
      }
      m = m && rank < a.kth;
    }
    if (a.sets != nullptr) {
      bool allowed = false;
      for (int s = 0; s < a.S && !allowed; ++s) {
        allowed = a.sets[(size_t)s * F + f] && compat[s];
      }
      m = m && allowed;
    }
    a.mask[(size_t)c * F + f] = m ? 1 : 0;
    if (a.thr != nullptr) {
      const int nb1 = a.num_bins[f] - 1;
      const float u = lgbt_draws::uniform01(x0, x1, (uint32_t)f);
      a.thr[(size_t)c * F + f] = (int32_t)(u * (float)(nb1 > 1 ? nb1 : 1));
    }
    if (a.delta != nullptr) {
      const float unused = a.tree_used[f] ? 0.f : 1.f;
      const float t1 = a.penalty_split * cnt;
      const float t2 = a.coupled[f] * unused;
      a.delta[(size_t)c * F + f] = a.tradeoff * (t1 + t2);
    }
  }
}

}  // namespace

extern "C" {

const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The inputs of args->P nodes on `stream`: one block of 256 threads a
// node. Returns a cudaError_t code (0 on success).
int node_inputs(const NodeArgs* args, void* stream) {
  const NodeArgs a = *args;
  if (a.F < 1 || a.P < 1 || a.P > 2 || a.keys == nullptr ||
      a.fmask == nullptr || a.mask == nullptr || a.S < 0 ||
      (a.sets != nullptr && (a.used == nullptr || a.compat == nullptr)) ||
      (a.delta != nullptr && (a.tree_used == nullptr ||
                              a.sums == nullptr || a.coupled == nullptr)) ||
      (a.thr != nullptr && a.num_bins == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = a.bynode ? (size_t)a.F * sizeof(float) : 0;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  node_inputs_kernel<<<a.P, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
