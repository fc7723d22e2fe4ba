// The split scan of both children of a split in one launch, for Hopper
// (sm_90a): the third launch of the three-launch chain (partition, the
// smaller child's histogram, the scan) in the device tree loop, and the
// forced-split scan of one leaf before a forced split's commit.
//
// Replaces lightgbm_tpu/ops/split.py find_best_split, which the JAX
// builder runs as XLA inside its lax.while_loop (no Pallas kernel), and in
// this package ops/split.find_best_split on a (2, F, B, 3) batch: about 55
// torch calls a split, a few hundred kernels, which a CUDA graph of a
// 255-leaf tree would hold as tens of thousands of nodes. Same contract:
// the two children's histograms hists (2, F, B, 3) f32 (left, right), the
// split's pair row [sums (2, 3), outputs (2,), lower (2,), upper (2,)]
// (ops/partition.PAIR_WORDS), the FeatureMeta columns, the (F,) search
// mask and the node depth -> each child's best split (gain, feature, bin,
// kind, default_left, go_left (B,), left_sum, right_sum, left_output,
// right_output) in the SplitOut buffers of ops/partition.py, which the
// split commit (csrc/split_commit.cu) reads as it reads the one-kernel
// split's. The depth and a live word come from device words (the split's
// header, ops/partition.ONE_KERNEL_HDR words 5 and 6, or a forced leaf's
// depth and the tree's forcing word); with live 0 every block returns at
// once and nothing is written. Each child may have its own search mask,
// extra-trees threshold bins and CEGB penalties (ops/node.py: by-node
// sampling, interaction constraints), (2, F) each; `nodes` = 1 scans the
// first child only (a forced split's leaf).
//
// The scan is the one-kernel split's phase C (split_scan.cuh, one body for
// both kernels) in torch's summation order on the card (kTorchOrder), so
// its outputs are bit-equal to find_best_split run on the card on the same
// inputs: numerical thresholds in both missing directions, one-vs-rest and
// many-vs-many categorical prefixes, the node's monotone bounds (basic and
// intermediate methods) or each candidate's child bounds (advanced: the
// adv input, find_best_split's adv_bounds) and the depth penalty, the
// feature penalty and mask, min_gain_to_split. Built with
// -fmad=false: no multiply-add is contracted, as torch's elementwise ops
// round each operation.
//
// Design: one block of 256 threads (one a bin up to 256 bins; past that
// kBpt = 2, 4, 8 or 12 bins a thread, up to 3072 bins, with a block-wide
// first maximum over each thread's own) per (child, feature) item, nodes x
// F blocks: the item loads its histogram row, builds its prefix sums in
// shared memory (one thread a channel, one bin after another, as torch's
// cumsum on the card adds) and keeps each kind's first maximum; then it takes a ticket
// (an atomic counter after a __threadfence). The block that takes the last
// one picks each child's first maximum over (kind, feature, bin) and builds
// its routing table, sums and outputs, then zeroes the ticket for the next
// launch. No grid barrier, so no cooperative launch.
//
// What bounds it on this card: latency. It reads the two histograms (2 x F
// x B x 12 B, 0.17 MB at F = 28, B = 255: ~0.05 us at 3.35 TB/s; 0.69 MB
// at B = 1023, ~0.2 us) and does
// ~10 operations a candidate (2 x 4 x F x B candidates: ~0.6 MFLOP, ~0.01
// us at 67 TFLOP/s). Its time is the items' chains: three sequential
// prefix sums of B steps per item (six more with categorical features),
// the many-vs-many ranks (B compares a thread), then the finishing block's
// reductions.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "split_scan.cuh"

// Field order and types must match ops/scan.py SplitScanArgs.
struct SplitScanArgs {
  const float* hists;          // (nodes, F, B, 3) children's histograms
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
  int32_t* done;            // scratch (1,): the ticket, 0 at rest
  float* cand_gain;            // scratch (2, 4, F)
  int32_t* cand_bin;           // scratch (2, 4, F)
  uint8_t* num_dl;             // scratch (2, F, B)
  uint16_t* rank;              // scratch (2, 2, F, B)
  const float* hist_left;      // hists[0], hists[1]
  const float* hist_right;
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
  int32_t F, B, max_cat_to_onehot, has_categorical, has_monotone,
      use_mono_penalty, mask_stride, nodes;
  float lambda_l1, lambda_l2, two_l1, l2_cat, min_data_in_leaf,
      min_sum_hessian, min_gain_to_split, max_delta_step, cat_smooth, cat_l2,
      min_data_per_group, path_smooth, monotone_penalty, max_cat_threshold;
};

namespace {

using namespace lgbt_scan;

template <int kBpt>
__global__ void __launch_bounds__(kScanThreads)
split_scan_kernel(const SplitScanArgs a) {
  extern __shared__ float smem[];
  __shared__ int s_last;
  // every block reads the same word: a dead split writes nothing
  if (a.live[0] == 0) return;
  const int depth = a.depth[0];
  const int F = a.F, B = a.B, b = threadIdx.x, items = a.nodes * F;
  bool last = false;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int c = it / F, f = it % F;
    const float* row = a.hists + ((size_t)c * F + f) * B * 3;
    float hv[kBpt * 3];
#pragma unroll
    for (int j = 0; j < kBpt; ++j) {
      const int bj = b + j * kScanThreads;
      for (int k = 0; k < 3; ++k) hv[j * 3 + k] = bj < B ? row[bj * 3 + k]
                                                         : 0.f;
    }
    scan_feature_n<true, kBpt>(a, c, f, depth, smem, hv);
    __threadfence();     // this item's outputs are visible grid-wide
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(a.done, 1) == items - 1;
    __syncthreads();
    last = last || s_last;
  }
  if (last) {
    __threadfence();
    for (int c = 0; c < a.nodes; ++c) finish_child<true, kBpt>(a, c, smem);
    if (threadIdx.x == 0) *a.done = 0;   // ready for the next launch
  }
}

// The bins a thread takes for B bins: 1 up to 256, else the least of 2,
// 4, 8, 12 that covers B; 0 past 3072.
int bins_per_thread(int B) {
  const int need = (B + kScanThreads - 1) / kScanThreads;
  if (need <= 1) return 1;
  const int options[] = {2, 4, 8, 12};
  for (int bpt : options) {
    if (need <= bpt) return bpt;
  }
  return 0;
}

template <int kBpt>
cudaError_t launch_scan(const SplitScanArgs& a, cudaStream_t stream) {
  const size_t smem = scan_smem_floats(kBpt) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        split_scan_kernel<kBpt>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  split_scan_kernel<kBpt><<<a.nodes * a.F, kScanThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One split scan on `stream`: nodes x F blocks of 256 threads, one
// (child, feature) item each. Returns a cudaError_t code (0 on success).
int split_scan(const SplitScanArgs* args, void* stream) {
  const SplitScanArgs a = *args;
  const int bpt = bins_per_thread(a.B);
  if (a.F < 1 || a.B < 1 || bpt == 0 || a.live == nullptr ||
      a.depth == nullptr || a.nodes < 1 || a.nodes > 2 ||
      (a.mask_stride != 0 && a.mask_stride != a.F) ||
      a.hist_left != a.hists ||
      (a.nodes == 2 &&
       a.hist_right != a.hists + (size_t)a.F * a.B * 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (bpt) {
    case 1: e = launch_scan<1>(a, st); break;
    case 2: e = launch_scan<2>(a, st); break;
    case 4: e = launch_scan<4>(a, st); break;
    case 8: e = launch_scan<8>(a, st); break;
    default: e = launch_scan<12>(a, st); break;
  }
  return static_cast<int>(e);
}

}  // extern "C"
