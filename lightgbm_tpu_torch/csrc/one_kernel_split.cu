// One split in one cooperative launch, for Hopper (sm_90a): the partition
// of the parent's segment, the smaller child's histogram and both
// children's split scan.
//
// Replaces the TPU kernel lightgbm_tpu/ops/partition.py:
// one_kernel_split_planes (pallas_call "one_kernel_split_planes", body
// _one_kernel_split_kernel), in both of its modes: planes (entry point
// one_kernel_split) and resident (entry point one_kernel_split_resident,
// the TPU kernel's resident_planes argument). Same contract: work is the
// (2, W, Npad) u8 plane pair of ops/partition.py. The split's scalars are
// read on the card from a device header hdr = [src, start, cnt, col,
// left_smaller, depth, live, parent_slot] (ops/partition.ONE_KERNEL_HDR):
// the parent's rows [start, start + cnt) of plane src are routed into plane
// 1 - src by the (B,) go-left table, left rows first; the smaller child
// (the left one when left_smaller) gets a fresh histogram, the larger one
// is the parent (row parent_slot of the histogram pool) minus smaller; then
// ops/split.find_best_split runs on both children with node_depth = depth,
// and each child's SplitInfo is written into the caller's buffers. When
// live is 0 every block returns before its first grid barrier (all blocks
// read the same word) and nothing is written: the device tree loop
// (learner.DeviceTreeLoop) launches a fixed number of splits per tree
// and a tree that stops early runs the rest as such no-ops.
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
// Phase C's device code lives in split_scan.cuh, shared with the split
// scan kernel (csrc/split_scan.cu); this file instantiates it in torch's
// CPU summation order. Phase C follows torch's arithmetic op by op: this
// file is compiled with -fmad=false so no multiply-add is contracted, and
// the scalar hyperparameters arrive as the float32 values torch would
// use. Prefix sums accumulate in double and round each to float, as
// torch's CPU cumsum does, one thread per channel (on the card torch's
// cumsum sums in float, so gains agree with the twin on the card at a
// tolerance, not bit for bit; the split scan kernel follows the card's
// order instead). NaN gains are never live;
// torch.maximum/minimum propagate NaN and so do the helpers here; the
// stable many-vs-many orders are ranks (count of smaller keys plus equal
// keys at a lower bin, NaN last).
//
// Why one cooperative launch: a stable partition needs a scan across
// blocks, the histogram needs the routed rows, the scan needs the whole
// histogram, and on Hopper nothing carries from block to block without a
// grid barrier, a ticket or another launch. A launch with <<<>>> would
// leave grid.sync() undefined; the entry point launches with the
// cooperative launch attribute (cudaLaunchKernelEx, which a CUDA graph
// captures) and sizes the grid to the blocks that fit on the card at once
// (occupancy x SMs, queried once per device and shared-memory size).
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
#include "split_scan.cuh"

namespace cg = cooperative_groups;

// Field order and types must match ops/partition.py OneKernelArgs.
struct OneKernelArgs {
  uint8_t* work;
  const int32_t* hdr;          // (8,) [src, start, cnt, col, left_smaller,
                               //  depth, live, parent_slot]
  const uint8_t* table;        // (table_bins,) bool
  const float* parent;         // (., F, B, 3) pool, row hdr[7] the parent
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
  // the per-node inputs of split_scan.cuh, which this kernel never takes
  // (the learner sends by-node sampling, extra-trees and CEGB to the
  // three-launch chain): null, and mask_stride 0 (one mask both children
  // share)
  const int32_t* rand_thr;
  const float* cegb;
  int32_t W, npad, table_bins, F, B, nch, groups,
      max_cat_to_onehot, has_categorical, has_monotone, use_mono_penalty,
      npad_res, mask_stride;
  float lambda_l1, lambda_l2, two_l1, l2_cat, min_data_in_leaf,
      min_sum_hessian, min_gain_to_split, max_delta_step, cat_smooth, cat_l2,
      min_data_per_group, path_smooth, monotone_penalty, max_cat_threshold;
};

namespace {

using namespace lgbt_scan;   // phase C's device code (split_scan.cuh)

constexpr int kThreads = lgbt_part::kPartThreads;   // 256, one per bin
static_assert(kThreads == kScanThreads, "phase C takes one thread a bin");
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

// Phase C item: the reduce of feature f's chunk partials (one thread per
// bin, its NCH channels summed in chunk order, four chunks' loads in
// flight), hi + lo, and child c's histogram row: the smaller child's sums
// or parent - them. Writes the row to hist_left / hist_right and returns
// it in hv (zero past B).
template <int kNch>
__device__ __forceinline__ void child_bins(const OneKernelArgs& a, int c,
                                           int f, int chunks,
                                           bool left_smaller,
                                           const float* parent, float hv[3]) {
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
  const bool is_small = (c == 0) == left_smaller;
  float* out = (c == 0 ? a.hist_left : a.hist_right) + fb * 3;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    hv[k] = is_small ? small[k] : parent[fb * 3 + k] - small[k];
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
  // every block reads the same word: a no-op split leaves the whole grid
  // before its first barrier
  if (a.hdr[6] == 0) return;
  const int src = a.hdr[0], start = a.hdr[1], cnt = a.hdr[2];
  // resident: hdr[3] is the resident column, the partition routes plane 0
  const int col = kResident ? lgbt_res::kRoute : a.hdr[3];
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
          srcp, a.npad, start, cnt, a.res, a.npad_res, a.hdr[3],
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
  // (the header's other words are read where they are used, so that no
  // register holds them across the phases)
  const bool left_smaller = a.hdr[4] != 0;
  const int small_start = left_smaller ? start : start + lt;
  const int small_cnt = left_smaller ? lt : cnt - lt;
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
  const bool small_left = a.hdr[4] != 0;
  const int depth = a.hdr[5];
  const float* parent = a.parent + (size_t)a.hdr[7] * a.F * a.B * 3;
  for (int it = blockIdx.x; it < 2 * a.F; it += gridDim.x) {
    const int c = it / a.F, f = it % a.F;
    float hv[3];
    child_bins<kNch>(a, c, f, chunks, small_left, parent, hv);
    scan_feature<false>(a, c, f, depth, smem, hv);
    __threadfence();     // this item's outputs are visible grid-wide
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(a.done, 1) == 2 * a.F - 1;
    __syncthreads();
    last = last || s_last;
  }
  stamp(a, 7);
  if (last) {
    __threadfence();
    finish_child<false>(a, 0, smem);
    finish_child<false>(a, 1, smem);
    if (threadIdx.x == 0) *a.done = 0;   // ready for the next launch
    stamp(a, 8);
  }
}

size_t smem_bytes(const OneKernelArgs& a) {
  const size_t hist = lgbt_hist::hist_smem_bytes(a.B, a.nch, kItemFeats);
  const size_t scan = kScanSmemFloats * sizeof(float);
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
  // cudaLaunchKernelEx with the cooperative attribute: the same launch as
  // cudaLaunchCooperativeKernel, and one that stream capture records as a
  // cooperative kernel node of a CUDA graph
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, one_kernel_split_kernel<kResident, kNch>, a);
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
