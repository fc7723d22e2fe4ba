// The dense tree builder's two per-split steps over every row, for Hopper
// (sm_90a): the row update and the masked histogram of one leaf, over u8
// or u16 bins.
//
// Replaces no Pallas kernel: the JAX package's dense builder
// (lightgbm_tpu/learner.py build_tree, the only builder for max_bin > 256
// and tree_builder=dense) runs both as XLA in its lax.while_loop:
//   - the row update row_leaf = where(row_leaf == leaf & ~go_left[bin],
//     new_leaf, row_leaf) (entry point dense_row_update);
//   - hist_of_leaf, a one-hot matmul histogram (ops/histogram.py
//     build_histogram) of the channels masked to the rows on one leaf, or
//     of all rows (entry point dense_histogram).
// Same contracts as their plain twins (ops/histogram.py
// dense_row_update_plain and dense_histogram_plain): bins (N, F) row-major
// u8 or u16 (elem 1 or 2 bytes), ghc (N, 3) f32 (g, h, count), row_leaf
// (N,) i32 -> an (F, B, 3) f32 histogram of the rows whose row_leaf
// equals the leaf. The leaf is a host int (-1: every row) or, with a
// device header hdr (ops/partition.ONE_KERNEL_HDR: words 3 col, 4
// left_smaller, 6 live, 7 parent_slot) and the split's new leaf id, the
// split's smaller child; a header whose live word is 0 writes nothing.
//
// What bounds it on this card: bytes. The histogram needs row_leaf for
// every row (4 B) and, for the M rows it selects, their F bins (F or 2F
// B) and channels (12 B), plus the (F, B, 3) output: at the 2M-row root
// with F = 28 u16 bins, ~144 MB, 0.043 ms at 3.35 TB/s; at a deep leaf of
// 8k rows ~8.6 MB, ~0.0026 ms, dominated by row_leaf. The row update reads
// row_leaf and the split column's bin of each row on the parent, and
// writes the moved rows' leaf.
//
// Design (histogram): four launches queued on the stream, no host read.
//   dh_count: per 4096-row tile, how many rows are on the leaf.
//   dh_compact: each tile's offset is the sum of the earlier tiles'
//     counts; the tile writes its rows' indices there in row order (warp
//     ballots and a block scan of 256-row steps), so idx[0 .. M) lists the
//     selected rows in row order; the last tile writes M.
//   dh_hist: block (c, g, t) sums chunk c (kChunk selected rows) for
//     feature group g and bin tile t, and only if the chunk holds rows:
//     the grid is sized for every row, and blocks past M return at once,
//     so the launch holds in a CUDA graph whatever the leaf's size. Its
//     (feature, slice) histograms are private copies in shared memory,
//     one per warp at a time; 256-row steps are staged (indices, channels,
//     bins) in shared memory; in each 32-row step the lanes that share a
//     bin are found with __match_any_sync and the lowest one adds its
//     group's rows in lane order, pulling the values by shuffle. Features
//     are grouped and bins tiled so that a block's histograms fit its
//     shared memory at any bin count (ops/histogram.dense_plan).
//   dh_reduce: each (feature, bin, channel) adds the chunks' partials in
//     chunk order.
// The summation order is fixed by the selected rows alone: chunk c holds
// selected rows [c * kChunk, (c + 1) * kChunk); a chunk's rows are cut
// into 32-row steps, slice s holding the steps q with q % 4 == s; a slice
// adds its rows one by one; a chunk adds slices 0 + 1 + 2 + 3, the leaf
// its chunks in order. So the kernel is deterministic, and a leaf's
// histogram has the same bits whichever loop (the per-split host loop or
// the device tree loop) asks for it. It is not bit-equal to its twin
// (chunked f32 sums, as the JAX package's chunked one-hot matmul):
// ops/histogram.dense_sum_bound states how far apart they may lie.
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 4096;     // rows of a count / compact tile
constexpr int kChunk = 8192;        // selected rows of a partial
constexpr int kSlices = 4;
constexpr int kStage = 256;         // selected rows staged at once
constexpr unsigned kFull = 0xffffffffu;

// The leaf whose rows are summed, and whether the split is live: the host
// leaf without a header, else the header's smaller child.
__device__ __forceinline__ int pick_leaf(const int* hdr, int leaf,
                                         int new_leaf, bool* live) {
  if (hdr == nullptr) {
    *live = true;
    return leaf;
  }
  *live = hdr[6] != 0;
  return hdr[4] != 0 ? hdr[7] : new_leaf;
}

// The block's sum of v; every thread gets it.
__device__ __forceinline__ int block_sum(int v, int* s_red) {
  for (int o = 16; o; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  __syncthreads();                 // s_red is free
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = 0;
  for (int w = 0; w < kWarps; ++w) t += s_red[w];
  return t;
}

__global__ void __launch_bounds__(kThreads)
dh_count(const int32_t* __restrict__ row_leaf, long long N,
         const int32_t* __restrict__ hdr, int leaf, int new_leaf,
         int32_t* __restrict__ tile_cnt) {
  __shared__ int s_red[kWarps];
  bool live;
  const int lf = pick_leaf(hdr, leaf, new_leaf, &live);
  const long long r0 = (long long)blockIdx.x * kTileRows;
  int cnt = 0;
  if (live) {
    for (int i = threadIdx.x; i < kTileRows; i += kThreads) {
      const long long r = r0 + i;
      if (r < N && (lf < 0 || row_leaf[r] == lf)) ++cnt;
    }
  }
  cnt = block_sum(cnt, s_red);
  if (threadIdx.x == 0) tile_cnt[blockIdx.x] = cnt;
}

__global__ void __launch_bounds__(kThreads)
dh_compact(const int32_t* __restrict__ row_leaf, long long N,
           const int32_t* __restrict__ hdr, int leaf, int new_leaf,
           const int32_t* __restrict__ tile_cnt, int32_t* __restrict__ idx,
           int32_t* __restrict__ m_word) {
  __shared__ int s_red[kWarps];
  __shared__ int s_warp[kWarps];
  bool live;
  const int lf = pick_leaf(hdr, leaf, new_leaf, &live);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int part = 0;
  for (int k = threadIdx.x; k < (int)blockIdx.x; k += kThreads) {
    part += tile_cnt[k];
  }
  int base = block_sum(part, s_red);
  const long long r0 = (long long)blockIdx.x * kTileRows;
  for (int s0 = 0; s0 < kTileRows; s0 += kThreads) {
    const long long r = r0 + s0 + threadIdx.x;
    const bool m = live && r < N && (lf < 0 || row_leaf[r] == lf);
    const unsigned bal = __ballot_sync(kFull, m);
    const int wpos = __popc(bal & ((1u << lane) - 1u));
    if (lane == 0) s_warp[warp] = __popc(bal);
    __syncthreads();
    int wbase = 0, tot = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) wbase += s_warp[w];
      tot += s_warp[w];
    }
    if (m) idx[base + wbase + wpos] = (int32_t)r;
    base += tot;
    __syncthreads();               // s_warp is free
  }
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) *m_word = base;
}

// Warp `warp` counts its (feature, slice) pairs' 32-row steps of a staged
// step of `rows` rows: bins outside [b0, b0 + bt) add nothing.
__device__ __forceinline__ void count_stage(int rows, int nf, int b0, int bt,
                                            const float* s_ch,
                                            const int* s_bin,
                                            float* s_hist) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int steps = (rows + 31) >> 5;
  for (int p = warp; p < nf * kSlices; p += kWarps) {
    const int fl = p / kSlices;
    float* h = s_hist + (size_t)p * bt * 3;
    const int* bins = s_bin + fl * kStage;
    for (int q = p % kSlices; q < steps; q += kSlices) {
      const int r = q * 32 + lane;   // < kStage
      const int b = r < rows ? bins[r] - b0 : -1;
      const bool valid = b >= 0 && b < bt;
      float x[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) x[k] = s_ch[k * kStage + r];
      const unsigned peers = __match_any_sync(kFull, valid ? b : -1);
      const bool leader = valid && lane == __ffs(peers) - 1;
      const int others = leader ? __popc(peers) - 1 : 0;
      const int most = (int)__reduce_max_sync(kFull, (unsigned)others);
      float* hb = h + (leader ? b : 0) * 3;
      float acc[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) acc[k] = leader ? hb[k] + x[k] : 0.f;
      unsigned m = leader ? peers & (peers - 1) : 0u;
      for (int j = 0; j < most; ++j) {
        const int src = m ? __ffs(m) - 1 : lane;
        m &= m - 1;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float v = __shfl_sync(kFull, x[k], src);
          if (j < others) acc[k] += v;
        }
      }
      if (leader) {
#pragma unroll
        for (int k = 0; k < 3; ++k) hb[k] = acc[k];
      }
      __syncwarp();                // the next step's leaders read these
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dh_hist(const T* __restrict__ bins, int F, int B, const float* __restrict__ ghc,
        const int32_t* __restrict__ idx, const int32_t* __restrict__ m_word,
        const int32_t* __restrict__ hdr, int fg, int bt,
        float* __restrict__ partial) {
  extern __shared__ float smem[];
  if (hdr != nullptr && hdr[6] == 0) return;
  const int M = *m_word;
  const int chunk = blockIdx.x;
  const int row0 = chunk * kChunk;
  if (row0 >= M) return;
  const int f0 = blockIdx.y * fg;
  const int nf = min(fg, F - f0);
  const int b0 = blockIdx.z * bt;
  const int nb = min(bt, B - b0);
  const int crows = min(kChunk, M - row0);
  float* s_hist = smem;                                  // (nf * 4, bt, 3)
  float* s_ch = s_hist + (size_t)fg * kSlices * bt * 3;  // (3, kStage)
  int* s_bin = reinterpret_cast<int*>(s_ch + 3 * kStage);  // (fg, kStage)
  const int hist_len = nf * kSlices * bt * 3;
  for (int k = threadIdx.x; k < hist_len; k += kThreads) s_hist[k] = 0.f;
  for (int t0 = 0; t0 < crows; t0 += kStage) {
    const int rows = min(kStage, crows - t0);
    __syncthreads();               // the previous step is counted
    for (int i = threadIdx.x; i < rows; i += kThreads) {
      const long long r = idx[row0 + t0 + i];
#pragma unroll
      for (int k = 0; k < 3; ++k) s_ch[k * kStage + i] = ghc[r * 3 + k];
    }
    for (int k = threadIdx.x; k < rows * nf; k += kThreads) {
      const int i = k / nf, f = k - i * nf;
      const long long r = idx[row0 + t0 + i];
      s_bin[f * kStage + i] = (int)bins[r * F + f0 + f];
    }
    __syncthreads();
    count_stage(rows, nf, b0, bt, s_ch, s_bin, s_hist);
  }
  __syncthreads();
  // the chunk's partial: slices 0 + 1 + 2 + 3 per (feature, bin, channel)
  const int per_f = bt * 3;
  for (int k = threadIdx.x; k < nf * nb * 3; k += kThreads) {
    const int fl = k / (nb * 3), e = k - fl * nb * 3;
    const float* h = s_hist + (size_t)fl * kSlices * per_f + e;
    float v = h[0];
#pragma unroll
    for (int s = 1; s < kSlices; ++s) v += h[s * per_f];
    partial[(((size_t)chunk * F + f0 + fl) * B + b0) * 3 + e] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
dh_reduce(const float* __restrict__ partial, const int32_t* __restrict__ m_word,
          const int32_t* __restrict__ hdr, long long FB3,
          float* __restrict__ out) {
  if (hdr != nullptr && hdr[6] == 0) return;
  const int chunks = (*m_word + kChunk - 1) / kChunk;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < FB3; e += step) {
    float v = 0.f;
    for (int c = 0; c < chunks; ++c) v = v + partial[(size_t)c * FB3 + e];
    out[e] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_update(const T* __restrict__ bins, long long N, int F,
           int32_t* __restrict__ row_leaf, const uint8_t* __restrict__ go_left,
           const int32_t* __restrict__ hdr, int new_leaf) {
  if (hdr[6] == 0) return;
  const int col = hdr[3], parent = hdr[7];
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < N;
       r += step) {
    if (row_leaf[r] == parent && !go_left[bins[r * F + col]]) {
      row_leaf[r] = new_leaf;
    }
  }
}

cudaError_t raise_smem() {
  thread_local int raised[lgbt_smem::kMaxDevices] = {};
  const void* fns[] = {reinterpret_cast<const void*>(dh_hist<uint8_t>),
                       reinterpret_cast<const void*>(dh_hist<uint16_t>)};
  return lgbt_smem::raise_once(fns, 2, raised);
}

}  // namespace

extern "C" {

const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The (F, B, 3) histogram of the rows on one leaf into out (see above):
// hdr null and `leaf` (-1: every row), or hdr and the split's new_leaf.
// Scratch: idx (N,) i32, tile_cnt (ceil(N / 4096),) i32, m_word (1,) i32,
// partial (ceil(N / 8192), F, B, 3) f32. fg features and bt bins a block,
// smem bytes of shared memory (ops/histogram.dense_plan). Returns a
// cudaError_t code.
int dense_histogram(const void* bins, int elem, long long N, int F, int B,
                    const void* ghc, const void* row_leaf, int leaf,
                    const void* hdr, int new_leaf, void* idx, void* tile_cnt,
                    void* m_word, void* partial, int fg, int bt, int smem,
                    void* out, void* stream) {
  if ((elem != 1 && elem != 2) || N < 1 || N > 0x7fffffffLL || F < 1 ||
      B < 1 || fg < 1 || bt < 1 || smem < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = raise_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* h = static_cast<const int*>(hdr);
  const int32_t* rl = static_cast<const int32_t*>(row_leaf);
  int32_t* ix = static_cast<int32_t*>(idx);
  int32_t* tc = static_cast<int32_t*>(tile_cnt);
  int32_t* mw = static_cast<int32_t*>(m_word);
  float* part = static_cast<float*>(partial);
  const int tiles = (int)((N + kTileRows - 1) / kTileRows);
  dh_count<<<tiles, kThreads, 0, st>>>(rl, N, h, leaf, new_leaf, tc);
  dh_compact<<<tiles, kThreads, 0, st>>>(rl, N, h, leaf, new_leaf, tc, ix,
                                         mw);
  const dim3 grid((unsigned)((N + kChunk - 1) / kChunk), (F + fg - 1) / fg,
                  (B + bt - 1) / bt);
  const float* g = static_cast<const float*>(ghc);
  if (elem == 1) {
    dh_hist<uint8_t><<<grid, kThreads, smem, st>>>(
        static_cast<const uint8_t*>(bins), F, B, g, ix, mw, h, fg, bt, part);
  } else {
    dh_hist<uint16_t><<<grid, kThreads, smem, st>>>(
        static_cast<const uint16_t*>(bins), F, B, g, ix, mw, h, fg, bt, part);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long FB3 = (long long)F * B * 3;
  const long long want = (FB3 + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 2048 ? want : 2048);
  dh_reduce<<<blocks, kThreads, 0, st>>>(part, mw, h, FB3,
                                         static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// row_leaf[r] = new_leaf for every row on the header's parent whose bin in
// the header's column goes right by the (B,) bool table go_left; nothing
// where the header is dead.
int dense_row_update(const void* bins, int elem, long long N, int F,
                     void* row_leaf, const void* go_left, const void* hdr,
                     int new_leaf, int grid, void* stream) {
  if ((elem != 1 && elem != 2) || N < 0 || F < 1 || grid < 1 ||
      hdr == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* rl = static_cast<int32_t*>(row_leaf);
  const uint8_t* go = static_cast<const uint8_t*>(go_left);
  const int32_t* h = static_cast<const int32_t*>(hdr);
  if (elem == 1) {
    row_update<uint8_t><<<grid, kThreads, 0, st>>>(
        static_cast<const uint8_t*>(bins), N, F, rl, go, h, new_leaf);
  } else {
    row_update<uint16_t><<<grid, kThreads, 0, st>>>(
        static_cast<const uint16_t*>(bins), N, F, rl, go, h, new_leaf);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
