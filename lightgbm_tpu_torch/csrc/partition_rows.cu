// Stable two-way partition of one leaf's segment of the rows work buffer
// (K3 rows), for Hopper (sm_90a): one cooperative launch per split.
//
// Replaces the TPU kernel lightgbm_tpu/ops/partition.py:
// partition_segment_fused (pallas_call "partition_segment_fused", body
// _partition_kernel); entry point partition_segment_rows. Same data
// contract as partition_segment.cu: work is the (2, npad, W) u8 ping-pong
// pair of packed rows, W bytes each (F bin bytes, then g/h/cnt as 12 f32
// bytes, or int8 g, int8 h, u8 cnt when quantized; F may be bundle
// columns); seg = [src, start, cnt, feat] on the device; a row whose
// split-column bin b has table[b] set goes left (bins past the table go
// right). Rows [start, start + cnt) of buffer src are written to buffer
// 1 - src, left rows ascending from start, right rows ascending from
// start + lt; nothing else is written; lt goes to a device int. The result
// equals partition_segment_rows_plain byte for byte.
//
// What bounds it on this card: bytes. The function reads and writes each
// row once: 2 W bytes per row, 124 MB at the 2M-row root at W = 31,
// ~0.037 ms at 3.35 TB/s. A segment larger than the grid's shared memory
// is read twice (the count, then the scatter): ~0.056 ms at that root.
//
// Design: a tile is T = 32 * steps consecutive rows (steps <= 32, about
// 32 KB of rows), i.e. one contiguous run of T * W bytes. Block b of the
// cooperative grid owns the contiguous tiles [b * kb, (b + 1) * kb), kb =
// ceil(tiles / grid), and holds `slots` tile slots of shared memory.
//   1. count. When the block's tiles fit its slots (resident mode), all
//      of them are staged at once with 16-byte cp.async of the aligned
//      chunks that cover them (a tile's first byte lands at its address
//      mod 16 within the slot) and counted from shared memory; they stay
//      there across the barrier, so the segment is read once. Otherwise
//      (two reads) the block counts its rows from the split column in
//      device memory. The block's left count goes to block_left[b].
//      Grid barrier.
//   2. offsets: each block sums block_left over the blocks before it
//      (integer sums, so no order matters) and over all of them (lt).
//   3. scatter, tile by tile (two reads: staged through two slots, the
//      next tile's copy in flight while this one is written): each warp
//      ballots the go-left bits of its 32-row steps; a warp scan of their
//      counts and popc below each lane rank every row on its side; the
//      tile's left rows then form one run of destination bytes starting
//      at row start + (left rows before the tile), its right rows another
//      at start + lt + (right rows before it). Each run is written as
//      aligned 4-byte words (a warp stores 128 consecutive bytes), bytes
//      only at its two ends; each word gathers its 4 bytes from the
//      staged rows (row k / W by a multiply-high with a per-W magic
//      number: no division on the byte path).
// Positions come from prefix counts, never from atomics, so the result
// is fixed. The planes layout keeps partition_segment.cu, whose device
// code phase A of one_kernel_split.cu shares.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_arg.cuh"
#include "smem.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSteps = 32;              // 32-row steps per tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Byte offset in its slot of the first byte of a run staged from g.
__device__ __forceinline__ int stage_pad(const uint8_t* g) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
}

// Stage `bytes` bytes at g into the 16-byte aligned `slot` as the aligned
// 16-byte chunks that cover them (byte k lands at slot + stage_pad(g) + k);
// one commit group per thread. The chunks never leave the allocation:
// device allocations are 256-byte aligned and whole multiples of 16.
__device__ __forceinline__ void stage(uint8_t* slot, const uint8_t* g,
                                      int bytes) {
  const int pad = stage_pad(g);
  const uint8_t* g0 = g - pad;
  const int chunks = (pad + bytes + 15) >> 4;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    cp_async16(slot + 16 * c, g0 + 16 * c);
  }
  cp_async_commit();
}

// Sum of v over the block, returned to every thread.
__device__ __forceinline__ int block_sum(int v, int* s_red) {
  v = __reduce_add_sync(kFull, v);
  __syncthreads();                 // s_red is free
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += s_red[w];
  return t;
}

// Go-left rows among rows [0, n) of `rows` (row i at rows + i * W; shared
// or device memory), this thread's share.
__device__ __forceinline__ int count_left(const uint8_t* rows, int n, int W,
                                          int feat, const uint8_t* s_tbl) {
  int k = 0;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) {
    k += s_tbl[rows[(size_t)i * W + feat]];
  }
  return k;
}

// Bytes k .. k + 3 of the run of rows src[0 ..] of `rows` as a
// little-endian word; k / W = __umulhi(k, magic) while k * W < 2^32.
__device__ __forceinline__ uint32_t gather_word(const uint8_t* rows,
                                                const uint16_t* src, int k,
                                                int W, unsigned magic) {
  int r = static_cast<int>(__umulhi(static_cast<unsigned>(k), magic));
  int w = k - r * W;
  const uint8_t* row = rows + (size_t)src[r] * W;
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (w == W) {                    // W >= 4: at most one row boundary
      w = 0;
      row = rows + (size_t)src[++r] * W;
    }
    v |= static_cast<uint32_t>(row[w++]) << (8 * j);
  }
  return v;
}

// Write rows src[0 .. nrows) of `rows` back to back from d: aligned
// 4-byte words, bytes at the two ends. Byte k of the run is byte k % W of
// row src[k / W].
__device__ __forceinline__ void copy_run(uint8_t* d, const uint8_t* rows,
                                         const uint16_t* src, int nrows,
                                         int W, unsigned magic) {
  const int len = nrows * W;
  if (len == 0) return;
  const int head =
      min(len, static_cast<int>((4 - (reinterpret_cast<uintptr_t>(d) & 3)) &
                                3));
  const int words = (len - head) >> 2;
  const int tail0 = head + 4 * words;
  const int t = threadIdx.x;
  // the ends: at most 3 bytes each
  int k = t < head ? t : tail0 + t - 4;
  if (t < head || (t >= 4 && t < 4 + len - tail0)) {
    const int r = static_cast<int>(__umulhi(static_cast<unsigned>(k), magic));
    d[k] = rows[(size_t)src[r] * W + (k - r * W)];
  }
  uint32_t* dw = reinterpret_cast<uint32_t*>(d + head);
  for (int u = t; u < words; u += kThreads) {
    dw[u] = gather_word(rows, src, head + 4 * u, W, magic);
  }
}

// Scatter one tile of n rows (row i at rows + i * W) into `dst`: its left
// rows from row left_at, its right rows from row right_at. Returns the
// tile's left count to every thread; ends with a barrier, so the shared
// scratch is free for the next tile.
__device__ int scatter_tile(const uint8_t* rows, int n, int W, int feat,
                            const uint8_t* s_tbl, uint8_t* dst,
                            long long left_at, long long right_at,
                            unsigned magic, unsigned* s_mask, int* s_lpre,
                            uint16_t* s_src) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int steps = (n + 31) >> 5;
  for (int s = warp; s < steps; s += kWarps) {
    const int i = s * 32 + lane;
    const bool g = i < n && s_tbl[rows[(size_t)i * W + feat]];
    const unsigned m = __ballot_sync(kFull, g);
    if (lane == 0) s_mask[s] = m;
  }
  __syncthreads();
  if (warp == 0) {                   // exclusive scan of the step counts
    const int c = lane < steps ? __popc(s_mask[lane]) : 0;
    int x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    s_lpre[lane] = x - c;
    if (lane == 31) s_lpre[32] = x;
  }
  __syncthreads();
  const int nl = s_lpre[32];
  const unsigned below = (1u << lane) - 1u;
  for (int s = warp; s < steps; s += kWarps) {
    const int i = s * 32 + lane;
    if (i < n) {
      const unsigned m = s_mask[s];
      const int lb = s_lpre[s] + __popc(m & below);   // left rows before i
      s_src[((m >> lane) & 1u) ? lb : nl + (i - lb)] =
          static_cast<uint16_t>(i);
    }
  }
  __syncthreads();
  copy_run(dst + left_at * W, rows, s_src, nl, W, magic);
  copy_run(dst + right_at * W, rows, s_src + nl, n - nl, W, magic);
  __syncthreads();
  return nl;
}

__global__ void __launch_bounds__(kThreads, 2)
partition_rows_kernel(uint8_t* work, int W, int npad,
                      const int* __restrict__ seg,
                      const uint8_t* __restrict__ table, int nbins,
                      int steps, int slot_bytes, int slots, int mode,
                      int* block_left, int* __restrict__ lt_out) {
  extern __shared__ __align__(16) uint8_t s_ring[];
  __shared__ uint8_t s_tbl[256];
  __shared__ unsigned s_mask[kMaxSteps];
  __shared__ int s_lpre[kMaxSteps + 1];
  __shared__ uint16_t s_src[kMaxSteps * 32];
  __shared__ int s_red[kWarps];
  for (int b = threadIdx.x; b < 256; b += kThreads) {
    s_tbl[b] = b < nbins ? (table[b] != 0) : 0;
  }
  // a dead split (device tree loop) leaves the whole grid here: every
  // block reads the same word, before the grid barrier
  if (mode != lgbt_seg::kSegPlain && seg[6] == 0) return;
  const lgbt_seg::Seg sg = lgbt_seg::read_seg<true>(seg, nullptr, mode);
  const int src = sg.src, start = sg.start, cnt = sg.cnt, feat = sg.col;
  const uint8_t* sbuf = work + (size_t)src * npad * W;
  uint8_t* dbuf = work + (size_t)(1 - src) * npad * W;
  const int T = steps * 32;
  const int nt = (cnt + T - 1) / T;
  const int G = gridDim.x;
  const int kb = (nt + G - 1) / G;
  const int t0 = min((int)blockIdx.x * kb, nt), t1 = min(t0 + kb, nt);
  const bool resident = kb <= slots;
  const unsigned magic = 0xffffffffu / static_cast<unsigned>(W) + 1u;
  auto tile_n = [&](int t) { return min(T, cnt - t * T); };
  auto tile_src = [&](int t) {
    return sbuf + ((size_t)start + (size_t)t * T) * W;
  };
  auto slot = [&](int k) { return s_ring + (size_t)k * slot_bytes; };
  __syncthreads();                   // s_tbl

  // ---- 1. count
  int left = 0;
  if (resident) {
    for (int t = t0; t < t1; ++t) stage(slot(t - t0), tile_src(t),
                                        tile_n(t) * W);
    cp_async_wait_all();
    __syncthreads();
    for (int t = t0; t < t1; ++t) {
      left += count_left(slot(t - t0) + stage_pad(tile_src(t)), tile_n(t), W,
                         feat, s_tbl);
    }
  } else if (t0 < t1) {              // the block's tiles are one run
    left = count_left(tile_src(t0), min(cnt, t1 * T) - t0 * T, W, feat,
                      s_tbl);
  }
  left = block_sum(left, s_red);
  if (threadIdx.x == 0) block_left[blockIdx.x] = left;
  cg::this_grid().sync();

  // ---- 2. offsets
  int before = 0, total = 0;
  for (int b = threadIdx.x; b < G; b += kThreads) {
    const int v = __ldcg(block_left + b);
    total += v;
    if (b < (int)blockIdx.x) before += v;
  }
  before = block_sum(before, s_red);
  total = block_sum(total, s_red);
  if (blockIdx.x == 0 && threadIdx.x == 0) *lt_out = total;

  // ---- 3. scatter
  long long left_at = (long long)start + before;
  long long right_at = (long long)start + total + ((long long)t0 * T - before);
  if (resident) {
    for (int t = t0; t < t1; ++t) {
      const int n = tile_n(t);
      const int nl = scatter_tile(slot(t - t0) + stage_pad(tile_src(t)), n,
                                  W, feat, s_tbl, dbuf, left_at, right_at,
                                  magic, s_mask, s_lpre, s_src);
      left_at += nl;
      right_at += n - nl;
    }
    return;
  }
  const int depth = slots > 1 ? 2 : 1;
  if (t0 < t1) stage(slot(0), tile_src(t0), tile_n(t0) * W);
  for (int t = t0; t < t1; ++t) {
    const int k = t - t0;
    if (depth == 2 && t + 1 < t1) {
      stage(slot((k + 1) & 1), tile_src(t + 1), tile_n(t + 1) * W);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const int n = tile_n(t);
    const int nl = scatter_tile(slot(depth == 2 ? (k & 1) : 0) +
                                    stage_pad(tile_src(t)),
                                n, W, feat, s_tbl, dbuf, left_at, right_at,
                                magic, s_mask, s_lpre, s_src);
    left_at += nl;
    right_at += n - nl;
    if (depth == 1 && t + 1 < t1) {
      stage(slot(0), tile_src(t + 1), tile_n(t + 1) * W);
    }
  }
}

// The most blocks of `smem` dynamic bytes the card runs at once (the
// cooperative grid's ceiling), from a small per-thread cache: a run's
// splits use a handful of slot counts. The first query on a device also
// raises the kernel's dynamic shared-memory limit to the most a block may
// take, once.
cudaError_t max_grid(size_t smem, int* out) {
  constexpr int kCache = 16;
  thread_local int c_dev[kCache], c_grid[kCache], c_n = 0;
  thread_local size_t c_smem[kCache];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  for (int i = 0; i < c_n; ++i) {
    if (c_dev[i] == dev && c_smem[i] == smem) {
      *out = c_grid[i];
      return cudaSuccess;
    }
  }
  thread_local int raised[lgbt_smem::kMaxDevices] = {};
  e = lgbt_smem::raise_once(
      reinterpret_cast<const void*>(partition_rows_kernel), raised);
  if (e != cudaSuccess) return e;
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, partition_rows_kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int i = c_n < kCache ? c_n++ : kCache - 1;
  c_dev[i] = dev;
  c_smem[i] = smem;
  c_grid[i] = per_sm * sms;
  *out = c_grid[i];
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Rows layout: work is (2, npad, W). steps (32-row steps per tile), slots
// (tile slots of shared memory per block) and grid come from
// ops/partition.partition_rows_plan; the grid is cut to what the card runs
// at once. block_left holds at least `grid` ints, lt one. mode
// (segment_arg.cuh) says what seg holds: the segment [src, start, cnt,
// feat], or a split's header. The launch is cudaLaunchKernelEx with the
// cooperative attribute, which stream capture records.
int partition_segment_rows(void* work, int W, int npad, const void* seg,
                           const void* table, int nbins, int steps,
                           int slots, int grid, int mode, void* block_left,
                           void* lt, void* stream) {
  if (W < 4 || steps < 1 || steps > kMaxSteps || slots < 1 || grid < 1 ||
      nbins < 1 || nbins > 256 || !lgbt_seg::seg_mode_ok(mode) ||
      mode == lgbt_seg::kSegSmaller) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows = 32LL * steps;
  if (rows * W * W >= (1LL << 32)) {   // the magic-number division
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int slot_bytes = static_cast<int>((rows * W + 31) / 16 * 16);
  const size_t smem = static_cast<size_t>(slots) * slot_bytes;
  int most = 0;
  cudaError_t e = max_grid(smem, &most);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (grid > most) grid = most;
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
  e = cudaLaunchKernelEx(&cfg, partition_rows_kernel,
                         static_cast<uint8_t*>(work), W, npad,
                         static_cast<const int*>(seg),
                         static_cast<const uint8_t*>(table), nbins, steps,
                         slot_bytes, slots, mode,
                         static_cast<int*>(block_left),
                         static_cast<int*>(lt));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
