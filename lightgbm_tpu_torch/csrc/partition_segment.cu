// Stable two-way partition of one leaf's segment of the planes work
// buffer (K3 planes), for Hopper (sm_90a): one cooperative launch per
// split.
//
// Replaces the TPU kernel lightgbm_tpu/ops/partition.py:
// partition_segment_planes_fused (pallas_call "partition_segment_planes_fused",
// body _partition_planes_kernel); entry point partition_segment. Same data
// contract: work is a ping-pong pair of packed rows, each row W bytes (F bin
// bytes, then g/h/cnt as 12 f32 bytes; or the resident layout's 17 slim
// bytes, routed on plane 0), laid out as (2, W, npad) byte planes; the
// segment is lanes [start, start + cnt) of buffer src; rows whose
// split-column bin b has table[b] set in the (B,) bool routing table go
// left (bins past the table go right). Rows are written into buffer
// 1 - src, left rows first; lanes outside the segment are not touched; lt
// (the left count) is written to a device int; seg = [src, start, cnt, feat]
// is read on the device, so the host never waits. Unlike the TPU kernel the
// order is fixed: stable on both sides (left rows ascending from start,
// right rows ascending from start + lt), so the result equals the plain
// twin byte for byte, and holds the same rows in the same order as the rows
// layout's kernel (partition_rows.cu).
//
// What bounds it on this card: bytes. Each row is read once and written
// once, W bytes each way: 80 B per row at W = 40, 160 MB at the 2M-row
// root, ~0.048 ms at 3.35 TB/s. A segment larger than the grid's shared
// memory reads its split column once more for the count (2 MB at the
// root, ~1%).
//
// Design (the rows kernel's, partition_rows.cu, on planes): a tile is
// T = 32 * steps consecutive lanes (steps <= 32). On planes a tile is W
// runs of T bytes, one per plane, all at the same lane offset, so each is
// staged with 16-byte cp.async of the aligned chunks that cover it (its
// first byte lands at its lane mod 16 within the plane's stripe of the
// slot; stripes are T + 16 bytes). Block b of the cooperative grid owns
// the contiguous tiles [b * kb, (b + 1) * kb), kb = ceil(tiles / grid).
//   1. count. When the block's tiles fit its slots with every plane
//      (resident mode), all of them are staged at once and counted from
//      the staged split column; they stay in shared memory across the
//      barrier, so the segment is read once. Otherwise (two reads) the
//      block counts its rows from the split column in device memory.
//      block_left[b] = the block's left count. Grid barrier.
//   2. offsets: each block sums block_left over the blocks before it and
//      over all of them (lt); integer sums, so no order matters.
//   3. scatter, tile by tile (two reads: staged a group of planes at a
//      time through a ring of up to three slots, the next two groups'
//      copies in flight while one is written). Each warp ballots the go-left bits of its 32-row steps; a
//      warp scan of their counts and popc below each lane rank every row on
//      its side. The tile's left rows form one run of lanes from
//      left_at = start + (left rows before the tile), its right rows one
//      from right_at = start + lt + (right rows before it). Each run's
//      tile-local row indices go to shared memory shifted by the run's
//      first lane mod 4, so that destination word j of a plane takes the
//      four indices at 4j .. 4j + 3 with one 8-byte load. Each thread then
//      takes items of one word position over 8 consecutive planes: per
//      plane four staged bytes gathered into one aligned 4-byte store (a
//      warp writes 128 consecutive bytes of one plane). A run's first and last word may hold bytes of the other
//      side or of a neighbouring tile, which another thread or block
//      writes: those words are stored byte by byte, only the run's own.
// Positions come from prefix counts, never from atomics, so the result is
// fixed. The three-launch form this replaces lives on in
// segment_partition.cuh, which phase A of one_kernel_split.cu runs.
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
constexpr int kMaxTile = 32 * kMaxSteps;
constexpr int kStripePad = 16;             // a plane's stripe: T + 16 bytes
// a run's shifted indices: up to 3 leading slots, the run, the last word
constexpr int kIdxLen = kMaxTile + 8;
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

// Wait until at most n (0, 1 or 2) of this thread's newest commit groups
// are still in flight.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n <= 0) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else if (n == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  }
}

// k / d for k * d < 2^32, with m = 0xffffffff / d + 1 (which wraps to 0
// for d = 1).
__device__ __forceinline__ int div_magic(int k, unsigned m) {
  return m ? static_cast<int>(__umulhi(static_cast<unsigned>(k), m)) : k;
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

// Go-left rows among col[0 .. n) in shared memory, this thread's share.
__device__ __forceinline__ int count_left(const uint8_t* col, int n,
                                          const uint8_t* s_tbl) {
  int k = 0;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) k += s_tbl[col[i]];
  return k;
}

// The same for a column in device memory, read as aligned 16-byte words
// (bytes at the two ends).
__device__ __forceinline__ int count_left_dev(const uint8_t* col, int n,
                                              const uint8_t* s_tbl) {
  const int head = min(
      n, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(col) & 15)) &
                          15));
  const int body = (n - head) >> 4;
  int k = 0;
  if (static_cast<int>(threadIdx.x) < head) k += s_tbl[col[threadIdx.x]];
  const uint4* v = reinterpret_cast<const uint4*>(col + head);
  for (int i = threadIdx.x; i < body; i += kThreads) {
    const uint4 x = v[i];
    const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int b = 0; b < 4; ++b) k += s_tbl[(w[j] >> (8 * b)) & 0xffu];
    }
  }
  for (int i = head + 16 * body + threadIdx.x; i < n; i += kThreads) {
    k += s_tbl[col[i]];
  }
  return k;
}

struct Shared {
  uint8_t tbl[256];
  unsigned mask[kMaxSteps];
  int lpre[kMaxSteps + 1];
  int red[kWarps];
  // tile-local row indices of the left and the right run, each shifted
  // by its run's first lane mod 4 (8-byte aligned for the uint2 loads)
  alignas(8) uint16_t idx[2][kIdxLen];
};

// Rank the n rows of one tile from its split column col[0 .. n): row i's
// tile-local index goes to idx[0][shl + (left rows before i)] or
// idx[1][shr + (right rows before i)]. Returns the tile's left count to
// every thread; ends with a barrier.
__device__ int rank_tile(const uint8_t* col, int n, int shl, int shr,
                         Shared& sh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int steps = (n + 31) >> 5;
  for (int s = warp; s < steps; s += kWarps) {
    const int i = s * 32 + lane;
    const bool g = i < n && sh.tbl[col[i]];
    const unsigned m = __ballot_sync(kFull, g);
    if (lane == 0) sh.mask[s] = m;
  }
  __syncthreads();
  if (warp == 0) {                   // exclusive scan of the step counts
    const int c = lane < steps ? __popc(sh.mask[lane]) : 0;
    int x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    sh.lpre[lane] = x - c;
    if (lane == 31) sh.lpre[32] = x;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  for (int s = warp; s < steps; s += kWarps) {
    const int i = s * 32 + lane;
    if (i < n) {
      const unsigned m = sh.mask[s];
      const int lb = sh.lpre[s] + __popc(m & below);   // left rows before i
      if ((m >> lane) & 1u) {
        sh.idx[0][shl + lb] = static_cast<uint16_t>(i);
      } else {
        sh.idx[1][shr + (i - lb)] = static_cast<uint16_t>(i);
      }
    }
  }
  const int nl = sh.lpre[32];
  __syncthreads();
  return nl;
}

// Write planes [w0, w0 + gw) of one ranked tile (n rows, nl left) from its
// staged stripes (plane w0 + q's row i at stage + q * S + i) to dst (buffer
// 1 - src): the left run from lane left_at, the right run from right_at.
// An item is one destination word position of a run over kCopyPlanes
// consecutive planes: its four source indices, its address and whether it
// is whole are worked out once, then each plane takes four staged bytes
// and one aligned 4-byte store. A run's end words are stored byte by byte.
constexpr int kCopyPlanes = 8;

__device__ void copy_tile(const uint8_t* stage, int S, int w0, int gw, int n,
                          int nl, long long left_at, long long right_at,
                          uint8_t* dst, size_t npad, const Shared& sh) {
  const int shl = static_cast<int>(left_at & 3);
  const int shr = static_cast<int>(right_at & 3);
  const int nr = n - nl;
  const int nwl = nl ? (shl + nl + 3) >> 2 : 0;
  const int nwt = nwl + (nr ? (shr + nr + 3) >> 2 : 0);
  if (nwt == 0) return;
  const unsigned m = 0xffffffffu / static_cast<unsigned>(nwt) + 1u;
  const int items = nwt * ((gw + kCopyPlanes - 1) / kCopyPlanes);
  for (int k = threadIdx.x; k < items; k += kThreads) {
    const int pb = div_magic(k, m);
    const int u = k - pb * nwt;
    const bool right = u >= nwl;
    const int j = right ? u - nwl : u;
    const int s = right ? shr : shl;
    const int len = right ? nr : nl;
    const uint2 v =
        *reinterpret_cast<const uint2*>(&sh.idx[right ? 1 : 0][4 * j]);
    const int q0 = pb * kCopyPlanes;
    const int qn = min(kCopyPlanes, gw - q0);
    const uint8_t* st = stage + (size_t)q0 * S;
    uint8_t* d = dst + (size_t)(w0 + q0) * npad +
                 ((right ? right_at : left_at) - s) + 4 * j;
    const int p0 = 4 * j - s;        // run position of the word's byte 0
    const int i0 = v.x & 0xffff, i1 = v.x >> 16;
    const int i2 = v.y & 0xffff, i3 = v.y >> 16;
    if (p0 >= 0 && p0 + 4 <= len) {
#pragma unroll
      for (int q = 0; q < kCopyPlanes; ++q) {
        if (q < qn) {
          const uint32_t word = static_cast<uint32_t>(st[i0]) |
                                static_cast<uint32_t>(st[i1]) << 8 |
                                static_cast<uint32_t>(st[i2]) << 16 |
                                static_cast<uint32_t>(st[i3]) << 24;
          *reinterpret_cast<uint32_t*>(d) = word;
        }
        st += S;
        d += npad;
      }
    } else {
      const int ix[4] = {i0, i1, i2, i3};
      for (int q = 0; q < qn; ++q) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (p0 + b >= 0 && p0 + b < len) d[b] = st[ix[b]];
        }
        st += S;
        d += npad;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
partition_planes_kernel(uint8_t* work, int W, int npad,
                        const int* __restrict__ seg,
                        const uint8_t* __restrict__ table, int nbins,
                        int steps, int group, int slots, int mode,
                        int* block_left, int* __restrict__ lt_out) {
  extern __shared__ __align__(16) uint8_t s_ring[];
  __shared__ Shared sh;
  for (int b = threadIdx.x; b < 256; b += kThreads) {
    sh.tbl[b] = b < nbins ? (table[b] != 0) : 0;
  }
  // a dead split (device tree loop) leaves the whole grid here: every
  // block reads the same word, before the grid barrier
  if (mode != lgbt_seg::kSegPlain && seg[6] == 0) return;
  const lgbt_seg::Seg sg = lgbt_seg::read_seg<true>(seg, nullptr, mode);
  const int src = sg.src, start = sg.start, cnt = sg.cnt, feat = sg.col;
  const uint8_t* sbuf = work + (size_t)src * W * npad;
  uint8_t* dbuf = work + (size_t)(1 - src) * W * npad;
  const int T = steps * 32;
  const int S = T + kStripePad;
  const size_t slot_bytes = (size_t)group * S;
  const int nt = (cnt + T - 1) / T;
  const int G = gridDim.x;
  const int kb = (nt + G - 1) / G;
  const int t0 = min((int)blockIdx.x * kb, nt), t1 = min(t0 + kb, nt);
  const bool resident = kb <= slots && group == W;
  const int ngroups = (W + group - 1) / group;
  auto tile_n = [&](int t) { return min(T, cnt - t * T); };
  auto tile_lane = [&](int t) { return start + t * T; };
  auto slot = [&](int k) { return s_ring + (size_t)k * slot_bytes; };
  // Stage planes [w0, w0 + gw) of tile t into `to` (stripe q at q * S);
  // one commit group per thread. The chunks never leave the allocation:
  // planes are whole multiples of 16 bytes, 16-byte aligned.
  auto stage = [&](uint8_t* to, int t, int w0, int gw) {
    const int a = tile_lane(t);
    const int pad = a & 15;
    const int nch = (pad + tile_n(t) + 15) >> 4;
    const uint8_t* from = sbuf + (size_t)w0 * npad + (a - pad);
    const unsigned m = 0xffffffffu / static_cast<unsigned>(nch) + 1u;
    const int items = gw * nch;
    for (int k = threadIdx.x; k < items; k += kThreads) {
      const int q = div_magic(k, m);
      const int c = k - q * nch;
      cp_async16(to + (size_t)q * S + 16 * c,
                 from + (size_t)q * npad + 16 * c);
    }
    cp_async_commit();
  };
  __syncthreads();                   // sh.tbl

  // two reads: units (tile, plane group) in order through a ring of up to
  // three slots; the first units' copies start now and land during the
  // count and the grid barrier
  const int depth = min(slots, 3);
  const int units = (t1 - t0) * ngroups;
  auto stage_unit = [&](int k) {
    const int t = t0 + k / ngroups, g = k % ngroups;
    stage(slot(k % depth), t, g * group, min(group, W - g * group));
  };
  if (!resident) {
    for (int k = 0; k < depth - 1 && k < units; ++k) stage_unit(k);
  }

  // ---- 1. count
  int left = 0;
  if (resident) {
    for (int t = t0; t < t1; ++t) stage(slot(t - t0), t, 0, W);
    cp_async_wait_all();
    __syncthreads();
    for (int t = t0; t < t1; ++t) {
      left += count_left(slot(t - t0) + (size_t)feat * S + (tile_lane(t) & 15),
                         tile_n(t), sh.tbl);
    }
  } else if (t0 < t1) {              // the block's tiles are one run
    left = count_left_dev(sbuf + (size_t)feat * npad + tile_lane(t0),
                          min(cnt, t1 * T) - t0 * T, sh.tbl);
  }
  left = block_sum(left, sh.red);
  if (threadIdx.x == 0) block_left[blockIdx.x] = left;
  cg::this_grid().sync();

  // ---- 2. offsets
  int before = 0, total = 0;
  for (int b = threadIdx.x; b < G; b += kThreads) {
    const int v = __ldcg(block_left + b);
    total += v;
    if (b < (int)blockIdx.x) before += v;
  }
  before = block_sum(before, sh.red);
  total = block_sum(total, sh.red);
  if (blockIdx.x == 0 && threadIdx.x == 0) *lt_out = total;

  // ---- 3. scatter
  long long left_at = (long long)start + before;
  long long right_at = (long long)start + total + ((long long)t0 * T - before);
  if (resident) {
    for (int t = t0; t < t1; ++t) {
      const int n = tile_n(t);
      const uint8_t* st = slot(t - t0) + (tile_lane(t) & 15);
      const int nl = rank_tile(st + (size_t)feat * S, n, left_at & 3,
                               right_at & 3, sh);
      copy_tile(st, S, 0, W, n, nl, left_at, right_at, dbuf, npad, sh);
      __syncthreads();               // sh.idx is free for the next tile
      left_at += nl;
      right_at += n - nl;
    }
    return;
  }
  // two reads: the next two units' copies in flight while one is written;
  // a tile's ranks come from its staged split column when a slot holds
  // every plane, else from device memory
  int nl = 0;
  for (int k = 0; k < units; ++k) {
    const int t = t0 + k / ngroups, g = k % ngroups;
    if (k + depth - 1 < units) stage_unit(k + depth - 1);  // a freed slot
    cp_async_wait_upto(min(depth - 1, units - 1 - k));     // unit k landed
    __syncthreads();
    const int n = tile_n(t);
    const uint8_t* st = slot(k % depth) + (tile_lane(t) & 15);
    if (g == 0) {
      nl = rank_tile(ngroups == 1
                         ? st + (size_t)feat * S
                         : sbuf + (size_t)feat * npad + tile_lane(t),
                     n, left_at & 3, right_at & 3, sh);
    }
    const int w0 = g * group;
    copy_tile(st, S, w0, min(group, W - w0), n, nl, left_at, right_at, dbuf,
              npad, sh);
    __syncthreads();                 // the slot and sh.idx are free
    if (g == ngroups - 1) {
      left_at += nl;
      right_at += n - nl;
    }
  }
}

// The most blocks of `smem` dynamic bytes the card runs at once (the
// cooperative grid's ceiling), from a small per-thread cache: a run's
// splits use a handful of slot sizes. The first query on a device also
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
      reinterpret_cast<const void*>(partition_planes_kernel), raised);
  if (e != cudaSuccess) return e;
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, partition_planes_kernel, kThreads, smem);
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

// Planes layout: work is (2, W, npad), npad a multiple of 16. steps
// (32-row steps per tile), group (planes per slot), slots (slots of shared
// memory per block) and grid come from ops/partition.partition_planes_plan;
// the grid is cut to what the card runs at once. block_left holds at least
// `grid` ints, lt one. mode (segment_arg.cuh) says what seg holds: the
// segment [src, start, cnt, feat], or a split's header. The launch is
// cudaLaunchKernelEx with the cooperative attribute, which stream capture
// records as a cooperative node of a CUDA graph.
int partition_segment(void* work, int W, int npad, const void* seg,
                      const void* table, int nbins, int steps, int group,
                      int slots, int grid, int mode, void* block_left,
                      void* lt, void* stream) {
  if (W < 1 || npad % 16 || steps < 1 || steps > kMaxSteps || group < 1 ||
      group > W || slots < 1 || grid < 1 || nbins < 1 || nbins > 256 ||
      !lgbt_seg::seg_mode_ok(mode) || mode == lgbt_seg::kSegSmaller) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t slot_bytes = (size_t)group * (32 * steps + kStripePad);
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
  e = cudaLaunchKernelEx(&cfg, partition_planes_kernel,
                         static_cast<uint8_t*>(work), W, npad,
                         static_cast<const int*>(seg),
                         static_cast<const uint8_t*>(table), nbins, steps,
                         group, slots, mode, static_cast<int*>(block_left),
                         static_cast<int*>(lt));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
