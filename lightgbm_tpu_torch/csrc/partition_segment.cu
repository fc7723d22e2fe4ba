// Stable two-way partition of one leaf's segment of the work buffer, for
// Hopper (sm_90a), on both work layouts.
//
// Replaces the TPU kernels lightgbm_tpu/ops/partition.py:
// partition_segment_planes_fused (pallas_call "partition_segment_planes_fused",
// body _partition_planes_kernel; entry point partition_segment) and
// partition_segment_fused (pallas_call "partition_segment_fused", body
// _partition_kernel; entry point partition_segment_rows). Same data
// contract: work is a ping-pong pair of packed rows, each row W bytes (F bin
// bytes, then g/h/cnt as 12 f32 bytes, or int8 g, int8 h, u8 cnt when
// quantized), laid out as (2, W, Npad) byte planes (planes) or (2, Npad, W)
// rows (rows); the segment is rows [start, start + cnt) of buffer src; rows
// whose split-column bin b has table[b] set in the (B,) bool routing table
// go left (the TPU kernels bit-pack the table into 8 scalar words for their
// scalar prefetch; here the 256 bytes sit in shared memory). Rows are
// written into buffer 1 - src, left rows first; rows outside the segment
// are not touched; lt (the left count) is written to a device int. Unlike
// the TPU kernels the order is fixed: stable on both sides (left rows
// ascending from start, right rows ascending from start + lt), so the
// result equals the plain twin byte for byte, and the two layouts hold the
// same rows in the same order.
//
// What bounds it on this card: bytes. Each row is read once (W bytes, plus
// the split column once more for the count) and written once (W bytes): 80 B
// per row at W = 40, 160 MB for the 2M-row root split, ~0.05 ms at 3.35 TB/s;
// 62 B per row quantized (W = 31). There is no arithmetic to speak of.
//
// Design: three launches on one stream, no atomics on positions, so the
// result is deterministic.
//   1. count: one block per 4096-row tile; each warp ballots the go-left
//      bits of its 512 rows, 32 at a time; the block's left count goes to
//      scratch[block].
//   2. scan: one block turns the per-tile counts into exclusive offsets and
//      writes lt (the total).
//   3. scatter: each block recomputes its warps' ballots (kept in
//      registers) and ranks each row by popc of the ballot below it.
//      Planes: each lane copies its row's W bytes plane by plane; a warp
//      reads 32 consecutive bytes of a plane per step and writes its left
//      lanes, and its right lanes, to consecutive bytes. Rows: the warp's
//      32 source rows are 32 * W consecutive bytes; lane l copies bytes l,
//      l + 32, ... of that span to their row's destination (fetched from
//      the owning lane by a shuffle), so reads are coalesced and writes
//      land in the two runs of consecutive destination rows.
// start, cnt, feat and src are read from a device array, so the host never
// waits on the card to launch; the grid is sized by a host upper bound of
// cnt and tiles past the segment do nothing. The per-tile count and scatter
// live in segment_partition.cuh, which phase A of one_kernel_split.cu runs
// too.
#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_partition.cuh"

namespace {

using namespace lgbt_part;

template <bool kRows>
__global__ void __launch_bounds__(kPartThreads)
count_kernel(const uint8_t* __restrict__ work, int W, int npad,
             const int* __restrict__ seg, const uint8_t* __restrict__ table,
             int nbins, int* __restrict__ counts) {
  __shared__ uint8_t s_tbl[256];
  __shared__ int s_warp[kPartWarps];
  load_table(s_tbl, table, nbins);
  const int src = seg[0], start = seg[1], cnt = seg[2], feat = seg[3];
  const uint8_t* buf = work + (size_t)src * W * npad;
  const int t = part_count_tile<kRows>(buf, W, npad, start, cnt, feat, s_tbl,
                                       blockIdx.x, s_warp);
  if (threadIdx.x == 0) counts[blockIdx.x] = t;
}

// In-place exclusive scan of the per-tile counts; *lt = their total.
__global__ void __launch_bounds__(1024)
scan_kernel(int* __restrict__ counts, int nblocks, int* __restrict__ lt) {
  __shared__ int s[1024];
  int carry = 0;
  for (int base = 0; base < nblocks; base += 1024) {
    const int i = base + threadIdx.x;
    const int v = i < nblocks ? counts[i] : 0;
    s[threadIdx.x] = v;
    __syncthreads();
    for (int o = 1; o < 1024; o <<= 1) {
      const int t = threadIdx.x >= o ? s[threadIdx.x - o] : 0;
      __syncthreads();
      s[threadIdx.x] += t;
      __syncthreads();
    }
    if (i < nblocks) counts[i] = carry + s[threadIdx.x] - v;
    carry += s[1023];
    __syncthreads();
  }
  if (threadIdx.x == 0) *lt = carry;
}

// planes: at most 128 registers, two blocks per SM (the copy's word
// buffers would take more); rows: at most 64, four blocks per SM, so the
// 489 tiles of a 2M-row root run in one wave
template <bool kRows>
__global__ void __launch_bounds__(kPartThreads, kRows ? 4 : 2)
scatter_kernel(uint8_t* __restrict__ work, int W, int npad,
               const int* __restrict__ seg, const uint8_t* __restrict__ table,
               int nbins, const int* __restrict__ offsets,
               const int* __restrict__ lt_p) {
  __shared__ uint8_t s_tbl[256];
  __shared__ int s_warp[kPartWarps];
  load_table(s_tbl, table, nbins);
  const int src = seg[0], start = seg[1], cnt = seg[2], feat = seg[3];
  const uint8_t* srcp = work + (size_t)src * W * npad;
  uint8_t* dstp = work + (size_t)(1 - src) * W * npad;
  part_scatter_tile<kRows>(srcp, dstp, W, npad, start, cnt, feat, *lt_p,
                           s_tbl, blockIdx.x, offsets[blockIdx.x], s_warp);
}

template <bool kRows>
int launch_partition(void* work, int W, int npad, const void* seg,
                     const void* table, int nbins, void* scratch, void* lt,
                     int nblocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* w = static_cast<uint8_t*>(work);
  const int* sg = static_cast<const int*>(seg);
  const uint8_t* tb = static_cast<const uint8_t*>(table);
  int* counts = static_cast<int*>(scratch);
  int* ltp = static_cast<int*>(lt);
  count_kernel<kRows><<<nblocks, kPartThreads, 0, s>>>(w, W, npad, sg, tb,
                                                       nbins, counts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  scan_kernel<<<1, 1024, 0, s>>>(counts, nblocks, ltp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  scatter_kernel<kRows><<<nblocks, kPartThreads, 0, s>>>(
      w, W, npad, sg, tb, nbins, counts, ltp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Planes layout: work is (2, W, npad).
int partition_segment(void* work, int W, int npad, const void* seg,
                      const void* table, int nbins, void* scratch, void* lt,
                      int nblocks, void* stream) {
  return launch_partition<false>(work, W, npad, seg, table, nbins, scratch,
                                 lt, nblocks, stream);
}

// Rows layout: work is (2, npad, W).
int partition_segment_rows(void* work, int W, int npad, const void* seg,
                           const void* table, int nbins, void* scratch,
                           void* lt, int nblocks, void* stream) {
  return launch_partition<true>(work, W, npad, seg, table, nbins, scratch,
                                lt, nblocks, stream);
}

}  // extern "C"
