// Device code of the stable two-way segment partition (K3), shared by
// csrc/partition_segment.cu (the three-launch path) and phase A of
// csrc/one_kernel_split.cu, so that both route the same bytes in the same
// order. See partition_segment.cu for the data contract and the design.
//
// A tile is kPartTile = 4096 rows handled by one 256-thread block: each of
// its 8 warps owns 16 consecutive 32-row steps. part_count_tile counts the
// tile's go-left rows; part_scatter_tile writes the tile's rows to the
// destination buffer given the number of left rows before the tile.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lgbt_part {

constexpr int kPartThreads = 256;
constexpr int kPartWarps = kPartThreads / 32;
constexpr int kPartSteps = 16;                              // steps per warp
constexpr int kPartTile = kPartWarps * kPartSteps * 32;     // 4096 rows
constexpr unsigned kPartFull = 0xffffffffu;

// Byte `feat` of row `row` of one buffer: planes hold byte w of row i at
// w * npad + i, rows at i * W + w.
template <bool kRows>
__device__ __forceinline__ uint8_t bin_at(const uint8_t* buf, int W, int npad,
                                          int feat, long row) {
  return kRows ? buf[row * W + feat] : buf[(size_t)feat * npad + row];
}

template <bool kRows>
__device__ __forceinline__ bool goes_left(const uint8_t* buf, int W, int npad,
                                          int feat, long row,
                                          const uint8_t* tbl) {
  return tbl[bin_at<kRows>(buf, W, npad, feat, row)] != 0;
}

// The (B,) table into shared memory; bins past B route right.
__device__ __forceinline__ void load_table(uint8_t* s_tbl,
                                           const uint8_t* table, int nbins) {
  for (int b = threadIdx.x; b < 256; b += blockDim.x) {
    s_tbl[b] = b < nbins ? table[b] : 0;
  }
  __syncthreads();
}

// Go-left rows of tile `tile` of the segment [start, start + cnt) of
// `buf`; the total is returned to thread 0 (other threads get 0).
template <bool kRows>
__device__ __forceinline__ int part_count_tile(const uint8_t* buf, int W,
                                               int npad, int start, int cnt,
                                               int feat, const uint8_t* s_tbl,
                                               long tile, int* s_warp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long base = tile * kPartTile + warp * (kPartSteps * 32);
  int n = 0;
  for (int s = 0; s < kPartSteps; ++s) {
    const long i = base + s * 32 + lane;
    const bool g = i < cnt &&
                   goes_left<kRows>(buf, W, npad, feat, start + i, s_tbl);
    n += __popc(__ballot_sync(kPartFull, g));
  }
  __syncthreads();     // s_warp is free: a previous tile's readers are done
  if (lane == 0) s_warp[warp] = n;
  __syncthreads();
  int t = 0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kPartWarps; ++w) t += s_warp[w];
  }
  return t;
}

// Rows of tile `tile` from srcp to dstp: a left row goes to start + (left
// rows before it), a right row to start + lt + (right rows before it).
// `left_before_tile` is the segment's go-left count in the tiles before
// this one. Each warp recomputes its ballots (kept in registers) and ranks
// each row by popc of the ballot below it. On the planes layout the copy
// reads aligned 4-row words (npad is a multiple of 4), 4 planes per round
// with all loads of a round before its stores, so that a round waits about
// one load latency (a store between two loads through srcp would order
// them) and each load brings 4 rows. No __restrict__ on srcp: the resident
// mode of one_kernel_split.cu writes its route plane earlier in the same
// launch, which the read-only (non-coherent) load path must not serve.
template <bool kRows>
__device__ __forceinline__ void part_scatter_tile(
    const uint8_t* srcp, uint8_t* __restrict__ dstp, int W,
    int npad, int start, int cnt, int feat, int lt, const uint8_t* s_tbl,
    long tile, int left_before_tile, int* s_warp) {
  constexpr int kCopyPlanes = 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long base = tile * kPartTile + warp * (kPartSteps * 32);
  unsigned masks[kPartSteps];
  int n = 0;
#pragma unroll
  for (int s = 0; s < kPartSteps; ++s) {
    const long i = base + s * 32 + lane;
    const bool g = i < cnt &&
                   goes_left<kRows>(srcp, W, npad, feat, start + i, s_tbl);
    masks[s] = __ballot_sync(kPartFull, g);
    n += __popc(masks[s]);
  }
  __syncthreads();     // s_warp is free: a previous tile's readers are done
  if (lane == 0) s_warp[warp] = n;
  __syncthreads();
  int left_before = left_before_tile;
  for (int w = 0; w < warp; ++w) left_before += s_warp[w];
  const unsigned below = (1u << lane) - 1u;
  if (kRows) {
#pragma unroll
    for (int s = 0; s < kPartSteps; ++s) {
      const long i = base + s * 32 + lane;
      const unsigned m = masks[s];
      const int lb = left_before + __popc(m & below);   // left rows before i
      long long dst = -1;                               // -1: past the end
      if (i < cnt) {
        dst = ((m >> lane) & 1u) ? (long long)start + lb
                                 : (long long)start + lt + (i - lb);
      }
      if (base + s * 32 < cnt) {   // warp-uniform test
        // the warp's 32 source rows are one run of 32 * W bytes
        const uint8_t* run = srcp + (size_t)(start + base + s * 32) * W;
        for (int k = lane; k < 32 * W; k += 32) {
          const int r = k / W;
          const long long d = __shfl_sync(kPartFull, dst, r);
          if (d >= 0) dstp[(size_t)d * W + (k - r * W)] = run[k];
        }
      }
      left_before += __popc(m);
    }
    return;
  }
  int dsts[kPartSteps];   // destination row - start, -1: past the segment
#pragma unroll
  for (int s = 0; s < kPartSteps; ++s) {
    const long i = base + s * 32 + lane;
    const unsigned m = masks[s];
    const int lb = left_before + __popc(m & below);   // left rows before i
    dsts[s] = -1;
    if (i < cnt) dsts[s] = ((m >> lane) & 1u) ? lb : (int)(lt + (i - lb));
    left_before += __popc(m);
  }
  // planes: the warp's 512 destinations go to shared memory; each lane
  // then copies aligned 4-row words of the source planes (the warp's rows
  // span at most kSpanWords words of a plane), kCopyPlanes planes per
  // round, all loads of a round before its stores, and stores each live
  // byte at its row's destination.
  constexpr int kSpanRows = kPartSteps * 32;
  constexpr int kSpanWords = kSpanRows / 4 + 1;
  constexpr int kLaneWords = (kSpanWords + 31) / 32;
  __shared__ int s_dst[kPartThreads * kPartSteps];
  int* wd = s_dst + warp * kSpanRows;
#pragma unroll
  for (int s = 0; s < kPartSteps; ++s) wd[s * 32 + lane] = dsts[s];
  __syncwarp();
  const long span0 = (long)start + base;      // lane of the warp's row 0
  const long w_lo = span0 >> 2;
  int d[kLaneWords][4];
  bool live[kLaneWords];
#pragma unroll
  for (int i = 0; i < kLaneWords; ++i) {
    live[i] = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long idx = 4 * (w_lo + lane + 32 * i) + j - span0;
      d[i][j] = (lane + 32 * i < kSpanWords && idx >= 0 && idx < kSpanRows)
                    ? wd[idx] : -1;
      live[i] = live[i] || d[i][j] >= 0;
    }
  }
  const uint32_t* src32 = reinterpret_cast<const uint32_t*>(srcp);
  const size_t pw = (size_t)npad >> 2;
  for (int w0 = 0; w0 < W; w0 += kCopyPlanes) {
    uint32_t v[kCopyPlanes][kLaneWords];
#pragma unroll
    for (int k = 0; k < kCopyPlanes; ++k) {
#pragma unroll
      for (int i = 0; i < kLaneWords; ++i) {
        if (w0 + k < W && live[i]) {
          v[k][i] = src32[(size_t)(w0 + k) * pw + w_lo + lane + 32 * i];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kCopyPlanes; ++k) {
      if (w0 + k >= W) break;
      uint8_t* to = dstp + (size_t)(w0 + k) * npad + start;
#pragma unroll
      for (int i = 0; i < kLaneWords; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (d[i][j] >= 0) to[d[i][j]] = (uint8_t)(v[k][i] >> (8 * j));
        }
      }
    }
  }
  __syncwarp();      // wd is free for the warp's next tile
}

}  // namespace lgbt_part
