// Device code of the resident layout (tpu_resident_state=on), shared by
// csrc/resident_route.cu (the route gather), csrc/segment_hist.cuh (the
// gather histogram) and csrc/one_kernel_split.cu (its resident mode).
//
// The bins stay put, once, in the resident planes: (F, npad_res) u8, bin f
// of original row i at f * npad_res + i (the row router's block form of
// the binned matrix). The partition permutes only the slim work pair
// (2, 17, npad), whose byte planes hold per row: plane 0 the route byte
// (the split column's bin, gathered before each partition), planes 1..4
// the row's index into the resident planes (ridx, little-endian bytes),
// planes 5..16 g, h, cnt as little-endian f32 bytes (ops/partition.py
// RST_*).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lgbt_res {

constexpr int kRoute = 0;    // plane of the route byte
constexpr int kRidx = 1;     // first of the 4 ridx planes
constexpr int kGhOff = 5;    // first of the 12 g/h/cnt planes
constexpr int kWidth = 17;

// The ridx of lane `lane` of one slim buffer `pl` (npad lanes per plane),
// clamped to [0, npad_res) as the JAX package's _decode_ridx clamps it.
// Callers decode only lanes of a live segment, whose bytes the pack or a
// partition wrote; the clamp keeps any other gather in bounds.
__device__ __forceinline__ int ridx_at(const uint8_t* pl, int npad,
                                       long lane, int npad_res) {
  const uint32_t b0 = pl[(size_t)kRidx * npad + lane];
  const uint32_t b1 = pl[(size_t)(kRidx + 1) * npad + lane];
  const uint32_t b2 = pl[(size_t)(kRidx + 2) * npad + lane];
  const uint32_t b3 = pl[(size_t)(kRidx + 3) * npad + lane];
  const int r = (int)(b0 | (b1 << 8) | (b2 << 16) | (b3 << 24));
  return min(max(r, 0), npad_res - 1);
}

// Route gather over rows [first, min(last, cnt)) of the segment starting
// at lane `start` of slim buffer `pl`: plane 0 of each row gets bin
// res[feat][ridx]; no other byte is written. The planes are read and
// written as aligned 4-lane words: thread t of `threads` takes words
// t + k * threads, k < kWords, of the range, then moves on by kWords *
// threads. A round loads its words of the 4 ridx planes, then every
// row's bin, then stores: its loads are in flight together (a store
// between two loads through `pl` would order them), so a sparse gather
// waits about two load latencies per round. A word whose 4 lanes are all
// rows of the range is stored whole; the ragged words at the ends of the
// range are stored byte by byte, their other lanes untouched.
template <int kWords>
__device__ __forceinline__ void route_gather(uint8_t* pl, int npad,
                                             int start, int cnt,
                                             const uint8_t* res,
                                             int npad_res, int feat,
                                             long first, long last, long t,
                                             long threads) {
  const uint8_t* col = res + (size_t)feat * npad_res;
  const long end = last < cnt ? last : cnt;
  if (first >= end) return;
  const long lo = start + first, hi = start + end;     // lanes [lo, hi)
  const long w_end = (hi + 3) >> 2;                    // words [lo/4, w_end)
  const size_t pw = (size_t)npad >> 2;                 // words per plane
  const uint32_t* ridx = reinterpret_cast<const uint32_t*>(pl) + kRidx * pw;
  uint32_t* route = reinterpret_cast<uint32_t*>(pl) + kRoute * pw;
  for (long w0 = (lo >> 2) + t; w0 < w_end; w0 += kWords * threads) {
    uint32_t rb[kWords][4];
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const long w = w0 + k * threads;
#pragma unroll
      for (int p = 0; p < 4; ++p) rb[k][p] = w < w_end ? ridx[p * pw + w] : 0;
    }
    uint32_t v[kWords];
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const long w = w0 + k * threads;
      v[k] = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long lane = 4 * w + j;
        if (w < w_end && lane >= lo && lane < hi) {
          const int sh = 8 * j;
          const int r = (int)(((rb[k][0] >> sh) & 255u) |
                              (((rb[k][1] >> sh) & 255u) << 8) |
                              (((rb[k][2] >> sh) & 255u) << 16) |
                              (((rb[k][3] >> sh) & 255u) << 24));
          v[k] |= (uint32_t)col[min(max(r, 0), npad_res - 1)] << sh;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const long w = w0 + k * threads;
      if (w >= w_end) continue;
      if (4 * w >= lo && 4 * w + 4 <= hi) {
        route[w] = v[k];
        continue;
      }
      uint8_t* bytes = reinterpret_cast<uint8_t*>(route + w);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long lane = 4 * w + j;
        if (lane >= lo && lane < hi) bytes[j] = (uint8_t)(v[k] >> (8 * j));
      }
    }
  }
}

}  // namespace lgbt_res
