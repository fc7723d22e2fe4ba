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
// res[feat][ridx]. Thread t of `threads` takes rows first + t + k *
// threads, k < kBatch, then moves on by kBatch * threads. A batch loads
// every row's ridx, then every bin, then stores: its loads are in flight
// together (a store between two loads through `pl` would order them), so
// a sparse gather waits about two load latencies per batch, not two per
// row.
template <int kBatch>
__device__ __forceinline__ void route_gather(uint8_t* pl, int npad,
                                             int start, int cnt,
                                             const uint8_t* res,
                                             int npad_res, int feat,
                                             long first, long last, long t,
                                             long threads) {
  const uint8_t* col = res + (size_t)feat * npad_res;
  const long end = last < cnt ? last : cnt;
  for (long i0 = first + t; i0 < end; i0 += kBatch * threads) {
    int r[kBatch];
    uint8_t v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const long i = i0 + k * threads;
      r[k] = i < end ? ridx_at(pl, npad, start + i, npad_res) : -1;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) v[k] = r[k] >= 0 ? col[r[k]] : 0;
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const long i = i0 + k * threads;
      if (i < end) pl[(size_t)kRoute * npad + start + i] = v[k];
    }
  }
}

}  // namespace lgbt_res
