// Device code of the f32 segment histogram (K4), shared by
// csrc/segment_histogram.cu (the three-launch path: planes, rows and
// resident entry points) and phase B of csrc/one_kernel_split.cu, so that
// all of them sum the same values in the same order and give the same
// bits. See segment_histogram.cu for the data contract and the design.
//
// The summation order depends on the segment's rows alone (never on the
// grid, on a host row bound or on how features are grouped):
//   - the segment is cut into chunks of kHistChunk = 2048 rows, chunk k
//     holding rows [k * 2048, (k + 1) * 2048) of the segment;
//   - a chunk's rows are cut into 32-row steps; slice s (of kHistSlices =
//     4) holds the steps q with q % 4 == s;
//   - per (chunk, slice, feature) a histogram starts at zero and adds the
//     slice's rows one by one in row order (rows of one step that share a
//     bin are found with warp ballots and added by the lowest such lane in
//     lane order, their values pulled by warp shuffle);
//   - a chunk's partial is slice 0 + slice 1 + slice 2 + slice 3, left to
//     right; the segment's sum is 0 + partial 0 + partial 1 + ..., in chunk
//     order; in exact mode hi + lo at the end.
// tests/torch_port_cases.py hist_order_np emulates this order in numpy;
// ops/histogram.sum_error_bound bounds its error.
//
// hist_chunk is one work item: one chunk x one group of up to kHistFeats
// features (4 in K4's 512-thread blocks, 2 in the one-kernel split's
// 256-thread ones). Its (feature, slice) histograms are private copies in
// shared memory, one per (feature, slice) pair, each owned by one warp, so
// every warp of the block works on its own rows. The chunk is staged
// through shared memory in tiles of kHistTile rows: the next tile's bytes
// are in flight while the warps count the current one (planes: cp.async
// into a second staging buffer; rows and resident: each thread's rows
// loaded into registers). The tile size is not part of the summation
// order. hist_sum sums a (feature, bin, channel)'s chunk partials in chunk
// order.
//
// Where a row's bytes are is a layout policy: PackedRows<false> (planes),
// PackedRows<true> (rows), ResidentRows (the slim pair plus the resident
// bin planes, csrc/resident.cuh); each loads one row's RowRaw.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "resident.cuh"

namespace lgbt_hist {

constexpr int kHistChunk = 2048;      // rows per chunk (one partial each)
constexpr int kHistSlices = 4;        // slices per chunk
constexpr int kHistTile = 512;        // rows staged in shared memory at once
constexpr int kStageBytes = kHistTile + 16;   // a plane's window of a tile
constexpr int kHistFeats = 4;         // the most features of a work item
constexpr unsigned kHistFull = 0xffffffffu;
static_assert(kHistChunk % kHistTile == 0, "a chunk is whole tiles");
static_assert(kHistTile % (32 * kHistSlices) == 0,
              "a tile holds whole rounds of the slices' steps");

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One row's bytes: the g, h, cnt words and the bins of the item's features
// (byte k of `bins` is feature f0 + k).
struct RowRaw {
  uint32_t g, h, c, bins;
};

// The little-endian word at bytes w .. w + 3 of row `row`.
template <class L>
__device__ __forceinline__ uint32_t word_at(const L& lay, int w, long row) {
  const uint32_t b0 = lay.byte_at(w, row);
  const uint32_t b1 = lay.byte_at(w + 1, row);
  const uint32_t b2 = lay.byte_at(w + 2, row);
  const uint32_t b3 = lay.byte_at(w + 3, row);
  return b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Planes (kRows false) hold byte w of row `row` at w * npad + row, rows
// at row * W + w: the F bin bytes, then g, h, cnt at bytes F .. F + 11.
// The planes layout stages a tile with cp.async (kAsync): each of the
// item's nf bin planes and the 12 channel planes is one run of bytes, so
// the 16-byte-aligned window around the tile's rows is copied to shared
// memory in 16-byte pieces while the warps count the previous tile, and
// rows are then decoded from there.
template <bool kRows>
struct PackedRows {
  const uint8_t* buf;
  int W, npad, F;
  static constexpr bool kAsync = !kRows;
  // staged plane p of the tile: the item's bins (p < nf), then the
  // channel bytes (p = nf + c, byte c of g, h, cnt)
  __device__ __forceinline__ const uint8_t* plane(int p, int f0,
                                                  int nf) const {
    return buf + (size_t)(p < nf ? f0 + p : F + p - nf) * npad;
  }
  // cp.async of lanes [lane0, lane0 + rows) of the nf + 12 planes into
  // raw (plane p at p * kStageBytes, lane0 & ~15 at its byte 0). The
  // window stays inside the planes: a segment has guard lanes around it.
  template <int kThreads>
  __device__ __forceinline__ void stage(long lane0, int rows, int f0, int nf,
                                        uint8_t* raw) const {
    const long lo = lane0 & ~15L;
    const int nvec = (int)((((lane0 + rows + 15) & ~15L) - lo) >> 4);
    for (int i = threadIdx.x; i < (nf + 12) * nvec; i += kThreads) {
      const int p = i / nvec, v = i - p * nvec;
      cp_async16(raw + p * kStageBytes + v * 16, plane(p, f0, nf) + lo + v * 16);
    }
  }
  __device__ __forceinline__ uint32_t byte_at(int w, long row) const {
    return kRows ? buf[row * W + w] : buf[(size_t)w * npad + row];
  }
  __device__ __forceinline__ RowRaw load(long row, int f0, int nf) const {
    RowRaw r;
    r.g = word_at(*this, F, row);
    r.h = word_at(*this, F + 4, row);
    r.c = word_at(*this, F + 8, row);
    r.bins = 0;
#pragma unroll
    for (int k = 0; k < kHistFeats; ++k) {
      if (k < nf) r.bins |= byte_at(f0 + k, row) << (8 * k);
    }
    return r;
  }
};

// The slim pair's buffer `buf` (npad lanes per plane) holds g, h, cnt at
// planes 5 .. 16; bin f of a row is res[f * npad_res + ridx].
struct ResidentRows {
  const uint8_t* buf;
  int npad;
  const uint8_t* res;
  int npad_res;
  static constexpr bool kAsync = false;
  __device__ __forceinline__ uint32_t byte_at(int w, long row) const {
    return buf[(size_t)w * npad + row];
  }
  __device__ __forceinline__ RowRaw load(long row, int f0, int nf) const {
    RowRaw r;
    const int x = lgbt_res::ridx_at(buf, npad, row, npad_res);
    r.g = word_at(*this, lgbt_res::kGhOff, row);
    r.h = word_at(*this, lgbt_res::kGhOff + 4, row);
    r.c = word_at(*this, lgbt_res::kGhOff + 8, row);
    r.bins = 0;
#pragma unroll
    for (int k = 0; k < kHistFeats; ++k) {
      if (k < nf) {
        r.bins |= (uint32_t)res[(size_t)(f0 + k) * npad_res + x] << (8 * k);
      }
    }
    return r;
  }
};

// Chunks of a segment of cnt rows.
__host__ __device__ __forceinline__ int hist_chunks(int cnt) {
  return (cnt + kHistChunk - 1) / kHistChunk;
}

// Shared memory of a work item of up to `feats` features, in bytes: the
// private histograms (feats x kHistSlices, B, NCH) f32, the tile's
// channels (NCH, kHistTile) f32, its bins (feats, kHistTile) u8 and the
// planes layout's two staging buffers (feats + 12 planes of kStageBytes).
__host__ __device__ __forceinline__ int hist_smem_bytes(int B, int nch,
                                                        int feats) {
  return (feats * kHistSlices * B * nch + nch * kHistTile) * 4 +
         feats * kHistTile + 2 * (feats + 12) * kStageBytes;
}

// The tile's rows [0, rows) into registers: thread t takes rows
// t, t + kThreads, ...
template <int kThreads, class L>
__device__ __forceinline__ void load_tile(const L& lay, long base, int rows,
                                          int f0, int nf,
                                          RowRaw (&raw)[kHistTile / kThreads]) {
#pragma unroll
  for (int i = 0; i < kHistTile / kThreads; ++i) {
    const int r = i * kThreads + threadIdx.x;
    if (r < rows) raw[i] = lay.load(base + r, f0, nf);
  }
}

// Tile row r's per-row contributions (bf16-rounded channels) and its
// kFeats features' bins into shared memory.
template <int kNch, int kFeats>
__device__ __forceinline__ void store_row(const RowRaw& x, int r,
                                          float* s_ch, uint8_t* s_bin) {
  const float g = __uint_as_float(x.g);
  const float h = __uint_as_float(x.h);
  const float c = __uint_as_float(x.c);
  if (kNch == 5) {
    const float g_hi = bf(g), h_hi = bf(h);
    s_ch[r] = g_hi;
    s_ch[kHistTile + r] = bf(g - g_hi);
    s_ch[2 * kHistTile + r] = h_hi;
    s_ch[3 * kHistTile + r] = bf(h - h_hi);
    s_ch[4 * kHistTile + r] = bf(c);
  } else {
    s_ch[r] = bf(g);
    s_ch[kHistTile + r] = bf(h);
    s_ch[2 * kHistTile + r] = bf(c);
  }
#pragma unroll
  for (int k = 0; k < kFeats; ++k) {
    s_bin[k * kHistTile + r] = (uint8_t)(x.bins >> (8 * k));
  }
}

// The registers' rows decoded into the tile's channels and bins.
template <int kNch, int kThreads, int kFeats>
__device__ __forceinline__ void store_tile(
    const RowRaw (&raw)[kHistTile / kThreads], int rows, float* s_ch,
    uint8_t* s_bin) {
#pragma unroll
  for (int i = 0; i < kHistTile / kThreads; ++i) {
    const int r = i * kThreads + threadIdx.x;
    if (r < rows) store_row<kNch, kFeats>(raw[i], r, s_ch, s_bin);
  }
}

// The lanes of the warp whose valid bin equals this lane's (a u8 bin):
// what __match_any_sync(b) gives among valid lanes, from 8 ballots, one
// per bit of the bin. match.any's cost grows with the distinct values
// among the lanes (~30 on a continuous feature's 32 rows); the ballots'
// does not.
__device__ __forceinline__ unsigned peers_by_bin(int b, bool valid) {
  unsigned peers = __ballot_sync(kHistFull, valid);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool bit = (b >> i) & 1;
    const unsigned ones = __ballot_sync(kHistFull, bit);
    peers &= bit ? ones : ~ones;
  }
  return peers;
}

// The staged tile (PackedRows<false>::stage, first lane lane0) decoded
// into the tile's channels and its kFeats features' bins, thread per row.
template <int kNch, int kThreads, int kFeats>
__device__ __forceinline__ void decode_staged(const uint8_t* raw, long lane0,
                                              int rows, int nf, float* s_ch,
                                              uint8_t* s_bin) {
  const int o0 = (int)(lane0 & 15);
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const uint8_t* b = raw + o0 + r;
    uint32_t w[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const uint8_t* p = b + (nf + 4 * c) * kStageBytes;
      w[c] = (uint32_t)p[0] | ((uint32_t)p[kStageBytes] << 8) |
             ((uint32_t)p[2 * kStageBytes] << 16) |
             ((uint32_t)p[3 * kStageBytes] << 24);
    }
    RowRaw x;
    x.g = w[0];
    x.h = w[1];
    x.c = w[2];
    x.bins = 0;
#pragma unroll
    for (int k = 0; k < kFeats; ++k) {
      if (k < nf) x.bins |= (uint32_t)b[k * kStageBytes] << (8 * k);
    }
    store_row<kNch, kFeats>(x, r, s_ch, s_bin);
  }
}

// Warp `warp` of kWarps counts its (feature, slice) pairs' steps of a tile
// of `rows` rows. Rows whose bin is >= B add nothing. Per 32-row step
// every lane loads its own row's channels; peers_by_bin groups the lanes
// by bin; the group's lowest lane (the leader) reads the bin's sums
// and adds its group's rows in lane order, pulling each peer's values by
// warp shuffle: all lanes stay converged, one shuffle round per rank up to
// the step's largest group, so a bin that many rows share costs one round
// per row, not a shared-memory load per row.
template <int kNch, int kWarps>
__device__ __forceinline__ void count_tile(int rows, int nf, int B,
                                           const float* s_ch,
                                           const uint8_t* s_bin,
                                           float* s_hist) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int steps = (rows + 31) >> 5;
  for (int p = warp; p < nf * kHistSlices; p += kWarps) {
    const int fl = p / kHistSlices;
    float* h = s_hist + (size_t)p * B * kNch;
    const uint8_t* bins = s_bin + fl * kHistTile;
    for (int q = p % kHistSlices; q < steps; q += kHistSlices) {
      const int r = q * 32 + lane;     // < kHistTile: r's channels exist
      const int b = r < rows ? (int)bins[r] : B;
      const bool valid = b < B;
      float x[kNch];
#pragma unroll
      for (int k = 0; k < kNch; ++k) x[k] = s_ch[k * kHistTile + r];
      const unsigned peers = peers_by_bin(b, valid);
      const bool leader = valid && lane == __ffs(peers) - 1;
      // the leader's own row first, then one shuffle round per other peer
      const int others = leader ? __popc(peers) - 1 : 0;
      const int most = (int)__reduce_max_sync(kHistFull, (unsigned)others);
      float* hb = h + (leader ? b : 0) * kNch;
      float acc[kNch];
#pragma unroll
      for (int k = 0; k < kNch; ++k) acc[k] = leader ? hb[k] + x[k] : 0.f;
      unsigned m = leader ? peers & (peers - 1) : 0u;
      for (int j = 0; j < most; ++j) {
        const int src = m ? __ffs(m) - 1 : lane;
        m &= m - 1;
#pragma unroll
        for (int k = 0; k < kNch; ++k) {
          const float v = __shfl_sync(kHistFull, x[k], src);
          if (j < others) acc[k] += v;
        }
      }
      if (leader) {
#pragma unroll
        for (int k = 0; k < kNch; ++k) hb[k] = acc[k];
      }
      __syncwarp();    // the next step's leaders read these sums
    }
  }
}

// One work item: chunk `chunk` of the segment [start, start + cnt) of the
// layout's buffer (the caller has checked chunk < hist_chunks(cnt)), for
// features [f0, f0 + min(kFeats, F - f0)). The block has kThreads
// threads; smem holds hist_smem_bytes(B, kNch, kFeats). Writes the chunk's
// partial
// of those features to partial (chunks, F, B, kNch). No __restrict__ on the
// layout's buffers: one_kernel_split.cu reads them after other blocks wrote
// them in the same launch, which the read-only (non-coherent) load path
// must not serve.
template <int kNch, int kThreads, int kFeats, class L>
__device__ __forceinline__ void hist_chunk(const L& lay, int start, int cnt,
                                           int F, int B, int f0, int chunk,
                                           float* smem,
                                           float* __restrict__ partial) {
  constexpr int kRpt = kHistTile / kThreads;
  constexpr int kWarps = kThreads / 32;
  static_assert(kHistTile % kThreads == 0, "whole rows per thread");
  static_assert(kHistTile % 16 == 0, "tiles keep the staging windows");
  static_assert(kFeats <= kHistFeats, "bins ride in one word");
  float* s_hist = smem;
  float* s_ch = smem + kFeats * kHistSlices * B * kNch;
  uint8_t* s_bin = reinterpret_cast<uint8_t*>(s_ch + kNch * kHistTile);
  uint8_t* s_raw = s_bin + kFeats * kHistTile;     // two staging buffers
  const int nf = min(kFeats, F - f0);
  const int row0 = chunk * kHistChunk;
  const int crows = min(kHistChunk, cnt - row0);
  const long base = (long)start + row0;
  const int hist_len = nf * kHistSlices * B * kNch;
  if constexpr (L::kAsync) {
    const int stage_len = (kFeats + 12) * kStageBytes;
    __syncthreads();   // smem is free: a previous item's readers are done
    lay.template stage<kThreads>(base, min(kHistTile, crows), f0, nf, s_raw);
    cp_async_commit();
    for (int k = threadIdx.x; k < hist_len; k += kThreads) s_hist[k] = 0.f;
    for (int t0 = 0, buf = 0; t0 < crows; t0 += kHistTile, buf ^= 1) {
      const int rows = min(kHistTile, crows - t0);
      if (t0 + kHistTile < crows) {   // the next tile's copies fly meanwhile
        lay.template stage<kThreads>(base + t0 + kHistTile,
                                     min(kHistTile, crows - t0 - kHistTile),
                                     f0, nf, s_raw + (buf ^ 1) * stage_len);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();   // the tile is staged; the previous one is counted
      decode_staged<kNch, kThreads, kFeats>(s_raw + buf * stage_len,
                                            base + t0, rows, nf, s_ch, s_bin);
      __syncthreads();
      count_tile<kNch, kWarps>(rows, nf, B, s_ch, s_bin, s_hist);
    }
  } else {
    RowRaw raw[kRpt];
    load_tile<kThreads>(lay, base, min(kHistTile, crows), f0, nf, raw);
    __syncthreads();   // smem is free: a previous item's readers are done
    for (int k = threadIdx.x; k < hist_len; k += kThreads) s_hist[k] = 0.f;
    for (int t0 = 0; t0 < crows; t0 += kHistTile) {
      const int rows = min(kHistTile, crows - t0);
      if (t0) __syncthreads();     // the previous tile is counted
      store_tile<kNch, kThreads, kFeats>(raw, rows, s_ch, s_bin);
      if (t0 + kHistTile < crows) {   // the next tile's loads fly meanwhile
        load_tile<kThreads>(lay, base + t0 + kHistTile,
                            min(kHistTile, crows - t0 - kHistTile), f0, nf,
                            raw);
      }
      __syncthreads();
      count_tile<kNch, kWarps>(rows, nf, B, s_ch, s_bin, s_hist);
    }
  }
  __syncthreads();
  // the chunk's partial: slices 0 + 1 + 2 + 3 per (feature, bin, channel)
  const int per_f = B * kNch;
  float* out = partial + ((size_t)chunk * F + f0) * per_f;
  for (int k = threadIdx.x; k < nf * per_f; k += kThreads) {
    const int fl = k / per_f, e = k - fl * per_f;
    const float* h = s_hist + (size_t)fl * kHistSlices * per_f + e;
    float v = h[0];
#pragma unroll
    for (int s = 1; s < kHistSlices; ++s) v += h[s * per_f];
    out[k] = v;
  }
}

// The sum of element e (a flat (feature, bin, channel) index) of the
// first `chunks` partials (each `stride` floats), in chunk order from
// zero. Loads go eight at a time so that they are in flight together.
__device__ __forceinline__ float hist_sum(const float* partial, int chunks,
                                          size_t stride, size_t e) {
  float v = 0.f;
  int k = 0;
  for (; k + 8 <= chunks; k += 8) {
    float x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = partial[(k + i) * stride + e];
#pragma unroll
    for (int i = 0; i < 8; ++i) v += x[i];
  }
  for (; k < chunks; ++k) v += partial[k * stride + e];
  return v;
}

}  // namespace lgbt_hist
