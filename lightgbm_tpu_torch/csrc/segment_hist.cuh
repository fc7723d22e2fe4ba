// Device code of the f32 segment histogram (K4), shared by
// csrc/segment_histogram.cu (the three-launch path) and phase B of
// csrc/one_kernel_split.cu, so that both sum the same values in the same
// order and give the same bits. See segment_histogram.cu for the data
// contract and the design.
//
// hist_row_block is one row block's pass: tiles rb, rb + row_blocks, ...
// of kHistTile = 1024 rows, one warp per feature of the block's feature
// range, into a shared (features, B, nch) histogram that it writes to the
// row block's partial. hist_reduce_bin sums one (feature, bin)'s partials
// in row-block order and combines hi + lo. A feature's sums depend only on
// the row blocks, never on how features are grouped into blocks.
//
// Where a row's bytes are is a layout policy: PackedRows<false> (planes),
// PackedRows<true> (rows), ResidentRows (the slim pair plus the resident
// bin planes, csrc/resident.cuh). The pass runs the same arithmetic in the
// same order on every layout, so the same rows in the same order give the
// same bits whichever layout holds them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "resident.cuh"

namespace lgbt_hist {

constexpr int kHistTile = 1024;       // rows per tile
constexpr int kHistMaxFeats = 16;     // features (warps) per K4 block
constexpr unsigned kHistFull = 0xffffffffu;

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Planes (kRows false) hold byte w of row `row` at w * npad + row, rows
// at row * W + w: the F bin bytes, then g, h, cnt at bytes F .. F + 11.
template <bool kRows>
struct PackedRows {
  const uint8_t* buf;
  int W, npad, F;
  static constexpr bool kGather = false;
  __device__ __forceinline__ uint32_t byte_at(int w, long row) const {
    return kRows ? buf[row * W + w] : buf[(size_t)w * npad + row];
  }
  __device__ __forceinline__ int gh_off() const { return F; }
  __device__ __forceinline__ void stage(long, int*, int) const {}
  // bin of feature f of buffer row `row`, tile row r
  __device__ __forceinline__ uint32_t bin(int f, long row, const int*,
                                          int) const {
    return byte_at(f, row);
  }
};

// The slim pair's buffer `buf` (npad lanes per plane) holds g, h, cnt at
// planes 5 .. 16; bin f of a row is res[f * npad_res + ridx]. The channel
// pass stages each tile row's ridx in shared memory (s_ridx, kHistTile
// ints), where the feature warps read it.
struct ResidentRows {
  const uint8_t* buf;
  int npad;
  const uint8_t* res;
  int npad_res;
  static constexpr bool kGather = true;
  __device__ __forceinline__ uint32_t byte_at(int w, long row) const {
    return buf[(size_t)w * npad + row];
  }
  __device__ __forceinline__ int gh_off() const { return lgbt_res::kGhOff; }
  __device__ __forceinline__ void stage(long row, int* s_ridx, int r) const {
    s_ridx[r] = lgbt_res::ridx_at(buf, npad, row, npad_res);
  }
  __device__ __forceinline__ uint32_t bin(int f, long, const int* s_ridx,
                                          int r) const {
    return res[(size_t)f * npad_res + s_ridx[r]];
  }
};

// The little-endian f32 word at bytes w .. w + 3 of row `row`.
template <class L>
__device__ __forceinline__ float word_at(const L& lay, int w, long row) {
  const uint32_t b0 = lay.byte_at(w, row);
  const uint32_t b1 = lay.byte_at(w + 1, row);
  const uint32_t b2 = lay.byte_at(w + 2, row);
  const uint32_t b3 = lay.byte_at(w + 3, row);
  return __uint_as_float(b0 | (b1 << 8) | (b2 << 16) | (b3 << 24));
}

// Row block rb of row_blocks over rows [start, start + cnt) of the
// layout's buffer for features [f0, f0 + min(nfb, F - f0)), one warp each
// (the block has at least nfb warps). s_hist holds (nfb, B, nch) floats,
// s_ch (nch, kHistTile), s_ridx kHistTile ints (ResidentRows only).
// Writes partial[rb][f0 ...] of the (row_blocks, F, B, nch) partial sums.
// No __restrict__ on the layout's buffers: one_kernel_split.cu reads them
// after other blocks wrote them in the same launch, which the read-only
// (non-coherent) load path must not serve; partial is only written here.
template <class L>
__device__ __forceinline__ void hist_row_block(
    const L& lay, int start, int cnt, int F, int B, int nch, int nfb, int f0,
    int rb, int row_blocks, float* s_hist, float* s_ch, int* s_ridx,
    float* __restrict__ partial) {
  const int nf = min(nfb, F - f0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hist_len = nfb * B * nch;
  __syncthreads();     // s_hist is free: a previous pass's readers are done
  for (int k = threadIdx.x; k < hist_len; k += blockDim.x) s_hist[k] = 0.f;
  const int ntiles = (cnt + kHistTile - 1) / kHistTile;
  for (int t = rb; t < ntiles; t += row_blocks) {
    const int row0 = t * kHistTile;
    const int rows = min(kHistTile, cnt - row0);
    __syncthreads();   // the previous tile's channels are consumed
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const long lane_i = (long)start + row0 + r;
      const int gh = lay.gh_off();
      const float g = word_at(lay, gh, lane_i);
      const float h = word_at(lay, gh + 4, lane_i);
      const float c = word_at(lay, gh + 8, lane_i);
      lay.stage(lane_i, s_ridx, r);
      if (nch == 5) {
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
    }
    __syncthreads();
    if (warp < nf) {
      const int feat = f0 + warp;
      const long row_base = (long)start + row0;
      float* hw = s_hist + (size_t)warp * B * nch;
      for (int r0 = 0; r0 < rows; r0 += 32) {
        const int r = r0 + lane;
        const int b = r < rows
            ? (int)lay.bin(feat, row_base + r, s_ridx, r) : B;
        const bool valid = b < B;
        // invalid lanes get keys no bin uses, so they never join a group
        const unsigned key = valid ? (unsigned)b : (unsigned)(B + lane);
        const unsigned peers = __match_any_sync(kHistFull, key);
        if (valid && lane == __ffs(peers) - 1) {
          float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
          unsigned m = peers;
          while (m) {
            const int j = __ffs(m) - 1;
            m &= m - 1;
            for (int k = 0; k < nch; ++k) {
              acc[k] += s_ch[k * kHistTile + r0 + j];
            }
          }
          float* hb = hw + (size_t)b * nch;
          for (int k = 0; k < nch; ++k) hb[k] += acc[k];
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  // this block's features are one contiguous range of the partial row
  float* out = partial + ((size_t)rb * F + f0) * B * nch;
  const int len = nf * B * nch;
  for (int k = threadIdx.x; k < len; k += blockDim.x) out[k] = s_hist[k];
}

// (g, h, cnt) of flat (feature, bin) index fb: the row blocks' partials
// summed in block order, then hi + lo per channel in exact mode (nch = 5).
__device__ __forceinline__ void hist_reduce_bin(
    const float* partial, int row_blocks, int F, int B, int nch,
    int fb, float o[3]) {
  float s[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int rb = 0; rb < row_blocks; ++rb) {
    const float* p = partial + ((size_t)rb * F * B + fb) * nch;
    for (int k = 0; k < nch; ++k) s[k] += p[k];
  }
  if (nch == 5) {
    o[0] = s[0] + s[1];
    o[1] = s[2] + s[3];
    o[2] = s[4];
  } else {
    o[0] = s[0];
    o[1] = s[1];
    o[2] = s[2];
  }
}

}  // namespace lgbt_hist
