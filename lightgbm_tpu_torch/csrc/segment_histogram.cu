// g/h/count histogram of one leaf's segment of the work buffer, for Hopper
// (sm_90a), on both work layouts.
//
// Replaces the TPU kernels lightgbm_tpu/ops/histogram.py:
// hist_pallas_segment_planes (pallas_call "hist_pallas_segment_planes", body
// _hist_pallas_kernel_planes; entry point segment_histogram) and
// hist_pallas_segment (pallas_call "hist_pallas_segment", body
// _hist_pallas_kernel; entry point segment_histogram_rows), which is also
// the f32 mode of hist_mxu_segment. Same contract: rows [start, start + cnt)
// of buffer `plane` of the work pair (rows of F bin bytes, then g, h, cnt as
// little-endian f32 bytes; (2, W, Npad) byte planes or (2, Npad, W) rows) ->
// (F, B, 3) f32 sums. Same per-row numerics: in exact (hi/lo) mode g and h
// each contribute bf16(x) and bf16(x - bf16(x)) (round to nearest even,
// __float2bfloat16_rn, as jnp.astype rounds), summed in separate f32
// channels and added at the end (_hist16_combine); cnt contributes bf16(cnt).
// In bf16 mode each channel contributes bf16(x). Only the order of the f32
// sums differs from the TPU. Both layouts run one kernel body with the same
// tile assignment and summation order, so the same rows in the same order
// give the same bits on either layout.
//
// What bounds it on this card: bytes. A row is read once: F bin bytes + 12
// channel bytes, 40 B at F = 28, 80 MB for a 2M-row segment, ~0.025 ms at
// 3.35 TB/s. The work per row is a shared-memory add per feature. The rows
// layout reads a feature's bins at a stride of W bytes; the 16 warps of a
// block read the same rows, so those reads are served from L1.
//
// Design, chosen for bit-determinism run to run (no float atomics):
//   1. Grid (row blocks, feature groups). A block owns <= 16 features, one
//      warp each, with its (features, B, NCH) f32 histogram in shared memory.
//      Row blocks walk the segment in 1024-row tiles, tile t going to block
//      t % row_blocks (a fixed assignment). Per tile the block decodes the
//      rows' channels into shared memory once; then each warp takes 32 rows
//      of its feature at a time, groups lanes by bin with __match_any_sync,
//      and the group's lowest lane sums the group's rows in lane order and
//      adds the sum to the bin. Each bin is written by one warp in row order.
//   2. A second launch sums the row blocks' partial histograms in block order
//      and combines hi + lo.
// The count channel sums exact small integers in f32 (exact below 2^24 rows).
// Channel words are assembled from single bytes: on the rows layout a row's
// f32 words start at byte F, which is not 4-byte aligned in general.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;        // rows per tile
constexpr int kMaxFeats = 16;      // features (warps) per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Byte w of row `row` of one buffer: planes hold it at w * npad + row, rows
// at row * W + w.
template <bool kRows>
__device__ __forceinline__ uint32_t byte_at(const uint8_t* buf, int W,
                                            int npad, int w, long row) {
  return kRows ? buf[row * W + w] : buf[(size_t)w * npad + row];
}

// The little-endian f32 word at bytes w .. w + 3 of row `row`.
template <bool kRows>
__device__ __forceinline__ float word_at(const uint8_t* buf, int W, int npad,
                                         int w, long row) {
  const uint32_t b0 = byte_at<kRows>(buf, W, npad, w, row);
  const uint32_t b1 = byte_at<kRows>(buf, W, npad, w + 1, row);
  const uint32_t b2 = byte_at<kRows>(buf, W, npad, w + 2, row);
  const uint32_t b3 = byte_at<kRows>(buf, W, npad, w + 3, row);
  return __uint_as_float(b0 | (b1 << 8) | (b2 << 16) | (b3 << 24));
}

template <bool kRows>
__global__ void hist_kernel(const uint8_t* __restrict__ work, int W, int npad,
                            const int* __restrict__ seg, int F, int B,
                            int nch, int feats_per_block,
                            float* __restrict__ partial) {
  extern __shared__ float smem[];
  const int nfb = feats_per_block;
  float* s_hist = smem;                          // (nfb, B, nch)
  float* s_ch = smem + (size_t)nfb * B * nch;    // (nch, kTile)
  const int plane = seg[0], start = seg[1], cnt = seg[2];
  const int f0 = blockIdx.y * nfb;
  const int nf = min(nfb, F - f0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hist_len = nfb * B * nch;
  for (int k = threadIdx.x; k < hist_len; k += blockDim.x) s_hist[k] = 0.f;
  const uint8_t* pl = work + (size_t)plane * W * npad;
  const int ntiles = (cnt + kTile - 1) / kTile;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int row0 = t * kTile;
    const int rows = min(kTile, cnt - row0);
    __syncthreads();   // the previous tile's channels are consumed
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const long lane_i = (long)start + row0 + r;
      const float g = word_at<kRows>(pl, W, npad, F, lane_i);
      const float h = word_at<kRows>(pl, W, npad, F + 4, lane_i);
      const float c = word_at<kRows>(pl, W, npad, F + 8, lane_i);
      if (nch == 5) {
        const float g_hi = bf(g), h_hi = bf(h);
        s_ch[r] = g_hi;
        s_ch[kTile + r] = bf(g - g_hi);
        s_ch[2 * kTile + r] = h_hi;
        s_ch[3 * kTile + r] = bf(h - h_hi);
        s_ch[4 * kTile + r] = bf(c);
      } else {
        s_ch[r] = bf(g);
        s_ch[kTile + r] = bf(h);
        s_ch[2 * kTile + r] = bf(c);
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
            ? (int)byte_at<kRows>(pl, W, npad, feat, row_base + r) : B;
        const bool valid = b < B;
        // invalid lanes get keys no bin uses, so they never join a group
        const unsigned key = valid ? (unsigned)b : (unsigned)(B + lane);
        const unsigned peers = __match_any_sync(kFull, key);
        if (valid && lane == __ffs(peers) - 1) {
          float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
          unsigned m = peers;
          while (m) {
            const int j = __ffs(m) - 1;
            m &= m - 1;
            for (int k = 0; k < nch; ++k) acc[k] += s_ch[k * kTile + r0 + j];
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
  float* out = partial + ((size_t)blockIdx.x * F + f0) * B * nch;
  const int len = nf * B * nch;
  for (int k = threadIdx.x; k < len; k += blockDim.x) out[k] = s_hist[k];
}

__global__ void reduce_kernel(const float* __restrict__ partial,
                              int row_blocks, int F, int B, int nch,
                              float* __restrict__ out) {
  const int fb = blockIdx.x * blockDim.x + threadIdx.x;
  if (fb >= F * B) return;
  float s[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int rb = 0; rb < row_blocks; ++rb) {
    const float* p = partial + ((size_t)rb * F * B + fb) * nch;
    for (int k = 0; k < nch; ++k) s[k] += p[k];
  }
  float* o = out + (size_t)fb * 3;
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

template <bool kRows>
int launch_histogram(const void* work, int W, int npad, const void* seg,
                     int F, int B, int exact, int row_blocks, void* partial,
                     void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nch = exact ? 5 : 3;
  const int groups = (F + kMaxFeats - 1) / kMaxFeats;
  const int nfb = (F + groups - 1) / groups;
  const int smem = (nfb * B * nch + nch * kTile) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      hist_kernel<kRows>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(row_blocks, groups);
  hist_kernel<kRows><<<grid, nfb * 32, smem, s>>>(
      static_cast<const uint8_t*>(work), W, npad,
      static_cast<const int*>(seg), F, B, nch, nfb,
      static_cast<float*>(partial));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int threads = 256;
  reduce_kernel<<<(F * B + threads - 1) / threads, threads, 0, s>>>(
      static_cast<const float*>(partial), row_blocks, F, B, nch,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Planes layout: work is (2, W, npad).
int segment_histogram(const void* work, int W, int npad, const void* seg,
                      int F, int B, int exact, int row_blocks, void* partial,
                      void* out, void* stream) {
  return launch_histogram<false>(work, W, npad, seg, F, B, exact, row_blocks,
                                 partial, out, stream);
}

// Rows layout: work is (2, npad, W).
int segment_histogram_rows(const void* work, int W, int npad, const void* seg,
                           int F, int B, int exact, int row_blocks,
                           void* partial, void* out, void* stream) {
  return launch_histogram<true>(work, W, npad, seg, F, B, exact, row_blocks,
                                partial, out, stream);
}

}  // extern "C"
