// g/h/count histogram of one leaf's segment of the work buffer, for Hopper
// (sm_90a), on the planes, rows and resident work layouts.
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
// The resident entry point (segment_histogram_resident) replaces
// lightgbm_tpu/ops/histogram.py hist16_segment_resident, an XLA gather of
// the JAX package's resident path (no Pallas kernel there): the slim pair
// (csrc/resident.cuh) carries g, h, cnt and each row's ridx, and the bins
// are gathered from the resident planes through ridx. It runs the same
// body, so on the same rows in the same order it is bit-equal to the
// planes entry point (torch's index_add_ on the card uses float atomics
// and is not deterministic). Its bytes: 4 ridx + 12 channel bytes + F
// gathered bins per row, 44 B at F = 28 (~0.026 ms for 2M rows); below the
// first few tree levels a leaf's rows are sparse in the resident order and
// each gathered byte costs a 32-byte sector.
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
// f32 words start at byte F, which is not 4-byte aligned in general. The
// row-block pass and the ordered reduce live in segment_hist.cuh, which
// phase B of one_kernel_split.cu runs too.
#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_hist.cuh"

namespace {

using namespace lgbt_hist;

// One row block of one feature group. `lay` points at the pair's first
// buffer; the kernel moves it to buffer seg[0] (plane_bytes apart).
template <class L>
__global__ void hist_kernel(L lay, size_t plane_bytes,
                            const int* __restrict__ seg, int F, int B,
                            int nch, int feats_per_block,
                            float* __restrict__ partial) {
  extern __shared__ float smem[];
  const int nfb = feats_per_block;
  float* s_hist = smem;                          // (nfb, B, nch)
  float* s_ch = smem + (size_t)nfb * B * nch;    // (nch, kHistTile)
  int* s_ridx = reinterpret_cast<int*>(s_ch + (size_t)nch * kHistTile);
  const int plane = seg[0], start = seg[1], cnt = seg[2];
  lay.buf += (size_t)plane * plane_bytes;
  hist_row_block(lay, start, cnt, F, B, nch, nfb, blockIdx.y * nfb,
                 blockIdx.x, gridDim.x, s_hist, s_ch, s_ridx, partial);
}

__global__ void reduce_kernel(const float* __restrict__ partial,
                              int row_blocks, int F, int B, int nch,
                              float* __restrict__ out) {
  const int fb = blockIdx.x * blockDim.x + threadIdx.x;
  if (fb >= F * B) return;
  float o[3];
  hist_reduce_bin(partial, row_blocks, F, B, nch, fb, o);
  float* dst = out + (size_t)fb * 3;
  dst[0] = o[0];
  dst[1] = o[1];
  dst[2] = o[2];
}

template <class L>
int launch_histogram(L lay, size_t plane_bytes, const void* seg, int F,
                     int B, int exact, int row_blocks, void* partial,
                     void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nch = exact ? 5 : 3;
  const int groups = (F + kHistMaxFeats - 1) / kHistMaxFeats;
  const int nfb = (F + groups - 1) / groups;
  const int smem = (nfb * B * nch + nch * kHistTile) * (int)sizeof(float) +
                   (L::kGather ? kHistTile * (int)sizeof(int) : 0);
  cudaError_t e = cudaFuncSetAttribute(
      hist_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(row_blocks, groups);
  hist_kernel<L><<<grid, nfb * 32, smem, s>>>(
      lay, plane_bytes, static_cast<const int*>(seg), F, B, nch, nfb,
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
  const PackedRows<false> lay{static_cast<const uint8_t*>(work), W, npad, F};
  return launch_histogram(lay, (size_t)W * npad, seg, F, B, exact,
                          row_blocks, partial, out, stream);
}

// Rows layout: work is (2, npad, W).
int segment_histogram_rows(const void* work, int W, int npad, const void* seg,
                           int F, int B, int exact, int row_blocks,
                           void* partial, void* out, void* stream) {
  const PackedRows<true> lay{static_cast<const uint8_t*>(work), W, npad, F};
  return launch_histogram(lay, (size_t)W * npad, seg, F, B, exact,
                          row_blocks, partial, out, stream);
}

// Resident layout: work is the (2, W, npad) slim pair, res the
// (F, npad_res) resident bin planes.
int segment_histogram_resident(const void* work, int W, int npad,
                               const void* seg, const void* res,
                               int npad_res, int F, int B, int exact,
                               int row_blocks, void* partial, void* out,
                               void* stream) {
  const ResidentRows lay{static_cast<const uint8_t*>(work), npad,
                         static_cast<const uint8_t*>(res), npad_res};
  return launch_histogram(lay, (size_t)W * npad, seg, F, B, exact,
                          row_blocks, partial, out, stream);
}

}  // extern "C"
