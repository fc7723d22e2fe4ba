// int8 quantized g/h/count histogram of one leaf's segment of the rows work
// buffer, for Hopper (sm_90a).
//
// Replaces the quantized mode of the TPU kernel lightgbm_tpu/ops/
// histogram.py: hist_mxu_segment (pallas_call "hist_mxu_segment", body
// _hist_mxu_kernel with quantized=True), whose oracle is hist16_segment_q.
// Same contract: rows [start, start + cnt) of buffer `plane` of the
// (2, Npad, W) u8 rows pair, each row F bin bytes then int8 g, int8 h and u8
// cnt (W = F + 3, ops/partition.py pack_rows_quantized) -> the (F, B, 3)
// int32 sums of g, h and cnt per (feature, bin), dequantized as
// hist16_segment_q does: float(sum) * [1/gscale, 1/hscale, 1], each a single
// f32 rounding. The TPU feeds int8 one-hots to its MXU with int32
// accumulation; here the sums are int32 shared-memory atomics. Integer adds
// do not depend on their order, so the result is the same bytes run to run
// and equals the plain twin's (and the JAX package's) exactly.
//
// What bounds it on this card: bytes. A row is read once: F + 3 bytes, 31 B
// at F = 28, 62 MB for a 2M-row segment, ~0.019 ms at 3.35 TB/s. The work
// per row is three shared-memory atomic adds per feature; rows with a zero
// channel skip that add (adding zero changes nothing), so out-of-bag rows
// cost only their read.
//
// Design:
//   1. memset the (F, B, 3) int32 accumulator.
//   2. Grid (row blocks, feature groups). A block privatises the int32
//      histogram of its features in shared memory (F = 28, B = 256 is 86 KB,
//      under the dynamic shared-memory opt-in), walks the segment with a
//      grid-stride loop, one row per thread, and adds its nonzero entries
//      into the accumulator with global int32 atomics.
//   3. One pass dequantizes the accumulator into the f32 output.
// int32 holds 127 * N for N <= 16,909,320 rows per leaf; the wrapper
// refuses larger segments.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
hist_q_kernel(const uint8_t* __restrict__ work, int W, int npad,
              const int* __restrict__ seg, int F, int B, int feats_per_block,
              int* __restrict__ acc) {
  extern __shared__ int s_hist[];                 // (nfb, B, 3)
  const int nfb = feats_per_block;
  const int plane = seg[0], start = seg[1], cnt = seg[2];
  const int f0 = blockIdx.y * nfb;
  const int nf = min(nfb, F - f0);
  const int len = nf * B * 3;
  for (int k = threadIdx.x; k < len; k += blockDim.x) s_hist[k] = 0;
  __syncthreads();
  const uint8_t* buf = work + (size_t)plane * npad * W;
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < cnt;
       i += stride) {
    const uint8_t* row = buf + ((long)start + i) * W;
    const int g = (int8_t)row[F];
    const int h = (int8_t)row[F + 1];
    const int c = row[F + 2];
    if ((g | h | c) == 0) continue;
    for (int f = 0; f < nf; ++f) {
      const int b = row[f0 + f];
      if (b >= B) continue;
      int* hb = s_hist + (f * B + b) * 3;
      if (g) atomicAdd(hb, g);
      if (h) atomicAdd(hb + 1, h);
      if (c) atomicAdd(hb + 2, c);
    }
  }
  __syncthreads();
  // this block's features are one contiguous range of the accumulator
  int* out = acc + (size_t)f0 * B * 3;
  for (int k = threadIdx.x; k < len; k += blockDim.x) {
    const int v = s_hist[k];
    if (v) atomicAdd(out + k, v);
  }
}

__global__ void dequant_kernel(const int* __restrict__ acc, int n,
                               const float* __restrict__ scale,
                               float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n) out[k] = __fmul_rn(__int2float_rn(acc[k]), scale[k % 3]);
}

}  // namespace

extern "C" {

const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// work (2, npad, W) u8; seg [plane, start, cnt] i32; scale (3,) f32;
// acc (F, B, 3) i32 scratch; out (F, B, 3) f32. feats_per_block sets the
// feature groups (grid.y) and the shared memory per block.
int segment_histogram_q(const void* work, int W, int npad, const void* seg,
                        int F, int B, int feats_per_block, int row_blocks,
                        const void* scale, void* acc, void* out,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = F * B * 3;
  cudaError_t e = cudaMemsetAsync(acc, 0, (size_t)n * sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem = feats_per_block * B * 3 * (int)sizeof(int);
  e = cudaFuncSetAttribute(hist_q_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int groups = (F + feats_per_block - 1) / feats_per_block;
  dim3 grid(row_blocks, groups);
  hist_q_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const uint8_t*>(work), W, npad,
      static_cast<const int*>(seg), F, B, feats_per_block,
      static_cast<int*>(acc));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int threads = 256;
  dequant_kernel<<<(n + threads - 1) / threads, threads, 0, s>>>(
      static_cast<const int*>(acc), n, static_cast<const float*>(scale),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
