// Row router: all rounds of one tree's split log -> a leaf id per row, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/route.py:route_rows (pallas_call
// "route_rows", body _route_kernel). Same contract: transposed bins
// (F, Npad/128, 128) u8, a (R * TBL_W) i32 table with TBL_W = 10 columns per
// round (col, leaf, bin, miss, dl, plain, off, dpos, nbm1, rest) and the
// device scalar num_splits -> (Npad,) i32 leaf ids. Numerical splits with
// the movable-missing override, and the EFB bundle arithmetic: a bundled
// column's slot maps back to the sub-feature's bin (slots at or above the
// shared default position shift up by one) and slots outside the
// sub-feature's range follow the default bin's direction (rest).
//
// What bounds it on this card: bytes at large N only in principle -- the
// input is one u8 per (feature, row) and the output one i32 per row, 2M x 28
// rows moving ~64 MB (~20 us at 3.35 TB/s). Each row runs R rounds of a
// shared-memory table read and a compare, so the kernel is bound by integer
// issue rate, not by memory.
//
// Design: one thread per row, 256 rows per block. The whole table
// (254 x 10 x 4 B ~ 10 KB at 255 leaves) is staged into shared memory once
// per block; every thread of a warp reads the same word (a broadcast). A
// row reads a bin only on the rounds that split its current leaf, from the
// transposed layout, so a warp's 32 reads of one column fall in one
// 32-byte sector when the rows share a leaf. num_splits stays on the device
// (no host sync between the tree builder and the router).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 256;
constexpr int kTblW = 10;

__global__ void __launch_bounds__(kRows)
route_rows_kernel(const uint8_t* __restrict__ bins_t, int npad,
                  const int* __restrict__ table, int rounds,
                  const int* __restrict__ num_splits,
                  int* __restrict__ out) {
  extern __shared__ int s_tbl[];
  for (int i = threadIdx.x; i < rounds * kTblW; i += kRows) {
    s_tbl[i] = table[i];
  }
  __syncthreads();
  const int row = blockIdx.x * kRows + threadIdx.x;
  if (row >= npad) return;
  const int ns = min(*num_splits, rounds);
  int state = 0;
  for (int r = 0; r < ns; ++r) {
    const int* e = s_tbl + r * kTblW;
    if (state != e[1]) continue;
    const int col = bins_t[(size_t)e[0] * npad + row];
    const int tbin = e[2], miss = e[3], dl = e[4], plain = e[5];
    const int off = e[6], dpos = e[7], nbm1 = e[8], rest = e[9];
    const int rank = col - off;
    const int fb = rank + (rank >= dpos ? 1 : 0);
    const bool in_range = col >= off && col < off + nbm1;
    const int eff = plain == 1 ? col : fb;
    int go = eff <= tbin ? 1 : 0;
    if (miss >= 0 && eff == miss) go = dl;
    if (!(plain == 1 || in_range)) go = rest;
    if (go == 0) state = r + 1;
  }
  out[row] = state;
}

}  // namespace

extern "C" {

const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int route_rows(const void* bins_t, int npad, const void* table, int rounds,
               const void* num_splits, void* out, void* stream) {
  const int smem = rounds * kTblW * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        route_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (npad + kRows - 1) / kRows;
  route_rows_kernel<<<grid, kRows, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bins_t), npad,
      static_cast<const int*>(table), rounds,
      static_cast<const int*>(num_splits), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
