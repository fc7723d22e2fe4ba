// Route gather of the resident layout, for Hopper (sm_90a): before a
// partition of the slim work pair, write the split column's bin of every
// segment row into the route plane, so that the planes partition (K3,
// csrc/partition_segment.cu) routes the slim payload on plane 0 unchanged.
//
// Replaces lightgbm_tpu/ops/partition.py write_route_plane, an XLA gather
// of the JAX package's resident path (no Pallas kernel there). Same
// contract: rows [start, start + cnt) of buffer src of the (2, W, npad) u8
// slim pair (csrc/resident.cuh); plane 0 of each row gets
// res[feat * npad_res + ridx], ridx decoded from planes 1..4 and clamped
// to [0, npad_res); nothing else is written. seg = [src, start, cnt, feat]
// is read from a device array, so the host never waits on the card; the
// grid is sized by a host upper bound of cnt and threads past the segment
// do nothing. The result equals the plain twin byte for byte.
//
// What bounds it on this card: bytes. Per row it reads the 4 ridx bytes
// and one gathered bin and writes the route byte: 6 B per row, 12 MB at
// the 2M-row root, ~0.0036 ms at 3.35 TB/s. At the root ridx is the
// identity and the gather reads one plane in order; below the first few
// levels a leaf's rows are ascending but sparse in the original order, so
// each gathered byte costs a 32-byte sector of its own.
//
// Design: each thread takes kBatch = 4 rows a grid stride apart (and
// strides past the grid), bytes read and written one at a time: a warp
// reads 32 consecutive bytes of each ridx plane and writes 32 consecutive
// route bytes; a thread's 4 rows' loads are issued before its stores
// (resident.cuh route_gather). A first, simple kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "resident.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 4;    // rows per thread per pass

__global__ void __launch_bounds__(kThreads)
route_kernel(uint8_t* work, int W, int npad, const int* __restrict__ seg,
             const uint8_t* __restrict__ res, int npad_res) {
  const int src = seg[0], start = seg[1], cnt = seg[2], feat = seg[3];
  uint8_t* pl = work + (size_t)src * W * npad;
  lgbt_res::route_gather<kBatch>(
      pl, npad, start, cnt, res, npad_res, feat, 0, cnt,
      (long)blockIdx.x * blockDim.x + threadIdx.x,
      (long)gridDim.x * blockDim.x);
}

}  // namespace

extern "C" {

const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// work is the (2, W, npad) slim pair, res the (F, npad_res) resident
// planes; nblocks blocks of 256 threads, 4 rows each.
int write_route_plane(void* work, int W, int npad, const void* seg,
                      const void* res, int npad_res, int nblocks,
                      void* stream) {
  route_kernel<<<nblocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(work), W, npad, static_cast<const int*>(seg),
      static_cast<const uint8_t*>(res), npad_res);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
