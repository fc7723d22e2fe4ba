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
// Design: the planes are read and written as aligned 4-lane words: a
// thread loads one word of each of the 4 ridx planes (a warp reads 128
// consecutive bytes of each), decodes its 4 rows' ridx, gathers their 4
// bins and stores one word of route bytes; the ragged words at the
// segment's ends are stored byte by byte (resident.cuh route_gather).
// Blocks of 64 threads, one word each per pass: an 8k-row segment spreads
// over 32 blocks, one per SM, and a larger one over as many blocks as it
// has words (grid-stride beyond the grid).
#include <cuda_runtime.h>
#include <stdint.h>

#include "resident.cuh"
#include "segment_arg.cuh"

namespace {

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
route_kernel(uint8_t* work, int W, int npad, const int* __restrict__ seg,
             int mode, const uint8_t* __restrict__ res, int npad_res) {
  const lgbt_seg::Seg sg = lgbt_seg::read_seg<true>(seg, nullptr, mode);
  const int src = sg.src, start = sg.start, cnt = sg.cnt, feat = sg.col;
  uint8_t* pl = work + (size_t)src * W * npad;
  lgbt_res::route_gather<1>(
      pl, npad, start, cnt, res, npad_res, feat, 0, cnt,
      (long)blockIdx.x * blockDim.x + threadIdx.x,
      (long)gridDim.x * blockDim.x);
}

}  // namespace

extern "C" {

const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// work is the (2, W, npad) slim pair (npad a multiple of 4), res the
// (F, npad_res) resident planes; nblocks blocks of 64 threads, one 4-row
// word each per pass. mode (segment_arg.cuh): seg is [src, start, cnt,
// feat] (kSegPlain) or a split's header (kSegParent; a dead one writes
// nothing).
int write_route_plane(void* work, int W, int npad, const void* seg,
                      int mode, const void* res, int npad_res, int nblocks,
                      void* stream) {
  if (npad % 4 != 0 || nblocks < 1 ||
      (mode != lgbt_seg::kSegPlain && mode != lgbt_seg::kSegParent)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  route_kernel<<<nblocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(work), W, npad, static_cast<const int*>(seg),
      mode, static_cast<const uint8_t*>(res), npad_res);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
