// Stable two-way partition of one leaf's segment of the planes work buffer,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/partition.py:
// partition_segment_planes_fused (pallas_call "partition_segment_planes_fused",
// body _partition_planes_kernel). Same data contract: work is a (2, W, Npad)
// u8 ping-pong pair of byte planes (F bin planes, then g/h/cnt as 12 f32 byte
// planes); the segment is lanes [start, start + cnt) of plane src; rows whose
// split-column bin b has table[b] set in the (B,) bool routing table go left
// (the TPU kernel bit-packs the table into 8 scalar words for its scalar
// prefetch; here the 256 bytes sit in shared memory). Rows are written into
// plane 1 - src, left rows first; lanes outside the segment are not touched;
// lt (the left count) is written to a device int. Unlike the TPU kernel the order is fixed: stable on both sides (left
// rows ascending from start, right rows ascending from start + lt), so the
// result equals the plain twin byte for byte.
//
// What bounds it on this card: bytes. Each row is read once (W bytes, plus
// the split column once more for the count) and written once (W bytes): 80 B
// per row at W = 40, 160 MB for the 2M-row root split, ~0.05 ms at 3.35 TB/s.
// There is no arithmetic to speak of.
//
// Design: three launches on one stream, no atomics on positions, so the
// result is deterministic.
//   1. count: one block per 4096-lane tile; each warp ballots the go-left
//      bits of its 512 lanes, 32 at a time; the block's left count goes to
//      scratch[block].
//   2. scan: one block turns the per-tile counts into exclusive offsets and
//      writes lt (the total).
//   3. scatter: each block recomputes its warps' ballots (kept in registers),
//      ranks each lane by popc of the ballot below it, and copies the row's
//      W bytes plane by plane. A warp reads 32 consecutive bytes of a plane
//      per step and writes its left lanes, and its right lanes, to
//      consecutive bytes: both sides stay coalesced.
// start, cnt, feat and src are read from a device array, so the host never
// waits on the card to launch; the grid is sized by a host upper bound of
// cnt and tiles past the segment do nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 16;                      // 32-lane steps per warp
constexpr int kTile = kWarps * kSteps * 32;     // 4096 lanes per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool goes_left(const uint8_t* col, long lane,
                                          const uint8_t* tbl) {
  return tbl[col[lane]] != 0;
}

// The (B,) table into shared memory; bins past B route right.
__device__ __forceinline__ void load_table(uint8_t* s_tbl,
                                           const uint8_t* table, int nbins) {
  for (int b = threadIdx.x; b < 256; b += blockDim.x) {
    s_tbl[b] = b < nbins ? table[b] : 0;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ work, int W, int npad,
             const int* __restrict__ seg, const uint8_t* __restrict__ table,
             int nbins, int* __restrict__ counts) {
  __shared__ uint8_t s_tbl[256];
  __shared__ int s_warp[kWarps];
  load_table(s_tbl, table, nbins);
  const int src = seg[0], start = seg[1], cnt = seg[2], feat = seg[3];
  const uint8_t* col = work + ((size_t)src * W + feat) * npad;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long base = (long)blockIdx.x * kTile + warp * (kSteps * 32);
  int n = 0;
  for (int s = 0; s < kSteps; ++s) {
    const long i = base + s * 32 + lane;
    const bool g = i < cnt && goes_left(col, start + i, s_tbl);
    n += __popc(__ballot_sync(kFull, g));
  }
  if (lane == 0) s_warp[warp] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < kWarps; ++w) t += s_warp[w];
    counts[blockIdx.x] = t;
  }
}

// In-place exclusive scan of the per-tile counts; *lt = their total.
__global__ void __launch_bounds__(1024)
scan_kernel(int* __restrict__ counts, int nblocks, int* __restrict__ lt) {
  __shared__ int s[1024];
  int carry = 0;
  for (int base = 0; base < nblocks; base += 1024) {
    const int i = base + threadIdx.x;
    const int v = i < nblocks ? counts[i] : 0;
    s[threadIdx.x] = v;
    __syncthreads();
    for (int o = 1; o < 1024; o <<= 1) {
      const int t = threadIdx.x >= o ? s[threadIdx.x - o] : 0;
      __syncthreads();
      s[threadIdx.x] += t;
      __syncthreads();
    }
    if (i < nblocks) counts[i] = carry + s[threadIdx.x] - v;
    carry += s[1023];
    __syncthreads();
  }
  if (threadIdx.x == 0) *lt = carry;
}

__global__ void __launch_bounds__(kThreads)
scatter_kernel(uint8_t* __restrict__ work, int W, int npad,
               const int* __restrict__ seg, const uint8_t* __restrict__ table,
               int nbins, const int* __restrict__ offsets,
               const int* __restrict__ lt_p) {
  __shared__ uint8_t s_tbl[256];
  __shared__ int s_warp[kWarps];
  load_table(s_tbl, table, nbins);
  const int src = seg[0], start = seg[1], cnt = seg[2], feat = seg[3];
  const int lt = *lt_p;
  const uint8_t* srcp = work + (size_t)src * W * npad;
  uint8_t* dstp = work + (size_t)(1 - src) * W * npad;
  const uint8_t* col = srcp + (size_t)feat * npad;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long base = (long)blockIdx.x * kTile + warp * (kSteps * 32);
  unsigned masks[kSteps];
  int n = 0;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const long i = base + s * 32 + lane;
    const bool g = i < cnt && goes_left(col, start + i, s_tbl);
    masks[s] = __ballot_sync(kFull, g);
    n += __popc(masks[s]);
  }
  if (lane == 0) s_warp[warp] = n;
  __syncthreads();
  int left_before = offsets[blockIdx.x];
  for (int w = 0; w < warp; ++w) left_before += s_warp[w];
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const long i = base + s * 32 + lane;
    const unsigned m = masks[s];
    if (i < cnt) {
      const int lb = left_before + __popc(m & below);   // left rows before i
      const long dst = ((m >> lane) & 1u) ? (long)start + lb
                                          : (long)start + lt + (i - lb);
      const long from = start + i;
      for (int w = 0; w < W; ++w) {
        dstp[(size_t)w * npad + dst] = srcp[(size_t)w * npad + from];
      }
    }
    left_before += __popc(m);
  }
}

}  // namespace

extern "C" {

const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int partition_segment(void* work, int W, int npad, const void* seg,
                      const void* table, int nbins, void* scratch, void* lt,
                      int nblocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* w = static_cast<uint8_t*>(work);
  const int* sg = static_cast<const int*>(seg);
  const uint8_t* tb = static_cast<const uint8_t*>(table);
  int* counts = static_cast<int*>(scratch);
  int* ltp = static_cast<int*>(lt);
  count_kernel<<<nblocks, kThreads, 0, s>>>(w, W, npad, sg, tb, nbins,
                                            counts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  scan_kernel<<<1, 1024, 0, s>>>(counts, nblocks, ltp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  scatter_kernel<<<nblocks, kThreads, 0, s>>>(w, W, npad, sg, tb, nbins,
                                              counts, ltp);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
