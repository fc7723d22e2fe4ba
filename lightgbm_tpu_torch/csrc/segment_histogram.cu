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
// sums differs from the TPU. Every layout runs one kernel body with one
// summation order, fixed by the segment's rows, so the same rows in the
// same order give the same bits on any layout and any grid.
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
// 3.35 TB/s. The work per row is a shared-memory add per feature and
// channel, and the chunk partials cost F x B x NCH x 4 B (143 KB) each way
// per 2048 rows, 140 MB at 2M rows. The chunk is small so that the many
// small segments of a tree get more work items; the price is more partial
// traffic on the largest segments (PERF.md).
//
// Design, chosen for bit-determinism run to run (no float atomics)
// with the summation order fixed by the segment's rows alone
// (segment_hist.cuh states it):
//   1. Grid (feature groups, chunk rows): groups of 4 features; the chunk
//      rows stride over the segment's true chunk count, read on the card
//      (one row a chunk of the host's row bound on the per-split path, a
//      wave's worth on the device tree loop's static plan); the blocks in
//      flight share a chunk's rows in L2.
//      A block of 512 threads holds 16 private (B, NCH) f32 histograms in
//      shared memory, one per (feature, slice), each owned by one of its
//      16 warps, so every warp counts its own rows. The chunk is staged in
//      512-row tiles, the bins and the bf16-rounded channels in shared
//      memory, the next tile's bytes in flight while the warps count the
//      current one: on planes, cp.async copies each needed plane's
//      16-byte-aligned window of the tile into a second staging buffer; on
//      rows and resident (a row's bytes are not one run per plane;
//      resident gathers its bins through ridx) each thread loads its row
//      of the next tile into registers. Per 32-row step a warp groups its
//      lanes by bin with 8 ballots, one per bin bit (the groups
//      __match_any_sync would give, at a cost that does not grow with the
//      number of distinct bins); the group's lowest lane adds the group's
//      rows to the bin in lane order, pulling their values by warp
//      shuffle. Two blocks fit on an SM (at most 64 registers, ~108 KB of
//      shared memory each). The chunk's partial is its four slices added
//      in order.
//   2. A second launch, one thread per (feature, bin, channel), sums the
//      chunk partials in chunk order (eight loads in flight) and combines
//      hi + lo.
// The count channel sums exact small integers in f32 (exact below 2^24
// rows). Channel words are assembled from single bytes: on the rows layout
// a row's f32 words start at byte F, which is not 4-byte aligned in
// general. The previous design (one warp per feature, a dependent global
// bin load per 32-row step, tile t to block t % row_blocks with row_blocks
// from the host's bound) took 2.79 ms at the 2M root (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_arg.cuh"
#include "segment_hist.cuh"
#include "smem.cuh"

namespace {

using namespace lgbt_hist;

constexpr int kThreads = 512;      // 16 warps: 4 features x 4 slices
constexpr int kReduceBins = 64;    // (feature, bin)s per reduce block

// The chunks of one feature group, grid-stride over the segment's true
// chunk count (read on the card). `lay` points at the pair's first buffer;
// the kernel moves it to the segment's buffer (plane_bytes apart).
template <int kNch, class L>
__global__ void __launch_bounds__(kThreads, 2)
hist_kernel(L lay, size_t plane_bytes, const int* __restrict__ seg,
            const int* __restrict__ lt, int mode, int F, int B,
            float* __restrict__ partial) {
  extern __shared__ float smem[];
  const lgbt_seg::Seg sg = lgbt_seg::read_seg<false>(seg, lt, mode);
  const int chunks = hist_chunks(sg.cnt);
  if ((int)blockIdx.y >= chunks) return;
  lay.buf += (size_t)sg.src * plane_bytes;
  for (int chunk = blockIdx.y; chunk < chunks; chunk += gridDim.y) {
    hist_chunk<kNch, kThreads, kHistFeats>(lay, sg.start, sg.cnt, F, B,
                                           blockIdx.x * kHistFeats, chunk,
                                           smem, partial);
  }
}

// out (F, B, 3): per (feature, bin, channel) the chunk partials summed in
// chunk order, then hi + lo (exact mode).
template <int kNch>
__global__ void __launch_bounds__(kReduceBins * kNch)
reduce_kernel(const int* __restrict__ seg, const int* __restrict__ lt,
              int mode, const float* __restrict__ partial, int F, int B,
              float* __restrict__ out) {
  __shared__ float s[kReduceBins * kNch];
  const int chunks =
      hist_chunks(lgbt_seg::read_seg<false>(seg, lt, mode).cnt);
  const int fb0 = blockIdx.x * kReduceBins;
  const int t = threadIdx.x;
  const int fb = fb0 + t / kNch;
  if (fb < F * B) {
    s[t] = hist_sum(partial, chunks, (size_t)F * B * kNch,
                    (size_t)fb0 * kNch + t);
  }
  __syncthreads();
  if (t < kReduceBins && fb0 + t < F * B) {
    const float* v = s + t * kNch;
    float* dst = out + (size_t)(fb0 + t) * 3;
    dst[0] = kNch == 5 ? v[0] + v[1] : v[0];
    dst[1] = kNch == 5 ? v[2] + v[3] : v[1];
    dst[2] = kNch == 5 ? v[4] : v[2];
  }
}

// Raise the kernel's dynamic shared-memory limit once (smem.cuh).
template <int kNch, class L>
cudaError_t raise_hist_smem() {
  thread_local int raised[lgbt_smem::kMaxDevices] = {};
  return lgbt_smem::raise_once(
      reinterpret_cast<const void*>(hist_kernel<kNch, L>), raised);
}

template <int kNch, class L>
int launch_nch(L lay, size_t plane_bytes, const int* seg, const int* lt,
               int mode, int F, int B, int chunks, float* partial,
               float* out, cudaStream_t s) {
  const int smem = hist_smem_bytes(B, kNch, kHistFeats);
  cudaError_t e = raise_hist_smem<kNch, L>();
  if (e != cudaSuccess) return static_cast<int>(e);
  // x: the feature groups, so that blocks in flight share a chunk's rows
  // in L2
  dim3 grid((F + kHistFeats - 1) / kHistFeats, chunks);
  hist_kernel<kNch, L><<<grid, kThreads, smem, s>>>(lay, plane_bytes, seg,
                                                    lt, mode, F, B, partial);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_kernel<kNch><<<(F * B + kReduceBins - 1) / kReduceBins,
                        kReduceBins * kNch, 0, s>>>(seg, lt, mode, partial,
                                                    F, B, out);
  return static_cast<int>(cudaGetLastError());
}

// chunks: the grid's chunk rows (at least 1; its blocks stride over the
// segment's chunks); partial holds (hist_chunks(cnt), F, B, NCH) f32 for
// the largest segment the caller passes. mode and lt (segment_arg.cuh):
// seg is [plane, start, cnt] (kSegPlain), or a split's header and lt its
// left count (kSegSmaller: the smaller child's segment).
template <class L>
int launch_histogram(L lay, size_t plane_bytes, const void* seg,
                     const void* lt, int mode, int F, int B, int exact,
                     int chunks, void* partial, void* out, void* stream) {
  if (B < 1 || B > 256 || chunks < 1 ||
      (mode != lgbt_seg::kSegPlain && mode != lgbt_seg::kSegSmaller) ||
      (mode == lgbt_seg::kSegSmaller && lt == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sg = static_cast<const int*>(seg);
  const int* n = static_cast<const int*>(lt);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  return exact ? launch_nch<5>(lay, plane_bytes, sg, n, mode, F, B, chunks,
                               p, o, s)
               : launch_nch<3>(lay, plane_bytes, sg, n, mode, F, B, chunks,
                               p, o, s);
}

}  // namespace

extern "C" {

const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Planes layout: work is (2, W, npad).
int segment_histogram(const void* work, int W, int npad, const void* seg,
                      const void* lt, int mode, int F, int B, int exact,
                      int chunks, void* partial, void* out, void* stream) {
  const PackedRows<false> lay{static_cast<const uint8_t*>(work), W, npad, F};
  return launch_histogram(lay, (size_t)W * npad, seg, lt, mode, F, B, exact,
                          chunks, partial, out, stream);
}

// Rows layout: work is (2, npad, W).
int segment_histogram_rows(const void* work, int W, int npad, const void* seg,
                           const void* lt, int mode, int F, int B, int exact,
                           int chunks, void* partial, void* out,
                           void* stream) {
  const PackedRows<true> lay{static_cast<const uint8_t*>(work), W, npad, F};
  return launch_histogram(lay, (size_t)W * npad, seg, lt, mode, F, B, exact,
                          chunks, partial, out, stream);
}

// Resident layout: work is the (2, W, npad) slim pair, res the
// (F, npad_res) resident bin planes.
int segment_histogram_resident(const void* work, int W, int npad,
                               const void* seg, const void* lt, int mode,
                               const void* res, int npad_res, int F, int B,
                               int exact, int chunks, void* partial,
                               void* out, void* stream) {
  const ResidentRows lay{static_cast<const uint8_t*>(work), npad,
                         static_cast<const uint8_t*>(res), npad_res};
  return launch_histogram(lay, (size_t)W * npad, seg, lt, mode, F, B, exact,
                          chunks, partial, out, stream);
}

}  // extern "C"
