// int8 quantized g/h/count histogram of one leaf's segment of the rows work
// buffer (K5), for Hopper (sm_90a): one cluster launch per call.
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
// What bounds it on this card: bytes by the count (a row is read once:
// F + 3 bytes, 31 B at F = 28, 62 MB for a 2M-row segment, ~0.019 ms at
// 3.35 TB/s), shared-memory atomics in practice: up to three per (row,
// feature), ~134M for the 2M-row root of the quantized model (1.6M rows in
// bag). Rows with a zero channel skip that add (adding zero changes
// nothing), so out-of-bag rows cost only their read.
//
// Design, one launch: grid (row blocks, feature groups) in clusters of
// `cluster` row blocks (8, fewer for small segments); 512 threads, one
// block per SM.
//   - Each block keeps the int32 (nfb, B, 3) histogram of its feature
//     group in shared memory (F = 28, B = 256: 86 KB).
//   - The segment's 32-row steps are dealt out to the grid's warps. A warp
//     stages its next steps' rows (one contiguous run of 32 W bytes each)
//     into its own ring of shared-memory slots with 16-byte cp.async, three
//     steps ahead, and reads each lane's row from there (rows too wide for
//     the ring are read in place: kStaged false).
//   - Merge: the cluster's blocks meet at a barrier; block r of the
//     cluster adds slice r of all its blocks' histograms (read through
//     distributed shared memory). A feature group with one cluster writes
//     its slices dequantized straight to `out`. Otherwise each cluster
//     adds its slices into the int32 accumulator `acc` with global atomics
//     (one merge per cluster, not per block), and the cluster that takes
//     the last ticket (an atomicAdd after a __threadfence) dequantizes acc
//     into `out`, each block a share, and zeroes acc and the ticket for
//     the next call: no memset, no second kernel. acc and the ticket are
//     kept by the wrapper per device and stream, zero between calls.
//   - The grid asks for a row block per 2048 rows, at most 128; the entry
//     point cuts it to the clusters the card runs at once
//     (cudaOccupancyMaxActiveClusters), so a 2M-row root runs in one wave
//     (uncut, 128 blocks in clusters of 8 ran slower than 128 plain blocks
//     there: a second wave).
// Tried on the card and left out (A/B in one call, NVIDIA H100 80GB HBM3,
// 700 W): a per-warp "hot bin" aggregation of the skewed three-valued
// features (redux.sync over the lanes on the bin) cost more than the
// serialised atomics it saved; g, h and cnt packed into one 64-bit shared
// atomic (one add per feature, unpacked every 8,192 rows) was slower
// still.
// int32 holds 127 * N for N <= 16,909,320 rows per leaf; the wrapper
// refuses larger segments.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRing = 4;          // staged steps per warp: 3 ahead
constexpr int kMaxCluster = 8;
constexpr int kDequantBatch = 8;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 1) : "memory");
}

__host__ __device__ __forceinline__ int step_bytes(int W) {
  return (32 * W + 31) / 16 * 16;   // 32 rows and the 16-byte head pad
}

__host__ __device__ __forceinline__ int hist_bytes(int nfb, int B) {
  return (nfb * B * 3 * 4 + 15) / 16 * 16;
}

// Stage rows [32 s, 32 s + 32) of the segment (from `rows`, row i at
// rows + i * W) into `slot` as the aligned 16-byte chunks that cover them:
// the warp's lanes issue the copies; one commit group per lane (empty
// when s is past the segment). Byte k of the run lands at slot + (the
// run's address mod 16) + k.
__device__ __forceinline__ void stage_step(uint8_t* slot, const uint8_t* rows,
                                           long s, long nsteps, int cnt,
                                           int W, int lane) {
  if (s < nsteps) {
    const uint8_t* g = rows + (size_t)s * 32 * W;
    const int n = static_cast<int>(min(32L, cnt - s * 32));
    const int pad = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
    const int chunks = (pad + n * W + 15) >> 4;
    for (int c = lane; c < chunks; c += 32) {
      cp_async16(slot + 16 * c, g - pad + 16 * c);
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ void add3(int* hb, int g, int h, int c) {
  if (g) atomicAdd(hb, g);
  if (h) atomicAdd(hb + 1, h);
  if (c) atomicAdd(hb + 2, c);
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads, 1)
hist_q_kernel(const uint8_t* __restrict__ work, int W, int npad,
              const int* __restrict__ seg, int F, int B, int nfb,
              const float* __restrict__ scale, int* acc, unsigned* ticket,
              float* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f0 = blockIdx.y * nfb;
  const int nf = min(nfb, F - f0);
  const int len = nf * B * 3;
  int* s_hist = reinterpret_cast<int*>(smem);
  const int sb = kStaged ? step_bytes(W) : 0;
  uint8_t* ring = smem + hist_bytes(nfb, B) + (size_t)warp * kRing * sb;
  for (int k = threadIdx.x; k < len; k += kThreads) s_hist[k] = 0;
  __syncthreads();

  const int plane = seg[0], start = seg[1], cnt = seg[2];
  const uint8_t* rows = work + ((size_t)plane * npad + start) * W;
  const long nsteps = (cnt + 31) / 32;
  const long gw = (long)blockIdx.x * kWarps + warp;
  const long stride = (long)gridDim.x * kWarps;
  if (kStaged) {
#pragma unroll
    for (int k = 0; k < kRing - 1; ++k) {
      stage_step(ring + k * sb, rows, gw + k * stride, nsteps, cnt, W, lane);
    }
  }
  for (long k = 0, s = gw; s < nsteps; ++k, s += stride) {
    const uint8_t* row = rows + ((size_t)s * 32 + lane) * W;
    if (kStaged) {
      stage_step(ring + ((k + kRing - 1) % kRing) * sb, rows,
                 s + (kRing - 1) * stride, nsteps, cnt, W, lane);
      cp_async_wait_ring();          // step s has landed
      __syncwarp();
      row = ring + (k % kRing) * sb +
            (reinterpret_cast<uintptr_t>(rows + (size_t)s * 32 * W) & 15) +
            lane * W;
    }
    int g = 0, h = 0, c = 0;
    if (s * 32 + lane < cnt) {
      g = static_cast<int8_t>(row[F]);
      h = static_cast<int8_t>(row[F + 1]);
      c = row[F + 2];
    }
    if ((g | h | c) != 0) {           // an out-of-bag row costs its read
      for (int f = 0; f < nf; ++f) {
        const int b = row[f0 + f];
        if (b < B) add3(s_hist + (f * B + b) * 3, g, h, c);
      }
    }
    __syncwarp();                    // the slot is free
  }
  __syncthreads();

  // merge: block r of the cluster adds slice r of every block's histogram
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const int csize = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const bool alone = gridDim.x == static_cast<unsigned>(csize);
  const int per = (len + csize - 1) / csize;
  const int lo = rank * per;
  const int hi = min(len, lo + per);
  const size_t base = (size_t)f0 * B * 3;
  for (int k = lo + threadIdx.x; k < hi; k += kThreads) {
    int v[kMaxCluster];              // the cluster's loads in flight at once
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      v[q] = q < csize ? cl.map_shared_rank(s_hist, q)[k] : 0;
    }
    int sum = 0;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) sum += v[q];
    if (alone) {                     // the feature group's only cluster
      out[base + k] = __fmul_rn(__int2float_rn(sum), scale[k % 3]);
    } else if (sum) {
      atomicAdd(acc + base + k, sum);
    }
  }
  __threadfence();
  cl.sync();                         // every slice read (and merged)
  if (alone) return;

  // the cluster that takes the last ticket dequantizes acc, each of its
  // blocks a share, and zeroes acc and the ticket for the next call
  if (rank == 0 && threadIdx.x == 0) {
    const unsigned t = atomicAdd(ticket, 1u);
    const int last = t == (gridDim.x / csize) * gridDim.y - 1;
    if (last) *ticket = 0u;
    for (int q = 0; q < csize; ++q) *cl.map_shared_rank(&s_last, q) = last;
  }
  cl.sync();
  if (!s_last) return;
  __threadfence();
  const int n = F * B * 3;
  const int share = (n + csize - 1) / csize;
  const int end = min(n, (rank + 1) * share);
  for (int k0 = rank * share + threadIdx.x; k0 < end;
       k0 += kDequantBatch * kThreads) {
    int v[kDequantBatch];            // a batch of loads in flight at once
#pragma unroll
    for (int j = 0; j < kDequantBatch; ++j) {
      const int k = k0 + j * kThreads;
      v[j] = k < end ? __ldcg(acc + k) : 0;
    }
#pragma unroll
    for (int j = 0; j < kDequantBatch; ++j) {
      const int k = k0 + j * kThreads;
      if (k < end) {
        out[k] = __fmul_rn(__int2float_rn(v[j]), scale[k % 3]);
        acc[k] = 0;
      }
    }
  }
}

// Let `kernel` take the most dynamic shared memory a block may have.
template <typename K>
cudaError_t raise_smem_limit(K kernel, int dev) {
  int optin = 0;
  cudaFuncAttributes fa;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              optin - static_cast<int>(fa.sharedSizeBytes));
}

// The clusters of `cfg`'s shape the card runs at once, from a small
// per-thread cache (a run's launches use a few shapes). The first query on
// a device also raises both kernels' dynamic shared-memory limit to the
// most a block may take, once.
template <typename K>
cudaError_t max_clusters(K kernel, bool staged, const cudaLaunchConfig_t* cfg,
                         int* out) {
  constexpr int kCache = 16;
  thread_local bool raised[kMaxDevices] = {};
  thread_local int c_dev[kCache], c_cl[kCache], c_most[kCache], c_n = 0;
  thread_local size_t c_smem[kCache];
  thread_local bool c_staged[kCache];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const int cl = static_cast<int>(cfg->attrs[0].val.clusterDim.x);
  for (int i = 0; i < c_n; ++i) {
    if (c_dev[i] == dev && c_cl[i] == cl && c_smem[i] == cfg->dynamicSmemBytes
        && c_staged[i] == staged) {
      *out = c_most[i];
      return cudaSuccess;
    }
  }
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    e = raise_smem_limit(hist_q_kernel<true>, dev);
    if (e == cudaSuccess) e = raise_smem_limit(hist_q_kernel<false>, dev);
    if (e != cudaSuccess) return e;
    raised[dev] = true;
  }
  int most = 0;
  e = cudaOccupancyMaxActiveClusters(&most, kernel, cfg);
  if (e != cudaSuccess) return e;
  if (most < 1) return cudaErrorInvalidConfiguration;
  const int i = c_n < kCache ? c_n++ : kCache - 1;
  c_dev[i] = dev;
  c_cl[i] = cl;
  c_smem[i] = cfg->dynamicSmemBytes;
  c_staged[i] = staged;
  c_most[i] = most;
  *out = most;
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// work (2, npad, W) u8; seg [plane, start, cnt] i32; scale (3,) f32; acc
// (F, B, 3) i32 and ticket (1,) u32, zero on entry and left zero; out
// (F, B, 3) f32. feats_per_block (the feature groups, grid.y), row_blocks
// (grid.x, a multiple of cluster), cluster and staged (rows staged through
// shared memory, else read in place) come from ops/histogram.hist_q_plan.
// row_blocks is cut to the clusters the card runs at once (the kernel
// walks the segment grid-stride, so any grid gives the same sums).
int segment_histogram_q(const void* work, int W, int npad, const void* seg,
                        int F, int B, int feats_per_block, int row_blocks,
                        int cluster, int staged, const void* scale,
                        void* acc, void* ticket, void* out, void* stream) {
  if (F < 1 || B < 1 || B > 256 || W != F + 3 || feats_per_block < 1 ||
      cluster < 1 || cluster > kMaxCluster || row_blocks < cluster ||
      row_blocks % cluster != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = staged ? hist_q_kernel<true> : hist_q_kernel<false>;
  const int groups = (F + feats_per_block - 1) / feats_per_block;
  const size_t smem =
      static_cast<size_t>(hist_bytes(feats_per_block, B)) +
      (staged ? static_cast<size_t>(kWarps) * kRing * step_bytes(W) : 0);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_blocks, groups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int most = 0;
  cudaError_t e = max_clusters(kernel, staged != 0, &cfg, &most);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int fit = most / groups * cluster;   // row blocks of one wave
  if (row_blocks > cluster && row_blocks > fit) {
    cfg.gridDim.x = fit > cluster ? fit : cluster;
  }
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const uint8_t*>(work), W,
                         npad, static_cast<const int*>(seg), F, B,
                         feats_per_block, static_cast<const float*>(scale),
                         static_cast<int*>(acc),
                         static_cast<unsigned*>(ticket),
                         static_cast<float*>(out));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
