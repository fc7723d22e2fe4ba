// Row router: one tree's split log -> a leaf id per row, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/route.py:route_rows (pallas_call
// "route_rows", body _route_kernel). Same contract: transposed bins
// (F, npad/128, 128) u8 (or, past the TPU kernel, u16: the dense builder's
// matrices past 256 bins, entry point route_rows_u16), a
// (R * TBL_W) i32 table with TBL_W = 10 columns per
// round (col, leaf, bin, miss, dl, plain, off, dpos, nbm1, rest) and the
// device scalar num_splits -> (npad,) i32 leaf ids, equal to applying
// rounds 0 .. min(num_splits, R) - 1 in order (a row at leaf `leaf` that
// goes right moves to leaf r + 1). Numerical splits with the
// movable-missing override, and the EFB bundle arithmetic: a bundled
// column's slot maps back to the sub-feature's bin (slots at or above the
// shared default position shift up by one) and slots outside the
// sub-feature's range follow the default bin's direction (rest). Beyond
// the TPU kernel, categorical splits: given the (R * (1 + W)) categorical
// table (ops/route.build_cat_table: per round a kind flag and the split's
// go-left set of 32 W bits, W = 8 for u8 bins), a categorical round sends a
// row left when its column's bin is in the set, as the JAX package's
// round-by-round assign_leaves does with its (B,) table
// (lightgbm_tpu/learner.py).
//
// What bounds it on this card: bytes. It reads one u8 (u16) per (column,
// row) and writes one i32 per row: 2M x 28 rows move ~64 MB, ~0.019 ms at
// 3.35 TB/s. A row's own work is one table entry and one bin per level of
// its path, ~depth steps.
//
// Design: a walk per row, not a loop over every round.
//   prologue (once per block of a grid that strides tiles of rows): the
//     table goes to shared memory as 32-byte entries, and each round gets
//     its two child links: next_left[r], the first round r' > r that
//     splits the same leaf (the left child keeps the leaf id), and
//     next_right[r], the first round r' > r that splits leaf r + 1 (the
//     right child's id). They come from the rounds' keys (leaf << 16 | r)
//     sorted in shared memory (a bitonic sort, O(R log^2 R) over the
//     block): a round's next_left is the next key if it has the same leaf;
//     its next_right, and the first round that splits leaf 0 (where every
//     row starts), are binary searches. Only rounds below ns =
//     min(num_splits, R) are keyed, so padded rounds (the learner pads
//     unused rounds with leaf 0) are never followed; a missing link ends
//     the walk. A row then follows ~depth links instead of R rounds.
//   tiles: a block stages a tile's F byte stripes (each plane's T bytes
//     are contiguous and 16-byte aligned) with 16-byte cp.async, double
//     buffered (the first tile's copy overlaps the prologue, the next
//     tile's the walk), so each plane is read once and coalesced; rows
//     that diverge in the tree then read shared memory, not up to 32
//     sectors of 32 planes. A thread walks one row and writes its id (a
//     warp writes 128 consecutive bytes); eight blocks share an SM, so
//     their warps hide each other's chains of dependent loads.
//   categorical rounds (kCat): the set's W words go to shared memory beside
//     the entries (4 W bytes a round more), and the round's entry carries
//     bin = kCatBin; its step is one word load and a shift (a bin past the
//     set's 32 W bits is not in it).
//   steps: a numerical round is one 16-byte entry {col, bin, miss', links}
//     and about a dozen instructions: go left = (c <= bin) xor (c ==
//     miss'), where miss' is the movable-missing bin only where its
//     default direction differs from the threshold's (else -1, which no
//     bin matches). A bundle round (col stored as ~col) reads a second
//     entry {off, dpos, nbm1, rest} and maps the slot first. When the
//     table and even the tiles of every plane exceed a block's shared
//     memory, the walk reads the bins from device memory.
// num_splits stays on the device (no host sync between the tree builder
// and the router).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;              // one row a thread: T = 256
constexpr int kTblW = 10;
constexpr int kCatBin = -0x7fffffff;       // a categorical round's bin
constexpr int kStripePad = 16;
constexpr int kEnd = 0xffff;               // no link: the walk ends
constexpr unsigned kNoKey = 0xffffffffu;
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

__device__ __forceinline__ void cp_async_wait(bool one_in_flight) {
  if (one_in_flight) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

// The first position of the n sorted keys whose key is >= x.
__device__ __forceinline__ int lower_bound(const unsigned* key, int n,
                                           unsigned x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <typename E, bool kStaged, bool kCat>
__global__ void __launch_bounds__(kThreads)
route_walk_kernel(const E* __restrict__ bins_t, int F, int npad,
                  const int* __restrict__ table, int rounds,
                  const int* __restrict__ num_splits,
                  const int* __restrict__ cat, int cat_words,
                  int* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t s_dyn[];
  // per round: e = {col (~col for a bundle round), bin (kCatBin for a
  // categorical round), miss', links}, f = {off, dpos, nbm1, rest}; with
  // kCat each round's go-left set (cat_words words); then the sort keys
  int4* s_e = reinterpret_cast<int4*>(s_dyn);
  int4* s_f = s_e + rounds;
  unsigned* s_set = reinterpret_cast<unsigned*>(s_f + rounds);
  const int cw = kCat ? cat_words : 0;
  unsigned* s_key = s_set + (size_t)cw * rounds;
  int nkeys = 1;
  while (nkeys < rounds) nkeys <<= 1;
  const size_t ent = (size_t)rounds * (32 + 4 * cw);
  uint8_t* s_bins = s_dyn + ((ent + (size_t)nkeys * 4 + 15) & ~(size_t)15);
  constexpr int T = kThreads;
  constexpr int E16 = 16 / (int)sizeof(E);   // bins in 16 bytes
  constexpr int stripe = T + kStripePad / (int)sizeof(E);   // in bins
  const int buf_bytes = F * stripe * (int)sizeof(E);
  const int tiles = (npad + T - 1) / T;
  // stage tile `tile` into buffer `b`; one commit group per thread
  auto stage = [&](int tile, int b) {
    const size_t row0 = (size_t)tile * T;
    constexpr int nch = T / E16;         // npad: a multiple of 128 >= T / 2
    const int per = min(nch, static_cast<int>((npad - row0) / E16));
    const int items = F * per;
    E* to = reinterpret_cast<E*>(s_bins + b * buf_bytes);
    for (int k = threadIdx.x; k < items; k += kThreads) {
      const int f = k / per, c = k - f * per;
      cp_async16(to + f * stripe + E16 * c,
                 bins_t + (size_t)f * npad + row0 + E16 * c);
    }
    cp_async_commit();
  };
  if (kStaged && (int)blockIdx.x < tiles) stage(blockIdx.x, 0);

  // ---- prologue: entries, keys, links
  const int ns = max(0, min(*num_splits, rounds));
  for (int r = threadIdx.x; r < nkeys; r += kThreads) {
    unsigned key = kNoKey;
    if (r < ns) {
      const int* t = table + (size_t)r * kTblW;
      const int col = t[0], leaf = t[1], bin = t[2], miss = t[3];
      const bool dl = t[4] != 0, plain = t[5] == 1;
      // the missing bin overrides only where it changes the direction
      const int missx = miss >= 0 && dl != (miss <= bin) ? miss : -1;
      const bool is_cat = kCat && cat[(size_t)r * (1 + cw)] > 0;
      s_e[r] = is_cat ? make_int4(col, kCatBin, -1, 0)
                      : make_int4(plain ? col : ~col, bin, missx, 0);
      s_f[r] = make_int4(t[6], t[7], t[8], t[9] != 0);
      if (kCat) {
        for (int w = 0; w < cw; ++w) {
          s_set[(size_t)r * cw + w] =
              static_cast<unsigned>(cat[(size_t)r * (1 + cw) + 1 + w]);
        }
      }
      // a leaf id past R never matches a row's leaf: such a round is
      // never reached
      if (leaf >= 0 && leaf <= rounds) {
        key = static_cast<unsigned>(leaf) << 16 | static_cast<unsigned>(r);
      }
    }
    s_key[r] = key;
  }
  __syncthreads();
  for (int k = 2; k <= nkeys; k <<= 1) {        // bitonic sort, ascending
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < nkeys; i += kThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned a = s_key[i], b = s_key[ixj];
          if ((a > b) == ((i & k) == 0)) {
            s_key[i] = b;
            s_key[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int p = threadIdx.x; p < nkeys; p += kThreads) {
    const unsigned key = s_key[p];
    if (key == kNoKey) continue;
    const int r = static_cast<int>(key & 0xffffu);
    const unsigned nxt = p + 1 < nkeys ? s_key[p + 1] : kNoKey;
    const int nl = nxt != kNoKey && (nxt >> 16) == (key >> 16)
                       ? static_cast<int>(nxt & 0xffffu) : kEnd;
    const unsigned right = static_cast<unsigned>(r + 1);
    const int q = lower_bound(s_key, nkeys, right << 16 | right);
    const unsigned kq = q < nkeys ? s_key[q] : kNoKey;
    const int nr = kq != kNoKey && (kq >> 16) == right
                       ? static_cast<int>(kq & 0xffffu) : kEnd;
    s_e[r].w = static_cast<int>(static_cast<unsigned>(nl) |
                                static_cast<unsigned>(nr) << 16);
  }
  const unsigned k0 = s_key[0];
  const int first = ns > 0 && k0 != kNoKey && (k0 >> 16) == 0
                        ? static_cast<int>(k0 & 0xffffu) : kEnd;
  __syncthreads();

  // ---- tiles: each thread walks its row from `first` along the links
  int b = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const size_t row0 = (size_t)tile * T;
    if (kStaged) {
      const bool more = tile + (int)gridDim.x < tiles;
      if (more) stage(tile + gridDim.x, b ^ 1);
      cp_async_wait(more);
      __syncthreads();
    }
    const size_t row = row0 + threadIdx.x;
    if (row < (size_t)npad) {
      const E* base =
          kStaged ? reinterpret_cast<const E*>(s_bins + b * buf_bytes) +
                        threadIdx.x
                  : bins_t + row;
      const size_t stride = kStaged ? stripe : npad;
      int r = first, state = 0;
      while (r < ns) {
        const int4 e = s_e[r];
        bool go;
        if (e.x >= 0) {
          const int c = base[e.x * stride];
          if (kCat && e.y == kCatBin) {  // a categorical round: c in the set
            go = (c >> 5) < cw &&
                 ((s_set[(size_t)r * cw + (c >> 5)] >> (c & 31)) & 1u);
          } else {
            go = (c <= e.y) != (c == e.z);
          }
        } else {                       // a bundle column's slot
          const int4 f = s_f[r];
          const int c = base[~e.x * stride];
          const int rank = c - f.x;
          const int eff = rank + (rank >= f.y ? 1 : 0);
          go = rank >= 0 && rank < f.z ? (eff <= e.y) != (eff == e.z)
                                       : f.w != 0;
        }
        const unsigned links = static_cast<unsigned>(e.w);
        if (!go) state = r + 1;
        r = static_cast<int>(go ? links & 0xffffu : links >> 16);
      }
      out[row] = state;
    }
    if (kStaged) {
      __syncthreads();               // the buffer is free for a later tile
      b ^= 1;
    }
  }
}

// Raise every variant's dynamic shared-memory limit to the most a block
// may take, once per device.
cudaError_t raise_smem() {
  thread_local bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (raised[dev]) return cudaSuccess;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  const void* fns[] = {
      reinterpret_cast<const void*>(route_walk_kernel<uint8_t, true, false>),
      reinterpret_cast<const void*>(route_walk_kernel<uint8_t, false, false>),
      reinterpret_cast<const void*>(route_walk_kernel<uint8_t, true, true>),
      reinterpret_cast<const void*>(route_walk_kernel<uint8_t, false, true>),
      reinterpret_cast<const void*>(route_walk_kernel<uint16_t, true, false>),
      reinterpret_cast<const void*>(
          route_walk_kernel<uint16_t, false, false>),
      reinterpret_cast<const void*>(route_walk_kernel<uint16_t, true, true>),
      reinterpret_cast<const void*>(
          route_walk_kernel<uint16_t, false, true>)};
  for (const void* fn : fns) {
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, fn);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(fa.sharedSizeBytes));
    if (e != cudaSuccess) return e;
  }
  raised[dev] = true;
  return cudaSuccess;
}

template <typename E>
int launch_route(const void* bins_t, int F, int npad, const void* table,
                 int rounds, const void* num_splits, const void* cat,
                 int cat_words, int staged, int grid, int smem, void* out,
                 void* stream) {
  if (F < 1 || npad % 128 || rounds < 0 || rounds >= kEnd || grid < 1 ||
      smem < 0 || (cat != nullptr && cat_words < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = raise_smem();
  if (e != cudaSuccess) return static_cast<int>(e);
  const E* b = static_cast<const E*>(bins_t);
  const int* t = static_cast<const int*>(table);
  const int* ns = static_cast<const int*>(num_splits);
  const int* c = static_cast<const int*>(cat);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = staged ? (c ? route_walk_kernel<E, true, true>
                            : route_walk_kernel<E, true, false>)
                       : (c ? route_walk_kernel<E, false, true>
                            : route_walk_kernel<E, false, false>);
  kernel<<<grid, kThreads, smem, s>>>(b, F, npad, t, rounds, ns, c,
                                      cat_words, o);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* lgbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// staged, grid and the dynamic shared memory smem come from
// ops/route.route_plan.
int route_rows(const void* bins_t, int F, int npad, const void* table,
               int rounds, const void* num_splits, int staged, int grid,
               int smem, void* out, void* stream) {
  return launch_route<uint8_t>(bins_t, F, npad, table, rounds, num_splits,
                               nullptr, 0, staged, grid, smem, out, stream);
}

// The same with the (rounds * (1 + 8)) categorical table `cat`:
// categorical rounds go by their go-left sets.
int route_rows_cat(const void* bins_t, int F, int npad, const void* table,
                   int rounds, const void* num_splits, const void* cat,
                   int staged, int grid, int smem, void* out,
                   void* stream) {
  if (cat == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_route<uint8_t>(bins_t, F, npad, table, rounds, num_splits,
                               cat, 8, staged, grid, smem, out, stream);
}

// The router over u16 bins: `cat` null (numerical and bundle rounds
// only), or the (rounds * (1 + cat_words)) categorical table.
int route_rows_u16(const void* bins_t, int F, int npad, const void* table,
                   int rounds, const void* num_splits, const void* cat,
                   int cat_words, int staged, int grid, int smem, void* out,
                   void* stream) {
  return launch_route<uint16_t>(bins_t, F, npad, table, rounds, num_splits,
                                cat, cat_words, staged, grid, smem, out,
                                stream);
}

}  // extern "C"
