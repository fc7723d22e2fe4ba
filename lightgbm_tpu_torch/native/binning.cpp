// Threaded numerical bin application for Dataset construction (the port's
// copy of lightgbm_tpu/native/binning.cpp: the same contract and semantics,
// so both packages write the same bytes).
//
// The learner consumes a (rows, features) uint8 binned matrix; this builds
// it from raw doubles at memory bandwidth instead of one GIL-bound numpy
// searchsorted per feature (reference analog: the OpenMP loop around
// Dataset::PushData / BinMapper::ValueToBin, src/io/dataset.cpp:318,
// include/LightGBM/bin.h ValueToBin binary search; row blocks across
// std::thread workers here).
//
// Semantics mirror ops/binning.py BinMapper.value_to_bin (numerical):
//   bin = lower_bound(upper_bounds, v)        (first bound >= v)
//   NaN -> missing_bin when missing_type == NAN, else treated as 0.0
// Bounds end with +inf, so the result is always < n_bounds.
//
// Build: g++ -O3 -shared -fPIC -std=c++14 -pthread (io_native.py, at first
// use, into lightgbm_tpu_torch/_build/).

#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

inline int32_t lower_bound_idx(const double* b, int32_t n, double v) {
    int32_t lo = 0, hi = n;
    while (lo < hi) {
        int32_t mid = (lo + hi) >> 1;
        if (b[mid] < v) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    return lo;
}

constexpr int32_t kMissingNan = 2;

}  // namespace

extern "C" {

// X: (n, x_cols) row-major doubles.
// For each of `f` output features: col_idx[f] selects the X column,
// bounds + bounds_off give that feature's upper bounds (last = +inf),
// out_col[f] selects the destination column of `out` ((n, out_cols) u8).
void lgbm_apply_bins_u8(const double* X, int64_t n, int64_t x_cols,
                        int32_t f, const int32_t* col_idx,
                        const double* bounds, const int64_t* bounds_off,
                        const int32_t* n_bounds, const int32_t* missing_type,
                        const int32_t* missing_bin, uint8_t* out,
                        int64_t out_cols, const int32_t* out_col,
                        int32_t nthreads) {
    if (nthreads < 1) nthreads = 1;
    int64_t block = (n + nthreads - 1) / nthreads;
    std::vector<std::thread> threads;
    for (int t = 0; t < nthreads; ++t) {
        int64_t r0 = t * block;
        int64_t r1 = r0 + block < n ? r0 + block : n;
        if (r0 >= r1) break;
        threads.emplace_back([=]() {
            for (int64_t r = r0; r < r1; ++r) {
                const double* xrow = X + r * x_cols;
                uint8_t* orow = out + r * out_cols;
                for (int32_t j = 0; j < f; ++j) {
                    double v = xrow[col_idx[j]];
                    const double* b = bounds + bounds_off[j];
                    int32_t bin;
                    if (std::isnan(v)) {
                        bin = missing_type[j] == kMissingNan
                                  ? missing_bin[j]
                                  : lower_bound_idx(b, n_bounds[j], 0.0);
                    } else {
                        bin = lower_bound_idx(b, n_bounds[j], v);
                    }
                    orow[out_col[j]] = static_cast<uint8_t>(bin);
                }
            }
        });
    }
    for (auto& th : threads) th.join();
}

}  // extern "C"
