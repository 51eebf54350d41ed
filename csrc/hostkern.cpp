// hostkern: native host-side kernels for vaex_tpu.
//
// Re-design of the host-resident parts of the reference's C++
// layer (vaex-core/src).  The device compute path is XLA/Pallas; what remains
// on the host — row-mask bookkeeping (reference superutils.cpp Mask),
// hash-partitioning for the multi-host shuffle (reference hash.hpp _hash64 +
// sharded maps), NaN-aware min/max scans over mmap'd columns (reference
// vaexfast.cpp find_nan_min_max) and gather for join materialization — is
// implemented here with std::thread parallelism and exposed through a plain
// C ABI consumed via ctypes (no pybind11 dependency).
//
// Build: make -C csrc   (g++ -O3 -shared -fPIC -pthread)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

int worker_count(int64_t n, int64_t grain = 1 << 16) {
    unsigned hw = std::thread::hardware_concurrency();
    if (hw == 0) hw = 4;
    int64_t by_grain = (n + grain - 1) / grain;
    return static_cast<int>(std::max<int64_t>(1, std::min<int64_t>(hw, by_grain)));
}

template <typename F>
void parallel_for(int64_t n, F&& f) {
    int nw = worker_count(n);
    if (nw == 1) {
        f(0, 0, n);
        return;
    }
    std::vector<std::thread> threads;
    int64_t chunk = (n + nw - 1) / nw;
    for (int w = 0; w < nw; w++) {
        int64_t lo = w * chunk;
        int64_t hi = std::min<int64_t>(lo + chunk, n);
        if (lo >= hi) break;
        threads.emplace_back([&, w, lo, hi] { f(w, lo, hi); });
    }
    for (auto& t : threads) t.join();
}

// murmur-style 64-bit finalizer (role of reference hash.hpp:25-30 _hash64)
inline uint64_t hash64(uint64_t v) {
    v ^= v >> 33;
    v *= 0xff51afd7ed558ccdULL;
    v ^= v >> 33;
    v *= 0xc4ceb9fe1a85ec53ULL;
    v ^= v >> 33;
    return v;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Mask ops (reference superutils.cpp Mask: count/indices/logical->raw)

// count set bytes in a boolean mask
int64_t mask_count(const uint8_t* mask, int64_t n) {
    std::atomic<int64_t> total{0};
    parallel_for(n, [&](int, int64_t lo, int64_t hi) {
        int64_t local = 0;
        for (int64_t i = lo; i < hi; i++) local += mask[i] != 0;
        total += local;
    });
    return total.load();
}

// raw indices of set rows; returns number written (reference Mask::indices)
int64_t mask_indices(const uint8_t* mask, int64_t n, int64_t* out) {
    int nw = worker_count(n);
    std::vector<int64_t> counts(nw + 1, 0);
    int64_t chunk = (n + nw - 1) / nw;
    parallel_for(n, [&](int w, int64_t lo, int64_t hi) {
        int64_t local = 0;
        for (int64_t i = lo; i < hi; i++) local += mask[i] != 0;
        counts[w + 1] = local;
    });
    for (int w = 0; w < nw; w++) counts[w + 1] += counts[w];
    parallel_for(n, [&](int w, int64_t lo, int64_t hi) {
        int64_t pos = counts[w];
        for (int64_t i = lo; i < hi; i++)
            if (mask[i]) out[pos++] = i;
    });
    (void)chunk;
    return counts[nw];
}

// logical row range -> raw row range through a mask (reference Mask::indices(i1,i2))
void mask_logical_to_raw(const uint8_t* mask, int64_t n, int64_t logical_i1,
                         int64_t logical_i2, int64_t* raw_i1, int64_t* raw_i2) {
    int64_t seen = 0;
    int64_t r1 = -1, r2 = n;
    for (int64_t i = 0; i < n; i++) {
        if (mask[i]) {
            if (seen == logical_i1 && r1 < 0) r1 = i;
            seen++;
            if (seen == logical_i2) {
                r2 = i + 1;
                break;
            }
        }
    }
    *raw_i1 = r1 < 0 ? n : r1;
    *raw_i2 = r2;
}

// ---------------------------------------------------------------------------
// Hash partitioning (the host side of the distributed shuffle: reference
// hash.hpp sharded maps / north-star all-to-all partitioning)

void hash_partition_i64(const int64_t* keys, int64_t n, int32_t nparts,
                        int32_t* out_parts) {
    parallel_for(n, [&](int, int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; i++)
            out_parts[i] = static_cast<int32_t>(hash64(static_cast<uint64_t>(keys[i])) % nparts);
    });
}

// per-partition counts (for shuffle buffer allocation)
void partition_counts(const int32_t* parts, int64_t n, int32_t nparts, int64_t* out_counts) {
    int nw = worker_count(n);
    std::vector<std::vector<int64_t>> local(nw, std::vector<int64_t>(nparts, 0));
    parallel_for(n, [&](int w, int64_t lo, int64_t hi) {
        auto& c = local[w];
        for (int64_t i = lo; i < hi; i++) c[parts[i]]++;
    });
    std::memset(out_counts, 0, sizeof(int64_t) * nparts);
    for (int w = 0; w < nw; w++)
        for (int32_t p = 0; p < nparts; p++) out_counts[p] += local[w][p];
}

// stable scatter of row indices into partition-contiguous order
void partition_scatter(const int32_t* parts, int64_t n, int32_t nparts,
                       const int64_t* offsets /* nparts, exclusive prefix */,
                       int64_t* out_indices) {
    std::vector<int64_t> cursor(offsets, offsets + nparts);
    for (int64_t i = 0; i < n; i++) out_indices[cursor[parts[i]]++] = i;
}

// ---------------------------------------------------------------------------
// NaN-aware min/max scan (reference vaexfast.cpp find_nan_min_max)

void minmax_f64(const double* data, int64_t n, double* out_min, double* out_max) {
    int nw = worker_count(n);
    std::vector<double> mins(nw, std::numeric_limits<double>::infinity());
    std::vector<double> maxs(nw, -std::numeric_limits<double>::infinity());
    parallel_for(n, [&](int w, int64_t lo, int64_t hi) {
        double mn = std::numeric_limits<double>::infinity();
        double mx = -std::numeric_limits<double>::infinity();
        for (int64_t i = lo; i < hi; i++) {
            double v = data[i];
            if (std::isnan(v)) continue;
            mn = std::min(mn, v);
            mx = std::max(mx, v);
        }
        mins[w] = mn;
        maxs[w] = mx;
    });
    double mn = mins[0], mx = maxs[0];
    for (int w = 1; w < nw; w++) {
        mn = std::min(mn, mins[w]);
        mx = std::max(mx, maxs[w]);
    }
    *out_min = mn;
    *out_max = mx;
}

void minmax_i64(const int64_t* data, int64_t n, int64_t* out_min, int64_t* out_max) {
    int nw = worker_count(n);
    std::vector<int64_t> mins(nw, std::numeric_limits<int64_t>::max());
    std::vector<int64_t> maxs(nw, std::numeric_limits<int64_t>::min());
    parallel_for(n, [&](int w, int64_t lo, int64_t hi) {
        int64_t mn = std::numeric_limits<int64_t>::max();
        int64_t mx = std::numeric_limits<int64_t>::min();
        for (int64_t i = lo; i < hi; i++) {
            mn = std::min(mn, data[i]);
            mx = std::max(mx, data[i]);
        }
        mins[w] = mn;
        maxs[w] = mx;
    });
    int64_t mn = mins[0], mx = maxs[0];
    for (int w = 1; w < nw; w++) {
        mn = std::min(mn, mins[w]);
        mx = std::max(mx, maxs[w]);
    }
    *out_min = mn;
    *out_max = mx;
}

// ---------------------------------------------------------------------------
// Join probe: parallel binary search of left keys in the sorted right keys
// (reference hash_primitives.hpp:679 map_index — the hashmap probe becomes
// a lower_bound on the sorted index)

void map_index_i64(const int64_t* sorted_keys, const int64_t* sorted_rows,
                   int64_t n_right, const int64_t* left_keys, int64_t n_left,
                   int64_t* out_rows) {
    parallel_for(n_left, [&](int, int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; i++) {
            int64_t key = left_keys[i];
            const int64_t* it = std::lower_bound(sorted_keys, sorted_keys + n_right, key);
            out_rows[i] = (it != sorted_keys + n_right && *it == key)
                              ? sorted_rows[it - sorted_keys]
                              : -1;
        }
    });
}

void map_index_f64(const double* sorted_keys, const int64_t* sorted_rows,
                   int64_t n_right, const double* left_keys, int64_t n_left,
                   int64_t* out_rows) {
    parallel_for(n_left, [&](int, int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; i++) {
            double key = left_keys[i];
            if (std::isnan(key)) {
                out_rows[i] = -1;
                continue;
            }
            const double* it = std::lower_bound(sorted_keys, sorted_keys + n_right, key);
            out_rows[i] = (it != sorted_keys + n_right && *it == key)
                              ? sorted_rows[it - sorted_keys]
                              : -1;
        }
    });
}

// ---------------------------------------------------------------------------
// Parallel gather (join materialization; reference ColumnIndexed hot path)

void take_f64(const double* src, const int64_t* indices, int64_t n, double* out) {
    parallel_for(n, [&](int, int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; i++) out[i] = src[indices[i]];
    });
}

void take_i64(const int64_t* src, const int64_t* indices, int64_t n, int64_t* out) {
    parallel_for(n, [&](int, int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; i++) out[i] = src[indices[i]];
    });
}

// masked gather: negative index -> fill slot and set out_mask
void take_masked_f64(const double* src, const int64_t* indices, int64_t n,
                     double* out, uint8_t* out_mask) {
    parallel_for(n, [&](int, int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; i++) {
            int64_t idx = indices[i];
            if (idx < 0) {
                out[i] = 0.0;
                out_mask[i] = 1;
            } else {
                out[i] = src[idx];
                out_mask[i] = 0;
            }
        }
    });
}

}  // extern "C"
