// Shadow-column cleanup hot loop: drop XZ-grid cells whose points form
// tall near-vertical streaks (monocular depth "shadows").
//
// Parity target: geom/clean.py::clean_shadows (itself behavioral parity
// with the reference's pointcloud_cleaner.py:142-309). The numpy
// version is fully vectorized but still the DOMINANT host stage of the
// frames->floorplan pipeline (1.57 s/frame of the 2.54 s total,
// scripts/pipeline_stage_budget.out): one np.lexsort over millions of
// rows plus ~15 full-array passes. This kernel does ONE parallel
// stable sort by (cell, y, original-index) — the exact lexsort order —
// then processes cells across threads, computing the true per-cell
// pair-angle median directly (np.median semantics, including the
// even-count two-middle average and the zero-length-pair NaN rule:
// any duplicate-point pair keeps the cell).
//
// Build: compiled together with the other sources into geom-native.so.
// Binding: ctypes (ml_depth_pro_video_tpu/native/__init__.py).

#include <cstdint>
#include <cmath>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>

namespace {

struct Rec {
    int64_t cell;
    double ykey;  // sort key: NaN mapped to +inf (a NaN comparator
                  // breaks std::sort's strict weak ordering — UB)
    double y;     // raw value (the qualification test must see NaN so
                  // a NaN-extent cell stays kept, as numpy's does)
    int64_t idx;
};

inline bool rec_less(const Rec& a, const Rec& b) {
    if (a.cell != b.cell) return a.cell < b.cell;
    if (a.ykey != b.ykey) return a.ykey < b.ykey;
    return a.idx < b.idx;  // lexsort stability tiebreak
}

// chunked parallel merge sort (same std::thread style as bpa.cpp — no
// extra build flags); ping-pong merges into a scratch buffer
void parallel_sort(std::vector<Rec>& v) {
    const size_t n = v.size();
    unsigned hw = std::thread::hardware_concurrency();
    size_t nt = hw ? hw : 1;
    if (nt > 1 && n < 1u << 16) nt = 1;
    if (nt == 1) {
        std::sort(v.begin(), v.end(), rec_less);
        return;
    }
    std::vector<size_t> bounds(nt + 1);
    for (size_t t = 0; t <= nt; ++t) bounds[t] = n * t / nt;
    {
        std::vector<std::thread> th;
        th.reserve(nt);
        for (size_t t = 0; t < nt; ++t)
            th.emplace_back([&, t] {
                std::sort(v.begin() + bounds[t], v.begin() + bounds[t + 1],
                          rec_less);
            });
        for (auto& x : th) x.join();
    }
    std::vector<Rec> tmp(n);
    std::vector<size_t> cur(bounds);
    Rec* src = v.data();
    Rec* dst = tmp.data();
    size_t runs = nt;
    while (runs > 1) {
        size_t out_runs = (runs + 1) / 2;
        std::vector<size_t> nb(out_runs + 1);
        std::vector<std::thread> th;
        th.reserve(out_runs);
        for (size_t r = 0; r < out_runs; ++r) {
            size_t a0 = cur[2 * r];
            size_t a1 = cur[2 * r + 1];
            size_t a2 = (2 * r + 2 <= runs) ? cur[2 * r + 2] : a1;
            nb[r] = a0;
            th.emplace_back([=] {
                std::merge(src + a0, src + a1, src + a1, src + a2,
                           dst + a0, rec_less);
            });
        }
        nb[out_runs] = cur[runs];
        for (auto& x : th) x.join();
        std::swap(src, dst);
        cur.assign(nb.begin(), nb.end());
        runs = out_runs;
    }
    if (src != v.data()) std::memcpy(v.data(), src, n * sizeof(Rec));
}

}  // namespace

extern "C" {

// points: (n, 3) float64 row-major. keep_out: n uint8 (1 = keep).
// Mirrors clean_shadows' cell sizing, qualification, and median rule.
void clean_shadows_mask(const double* pts, int64_t n,
                        double shadow_height_threshold,
                        double max_shadow_angle_deg,
                        int32_t min_points_per_column,
                        uint8_t* keep_out) {
    std::memset(keep_out, 1, (size_t)n);
    if (n == 0) return;

    double x_min = pts[0], x_max = pts[0];
    double z_min = pts[2], z_max = pts[2];
    for (int64_t i = 1; i < n; ++i) {
        const double x = pts[3 * i], z = pts[3 * i + 2];
        if (x < x_min) x_min = x;
        if (x > x_max) x_max = x;
        if (z < z_min) z_min = z;
        if (z > z_max) z_max = z;
    }
    double area = (x_max - x_min) * (z_max - z_min);
    if (area < 1e-9) area = 1e-9;
    const double density = (double)n / area;
    double cell_size = 1.0 / std::sqrt(std::max(density / 10.0, 1e-12));
    if (cell_size < 0.05) cell_size = 0.05;

    int64_t nx = (int64_t)std::ceil((x_max - x_min) / cell_size);
    int64_t nz = (int64_t)std::ceil((z_max - z_min) / cell_size);
    if (nx < 1) nx = 1;
    if (nz < 1) nz = 1;

    std::vector<Rec> rec((size_t)n);
    for (int64_t i = 0; i < n; ++i) {
        // numpy: xi = min(int64((x - x_min)/cell_size), nx-1)
        int64_t xi = (int64_t)((pts[3 * i] - x_min) / cell_size);
        int64_t zi = (int64_t)((pts[3 * i + 2] - z_min) / cell_size);
        if (xi > nx - 1) xi = nx - 1;
        if (zi > nz - 1) zi = nz - 1;
        const double y = pts[3 * i + 1];
        const double ykey = std::isnan(y) ? INFINITY : y;
        rec[(size_t)i] = {xi * nz + zi, ykey, y, i};
    }
    parallel_sort(rec);

    // segment boundaries (cells are contiguous after the sort)
    std::vector<int64_t> starts;
    starts.reserve((size_t)(n / 8) + 2);
    starts.push_back(0);
    for (int64_t i = 1; i < n; ++i)
        if (rec[(size_t)i].cell != rec[(size_t)i - 1].cell)
            starts.push_back(i);
    starts.push_back(n);
    const size_t n_seg = starts.size() - 1;

    const int64_t min_pts = std::max(min_points_per_column, 3);
    const double deg = 180.0 / M_PI;
    const double cos_t = std::cos(max_shadow_angle_deg * M_PI / 180.0);
    const double cos2_t = cos_t * cos_t;

    unsigned hw = std::thread::hardware_concurrency();
    size_t nt = hw ? hw : 1;
    if (n_seg < 64) nt = 1;

    // the drop rule mirrors geom/clean.py EXACTLY: the primary test is
    // the algebraic pair count (vy > 0 && vy^2 > cos^2(t)*n2 — no
    // acos, no rounding beyond numpy's own), the exact two-middle
    // median is computed only for the even-count boundary tie, and a
    // zero-length (duplicate) pair keeps the cell (numpy's 0/0 -> NaN
    // median rule)
    auto worker = [&](size_t t, size_t T) {
        std::vector<double> angles;
        for (size_t s = t; s < n_seg; s += T) {
            const int64_t a = starts[s], b = starts[s + 1];
            const int64_t cnt = b - a;
            if (cnt < min_pts) continue;
            // NaN extent (non-finite y in the cell sorts last) fails
            // this strict test -> kept, matching numpy's NaN behavior
            if (!(rec[(size_t)(b - 1)].y - rec[(size_t)a].y
                  > shadow_height_threshold))
                continue;
            const int64_t m = cnt - 1;  // within-cell consecutive pairs
            int64_t below = 0;
            bool has_zero = false;
            for (int64_t i = a; i + 1 < b; ++i) {
                const int64_t p = rec[(size_t)i].idx;
                const int64_t q = rec[(size_t)(i + 1)].idx;
                const double vy = rec[(size_t)(i + 1)].y - rec[(size_t)i].y;
                const double dx = pts[3 * q] - pts[3 * p];
                const double dz = pts[3 * q + 2] - pts[3 * p + 2];
                const double n2 = vy * vy + dx * dx + dz * dz;
                if (n2 == 0.0) {
                    has_zero = true;
                    break;
                }
                // angle < t <=> vy > cos(t)*|v|, sign-aware squared
                // (for t > 90, cos t < 0, the naive squared test would
                // silently keep every cell)
                if (cos_t >= 0.0
                        ? (vy > 0.0 && vy * vy > cos2_t * n2)
                        : !(vy < 0.0 && vy * vy >= cos2_t * n2))
                    ++below;
            }
            if (has_zero || m <= 0) continue;
            bool drop;
            if (m % 2 == 1) {
                drop = below >= (m + 1) / 2;
            } else if (below >= m / 2 + 1) {
                drop = true;
            } else if (below == m / 2) {
                // boundary tie: the exact median of the two middle
                // ANGLE values (numpy computes these with arccos too)
                angles.clear();
                bool finite = true;
                for (int64_t i = a; i + 1 < b && finite; ++i) {
                    const int64_t p = rec[(size_t)i].idx;
                    const int64_t q = rec[(size_t)(i + 1)].idx;
                    const double vy = rec[(size_t)(i + 1)].y
                        - rec[(size_t)i].y;
                    const double dx = pts[3 * q] - pts[3 * p];
                    const double dz = pts[3 * q + 2] - pts[3 * p + 2];
                    double nrm = std::sqrt(vy * vy + dx * dx + dz * dz);
                    if (nrm == 0.0) nrm = 1e-12;  // numpy's substitute
                    double c = vy / nrm;
                    if (!(std::fabs(c) <= 1.0) && !std::isfinite(c))
                        finite = false;  // inf coords -> NaN median -> keep
                    if (c > 1.0) c = 1.0;
                    if (c < -1.0) c = -1.0;
                    angles.push_back(std::acos(c) * deg);
                }
                if (!finite) {
                    drop = false;
                } else {
                    const size_t mid = angles.size() / 2;
                    std::nth_element(angles.begin(), angles.begin() + mid,
                                     angles.end());
                    const double hi2 = angles[mid];
                    const double lo2 = *std::max_element(
                        angles.begin(), angles.begin() + mid);
                    drop = 0.5 * (lo2 + hi2) < max_shadow_angle_deg;
                }
            } else {
                drop = false;
            }
            if (drop)
                for (int64_t i = a; i < b; ++i)
                    keep_out[rec[(size_t)i].idx] = 0;
        }
    };
    if (nt == 1) {
        worker(0, 1);
    } else {
        std::vector<std::thread> th;
        th.reserve(nt);
        for (size_t t = 0; t < nt; ++t) th.emplace_back(worker, t, nt);
        for (auto& x : th) x.join();
    }
}

}  // extern "C"
