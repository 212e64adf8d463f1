// Native geometry kernels: grid-hash neighbor counting, voxel downsampling
// and k-NN PCA normals. Replaces the Open3D C++ surface the reference uses
// (KDTreeFlann radius search pointcloud_cleaner.py:164-187, voxel_down_sample
// and estimate_normals pointcloud_to_mesh.py:335-345) with a uniform-grid
// spatial hash: build is O(N), queries touch 27 cells.
//
// Build: see Makefile (g++ -O3 -march=native -shared -fPIC).
// Binding: ctypes (ml_depth_pro_video_tpu/native/__init__.py).

#include <cstdint>
#include <cmath>
#include <cstring>
#include <thread>
#include <unordered_map>
#include <vector>
#include <algorithm>

namespace {

struct GridHash {
    double cell;
    double ox, oy, oz;
    std::unordered_map<uint64_t, std::vector<int64_t>> cells;

    static uint64_t key(int64_t ix, int64_t iy, int64_t iz) {
        // 21 bits per axis, offset to keep indices positive
        const uint64_t B = 1ull << 20;
        return ((uint64_t)(ix + B) << 42) | ((uint64_t)(iy + B) << 21) | (uint64_t)(iz + B);
    }

    GridHash(const double* pts, int64_t n, double cell_size) : cell(cell_size) {
        ox = oy = oz = 0.0;
        cells.reserve(static_cast<size_t>(n / 2 + 16));
        for (int64_t i = 0; i < n; ++i) {
            int64_t ix = (int64_t)std::floor(pts[3 * i] / cell);
            int64_t iy = (int64_t)std::floor(pts[3 * i + 1] / cell);
            int64_t iz = (int64_t)std::floor(pts[3 * i + 2] / cell);
            cells[key(ix, iy, iz)].push_back(i);
        }
    }

    template <typename F>
    void for_neighbors(const double* pts, int64_t i, F&& fn) const {
        int64_t ix = (int64_t)std::floor(pts[3 * i] / cell);
        int64_t iy = (int64_t)std::floor(pts[3 * i + 1] / cell);
        int64_t iz = (int64_t)std::floor(pts[3 * i + 2] / cell);
        for (int64_t dx = -1; dx <= 1; ++dx)
            for (int64_t dy = -1; dy <= 1; ++dy)
                for (int64_t dz = -1; dz <= 1; ++dz) {
                    auto it = cells.find(key(ix + dx, iy + dy, iz + dz));
                    if (it == cells.end()) continue;
                    for (int64_t j : it->second) fn(j);
                }
    }
};

}  // namespace

extern "C" {

// mask[i] = 1 iff point i has >= min_count neighbors (j != i) within radius.
// Cells sorted by linear key; the 27-cell neighborhood of every cell is
// discovered with 9 monotonic two-pointer streams over the sorted key
// array (one per (dx,dy), z-neighbors are key +/-1) — sequential scans
// instead of 27 random hash probes per cell, which dominated on sparse
// multi-million-cell clouds. Key-space wrap at grid edges can only add
// FALSE neighbor cells (never miss true ones); the r^2 check filters them.
void radius_mask(const double* pts, int64_t n, double radius,
                 int32_t min_count, uint8_t* mask) {
    if (n == 0) return;
    const float r2 = (float)(radius * radius);
    const double inv_cell = 1.0 / radius;

    double min_x = 1e300, min_y = 1e300, min_z = 1e300;
    double max_x = -1e300, max_y = -1e300, max_z = -1e300;
    for (int64_t i = 0; i < n; ++i) {
        min_x = std::min(min_x, pts[3 * i]);     max_x = std::max(max_x, pts[3 * i]);
        min_y = std::min(min_y, pts[3 * i + 1]); max_y = std::max(max_y, pts[3 * i + 1]);
        min_z = std::min(min_z, pts[3 * i + 2]); max_z = std::max(max_z, pts[3 * i + 2]);
    }
    const int64_t ny = (int64_t)((max_y - min_y) * inv_cell) + 1;
    const int64_t nz = (int64_t)((max_z - min_z) * inv_cell) + 1;

    // (key, point) pairs sorted by key
    std::vector<std::pair<int64_t, int64_t>> kp(n);
    for (int64_t i = 0; i < n; ++i) {
        const int64_t gx = (int64_t)((pts[3 * i] - min_x) * inv_cell);
        const int64_t gy = (int64_t)((pts[3 * i + 1] - min_y) * inv_cell);
        const int64_t gz = (int64_t)((pts[3 * i + 2] - min_z) * inv_cell);
        kp[i] = {(gx * ny + gy) * nz + gz, i};
    }
    std::sort(kp.begin(), kp.end());

    // CSR over unique keys + contiguous float32 coords in sorted order
    std::vector<int64_t> ukey;  ukey.reserve(n / 4 + 16);
    std::vector<int64_t> starts; starts.reserve(n / 4 + 17);
    std::vector<float> fx(n), fy(n), fz(n);
    std::vector<int64_t> order(n);
    for (int64_t s = 0; s < n; ++s) {
        if (s == 0 || kp[s].first != kp[s - 1].first) {
            ukey.push_back(kp[s].first);
            starts.push_back(s);
        }
        const int64_t i = kp[s].second;
        order[s] = i;
        fx[s] = (float)pts[3 * i];
        fy[s] = (float)pts[3 * i + 1];
        fz[s] = (float)pts[3 * i + 2];
    }
    const int64_t u = (int64_t)ukey.size();
    starts.push_back(n);

    const int64_t nynz = ny * nz;
    const int64_t offs[9] = {-nynz - nz, -nynz, -nynz + nz,
                             -nz,        0,     nz,
                             nynz - nz,  nynz,  nynz + nz};

    // cells are independent: shard contiguous ranges across threads,
    // each range re-seeding its 9 stream pointers by binary search
    auto process_range = [&](int64_t c0, int64_t c1) {
    int64_t ptr[9];
    for (int q = 0; q < 9; ++q)
        ptr[q] = std::lower_bound(ukey.begin(), ukey.end(),
                                  ukey[c0] + offs[q] - 1) - ukey.begin();

    // On small grids the 9 stream windows OVERLAP: distinct offsets
    // differ by nz, 2nz, or nz*(ny-2)/nz*(ny-1), and each window spans
    // +-1 — so whenever the smallest gap is <= 2 the same cell lands in
    // several windows and would be counted repeatedly (inflating
    // neighbor counts on thin/planar clouds). Dedup below in that case.
    const bool windows_overlap = (nz <= 2) || (nz * (ny - 2) <= 2);
    for (int64_t c = c0; c < c1; ++c) {
        const int64_t k = ukey[c];
        int64_t nb_lo[27], nb_hi[27];
        int n_nb = 0;
        int64_t upper = -1;
        for (int q = 0; q < 9; ++q) {
            const int64_t target = k + offs[q] - 1;  // window [target, target+2]
            int64_t& p = ptr[q];
            while (p < u && ukey[p] < target) ++p;
            for (int64_t t = p; t < u && ukey[t] <= target + 2; ++t) {
                nb_lo[n_nb] = starts[t];
                nb_hi[n_nb] = starts[t + 1];
                upper += nb_hi[n_nb] - nb_lo[n_nb];
                ++n_nb;
            }
        }
        if (windows_overlap) {
            int mkeep = 0;
            upper = -1;
            for (int b = 0; b < n_nb; ++b) {
                bool dup = false;
                for (int j = 0; j < mkeep; ++j)
                    if (nb_lo[j] == nb_lo[b]) { dup = true; break; }
                if (!dup) {
                    nb_lo[mkeep] = nb_lo[b];
                    nb_hi[mkeep] = nb_hi[b];
                    upper += nb_hi[b] - nb_lo[b];
                    ++mkeep;
                }
            }
            n_nb = mkeep;
        }
        const int64_t cell_lo = starts[c], cell_hi = starts[c + 1];
        if (upper < min_count) {
            for (int64_t s = cell_lo; s < cell_hi; ++s) mask[order[s]] = 0;
            continue;
        }

        // auto-keep shortcut: bucket this cell's points into 2x2x2
        // half-cells (diagonal r*sqrt(3)/2 <= r): every point of a
        // half-cell holding > min_count points is trivially kept —
        // on dense surfaces this skips the distance checks entirely.
        uint8_t sub[/*points per cell often small*/ 512];
        int32_t sub_cnt[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        const bool use_sub = (cell_hi - cell_lo) > (int64_t)min_count &&
                             (cell_hi - cell_lo) <= 512;
        if (use_sub) {
            const float cxo = (float)(min_x) + (float)((k / nynz)) * (float)radius;
            const float cyo = (float)(min_y) + (float)(((k / nz) % ny)) * (float)radius;
            const float czo = (float)(min_z) + (float)((k % nz)) * (float)radius;
            const float half = (float)(radius * 0.5);
            for (int64_t s = cell_lo; s < cell_hi; ++s) {
                const int b = ((fx[s] - cxo >= half) << 2) |
                              ((fy[s] - cyo >= half) << 1) |
                              (fz[s] - czo >= half);
                sub[s - cell_lo] = (uint8_t)b;
                ++sub_cnt[b];
            }
        }

        for (int64_t s = cell_lo; s < cell_hi; ++s) {
            if (use_sub && sub_cnt[sub[s - cell_lo]] > min_count) {
                mask[order[s]] = 1;
                continue;
            }
            const float xi = fx[s], yi = fy[s], zi = fz[s];
            int32_t cnt = -1;  // the point itself matches at distance 0
            bool done = false;
            // own cell first: densest, triggers the early exit soonest
            for (int64_t t = cell_lo; t < cell_hi; ++t) {
                const float ddx = fx[t] - xi;
                const float ddy = fy[t] - yi;
                const float ddz = fz[t] - zi;
                if (ddx * ddx + ddy * ddy + ddz * ddz <= r2) {
                    if (++cnt >= min_count) { done = true; break; }
                }
            }
            for (int b = 0; b < n_nb && !done; ++b) {
                if (nb_lo[b] == cell_lo) continue;  // own cell done above
                for (int64_t t = nb_lo[b]; t < nb_hi[b]; ++t) {
                    const float ddx = fx[t] - xi;
                    const float ddy = fy[t] - yi;
                    const float ddz = fz[t] - zi;
                    if (ddx * ddx + ddy * ddy + ddz * ddz <= r2) {
                        if (++cnt >= min_count) { done = true; break; }
                    }
                }
            }
            mask[order[s]] = cnt >= min_count ? 1 : 0;
        }
    }
    };  // process_range

    unsigned n_threads = std::thread::hardware_concurrency();
    if (n_threads <= 1 || u < 4096) {
        process_range(0, u);
    } else {
        n_threads = std::min<unsigned>(n_threads, 64);
        std::vector<std::thread> workers;
        const int64_t chunk = (u + n_threads - 1) / n_threads;
        for (unsigned t = 0; t < n_threads; ++t) {
            const int64_t lo = t * chunk, hi = std::min<int64_t>(lo + chunk, u);
            if (lo < hi) workers.emplace_back(process_range, lo, hi);
        }
        for (auto& w : workers) w.join();
    }
}

// counts[i] = number of points j != i with |p_i - p_j| <= radius
void radius_counts(const double* pts, int64_t n, double radius, int32_t* counts) {
    if (n == 0) return;
    GridHash grid(pts, n, radius);
    const double r2 = radius * radius;
    for (int64_t i = 0; i < n; ++i) {
        int32_t c = 0;
        const double xi = pts[3 * i], yi = pts[3 * i + 1], zi = pts[3 * i + 2];
        grid.for_neighbors(pts, i, [&](int64_t j) {
            if (j == i) return;
            const double dx = pts[3 * j] - xi;
            const double dy = pts[3 * j + 1] - yi;
            const double dz = pts[3 * j + 2] - zi;
            if (dx * dx + dy * dy + dz * dz <= r2) ++c;
        });
        counts[i] = c;
    }
}

// Voxel downsample: averages points (and colors if given) per voxel.
// Returns the number of voxels written to out_pts/out_cols (capacity n).
int64_t voxel_downsample(const double* pts, const double* cols, int64_t n,
                         double voxel, double* out_pts, double* out_cols) {
    std::unordered_map<uint64_t, int64_t> slot;
    slot.reserve(static_cast<size_t>(n / 2 + 16));
    std::vector<double> acc;   // x,y,z,(r,g,b),count per voxel
    const int stride = cols ? 7 : 4;
    int64_t m = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t ix = (int64_t)std::floor(pts[3 * i] / voxel);
        int64_t iy = (int64_t)std::floor(pts[3 * i + 1] / voxel);
        int64_t iz = (int64_t)std::floor(pts[3 * i + 2] / voxel);
        uint64_t k = GridHash::key(ix, iy, iz);
        auto it = slot.find(k);
        int64_t s;
        if (it == slot.end()) {
            s = m++;
            slot.emplace(k, s);
            acc.resize(static_cast<size_t>(m) * stride, 0.0);
        } else {
            s = it->second;
        }
        double* a = &acc[static_cast<size_t>(s) * stride];
        a[0] += pts[3 * i];
        a[1] += pts[3 * i + 1];
        a[2] += pts[3 * i + 2];
        if (cols) {
            a[3] += cols[3 * i];
            a[4] += cols[3 * i + 1];
            a[5] += cols[3 * i + 2];
        }
        a[stride - 1] += 1.0;
    }
    for (int64_t s = 0; s < m; ++s) {
        const double* a = &acc[static_cast<size_t>(s) * stride];
        const double inv = 1.0 / a[stride - 1];
        out_pts[3 * s] = a[0] * inv;
        out_pts[3 * s + 1] = a[1] * inv;
        out_pts[3 * s + 2] = a[2] * inv;
        if (cols && out_cols) {
            out_cols[3 * s] = a[3] * inv;
            out_cols[3 * s + 1] = a[4] * inv;
            out_cols[3 * s + 2] = a[5] * inv;
        }
    }
    return m;
}

// PCA normals from neighbors within `radius` (fallback: nearest cell
// occupants), oriented towards `camera` (cx, cy, cz).
// Smallest eigenvector of a symmetric 3x3 matrix {a d f; d b e; f e c},
// closed form (trigonometric eigenvalues + largest cross product of rows
// of C - lambda*I). Deterministic — replaces a fixed-start power
// iteration that could fail to separate near-equal eigenvalues on thin
// edges, flipping normals differently from the numpy eigh fallback.
static void smallest_eigvec3(double a, double b, double c,
                             double d, double e, double f, double out[3]) {
    out[0] = 0.0; out[1] = 1.0; out[2] = 0.0;
    const double p1 = d * d + e * e + f * f;
    if (p1 < 1e-30) {  // already diagonal
        int k = (a <= b && a <= c) ? 0 : (b <= c ? 1 : 2);
        out[0] = out[1] = out[2] = 0.0;
        out[k] = 1.0;
        return;
    }
    const double q = (a + b + c) / 3.0;
    const double p2 = (a - q) * (a - q) + (b - q) * (b - q) + (c - q) * (c - q) + 2.0 * p1;
    const double p = std::sqrt(p2 / 6.0);
    const double B0 = (a - q) / p, B4 = (b - q) / p, B8 = (c - q) / p;
    const double B1 = d / p, B5 = e / p, B2 = f / p;
    double r = (B0 * (B4 * B8 - B5 * B5) - B1 * (B1 * B8 - B5 * B2)
                + B2 * (B1 * B5 - B4 * B2)) / 2.0;
    r = std::max(-1.0, std::min(1.0, r));
    const double phi = std::acos(r) / 3.0;
    const double lam = q + 2.0 * p * std::cos(phi + 2.0 * M_PI / 3.0);  // smallest
    const double A0 = a - lam, A4 = b - lam, A8 = c - lam;
    const double r0[3] = {A0, d, f}, r1[3] = {d, A4, e}, r2[3] = {f, e, A8};
    double cr[3][3] = {
        {r0[1] * r1[2] - r0[2] * r1[1], r0[2] * r1[0] - r0[0] * r1[2], r0[0] * r1[1] - r0[1] * r1[0]},
        {r0[1] * r2[2] - r0[2] * r2[1], r0[2] * r2[0] - r0[0] * r2[2], r0[0] * r2[1] - r0[1] * r2[0]},
        {r1[1] * r2[2] - r1[2] * r2[1], r1[2] * r2[0] - r1[0] * r2[2], r1[0] * r2[1] - r1[1] * r2[0]},
    };
    int best = 0;
    double best_n = -1.0;
    for (int k = 0; k < 3; ++k) {
        const double nn = cr[k][0] * cr[k][0] + cr[k][1] * cr[k][1] + cr[k][2] * cr[k][2];
        if (nn > best_n) { best_n = nn; best = k; }
    }
    if (best_n < 1e-30) return;  // fully degenerate: keep +Y
    const double inv = 1.0 / std::sqrt(best_n);
    out[0] = cr[best][0] * inv;
    out[1] = cr[best][1] * inv;
    out[2] = cr[best][2] * inv;
}

void estimate_normals(const double* pts, int64_t n, double radius,
                      double cx, double cy, double cz, double* normals) {
    if (n == 0) return;
    GridHash grid(pts, n, radius);
    const double r2 = radius * radius;
    const size_t max_nn = 30;  // Hybrid semantics: the 30 NEAREST inside
                               // the radius (matching the numpy fallback
                               // and the reference's KDTreeSearchParamHybrid)
    std::vector<std::pair<double, int64_t>> nbrs;
    for (int64_t i = 0; i < n; ++i) {
        nbrs.clear();
        const double xi = pts[3 * i], yi = pts[3 * i + 1], zi = pts[3 * i + 2];
        grid.for_neighbors(pts, i, [&](int64_t j) {
            const double dx = pts[3 * j] - xi;
            const double dy = pts[3 * j + 1] - yi;
            const double dz = pts[3 * j + 2] - zi;
            const double d2 = dx * dx + dy * dy + dz * dz;
            if (d2 <= r2) nbrs.emplace_back(d2, j);
        });
        if (nbrs.size() > max_nn) {
            std::nth_element(nbrs.begin(), nbrs.begin() + max_nn, nbrs.end());
            nbrs.resize(max_nn);
        }
        double nx = 0, ny = 1, nz = 0;
        if (nbrs.size() >= 3) {
            double mx = 0, my = 0, mz = 0;
            for (auto& pr : nbrs) {
                const int64_t j = pr.second;
                mx += pts[3*j]; my += pts[3*j+1]; mz += pts[3*j+2];
            }
            const double inv = 1.0 / nbrs.size();
            mx *= inv; my *= inv; mz *= inv;
            double cxx=0, cxy=0, cxz=0, cyy=0, cyz=0, czz=0;
            for (auto& pr : nbrs) {
                const int64_t j = pr.second;
                const double dx = pts[3*j] - mx, dy = pts[3*j+1] - my, dz = pts[3*j+2] - mz;
                cxx += dx*dx; cxy += dx*dy; cxz += dx*dz;
                cyy += dy*dy; cyz += dy*dz; czz += dz*dz;
            }
            double v[3];
            smallest_eigvec3(cxx, cyy, czz, cxy, cyz, cxz, v);
            nx = v[0]; ny = v[1]; nz = v[2];
        }
        // orient towards camera
        const double tox = cx - xi, toy = cy - yi, toz = cz - zi;
        if (nx * tox + ny * toy + nz * toz < 0) { nx = -nx; ny = -ny; nz = -nz; }
        normals[3 * i] = nx; normals[3 * i + 1] = ny; normals[3 * i + 2] = nz;
    }
}

}  // extern "C"
