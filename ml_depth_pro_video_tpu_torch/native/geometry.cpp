// Fused per-frame geometry: depth map -> ground-normalized, grid-adjusted
// point cloud in ONE native pass.
//
// Replaces the numpy chain depth_to_3d -> normalize_to_ground ->
// grid_ground_adjustment (geom/unproject.py, geom/ground.py; reference
// semantics img_to_normalized_pointcloud.py:819-856, :880-981, :983-1118)
// for the video pipeline hot path: the numpy version makes ~25 passes over
// a 6.9M-point float64 cloud plus full sorts for every percentile; this
// makes ~6 fused passes and uses nth_element selection. Exact same math
// (float64 accumulate, numpy-style linear-interpolated percentiles,
// digitize-compatible binning) — the Python fallback remains and tests
// assert equality.
//
// Build: compiled together with neighbors.cpp into geom-native.so.
// Binding: ctypes (ml_depth_pro_video_tpu/native/__init__.py).

#include <cstdint>
#include <cmath>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>

namespace {

// numpy np.percentile(..., method="linear") on a scratch copy
double percentile_linear(std::vector<double>& v, double q) {
    if (v.empty()) return 0.0;
    const double pos = (q / 100.0) * (double)(v.size() - 1);
    const size_t lo = (size_t)std::floor(pos);
    const double frac = pos - (double)lo;
    std::nth_element(v.begin(), v.begin() + lo, v.end());
    const double a = v[lo];
    if (frac == 0.0 || lo + 1 >= v.size()) return a;
    const double b = *std::min_element(v.begin() + lo + 1, v.end());
    return a + frac * (b - a);
}

// np.digitize(x, linspace(mn, mx, g+1)) - 1, clipped to [0, g-1]
inline int digitize_cell(double x, const double* edges, int g) {
    // first index i with edges[i] > x  (upper_bound), minus one
    int lo = 0, hi = g + 1;
    while (lo < hi) {
        int mid = (lo + hi) / 2;
        if (edges[mid] <= x) lo = mid + 1; else hi = mid;
    }
    int idx = lo - 1;
    if (idx < 0) idx = 0;
    if (idx > g - 1) idx = g - 1;
    return idx;
}

}  // namespace

extern "C" {

// depth (h*w float32, row-major), optional image (h*w*3 uint8, may be null).
// Ground plane: unit normal (3), d. Rotation R (3x3 row-major, applied as
// p' = R p) with y_shift subtracted from y' — pass use_rotation=0 for the
// near-horizontal identity path (|n.y| > 0.99). Outputs compacted points
// (n_out*3 float64) and optional colors (n_out*3 float64, /255).
// Returns n_out.
int64_t normalized_cloud(
    const float* depth, int64_t h, int64_t w,
    double f_px, double max_depth,
    const uint8_t* image,
    const double* normal, double d,
    const double* R, int use_rotation, double y_shift,
    int grid_size, double pct,
    double* out_pts, double* out_colors) {

    const double cx = (double)w / 2.0, cy = (double)h / 2.0;
    const double nx = normal[0], ny = normal[1], nz = normal[2];

    // pass 1: unproject + plane distance + rotate + translate, compacted
    std::vector<double> dist;  // signed distance BEFORE rotation (clamp masks)
    dist.reserve((size_t)(h * w));
    int64_t n = 0;
    for (int64_t r = 0; r < h; ++r) {
        const float* row = depth + r * w;
        const double py0 = -((double)r - cy);
        for (int64_t c = 0; c < w; ++c) {
            const double z = (double)row[c];
            if (!(z > 0.0) || std::isnan(z)) continue;
            if (max_depth > 0.0 && z >= max_depth) continue;
            const double x = -((double)c - cx) * z / f_px;
            const double y = py0 * z / f_px;
            dist.push_back(x * nx + y * ny + z * nz + d);
            double ox, oy, oz;
            if (use_rotation) {
                ox = R[0] * x + R[1] * y + R[2] * z;
                oy = R[3] * x + R[4] * y + R[5] * z - y_shift;
                oz = R[6] * x + R[7] * y + R[8] * z;
            } else {
                ox = x; oy = y; oz = z;
            }
            out_pts[3 * n] = ox;
            out_pts[3 * n + 1] = oy;
            out_pts[3 * n + 2] = oz;
            if (image && out_colors) {
                const uint8_t* px = image + (r * w + c) * 3;
                out_colors[3 * n] = px[0] / 255.0;
                out_colors[3 * n + 1] = px[1] / 255.0;
                out_colors[3 * n + 2] = px[2] / 255.0;
            }
            ++n;
        }
    }
    if (n == 0) return 0;

    // ground-band percentile shift (normalize_to_ground)
    {
        std::vector<double> ground_y;
        for (int64_t i = 0; i < n; ++i)
            if (std::fabs(dist[i]) < 0.1) ground_y.push_back(out_pts[3 * i + 1]);
        if (ground_y.size() > 10) {
            const double shift = percentile_linear(ground_y, 2.0);
            for (int64_t i = 0; i < n; ++i) out_pts[3 * i + 1] -= shift;
        }
        for (int64_t i = 0; i < n; ++i) {
            const bool gmask = std::fabs(dist[i]) < 0.05;
            double& y = out_pts[3 * i + 1];
            if (gmask) { if (y < 0.0) y = 0.0; }
            else if (y < -0.1) y = -0.1;
        }
    }

    // grid_ground_adjustment: per-XZ-cell lowering with graduated falloff
    {
        const int g = grid_size;
        double xmn = out_pts[0], xmx = out_pts[0], zmn = out_pts[2], zmx = out_pts[2];
        for (int64_t i = 1; i < n; ++i) {
            xmn = std::min(xmn, out_pts[3 * i]);     xmx = std::max(xmx, out_pts[3 * i]);
            zmn = std::min(zmn, out_pts[3 * i + 2]); zmx = std::max(zmx, out_pts[3 * i + 2]);
        }
        // np.linspace edges for exact digitize parity: start + i*step,
        // last edge set to stop (numpy's exact construction)
        std::vector<double> xe(g + 1), ze(g + 1);
        const double xstep = (xmx - xmn) / (double)g, zstep = (zmx - zmn) / (double)g;
        for (int i = 0; i <= g; ++i) {
            xe[i] = xmn + (double)i * xstep;
            ze[i] = zmn + (double)i * zstep;
        }
        xe[g] = xmx; ze[g] = zmx;

        std::vector<int> cell(n);
        std::vector<int64_t> count((size_t)g * g, 0);
        for (int64_t i = 0; i < n; ++i) {
            const int xi = digitize_cell(out_pts[3 * i], xe.data(), g);
            const int zi = digitize_cell(out_pts[3 * i + 2], ze.data(), g);
            cell[i] = xi * g + zi;
            ++count[cell[i]];
        }
        // bucket y values per cell (only cells with >= 10 points matter)
        std::vector<std::vector<double>> low((size_t)g * g);
        for (int64_t i = 0; i < n; ++i) {
            if (count[cell[i]] < 10) continue;
            const double y = out_pts[3 * i + 1];
            if (y < 0.2) low[cell[i]].push_back(y);
        }
        std::vector<double> cell_pct((size_t)g * g, 0.0);
        for (size_t cidx = 0; cidx < low.size(); ++cidx) {
            if (count[cidx] < 10 || low[cidx].size() < 5) continue;
            const double p = percentile_linear(low[cidx], pct);
            if (p > 0.01) cell_pct[cidx] = p;
        }
        for (int64_t i = 0; i < n; ++i) {
            const double p = cell_pct[cell[i]];
            if (p <= 0.0) continue;
            double& y = out_pts[3 * i + 1];
            double adj = 0.0;
            if (y < 0.1) adj = p;
            else if (y < 1.5) adj = p * (1.0 - (y - 0.1) / 1.4);
            if (adj != 0.0) {
                y -= adj;
                if (y < 0.0) y = 0.0;
            }
        }
    }
    return n;
}

}  // extern "C"

extern "C" {

// Raw pinhole unprojection with validity compaction (depth_to_3d's hot
// loop, geom/unproject.py): out_pts (h*w*3 f64), out_valid (h*w u8),
// optional colors. Returns the number of valid points.
int64_t unproject_valid(
    const float* depth, int64_t h, int64_t w,
    double f_px, double max_depth,
    const uint8_t* image,
    double* out_pts, uint8_t* out_valid, double* out_colors) {

    const double cx = (double)w / 2.0, cy = (double)h / 2.0;
    int64_t n = 0;
    for (int64_t r = 0; r < h; ++r) {
        const float* row = depth + r * w;
        const double py0 = -((double)r - cy);
        for (int64_t c = 0; c < w; ++c) {
            const double z = (double)row[c];
            const bool ok = (z > 0.0) && !std::isnan(z) &&
                            (max_depth <= 0.0 || z < max_depth);
            out_valid[r * w + c] = ok ? 1 : 0;
            if (!ok) continue;
            out_pts[3 * n] = -((double)c - cx) * z / f_px;
            out_pts[3 * n + 1] = py0 * z / f_px;
            out_pts[3 * n + 2] = z;
            if (image && out_colors) {
                const uint8_t* px = image + (r * w + c) * 3;
                out_colors[3 * n] = px[0] / 255.0;
                out_colors[3 * n + 1] = px[1] / 255.0;
                out_colors[3 * n + 2] = px[2] / 255.0;
            }
            ++n;
        }
    }
    return n;
}

}  // extern "C"
