// Tallest-point-wins floor-plan rasterization (fast_floorplan_image's
// splat + dilation core, geom/floorplan_viz.py:138-207; reference
// behavior pointcloud_pipeline.py's scatter plots).
//
// Parity notes (each mirrors the numpy code exactly):
// - pixel mapping truncates toward zero like ndarray.astype(int64), so
//   a point marginally outside the low limit still lands in column 0;
// - the winner per pixel is the lexicographic max of (y, point index)
//   in FLOAT64 — numpy's stable ascending sort writes later/taller
//   points last; the stored height buffer is float32 (numpy allocates
//   hbuf as float32) and the dilation compares in float32;
// - dilation reads the PRE-dilation copy for all 8 offsets (numpy
//   copies src_img/src_h once before its offset loop);
// - colorless clouds splat the 0.35 gray fill.
//
// Threads: points are bucketed into row bands (one owner thread per
// band — no atomics, no contention), dilation parallelizes over rows.
//
// Build: compiled with the other sources into geom-native.so.
// Binding: ctypes (ml_depth_pro_video_tpu/native/__init__.py).

#include <cstdint>
#include <cmath>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>

namespace {

struct Hit {
    int64_t lin;
    int64_t idx;
    float y32;
    double y;
};

}  // namespace

extern "C" {

// points (n,3) f64; colors (n,3) f64 in [0,1] or null; img_out
// (height*width*3) f32 PRE-FILLED with the background color.
void splat_floorplan(const double* pts, const double* colors, int64_t n,
                     double height_threshold, int use_threshold,
                     double x0, double x1, double z0, double z1,
                     int64_t width, int64_t height, int32_t point_radius,
                     float* img_out) {
    const double span_x = std::max(x1 - x0, 1e-9);
    const double span_z = std::max(z1 - z0, 1e-9);

    // collect in-bounds hits (serial pass; branchy but cheap)
    std::vector<Hit> hits;
    hits.reserve((size_t)n);
    for (int64_t i = 0; i < n; ++i) {
        const double y = pts[3 * i + 1];
        if (use_threshold && !(y >= height_threshold)) continue;
        const double x = -pts[3 * i];
        const double z = pts[3 * i + 2];
        // numpy: ((x - x0)/span_x*(width-1)).astype(int64) — truncation
        const int64_t px = (int64_t)((x - x0) / span_x * (double)(width - 1));
        const int64_t pz = (int64_t)((z1 - z) / span_z * (double)(height - 1));
        if (px < 0 || px >= width || pz < 0 || pz >= height) continue;
        hits.push_back({pz * width + px, i, (float)y, y});
    }

    const size_t npix = (size_t)(height * width);
    std::vector<float> hbuf(npix, -INFINITY);
    std::vector<int64_t> winner(npix, -1);

    unsigned hw = std::thread::hardware_concurrency();
    size_t nt = hw ? hw : 1;
    if (hits.size() < 1u << 15) nt = 1;

    if (nt == 1) {
        for (const Hit& h : hits) {
            const size_t p = (size_t)h.lin;
            const int64_t w = winner[p];
            // lexicographic (y, idx) max == numpy's stable-sort overwrite
            if (w < 0 || h.y > pts[3 * w + 1]
                || (h.y == pts[3 * w + 1] && h.idx > w)) {
                winner[p] = h.idx;
                hbuf[p] = h.y32;
            }
        }
    } else {
        // bucket hits into row bands; each band has ONE owner thread
        std::vector<size_t> band_of(hits.size());
        std::vector<size_t> count(nt + 1, 0);
        const int64_t rows_per = (height + (int64_t)nt - 1) / (int64_t)nt;
        for (size_t i = 0; i < hits.size(); ++i) {
            size_t b = (size_t)(hits[i].lin / width / rows_per);
            if (b >= nt) b = nt - 1;
            band_of[i] = b;
            ++count[b + 1];
        }
        for (size_t b = 0; b < nt; ++b) count[b + 1] += count[b];
        std::vector<Hit> sorted(hits.size());
        {
            std::vector<size_t> cur(count.begin(), count.end() - 1);
            for (size_t i = 0; i < hits.size(); ++i)
                sorted[cur[band_of[i]]++] = hits[i];
        }
        std::vector<std::thread> th;
        th.reserve(nt);
        for (size_t b = 0; b < nt; ++b)
            th.emplace_back([&, b] {
                for (size_t i = count[b]; i < count[b + 1]; ++i) {
                    const Hit& h = sorted[i];
                    const size_t p = (size_t)h.lin;
                    const int64_t w = winner[p];
                    if (w < 0 || h.y > pts[3 * w + 1]
                        || (h.y == pts[3 * w + 1] && h.idx > w)) {
                        winner[p] = h.idx;
                        hbuf[p] = h.y32;
                    }
                }
            });
        for (auto& x : th) x.join();
    }

    // write winner colors
    for (size_t p = 0; p < npix; ++p) {
        const int64_t w = winner[p];
        if (w < 0) continue;
        float* o = img_out + 3 * p;
        if (colors) {
            o[0] = (float)colors[3 * w];
            o[1] = (float)colors[3 * w + 1];
            o[2] = (float)colors[3 * w + 2];
        } else {
            o[0] = o[1] = o[2] = 0.35f;
        }
    }

    const int r = point_radius;
    if (r <= 0) return;
    // height-aware dilation from the PRE-dilation copies
    std::vector<float> src_h(hbuf);
    std::vector<float> src_img((size_t)npix * 3);
    std::memcpy(src_img.data(), img_out, npix * 3 * sizeof(float));

    auto dilate_rows = [&](int64_t r0, int64_t r1) {
        for (int64_t row = r0; row < r1; ++row) {
            for (int64_t col = 0; col < width; ++col) {
                const size_t p = (size_t)(row * width + col);
                float best = hbuf[p];
                int64_t bi = -1, bj = 0;
                for (int dy = -r; dy <= r; ++dy) {
                    const int64_t sr = row - dy;
                    if (sr < 0 || sr >= height) continue;
                    for (int dx = -r; dx <= r; ++dx) {
                        if (dy == 0 && dx == 0) continue;
                        const int64_t sc = col - dx;
                        if (sc < 0 || sc >= width) continue;
                        const float v = src_h[(size_t)(sr * width + sc)];
                        if (v > best) {
                            best = v;
                            bi = sr;
                            bj = sc;
                        }
                    }
                }
                if (bi >= 0) {
                    const size_t sp = (size_t)(bi * width + bj);
                    hbuf[p] = best;
                    img_out[3 * p] = src_img[3 * sp];
                    img_out[3 * p + 1] = src_img[3 * sp + 1];
                    img_out[3 * p + 2] = src_img[3 * sp + 2];
                }
            }
        }
    };
    unsigned hw2 = std::thread::hardware_concurrency();
    size_t nt2 = hw2 ? hw2 : 1;
    if ((size_t)height < 4 * nt2) nt2 = 1;
    if (nt2 == 1) {
        dilate_rows(0, height);
    } else {
        std::vector<std::thread> th;
        th.reserve(nt2);
        for (size_t t = 0; t < nt2; ++t) {
            const int64_t r0 = height * (int64_t)t / (int64_t)nt2;
            const int64_t r1 = height * (int64_t)(t + 1) / (int64_t)nt2;
            th.emplace_back(dilate_rows, r0, r1);
        }
        for (auto& x : th) x.join();
    }
}

}  // extern "C"
