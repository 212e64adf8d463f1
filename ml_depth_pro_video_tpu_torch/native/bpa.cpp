// Ball-Pivoting surface reconstruction (Bernardini et al. 1999).
//
// Real BPA replacing the round-1 tangent-fan stand-in: a ball of radius
// rho pivots around front edges; the first point it touches (minimal
// pivot angle with an empty ball) forms a new triangle. Multi-radius
// passes reactivate boundary edges with the next larger radius, exactly
// the contract of the reference's Open3D call
// (pointcloud_to_mesh.py:368-375: radii = avg k-NN distance x {2,4,8,16}).
//
// Binding: ctypes (ml_depth_pro_video_tpu/native/__init__.py); Python
// fallback remains geom/mesh.py::tangent_fan_triangulation.

#include <atomic>
#include <cstdint>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <thread>
#include <unordered_map>
#include <vector>
#include <algorithm>

namespace {

struct V3 {
    double x, y, z;
    V3 operator+(const V3& o) const { return {x + o.x, y + o.y, z + o.z}; }
    V3 operator-(const V3& o) const { return {x - o.x, y - o.y, z - o.z}; }
    V3 operator*(double s) const { return {x * s, y * s, z * s}; }
    double dot(const V3& o) const { return x * o.x + y * o.y + z * o.z; }
    V3 cross(const V3& o) const {
        return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
    }
    double norm2() const { return dot(*this); }
    double norm() const { return std::sqrt(norm2()); }
    V3 normalized() const { double n = norm(); return n > 0 ? *this * (1.0 / n) : V3{0, 0, 0}; }
};

struct Grid {
    double cell;
    double ox, oy, oz;
    int64_t ny, nz;
    std::unordered_map<int64_t, std::vector<int32_t>> cells;

    Grid(const double* pts, int64_t n, double cell_size) : cell(cell_size) {
        ox = oy = oz = 1e300;
        double mx = -1e300, my = -1e300, mz = -1e300;
        for (int64_t i = 0; i < n; ++i) {
            ox = std::min(ox, pts[3 * i]);     mx = std::max(mx, pts[3 * i]);
            oy = std::min(oy, pts[3 * i + 1]); my = std::max(my, pts[3 * i + 1]);
            oz = std::min(oz, pts[3 * i + 2]); mz = std::max(mz, pts[3 * i + 2]);
        }
        ny = (int64_t)((my - oy) / cell) + 2;
        nz = (int64_t)((mz - oz) / cell) + 2;
        cells.reserve((size_t)n);
        for (int64_t i = 0; i < n; ++i)
            cells[key_of(pts + 3 * i)].push_back((int32_t)i);
    }
    int64_t key(int64_t gx, int64_t gy, int64_t gz) const {
        return (gx * ny + gy) * nz + gz;
    }
    int64_t key_of(const double* p) const {
        return key((int64_t)((p[0] - ox) / cell), (int64_t)((p[1] - oy) / cell),
                   (int64_t)((p[2] - oz) / cell));
    }
    template <typename F>
    void near(const V3& c, F&& fn) const {  // all points within ~cell of c
        const int64_t gx = (int64_t)((c.x - ox) / cell);
        const int64_t gy = (int64_t)((c.y - oy) / cell);
        const int64_t gz = (int64_t)((c.z - oz) / cell);
        for (int64_t dx = -1; dx <= 1; ++dx)
            for (int64_t dy = -1; dy <= 1; ++dy)
                for (int64_t dz = -1; dz <= 1; ++dz) {
                    auto it = cells.find(key(gx + dx, gy + dy, gz + dz));
                    if (it == cells.end()) continue;
                    for (int32_t j : it->second) fn(j);
                }
    }
};

struct BPA {
    const double* pts;
    const double* nrm;
    int64_t n;

    std::vector<uint8_t> used;
    std::vector<int32_t> front_deg;  // open (front/boundary) edges per vertex
    // edge key -> status: 1 = front, 2 = inner, 3 = boundary (this radius)
    std::unordered_map<uint64_t, uint8_t> estat;
    struct FrontEdge { int32_t i, j, o; V3 c; };
    std::deque<FrontEdge> front;
    std::vector<FrontEdge> boundary_records;
    std::vector<int64_t> tris;
    int64_t max_tris;

    BPA(const double* p, const double* nr, int64_t n_, int64_t cap)
        : pts(p), nrm(nr), n(n_), used(n_, 0), front_deg(n_, 0), max_tris(cap) {}

    V3 P(int64_t i) const { return {pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]}; }
    V3 N(int64_t i) const { return {nrm[3 * i], nrm[3 * i + 1], nrm[3 * i + 2]}; }
    static uint64_t ekey(int64_t a, int64_t b) {
        if (a > b) std::swap(a, b);
        return ((uint64_t)a << 32) | (uint64_t)b;
    }

    // the two ball centers of radius rho touching a,b,c (circumcenter
    // +- h along the face normal); false if the circumradius exceeds
    // rho or abc is degenerate
    bool centers(int64_t a, int64_t b, int64_t c, double rho,
                 V3& c_pos, V3& c_neg) const {
        const V3 pa = P(a), pb = P(b), pc = P(c);
        const V3 ab = pb - pa, ac = pc - pa;
        const V3 nf = ab.cross(ac);
        const double nf2 = nf.norm2();
        if (nf2 < 1e-24) return false;
        // circumcenter (barycentric form)
        const double d = 0.5 / nf2;
        const V3 cc = pa + (ac * ab.norm2() - ab * ac.norm2()).cross(nf) * d;
        const double r2 = (cc - pa).norm2();
        const double h2 = rho * rho - r2;
        if (h2 <= 0) return false;
        const V3 off = nf * (std::sqrt(h2) / std::sqrt(nf2));
        c_pos = cc + off;
        c_neg = cc - off;
        return true;
    }

    // seed helper: the center on the vertex-normal-consistent side
    bool center(int64_t a, int64_t b, int64_t c, double rho, V3& out) const {
        V3 cp, cn;
        if (!centers(a, b, c, rho, cp, cn)) return false;
        const V3 navg = N(a) + N(b) + N(c);
        const V3 nf = (P(b) - P(a)).cross(P(c) - P(a));
        out = nf.dot(navg) >= 0 ? cp : cn;
        return true;
    }

    bool ball_empty(const Grid& g, const V3& c, double rho,
                    int64_t a, int64_t b, int64_t x) const {
        const double lim = rho * rho * (1.0 - 1e-9);
        bool ok = true;
        g.near(c, [&](int32_t j) {
            if (!ok || j == a || j == b || j == x) return;
            if ((P(j) - c).norm2() < lim) ok = false;
        });
        return ok;
    }

    void emit(int64_t a, int64_t b, int64_t c) {
        // winding consistent with vertex normals
        const V3 nf = (P(b) - P(a)).cross(P(c) - P(a));
        if (nf.dot(N(a) + N(b) + N(c)) >= 0) {
            tris.push_back(a); tris.push_back(b); tris.push_back(c);
        } else {
            tris.push_back(a); tris.push_back(c); tris.push_back(b);
        }
        used[a] = used[b] = used[c] = 1;
    }

    // register edge (a,b) with opposite o and ball center c
    void add_edge(int64_t a, int64_t b, int64_t o, const V3& c) {
        auto& st = estat[ekey(a, b)];
        if (st == 0) {
            st = 1;
            ++front_deg[a]; ++front_deg[b];
            front.push_back({(int32_t)a, (int32_t)b, (int32_t)o, c});
        } else {
            if (st != 2) { --front_deg[a]; --front_deg[b]; }
            st = 2;  // glue: second use closes the edge
        }
    }

    bool try_seed(const Grid& g, double rho, int64_t& cursor) {
        for (int64_t i = cursor; i < n; ++i) {
            cursor = i + 1;
            if (used[i]) continue;
            // nearest unused-ish candidates around i
            std::vector<std::pair<double, int32_t>> cand;
            g.near(P(i), [&](int32_t j) {
                if (j == i) return;
                const double d2 = (P(j) - P(i)).norm2();
                if (d2 < 4 * rho * rho) cand.push_back({d2, j});
            });
            if (cand.size() < 2) continue;
            std::sort(cand.begin(), cand.end());
            const size_t kmax = std::min(cand.size(), (size_t)24);
            for (size_t u = 0; u < kmax; ++u) {
                for (size_t v = u + 1; v < kmax; ++v) {
                    const int64_t a = cand[u].second, b = cand[v].second;
                    if (used[a] && front_deg[a] <= 0) continue;
                    if (used[b] && front_deg[b] <= 0) continue;
                    if (estat.count(ekey(i, a)) && estat[ekey(i, a)] != 1) continue;
                    if (estat.count(ekey(i, b)) && estat[ekey(i, b)] != 1) continue;
                    V3 c;
                    if (!center(i, a, b, rho, c)) continue;
                    if (!ball_empty(g, c, rho, i, a, b)) continue;
                    // register edges in the cycle whose normal faces the
                    // ball center — the pivot rotation sense (w = axis x u)
                    // rolls away from the triangle only for that cycle
                    int64_t v0 = i, v1 = a, v2 = b;
                    const V3 nf = (P(v1) - P(v0)).cross(P(v2) - P(v0));
                    if (nf.dot(c - P(v0)) < 0) std::swap(v1, v2);
                    emit(v0, v1, v2);
                    add_edge(v0, v1, v2, c);
                    add_edge(v1, v2, v0, c);
                    add_edge(v2, v0, v1, c);
                    return true;
                }
            }
        }
        return false;
    }

    struct PivotResult { int32_t found; int32_t x; V3 c; };

    // read-only pivot search around front edge e (thread-safe: mutates
    // nothing; ball_empty uses only static point positions)
    PivotResult pivot_search(const Grid& g, const FrontEdge& e, double rho) const {
        const V3 pi = P(e.i), pj = P(e.j);
        const V3 m = (pi + pj) * 0.5;
        const V3 axis = (pj - pi).normalized();
        // reference direction of the current ball center around the edge
        V3 u0 = e.c - m;
        u0 = (u0 - axis * u0.dot(axis));
        const double u0n = u0.norm();
        if (u0n < 1e-15) return {0, -1, V3{}};
        const V3 u = u0 * (1.0 / u0n);
        V3 w = axis.cross(u);  // completes the rotation frame
        // rotation sense: roll AWAY from the old triangle's third vertex
        // (initial center motion w must oppose the in-plane direction
        // toward o) — intrinsic, independent of edge storage order
        V3 q = P(e.o) - m;
        q = q - axis * q.dot(axis);
        if (w.dot(q) > 0) w = w * -1.0;

        double best_theta = 1e300;
        int64_t best_x = -1;
        V3 best_c{};
        g.near(m, [&](int32_t x) {
            if (x == e.i || x == e.j || x == e.o) return;
            // Bernardini validity: the candidate must be unused or lie
            // on the front/boundary — interior vertices would let the
            // ball tunnel back over finished surface (duplicate sheets)
            if (used[x] && front_deg[x] <= 0) return;
            const double d2 = (P(x) - m).norm2();
            if (d2 > 4 * rho * rho) return;
            auto it1 = estat.find(ekey(e.i, x));
            if (it1 != estat.end() && it1->second == 2) return;
            auto it2 = estat.find(ekey(e.j, x));
            if (it2 != estat.end() && it2->second == 2) return;
            V3 cp, cn;
            if (!centers(e.i, e.j, x, rho, cp, cn)) return;
            // both centers lie on the pivot circle; the rolling ball
            // touches x at the SMALLER rotation angle of the two
            for (const V3& c : {cp, cn}) {
                V3 vc = c - m;
                vc = vc - axis * vc.dot(axis);
                double theta = std::atan2(w.dot(vc), u.dot(vc));
                // rotate AWAY from the previous triangle: angle in (eps, 2pi)
                if (theta < 1e-7) theta += 2 * M_PI;
                if (theta >= best_theta) continue;
                if (!ball_empty(g, c, rho, e.i, e.j, x)) continue;
                best_theta = theta;
                best_x = x;
                best_c = c;
            }
        });
        return {best_x >= 0, (int32_t)best_x, best_c};
    }

    // apply a successful pivot (serial; mutates the front state)
    void commit_pivot(const FrontEdge& e, const PivotResult& r) {
        emit(e.i, r.x, e.j);
        estat[ekey(e.i, e.j)] = 2;
        --front_deg[e.i]; --front_deg[e.j];
        add_edge(e.i, r.x, e.j, r.c);
        add_edge(r.x, e.j, e.i, r.c);
    }

    void run(const double* radii, int64_t n_radii) {
        // one grid per radius pass (cell = 2*rho covers both candidate
        // search around edge midpoints and empty-ball tests)
        for (int64_t ri = 0; ri < n_radii; ++ri) {
            const double rho = radii[ri];
            Grid g(pts, n, std::max(2 * rho, 1e-9));
            // reactivate boundary edges (pivot failures from smaller
            // radii) with a ball of the new, larger radius
            std::vector<FrontEdge> pending;
            std::swap(pending, boundary_records);
            for (auto& e : pending) {
                auto it = estat.find(ekey(e.i, e.j));
                if (it == estat.end() || it->second != 3) continue;  // glued since
                V3 c;
                if (center(e.i, e.j, e.o, rho, c)) {
                    it->second = 1;
                    e.c = c;
                    front.push_back(e);
                } else {
                    boundary_records.push_back(e);  // retry at next radius
                }
            }
            int64_t cursor = 0;
            int64_t ops = 0, ops_cap = 64 * n + 100000;
            // Parallel front processing with EXACT sequential semantics:
            // drain the next K front edges (the same K the serial loop
            // would process — commits only append new edges at the back),
            // run the read-only pivot searches across threads against the
            // pre-batch state, then commit serially in deque order. A
            // search is only reusable if no commit this batch touched its
            // 2*rho neighborhood (every state mutation — used, front_deg,
            // estat — lands on the 3 vertices of a committed triangle, and
            // pivot candidates live within 2*rho of the edge midpoint);
            // conflicting or failed searches re-run serially against the
            // live state, which reproduces the serial algorithm exactly.
            unsigned hw = std::thread::hardware_concurrency();
            if (const char* env = std::getenv("BPA_THREADS")) hw = (unsigned)std::atoi(env);
            hw = std::max(1u, std::min(hw, 64u));
            const size_t batch_cap = hw > 1 ? (size_t)hw * 4 : 1;
            std::vector<FrontEdge> batch;
            std::vector<PivotResult> results;
            std::vector<V3> touched;  // triangle vertices committed this batch
            while ((int64_t)tris.size() / 3 < max_tris && ops < ops_cap) {
                if (front.empty()) {
                    ++ops;
                    if (!try_seed(g, rho, cursor)) break;
                    continue;
                }
                batch.clear();
                // ops counts POPS (like the serial loop) so the runaway
                // cap fires at the same pop count for ANY thread count —
                // the determinism contract includes the capped case
                while (!front.empty() && batch.size() < batch_cap && ops < ops_cap) {
                    ++ops;
                    FrontEdge e = front.front();
                    front.pop_front();
                    auto it = estat.find(ekey(e.i, e.j));
                    if (it == estat.end() || it->second != 1) continue;  // stale
                    batch.push_back(e);
                }
                if (batch.empty()) continue;
                results.assign(batch.size(), PivotResult{0, -1, V3{}});
                if (hw > 1 && batch.size() >= 16) {
                    std::atomic<size_t> next{0};
                    auto worker = [&]() {
                        for (size_t i; (i = next.fetch_add(1)) < batch.size();)
                            results[i] = pivot_search(g, batch[i], rho);
                    };
                    std::vector<std::thread> threads;
                    const size_t nt = std::min((size_t)hw, batch.size());
                    threads.reserve(nt - 1);
                    for (size_t t = 1; t < nt; ++t) threads.emplace_back(worker);
                    worker();
                    for (auto& th : threads) th.join();
                } else {
                    for (size_t i = 0; i < batch.size(); ++i)
                        results[i] = pivot_search(g, batch[i], rho);
                }
                touched.clear();
                const double lim2 = 4 * rho * rho * (1.0 + 1e-9);
                for (size_t i = 0; i < batch.size(); ++i) {
                    if ((int64_t)tris.size() / 3 >= max_tris) break;
                    const FrontEdge& e = batch[i];
                    auto it = estat.find(ekey(e.i, e.j));
                    if (it == estat.end() || it->second != 1) continue;  // glued by an earlier commit
                    const V3 m = (P(e.i) + P(e.j)) * 0.5;
                    bool conflict = false;
                    for (const V3& v : touched)
                        if ((v - m).norm2() < lim2) { conflict = true; break; }
                    PivotResult r = conflict ? pivot_search(g, e, rho) : results[i];
                    if (r.found) {
                        commit_pivot(e, r);
                        touched.push_back(P(e.i));
                        touched.push_back(P(e.j));
                        touched.push_back(P(r.x));
                    } else {
                        it->second = 3;  // boundary at this radius
                        boundary_records.push_back(e);
                    }
                }
            }
        }
    }
};

}  // namespace

extern "C" {

// points/normals: (n, 3) float64; radii ascending; tris_out capacity
// max_tris*3 int64. Returns the number of triangles written.
int64_t bpa_reconstruct(const double* pts, const double* normals, int64_t n,
                        const double* radii, int64_t n_radii,
                        int64_t* tris_out, int64_t max_tris) {
    if (n < 3 || n_radii < 1) return 0;
    BPA bpa(pts, normals, n, max_tris);
    bpa.run(radii, n_radii);
    const int64_t nt = std::min((int64_t)bpa.tris.size() / 3, max_tris);
    if (nt > 0)
        std::memcpy(tris_out, bpa.tris.data(), (size_t)nt * 3 * sizeof(int64_t));
    return nt;
}

}  // extern "C"
