// One-call batched host-geometry pass: for every ROI of a slide, compute all
// contour/hull/caliper/chord/radius/radial host features in a single native
// invocation fanned over a thread pool.  This replaces the per-family Python
// loops (the reference runs the same families on std::async CPU threads,
// reference: src/nyx/parallel.h:23-42); each per-ROI algorithm is the same
// semantic port already vetted in geomfeats.cpp / contour.cpp and pinned by
// the Python oracles in nyxus_tpu/pipeline/hostfeats.py.
//
// Inputs are concatenated per-ROI arrays + offsets (cloud pixels in raster
// order, merged contours in trace order), one [n, 9] rec table, and a group
// bitmask selecting which feature groups to compute.  Output is one
// [n, NYX_GEOM_W] matrix (Python pre-fills the per-family sentinel values;
// this kernel only writes computed entries) plus an optional flat per-pixel
// log-weight array for the weighted-moment device kernels.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <thread>
#include <vector>

// cross-TU entry points (contour.cpp, geomfeats.cpp)
extern "C" int nyx_convex_hull(const int64_t* xs, const int64_t* ys, int npts,
                               double* out);
extern "C" void nyx_contour_sqdist_approx(const double* px, const double* py,
                                          long n, const double* cx,
                                          const double* cy, long nc,
                                          double* out_min, double* out_max);
extern "C" void nyx_caliper_feret_one(const double* hx, const double* hy,
                                      long k, double* out);
extern "C" void nyx_caliper_martin_one(const double* hx, const double* hy,
                                       long k, double* out);
extern "C" void nyx_caliper_nassenstein_one(const double* hx, const double* hy,
                                            long k, double* out);
extern "C" void nyx_chords_one(const int64_t* gx, const int64_t* gy,
                               const double* inten, long n, long x0, long x1,
                               long y0, long y1, double* out);

namespace {

// group bits (mirror nyxus_tpu/pipeline/hostfeats.py GEOM_GROUPS)
enum {
    G_CONTOUR = 1 << 0,   // PERIMETER + EDGE_* (contour.cpp:935-987)
    G_FRACTAL = 1 << 1,   // FRACT_DIM_PERIMETER (fractal_dim.cpp:96-125)
    G_HULL = 1 << 2,      // CONVEX_HULL_AREA/SOLIDITY/CIRCULARITY
    G_FERET = 1 << 3,
    G_MARTIN = 1 << 4,
    G_NASS = 1 << 5,
    G_CHORDS = 1 << 6,
    G_RADIUS = 1 << 7,    // ROI_RADIUS_* (roi_radius.cpp:11-37)
    G_RADIAL = 1 << 8,    // FRAC_AT_D/MEAN_FRAC/RADIAL_CV
    G_LOGW = 1 << 9,      // weighted-moment log distances
    G_LOGW_D2 = 1 << 10,  // with G_LOGW: emit the RAW squared distances
                          // (exact small integers) so the caller can ship
                          // them to the device compactly and take
                          // log(sqrt(d2)+eps) there
};

// column layout (mirror GEOM_COLS in hostfeats.py)
enum {
    C_PERIM = 0, C_DIAM_EQ_PERIM, C_EDGE_MEAN, C_EDGE_STD, C_EDGE_MAX,
    C_EDGE_MIN, C_EDGE_INTEG,                      // 0..6
    C_FRACT_PERIM = 7,                             // 7
    C_HULL_AREA = 8, C_SOLIDITY, C_CIRCULARITY,    // 8..10
    C_FERET = 11,                                  // 11..18 (8)
    C_MARTIN = 19,                                 // 19..24 (6)
    C_NASS = 25,                                   // 25..30 (6)
    C_CHORDS = 31,                                 // 31..46 (16)
    C_RRAD = 47,                                   // 47..49 (3)
    C_FRAC_AT_D = 50,                              // 50..57
    C_MEAN_FRAC = 58,                              // 58..65
    C_RADIAL_CV = 66,                              // 66..73
    GEOM_W = 74,
};

long long igcd(long long a, long long b) {
    a = a < 0 ? -a : a;
    b = b < 0 ? -b : b;
    while (b) { long long t = a % b; a = b; b = t; }
    return a;
}

// FRACT_DIM_PERIMETER ruler walk + log-log slope
// (reference: fractal_dim.cpp:96-125; oracle: registry._fractal_perimeter_host)
double fract_dim_perimeter(const double* px, const double* py, long clen) {
    if (clen < 3) return 0.0;
    std::vector<double> la, lb;
    for (long s = clen / 4; s > 0; s /= 2) {
        double perim = 0.0;
        long nsteps = 0;
        long j = 0;
        // j = 0, s, 2s, ... while j + s < clen (arange(0, clen-s, s))
        for (j = 0; j + s < clen; j += s) {
            double dx = px[j + s] - px[j], dy = py[j + s] - py[j];
            perim += std::sqrt(dx * dx + dy * dy);
            nsteps++;
        }
        double dx = px[j] - px[0], dy = py[j] - py[0];
        perim += std::sqrt(dx * dx + dy * dy);
        nsteps++;
        double a = perim / (double)nsteps;
        if (a > 0 && perim > 0) { la.push_back(std::log(a));
                                  lb.push_back(std::log(perim)); }
    }
    if (la.size() < 2) return 1.0;
    double n = (double)la.size(), sx = 0, sy = 0, sxx = 0, sxy = 0;
    for (size_t i = 0; i < la.size(); i++) {
        sx += la[i]; sy += lb[i]; sxx += la[i] * la[i]; sxy += la[i] * lb[i];
    }
    double denom = sxx * n - sx * sx;
    double slope = denom == 0 ? 0.0 : (sxy * n - sx * sy) / denom;
    return 1.0 - slope;
}

struct GeomIn {
    const int64_t* gx;      // cloud global x, concatenated
    const int64_t* gy;
    const double* inten;    // cloud intensity
    const int64_t* coff;    // [n+1] cloud offsets
    const int64_t* ctr;     // contour triples (x, y, inten), local +1 coords
    const int64_t* koff;    // [n+1] contour POINT offsets
    const int64_t* recs;    // [n, 9] x0, x1, y0, y1, rx0, rx1, ry0, ry1, area
    const uint8_t* flags;   // bit0 has_cloud, bit1 hull_from_points
    const int64_t* hpts;    // hull candidate (x, y) pairs, global coords
    const int64_t* hoff;    // [n+1] hull candidate POINT offsets
    long n;
    uint32_t groups;
    double logw_eps;
    double* out;            // [n, GEOM_W]
    double* logw;           // flat, aligned with coff (nullable)
};

void geom_one(const GeomIn& in, long r) {
    const int64_t* rec = in.recs + r * 9;
    long x0 = rec[0], y0 = rec[2];
    long rx0 = rec[4], rx1 = rec[5], ry0 = rec[6], ry1 = rec[7];
    double roi_area = (double)rec[8];
    long ca = in.coff[r], cb = in.coff[r + 1];
    long P = cb - ca;
    long ka = in.koff[r], kb = in.koff[r + 1];
    long K = kb - ka;
    bool has_cloud = in.flags[r] & 1;
    bool hull_from_points = in.flags[r] & 2;
    double* out = in.out + r * GEOM_W;

    // contour coords as double (local +1)
    std::vector<double> cxv(K), cyv(K);
    for (long i = 0; i < K; i++) {
        cxv[i] = (double)in.ctr[(ka + i) * 3];
        cyv[i] = (double)in.ctr[(ka + i) * 3 + 1];
    }

    double perim = 0.0;
    if (K > 0 && (in.groups & (G_CONTOUR | G_HULL | G_FRACTAL))) {
        for (long i = 0; i < K; i++) {
            long j = i == 0 ? K - 1 : i - 1;   // roll(pts, 1): dist to prev
            double dx = cxv[i] - cxv[j], dy = cyv[i] - cyv[j];
            perim += std::sqrt(dx * dx + dy * dy);
        }
    }
    if (K > 0 && (in.groups & G_CONTOUR)) {
        out[C_PERIM] = perim;
        out[C_DIAM_EQ_PERIM] = perim / M_PI;
        double s = 0, mn = 0, mx = 0;
        for (long i = 0; i < K; i++) {
            double v = (double)in.ctr[(ka + i) * 3 + 2];
            s += v;
            if (i == 0) { mn = mx = v; }
            else { mn = std::min(mn, v); mx = std::max(mx, v); }
        }
        double mean = s / (double)K;
        double ss = 0;
        for (long i = 0; i < K; i++) {
            double v = (double)in.ctr[(ka + i) * 3 + 2] - mean;
            ss += v * v;
        }
        out[C_EDGE_MEAN] = mean;
        out[C_EDGE_STD] = K > 2 ? std::sqrt(ss / (double)(K - 1)) : 0.0;
        out[C_EDGE_MAX] = mx;
        out[C_EDGE_MIN] = mn;
        out[C_EDGE_INTEG] = s;
    }
    if (K >= 3 && (in.groups & G_FRACTAL))
        out[C_FRACT_PERIM] = fract_dim_perimeter(cxv.data(), cyv.data(), K);

    // ---- convex hull (global coordinates) + calipers --------------------
    bool want_hull = in.groups & (G_HULL | G_FERET | G_MARTIN | G_NASS);
    if (want_hull) {
        const int64_t* hxs = nullptr;
        const int64_t* hys = nullptr;
        long npts = 0;
        std::vector<int64_t> tx, ty;
        if (hull_from_points) {
            // oversized: each column's top and bottom pixel, the only pixels
            // that can be hull vertices (the contour can miss some)
            long ha = in.hoff[r], hb = in.hoff[r + 1];
            npts = hb - ha;
            tx.resize(npts); ty.resize(npts);
            for (long i = 0; i < npts; i++) {
                tx[i] = in.hpts[(ha + i) * 2];
                ty[i] = in.hpts[(ha + i) * 2 + 1];
            }
            hxs = tx.data(); hys = ty.data();
        } else if (has_cloud && P > 0) {
            hxs = in.gx + ca; hys = in.gy + ca; npts = P;
        }
        if (npts > 0) {
            std::vector<double> hull(2 * (npts + 4));
            int k = nyx_convex_hull(hxs, hys, (int)npts, hull.data());
            if (in.groups & G_HULL) {
                double area2 = 0;
                long long bpts = 0;
                for (int i = 0; i < k; i++) {
                    int j = (i + 1) % k;
                    area2 += hull[2 * i] * hull[2 * j + 1] -
                             hull[2 * i + 1] * hull[2 * j];
                    bpts += igcd((long long)(hull[2 * i] - hull[2 * j]),
                                 (long long)(hull[2 * i + 1] - hull[2 * j + 1]));
                }
                double s_hull = (k ? std::fabs(area2) / 2.0 : 0.0)
                                + (double)bpts / 2.0 + 1.0;
                out[C_HULL_AREA] = s_hull;
                out[C_SOLIDITY] = s_hull > 0 ? roi_area / s_hull : 0.0;
                if (perim > 0)
                    out[C_CIRCULARITY] =
                        std::sqrt(4.0 * M_PI * roi_area / (perim * perim));
            }
            if (k > 0 && (in.groups & (G_FERET | G_MARTIN | G_NASS))) {
                std::vector<double> hx(k), hy(k);
                for (int i = 0; i < k; i++) { hx[i] = hull[2 * i];
                                              hy[i] = hull[2 * i + 1]; }
                if (in.groups & G_FERET)
                    nyx_caliper_feret_one(hx.data(), hy.data(), k,
                                          out + C_FERET);
                if (in.groups & G_MARTIN)
                    nyx_caliper_martin_one(hx.data(), hy.data(), k,
                                           out + C_MARTIN);
                if ((in.groups & G_NASS) && k >= 3)
                    nyx_caliper_nassenstein_one(hx.data(), hy.data(), k,
                                                out + C_NASS);
            }
        }
    }

    if (!has_cloud || P == 0) return;

    if (in.groups & G_CHORDS)
        nyx_chords_one(in.gx + ca, in.gy + ca, in.inten + ca, P,
                       rx0, rx1, ry0, ry1, out + C_CHORDS);

    // ---- approximate contour distances (pixel.cpp:36-143) ---------------
    bool want_min = in.groups & (G_RADIUS | G_RADIAL | G_LOGW);
    bool want_max = in.groups & G_RADIAL;
    if (!(want_min || want_max) || K == 0) return;
    std::vector<double> lx(P), ly(P), mind2, maxd2;
    for (long i = 0; i < P; i++) {
        lx[i] = (double)(in.gx[ca + i] - x0);
        ly[i] = (double)(in.gy[ca + i] - y0);
    }
    if (want_min) mind2.resize(P);
    if (want_max) maxd2.resize(P);
    nyx_contour_sqdist_approx(lx.data(), ly.data(), P, cxv.data(), cyv.data(),
                              K, want_min ? mind2.data() : nullptr,
                              want_max ? maxd2.data() : nullptr);

    if ((in.groups & G_LOGW) && in.logw) {
        if (in.groups & G_LOGW_D2)
            for (long i = 0; i < P; i++) in.logw[ca + i] = mind2[i];
        else
            for (long i = 0; i < P; i++)
                in.logw[ca + i] = std::log(std::sqrt(mind2[i]) + in.logw_eps);
    }

    if (in.groups & G_RADIUS) {
        double s = 0, mx = mind2[0];
        for (long i = 0; i < P; i++) { s += mind2[i];
                                       mx = std::max(mx, mind2[i]); }
        out[C_RRAD] = s / (double)P;
        out[C_RRAD + 1] = mx;
        // median over uint-truncated distances (TrivialHistogram,
        // reference: histogram.h:352)
        std::vector<uint32_t> d(P);
        for (long i = 0; i < P; i++) d[i] = (uint32_t)mind2[i];
        std::sort(d.begin(), d.end());
        long half = P / 2;
        out[C_RRAD + 2] = P % 2 ? (double)d[half]
                                : ((double)d[half] + (double)d[half - 1]) / 2.0;
    }

    if (in.groups & G_RADIAL) {
        // center = cloud pixel minimizing (approx max d2 - approx min d2)
        // (reference: radial_distribution.cpp:43-165)
        const int NB = 8;
        const double eps = 1e-9;
        long idxO = 0;
        double best = maxd2[0] - mind2[0];
        for (long i = 1; i < P; i++) {
            double v = maxd2[i] - mind2[i];
            if (v < best) { best = v; idxO = i; }
        }
        double cx = (double)(long)lx[idxO], cy = (double)(long)ly[idxO];
        double dstOC = std::sqrt(maxd2[idxO]);
        double counts[NB] = {0}, intb[NB] = {0}, wedges[NB][NB] = {{0}};
        for (long i = 0; i < P; i++) {
            double dx = lx[i] - cx, dy = ly[i] - cy;
            double dstOA = std::sqrt(dx * dx + dy * dy);
            double rat = dstOC > 0 ? dstOA / dstOC : 0.0;
            long bi = (long)(rat * (NB - 1));
            if (bi > NB - 1) bi = NB - 1;
            double ang = std::atan2(dy, dx);
            if (ang < 0) ang = 2.0 * M_PI + ang;
            long wb = (long)(ang / (2.0 * M_PI / NB));
            if (wb > NB - 1) wb = NB - 1;
            counts[bi] += 1.0;
            intb[bi] += in.inten[ca + i];
            wedges[bi][wb] += in.inten[ca + i];
        }
        for (int b = 0; b < NB; b++) {
            out[C_FRAC_AT_D + b] = counts[b] / ((double)P + eps);
            out[C_MEAN_FRAC + b] = intb[b] / (counts[b] + eps);
            double wm = 0;
            for (int w = 0; w < NB; w++) wm += wedges[b][w];
            wm /= (double)NB;
            double wv = 0;
            for (int w = 0; w < NB; w++)
                wv += (wedges[b][w] - wm) * (wedges[b][w] - wm);
            wv /= (double)NB;
            out[C_RADIAL_CV + b] = std::sqrt(wv) / (wm + eps);
        }
    }
}

}  // namespace

extern "C" {

int nyx_geom_width() { return GEOM_W; }

void nyx_geom_batch(const int64_t* gx, const int64_t* gy, const double* inten,
                    const int64_t* coff, const int64_t* ctr,
                    const int64_t* koff, const int64_t* recs,
                    const uint8_t* flags, const int64_t* hpts,
                    const int64_t* hoff, long n, uint32_t groups,
                    double logw_eps, double* out, double* logw,
                    int n_threads) {
    GeomIn in{gx, gy, inten, coff, ctr, koff, recs, flags, hpts, hoff, n,
              groups, logw_eps, out, logw};
    if (n_threads <= 1 || n < 4) {
        for (long r = 0; r < n; r++) geom_one(in, r);
        return;
    }
    // interleaved assignment balances the per-ROI cost skew better than
    // contiguous chunks (cloud sizes vary 10-100x)
    std::vector<std::thread> ts;
    for (int t = 0; t < n_threads; t++)
        ts.emplace_back([&in, t, n_threads]() {
            for (long r = t; r < in.n; r += n_threads) geom_one(in, r);
        });
    for (auto& t : ts) t.join();
}

// ---------------------------------------------------------------------------
// Cross-ROI neighbors (reference: neighbors.cpp; oracle:
// hostfeats.neighbors_features).  out[n, 9]: NUM_NEIGHBORS, PERCENT_TOUCHING,
// CLOSEST1_DIST, CLOSEST1_ANG, CLOSEST2_DIST, CLOSEST2_ANG, ANG_MEAN,
// ANG_STDDEV, ANG_MODE.  Pair phase uses AABB-with-radius prefilter then an
// exact contour-to-contour distance scan, matching the oracle's append order.

void nyx_neighbors_batch(const double* kx, const double* ky,
                         const int64_t* koff, const int64_t* aabbs /*[n,4]*/,
                         const double* cenx, const double* ceny, double radius,
                         long n, double* out /*[n,9]*/, int n_threads) {
    double radius2 = radius * radius;
    std::vector<std::vector<long>> neigh(n);
    std::vector<std::vector<uint8_t>> touch(n);
    for (long i = 0; i < n; i++) touch[i].assign(koff[i + 1] - koff[i], 0);

    struct PairRes {
        long i1, i2;
        bool neighbor;
        std::vector<long> t1, t2;   // touching point indices
    };
    // collect candidate pairs (upper triangle, oracle iteration order)
    std::vector<std::pair<long, long>> cand;
    for (long i1 = 0; i1 < n; i1++) {
        long x0a = aabbs[i1 * 4], x1a = aabbs[i1 * 4 + 1];
        long y0a = aabbs[i1 * 4 + 2], y1a = aabbs[i1 * 4 + 3];
        for (long i2 = i1 + 1; i2 < n; i2++) {
            if ((double)x0a - radius > (double)aabbs[i2 * 4 + 1] ||
                (double)x1a + radius < (double)aabbs[i2 * 4] ||
                (double)y0a - radius > (double)aabbs[i2 * 4 + 3] ||
                (double)y1a + radius < (double)aabbs[i2 * 4 + 2])
                continue;
            if (koff[i1 + 1] - koff[i1] == 0 || koff[i2 + 1] - koff[i2] == 0)
                continue;
            cand.emplace_back(i1, i2);
        }
    }
    std::vector<PairRes> results(cand.size());
    auto worker = [&](size_t lo, size_t hi) {
        for (size_t c = lo; c < hi; c++) {
            long i1 = cand[c].first, i2 = cand[c].second;
            long a1 = koff[i1], b1 = koff[i1 + 1];
            long a2 = koff[i2], b2 = koff[i2 + 1];
            PairRes& pr = results[c];
            pr.i1 = i1; pr.i2 = i2;
            double mind = 1e300;
            std::vector<double> min1(b1 - a1, 1e300), min2(b2 - a2, 1e300);
            for (long p = a1; p < b1; p++) {
                double px = kx[p], py = ky[p];
                for (long q = a2; q < b2; q++) {
                    double dx = px - kx[q], dy = py - ky[q];
                    double d2 = dx * dx + dy * dy;
                    if (d2 < min1[p - a1]) min1[p - a1] = d2;
                    if (d2 < min2[q - a2]) min2[q - a2] = d2;
                    if (d2 < mind) mind = d2;
                }
            }
            for (long p = 0; p < b1 - a1; p++)
                if (min1[p] <= 2.0) pr.t1.push_back(p);
            for (long q = 0; q < b2 - a2; q++)
                if (min2[q] <= 2.0) pr.t2.push_back(q);
            pr.neighbor = mind <= radius2;
        }
    };
    if (n_threads <= 1 || cand.size() < 8) {
        worker(0, cand.size());
    } else {
        std::vector<std::thread> ts;
        size_t chunk = (cand.size() + n_threads - 1) / n_threads;
        for (int t = 0; t < n_threads; t++) {
            size_t lo = t * chunk, hi = std::min(cand.size(), lo + chunk);
            if (lo >= hi) break;
            ts.emplace_back(worker, lo, hi);
        }
        for (auto& t : ts) t.join();
    }
    for (auto& pr : results) {
        for (long p : pr.t1) touch[pr.i1][p] = 1;
        for (long q : pr.t2) touch[pr.i2][q] = 1;
        if (pr.neighbor) { neigh[pr.i1].push_back(pr.i2);
                           neigh[pr.i2].push_back(pr.i1); }
    }
    auto dir_ang = [](double x1, double y1, double x2, double y2) {
        double a = std::atan2(y2 - y1, x2 - x1) * 180.0 / M_PI;
        return a < 0 ? a + 360.0 : a;
    };
    for (long i = 0; i < n; i++) {
        double* o = out + i * 9;
        o[0] = (double)neigh[i].size();
        long K = koff[i + 1] - koff[i];
        if (K > 0) {
            long t = 0;
            for (uint8_t v : touch[i]) t += v;
            o[1] = 100.0 * (double)t / (double)K;
        }
        if (neigh[i].empty()) continue;
        std::vector<double> dists, angs;
        for (long j : neigh[i]) {
            dists.push_back(std::hypot(cenx[i] - cenx[j], ceny[i] - ceny[j]));
            angs.push_back(dir_ang(cenx[i], ceny[i], cenx[j], ceny[j]));
        }
        size_t k1 = std::min_element(dists.begin(), dists.end())
                    - dists.begin();
        o[2] = dists[k1];
        o[3] = dir_ang(cenx[i], ceny[i], cenx[neigh[i][k1]],
                       ceny[neigh[i][k1]]);
        if (dists.size() > 1) {
            std::vector<double> d2(dists);
            d2[k1] = 1e300;
            size_t k2 = std::min_element(d2.begin(), d2.end()) - d2.begin();
            o[4] = dists[k2];
            o[5] = dir_ang(cenx[i], ceny[i], cenx[neigh[i][k2]],
                           ceny[neigh[i][k2]]);
        }
        double mean = 0;
        for (double a : angs) mean += a;
        mean /= (double)angs.size();
        double ss = 0;
        for (double a : angs) ss += (a - mean) * (a - mean);
        o[6] = mean;
        o[7] = angs.size() > 2
                   ? std::sqrt(ss / (double)(angs.size() - 1)) : 0.0;
        long counts[361] = {0};
        for (double a : angs) {
            // half-to-even to match the Python oracle's int(round(a))
            // (neighbors_features_py); lround's half-away-from-zero binned
            // exact .5-degree angles one bin higher (ADVICE r3)
            long b = (long)std::nearbyint(a);
            if (b < 0) b = 0;
            if (b > 360) b = 360;
            counts[b]++;
        }
        long bi = 0, bc = counts[0];
        for (long b = 1; b <= 360; b++)
            if (counts[b] > bc) { bc = counts[b]; bi = b; }
        o[8] = (double)bi;
    }
}

}  // extern "C"
