// Frozen copy of native/mser.cpp, kept as the benchmark's plain reference
// (see portbench/reference/__init__.py); later edits to the program do not
// reach it.  reference/mods/detect/mser.py builds it with g++ at first use.
// Native MSER component-tree detector (C++), exposed via C ABI for ctypes.
//
// TPU-native framework counterpart of the reference's CMP MSER
// (reference: detectors/mser/**).  The component tree is inherently
// sequential/irregular, so it runs on host as native code; ellipses feed
// the TPU pipeline like any other detector's output.
//
// This is a faithful re-implementation of the CMP margin-stability
// algorithm (not the Nister-Stewenius variant):
//  - pixels processed in increasing intensity, union-find over regions
//    (reference getExtrema.cpp ProcessPixel/MergeRegions)
//  - per-region per-level cumulative area/boundary stats; small regions
//    are tracked compactly and "upgraded" when they reach min_size, at
//    which point history attribution collapses to the upgrade level
//    (reference UpgradeRegion, getExtrema.cpp:103-143)
//  - merge keeps the region largest at the previous level; merged full
//    regions are finalized if their lifespan exceeds min_margin
//    (getExtrema.cpp:267-360)
//  - threshold selection: margin(i) = number of levels the region needs
//    to grow by its boundary length, non-max suppressed runs, threshold
//    at localMaxPos + margin/2, plus overlapping-threshold suppression
//    (optThresh.cpp FastSetOptThresholds4StableRegion /
//    SuppresOverlappingTresholds4StableRegions)
//  - ellipse from cumulative continuous second moments (equivalent of
//    boundary RLE + RLE2Ellipse, libExtrema.cpp:117-159: pixel (x,y)
//    integrates over [x,x+1]x[y,y+1] => center +0.5, variance +1/12)
//
// Build: g++ -O3 -shared -fPIC -o libmser.so mser.cpp

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <cmath>

namespace {

struct Snap {
    int level;
    int64_t area, border;
    double mx, my, mxx, mxy, myy;
};

struct Reg {
    int parent = -1;          // union-find (index), -1 = root
    bool full = false;
    bool dead = false;
    int min_int = 0;          // full: upgrade level (reference resets it)
    int max_int = 0;
    int last_level = 0;       // level of current accumulators
    int64_t area = 0, border = 0;
    double mx = 0, my = 0, mxx = 0, mxy = 0, myy = 0;
    std::vector<Snap> snaps;  // cumulative at END of snap.level
};

struct OutRegion {
    double x, y, a11, a12, a21, a22, s;
    double margin;
};

struct Pass {
    const uint8_t* img;
    int w, h;
    int min_size;
    int64_t max_size;
    double min_margin;
    std::vector<OutRegion>* out;

    std::vector<Reg> regs;
    std::vector<int32_t> label;    // per-pixel region index or -1

    int find(int r) {
        int root = r;
        while (regs[root].parent >= 0) root = regs[root].parent;
        while (regs[r].parent >= 0) {   // path compression
            int nxt = regs[r].parent;
            regs[r].parent = root;
            r = nxt;
        }
        return root;
    }

    void touch(Reg& R, int l) {
        if (R.last_level < l) {
            R.snaps.push_back({R.last_level, R.area, R.border,
                               R.mx, R.my, R.mxx, R.mxy, R.myy});
            R.last_level = l;
        }
    }

    int64_t area_before(Reg& R, int l) {
        if (R.last_level < l) return R.area;
        return R.snaps.empty() ? 0 : R.snaps.back().area;
    }

    void add_pixel(int ri, int x, int y, int l, int n_lab) {
        Reg& R = regs[ri];
        touch(R, l);
        R.area += 1;
        R.border += 4 - 2 * n_lab;     // InsMarkPixel: border_total += 4 - border_num
        double cx = x + 0.5, cy = y + 0.5;
        R.mx += cx; R.my += cy;
        R.mxx += cx * cx; R.mxy += cx * cy; R.myy += cy * cy;
        R.max_int = l;
        if (!R.full && R.area >= min_size) {
            // UpgradeRegion: history collapses to the upgrade level
            R.full = true;
            R.min_int = l;
            R.snaps.clear();
            R.last_level = l;
        }
    }

    // dense per-level forward-filled stats over [min_int, max_int]
    void finalize(Reg& R) {
        if (R.area < min_size) return;
        int lo = R.min_int, hi = R.max_int;
        int n = hi - lo + 1;
        if (n <= 1) return;
        std::vector<int64_t> A(n), B(n);
        std::vector<double> MX(n), MY(n), MXX(n), MXY(n), MYY(n);
        size_t si = 0;
        // snaps hold cumulative at END of snap.level; current accumulators
        // are cumulative at END of max_int
        int64_t ca = 0, cb = 0;
        double cmx = 0, cmy = 0, cmxx = 0, cmxy = 0, cmyy = 0;
        for (int i = 0; i < n; ++i) {
            int lev = lo + i;
            while (si < R.snaps.size() && R.snaps[si].level <= lev) {
                const Snap& s = R.snaps[si];
                ca = s.area; cb = s.border;
                cmx = s.mx; cmy = s.my; cmxx = s.mxx; cmxy = s.mxy; cmyy = s.myy;
                ++si;
            }
            if (lev >= R.last_level) {
                ca = R.area; cb = R.border;
                cmx = R.mx; cmy = R.my; cmxx = R.mxx; cmxy = R.mxy; cmyy = R.myy;
            }
            A[i] = ca; B[i] = cb;
            MX[i] = cmx; MY[i] = cmy; MXX[i] = cmxx; MXY[i] = cmxy; MYY[i] = cmyy;
        }

        // FastSetOptThresholds4StableRegion scan (optThresh.cpp:69-165)
        struct Th { int pos, margin, thresh; };
        std::vector<Th> ths;
        int i = 0, up = 0;
        int localMaxMargin = -1, localMaxPos = -1;
        auto emit_local = [&]() {
            if (localMaxPos >= 0) {
                int thresh = localMaxPos + localMaxMargin / 2;
                if (thresh < n && A[thresh] <= max_size && A[thresh] > min_size)
                    ths.push_back({localMaxPos, localMaxMargin, thresh});
                localMaxPos = -1;
            }
        };
        do {
            up = i + int(min_margin);
            if (up > n - 1) break;
            while (A[up] - A[i] < B[i] && up < n - 1) up++;
            int margin = up - i;
            double quality = (double)margin;
            if (quality > min_margin && margin >= localMaxMargin) {
                localMaxMargin = margin;
                localMaxPos = i;
            } else {
                emit_local();
                localMaxMargin = margin;
            }
            i++;
        } while (up < n - 1);
        emit_local();

        // SuppresOverlappingTresholds4StableRegions (optThresh.cpp:15-65)
        // pass 1: overlapping stable runs -> keep the higher margin
        for (size_t a = 0; a + 1 < ths.size();) {
            Th& t = ths[a];
            Th& nx = ths[a + 1];
            if ((t.pos + t.margin < nx.thresh) && (t.thresh < nx.pos)) {
                ++a;                       // no overlap
                continue;
            }
            if (nx.margin <= t.margin) ths.erase(ths.begin() + a + 1);
            else { ths.erase(ths.begin() + a); if (a) --a; }
        }
        // pass 2: merge runs whose areas differ by <= 10%
        for (size_t a = 0; a + 1 < ths.size();) {
            Th& t = ths[a];
            Th& nx = ths[a + 1];
            if (t.pos + t.margin < nx.pos) { ++a; continue; }
            if (A[nx.thresh] - A[t.thresh] <= 0.1 * (double)A[t.thresh]) {
                t.margin = nx.pos - t.pos + nx.margin;
                t.thresh = t.pos + t.margin / 2;
                if (t.thresh > n - 1) t.thresh = n - 1;
                ths.erase(ths.begin() + a + 1);
            } else ++a;
        }

        for (const Th& t : ths) {
            int ti = t.thresh;
            double area = (double)A[ti];
            if (area <= 0) continue;
            double cx = MX[ti] / area, cy = MY[ti] / area;
            double cxx = MXX[ti] / area - cx * cx + 1.0 / 12.0;
            double cyy = MYY[ti] / area - cy * cy + 1.0 / 12.0;
            double cxy = MXY[ti] / area - cx * cy;
            double tr = cxx + cyy, det = cxx * cyy - cxy * cxy;
            if (det <= 1e-12) continue;
            double sq = std::sqrt(std::max(tr * tr / 4 - det, 0.0));
            double l1 = tr / 2 + sq, l2 = tr / 2 - sq;
            if (l2 <= 1e-12) continue;
            // A = sqrtm(C) via eigen decomposition (utls Matrix2
            // schur_sym + sqrt, extrema.cpp:145-151)
            double theta = 0.5 * std::atan2(2 * cxy, cxx - cyy);
            double ct = std::cos(theta), st = std::sin(theta);
            double r1 = std::sqrt(l1), r2 = std::sqrt(l2);
            double a11 = ct * r1 * ct + st * r2 * st;
            double a12 = ct * r1 * st - st * r2 * ct;
            double a22 = st * r1 * st + ct * r2 * ct;
            double d2 = std::sqrt(std::abs(a11 * a22 - a12 * a12));
            if (d2 <= 1e-9) continue;
            OutRegion r;
            r.x = cx; r.y = cy;
            r.a11 = a11 / d2; r.a12 = a12 / d2;
            r.a21 = a12 / d2; r.a22 = a22 / d2;
            r.s = d2;           // sqrt|det sqrtm(C)| = (det C)^(1/4)
            r.margin = t.margin;
            out->push_back(r);
        }
    }

    void run() {
        const int n = w * h;
        label.assign(n, -1);
        regs.clear();
        regs.reserve(1 << 14);

        // counting sort: pixel offsets per intensity, scan order
        std::vector<int> hist(257, 0);
        for (int p = 0; p < n; ++p) hist[img[p] + 1]++;
        for (int i = 0; i < 256; ++i) hist[i + 1] += hist[i];
        std::vector<int32_t> order(n);
        {
            std::vector<int> cur(hist.begin(), hist.end() - 1);
            for (int p = 0; p < n; ++p) order[cur[img[p]]++] = p;
        }

        const int dx[4] = {-1, 0, 1, 0};
        const int dy[4] = {0, -1, 0, 1};
        int roots[4];

        for (int pi = 0; pi < n; ++pi) {
            int p = order[pi];
            int l = img[p];
            int x = p % w, y = p / w;
            int n_lab = 0, n_roots = 0;
            for (int e = 0; e < 4; ++e) {
                int nx2 = x + dx[e], ny2 = y + dy[e];
                if (nx2 < 0 || ny2 < 0 || nx2 >= w || ny2 >= h) continue;
                int lb = label[ny2 * w + nx2];
                if (lb < 0) continue;
                ++n_lab;
                int r = find(lb);
                bool seen = false;
                for (int q = 0; q < n_roots; ++q)
                    if (roots[q] == r) { seen = true; break; }
                if (!seen) roots[n_roots++] = r;
            }
            int target;
            if (n_roots == 0) {
                target = (int)regs.size();
                regs.push_back(Reg{});
                regs[target].min_int = l;
                regs[target].max_int = l;
                regs[target].last_level = l;
            } else if (n_roots == 1) {
                target = roots[0];
            } else {
                // MergeRegions: survivor = largest FULL region at the
                // previous level; simple merge into roots[0] otherwise
                int best = -1;
                int64_t bestSize = -1;
                for (int q = 0; q < n_roots; ++q) {
                    Reg& R = regs[roots[q]];
                    if (!R.full) continue;
                    int64_t sz = area_before(R, l);
                    if (sz > bestSize) { bestSize = sz; best = roots[q]; }
                }
                target = best >= 0 ? best : roots[0];
                Reg& S = regs[target];
                touch(S, l);
                for (int q = 0; q < n_roots; ++q) {
                    if (roots[q] == target) continue;
                    Reg& R = regs[roots[q]];
                    if (R.full) {
                        // margin pre-filter (getExtrema.cpp:344)
                        if (double(l - R.min_int + 1) > min_margin) {
                            touch(R, l);
                            R.max_int = l;
                            finalize(R);
                        }
                    }
                    S.area += R.area; S.border += R.border;
                    S.mx += R.mx; S.my += R.my;
                    S.mxx += R.mxx; S.mxy += R.mxy; S.myy += R.myy;
                    R.parent = target;
                    R.dead = true;
                    R.snaps.clear();
                    R.snaps.shrink_to_fit();
                }
            }
            label[p] = target;
            add_pixel(target, x, y, l, n_lab);
        }

        // the root region is finalized at the end (getExtrema.cpp:
        // "process the last region (root)")
        for (size_t r = 0; r < regs.size(); ++r)
            if (!regs[r].dead && regs[r].parent < 0 && regs[r].full)
                finalize(regs[r]);
    }
};

}  // namespace

extern "C" {

// Detect MSERs.  img: uint8 row-major [h,w].  Results written to out
// (capacity max_out rows of 8 doubles: x y a11 a12 a21 a22 s margin).
// Returns number of regions (<= max_out).  polarity: 0 = dark (MSER-),
// 1 = bright (MSER+ via inverted image), 2 = both.
int mser_detect(const uint8_t* img, int w, int h,
                int min_size, long long max_size,
                double min_margin,
                int polarity, double* out, int max_out) {
    std::vector<OutRegion> all;
    std::vector<uint8_t> buf;
    for (int pol = 0; pol < 2; ++pol) {
        if (polarity != 2 && polarity != pol) continue;
        Pass c;
        c.w = w; c.h = h;
        c.min_size = min_size;
        c.max_size = max_size;
        c.min_margin = min_margin;
        c.out = &all;
        if (pol == 0) {
            c.img = img;
        } else {
            buf.resize(size_t(w) * h);
            for (size_t i = 0; i < buf.size(); ++i) buf[i] = 255 - img[i];
            c.img = buf.data();
        }
        c.run();
    }
    // margin-ranked output (prepareKeysForExport sorts by |response|)
    std::sort(all.begin(), all.end(),
              [](const OutRegion& a, const OutRegion& b) {
                  return a.margin > b.margin;
              });
    int n = std::min<int>((int)all.size(), max_out);
    for (int i = 0; i < n; ++i) {
        const OutRegion& r = all[i];
        double* row = out + 8 * i;
        row[0] = r.x; row[1] = r.y;
        row[2] = r.a11; row[3] = r.a12;
        row[4] = r.a21; row[5] = r.a22;
        row[6] = r.s; row[7] = r.margin;
    }
    return n;
}

}  // extern "C"
