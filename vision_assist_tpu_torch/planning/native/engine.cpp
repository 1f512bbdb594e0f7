// Native exact planning engine: penalty field + curvature-penalised A*.
//
// Bit-compatible C++ implementation of the host twin (golden/lattice.py,
// golden/astar.py), which itself reproduces the reference pipeline
// decision-for-decision (PenaltyCalculator.py:57-142, PathFinder.py:119-186,
// including stale heap priorities and the radians/degrees cache quirk).
// All floating point is IEEE double with the same operation order as the
// numpy twin, so results are identical bits, ~100x faster than Python —
// this is the host-side planner of the exact engine, for single-stream parity
// mode, while the device engines serve the other modes.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this environment).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <queue>
#include <unordered_map>
#include <vector>

namespace {

struct VecKey {
    // (prev dx, prev dy, next dx, next dy), each a multiple of grid size and
    // bounded by +/- 3 * grid, packed into 64 bits.
    uint64_t packed;
    bool operator==(const VecKey& o) const { return packed == o.packed; }
};

struct VecKeyHash {
    size_t operator()(const VecKey& k) const {
        uint64_t x = k.packed * 0x9E3779B97F4A7C15ull;
        x ^= x >> 32;
        return static_cast<size_t>(x);
    }
};

inline uint64_t pack4(int a, int b, int c, int d) {
    auto u = [](int v) -> uint64_t {
        return static_cast<uint64_t>(static_cast<uint16_t>(static_cast<int16_t>(v)));
    };
    return (u(a) << 48) | (u(b) << 32) | (u(c) << 16) | u(d);
}

struct AngleCache {
    std::unordered_map<VecKey, double, VecKeyHash> map;
};

struct Params {
    int grid_size;
    int window;
    double grace_deg;
    double exponent;
    double denominator;
    double penalty_w;
    double angle_w;
    int bug_mode;  // 1 = cache stores radians (reference quirk), 0 = degrees
};

const double kDegPerRad = 45.0 / atan(1.0);

// Max window angle over the path (pixel coordinates), reference
// PathFinder._angle_between_grids (PathFinder.py:51-101).
double max_window_angle(const std::vector<std::pair<int, int>>& path,
                        const Params& p, AngleCache* cache) {
    const int n = static_cast<int>(path.size());
    if (n < p.window) return 0.0;
    const int half = p.window / 2;
    double best = 0.0;
    bool any = false;
    for (int i = half; i < n - half - 1; ++i) {
        const int pvx = path[i].first - path[i - half].first;
        const int pvy = path[i].second - path[i - half].second;
        const int nvx = path[i + half].first - path[i + 1].first;
        const int nvy = path[i + half].second - path[i + 1].second;
        VecKey key{pack4(pvx, pvy, nvx, nvy)};
        auto it = cache->map.find(key);
        double angle;
        if (it != cache->map.end()) {
            angle = it->second;
        } else {
            const double dot = double(pvx) * nvx + double(pvy) * nvy;
            const double mp = sqrt(double(pvx) * pvx + double(pvy) * pvy);
            const double mn = sqrt(double(nvx) * nvx + double(nvy) * nvy);
            if (mp == 0.0 || mn == 0.0) continue;
            double c = dot / (mp * mn);
            if (c > 1.0) c = 1.0;
            if (c < -1.0) c = -1.0;
            const double radians = acos(c);
            angle = radians * kDegPerRad;
            cache->map.emplace(key, p.bug_mode ? radians : angle);
        }
        if (!any || angle > best) { best = angle; any = true; }
    }
    return any ? best : 0.0;
}

inline double angle_penalty(double angle, const Params& p) {
    if (angle <= p.grace_deg) return 0.0;
    return pow(angle / p.denominator, p.exponent);
}

struct HeapEntry {
    double f;
    int x, y;  // pixel coords; ties break lexicographically like Python tuples
    bool operator>(const HeapEntry& o) const {
        if (f != o.f) return f > o.f;
        if (x != o.x) return x > o.x;
        return y > o.y;
    }
};

}  // namespace

extern "C" {

void* va_cache_new() { return new AngleCache(); }
void va_cache_free(void* h) { delete static_cast<AngleCache*>(h); }
int64_t va_cache_size(void* h) {
    return static_cast<int64_t>(static_cast<AngleCache*>(h)->map.size());
}

// Penalty field, reference PenaltyCalculator.py:57-142 (row-major out).
void va_penalty_field(const uint8_t* walkable, int rows, int cols,
                      double saturation, double gain, double* out) {
    std::vector<int> rstart(rows * cols), rend(rows * cols);
    std::vector<int> cstart(rows * cols), cend(rows * cols);
    for (int r = 0; r < rows; ++r) {
        int start = 0;
        for (int c = 0; c < cols; ++c) {
            if (!walkable[r * cols + c]) { start = c + 1; continue; }
            rstart[r * cols + c] = start;
        }
        int end = cols - 1;
        for (int c = cols - 1; c >= 0; --c) {
            if (!walkable[r * cols + c]) { end = c - 1; continue; }
            rend[r * cols + c] = end;
        }
    }
    for (int c = 0; c < cols; ++c) {
        int start = 0;
        for (int r = 0; r < rows; ++r) {
            if (!walkable[r * cols + c]) { start = r + 1; continue; }
            cstart[r * cols + c] = start;
        }
        int end = rows - 1;
        for (int r = rows - 1; r >= 0; --r) {
            if (!walkable[r * cols + c]) { end = r - 1; continue; }
            cend[r * cols + c] = end;
        }
    }
    for (int r = 0; r < rows; ++r) {
        for (int c = 0; c < cols; ++c) {
            const int i = r * cols + c;
            if (!walkable[i]) { out[i] = 0.0; continue; }
            const double rd = double(rend[i] - rstart[i]);
            const double row_ratio = rd == 0.0 ? 0.5 : double(c - rstart[i]) / rd;
            const double row_p = 2.0 * fabs(row_ratio - 0.5);
            const double cd = double(cend[i] - cstart[i]);
            const double col_ratio = cd == 0.0 ? 0.5 : double(r - cstart[i]) / cd;
            const double col_p = 2.0 * fabs(col_ratio - 0.5);
            if (row_p > saturation || col_p > saturation) { out[i] = 1.0; continue; }
            const double total = row_p + col_p;
            if (total == 0.0) { out[i] = 0.0; continue; }
            const double dom = fabs(row_p - col_p) / total;
            const double row_w = row_p > col_p ? 0.5 + gain * dom : 0.5 - gain * dom;
            out[i] = row_p * row_w + col_p * (1.0 - row_w);
        }
    }
}

// Exact A*, reference PathFinder.py:119-186 via the host twin's formulation.
// Returns path length (cells) or 0 if unreachable / overflow; path as
// (row, col) pairs into out_path.
int va_find_path(const uint8_t* walkable, const double* penalty,
                 int rows, int cols, int start_r, int start_c,
                 int goal_r, int goal_c, int grid_size, int window,
                 double grace_deg, double exponent, double denominator,
                 double penalty_w, double angle_w, int bug_mode,
                 void* cache_handle, int32_t* out_path, int max_len,
                 double* out_cost) {
    Params p{grid_size, window, grace_deg, exponent, denominator,
             penalty_w, angle_w, bug_mode};
    AngleCache local_cache;
    AngleCache* cache = cache_handle ? static_cast<AngleCache*>(cache_handle)
                                     : &local_cache;

    const int n = rows * cols;
    const double INF = 1e300;
    std::vector<double> g(n, INF);
    std::vector<int> came(n, -1);
    std::vector<uint8_t> closed(n, 0), in_open(n, 0);

    auto idx_of = [cols](int r, int c) { return r * cols + c; };
    const int gx = goal_c * grid_size, gy = goal_r * grid_size;
    auto heuristic = [&](int x, int y) {
        return double(abs(x - gx) + abs(y - gy));
    };

    std::priority_queue<HeapEntry, std::vector<HeapEntry>,
                        std::greater<HeapEntry>> open;
    const int sx = start_c * grid_size, sy = start_r * grid_size;
    g[idx_of(start_r, start_c)] = 0.0;
    open.push({heuristic(sx, sy), sx, sy});
    in_open[idx_of(start_r, start_c)] = 1;

    // Neighbour order right, left, down, up (FrameProcessor.py:195-200).
    const int dxs[4] = {grid_size, -grid_size, 0, 0};
    const int dys[4] = {0, 0, grid_size, -grid_size};

    std::vector<std::pair<int, int>> path_so_far;
    path_so_far.reserve(n);

    while (!open.empty()) {
        HeapEntry e = open.top();
        open.pop();
        const int cx = e.x, cy = e.y;
        const int cr = cy / grid_size, cc = cx / grid_size;
        const int ci = idx_of(cr, cc);
        in_open[ci] = 0;

        if (cr == goal_r && cc == goal_c) {
            // Reconstruct.
            std::vector<int> rev;
            int node = ci;
            while (node != -1) { rev.push_back(node); node = came[node]; }
            const int len = static_cast<int>(rev.size());
            if (len > max_len) return 0;
            for (int i = 0; i < len; ++i) {
                const int v = rev[len - 1 - i];
                out_path[2 * i] = v / cols;
                out_path[2 * i + 1] = v % cols;
            }
            *out_cost = g[ci];
            return len;
        }
        closed[ci] = 1;

        // Only walkable cells expand (the reference's graph keys are
        // non-empty cells); empty cells are still relaxed below because
        // grid_lookup.get() is truthy for empty grids (FrameProcessor.py:203)
        // and those dead-end relaxations warm the angle cache, which changes
        // later costs in radians-cache mode (differential-fuzz finding).
        // The START is exempt like the numpy twin (golden/astar.py:
        // "current != start and not walkable"): a non-walkable start still
        // expands, so the engines stay bit-compatible on that edge case.
        const bool is_start = (cr == start_r && cc == start_c);
        if (!is_start && !walkable[ci]) continue;

        // Path so far (current first after reverse) — PathFinder.py:156-162.
        path_so_far.clear();
        { int node = ci;
          while (node != -1) {
              path_so_far.emplace_back((node % cols) * grid_size,
                                       (node / cols) * grid_size);
              node = came[node];
          } }
        std::reverse(path_so_far.begin(), path_so_far.end());

        for (int k = 0; k < 4; ++k) {
            const int nx = cx + dxs[k], ny = cy + dys[k];
            if (nx < 0 || ny < 0) continue;
            const int nr = ny / grid_size, nc2 = nx / grid_size;
            if (nr >= rows || nc2 >= cols) continue;
            const int ni = idx_of(nr, nc2);
            if (closed[ni]) continue;

            path_so_far.emplace_back(nx, ny);
            const double max_angle = max_window_angle(path_so_far, p, cache);
            path_so_far.pop_back();

            const double apen = angle_penalty(max_angle, p);
            // Penalty applies only to walkable neighbours (golden twin:
            // "penalty[nr, nc] if walkable[nr, nc] else 0.0") — a
            // caller-supplied penalty buffer may be nonzero off-mask.
            const double cell_pen = walkable[ni] ? penalty[ni] : 0.0;
            const double mult = 1.0 + penalty_w * cell_pen + apen * angle_w;
            const double dist = sqrt(double(dxs[k]) * dxs[k]
                                     + double(dys[k]) * dys[k]);
            const double tentative = g[ci] + dist * mult;

            if (tentative < g[ni]) {
                came[ni] = ci;
                g[ni] = tentative;
                const double f = tentative + heuristic(nx, ny);
                // Never re-push a queued node (stale priorities,
                // PathFinder.py:182-184).
                if (!in_open[ni]) {
                    open.push({f, nx, ny});
                    in_open[ni] = 1;
                }
            }
        }
    }
    *out_cost = INF;
    return 0;
}

}  // extern "C"
