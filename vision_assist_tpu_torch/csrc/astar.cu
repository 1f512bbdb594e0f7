// Exact A* with the carried angle cache: all the goals of a frame in one
// launch, one CTA per stream.
//
// Replaces no Pallas kernel. Its counterpart is the compiled JAX loop
// vision_assist_tpu/planning/device_astar.py (device_astar, one
// lax.while_loop per goal, scanned over the goals by device_astar_paths);
// the plain PyTorch version is planning/device_astar.py in this package,
// which needs a host read per pop and some hundred small launches.
//
// What bounds it on an H100: latency, neither bytes nor operations. A search
// is a chain of pops, each depending on the one before; a pop is a block-wide
// argmin over the open set and up to four relaxations. One stream moves
// about 5 B a cell in and a few KB out, once.
//
// What the design does about that: it makes a pop cost O(1), with no chain
// of dependent loads in it, and keeps the whole state of a search in shared
// memory (29 B a cell and 18 KB for the cache and its key table: 47 KB at
// 32x32, 83 KB at 64x36, 165 KB at 54x96; astar_shared_bytes).
//
// * No path-so-far buffer. The reference analyses, for each relaxation out
//   of a popped node, every 7-point window of the node's path: O(path) work,
//   and the JAX loop copies a 512-int path row per improvement. A popped
//   node is closed and a closed node is never relaxed again, so its path is
//   frozen at the pop and its parent chain reconstructs it. More: a cache
//   entry is written once (NaN -> value) and never changes, and the first
//   valid relaxation out of a node stores every window of its path. So when
//   a node is popped, all windows of its parent's path are in the cache with
//   their final values, and the node's own windows are those plus ONE new
//   window (points m-7, m-4, m-3, m-1 of its m-cell path). Each expanded
//   node has mfull = the maximum over its windows of the cached values;
//   then for node v with parent u
//       first valid neighbour:  max(mfull[u], fresh ? degrees : cache[key])
//       later neighbours:       max(mfull[u], cache[key] after the store)
//   and mfull[v] is the second. The radians/degrees bug, the same-call
//   visibility rule and "invalid relaxations leave the cache alone" all fall
//   out of it. tests/test_torch_device_astar.py holds a numpy emulation of
//   this rule against the plain version (cells, lengths, pop and relaxation
//   counts, cache pattern equal).
// * A node carries what its pop will need: the last six moves of its path
//   (hist, 2 bits a move; the new window's two vectors are sums of those
//   moves, so its cache key is arithmetic on hist), its parent's mfull
//   (mbase), its path length, and the heuristic of its cell (hval, filled
//   for all cells when a goal starts). All are written when the node is
//   improved. In-bounds tests are four bits of the cell's flags, set once.
// * The state is indexed column-major (t = col * rows + row), so the pop's
//   tie-break order (f, col, row) is the order of (bits(f), t): f >= 0, so
//   its bit pattern orders as the float does. The open set is one array of
//   keys (bits of f, all ones when not open).
// * One warp runs a search, with __syncwarp, shuffles and warp reductions
//   only: no block barrier inside a search. The block's other warps help to
//   load the inputs and to reset the state between goals, and wait at a
//   barrier meanwhile. The open set is cut into at most 32 segments of
//   128 << s cells, and lane j keeps the least (key, t) of segment j in two
//   registers. A pop is then two warp min-reductions over registers (f, then
//   t among the equal f). A pop changes at most five keys: the popped node
//   leaves the open set, so its segment is read again (one 128-bit load a
//   lane, two reductions) and its lane takes the result; a pushed neighbour
//   can only lower its segment's minimum, so its key goes to the owning lane
//   by shuffle. A node that is open already keeps its stale key, so an
//   improvement changes no key at all. Lane d of the warp relaxes the
//   neighbour in move d (the first valid lane, by ballot, takes the fresh
//   degrees).
// * The final path is written from the goal back, one move (hist & 3) a step.
//
// float32 in the reference's order of operations, every product and sum
// rounded separately (the _rn intrinsics: no contraction into FMA), IEEE
// sqrt and division, acosf and powf from the CUDA math library. Built without
// --use_fast_math.
//
// The "@profile" comments mark the sections of a pop; utils/profile_astar.py
// builds a copy with a clock() stamp at each (the card's profilers may be
// out of reach) and prints the cycles a pop spends in each section.
//
// A path longer than max_len is reported as no path, as the reference does;
// unlike the reference, whose fixed path buffer is corrupt by then, the
// search itself stays exact (it equals the host twin's).
//
// Two forms of one kernel. The shared form keeps the whole search in shared
// memory, as above: lattices of up to about 7,400 cells (a 1080x1920 frame's
// 54x96 lattice is 5,184; 1440p's 72x128, 9,216, does not fit). The global
// form keeps in shared memory what every pop scans or may read anywhere:
// fkey with its segments, the cache and its penalties, and the key table
// (86 KB of keys at 4K UHD's 108x192, 104 KB in all). What a pop touches
// only at the popped cell and its four neighbours (g, mbase, pbase, pen,
// hval, plen, hist and the flags, 25 B a cell) is in per-stream scratch in
// device memory (`scratch`, astar_scratch_bytes a stream, allocated by the
// caller: 518 KB at 108x192). One warp still runs a search and one CTA a
// stream, so one SM serves every access, __syncwarp and __syncthreads order
// them as they order shared memory, and every operation is the shared
// form's in the same order: the same costs, paths, pops and relaxations. A
// pop's loads of those fields come from L1 or L2 instead of shared memory,
// and they sit on the pop's chain: ~1.0 us a pop at 108x192 against
// 0.55-0.65 for the shared form (PERF.md section 6). The global form takes
// lattices whose keys and tables fit a block's shared memory: up to 53,248
// cells (a 256x208 lattice).

#include <cuda_runtime.h>
// @profile include

namespace {

// One block size: warp 0 searches; all eight warps load the inputs and reset
// the state between goals.
constexpr int kThreads = 256;
// A segment of the open set is at least 128 cells: one 128-bit load a lane.
constexpr int kMinSegShift = 7;
// hist holds six moves of two bits; kNoKey marks a window without an angle.
constexpr int kHistSize = 1 << 12;
constexpr unsigned short kNoKey = 0xffffu;
constexpr int kCacheSize = 49 * 25 + 1;  // last slot is scratch, always NaN
constexpr unsigned kFull = 0xffffffffu;
// Cell flags: closed, walkable, and "the neighbour in move d exists" at bit
// kInBounds << d (moves: right, left, down, up).
constexpr unsigned kClosed = 2u, kWalk = 4u, kInBounds = 16u;
constexpr unsigned kInfBits = 0x7f800000u;
constexpr float kDegPerRad = 57.29577951308232f;

struct Params {
  float grid;
  float grace_deg;
  float exponent;
  float denominator;
  float penalty_w;
  float angle_w;
  int store_radians;  // the reference's cache bug: fresh degrees, stored radians
  int max_len;
};

// log2 of the cells in a segment: the least s >= kMinSegShift with 32
// segments of 1 << s cells covering n cells.
__host__ __device__ inline int seg_shift(long long n) {
  int s = kMinSegShift;
  while ((32ll << s) < n) ++s;
  return s;
}

// n rounded up to whole segments: the length of fkey.
__host__ __device__ inline long long padded_cells(long long n) {
  const long long seg = 1ll << seg_shift(n);
  return (n + seg - 1) / seg * seg;
}

// Bytes a cell of g, mbase, pbase, pen, hval (32 bits), plen, hist (16 bits)
// and the flags (byte): the part of the state that the global form keeps in
// device memory.
constexpr long long kCellBytes = 4 * 5 + 2 * 2 + 1;

// Bytes of dynamic shared memory for n cells: fkey (padded to whole
// segments), the cache with the penalties of its entries, and the table of
// cache keys by hist; in the shared form also g, mbase, pbase, pen, hval,
// plen, hist and the flags.
__host__ __device__ inline long long shared_bytes(long long n, bool global) {
  const long long bytes = 4 * (padded_cells(n) + 2 * kCacheSize) + 2 * kHistSize +
                          (global ? 0 : kCellBytes * n);
  return (bytes + 15) / 16 * 16;
}

// Bytes of the global form's scratch a stream, whole 16-byte lines.
__host__ __device__ inline long long scratch_bytes(long long n) {
  return (kCellBytes * n + 15) / 16 * 16;
}

struct Search {
  unsigned* fkey;  // bits of f while the node is open, kFull otherwise
  float* g;
  float* mbase;  // mfull of the node's parent
  float* pbase;  // angle_penalty(mbase)
  float* pen;
  float* hval;   // heuristic of the cell for the goal in hand
  float* cache;
  float* pcache;  // angle_penalty of each cache entry (0 where absent)
  unsigned short* plen;
  unsigned short* hist;  // the last six moves into the node, newest lowest
  unsigned short* wkey;  // by hist: the cache key of the window a node adds
  unsigned char* flags;
  int rows;
  int start;
  int shift;  // a segment of the open set is 1 << shift cells
  Params p;
};

__device__ __forceinline__ int move_dt(int d, int rows) {
  // right, left, down, up in column-major index steps
  return d == 0 ? rows : (d == 1 ? -rows : (d == 2 ? 1 : -1));
}
__device__ __forceinline__ int move_dc(int d) { return (d == 0) - (d == 1); }
__device__ __forceinline__ int move_dr(int d) { return (d == 2) - (d == 3); }

// The cache key of the one window a node adds to its parent's: points
// a = p[m-7], b = p[m-4], c = p[m-3], d = p[m-1] of its m-cell path. With the
// moves into p[m-1] .. p[m-6] in h (newest lowest):
//   next = d - c = move(m-1) + move(m-2)
//   prev = b - a = move(m-4) + move(m-5) + move(m-6)
// kNoKey when either vector has no length (the window has no angle). A
// function of h alone, so the kernel tabulates it once.
__device__ unsigned short window_key(unsigned h) {
  const int m1 = h & 3, m2 = (h >> 2) & 3, m4 = (h >> 6) & 3, m5 = (h >> 8) & 3,
            m6 = (h >> 10) & 3;
  const int nxt_dc = move_dc(m1) + move_dc(m2), nxt_dr = move_dr(m1) + move_dr(m2);
  const int prev_dc = move_dc(m4) + move_dc(m5) + move_dc(m6);
  const int prev_dr = move_dr(m4) + move_dr(m5) + move_dr(m6);
  if (prev_dc * prev_dc + prev_dr * prev_dr == 0 || nxt_dc * nxt_dc + nxt_dr * nxt_dr == 0)
    return kNoKey;
  return static_cast<unsigned short>(((prev_dc + 3) * 7 + (prev_dr + 3)) * 25 +
                                     (nxt_dc + 2) * 5 + (nxt_dr + 2));
}

// The angle of the window with cache key `key`, in radians: the inverse of
// the key's arithmetic gives the two vectors.
__device__ float window_radians(int key) {
  const int prev_dc = key / 175 - 3, prev_dr = key / 25 % 7 - 3;
  const int nxt_dc = key / 5 % 5 - 2, nxt_dr = key % 5 - 2;
  const float mag_p = __fsqrt_rn(static_cast<float>(prev_dc * prev_dc + prev_dr * prev_dr));
  const float mag_n = __fsqrt_rn(static_cast<float>(nxt_dc * nxt_dc + nxt_dr * nxt_dr));
  const float dot = static_cast<float>(prev_dc * nxt_dc + prev_dr * nxt_dr);
  const float cosv = fminf(fmaxf(__fdiv_rn(dot, __fmul_rn(mag_p, mag_n)), -1.0f), 1.0f);
  return acosf(cosv);
}

// The reference's angle term of a relaxation, from the largest window angle
// of the path. powf is some hundred dependent instructions, so it is taken
// once for each value that can come out of the cache, never in a pop.
__device__ __forceinline__ float angle_penalty(const Params& p, float max_angle) {
  return max_angle <= p.grace_deg ? 0.0f : powf(__fdiv_rn(max_angle, p.denominator), p.exponent);
}

// (f, t) into a lane's minimum if it is less, in the pop's order.
__device__ __forceinline__ void take_min(unsigned& lf, unsigned& lt, unsigned f, unsigned t) {
  if (f < lf || (f == lf && t < lt)) {
    lf = f;
    lt = t;
  }
}

// Warp 0, all 32 lanes: one search from s.start to `goal`, the state reset
// and the start node open. Lane j holds in (lf, lt) the least (key, t) of
// segment j of the open set. The loads of a pop are started together, ahead
// of the tests that need them: the node's fields with its segment's keys,
// then the neighbours' fields.
// One instance a form, so that each is compiled against its own layout;
// inlined, so that the state's pointers stay in registers.
template <bool kGlobal>
__device__ __forceinline__ void search(const Search& s, int goal, int lane, int& pops, int& relaxations,
                       bool& found) {
  const uint4* fkey4 = reinterpret_cast<const uint4*>(s.fkey);
  const int shift = s.shift;
  const int quads = 1 << (shift - 2);  // 128-bit loads a segment
  const float pen_zero = angle_penalty(s.p, 0.0f);  // of a path with no window
  unsigned lf = kFull, lt = kFull;
  if (lane == (s.start >> shift)) {
    lf = s.fkey[s.start];
    lt = s.start;
  }
  // @profile declare
  for (;;) {
    // @profile start
    __syncwarp();  // the last pop's stores before this pop's loads
    // Pop: lexicographic argmin of (f_open, col, row) over the open set.
    // Segments rise with the lane, so of the lanes with the least f the
    // lowest holds the least t.
    const unsigned best_f = __reduce_min_sync(kFull, lf);
    if (best_f >= kInfBits) break;  // open set exhausted
    const int cur = static_cast<int>(
        __shfl_sync(kFull, lt, __ffs(__ballot_sync(kFull, lf == best_f)) - 1));
    ++pops;
    if (cur == goal) {
      found = true;
      break;
    }
    // @profile stamp 0 select
    const unsigned fl = s.flags[cur];
    const int m = s.plen[cur];
    const unsigned h = s.hist[cur];
    const float cur_g = s.g[cur];
    const float base = s.mbase[cur];
    const float pen_base = s.pbase[cur];
    // The popped node's segment loses its minimum: read it again, without
    // the node. Each lane reads a run of rising t, and the runs rise with
    // the lane. The reduction is started here and taken at the end of the
    // pop.
    const int owner = cur >> shift;
    const int per_lane = quads >> 5;
    unsigned seg_f = kFull, seg_t = kFull;
    for (int q = lane * per_lane; q < (lane + 1) * per_lane; ++q) {
      const unsigned i4 = static_cast<unsigned>(owner) * quads + q;
      uint4 v = fkey4[i4];
      const unsigned t = 4u * i4;
      if (t == (static_cast<unsigned>(cur) & ~3u)) {
        const int e = cur & 3;
        if (e == 0) v.x = kFull;
        if (e == 1) v.y = kFull;
        if (e == 2) v.z = kFull;
        if (e == 3) v.w = kFull;
      }
      if (v.x < seg_f) { seg_f = v.x; seg_t = t; }
      if (v.y < seg_f) { seg_f = v.y; seg_t = t + 1; }
      if (v.z < seg_f) { seg_f = v.z; seg_t = t + 2; }
      if (v.w < seg_f) { seg_f = v.w; seg_t = t + 3; }
    }
    const unsigned min_f = __reduce_min_sync(kFull, seg_f);
    const int key = m >= 7 ? s.wkey[h] : kNoKey;

    // @profile stamp 1 node, segment scan, first reduction
    // Lane d relaxes the neighbour in move d. Dead-end pops (non-walkable,
    // non-start) close without expanding.
    const int d = lane & 3;
    const bool expands = (fl & kWalk) || cur == s.start;
    const bool inb = expands && lane < 4 && (fl & (kInBounds << d));
    const int t = inb ? cur + move_dt(d, s.rows) : cur;
    const unsigned nfl = s.flags[t];
    const float pen_t = s.pen[t], g_t = s.g[t], h_t = s.hval[t];
    const unsigned fkey_t = s.fkey[t];
    const bool valid = inb && !(nfl & kClosed);
    const unsigned mask = __ballot_sync(kFull, valid);
    __syncwarp();  // every lane has read the node before it is closed
    if (lane == 0) {
      s.fkey[cur] = kFull;
      s.flags[cur] = static_cast<unsigned char>(fl | kClosed);
    }

    // @profile stamp 2 neighbours, ballot, close
    unsigned push_f = kFull;
    // An invalid relaxation leaves the cache alone.
    if (mask) {
      // The angle term: that of the parent's windows (mbase, pbase) and of
      // the one window this node adds. Without a seventh cell there is no
      // window; without an angle the window adds nothing.
      float pen_first = m >= 7 ? pen_base : pen_zero, pen_rest = pen_first;
      float ma_rest = m >= 7 ? base : 0.0f;
      if (key != kNoKey) {
        float rest = s.cache[key];
        float pen_key = s.pcache[key];
        float first = rest;
        const bool fresh = rest != rest;
        __syncwarp();
        if (fresh) {  // contributes degrees, stores radians (bug mode)
          const float radians = window_radians(key);
          first = __fmul_rn(radians, kDegPerRad);
          rest = s.p.store_radians ? radians : first;
          pen_key = angle_penalty(s.p, rest);
          if (lane == 0) {
            s.cache[key] = rest;
            s.pcache[key] = pen_key;
          }
        }
        // angle_penalty(fmaxf(base, x)) is the penalty of whichever is larger.
        pen_rest = base >= rest ? pen_base : pen_key;
        pen_first = !fresh ? pen_rest : (base >= first ? pen_base : angle_penalty(s.p, first));
        ma_rest = fmaxf(base, rest);
      }

      // @profile stamp 3 window and cache
      if (valid) {
        // Only the first valid neighbour sees a fresh window's degrees.
        const float angle_pen = lane == __ffs(mask) - 1 ? pen_first : pen_rest;
        const float cell_pen = (nfl & kWalk) ? pen_t : 0.0f;
        const float mult = __fadd_rn(__fadd_rn(1.0f, __fmul_rn(s.p.penalty_w, cell_pen)),
                                     __fmul_rn(s.p.angle_w, angle_pen));
        const float tentative = __fadd_rn(cur_g, __fmul_rn(s.p.grid, mult));
        if (tentative < g_t) {
          s.g[t] = tentative;
          s.hist[t] = static_cast<unsigned short>(((h << 2) | d) & 0xfffu);
          s.plen[t] = static_cast<unsigned short>(m + 1);
          s.mbase[t] = ma_rest;  // this node's mfull
          s.pbase[t] = pen_rest;
          // Push only if not already queued; a queued node keeps its stale f.
          if (fkey_t == kFull) {
            push_f = __float_as_uint(__fadd_rn(tentative, h_t));
            s.fkey[t] = push_f;
          }
        }
      }
      relaxations += __popc(mask);
      // @profile stamp 4 relaxation and stores
    }
    const unsigned min_t =
        __shfl_sync(kFull, seg_t, __ffs(__ballot_sync(kFull, seg_f == min_f)) - 1);
    if (lane == owner) {
      lf = min_f;
      lt = min_t;
    }
    // @profile stamp 5 segment minimum to its lane
    // A push can only lower its segment's minimum: hand it to the owning lane.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned f = __shfl_sync(kFull, push_f, j);
      const unsigned pt = __shfl_sync(kFull, static_cast<unsigned>(t), j);
      if (f != kFull && lane == static_cast<int>(pt >> shift)) take_min(lf, lt, f, pt);
    }
    // @profile stamp 6 pushes to their lanes
  }
  // @profile report
}

// kGlobal: g, mbase, pbase, pen, hval, plen, hist and the flags in `scratch`
// (scratch_bytes a stream), the rest in shared memory; else all in shared
// memory.
template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
astar_kernel(const unsigned char* __restrict__ walkable, const float* __restrict__ penalty,
             const int* __restrict__ start, const int* __restrict__ goals,
             const unsigned char* __restrict__ goals_valid, const float* __restrict__ cache_in,
             int* __restrict__ cells, int* __restrict__ lengths, float* __restrict__ costs,
             float* __restrict__ cache_out, int* __restrict__ stats,
             unsigned char* __restrict__ scratch, int rows, int cols, int k_goals, Params p) {
  extern __shared__ uint4 smem4[];
  const int n = rows * cols;
  const int n_pad = static_cast<int>(padded_cells(n));
  const int tid = threadIdx.x;
  constexpr int nthreads = kThreads;
  const int lane = tid & 31;
  const int b = blockIdx.x;

  Search s;
  s.fkey = reinterpret_cast<unsigned*>(smem4);
  if constexpr (kGlobal) {
    s.cache = reinterpret_cast<float*>(s.fkey + n_pad);
    s.pcache = s.cache + kCacheSize;
    s.wkey = reinterpret_cast<unsigned short*>(s.pcache + kCacheSize);
    s.g = reinterpret_cast<float*>(scratch + static_cast<size_t>(b) * scratch_bytes(n));
    s.mbase = s.g + n;
    s.pbase = s.g + 2 * n;
    s.pen = s.g + 3 * n;
    s.hval = s.g + 4 * n;
    s.plen = reinterpret_cast<unsigned short*>(s.g + 5 * n);
    s.hist = s.plen + n;
    s.flags = reinterpret_cast<unsigned char*>(s.hist + n);
  } else {
    s.g = reinterpret_cast<float*>(s.fkey + n_pad);
    s.mbase = s.g + n;
    s.pbase = s.g + 2 * n;
    s.pen = s.g + 3 * n;
    s.hval = s.g + 4 * n;
    s.cache = s.g + 5 * n;
    s.pcache = s.cache + kCacheSize;
    s.plen = reinterpret_cast<unsigned short*>(s.pcache + kCacheSize);
    s.hist = s.plen + n;
    s.wkey = s.hist + n;
    s.flags = reinterpret_cast<unsigned char*>(s.wkey + kHistSize);
  }
  s.rows = rows;
  s.shift = seg_shift(n);
  s.p = p;

  // Row-major inputs into the column-major state.
  const unsigned char* walk_b = walkable + static_cast<size_t>(b) * n;
  const float* pen_b = penalty + static_cast<size_t>(b) * n;
  for (int i = tid; i < n; i += nthreads) {
    const int r = i / cols, c = i - r * cols;
    const int t = c * rows + r;
    s.pen[t] = pen_b[i];
    s.flags[t] = static_cast<unsigned char>(
        (walk_b[i] ? kWalk : 0u) | (c + 1 < cols ? kInBounds : 0u) |
        (c > 0 ? kInBounds << 1 : 0u) | (r + 1 < rows ? kInBounds << 2 : 0u) |
        (r > 0 ? kInBounds << 3 : 0u));
  }
  for (int i = tid; i < kCacheSize; i += nthreads) {
    const float v = cache_in[static_cast<size_t>(b) * kCacheSize + i];
    s.cache[i] = v;
    s.pcache[i] = v != v ? 0.0f : angle_penalty(p, v);
  }
  for (int i = tid; i < kHistSize; i += nthreads) s.wkey[i] = window_key(i);
  int* cells_b = cells + static_cast<size_t>(b) * k_goals * p.max_len * 2;
  for (int i = tid; i < k_goals * p.max_len * 2; i += nthreads) cells_b[i] = -1;

  const int sr = start[2 * b], sc = start[2 * b + 1];
  const bool start_ok = sr >= 0 && sr < rows && sc >= 0 && sc < cols;
  s.start = sc * rows + sr;
  __syncthreads();

  for (int k = 0; k < k_goals; ++k) {
    const int out = b * k_goals + k;
    const int gr = goals[2 * out], gc = goals[2 * out + 1];
    // Invalid goals are skipped without touching the cache.
    const bool run = goals_valid[out] && start_ok && gr >= 0 && gr < rows && gc >= 0 && gc < cols;
    int pops = 0, relaxations = 0;
    bool found = false;
    const int goal = gc * rows + gr;
    if (run) {
      for (int t = tid; t < n_pad; t += nthreads) s.fkey[t] = kFull;
      for (int t = tid; t < n; t += nthreads) {
        const int c = t / rows, r = t - c * rows;
        s.g[t] = __int_as_float(kInfBits);
        s.hval[t] = __fmul_rn(p.grid, static_cast<float>(abs(r - gr) + abs(c - gc)));
        s.flags[t] &= ~kClosed;
      }
      __syncthreads();
      if (tid == 0) {
        s.g[s.start] = 0.0f;
        s.fkey[s.start] = __float_as_uint(s.hval[s.start]);
        s.plen[s.start] = 1;
        s.hist[s.start] = 0;
        s.mbase[s.start] = 0.0f;
        s.pbase[s.start] = angle_penalty(p, 0.0f);
      }
      __syncthreads();

      // Warp 0 searches; the other warps wait at the barrier below.
      if (tid < 32) search<kGlobal>(s, goal, lane, pops, relaxations, found);
    }
    if (tid == 0) {
      int len = 0;
      float cost = __int_as_float(kInfBits);
      int* path = cells_b + static_cast<size_t>(k) * p.max_len * 2;
      if (!goals_valid[out] && start_ok && p.max_len > 0) {
        // The JAX loop searches an invalid goal against the start cell, a
        // one-pop no-op whose one-cell path stays in `cells` under length 0.
        path[0] = sr;
        path[1] = sc;
      }
      if (found && s.plen[goal] <= p.max_len) {
        len = s.plen[goal];
        cost = s.g[goal];
        int t = goal, r = gr, c = gc;
        for (int j = len - 1; j >= 0; --j) {
          path[2 * j] = r;
          path[2 * j + 1] = c;
          if (j > 0) {
            const int d = s.hist[t] & 3;
            r -= move_dr(d);
            c -= move_dc(d);
            t -= move_dt(d, rows);
          }
        }
      }
      lengths[out] = len;
      costs[out] = cost;
      stats[2 * out] = pops;
      stats[2 * out + 1] = relaxations;
    }
    __syncthreads();  // the next goal's reset must not overtake this read-out
  }
  for (int i = tid; i < kCacheSize; i += nthreads)
    cache_out[static_cast<size_t>(b) * kCacheSize + i] = s.cache[i];
}

}  // namespace

// Dynamic shared memory one stream of a rows x cols lattice needs in the
// shared form (global = 0) or the global form (global = 1), in bytes.
extern "C" long long astar_shared_bytes(int rows, int cols, int global) {
  return shared_bytes(static_cast<long long>(rows) * cols, global != 0);
}

// The global form's scratch a stream, in bytes.
extern "C" long long astar_scratch_bytes(int rows, int cols) {
  return scratch_bytes(static_cast<long long>(rows) * cols);
}

// The most dynamic shared memory one block of the kernel can have on card
// `device`, in bytes, or -1 on error.
extern "C" int astar_shared_cap(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return optin;
}

// walkable (B, R, C) u8, penalty (B, R, C) f32, start (B, 2) i32, goals
// (B, K, 2) i32, goals_valid (B, K) u8, cache_in (B, 1226) f32 -> cells
// (B, K, L, 2) i32 (-1 padded), lengths (B, K) i32, costs (B, K) f32,
// cache_out (B, 1226) f32, stats (B, K, 2) i32 (pops, relaxations); all
// pointers on card `device`. The global form when `scratch` is not null
// (B * astar_scratch_bytes(R, C) bytes on the card, 16-byte aligned), else
// the shared form. Returns the cudaError_t of the launch (0 on success);
// launches on `stream`, does not synchronise. This library carries its own
// CUDA runtime, so the card is set here when it is not the current one, and
// each form's shared-memory limit is raised only when a launch needs more
// than any before it.
extern "C" int astar_launch(const unsigned char* walkable, const float* penalty, const int* start,
                            const int* goals, const unsigned char* goals_valid,
                            const float* cache_in, int* cells, int* lengths, float* costs,
                            float* cache_out, int* stats, int batch, int rows, int cols,
                            int k_goals, int max_len, float grid, float grace_deg, float exponent,
                            float denominator, float penalty_w, float angle_w, int store_radians,
                            unsigned char* scratch, int device, void* stream) {
  constexpr int kMaxDevices = 64;
  static long long configured[2][kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool global = scratch != nullptr;
  const auto kernel = global ? astar_kernel<true> : astar_kernel<false>;
  const long long smem = astar_shared_bytes(rows, cols, global);
  if (smem > configured[global][device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[global][device] = smem;
  }
  const Params p{grid, grace_deg, exponent, denominator, penalty_w, angle_w, store_radians, max_len};
  kernel<<<batch, kThreads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      walkable, penalty, start, goals, goals_valid, cache_in, cells, lengths, costs, cache_out,
      stats, scratch, rows, cols, k_goals, p);
  return static_cast<int>(cudaGetLastError());
}
