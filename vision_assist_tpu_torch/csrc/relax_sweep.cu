// Fast-sweeping wavefront relaxation: the min-plus fixed point over
// (incoming direction x cell) states by passes of four directional scans,
// one CTA per stream, all passes inside the launch.
//
// Replaces the compiled JAX device loop vision_assist_tpu/planning/
// wavefront.py::relax_sweep (lax.while_loop over passes, each scan a
// lax.associative_scan), the relaxation of the default wavefront flags. Its
// plain twin is planning/wavefront.py:relax_sweep_field, and the field this
// kernel writes is bit-equal to the twin's.
//
// The pass, as the twin runs it. For d = right, left, down, up in turn (the
// order of MOVES; Gauss-Seidel: each scan sees the earlier scans' updates):
//   (a) h[i] = min_d' fl(dist[d'][i] + T[d'][d]) at every cell;
//   (b) along every line of direction d (rows for right and left, columns
//       for down and up; left and up in reverse), in scan order,
//       a[i] = min(dist[d][i], fl(h[i-1] + enter[i])); position 0 stays;
//   (c) x[i] = min(a[i], fl(x[i-1] + enter[i])) along the line, solved by
//       log-step doubling over pairs (a, b), b = enter at level 0: at
//       level k with shift s = 2**k, for every position i >= s,
//         a[i] <- min(a[i], fl(a[i-s] + b[i])),  b[i] <- fl(b[i] + b[i-s]),
//       both from the values before the level, for s = 1, 2, 4, ... while
//       s < n (the twin's _scan_levels and _min_plus_scan).
// A stream stops after a pass that changed nothing, or at max_passes. The
// twin stops when no stream changes, but its pass is a function of the
// field alone, so the passes a converged stream sits out leave its field as
// it is: the early exit here gives the same field and counts the same
// passes.
//
// Bit-equality: every float addition is one of the twin's, on the same two
// operands, rounded to nearest (__fadd_rn; built with -fmad=false, and there
// is no multiply to fuse anyway); min is exact, so its order is free. The
// level structure is kept exactly, including which positions have a
// partner at each shift.
//
// What bounds it on an H100: neither bytes nor operations. A stream moves
// (R*C + 4*R*C) * 4 bytes in and out of device memory once; a pass is ~60
// float operations a cell. The time goes into a chain of dependent steps
// on one SM: per pass four scans, each ~log2(n) levels of warp shuffles,
// a block-wide barrier between scans.
//
// What the design does about that: one warp owns one line of a scan, so a
// scan needs no barrier inside it. Lane l holds the line's positions
// p = l + 32*j, j < J, in registers; a level's partner p - s is, for s < 32,
// lane (l - s) mod 32 of slot j (l >= s) or slot j - 1 (l < s): one shuffle a
// slot; for s >= 32 it is slot j - s/32 of the same lane: no shuffle. The
// levels are unrolled, so every shift is a constant. A line of 96 cells (the
// 54x96 lattice of a 1080x1920 frame) is three slots of one warp. The lines
// of one direction touch disjoint cells, so the warps of a scan run free; a
// barrier separates scans, and one barrier with a vote ends the pass.
//
// Lines whose scan cannot change anything are skipped. A scan of line L in
// direction d is a function of the four directions' values at L's cells and
// of the entry costs, so if none of those values changed since the last scan
// of (L, d) (whose own writes count as changes), the scan would write what is
// already there. need[d][L] is set when a cell of L changes (by the scan of
// L's own orientation, or by a crossing line's scan) and cleared when (L, d)
// runs; every flag starts set. Skipping a scan that would change nothing
// leaves the field, the vote and so the pass count as they are: the skip is
// exact. After the first passes most lines are clean, so a pass costs what
// its moving front costs. The launch also writes, per stream, how many line
// scans ran (of rows, of columns): the operations this run's data needed.
//
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr float kInf = 3.0e38f;  // the reference's finite "infinity"
constexpr int kWarp = 32;
constexpr int kMaxWarps = 32;
constexpr int kMaxSlots = 8;     // lines of up to 256 cells
constexpr int kMaxLine = kMaxSlots * kWarp;
constexpr unsigned kFull = 0xffffffffu;
// Static shared memory: T, need, ran.
constexpr int kStaticShared = 16 * sizeof(float) + 4 * kMaxLine + 2 * sizeof(int);

// log2 of the least power of two >= x.
__host__ __device__ constexpr int ceil_log2(int x) { return x <= 1 ? 0 : 1 + ceil_log2((x + 1) / 2); }

inline int padded_stride(int cols) { return cols | 1; }

// One level's partners: src[j] = x at position p_j - s of the line, for the
// positions that have one (p_j >= s); the others keep what src held. s is a
// constant wherever this is inlined.
template <int J>
__device__ __forceinline__ void partners(const float (&x)[J], float (&src)[J], int s,
                                         int lane, int jn) {
  if (s < kWarp) {
    float sh[J];
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (j < jn) sh[j] = __shfl_sync(kFull, x[j], (lane - s) & (kWarp - 1));
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (j >= jn) continue;
      if (lane >= s) src[j] = sh[j];
      else if (j > 0) src[j] = sh[j - 1];
    }
  } else {
#pragma unroll
    for (int j = s / kWarp; j < J; ++j) src[j] = x[j - s / kWarp];
  }
}

// One line of the scan of direction d: n positions, position p at shared
// index base + p*step (forward) or base + (n-1-p)*step (reverse); line is
// its index among the lines of its orientation. Returns non-zero if a state
// dropped, and then marks the lines that hold the dropped states dirty.
template <int J>
__device__ __forceinline__ int scan_line(float* dist, const float* ent, const float* T,
                                         unsigned char (*need)[kMaxLine], int np, int d,
                                         int line, int base, int step, int n, bool rev,
                                         int lane) {
  const int jn = (n + kWarp - 1) / kWarp;
  float a[J], b[J], h[J], old[J];
  int q[J];
  const float t0 = T[0 * 4 + d], t1 = T[1 * 4 + d], t2 = T[2 * 4 + d], t3 = T[3 * 4 + d];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int p = lane + kWarp * j;
    q[j] = -1;
    a[j] = old[j] = h[j] = kInf;
    b[j] = 0.0f;
    if (j < jn && p < n) {
      q[j] = base + (rev ? n - 1 - p : p) * step;
      const float x0 = dist[q[j]], x1 = dist[np + q[j]];
      const float x2 = dist[2 * np + q[j]], x3 = dist[3 * np + q[j]];
      h[j] = fminf(fminf(__fadd_rn(x0, t0), __fadd_rn(x1, t1)),
                   fminf(__fadd_rn(x2, t2), __fadd_rn(x3, t3)));
      old[j] = a[j] = d == 0 ? x0 : d == 1 ? x1 : d == 2 ? x2 : x3;
      b[j] = ent[q[j]];
    }
  }
  // (b) the one-step shift: a[p] = min(old[p], h[p-1] + enter[p]), p >= 1.
  {
    float hp[J];
    partners<J>(h, hp, 1, lane, jn);
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (j < jn && (lane >= 1 || j > 0)) a[j] = fminf(a[j], __fadd_rn(hp[j], b[j]));
  }
  // (c) the doubling scan over (a, b), shifts 1, 2, 4, ... below n.
  constexpr int kLevels = ceil_log2(kWarp * J);
#pragma unroll
  for (int k = 0; k < kLevels; ++k) {
    const int s = 1 << k;
    if (s >= n) break;
    float as[J], bs[J];
    partners<J>(a, as, s, lane, jn);
    partners<J>(b, bs, s, lane, jn);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (j >= jn || (s >= kWarp ? j < s / kWarp : j == 0 && lane < s)) continue;
      a[j] = fminf(a[j], __fadd_rn(as[j], b[j]));
      b[j] = __fadd_rn(b[j], bs[j]);
    }
  }
  const int cross = d < 2 ? 2 : 0;  // the orientation of the crossing lines
  int changed = 0;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (q[j] < 0) continue;
    dist[d * np + q[j]] = a[j];
    if (__float_as_int(a[j]) != __float_as_int(old[j])) {  // a <= old, no NaN
      const int at = rev ? n - 1 - (lane + kWarp * j) : lane + kWarp * j;
      need[cross][at] = need[cross + 1][at] = 1;
      changed = 1;
    }
  }
  if (changed) need[d & 2][line] = need[(d & 2) + 1][line] = 1;
  return changed;
}

template <int J>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
relax_sweep_kernel(const float* __restrict__ enter, const int* __restrict__ start,
                   const float* __restrict__ turn, float* __restrict__ out,
                   int* __restrict__ passes_out, int* __restrict__ scans_out, int rows,
                   int cols, int stride, int max_passes) {
  extern __shared__ float smem[];
  __shared__ float T[16];
  __shared__ unsigned char need[4][kMaxLine];  // need[d][line]: scan it this pass
  __shared__ int ran[2];                       // line scans run: of rows, of columns
  const int np = rows * stride;
  float* dist = smem;           // [4][rows][stride]
  float* ent = smem + 4 * np;   // [rows][stride]
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid % kWarp, warp = tid / kWarp, nwarps = nthreads / kWarp;
  const int b = blockIdx.x;
  const int n = rows * cols;
  const float* enter_b = enter + static_cast<size_t>(b) * n;

  for (int p = tid; p < 4 * np; p += nthreads) dist[p] = kInf;
  for (int p = tid; p < 4 * kMaxLine; p += nthreads) need[p / kMaxLine][p % kMaxLine] = 1;
  if (tid < 16) T[tid] = turn[tid];
  if (tid < 2) ran[tid] = 0;
  for (int i = tid; i < n; i += nthreads) {
    const int r = i / cols;
    ent[r * stride + (i - r * cols)] = enter_b[i];
  }
  __syncthreads();
  const int sr = start[2 * b], sc = start[2 * b + 1];
  if (tid < 4 && sr >= 0 && sr < rows && sc >= 0 && sc < cols)
    dist[tid * np + sr * stride + sc] = 0.0f;
  __syncthreads();

  int pass = 0;
  int ran_rows = 0, ran_cols = 0;  // this warp's line scans
  while (pass < max_passes) {
    ++pass;
    int changed = 0;
#pragma unroll 1
    for (int d = 0; d < 4; ++d) {
      const bool across = d < 2, rev = d == 1 || d == 3;
      const int nlines = across ? rows : cols, len = across ? cols : rows;
      for (int line = warp; line < nlines; line += nwarps) {
        if (!need[d][line]) continue;
        ran_rows += across;  // every lane counts; lane 0's count is kept
        ran_cols += !across;
        __syncwarp();
        if (lane == 0) need[d][line] = 0;
        __syncwarp();
        changed |= scan_line<J>(dist, ent, T, need, np, d, line,
                                across ? line * stride : line, across ? 1 : stride, len,
                                rev, lane);
      }
      if (d < 3) __syncthreads();
    }
    if (!__syncthreads_or(changed)) break;
  }
  if (lane == 0) {
    atomicAdd(&ran[0], ran_rows);
    atomicAdd(&ran[1], ran_cols);
  }
  __syncthreads();

  float4* out_b = reinterpret_cast<float4*>(out + static_cast<size_t>(b) * n * 4);
  for (int i = tid; i < n; i += nthreads) {
    const int r = i / cols;
    const int p = r * stride + (i - r * cols);
    out_b[i] = make_float4(dist[p], dist[np + p], dist[2 * np + p], dist[3 * np + p]);
  }
  if (tid == 0) {
    passes_out[b] = pass;
    scans_out[2 * b] = ran[0];
    scans_out[2 * b + 1] = ran[1];
  }
}

template <int J>
cudaError_t launch(const float* enter, const int* start, const float* turn, float* out,
                   int* passes, int* scans, int batch, int rows, int cols, int max_passes,
                   int device, long long smem, int threads, cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  static long long configured[kMaxDevices] = {};
  if (smem > configured[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        relax_sweep_kernel<J>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    configured[device] = smem;
  }
  relax_sweep_kernel<J><<<batch, threads, static_cast<size_t>(smem), stream>>>(
      enter, start, turn, out, passes, scans, rows, cols, padded_stride(cols), max_passes);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one stream of a rows x cols lattice needs, in bytes.
extern "C" long long relax_sweep_shared_bytes(int rows, int cols) {
  return 5LL * rows * padded_stride(cols) * static_cast<long long>(sizeof(float));
}

// The longest line (cells) the kernel takes.
extern "C" int relax_sweep_max_line() { return kMaxLine; }

// The most dynamic shared memory one block of the kernel can have on card
// `device`, in bytes, or -1 on error.
extern "C" int relax_sweep_shared_cap(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return optin - kStaticShared;
}

// enter (B, R, C) f32, start (B, 2) i32, turn (4, 4) f32 -> out (B, R, C, 4)
// f32, passes (B,) i32 and scans (B, 2) i32 (the line scans each stream ran:
// rows, columns), all pointers on card `device`. Returns the cudaError_t of
// the launch (0 on success), or -1 when a line is longer than
// relax_sweep_max_line(); launches on `stream`, does not synchronise. This
// library carries its own CUDA runtime, so the card is set here when it is
// not the current one, and the kernel's shared-memory limit is raised only
// when a launch needs more than any before it.
extern "C" int relax_sweep_launch(const float* enter, const int* start, const float* turn,
                                  float* out, int* passes, int* scans, int batch, int rows,
                                  int cols, int max_passes, int device, void* stream) {
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  const int longest = rows > cols ? rows : cols;
  if (rows < 1 || cols < 1 || longest > kMaxLine) return -1;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long smem = relax_sweep_shared_bytes(rows, cols);
  const int warps = longest < kMaxWarps ? longest : kMaxWarps;
  const int threads = warps * kWarp;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto slots) {
    return launch<decltype(slots)::value>(enter, start, turn, out, passes, scans, batch, rows,
                                          cols, max_passes, device, smem, threads, s);
  };
  switch ((longest + kWarp - 1) / kWarp) {
    case 1: err = go(std::integral_constant<int, 1>{}); break;
    case 2: err = go(std::integral_constant<int, 2>{}); break;
    case 3: err = go(std::integral_constant<int, 3>{}); break;
    case 4: err = go(std::integral_constant<int, 4>{}); break;
    case 5: err = go(std::integral_constant<int, 5>{}); break;
    case 6: err = go(std::integral_constant<int, 6>{}); break;
    case 7: err = go(std::integral_constant<int, 7>{}); break;
    default: err = go(std::integral_constant<int, 8>{}); break;
  }
  return static_cast<int>(err);
}
