// Wavefront relaxation: single-source min-plus fixed point over
// (incoming direction x cell) states, one CTA per stream.
//
// Replaces the Pallas TPU kernel vision_assist_tpu/ops/pallas_wavefront.py
// (_relax_kernel, launched by relax_pallas through pl.pallas_call).
//
// What bounds it on an H100: neither bytes nor FLOPs. One stream moves
// (R*C + 4*R*C) * 4 bytes in and out of device memory once, and a Jacobi
// sweep is ~10 float operations per state; the time goes into a serial chain
// of sweeps on one SM, each a block-wide barrier apart, and the front moves
// one cell per sweep, so the chain is as long as the longest best path.
//
// What the design does about that: it shortens the chain instead of speeding
// up the sweep. One thread owns one line of one direction (a row for right
// and left, a column for down and up) and walks it cell by cell in the
// direction of travel, applying to each state the reference's update
//
//   dist[d][cell] = min(dist[d][cell],
//                       fl(fl(min_d' fl(dist[d'][parent] + T[d'][d])) + enter[cell]))
//
// with its own direction's parent value carried in a register, so a straight
// run of any length is relaxed in one pass; the other three directions at
// the parent cell are read from shared memory as they are at that moment.
// All 2R + 2C lines run at once, one barrier and one vote per pass, and a
// pass that changes nothing ends the loop. Passes needed: the number of
// straight runs on the best paths, not their length in cells (13 against 41
// sweeps on the served 32x32 lattice, 41 against 151 on the hardest 64x36
// fixture).
//
// Why the field is still bit-equal to the Jacobi twin
// (planning/wavefront.py:relax_field): every write is the reference's own
// per-state update F_s applied to values that some thread wrote earlier. F
// is monotone (float add and min are monotone under round-to-nearest) and
// never raises a value, so every value stays at or above the greatest fixed
// point below the start state, which is what Jacobi sweeps converge to;
// and a pass in which no state changed read only final values, so its
// state is a fixed point of every F_s. Both ends meet: the same floats. The
// chain folds the min as min(old, fl(g + e), fl(fl(x + T[d][d]) + e)) with g
// the min over the other three directions; that equals
// min(old, fl(min(g, fl(x + T[d][d])) + e)) because fl(. + e) is monotone.
// Only the order of updates differs from run to run (lines read each other's
// values while they change, through volatile 32-bit accesses), so the pass
// count may differ between runs; the field cannot.
//
// Layout: shared memory holds dist[4] and enter, each (R+2) x stride floats
// with a one-cell halo of the reference's finite INF (3.0e38f) standing for
// the off-lattice parent, so the walk needs no bounds test; stride is odd,
// so 32 row walkers hit 32 banks. 20 bytes a cell: 24 KB at 32x32, 51 KB at
// 64x36. Loads for 8 cells are issued ahead of the 8 dependent chain steps.
// Built without --use_fast_math; there are no multiplies, so no contraction
// into FMA can change a rounding.

#include <cuda_runtime.h>

namespace {

constexpr float kInf = 3.0e38f;  // the reference's finite "infinity"
constexpr int kMaxThreads = 1024;
constexpr int kMinThreads = 256;
constexpr int kChunk = 8;
constexpr int kStaticShared = 16 * sizeof(float);  // T

__host__ __device__ inline int round_up_warp(int x) { return (x + 31) & ~31; }
inline int padded_stride(int cols) { return (cols + 2) | 1; }

// N cells of one line, starting at padded index p and stepping by `step`:
// dd is the line's own direction, q1..q3 the other three already shifted to
// the parent cell. Returns the carried value; ORs a non-zero into `changed`
// if any state dropped.
template <int N>
__device__ __forceinline__ float chain_cells(volatile float* dd, const volatile float* q1,
                                             const volatile float* q2,
                                             const volatile float* q3, const float* ent,
                                             int p, int step, float t1, float t2, float t3,
                                             float tdd, float x, int& changed) {
  float e[N], old[N], a[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int q = p + i * step;
    e[i] = ent[q];
    old[i] = dd[q];
    const float g = fminf(fminf(q1[q] + t1, q2[q] + t2), q3[q] + t3);
    a[i] = fminf(old[i], g + e[i]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x = fminf(a[i], (x + tdd) + e[i]);
    changed |= __float_as_int(x) ^ __float_as_int(old[i]);  // x <= old, no NaN
    dd[p + i * step] = x;
  }
  return x;
}

__global__ void __launch_bounds__(kMaxThreads)
relax_kernel(const float* __restrict__ enter, const int* __restrict__ start,
             const float* __restrict__ turn, float* __restrict__ out,
             int* __restrict__ passes_out, int rows, int cols, int stride,
             int max_passes) {
  extern __shared__ float smem[];
  __shared__ float T[16];
  const int np = (rows + 2) * stride;
  volatile float* dist = smem;  // [4][np]
  float* ent = smem + 4 * np;   // [np]
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int b = blockIdx.x;
  const int n = rows * cols;
  const float* enter_b = enter + static_cast<size_t>(b) * n;

  for (int p = tid; p < 5 * np; p += nthreads) smem[p] = kInf;
  if (tid < 16) T[tid] = turn[tid];
  __syncthreads();
  for (int i = tid; i < n; i += nthreads) {
    const int r = i / cols;
    ent[(r + 1) * stride + (i - r * cols) + 1] = enter_b[i];
  }
  const int sr = start[2 * b], sc = start[2 * b + 1];
  if (tid < 4 && sr >= 0 && sr < rows && sc >= 0 && sc < cols)
    dist[tid * np + (sr + 1) * stride + sc + 1] = 0.0f;
  __syncthreads();

  // Line slots, each group padded to whole warps so that a warp walks one
  // direction: [right rows | left rows | down columns | up columns].
  const int wr = round_up_warp(rows);
  const int wc = round_up_warp(cols);
  const int nslots = 2 * (wr + wc);

  int pass = 0;
  while (pass < max_passes) {
    ++pass;
    int changed = 0;
    for (int k = tid; k < nslots; k += nthreads) {
      int d, p, step, len;
      if (k < 2 * wr) {
        d = k >= wr;
        const int row = k - d * wr;
        if (row >= rows) continue;
        len = cols;
        step = d ? -1 : 1;
        p = (row + 1) * stride + (d ? cols : 1);
      } else {
        d = 2 + (k - 2 * wr >= wc);
        const int col = k - 2 * wr - (d - 2) * wc;
        if (col >= cols) continue;
        len = rows;
        step = d == 3 ? -stride : stride;
        p = (d == 3 ? rows : 1) * stride + col + 1;
      }
      const int o1 = (d + 1) & 3, o2 = (d + 2) & 3, o3 = (d + 3) & 3;
      volatile float* dd = dist + d * np;
      const volatile float* q1 = dist + o1 * np - step;
      const volatile float* q2 = dist + o2 * np - step;
      const volatile float* q3 = dist + o3 * np - step;
      const float t1 = T[o1 * 4 + d], t2 = T[o2 * 4 + d], t3 = T[o3 * 4 + d];
      const float tdd = T[5 * d];
      float x = kInf;  // the halo's value: nothing enters from off the lattice
      int j = 0;
      for (; j + kChunk <= len; j += kChunk, p += kChunk * step)
        x = chain_cells<kChunk>(dd, q1, q2, q3, ent, p, step, t1, t2, t3, tdd, x, changed);
      for (; j < len; ++j, p += step)
        x = chain_cells<1>(dd, q1, q2, q3, ent, p, step, t1, t2, t3, tdd, x, changed);
    }
    if (!__syncthreads_or(changed)) break;
  }

  float4* out_b = reinterpret_cast<float4*>(out + static_cast<size_t>(b) * n * 4);
  for (int i = tid; i < n; i += nthreads) {
    const int r = i / cols;
    const int p = (r + 1) * stride + (i - r * cols) + 1;
    out_b[i] = make_float4(dist[p], dist[np + p], dist[2 * np + p], dist[3 * np + p]);
  }
  if (tid == 0) passes_out[b] = pass;
}

}  // namespace

// Dynamic shared memory one stream of a rows x cols lattice needs, in bytes.
extern "C" long long relax_shared_bytes(int rows, int cols) {
  return 5LL * (rows + 2) * padded_stride(cols) * static_cast<long long>(sizeof(float));
}

// The most dynamic shared memory one block of the kernel can have on card
// `device`, in bytes, or -1 on error.
extern "C" int relax_shared_cap(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return optin - kStaticShared;
}

// enter (B, R, C) f32, start (B, 2) i32, turn (4, 4) f32 -> out (B, R, C, 4)
// f32 and passes (B,) i32, all pointers on card `device`. Returns the
// cudaError_t of the launch (0 on success); launches on `stream`, does not
// synchronise. This library carries its own CUDA runtime, so the card is
// set here when it is not the current one, and the kernel's shared-memory
// limit is raised only when a launch needs more than any before it.
extern "C" int relax_launch(const float* enter, const int* start, const float* turn,
                            float* out, int* passes, int batch, int rows, int cols,
                            int max_passes, int device, void* stream) {
  constexpr int kMaxDevices = 64;
  static long long configured[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long smem = relax_shared_bytes(rows, cols);
  if (smem > configured[device]) {
    err = cudaFuncSetAttribute(relax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[device] = smem;
  }
  int threads = 2 * (round_up_warp(rows) + round_up_warp(cols));
  threads = threads < kMinThreads ? kMinThreads : (threads > kMaxThreads ? kMaxThreads : threads);
  relax_kernel<<<batch, threads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      enter, start, turn, out, passes, rows, cols, padded_stride(cols), max_passes);
  return static_cast<int>(cudaGetLastError());
}
