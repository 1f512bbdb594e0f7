// Wavefront relaxation: single-source min-plus fixed point over
// (incoming direction x cell) states, one CTA per stream.
//
// Replaces the Pallas TPU kernel vision_assist_tpu/ops/pallas_wavefront.py
// (_relax_kernel, launched by relax_pallas through pl.pallas_call).
//
// What bounds it on an H100: neither bytes nor FLOPs. One stream moves
// (R*C + 4*R*C) * 4 bytes in and out of device memory once and does ~10 float
// operations per state per sweep, but the sweeps are serial: each one is a
// 4x4 min-plus stencil over shifted neighbours followed by a block-wide
// barrier and vote. The design keeps every sweep on chip: the whole state,
// double-buffered for strict Jacobi order, plus the entry costs, lives in
// shared memory (9 * R * C * 4 bytes: 36 KB at 32x32, 81 KB at 64x36), and
// convergence is decided by __syncthreads_or, so a stream never leaves its SM
// between the first sweep and the final write.
//
// Arithmetic order matches the plain twin (planning/wavefront.py:relax_field)
// exactly: cand = fl(fl(min_d' fl(parent[d'] + T[d'][d])) + enter), then
// min(old, cand). Built without --use_fast_math; there are no multiplies, so
// no contraction into FMA can change a rounding. The output is bit-equal.

#include <cuda_runtime.h>

namespace {

constexpr float kInf = 3.0e38f;  // the reference's finite "infinity"
constexpr int kThreads = 1024;

// Moves d = 0..3: right, left, down, up as (dr, dc).
__device__ __forceinline__ int move_dr(int d) { return d == 2 ? 1 : (d == 3 ? -1 : 0); }
__device__ __forceinline__ int move_dc(int d) { return d == 0 ? 1 : (d == 1 ? -1 : 0); }

__global__ void __launch_bounds__(kThreads)
relax_kernel(const float* __restrict__ enter, const int* __restrict__ start,
             const float* __restrict__ turn, float* __restrict__ out,
             int* __restrict__ sweeps_out, int rows, int cols, int max_sweeps) {
  extern __shared__ float smem[];
  __shared__ float T[16];
  const int n = rows * cols;
  float* cur = smem;          // [4][n]
  float* nxt = smem + 4 * n;  // [4][n]
  float* ent = smem + 8 * n;  // [n]

  const int b = blockIdx.x;
  const float* enter_b = enter + static_cast<size_t>(b) * n;
  const int start_cell = start[2 * b] * cols + start[2 * b + 1];

  if (threadIdx.x < 16) T[threadIdx.x] = turn[threadIdx.x];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    ent[i] = enter_b[i];
    const float v = (i == start_cell) ? 0.0f : kInf;
#pragma unroll
    for (int d = 0; d < 4; ++d) cur[d * n + i] = v;
  }
  __syncthreads();

  int sweep = 0;
  while (sweep < max_sweeps) {
    ++sweep;
    int changed = 0;
    for (int s = threadIdx.x; s < 4 * n; s += blockDim.x) {
      const int d = s / n;
      const int i = s - d * n;
      const int r = i / cols;
      const int c = i - r * cols;
      const int pr = r - move_dr(d);
      const int pc = c - move_dc(d);
      const bool inside = pr >= 0 && pr < rows && pc >= 0 && pc < cols;
      const int p = inside ? pr * cols + pc : 0;  // never read when outside
      float m = (inside ? cur[p] : kInf) + T[d];
#pragma unroll
      for (int dp = 1; dp < 4; ++dp) {
        const float parent = inside ? cur[dp * n + p] : kInf;
        m = fminf(m, parent + T[dp * 4 + d]);
      }
      const float cand = m + ent[i];
      const float old = cur[s];
      const float nv = fminf(old, cand);
      nxt[s] = nv;
      changed |= (nv < old);
    }
    const int any = __syncthreads_or(changed);
    float* t = cur;
    cur = nxt;
    nxt = t;
    if (!any) break;
  }

  float* out_b = out + static_cast<size_t>(b) * n * 4;
  for (int s = threadIdx.x; s < 4 * n; s += blockDim.x) {
    const int d = s / n;
    const int i = s - d * n;
    out_b[i * 4 + d] = cur[s];
  }
  if (threadIdx.x == 0) sweeps_out[b] = sweep;
}

}  // namespace

// enter (B, R, C) f32, start (B, 2) i32, turn (4, 4) f32 -> out (B, R, C, 4)
// f32 and sweeps (B,) i32, all pointers on card `device`. Returns the
// cudaError_t of the launch (0 on success); launches on `stream`, does not
// synchronise. This library carries its own CUDA runtime, so the card is set
// here rather than inherited from the caller's runtime.
extern "C" int relax_launch(const float* enter, const int* start, const float* turn,
                            float* out, int* sweeps, int batch, int rows, int cols,
                            int max_sweeps, int device, void* stream) {
  const size_t smem = static_cast<size_t>(9) * rows * cols * sizeof(float);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      relax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  relax_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      enter, start, turn, out, sweeps, rows, cols, max_sweeps);
  return static_cast<int>(cudaGetLastError());
}

// The largest lattice (rows * cols) whose state fits in one block's shared
// memory on card `device`, or -1 on error.
extern "C" int relax_max_cells(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return (optin - 16 * static_cast<int>(sizeof(float))) / (9 * static_cast<int>(sizeof(float)));
}
