// Greedy class-aware NMS: the keep mask of K score-sorted candidates, one
// CTA per image.
//
// Replaces the compiled JAX loop vision_assist_tpu/models/decode.py:137
// (jax.lax.fori_loop over max_candidates inside the jitted nms, :102):
//
//   keep = cand_valid
//   for i in 0..K-1:
//     if keep[i]: keep &= ~((iou[i] > thr) & (order > i))
//
// The boxes come with the class offset already added (the max_wh trick), so
// boxes of different classes never overlap.
//
// What bounds it on an H100: neither bytes nor FLOPs. An image moves 18 bytes
// a candidate (a box in, a flag in, a flag out); its IoU pairs are ~14 float
// operations each, K^2/2 pairs at most (7.3 M operations for K = 1024, 0.1 us
// of the card's float32 rate). The time goes into the greedy scan: step i
// depends on every earlier step, so it is a chain of K dependent steps on one
// SM, and into the pairs' IoUs on the one SM that holds the image.
//
// What the design does about that: it computes every IoU once, in parallel,
// before the chain starts, and leaves the chain a few register operations a
// step. A warp computes one 32-bit word of the bit mask "candidate j is
// suppressed by candidate i" (bit j - 32w of word w of row i) per iteration:
// lane t takes j = 32w + t, so the 32 lanes read 32 neighbouring boxes from
// shared memory, and a ballot packs the answers. Only rows of valid
// candidates and words at or right of the diagonal are computed, and only up
// to the last valid candidate (candidates after it can neither keep nor be
// kept). The mask lives in shared memory: K * ceil(K/32) words, 8 KB at
// K = 256 and 128 KB at K = 1024, past the 48 KB a launch gets without the
// opt-in. The scan is one warp: lane w holds word w of the suppressed set,
// a shuffle tells every lane whether candidate i is still alive, and an alive
// row is OR-ed in, one word a lane.
//
// Why keep is bit-equal to the plain loop (models/decode.py:greedy_keep): the
// IoU is the plain version's float32 expression in its order, each operation
// rounded to nearest through the _rn intrinsics (and the file is built with
// -fmad=false): max and min that pass a NaN on, as torch.maximum and
// torch.minimum do, a clamp at 0, inter = w * h, union = (area_i + area_j) -
// inter, inter / max(union, 1e-9f); the same float32 threshold, compared with
// ">". The scan visits i in order and row i holds only j > i, so it is the
// loop's recurrence.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxK = 1024;        // 32 words a row: one warp holds the suppressed set
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ bool iou_above(float4 a, float area_a, float4 b, float area_b,
                                          float thr) {
  const float w = clamp_min(__fsub_rn(min_nan(a.z, b.z), max_nan(a.x, b.x)), 0.0f);
  const float h = clamp_min(__fsub_rn(min_nan(a.w, b.w), max_nan(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, clamp_min(uni, 1e-9f)) > thr;
}

__host__ __device__ __forceinline__ int row_words(int k) { return (k + 31) >> 5; }

__host__ __device__ __forceinline__ long long shared_bytes(int k) {
  // boxes (float4), areas, the bit mask, the valid flags (rounded to 16 B)
  return 16LL * k + 4LL * k + 4LL * k * row_words(k) + ((k + 15) / 16) * 16LL;
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float* __restrict__ boxes, const unsigned char* __restrict__ valid,
           unsigned char* __restrict__ keep, int k, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned removed_s[32];
  __shared__ int n_s;
  const int words = row_words(k);
  float4* box = reinterpret_cast<float4*>(smem);
  float* area = reinterpret_cast<float*>(box + k);
  unsigned* mask = reinterpret_cast<unsigned*>(area + k);
  unsigned char* ok = reinterpret_cast<unsigned char*>(mask + static_cast<size_t>(k) * words);

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  const float* box_b = boxes + static_cast<size_t>(b) * k * 4;
  const unsigned char* valid_b = valid + static_cast<size_t>(b) * k;
  if (tid == 0) n_s = 0;
  __syncthreads();

  int last = 0;  // one past the last valid candidate this thread saw
  for (int i = tid; i < k; i += blockDim.x) {
    const float4 v = make_float4(box_b[4 * i], box_b[4 * i + 1], box_b[4 * i + 2],
                                 box_b[4 * i + 3]);
    box[i] = v;
    area[i] = __fmul_rn(__fsub_rn(v.z, v.x), __fsub_rn(v.w, v.y));
    ok[i] = valid_b[i] != 0;
    if (valid_b[i]) last = i + 1;
  }
  if (last) atomicMax(&n_s, last);
  __syncthreads();
  const int n = n_s;
  const int nw = row_words(n);

  // The bit mask: one word a warp an iteration, lane t on column 32w + t.
  const int total = n * nw;
  for (int t = warp; t < total; t += n_warps) {
    const int i = t / nw, w = t - i * nw;
    if (!ok[i] || w < (i >> 5)) continue;  // uniform across the warp
    const int j = (w << 5) + lane;
    const bool above = j > i && j < n && iou_above(box[i], area[i], box[j], area[j], thr);
    const unsigned bits = __ballot_sync(kFull, above);
    if (lane == 0) mask[static_cast<size_t>(i) * words + w] = bits;
  }
  __syncthreads();

  // The greedy scan: lane w holds word w of the suppressed set.
  if (warp == 0) {
    unsigned removed = 0;
    for (int i = 0; i < n; ++i) {
      const unsigned word = __shfl_sync(kFull, removed, i >> 5);
      if (ok[i] && !((word >> (i & 31)) & 1u) && lane >= (i >> 5) && lane < nw)
        removed |= mask[static_cast<size_t>(i) * words + lane];
    }
    removed_s[lane] = removed;
  }
  __syncthreads();
  for (int j = tid; j < k; j += blockDim.x)
    keep[static_cast<size_t>(b) * k + j] =
        (ok[j] && !((removed_s[j >> 5] >> (j & 31)) & 1u)) ? 1 : 0;
}

}  // namespace

// boxes (B, K, 4) f32 xyxy with the class offset added, valid (B, K) u8 ->
// keep (B, K) u8, all on card `device`. Returns the cudaError_t of the launch
// (0 on success); launches on `stream`, does not synchronise. The card is set
// here when it is not the current one (this library carries its own CUDA
// runtime), and the kernel's shared-memory limit is raised only when a launch
// needs more than any before it.
extern "C" int nms_launch(const float* boxes, const unsigned char* valid, unsigned char* keep,
                          int batch, int k, float iou_threshold, int device, void* stream) {
  constexpr int kMaxDevices = 64;
  static long long configured[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (k < 1 || k > kMaxK || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long smem = shared_bytes(k);
  if (smem > configured[device]) {
    err = cudaFuncSetAttribute(nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[device] = smem;
  }
  nms_kernel<<<batch, kThreads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      boxes, valid, keep, k, iou_threshold);
  return static_cast<int>(cudaGetLastError());
}
