// The epilogue of the segmenter's ConvBNAct in eval mode, in one pass over
// device memory: the convolution's output (bf16, or float32 for a float32
// model) -> BatchNorm with the running statistics, in float32 -> SiLU where
// the block has it -> the convolution's dtype.
//
// Replaces no Pallas kernel. The JAX package leaves this chain to XLA, which
// fuses it into the convolution's output (vision_assist_tpu/models/yolo.py,
// ConvBNAct: nn.BatchNorm, nn.silu, astype). In eager PyTorch the same chain
// was four passes, four launches a block: a cast to float32 (2 B read, 4 B
// written an element), cuDNN's float32 BatchNorm (4 + 4), SiLU (4 + 4) and a
// cast back (4 + 2): 28 B an element, against 4 B for one pass that reads and
// writes bf16.
//
//   mul = weight / sqrt(var + eps)                  (a channel)
//   y   = (x - mean) * mul + bias
//   y   = y / (1 + exp(-y))                         (act)
//
// The arithmetic is that of the plain twin (ops/cuda_bn_act.py,
// bn_act_plain) in its order, each step rounded to float32 as PyTorch's
// elementwise operators round it: the _rn intrinsics, expf as PyTorch's exp
// calls it, and the file is built with -fmad=false, so nothing is contracted.
// bf16 is widened exactly and narrowed to nearest even. So the kernel is bit
// for bit its twin run on the card.
//
// What bounds it on an H100: bytes and launch latency, never arithmetic. The
// largest launch at the served shapes (yolo11n-seg at imgsz 256, 8 frames)
// has 2.1 M elements, 8.4 MB read and written, 2.5 us at 3.35 TB/s; most are
// under 1 us by bytes, so a launch costs about its latency, 2-3 us.
//
// The design does the least that reaches that:
// - Each CTA first makes a table of mul, mean and bias for every channel in
//   its shared memory, one channel a thread (nothing is cached between
//   launches: reloaded weights are read as they are), while its first pack
//   of data is already on its way from device memory. So a thread waits on
//   one correctly rounded square root and division, not on the 8 of its own
//   channels in a row ahead of its data.
// - Channels innermost (channels_last, the served layout: the network runs on
//   the letterboxed NHWC frame permuted) with C a multiple of 16 B / sizeof(T):
//   16-byte loads and stores, 8 bf16 or 4 float32 a thread a step. The
//   grid-stride loop steps by a multiple of C / 8 packs, so each thread's
//   channels are fixed for the whole launch and their mul, mean and bias stay
//   in registers. Other channel counts take the same loop a scalar a step.
// - Contiguous NCHW: a grid-stride loop over packs of 16 B inside one plane
//   (H * W a multiple of the pack) or scalars, the channel (i / HW) % C read
//   from the table.
// - The grid is sized to the work, up to 8 CTAs of 256 threads an SM, so one
//   wave covers the served launches with a pack or two a thread and enough
//   loads in flight to hide the memory's latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxTableChannels = 4096;   // 48 KB of shared memory: mul, mean, bias
constexpr int kPackBytes = 16;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int W>
struct alignas(sizeof(T) * W) Pack {
  T v[W];
};

__device__ __forceinline__ float scale_of(float weight, float var, float eps) {
  return __fdiv_rn(weight, __fsqrt_rn(__fadd_rn(var, eps)));
}

__device__ __forceinline__ float epilogue(float x, float mean, float mul, float bias,
                                          bool act) {
  const float y = __fadd_rn(__fmul_rn(__fsub_rn(x, mean), mul), bias);
  return act ? __fdiv_rn(y, __fadd_rn(1.0f, expf(-y))) : y;
}

// Each CTA's table of mul, mean and bias for every channel, made at every
// launch, one channel a thread: `table` holds mul[channels], mean[channels],
// bias[channels]. Every thread of the CTA must call it (a barrier).
__device__ __forceinline__ void make_table(float* table, const float* __restrict__ weight,
                                           const float* __restrict__ bias,
                                           const float* __restrict__ mean,
                                           const float* __restrict__ var, float eps,
                                           int channels) {
  for (int c = threadIdx.x; c < channels; c += kThreads) {
    table[c] = scale_of(weight[c], var[c], eps);
    table[channels + c] = mean[c];
    table[2 * channels + c] = bias[c];
  }
  __syncthreads();
}

// Channels innermost: `packs` packs of W elements, `groups` = C / W of them a
// row. Thread g owns channels (g % groups) * W .. + W and every pack
// g + k * stride, stride a multiple of groups. Its first pack is loaded
// before the table is made, so the two latencies overlap.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
    bn_act_nhwc(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ weight,
                const float* __restrict__ bias, const float* __restrict__ mean,
                const float* __restrict__ var, float eps, long long packs, int groups,
                int act) {
  extern __shared__ float table[];
  const int channels = groups * W;
  const long long threads = static_cast<long long>(gridDim.x) * kThreads;
  const long long stride = threads / groups * groups;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool active = first < stride && first < packs;
  const auto* in = reinterpret_cast<const Pack<T, W>*>(x);
  auto* out = reinterpret_cast<Pack<T, W>*>(y);
  Pack<T, W> p;
  if (active) p = in[first];
  make_table(table, weight, bias, mean, var, eps, channels);
  if (!active) return;
  const int c0 = static_cast<int>(first % groups) * W;
  float mul[W], mu[W], b[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    mul[j] = table[c0 + j];
    mu[j] = table[channels + c0 + j];
    b[j] = table[2 * channels + c0 + j];
  }
  for (long long q = first;;) {
#pragma unroll
    for (int j = 0; j < W; ++j) p.v[j] = narrow<T>(epilogue(widen(p.v[j]), mu[j], mul[j], b[j], act));
    out[q] = p;
    q += stride;
    if (q >= packs) break;
    p = in[q];
  }
}

// Contiguous NCHW: pack q holds elements q * W .. + W of one plane (W divides
// hw), channel (q * W / hw) % channels, from the CTA's table.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
    bn_act_nchw(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ weight,
                const float* __restrict__ bias, const float* __restrict__ mean,
                const float* __restrict__ var, float eps, long long packs, int channels,
                long long hw, int act) {
  extern __shared__ float table[];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const auto* in = reinterpret_cast<const Pack<T, W>*>(x);
  auto* out = reinterpret_cast<Pack<T, W>*>(y);
  Pack<T, W> p;
  if (first < packs) p = in[first];
  make_table(table, weight, bias, mean, var, eps, channels);
  for (long long q = first; q < packs;) {
    const int c = static_cast<int>((q * W / hw) % channels);
    const float mul = table[c], mu = table[channels + c], b = table[2 * channels + c];
#pragma unroll
    for (int j = 0; j < W; ++j) p.v[j] = narrow<T>(epilogue(widen(p.v[j]), mu, mul, b, act));
    out[q] = p;
    q += stride;
    if (q < packs) p = in[q];
  }
}

int blocks_for(long long packs, int sms) {
  const long long wanted = (packs + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sms) * kBlocksPerSm;
  return static_cast<int>(wanted < most ? wanted : most);
}

template <typename T>
cudaError_t launch(const void* x, void* y, const float* weight, const float* bias,
                   const float* mean, const float* var, float eps, long long n, int channels,
                   long long hw, bool channels_last, int act, int sms, cudaStream_t stream) {
  constexpr int V = kPackBytes / static_cast<int>(sizeof(T));
  const T* in = static_cast<const T*>(x);
  T* out = static_cast<T*>(y);
  const bool aligned = reinterpret_cast<std::uintptr_t>(x) % kPackBytes == 0 &&
                       reinterpret_cast<std::uintptr_t>(y) % kPackBytes == 0;
  const size_t smem = 3 * sizeof(float) * static_cast<size_t>(channels);
  if (channels_last) {
    const bool packed = aligned && channels % V == 0;
    const int groups = packed ? channels / V : channels;
    const long long packs = packed ? n / V : n;
    int blocks = blocks_for(packs, sms);
    const int least = (groups + kThreads - 1) / kThreads;   // every channel owned
    if (blocks < least) blocks = least;
    if (packed)
      bn_act_nhwc<T, V><<<blocks, kThreads, smem, stream>>>(in, out, weight, bias, mean, var,
                                                            eps, packs, groups, act);
    else
      bn_act_nhwc<T, 1><<<blocks, kThreads, smem, stream>>>(in, out, weight, bias, mean, var,
                                                            eps, packs, groups, act);
  } else {
    const bool packed = aligned && hw % V == 0;
    const long long packs = packed ? n / V : n;
    const int blocks = blocks_for(packs, sms);
    if (packed)
      bn_act_nchw<T, V><<<blocks, kThreads, smem, stream>>>(in, out, weight, bias, mean, var,
                                                            eps, packs, channels, hw, act);
    else
      bn_act_nchw<T, 1><<<blocks, kThreads, smem, stream>>>(in, out, weight, bias, mean, var,
                                                            eps, packs, channels, hw, act);
  }
  return cudaGetLastError();
}

}  // namespace

// x and y: n = batch * channels * hw elements, channels innermost when
// channels_last, else contiguous NCHW; bf16 when bf16, else float32. weight,
// bias, mean and var: `channels` float32 each. Returns 0, a cudaError_t, or
// -2 when there are more channels than a CTA's shared-memory table holds.
extern "C" int bn_act_launch(const void* x, void* y, const float* weight, const float* bias,
                             const float* mean, const float* var, float eps, long long n,
                             int channels, long long hw, int channels_last, int bf16, int act,
                             int device, void* stream) {
  constexpr int kMaxDevices = 64;
  static int sms_of[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (n < 1 || channels < 1 || hw < 1 || n % (static_cast<long long>(channels) * hw) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (channels > kMaxTableChannels) return -2;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sms_of[device] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  err = bf16 ? launch<__nv_bfloat16>(x, y, weight, bias, mean, var, eps, n, channels, hw,
                                     channels_last != 0, act, sms_of[device], s)
             : launch<float>(x, y, weight, bias, mean, var, eps, n, channels, hw,
                             channels_last != 0, act, sms_of[device], s);
  return static_cast<int>(err);
}
