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
// - Stored where its readers read it (bn_act_into_launch): in eval mode the
//   segmenter's blocks hand the epilogue a channel slice of the channels_last
//   buffer their next convolution reads as a concatenation, so no block
//   concatenates. The store address is the pixel times the buffer's channel
//   count plus the thread's channels; where a convolution reads the result as
//   well, the same packs go, from the same registers, to a contiguous tensor
//   too (all channels, or those from a given one on). Same packs, same table,
//   one launch a call; only the addresses change.
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
// pixel. Thread g owns channels (g % groups) * W .. + W and every pack
// g + k * stride, stride a multiple of groups, so its pixel advances by
// stride / groups a step. Its first pack is loaded before the table is made,
// so the two latencies overlap. The result of pixel p goes to
// y + p * y_pixel (y_pixel = C for a tensor of its own, the wider buffer's
// channel count for a channel slice of it); where `also` is given, channels
// [also_from, C) go there too, at also + p * (C - also_from), from the same
// registers.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
    bn_act_nhwc(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ weight,
                const float* __restrict__ bias, const float* __restrict__ mean,
                const float* __restrict__ var, float eps, long long packs, int groups,
                int act, long long y_pixel, T* __restrict__ also, int also_from) {
  extern __shared__ float table[];
  const int channels = groups * W;
  const long long threads = static_cast<long long>(gridDim.x) * kThreads;
  const long long stride = threads / groups * groups;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool active = first < stride && first < packs;
  const auto* in = reinterpret_cast<const Pack<T, W>*>(x);
  Pack<T, W> p;
  if (active) p = in[first];
  make_table(table, weight, bias, mean, var, eps, channels);
  if (!active) return;
  const int c0 = static_cast<int>(first % groups) * W;
  const long long pixel = first / groups, pixel_step = stride / groups;
  T* dst = y + pixel * y_pixel + c0;
  const long long dst_step = pixel_step * y_pixel;
  const long long also_pixel = channels - also_from;
  T* dst2 = also != nullptr && c0 >= also_from ? also + pixel * also_pixel + (c0 - also_from)
                                               : nullptr;
  const long long dst2_step = pixel_step * also_pixel;
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
    *reinterpret_cast<Pack<T, W>*>(dst) = p;
    dst += dst_step;
    if (dst2 != nullptr) {
      *reinterpret_cast<Pack<T, W>*>(dst2) = p;
      dst2 += dst2_step;
    }
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
                   long long hw, bool channels_last, int act, int sms, cudaStream_t stream,
                   long long y_pixel, void* also, int also_from) {
  constexpr int V = kPackBytes / static_cast<int>(sizeof(T));
  const T* in = static_cast<const T*>(x);
  T* out = static_cast<T*>(y);
  T* two = static_cast<T*>(also);
  const auto off_pack = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % kPackBytes != 0;
  };
  const bool aligned = !off_pack(x) && !off_pack(y) && !off_pack(also);
  const size_t smem = 3 * sizeof(float) * static_cast<size_t>(channels);
  if (channels_last) {
    const bool packed = aligned && channels % V == 0 && y_pixel % V == 0 && also_from % V == 0;
    const int groups = packed ? channels / V : channels;
    const long long packs = packed ? n / V : n;
    int blocks = blocks_for(packs, sms);
    const int least = (groups + kThreads - 1) / kThreads;   // every channel owned
    if (blocks < least) blocks = least;
    if (packed)
      bn_act_nhwc<T, V><<<blocks, kThreads, smem, stream>>>(
          in, out, weight, bias, mean, var, eps, packs, groups, act, y_pixel, two, also_from);
    else
      bn_act_nhwc<T, 1><<<blocks, kThreads, smem, stream>>>(
          in, out, weight, bias, mean, var, eps, packs, groups, act, y_pixel, two, also_from);
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

int run(const void* x, void* y, const float* weight, const float* bias, const float* mean,
        const float* var, float eps, long long n, int channels, long long hw,
        int channels_last, int bf16, int act, int device, void* stream, long long y_pixel,
        void* also, int also_from) {
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
                                     channels_last != 0, act, sms_of[device], s, y_pixel, also,
                                     also_from)
             : launch<float>(x, y, weight, bias, mean, var, eps, n, channels, hw,
                             channels_last != 0, act, sms_of[device], s, y_pixel, also,
                             also_from);
  return static_cast<int>(err);
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
  return run(x, y, weight, bias, mean, var, eps, n, channels, hw, channels_last, bf16, act,
             device, stream, channels, nullptr, 0);
}

// The same epilogue on channels_last x, stored into a view: pixel p of the
// result at y + p * y_pixel (y_pixel >= channels: a channel slice of a wider
// channels_last buffer), and, where `also` is not null, its channels
// [also_from, channels) at also + p * (channels - also_from) as well. The
// caller checks that the view fits (ops/cuda_bn_act.py): 16-byte addresses,
// and y_pixel, channels and also_from multiples of the 16-byte pack.
extern "C" int bn_act_into_launch(const void* x, void* y, const float* weight,
                                  const float* bias, const float* mean, const float* var,
                                  float eps, long long n, int channels, long long hw, int bf16,
                                  int act, int device, void* stream, long long y_pixel,
                                  void* also, int also_from) {
  if (y_pixel < channels || also_from < 0 || also_from >= channels)
    return static_cast<int>(cudaErrorInvalidValue);
  return run(x, y, weight, bias, mean, var, eps, n, channels, hw, 1, bf16, act, device, stream,
             y_pixel, also, also_from);
}
