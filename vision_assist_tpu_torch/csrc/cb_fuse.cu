// YOLOv9's CBFuse in one pass over device memory: a stage's output (the
// target) plus one channel slice of each of up to kMaxSources CBLinear
// outputs, each upsampled to the target's size by nearest indexing, summed in
// float32 and stored once in the target's dtype, channels_last.
//
//   out[b, y, x, c] = src_0[b, y / f_0, x / f_0, o_0 + c] + ... + src_{n-1}[...]
//                     + target[b, y, x, c]
//
// Replaces no Pallas kernel: the JAX package has no YOLOv9. In eager PyTorch
// the same fusion (Ultralytics' CBFuse: F.interpolate of each piece, a stack,
// a sum) writes every upsampled piece at the target's full size, stacks them
// and reads them back: at imgsz 640 the five fusions of a forward would move
// some three times the ~84 MB a frame that reading each piece once and the
// target once and writing the result once takes.
//
// The arithmetic is that of the plain twin (ops/cuda_cb_fuse.py,
// cb_fuse_plain) in its order: the pieces in list order, the target last,
// each add a float32 add rounded to nearest (__fadd_rn; the file is built
// with -fmad=false), bf16 widened exactly and narrowed once to nearest even.
// So the kernel is bit for bit its twin run on the card.
//
// What bounds it on an H100: bytes. It does one add an element a source;
// its least traffic is each source slice read once (the source pixels are
// 1/f^2 of the target's), the target read once and the result written once.
//
// The design does the least that reaches that:
// - One thread a 16-byte pack of one output pixel (8 bf16 or 4 float32
//   channels), neighbouring threads on neighbouring channels and pixels, so
//   the target's loads and the output's stores are whole lines.
// - Each source is read where it lies: a channel slice of its CBLinear
//   output, addressed by its own pixel stride (that output's channel count)
//   and the slice's offset, so no split view is ever copied. Neighbouring
//   output pixels that share a source pixel read the same 16 bytes; the
//   repeats hit L1/L2 (the largest source slice of a forward at 640 and 8
//   frames is 13 MB, the L2 holds 50), so device memory sees each once.
// - The integer factors and each source's size are passed by value, in one
//   struct, so a thread's index arithmetic is a few divisions and no loads.
// - The grid covers the packs with up to 8 CTAs of 256 threads an SM and
//   loops, enough loads in flight to hide the memory's latency.
// Channels, pixel strides or addresses off the 16-byte pack take the same
// loop a scalar a thread; no served shape does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kMaxSources = 8;
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

// Where each source lies: its first element of the slice (the slice's offset
// included), the elements between two of its pixels, its height and width,
// and the factor that maps a target pixel onto it (y / factor, x / factor).
struct Sources {
  const void* ptr[kMaxSources];
  long long pixel[kMaxSources];
  int height[kMaxSources];
  int width[kMaxSources];
  int factor[kMaxSources];
  int count;
};

// Pack q is channels (q % groups) * W .. + W of target pixel q / groups,
// pixels in (b, y, x) order.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
    cb_fuse_nhwc(const T* __restrict__ target, T* __restrict__ out, const Sources s,
                 long long packs, int groups, int height, int width) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long q = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; q < packs;
       q += stride) {
    const int c = static_cast<int>(q % groups) * W;
    const long long pixel = q / groups;
    const int x = static_cast<int>(pixel % width);
    const long long row = pixel / width;
    const int y = static_cast<int>(row % height);
    const long long b = row / height;
    float acc[W];
    for (int i = 0; i < s.count; ++i) {
      const int f = s.factor[i];
      const long long at =
          ((b * s.height[i] + y / f) * s.width[i] + x / f) * s.pixel[i] + c;
      const Pack<T, W> v = *reinterpret_cast<const Pack<T, W>*>(
          static_cast<const T*>(s.ptr[i]) + at);
#pragma unroll
      for (int j = 0; j < W; ++j) acc[j] = i == 0 ? widen(v.v[j]) : __fadd_rn(acc[j], widen(v.v[j]));
    }
    const Pack<T, W> t = reinterpret_cast<const Pack<T, W>*>(target)[q];
    Pack<T, W> r;
#pragma unroll
    for (int j = 0; j < W; ++j)
      r.v[j] = narrow<T>(s.count > 0 ? __fadd_rn(acc[j], widen(t.v[j])) : widen(t.v[j]));
    reinterpret_cast<Pack<T, W>*>(out)[q] = r;
  }
}

template <typename T>
cudaError_t launch(const void* target, void* out, const Sources& s, long long pixels,
                   int channels, int height, int width, int sms, cudaStream_t stream) {
  constexpr int V = kPackBytes / static_cast<int>(sizeof(T));
  const auto off_pack = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % kPackBytes != 0;
  };
  bool packed = channels % V == 0 && !off_pack(target) && !off_pack(out);
  for (int i = 0; i < s.count; ++i)
    packed = packed && s.pixel[i] % V == 0 && !off_pack(s.ptr[i]);
  const int groups = packed ? channels / V : channels;
  const long long packs = pixels * groups;
  const long long wanted = (packs + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sms) * kBlocksPerSm;
  const int blocks = static_cast<int>(wanted < most ? wanted : most);
  const T* in = static_cast<const T*>(target);
  T* o = static_cast<T*>(out);
  if (packed)
    cb_fuse_nhwc<T, V><<<blocks, kThreads, 0, stream>>>(in, o, s, packs, groups, height, width);
  else
    cb_fuse_nhwc<T, 1><<<blocks, kThreads, 0, stream>>>(in, o, s, packs, groups, height, width);
  return cudaGetLastError();
}

}  // namespace

// target and out: (batch, height, width, channels) contiguous, bf16 when
// bf16, else float32. Source i: `ptrs[i]` its slice's first element,
// `pixels[i]` the elements between two of its pixels (>= channels), and
// (heights[i], widths[i]) = (height, width) / factors[i]. The caller checks
// the shapes (ops/cuda_cb_fuse.py). Returns 0, a cudaError_t, or -2 past
// kMaxSources sources.
extern "C" int cb_fuse_launch(const void* target, void* out, int count,
                              const void* const* ptrs, const long long* pixels,
                              const int* heights, const int* widths, const int* factors,
                              long long batch, int channels, int height, int width, int bf16,
                              int device, void* stream) {
  constexpr int kMaxDevices = 64;
  static int sms_of[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (count < 0 || count > kMaxSources) return -2;
  if (batch < 1 || channels < 1 || height < 1 || width < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Sources s = {};
  s.count = count;
  for (int i = 0; i < count; ++i) {
    if (factors[i] < 1 || pixels[i] < channels || heights[i] * factors[i] != height ||
        widths[i] * factors[i] != width)
      return static_cast<int>(cudaErrorInvalidValue);
    s.ptr[i] = ptrs[i];
    s.pixel[i] = pixels[i];
    s.height[i] = heights[i];
    s.width[i] = widths[i];
    s.factor[i] = factors[i];
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sms_of[device] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long n_pixels = batch * height * width;
  const auto st = static_cast<cudaStream_t>(stream);
  err = bf16 ? launch<__nv_bfloat16>(target, out, s, n_pixels, channels, height, width,
                                     sms_of[device], st)
             : launch<float>(target, out, s, n_pixels, channels, height, width, sms_of[device],
                             st);
  return static_cast<int>(err);
}
