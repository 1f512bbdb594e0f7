// YOLOv9's ADown pools in one pass over device memory: of a channels_last
// x of (N, C, H, W), the 2x2 stride-1 average pool of every channel, its
// first C/2 channels stored as `avg`, and a 3x3 stride-2 max pool (padding
// 1, left out of the window) over the rounded averages of the last C/2
// channels stored as `mx`:
//
//   avg[n, y, x, c]   = pool(n, y, x, c)                   c < C/2
//   mx[n, oy, ox, c]  = max of pool(n, 2oy-1..2oy+1, 2ox-1..2ox+1, C/2 + c)
//   pool(n, y, x, c)  = T((((0 + x[y][x]) + x[y][x+1]) + x[y+1][x])
//                          + x[y+1][x+1]) / 4)
//
// Replaces no Pallas kernel: the JAX package has no YOLOv9. In eager
// PyTorch the same pools (F.avg_pool2d(x, 2, 1), .chunk(2, 1), then
// F.max_pool2d of the second half) write the whole average, copy each half
// to make it contiguous and read the second copy again for the max pool:
// four passes over tensors of x's size or half of it, where this one reads
// x once and writes the two results once.
//
// The arithmetic is ATen's (avg_pool2d_out_cuda_frame_nhwc, then
// max_pool_forward_nhwc), in its order, so the kernel is bit for bit the
// plain twin (ops/cuda_adown.py, adown_pool_plain) run on the card: each
// sum a float32 add from 0 in row-major order of the window (__fadd_rn;
// the file is built with -fmad=false), divided by 4 (a product with 0.25 is
// the same correctly rounded quotient) and narrowed once to nearest even;
// the max pool a row-major scan of the rounded averages that takes a value
// that is larger or NaN, so ties keep the first and the last NaN wins. That
// rule composes in order: the window's rows reduced each, then the three
// row results in order, give the scan's answer.
//
// What bounds it on an H100: bytes. It does four adds an average and a few
// comparisons a maximum; its least traffic is x read once and both outputs
// written once (81,965,312 bytes a frame for YOLOv9e-seg's 8 ADowns at imgsz
// 640 in bf16, 24.5 us at 3.35 TB/s).
//
// The design does the least that reaches that:
// - One thread a 16-byte pack of channels (8 bf16 or 4 float32) of one
//   half, one column group and a strip of kRows max-pool rows (2 kRows
//   average rows). A first-half thread makes average columns 2j and 2j+1
//   from input columns 2j..2j+2; a second-half thread makes max-pool column
//   j from input columns 2j-1..2j+2. Both halves have W/2 column groups and
//   H/2 output rows, rounded down, so one grid covers them: x over a half's
//   column groups and packs, y over strips and the two halves, z over the
//   frames, so a thread finds its place without a 64-bit division.
// - The thread walks down its strip a row at a time. Each input row is
//   loaded once into registers and its window row sums are kept there, so
//   a row feeds the averages above and below it; the averages feed the max
//   pool from registers, never from device memory.
// - Neighbouring threads hold neighbouring packs of one pixel and then
//   neighbouring column groups, so a warp's loads and stores are whole
//   256-byte runs. The columns two threads share and the one-row halo of a
//   strip are read again from L1 or L2, not from device memory.
// - A step of 8 frames at 640 has 100,000 to 820,000 threads an ADown, each
//   with 3 or 4 16-byte loads in flight a row, in blocks of 128 threads (a
//   fine grain for the last wave). Measured on an H100 against other
//   designs (float sums or packs held across rows, strips of 1 to 8 rows,
//   blocks of 64 to 256, a cp.async ring of 3 to 8 rows in shared memory):
//   this one moved a served step's bytes fastest, at 60-70 % of the
//   memory rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 2;        // max-pool output rows a thread
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

template <typename T, int V>
struct alignas(kPackBytes) Pack {
  T v[V];
};

struct Shape {
  long long batch;
  int channels, height, width;  // x
  int packs;                    // 16-byte packs in one half's channels
  int groups;                   // column groups: max-pool output columns
  int out_height;               // max-pool output rows
  int strips;                   // strips of kRows max-pool rows
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* x, const Shape& s, long long n, int row,
                                           int col, int ch) {
  return *reinterpret_cast<const Pack<T, V>*>(
      x + ((n * s.height + row) * s.width + col) * s.channels + ch);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* at, const Pack<T, V>& p) {
  *reinterpret_cast<Pack<T, V>*>(at) = p;
}

// The first row of a 2x2 window summed as ATen sums it: (0 + left) + right.
template <typename T, int V>
__device__ __forceinline__ void row_sum(float (&sum)[V], const Pack<T, V>& left,
                                        const Pack<T, V>& right) {
#pragma unroll
  for (int i = 0; i < V; ++i)
    sum[i] = __fadd_rn(__fadd_rn(0.0f, widen(left.v[i])), widen(right.v[i]));
}

// The window's average: its first row's sum, then the second row left to
// right, over 4, rounded to T.
template <typename T, int V>
__device__ __forceinline__ Pack<T, V> average(const float (&sum)[V], const Pack<T, V>& left,
                                              const Pack<T, V>& right) {
  Pack<T, V> r;
#pragma unroll
  for (int i = 0; i < V; ++i)
    r.v[i] = narrow<T>(
        __fmul_rn(__fadd_rn(__fadd_rn(sum[i], widen(left.v[i])), widen(right.v[i])), 0.25f));
  return r;
}

// One step of ATen's max-pool scan: `next` replaces `best` where it is
// larger or NaN.
template <typename T, int V>
__device__ __forceinline__ void take(Pack<T, V>& best, const Pack<T, V>& next) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float v = widen(next.v[i]);
    if (v > widen(best.v[i]) || v != v) best.v[i] = next.v[i];   // v != v: NaN
  }
}

// Thread (x, y, z): pack q = x % packs and column group j = x / packs of
// half y % 2 in strip y / 2 of frame z.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    adown_pool_nhwc(const T* __restrict__ x, T* __restrict__ avg, T* __restrict__ mx,
                    const Shape s) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= s.groups * s.packs) return;
  const int q = t % s.packs;
  const int j = t / s.packs;
  const bool second = blockIdx.y & 1;
  const int oy0 = static_cast<int>(blockIdx.y >> 1) * kRows;
  const long long n = blockIdx.z;
  const int oy1 = min(oy0 + kRows, s.out_height);
  const int half = s.channels / 2;
  const int avg_h = s.height - 1, avg_w = s.width - 1;
  const bool right = 2 * j + 2 < s.width;   // average column 2j+1 exists

  if (!second) {
    // Average columns 2j and 2j+1, rows 2 oy0 .. 2 oy1 - 1 (those that exist).
    const int ch = q * V, col = 2 * j, end = min(2 * oy1, avg_h);
    Pack<T, V> c0 = load<T, V>(x, s, n, 2 * oy0, col, ch);
    Pack<T, V> c1 = load<T, V>(x, s, n, 2 * oy0, col + 1, ch);
    Pack<T, V> c2;
    float s0[V], s1[V];
    row_sum(s0, c0, c1);
    if (right) {
      c2 = load<T, V>(x, s, n, 2 * oy0, col + 2, ch);
      row_sum(s1, c1, c2);
    }
    for (int y = 2 * oy0; y < end; ++y) {
      c0 = load<T, V>(x, s, n, y + 1, col, ch);
      c1 = load<T, V>(x, s, n, y + 1, col + 1, ch);
      T* out = avg + ((n * avg_h + y) * avg_w + col) * half + ch;
      store(out, average(s0, c0, c1));
      row_sum(s0, c0, c1);
      if (right) {
        c2 = load<T, V>(x, s, n, y + 1, col + 2, ch);
        store(out + half, average(s1, c1, c2));
        row_sum(s1, c1, c2);
      }
    }
    return;
  }

  // Max-pool column j, rows oy0 .. oy1 - 1: average columns 2j-1 (where
  // j > 0), 2j and 2j+1 (where it exists), average rows `first` .. `last`.
  const int ch = half + q * V, col = 2 * j;
  const bool left = j > 0;
  const int first = max(2 * oy0 - 1, 0), last = min(2 * oy1 - 1, avg_h - 1);
  Pack<T, V> l, m0, m1, r;
  float sl[V], sm[V], sr[V];
  m0 = load<T, V>(x, s, n, first, col, ch);
  m1 = load<T, V>(x, s, n, first, col + 1, ch);
  row_sum(sm, m0, m1);
  if (left) {
    l = load<T, V>(x, s, n, first, col - 1, ch);
    row_sum(sl, l, m0);
  }
  if (right) {
    r = load<T, V>(x, s, n, first, col + 2, ch);
    row_sum(sr, m1, r);
  }
  Pack<T, V> acc;
  T* out = mx + ((n * s.out_height + oy0) * s.groups + j) * half + q * V;
  const long long out_row = static_cast<long long>(s.groups) * half;
  for (int y = first; y <= last; ++y) {
    m0 = load<T, V>(x, s, n, y + 1, col, ch);
    m1 = load<T, V>(x, s, n, y + 1, col + 1, ch);
    // The window's row y, left to right.
    Pack<T, V> row;
    if (left) {
      l = load<T, V>(x, s, n, y + 1, col - 1, ch);
      row = average(sl, l, m0);
      take(row, average(sm, m0, m1));
      row_sum(sl, l, m0);
    } else {
      row = average(sm, m0, m1);
    }
    row_sum(sm, m0, m1);
    if (right) {
      r = load<T, V>(x, s, n, y + 1, col + 2, ch);
      take(row, average(sr, m1, r));
      row_sum(sr, m1, r);
    }
    // Row y is the middle row of output y / 2 where y is even; where it is
    // odd, the last row of output (y - 1) / 2 and the first of (y + 1) / 2.
    if (y & 1) {
      if (y != first) {
        take(acc, row);
        store(out + ((y - 1) / 2 - oy0) * out_row, acc);
      }
      acc = row;
    } else {
      if (y == 0)
        acc = row;
      else
        take(acc, row);
      if (y == avg_h - 1) store(out + (y / 2 - oy0) * out_row, acc);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* avg, void* mx, long long batch, int channels,
                   int height, int width, cudaStream_t stream) {
  constexpr int V = kPackBytes / static_cast<int>(sizeof(T));
  Shape s;
  s.batch = batch;
  s.channels = channels;
  s.height = height;
  s.width = width;
  s.packs = channels / 2 / V;
  s.groups = width / 2;
  s.out_height = height / 2;
  s.strips = (s.out_height + kRows - 1) / kRows;
  const dim3 grid((s.groups * s.packs + kThreads - 1) / kThreads, 2 * s.strips,
                  static_cast<unsigned>(batch));
  adown_pool_nhwc<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(avg), static_cast<T*>(mx), s);
  return cudaGetLastError();
}

}  // namespace

// x: (batch, height, width, channels) contiguous; avg: (batch, height - 1,
// width - 1, channels / 2); mx: (batch, height / 2, width / 2, channels / 2)
// (the max pool's (H - 2) / 2 + 1 rows and columns of the (H-1)x(W-1)
// averages); bf16 when bf16, else float32; batch and height at most 65535
// (the grid's z and y). Returns 0, a cudaError_t, or -2 where a half's
// channels are off the 16-byte pack or a pointer is off 16 bytes (the
// caller checks the rest: ops/cuda_adown.py).
extern "C" int adown_pool_launch(const void* x, void* avg, void* mx, long long batch,
                                 int channels, int height, int width, int bf16, int device,
                                 void* stream) {
  if (batch < 1 || batch > 65535 || channels < 2 || height < 2 || height > 65535 || width < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_pack = kPackBytes / (bf16 ? 2 : 4);
  const auto off_pack = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % kPackBytes != 0;
  };
  if (channels % (2 * per_pack) != 0 || off_pack(x) || off_pack(avg) || off_pack(mx)) return -2;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  err = bf16 ? launch<__nv_bfloat16>(x, avg, mx, batch, channels, height, width, st)
             : launch<float>(x, avg, mx, batch, channels, height, width, st);
  return static_cast<int>(err);
}
