// Greedy class-aware NMS of S images in one launch: candidate selection, the
// class offset, the IoU bit mask, the greedy scan and the gather of the
// first max_det kept, from the best-class scores to the five Detections
// fields. A cluster of 8 CTAs an image.
//
// Replaces the jitted JAX nms after its sigmoid, vision_assist_tpu/models/
// decode.py:102-150: the top_k of the scores above conf_threshold (:117),
// the class offset (:127-128), the fori_loop keep mask (:131-137) and the
// gather of the first max_det kept (:139-150):
//
//   cand   = the anchors with score > conf, by score descending, index
//            ascending (a stable sort), the first K of them
//   boxes' = boxes + class * 7680            (the max_wh trick)
//   keep   = for i in 0..n-1: if kept[i]: drop every j > i with IoU > thr
//   out[r] = the r-th kept candidate's box, score, class, coefficients
//
// What bounds it on an H100: neither bytes nor FLOPs. An image moves its A
// scores and classes, the n valid candidates' boxes and coefficients and its
// max_det outputs; its IoU pairs are ~14 float operations each, n^2/2 pairs at
// most (7.3 M operations at n = 1024, 0.1 us of the card's float32 rate). The
// time goes into latency and issue: the greedy scan is a chain of n / 32
// dependent blocks, the sort ~log^2 m steps behind barriers, and each word of
// the bit mask 32 IoUs with a correctly rounded division, on the 8 SMs of an
// image.
//
// The design:
// 1. Selection, in the leader CTA (rank 0). Each warp ballots "score > conf"
//    (a NaN is not above) over 32 anchors and appends the valid ones to a
//    shared array of 64-bit keys through one atomicAdd a warp: (~ordered
//    score bits) << 32 | anchor, so ascending keys are scores descending, then
//    anchors ascending, exactly torch.sort(descending=True, stable=True)
//    restricted to the valid anchors. The append order does not matter: all
//    keys differ. A bitonic sort of the m keys follows, in its form whose
//    comparators all put the smaller key first: padding the m keys to the
//    next power of two with +inf keys, a comparator (i, j), i < j, never moves
//    a pad key, so every comparator with j >= m is skipped and only m keys are
//    stored (A * 8 bytes: 67200 B at A = 8400). Steps between keys less than
//    32 apart run in registers through warp shuffles, the others in shared
//    memory behind a barrier each (21 barriers at m = 1024, 1 at m <= 32).
//    The plain code also sorts the invalid anchors and carries them as
//    padding; none of them reaches an output (the final where()s zero those
//    slots), so their order is not reproduced here. The first n = min(m, K)
//    keys' anchors are the candidates.
// 2. The class offset and the IoU bit mask over the cluster. After a
//    cluster barrier, every CTA reads the leader's anchor list through
//    distributed shared memory, loads the candidates' boxes and classes,
//    adds cls * 7680.0f (__fmul_rn, __fadd_rn) and computes the areas in its
//    own shared memory. CTA r computes rows i = r (mod 8) of the upper
//    triangle: one 32-bit word (bit t: candidate 32w + t is suppressed by i)
//    a warp-iteration, lane t on column 32w + t, a __ballot_sync packing the
//    answers, the CTA's rows dealt out to its warps in snake order, and lane
//    0 stores the word straight into the leader's mask; a second cluster
//    barrier before the leader reads it. The mask keeps the upper triangle
//    only (row i from word i/32 on) and reuses the keys' buffer: 67584 B at
//    n = 1024. A CTA has 512 threads and ~93 KB of shared memory at K =
//    1024, so two fit on an SM and the 16 clusters of an evaluation batch
//    run at once. The barriers are split into arrive and wait. Every other CTA
//    counts the valid anchors itself while the leader selects, so all know
//    n: up to 64 candidates (a served frame has ~9, an evaluation image
//    ~36) the leader computes the mask alone, the others leave at once, and
//    no CTA waits on another.
// 3. The greedy scan, in the leader's warp 0, by blocks of 32 candidates.
//    Lane w holds word w of the suppressed set. For block b, lane t loads row
//    32b + t's diagonal word, and the block's kept set is resolved in
//    registers as the fixed point of keep = alive & ~OR(diagonal words of
//    the kept), one warp OR-reduction a round: round k settles candidate k
//    at the latest, and the rounds stop at the first that changes nothing
//    (a handful where suppression chains are short, against 32 dependent
//    steps for the serial loop over the block). Then lane w > b ORs word w
//    of each kept row of the block (independent loads). Row i holds only
//    columns j > i, so this is the plain loop's recurrence.
// 4. The gather. Popcount prefixes of the keep words give each kept
//    candidate its rank; the first max_det go straight into the outputs
//    (box without the offset, score, class, coefficients, valid), the rest
//    are 0, or -1 for the class, as the plain code writes them.
//
// Why the outputs are bit-equal to the plain code (models/decode.py,
// nms_from_scores): the conf comparison is the plain one (the threshold comes
// rounded to the scores' dtype, as PyTorch compares a tensor with a Python
// number); bf16 inputs are widened exactly; the IoU is the plain float32
// expression in its order, each operation rounded to nearest through the _rn
// intrinsics (and the file is built with -fmad=false): max and min that pass
// a NaN on, as torch.maximum and torch.minimum do, a clamp at 0, inter = w *
// h, union = (area_i + area_j) - inter, inter / max(union, 1e-9f), compared
// with ">" to the float32 threshold (a zero numerator is compared without the
// division: 0 / union is +-0, or NaN for a NaN union); the outputs are copies
// of input bits.

// The "@profile" comments mark the kernel's sections; utils/profile_nms.py
// turns them into clock stamps in a copy of this file.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
// @profile include

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;        // CTAs an image: a portable cluster size
constexpr int kThreads = 512;      // two CTAs an SM
constexpr int kMaxK = 1024;        // 32 words a row: one warp holds the suppressed set
constexpr int kSolo = 64;          // up to this many candidates the leader works alone
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
  const float uni = clamp_min(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-9f);
  // Most pairs do not overlap, and the division is much slower with a zero
  // numerator: 0 / uni is +-0, or NaN for a NaN uni, so that is compared
  // directly.
  const float quotient = __fdiv_rn(inter == 0.0f ? 1.0f : inter, uni);
  return inter == 0.0f ? uni == uni && 0.0f > thr : quotient > thr;
}

// barrier.cluster in two halves: a CTA arrives when its part is done and
// waits only where it needs the others' (release and acquire order the
// distributed shared memory between them).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address in CTA `rank`'s shared memory of what `p` is in this CTA's, for
// st_cluster.
__device__ __forceinline__ unsigned cluster_address(const void* p, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_cluster(unsigned address, unsigned value) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(address), "r"(value) : "memory");
}

// Element i of a float32 or bf16 array, widened exactly to float32.
__device__ __forceinline__ float load_float(const void* p, long long i, bool bf16) {
  if (bf16) return __uint_as_float(static_cast<unsigned>(static_cast<const unsigned short*>(p)[i]) << 16);
  return static_cast<const float*>(p)[i];
}

// The outputs of slots r < max_det of one image in one pass, so that their
// loads are in flight together: slot r's box and coefficient rows, in units
// U (rows of box_units and coeff_units of them), and at the first unit of the
// slot its score, class and valid flag; the anchor of slot r < kept is
// first + sel[r], and later slots are zeros, class -1.
template <typename U>
__device__ __forceinline__ void gather_slots(const float* boxes, const void* scores,
                                             const long long* classes, const void* coeffs,
                                             float* out_boxes, void* out_scores,
                                             int* out_classes, void* out_coeffs,
                                             unsigned char* out_valid, long long first,
                                             long long out0, const int* sel, int kept,
                                             int max_det, int box_units, int coeff_units,
                                             bool bf16, int tid) {
  const int per = box_units > coeff_units ? box_units : coeff_units;
  for (int e = tid; e < per * max_det; e += kThreads) {
    const int r = e / per, c = e - r * per;
    const bool ok = r < kept;
    const long long at = first + (ok ? sel[r] : 0), slot = out0 + r;
    U box = {}, coeff = {};
    unsigned score = 0;
    int cls = -1;
    if (ok) {
      if (c < box_units) box = reinterpret_cast<const U*>(boxes)[at * box_units + c];
      if (c < coeff_units) coeff = static_cast<const U*>(coeffs)[at * coeff_units + c];
      if (c == 0) {
        score = bf16 ? static_cast<const unsigned short*>(scores)[at]
                     : static_cast<const unsigned*>(scores)[at];
        cls = static_cast<int>(classes[at]);
      }
    }
    if (c < box_units) reinterpret_cast<U*>(out_boxes)[slot * box_units + c] = box;
    if (c < coeff_units) static_cast<U*>(out_coeffs)[slot * coeff_units + c] = coeff;
    if (c == 0) {
      if (bf16)
        static_cast<unsigned short*>(out_scores)[slot] = static_cast<unsigned short>(score);
      else
        static_cast<unsigned*>(out_scores)[slot] = score;
      out_classes[slot] = cls;
      out_valid[slot] = ok ? 1 : 0;
    }
  }
}

// Ascending keys: score descending, then anchor ascending.
__device__ __forceinline__ unsigned long long sort_key(float score, int anchor) {
  const unsigned u = __float_as_uint(score == 0.0f ? 0.0f : score);   // -0 ranks as +0
  const unsigned ordered = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // ascending in score
  return (static_cast<unsigned long long>(~ordered) << 32) | static_cast<unsigned>(anchor);
}

__host__ __device__ __forceinline__ int row_words(int k) { return (k + 31) >> 5; }

// The bit mask keeps the upper triangle only: row i holds words i/32 .. nw-1,
// rows one after another. Offset of row i's first word (at word i/32).
__device__ __forceinline__ int row_offset(int i, int nw) {
  const int b = i >> 5;
  return 32 * (b * nw - (b * (b - 1) >> 1)) + (i & 31) * (nw - b);
}

struct Layout {          // byte offsets into the dynamic shared memory
  long long box, shared_u, area, idx, sel, total;
};

// Every CTA gets the same layout. The union region holds the leader's sort
// keys (8 B an anchor) and then its bit mask (the upper triangle of k rows).
__host__ __device__ __forceinline__ Layout layout(int anchors, int max_candidates, int max_det) {
  const long long kc = anchors < max_candidates ? anchors : max_candidates;
  const long long nw = row_words(static_cast<int>(kc));
  const long long keys = 8LL * anchors, mask = 4LL * 32 * (nw * (nw + 1) / 2);
  Layout l;
  l.box = 0;
  l.shared_u = 16 * kc;
  l.area = l.shared_u + (((keys > mask ? keys : mask) + 15) / 16) * 16;
  l.idx = l.area + 4 * kc;
  l.sel = l.idx + 4 * kc;
  l.total = l.sel + 4LL * max_det;
  return l;
}

// One compare-exchange step in registers: lane and lane ^ across hold a
// pair, the lane with `half` clear keeps the smaller key.
__device__ __forceinline__ unsigned long long exchange(unsigned long long k, int across,
                                                      int half, int lane) {
  const unsigned long long other = __shfl_xor_sync(kFull, k, across);
  return ((lane & half) == 0) == (other < k) ? other : k;
}

// A warp's 32 keys, one a lane, through the network's merges of sizes 2 to
// `top` (top <= 32: each merge's mirrored first step, then its
// half-cleaners), or, with top == 0, through the half-cleaners of strides 16
// to 1 alone.
__device__ __forceinline__ unsigned long long sort_in_registers(unsigned long long k, int top,
                                                                int lane) {
  if (top) {
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
      if (size > top) break;
      k = exchange(k, size - 1, size >> 1, lane);
#pragma unroll
      for (int stride = size >> 2; stride > 0; stride >>= 1) k = exchange(k, stride, stride, lane);
    }
  } else {
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1) k = exchange(k, stride, stride, lane);
  }
  return k;
}

// Every chunk of 32 keys below m through sort_in_registers, a warp C chunks at
// once. Keys at or past m are +inf in registers and never stored, which is
// the comparators' skip.
template <int C>
__device__ __forceinline__ void sort_in_warps(unsigned long long* keys, int m, int top,
                                              int lane, int warp) {
  constexpr int n_warps = kThreads / 32;
  for (int c0 = warp; c0 * 32 < m; c0 += C * n_warps) {
    unsigned long long k[C];
#pragma unroll
    for (int u = 0; u < C; ++u) {
      const int i = (c0 + u * n_warps) * 32 + lane;
      k[u] = i < m ? keys[i] : ~0ull;
    }
#pragma unroll
    for (int u = 0; u < C; ++u) k[u] = sort_in_registers(k[u], top, lane);
#pragma unroll
    for (int u = 0; u < C; ++u) {
      const int i = (c0 + u * n_warps) * 32 + lane;
      if (i < m) keys[i] = k[u];
    }
  }
}

// One shared-memory step of the network over p2 keys, C pairs a thread at
// once (a step's pairs are disjoint): pair p is (i, j), i < j, j = i's mirror
// in its block of 2 * stride keys when `flip`, else i + stride.
template <int C>
__device__ __forceinline__ void exchange_in_shared(unsigned long long* keys, int m, int p2,
                                                   int stride, bool flip, int tid) {
  for (int p0 = tid; p0 < (p2 >> 1); p0 += C * kThreads) {
    int i[C], j[C];
    unsigned long long ki[C], kj[C];
#pragma unroll
    for (int u = 0; u < C; ++u) {
      const int p = p0 + u * kThreads, off = p & (stride - 1);
      i[u] = ((p - off) << 1) + off;
      j[u] = p < (p2 >> 1) ? (flip ? i[u] + ((stride - off) << 1) - 1 : i[u] + stride) : m;
      if (j[u] < m) {
        ki[u] = keys[i[u]];
        kj[u] = keys[j[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < C; ++u)
      if (j[u] < m && kj[u] < ki[u]) {
        keys[i[u]] = kj[u];
        keys[j[u]] = ki[u];
      }
  }
}

// Ascending sort of m unique keys by the bitonic network whose comparators
// all put the smaller key first (padding to a power of two with +inf keys, a
// comparator reaching past the m stored keys is skipped). Steps between keys
// less than 32 apart run in registers, the rest in shared memory; past 2048
// keys a thread works on 4 chunks or pairs at once.
__device__ void sort_keys(unsigned long long* keys, int m, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  int p2 = 1;
  while (p2 < m) p2 <<= 1;
  const bool wide = p2 > 2048;
  if (wide) sort_in_warps<4>(keys, m, 32, lane, warp);
  else sort_in_warps<1>(keys, m, p2 < 32 ? p2 : 32, lane, warp);
  __syncthreads();
  for (int size = 64; size <= p2; size <<= 1) {
    for (int stride = size >> 1; stride >= 32; stride >>= 1) {
      const bool flip = stride == (size >> 1);   // the merge's first step mirrors the block
      if (wide) exchange_in_shared<4>(keys, m, p2, stride, flip, tid);
      else exchange_in_shared<1>(keys, m, p2, stride, flip, tid);
      __syncthreads();
    }
    if (wide) sort_in_warps<4>(keys, m, 0, lane, warp);
    else sort_in_warps<1>(keys, m, 0, lane, warp);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 2)
nms_kernel(const float* __restrict__ boxes, const void* __restrict__ scores,
           const long long* __restrict__ classes, const void* __restrict__ coeffs,
           float* __restrict__ out_boxes, void* __restrict__ out_scores,
           int* __restrict__ out_classes, void* __restrict__ out_coeffs,
           unsigned char* __restrict__ out_valid, int anchors, int nm, int max_candidates,
           int max_det, int bf16, float conf, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int m_s, total_s;
  __shared__ unsigned keep_s[32];
  __shared__ int prefix_s[32];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int image = blockIdx.x / kCluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int n_warps = kThreads / 32;

  const Layout l = layout(anchors, max_candidates, max_det);
  float4* box = reinterpret_cast<float4*>(smem + l.box);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem + l.shared_u);
  unsigned* mask = reinterpret_cast<unsigned*>(smem + l.shared_u);
  float* area = reinterpret_cast<float*>(smem + l.area);
  int* idx = reinterpret_cast<int*>(smem + l.idx);
  int* sel = reinterpret_cast<int*>(smem + l.sel);
  const long long first = static_cast<long long>(image) * anchors;   // the image's anchor 0
  // @profile declare

  // 1. Selection (leader): compact the valid anchors' keys, sort them, keep
  // the first n anchors. The other CTAs only count the valid anchors, to
  // know n as well.
  if (tid == 0) m_s = 0;
  __syncthreads();
  if (rank == 0) {
    constexpr int kLoads = 4;     // anchors a thread loads before it ballots
    for (int base = 0; base < anchors; base += kLoads * kThreads) {
      float v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int a = base + u * kThreads + tid;
        v[u] = a < anchors ? load_float(scores, first + a, bf16) : 0.0f;
      }
      unsigned ballot[kLoads];
      int count = 0;
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        ballot[u] = __ballot_sync(kFull, base + u * kThreads + tid < anchors && v[u] > conf);
        count += __popc(ballot[u]);
      }
      int at = 0;
      if (lane == 0 && count) at = atomicAdd(&m_s, count);
      at = __shfl_sync(kFull, at, 0);
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if ((ballot[u] >> lane) & 1u)
          keys[at + __popc(ballot[u] & ((1u << lane) - 1u))] =
              sort_key(v[u], base + u * kThreads + tid);
        at += __popc(ballot[u]);
      }
    }
    __syncthreads();
    // @profile stamp 0 compaction
    const int m = m_s, n = m < max_candidates ? m : max_candidates;
    if (m <= 32) {        // warp 0's registers hold them all
      if (warp == 0) {
        int p2 = 1;
        while (p2 < m) p2 <<= 1;
        const unsigned long long k = sort_in_registers(lane < m ? keys[lane] : ~0ull, p2, lane);
        if (lane < n) idx[lane] = static_cast<int>(k & 0xffffffffu);
      }
    } else {
      sort_keys(keys, m, tid);
      for (int i = tid; i < n; i += kThreads) idx[i] = static_cast<int>(keys[i] & 0xffffffffu);
    }
    // @profile stamp 1 sort
  } else {
    int count = 0;
#pragma unroll 4
    for (int a = tid; a < anchors; a += kThreads)
      count += load_float(scores, first + a, bf16) > conf;
    count = __reduce_add_sync(kFull, count);
    if (lane == 0 && count) atomicAdd(&m_s, count);
  }
  __syncthreads();
  const int n = m_s < max_candidates ? m_s : max_candidates, nw = row_words(n);
  // Up to kSolo candidates the leader computes the whole mask alone: the
  // others leave, and no CTA waits on another. Otherwise barrier A: the
  // leader's anchors are ready, and every CTA of the cluster runs.
  const bool solo = n <= kSolo;
  const int ctas = solo ? 1 : kCluster;
  if (solo && rank != 0) return;
  if (!solo) {
    cluster_arrive();
    if (rank != 0) cluster_wait();
  }
  // @profile stamp 2 cluster barrier

  // 2. The candidates with the class offset, from the leader's list.
  {
    const int* anchor = cluster.map_shared_rank(idx, 0);
    for (int i = tid; i < n; i += kThreads) {
      const long long at = first + anchor[i];
      float4 b = make_float4(boxes[4 * at], boxes[4 * at + 1], boxes[4 * at + 2],
                             boxes[4 * at + 3]);
      const float off = __fmul_rn(__int2float_rn(static_cast<int>(classes[at])), 7680.0f);
      b = make_float4(__fadd_rn(b.x, off), __fadd_rn(b.y, off), __fadd_rn(b.z, off),
                      __fadd_rn(b.w, off));
      box[i] = b;
      area[i] = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
    }
  }
  __syncthreads();
  // @profile stamp 3 candidates

  // 3. The bit mask: rows i = rank (mod 8), stored into the leader's mask. The
  // CTA's rows q = 0, 1, ... (i = rank + 8q; solo: i = q) go to its warps in
  // rounds of n_warps, in snake order: rows shorten as q grows, so a warp that
  // takes a round's longest row takes the next round's shortest.
  {
    const unsigned leader_mask = cluster_address(mask, 0);
    const int rows = n > rank ? (n - 1 - rank) / ctas + 1 : 0;
    for (int round = 0;; ++round) {
      const int q = round * n_warps + (round & 1 ? n_warps - 1 - warp : warp);
      if (q >= rows) break;
      const int i = rank + q * ctas;
      const float4 bi = box[i];
      const float ai = area[i];
      const unsigned row = leader_mask + 4 * (row_offset(i, nw) - (i >> 5));
      for (int w = i >> 5; w < nw; ++w) {
        const int j = (w << 5) + lane;
        const bool above = j > i && j < n && iou_above(bi, ai, box[j], area[j], thr);
        const unsigned bits = __ballot_sync(kFull, above);
        if (lane == 0) st_cluster(row + 4 * w, bits);
      }
    }
  }
  // Barrier B: the mask rows are in the leader's shared memory, and no CTA
  // reads the leader's any more.
  if (!solo) {
    if (rank == 0) cluster_wait();
    cluster_arrive();
    cluster_wait();
    if (rank != 0) return;
  }
  __syncthreads();
  // @profile stamp 4 bit mask

  // 4. The greedy scan: lane w holds word w of the suppressed set.
  if (warp == 0) {
    unsigned removed = 0;
    int total = 0;
    for (int b = 0; b < nw; ++b) {
      const unsigned before = __shfl_sync(kFull, removed, b);
      const int rows_b = n - (b << 5) < 32 ? n - (b << 5) : 32;
      const unsigned alive = ~before & (rows_b == 32 ? kFull : (1u << rows_b) - 1u);
      const unsigned* row0 = mask + row_offset(b << 5, nw);
      const int len = nw - b;       // words a row of this block
      // The block's kept set is the fixed point of keep = alive & ~(the union
      // of the kept rows' diagonal words): bit t depends only on the bits
      // below it, so round k settles bit k at the latest, and a round that
      // changes nothing has the greedy loop's answer. Lane t holds row
      // 32b + t's diagonal word; a round is one OR-reduction over the warp.
      const unsigned diagonal = lane < rows_b ? row0[lane * len] : 0u;
      unsigned live = alive;
      for (int round = 0; round <= 32; ++round) {   // 33 rounds at most, by the above
        const unsigned last = live;
        live = alive & ~__reduce_or_sync(kFull, (last >> lane) & 1u ? diagonal : 0u);
        if (live == last) break;
      }
      if (lane > b && lane < nw) {      // rows past n hold garbage, but their bits are 0
        unsigned acc = 0;
#pragma unroll
        for (int t = 0; t < 32; ++t)
          acc |= row0[t * len + lane - b] & static_cast<unsigned>(static_cast<int>(live << (31 - t)) >> 31);
        removed |= acc;
      }
      if (lane == 0) {
        keep_s[b] = live;
        prefix_s[b] = total;
      }
      total += __popc(live);
    }
    if (lane == 0) total_s = total;
  }
  __syncthreads();
  // @profile stamp 5 scan

  // 5. The gather: the r-th kept candidate's anchor into sel[r], then the outputs.
  for (int i = tid; i < n; i += kThreads) {
    const unsigned word = keep_s[i >> 5], bit = 1u << (i & 31);
    if (word & bit) {
      const int r = prefix_s[i >> 5] + __popc(word & (bit - 1u));
      if (r < max_det) sel[r] = idx[i];
    }
  }
  __syncthreads();
  // @profile stamp 6 ranks
  // The rows move in the widest unit (16, 8, 4 or 2 bytes) that divides the
  // box and coefficient rows and aligns the four arrays.
  const int kept = total_s < max_det ? total_s : max_det;
  const long long out0 = static_cast<long long>(image) * max_det;
  const int box_bytes = 16, coeff_bytes = nm * (bf16 ? 2 : 4);
  const unsigned long long fit =
      reinterpret_cast<unsigned long long>(boxes) | reinterpret_cast<unsigned long long>(coeffs) |
      reinterpret_cast<unsigned long long>(out_boxes) |
      reinterpret_cast<unsigned long long>(out_coeffs) | box_bytes | coeff_bytes;
  const int unit = fit % 16 == 0 ? 16 : fit % 8 == 0 ? 8 : fit % 4 == 0 ? 4 : 2;
#define NMS_GATHER(U)                                                                      \
  gather_slots<U>(boxes, scores, classes, coeffs, out_boxes, out_scores, out_classes,      \
                  out_coeffs, out_valid, first, out0, sel, kept, max_det, box_bytes / unit, \
                  coeff_bytes / unit, bf16, tid)
  if (unit == 16) NMS_GATHER(uint4);
  else if (unit == 8) NMS_GATHER(uint2);
  else if (unit == 4) NMS_GATHER(unsigned);
  else NMS_GATHER(unsigned short);
#undef NMS_GATHER
  // @profile report
}

}  // namespace

// Inputs of S images: boxes (S, A, 4) float32 xyxy, scores (S, A) best-class
// scores, classes (S, A) int64, coeffs (S, A, nm); scores and coeffs float32,
// or bf16 when `bf16` is set. Outputs, written whole: out_boxes (S, D, 4)
// float32, out_scores (S, D) and out_coeffs (S, D, nm) in the scores' dtype,
// out_classes (S, D) int32, out_valid (S, D) bool, D = max_det (at most
// max_candidates). conf_threshold must already be rounded to the scores' dtype.
// All on card `device`; launches on `stream` and does not synchronise.
// Returns 0 on success, a cudaError_t, -1 when no cluster of this kernel with
// this shared memory fits on the card, -2 when the shared memory a CTA needs
// exceeds a block's. The card is set here when it is not the current one (this
// library carries its own CUDA runtime); the kernel's shared-memory limit is
// raised, and the clusters' occupancy checked, only when a launch needs more
// shared memory than any before it.
extern "C" int nms_launch(const float* boxes, const void* scores, const long long* classes,
                          const void* coeffs, float* out_boxes, void* out_scores,
                          int* out_classes, void* out_coeffs, unsigned char* out_valid,
                          int batch, int anchors, int nm, int max_candidates, int max_det,
                          int bf16, float conf_threshold, float iou_threshold, int device,
                          void* stream) {
  constexpr int kMaxDevices = 64;
  static long long configured[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (batch < 1 || anchors < 1 || nm < 1 || max_candidates < 1 || max_candidates > kMaxK ||
      max_det < 1 || max_det > max_candidates)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long smem = layout(anchors, max_candidates, max_det).total;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch) * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  if (smem > configured[device]) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, nms_kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (smem + static_cast<long long>(fa.sharedSizeBytes) > optin) return -2;
    err = cudaFuncSetAttribute(nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, nms_kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters < 1) return -1;
    configured[device] = smem;
  }
  err = cudaLaunchKernelEx(&cfg, nms_kernel, boxes, scores, classes, coeffs, out_boxes,
                           out_scores, out_classes, out_coeffs, out_valid, anchors, nm,
                           max_candidates, max_det, bf16, conf_threshold, iou_threshold);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
