// Fast-sweeping wavefront relaxation: the min-plus fixed point over
// (incoming direction x cell) states by passes of four directional scans,
// all passes of B streams in one launch, a thread-block cluster of k CTAs a
// stream.
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
//       log-step doubling: at level k with shift s = 2**k, for every
//       position i >= s, a[i] <- min(a[i], fl(a[i-s] + b_k[i])), from the
//       values before the level, for s = 1, 2, 4, ... while s < n; b_0 =
//       enter and b_k[i] = fl(b_{k-1}[i] + b_{k-1}[i-s/2]) where i has that
//       partner, else b_{k-1}[i] (the twin's _scan_levels and
//       _min_plus_scan).
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
// partner at each shift. Of the first design's argument this all still
// holds; what changed is who makes the b levels and when. They depend on
// the entry costs alone, so the warp that owns a line makes them once, before
// the first pass, by the same additions the twin's _scan_levels makes, and
// every scan reads them. Only the levels at positions with a partner are
// read, and there b_k[i] is the sum of the 2**k entry costs ending at i in
// scan order, associated as a balanced tree. A reverse scan's b_k at cell i
// is the tree over cells i .. i + 2**k - 1 and a forward scan's b_k at cell
// i + 2**k - 1 is the tree over the same cells with the operands of each
// addition swapped, which rounds alike: so both directions of a line read
// one set of levels kept in shared memory, the reverse scan at cell
// i + 2**k - 1. Lines of at most 32 cells keep their levels in registers
// instead, each direction its own (5 levels a direction, 20 registers at
// 32x32), unless the crossing lines are longer than 96 cells and need the
// registers. The skip of clean lines below is the first design's,
// unchanged, so the line-scan counts are too.
//
// What bounds it on an H100: neither bytes nor operations. A stream moves
// (R*C + 4*R*C) * 4 bytes in and out of device memory once; a pass is
// 4 * (9 + 2*log2(n)) float operations a cell at most (h, the shift, the
// levels of a line of n cells). The time goes into a chain of dependent steps:
// per pass four scans, each ~log2(n) levels of warp shuffles, barriers
// between them. The first design ran a stream on one SM, whose warp
// schedulers were the limit (4 scans a pass, each up to 3 lines a warp at
// 54x96, two shuffles a slot a level).
//
// What this design does about that:
//  - A warp owns at most one row and one column for the whole launch, so a
//    scan is one line a warp and a level is one shuffle (none for s >= 32),
//    one addition and one min a slot, in place from the last slot down; the
//    b levels come from registers or shared memory. The shift is taken slot
//    by slot as h is made, so h is never held for the whole line.
//  - A line's scan reads and writes only its own cells, and the other
//    orientation's values there change only in the other half of the pass,
//    so a warp runs both directions of its line back to back: two barriers
//    a pass, not four.
//  - A stream runs on a cluster of k CTAs (cluster_size in ops/cuda_sweep.py
//    picks k from the lattice; k * 32 warps >= the longer side). Each CTA
//    holds a full replica of the field, 16*R*(C|1) bytes, and the levels of
//    its own lines, whose level 0 is the entry costs (so the entry costs
//    need no replica of their own). After a scan a CTA writes every
//    value that changed into its own replica and each peer's (distributed
//    shared memory) and sets the need flags of the crossing lines in the
//    CTA that owns them; one cluster barrier (release on arrive, acquire on
//    wait) before the other orientation's half reads. The vote goes through
//    the leader's shared memory behind the same barrier.
//  - Each orientation has its own slot count (template on the slots of a row
//    and of a column), so no loop runs a predicate for a slot a line lacks.
//
// Lines whose scan cannot change anything are skipped. A scan of line L in
// direction d is a function of the four directions' values at L's cells and
// of the entry costs, so if none of those values changed since the last scan
// of (L, d) (whose own writes count as changes), the scan would write what is
// already there. need[d][L] is set when a cell of L changes (by the scan of
// L's own orientation, or by a crossing line's scan) and cleared when (L, d)
// runs; every flag starts set. Skipping a scan that would change nothing
// leaves the field, the vote and so the pass count as they are: the skip is
// exact. The launch also writes, per stream, how many line scans ran (of
// rows, of columns): the operations this run's data needed.
//
// Two forms. The shared form is the design above: a replica of the field in
// every CTA's shared memory, which bounds the lattice (at grid 20, 1440p's
// 72x128 at k = 7 or 8; 4K UHD's 108x192 needs 331,776 B a CTA for the
// replica alone, past a block's 232,448). The global form keeps ONE copy of
// the field a stream in device memory (`field`, 16*R*(C|1) B a stream:
// 333 KB at 108x192, L2-resident), shared by the cluster's CTAs: a scan
// writes a changed value once, there, instead of into k replicas. The kept
// levels of each CTA's own lines follow the fields in the same allocation
// (`levels`, 207 KB a CTA at 108x192); the need flags, the vote and the
// barriers stay in shared memory. Field reads and writes go through L2
// (ld.global.cg / st.global.cg), so no SM reads a line of the field from
// its L1 that another SM's CTA has since written; the cluster barrier
// (release on arrive, acquire on wait) orders a half pass's writes before
// the next half's reads, as it orders the distributed shared memory of the
// shared form. A half pass reads and writes what it read and wrote in the
// shared form, in the same order, so the field, the passes and the line
// scans are the same. It is one instance, 8 slots a line, whatever the
// lattice; its k is the fewest CTAs that give each warp at most one line a
// side (6 at 108x192), so it takes any lattice of lines of at most 256
// cells. The field and the levels are addressed as the stream's base and a
// 32-bit offset a lane, and the scan is a call, which keeps it within 64
// registers. What bounds it: a scan's loads of the field and the levels
// are L2 round trips, taken a slot at a time; ~2 ms at 108x192 B=1
// (PERF.md section 6).
//
// The "@profile" comments mark the kernel's sections; utils/profile_sweep.py
// turns them into clock stamps in a copy of this file.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <array>
#include <utility>
// @profile include

namespace cg = cooperative_groups;

namespace {

constexpr float kInf = 3.0e38f;  // the reference's finite "infinity"
constexpr int kWarp = 32;
constexpr int kMaxWarps = 32;    // warps a CTA
constexpr int kMaxSlots = 8;     // lines of up to 256 cells
constexpr int kMaxLine = kMaxSlots * kWarp;
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kSmemPerBlock = 232448;  // the H100's opt-in shared memory a block
constexpr unsigned kFull = 0xffffffffu;

// log2 of the least power of two >= x: the doubling levels of a line of x
// cells (shifts 1, 2, 4, ... below x).
__host__ __device__ constexpr int ceil_log2(int x) { return x <= 1 ? 0 : 1 + ceil_log2((x + 1) / 2); }

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Levels a line of a J-slot class can have.
template <int J>
constexpr int kLevels = ceil_log2(kWarp * J);

// Levels of a line of at most 32 cells, kept in registers.
constexpr int kRegLevels = kLevels<1>;

// Whether the lines of n cells keep their levels in registers, the crossing
// lines being of `other` cells: a line of one slot does, unless the
// crossing lines are longer than 3 slots, whose scans need those registers.
__host__ __device__ constexpr bool in_registers(int n, int other) {
  return n <= kWarp && other <= 3 * kWarp;
}

// One CTA's dynamic shared memory, in floats: the replica of the field,
// dist[4][R][C|1], then the b levels 0.. of its own rows, then of its own
// columns (none where they are in registers). A line of n cells keeps
// ceil_log2(n) levels of n floats; the entry costs are level 0, so the
// replica holds no copy of them. The global form (`global`) has no replica
// and keeps every line's levels, in device memory.
struct Layout {
  int per[2];        // lines a CTA owns: rows, columns
  long long lev[2];  // floats of kept levels: rows, columns
  long long floats;
};

__host__ __device__ constexpr Layout layout(int rows, int cols, int k, bool global = false) {
  Layout l{};
  l.per[0] = ceil_div(rows, k);
  l.per[1] = ceil_div(cols, k);
  const bool reg_rows = !global && in_registers(cols, rows);
  const bool reg_cols = !global && in_registers(rows, cols);
  l.lev[0] = reg_rows ? 0 : 1LL * l.per[0] * ceil_log2(cols) * cols;
  l.lev[1] = reg_cols ? 0 : 1LL * l.per[1] * ceil_log2(rows) * rows;
  l.floats = (global ? 0 : 4LL * rows * (cols | 1)) + l.lev[0] + l.lev[1];
  return l;
}

// The statically allocated shared memory of the kernel (T, need, the vote,
// the counts), rounded up.
constexpr int kStaticShared = 512;

// Whether any lattice of the (JR, JC) slot class fits: its smallest lattice
// with some cluster size that gives each warp at most one line a side.
constexpr bool taken(int jr, int jc) {
  const int cols = kWarp * (jr - 1) + 1, rows = kWarp * (jc - 1) + 1;
  const int longest = rows > cols ? rows : cols;
  for (int k = ceil_div(longest, kMaxWarps); k <= kMaxCluster; ++k)
    if (layout(rows, cols, k).floats * 4 + kStaticShared <= kSmemPerBlock) return true;
  return false;
}

// barrier.cluster in two halves, release on arrive and acquire on wait (they
// order the distributed shared memory between them); a CTA barrier when the
// cluster is one CTA.
__device__ __forceinline__ void sync_cluster(int k) {
  if (k == 1) {
    __syncthreads();
  } else {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
}

// The shared::cluster address in CTA `rank` of what `address` (a
// shared::cta address) is in this CTA.
__device__ __forceinline__ unsigned mapa(unsigned address, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(address), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_cluster(unsigned address, float value) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(address), "f"(value) : "memory");
}

__device__ __forceinline__ void st_cluster_u16(unsigned address, unsigned short value) {
  asm volatile("st.shared::cluster.u16 [%0], %1;\n" ::"r"(address), "h"(value) : "memory");
}

__device__ __forceinline__ void st_shared_u16(unsigned address, unsigned short value) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(address), "h"(value) : "memory");
}

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float ld_shared(unsigned address) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(address));
  return v;
}

__device__ __forceinline__ void st_cluster_u32(unsigned address, int value) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(address), "r"(value) : "memory");
}

__device__ __forceinline__ int ld_cluster_u32(unsigned address) {
  int v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(address) : "memory");
  return v;
}

// An int the compiler cannot see through: address arithmetic recomputed
// from it is not kept alive across a scan.
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// One doubling level in place over a line held as x[j] at position
// p = lane + 32*j: x[p] <- op(x[p], x[p - s]) wherever p has a partner and
// p < n, every partner taken before the level. For s < 32 the partner of
// slot j is lane (lane - s) mod 32 of slot j (lane >= s) or of slot j - 1
// (lane < s); the slots run from the last down, so one shuffle a slot
// serves both and slot j - 1 is shuffled before it changes (short_level,
// s < 32). For s >= 32 the partner is slot j - s/32 of the same lane, not
// yet changed, so s must be a constant there. op(j, x, partner) gives the
// new value. Lines of 4 slots or more take their slots one at a time (no
// loads hoisted above the slot before), which keeps them within 64
// registers.
template <int J, typename Op>
__device__ __forceinline__ void short_level(float (&x)[J], int s, int n, int lane, Op op) {
  float hi = __shfl_sync(kFull, x[J - 1], (lane - s) & (kWarp - 1));
#pragma unroll
  for (int j = J - 1; j >= 0; --j) {
    const float lo = j > 0 ? __shfl_sync(kFull, x[j - 1], (lane - s) & (kWarp - 1)) : 0.0f;
    if ((j > 0 || lane >= s) && lane + kWarp * j < n) x[j] = op(j, x[j], lane >= s ? hi : lo);
    hi = lo;
    if constexpr (J >= 4) asm volatile("" ::: "memory");
  }
}

template <int J, typename Op>
__device__ __forceinline__ void level_in_place(float (&x)[J], int s, int n, int lane, Op op) {
  if (s < kWarp) {
    short_level<J>(x, s, n, lane, op);
  } else {
#pragma unroll
    for (int j = J - 1; j >= s / kWarp; --j) {
      if (lane + kWarp * j < n) x[j] = op(j, x[j], x[j - s / kWarp]);
      if constexpr (J >= 4) asm volatile("" ::: "memory");
    }
  }
}

// The levels b_0, b_1, ... of a line of n > 32 cells, cell p at index
// base + p*step of the stream's entry costs in device memory, made in
// forward order (the twin's _scan_levels: b_k[p] = b_{k-1}[p] + b_{k-1}[p-s],
// s = 2**(k-1)) and kept at lev[k*n + p]. With kOpaque (the global form's
// levels in device memory) each store's offset is made anew, so no 64-bit
// address is kept from one level to the next.
template <int J, bool kOpaque = false>
__device__ __forceinline__ void keep_levels(const float* enter, int base, int step, int n,
                                            int lane, float* lev) {
  if (n <= 1) return;  // no level is read, and none is laid out
  const auto at = [](int i) { return kOpaque ? opaque(i) : i; };
  float b[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int p = lane + kWarp * j;
    b[j] = p < n ? enter[opaque(base) + p * step] : 0.0f;
    if constexpr (J >= 4) asm volatile("" ::: "memory");
  }
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (lane + kWarp * j < n) lev[at(lane + kWarp * j)] = b[j];
#pragma unroll
  for (int k = 1; k < kLevels<J>; ++k) {
    if ((1 << k) >= n) break;
    level_in_place<J>(b, 1 << (k - 1), n, lane,
                      [](int, float x, float partner) { return __fadd_rn(x, partner); });
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (lane + kWarp * j < n) lev[at(k * n + lane + kWarp * j)] = b[j];
  }
}

// The levels b_0, b_1, ... of a line of n <= 32 cells in one direction,
// position p = lane at cell (rev ? n - 1 - p : p), into registers; `e` is
// this lane's entry cost in forward order (cell lane).
__device__ __forceinline__ void register_levels(float e, int n, bool rev, int lane,
                                                float (&lv)[kRegLevels]) {
  float b[1] = {rev ? __shfl_sync(kFull, e, (n - 1 - lane) & (kWarp - 1)) : e};
  if (lane >= n) b[0] = 0.0f;
  lv[0] = b[0];
#pragma unroll
  for (int k = 1; k < kRegLevels; ++k) {
    lv[k] = b[0];
    if ((1 << k) >= n) break;
    level_in_place<1>(b, 1 << (k - 1), n, lane,
                      [](int, float x, float partner) { return __fadd_rn(x, partner); });
    lv[k] = b[0];
  }
}

// What a scan needs to publish a changed value: the shared::cta address of
// this CTA's dist, the cluster, and the need flags of the crossing lines.
struct Publish {
  unsigned dist;        // shared::cta address of dist[0][0][0]
  unsigned need;        // shared::cta address of need[crossing orientation][0]
  int rank, k;
  int per_cross;        // crossing lines a CTA owns
  float inv_per_cross;  // 1 / per_cross: (at + 0.5) * it floors to at / per_cross
};

// One line of the scan of direction d: n positions, position p at index
// base + p*step (forward) or base + (n-1-p)*step (reverse) of dist. Writes
// what changed into every replica of the cluster (the global form: into the
// one field in device memory) and flags the crossing lines through those
// cells. Returns whether this lane changed a value. The kept levels are at
// the shared::cta address `lev`, or in the global form at dist[lev], in the
// same allocation as the field. The global form addresses the field and the
// levels as the stream's base and a 32-bit offset a lane, which keeps it
// within 64 registers.
template <int J, bool kReg, bool kGlobal>
__device__ __forceinline__ bool scan_line(float* dist, const float* T, int np, int d,
                                          int base, int step, int n, unsigned lev,
                                          const float (&reg)[kRegLevels], const Publish& pub,
                                          int lane) {
  const bool rev = d & 1;
  // Slot j of this lane is cell c0 + j*dc of the line; its direction-0 value
  // is at cell0[j*jump], the others np floats apart.
  const int c0 = rev ? n - 1 - lane : lane, dc = rev ? -kWarp : kWarp;
  const int jump = dc * step;
  const float* cell0 = dist + opaque(base) + c0 * step;
  // b_k at slot j (k = 0: the entry costs), from registers or the kept levels;
  // only read where slot j's position has a partner at shift 2**k and is < n.
  const unsigned lv = lev + 4 * (rev ? n - 2 - lane : lane);
  const auto level = [&](int k, int j) -> float {
    const int at = rev ? k * n - kWarp * j + (1 << k) : k * n + kWarp * j;
    if constexpr (kReg) return reg[k];
    else if constexpr (kGlobal)  // the offset made anew at each read
      return dist[opaque(static_cast<int>(lev) + (rev ? n - 2 - lane : lane) + at)];
    else return ld_shared(lv + 4 * at);
  };
  const float t0 = T[0 * 4 + d], t1 = T[1 * 4 + d], t2 = T[2 * 4 + d], t3 = T[3 * 4 + d];
  // (a) h at each cell and (b) the one-step shift, a[p] = min(old[p],
  // h[p-1] + enter[p]) for p >= 1, a slot at a time: h[p-1] is lane - 1's
  // h of the same slot, or for lane 0 lane 31's of the slot before.
  float a[J];
  float carry = 0.0f;
  const float* c = cell0;
  int co = opaque(base) + c0 * step;  // the global form: slot j's offset in dist
#pragma unroll
  for (int j = 0; j < J; ++j, c += jump, co += jump) {
    const int p = lane + kWarp * j;
    float h = kInf;
    a[j] = kInf;
    if (p < n) {
      float x0, x1, x2, x3;
      if constexpr (kGlobal) {
        const float* at = dist + opaque(co);
        x0 = __ldcg(at);
        x1 = __ldcg(at + np);
        x2 = __ldcg(at + 2 * np);
        x3 = __ldcg(at + 3 * np);
      } else {
        x0 = c[0];
        x1 = c[np];
        x2 = c[2 * np];
        x3 = c[3 * np];
      }
      h = fminf(fminf(__fadd_rn(x0, t0), __fadd_rn(x1, t1)),
                fminf(__fadd_rn(x2, t2), __fadd_rn(x3, t3)));
      a[j] = d == 0 ? x0 : d == 1 ? x1 : d == 2 ? x2 : x3;
    }
    const float sh = __shfl_sync(kFull, h, (lane - 1) & (kWarp - 1));
    if ((j > 0 || lane >= 1) && p < n)
      a[j] = fminf(a[j], __fadd_rn(lane >= 1 ? sh : carry, level(0, j)));
    carry = sh;
    if constexpr (J >= 4) asm volatile("" ::: "memory");
  }
  // @profile stamp 0 loads, h and the shift
  // (c) the doubling scan, shifts 1, 2, 4, ... below n, b_k read as made.
  // Lines of 4 slots or more run the shifts below 32 as a loop, not
  // unrolled, which keeps 64 registers enough.
  const auto scan_level = [&](int j, int k, float x, float partner) {
    return fminf(x, __fadd_rn(partner, level(k, j)));
  };
  constexpr int kRolled = J >= 4 ? 5 : 0;
  if constexpr (kRolled > 0) {
#pragma unroll 1
    for (int k = 0; k < kRolled; ++k) {
      if ((1 << k) >= n) break;
      short_level<J>(a, 1 << k, n, lane,
                     [&](int j, float x, float partner) { return scan_level(j, k, x, partner); });
    }
  }
#pragma unroll
  for (int k = kRolled; k < kLevels<J>; ++k) {
    if ((1 << k) >= n) break;
    level_in_place<J>(a, 1 << k, n, lane,
                      [&](int j, float x, float partner) { return scan_level(j, k, x, partner); });
  }
  // @profile stamp 1 levels
  bool moved = false;
  int q = d * np + opaque(base) + c0 * step;     // slot j's value: dist[q], q += jump
#pragma unroll
  for (int j = 0; j < J; ++j, q += jump) {
    const int p = lane + kWarp * j;
    if (p >= n) continue;
    const int at = c0 + j * dc;                  // the crossing line through this cell
    if constexpr (kGlobal) {
      if (__float_as_int(a[j]) == __float_as_int(__ldcg(dist + q))) continue;
      __stcg(dist + q, a[j]);
    } else {
      if (__float_as_int(a[j]) == __float_as_int(dist[q])) continue;  // a <= old, no NaN
      dist[q] = a[j];
    }
    const int owner = static_cast<int>(__fmul_rz(static_cast<float>(opaque(at)) + 0.5f,
                                                 pub.inv_per_cross));
    const unsigned flag = pub.need + 4 * (at - owner * pub.per_cross);
    if (owner == pub.rank) st_shared_u16(flag, 0x0101);
    else st_cluster_u16(mapa(flag, owner), 0x0101);
    if constexpr (!kGlobal)
      for (int r = 0; r < pub.k; ++r)
        if (r != pub.rank) st_cluster(mapa(pub.dist + 4 * q, r), a[j]);
    moved = true;
    if constexpr (J >= 4) asm volatile("" ::: "memory");
  }
  // @profile stamp 2 store and need flags
  return moved;
}

// scan_line as a call: the global form takes it so, since inlined it needs
// more than its 64 registers a thread once the field's addresses are 64 bits
// and spills inside the scan; as a call, what spills is what the caller
// saves across the call (phase build of chip_smoke.py prints it).
template <int J, bool kReg, bool kGlobal>
__device__ __noinline__ bool scan_line_call(float* dist, const float* T, int np, int d,
                                            int base, int step, int n, unsigned lev,
                                            const float (&reg)[kRegLevels], const Publish& pub,
                                            int lane) {
  return scan_line<J, kReg, kGlobal>(dist, T, np, d, base, step, n, lev, reg, pub, lane);
}

template <int J, bool kReg, bool kGlobal>
__device__ __forceinline__ bool scan(float* dist, const float* T, int np, int d, int base,
                                     int step, int n, unsigned lev,
                                     const float (&reg)[kRegLevels], const Publish& pub,
                                     int lane) {
  if constexpr (kGlobal)
    return scan_line_call<J, kReg, kGlobal>(dist, T, np, d, base, step, n, lev, reg, pub, lane);
  else
    return scan_line<J, kReg, kGlobal>(dist, T, np, d, base, step, n, lev, reg, pub, lane);
}

// kGlobal: the field in `field` (4 * R * (C|1) floats a stream) and the kept
// levels in `levels` (lev[0] + lev[1] floats a CTA), which follows the
// fields in the same allocation.
template <int JR, int JC, bool kGlobal>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
relax_sweep_kernel(const float* __restrict__ enter, const int* __restrict__ start,
                   const float* __restrict__ turn, float* __restrict__ out,
                   int* __restrict__ passes_out, int* __restrict__ scans_out,
                   float* __restrict__ field, float* __restrict__ levels, int rows,
                   int cols, int max_passes, int k) {
  extern __shared__ float smem[];
  __shared__ float T[16];
  // need[o][slot][dir]: scan the line of orientation o (rows, columns) that
  // warp `slot` owns in direction dir (forward, reverse) this pass. Written
  // by any CTA of the cluster, read by the owner.
  __shared__ __align__(4) unsigned char need[2][kMaxWarps][4];
  __shared__ int vote;                   // leader: the last pass that changed a value
  __shared__ int ran[kMaxCluster][2];    // leader: each CTA's line scans (rows, columns)
  __shared__ int cta_ran[2];
  // @profile declare
  const Layout lay = layout(rows, cols, k, kGlobal);
  const int stride = cols | 1, np = rows * stride;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid % kWarp, warp = tid / kWarp;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int stream = blockIdx.x / k;
  float* dist = smem;                    // [4][rows][stride]
  float* lev_rows = smem + 4 * np;       // [rows a CTA][levels][cols]
  if constexpr (kGlobal) {
    dist = field + static_cast<size_t>(stream) * 4 * np;
    lev_rows = levels + static_cast<size_t>(blockIdx.x) * (lay.lev[0] + lay.lev[1]);
  }
  float* lev_cols = lev_rows + lay.lev[0];
  const int n = rows * cols;
  const float* enter_b = enter + static_cast<size_t>(stream) * n;

  // This warp's lines for the whole launch; the entry costs of a line of at
  // most 32 cells are loaded first, so their latency overlaps the fill.
  const int row = rank * lay.per[0] + warp, col = rank * lay.per[1] + warp;
  const bool has_row = warp < lay.per[0] && row < rows;
  const bool has_col = warp < lay.per[1] && col < cols;
  constexpr bool kRegRows = !kGlobal && JR == 1 && JC <= 3;  // in_registers
  constexpr bool kRegCols = !kGlobal && JC == 1 && JR <= 3;
  const float e_row = kRegRows && has_row && lane < cols ? enter_b[row * cols + lane] : 0.0f;
  const float e_col = kRegCols && has_col && lane < rows ? enter_b[lane * cols + col] : 0.0f;
  const float t = tid < 16 ? turn[tid] : 0.0f;
  const int sr = start[2 * stream], sc = start[2 * stream + 1];
  if constexpr (kGlobal) {  // the cluster's CTAs fill the stream's field in turn
    const int at = sr >= 0 && sr < rows && sc >= 0 && sc < cols ? sr * stride + sc : -1;
    for (int p = rank * nthreads + tid; p < 4 * np; p += k * nthreads)
      __stcg(dist + p, p % np == at ? 0.0f : kInf);
  } else {
    for (int p = tid; p < 4 * np; p += nthreads) dist[p] = kInf;
  }
  for (int p = tid; p < 2 * kMaxWarps * 4; p += nthreads) (&need[0][0][0])[p] = 1;
  if (tid < 16) T[tid] = t;
  if (tid < 2 * kMaxCluster) (&ran[0][0])[tid] = 0;
  if (tid < 2) cta_ran[tid] = 0;
  if (tid == 0) vote = 0;
  __syncthreads();
  if (!kGlobal && tid < 4 && sr >= 0 && sr < rows && sc >= 0 && sc < cols)
    dist[tid * np + sr * stride + sc] = 0.0f;

  // The levels of this warp's lines, made once.
  float* my_lev_row = lev_rows + (kRegRows ? 0 : warp * ceil_log2(cols) * cols);
  float* my_lev_col = lev_cols + (kRegCols ? 0 : warp * ceil_log2(rows) * rows);
  float reg_row[2][kRegLevels], reg_col[2][kRegLevels];
  if (has_row) {
    if constexpr (kRegRows) {
      register_levels(e_row, cols, false, lane, reg_row[0]);
      register_levels(e_row, cols, true, lane, reg_row[1]);
    } else {
      keep_levels<JR, kGlobal>(enter_b, row * cols, 1, cols, lane, my_lev_row);
    }
  }
  if (has_col) {
    if constexpr (kRegCols) {
      register_levels(e_col, rows, false, lane, reg_col[0]);
      register_levels(e_col, rows, true, lane, reg_col[1]);
    } else {
      keep_levels<JC, kGlobal>(enter_b, col, cols, rows, lane, my_lev_col);
    }
  }
  // Every replica, flag and level ready, and every CTA of the cluster
  // running before any distributed shared memory is touched.
  if (k == 1) __syncthreads();
  else cluster.sync();
  // @profile stamp 4 setup

  const Publish to_cols{shared_address(dist), shared_address(&need[1][0][0]), rank, k,
                        lay.per[1], 1.0f / lay.per[1]};
  const Publish to_rows{shared_address(dist), shared_address(&need[0][0][0]), rank, k,
                        lay.per[0], 1.0f / lay.per[0]};
  const unsigned vote_leader = mapa(shared_address(&vote), 0);
  // The kept levels' addresses: shared::cta, or in device memory the offset
  // from the stream's field (the levels follow the fields in one allocation).
  const unsigned lev_row = kGlobal ? static_cast<unsigned>(my_lev_row - dist)
                                   : shared_address(my_lev_row);
  const unsigned lev_col = kGlobal ? static_cast<unsigned>(my_lev_col - dist)
                                   : shared_address(my_lev_col);
  int pass = 0;
  int ran_rows = 0, ran_cols = 0;  // this warp's line scans
  while (pass < max_passes) {
    ++pass;
    // Rows (right, then left), a barrier, columns (down, then up), a
    // barrier. A line's scans read and write only its own cells and the
    // other orientation's values there, which change only in the other
    // half, so a warp runs its line's two directions back to back and the
    // twin's barrier between them is not needed. Unrolled: the orientation
    // and the direction are constants.
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      if (o == 0 ? has_row : has_col) {
#pragma unroll
        for (int dir = 0; dir < 2; ++dir) {
          if (!need[o][warp][dir]) continue;
          bool moved;
          if (o == 0) {
            ++ran_rows;  // every lane counts; lane 0's count is kept
            moved = scan<JR, kRegRows, kGlobal>(dist, T, np, dir, row * stride, 1, cols, lev_row,
                                          reg_row[dir], to_cols, lane);
          } else {
            ++ran_cols;
            moved = scan<JC, kRegCols, kGlobal>(dist, T, np, 2 + dir, col, stride, rows, lev_col,
                                          reg_col[dir], to_rows, lane);
          }
          // Only this warp writes its own flags during its orientation's half,
          // and every lane read them before the scan's shuffles.
          const bool any = __any_sync(kFull, moved);
          if (lane == 0) {
            need[o][warp][dir] = any;
            if (any) {
              need[o][warp][dir ^ 1] = 1;
              st_cluster_u32(vote_leader, pass);
            }
          }
          __syncwarp();  // this scan's values and flags before the other direction reads
        }
      }
      sync_cluster(k);
      // @profile stamp 3 barrier wait
    }
    if (ld_cluster_u32(vote_leader) < pass) break;
  }
  // @profile report(stream, rank, k, pass)

  if (lane == 0) {
    atomicAdd(&cta_ran[0], ran_rows);
    atomicAdd(&cta_ran[1], ran_cols);
  }
  __syncthreads();
  if (tid < 2) *cluster.map_shared_rank(&ran[rank][tid], 0) = cta_ran[tid];
  sync_cluster(k);

  // Every replica is whole (the field after the last barrier): each CTA
  // writes its own rows.
  const int r0 = rank * lay.per[0], r1 = min(rows, r0 + lay.per[0]);
  float4* out_b = reinterpret_cast<float4*>(out + static_cast<size_t>(stream) * n * 4);
  for (int i = r0 * cols + tid; i < r1 * cols; i += nthreads) {
    const int r = i / cols;
    const int p = r * stride + (i - r * cols);
    if constexpr (kGlobal)
      out_b[i] = make_float4(__ldcg(dist + p), __ldcg(dist + np + p), __ldcg(dist + 2 * np + p),
                             __ldcg(dist + 3 * np + p));
    else
      out_b[i] = make_float4(dist[p], dist[np + p], dist[2 * np + p], dist[3 * np + p]);
  }
  if (rank == 0 && tid == 0) {
    int rs = 0, cs = 0;
    for (int r = 0; r < k; ++r) {
      rs += ran[r][0];
      cs += ran[r][1];
    }
    passes_out[stream] = pass;
    scans_out[2 * stream] = rs;
    scans_out[2 * stream + 1] = cs;
  }
}

struct Args {
  const float* enter;
  const int* start;
  const float* turn;
  float* out;
  int* passes;
  int* scans;
  float* field;   // the global form's fields, else null
  float* levels;  // the global form's kept levels, after the fields, else null
  int batch, rows, cols, max_passes, k, device;
  long long smem;
  cudaStream_t stream;
};

// Launches instance (JR, JC, kGlobal): returns 0, a cudaError_t, or -3 when no
// cluster of k CTAs with this shared memory can be placed on the card. The
// shared-memory limit is raised, and the placement checked, once for each
// (card, k, threads, shared memory) an instance meets; a few are kept.
template <int JR, int JC, bool kGlobal>
int launch(const Args& a) {
  const auto kernel = relax_sweep_kernel<JR, JC, kGlobal>;
  const Layout lay = layout(a.rows, a.cols, a.k);
  const int warps = lay.per[0] > lay.per[1] ? lay.per[0] : lay.per[1];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.batch) * a.k);
  cfg.blockDim = dim3(warps * kWarp);
  cfg.dynamicSmemBytes = static_cast<size_t>(a.smem);
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  constexpr int kKept = 16;
  static long long checked[kKept] = {};  // device << 40 | k << 32 | warps << 24 | smem
  static long long raised[64] = {};      // the limit set on each card
  const long long key = (static_cast<long long>(a.device) << 40) |
                        (static_cast<long long>(a.k) << 32) |
                        (static_cast<long long>(warps) << 24) | a.smem;
  for (int i = 0; i < kKept; ++i)
    if (checked[i] == key + 1) {
      cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a.enter, a.start, a.turn, a.out,
                                           a.passes, a.scans, a.field, a.levels, a.rows,
                                           a.cols, a.max_passes, a.k);
      return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
    }
  cudaError_t err = cudaSuccess;
  if (a.smem > raised[a.device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(a.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised[a.device] = a.smem;
  }
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return -3;
  for (int i = 0; i < kKept; ++i)
    if (checked[i] == 0) {
      checked[i] = key + 1;
      break;
    }
  err = cudaLaunchKernelEx(&cfg, kernel, a.enter, a.start, a.turn, a.out, a.passes, a.scans,
                           a.field, a.levels, a.rows, a.cols, a.max_passes, a.k);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <int JR, int JC>
int launch_if_taken(const Args& a) {
  if constexpr (taken(JR, JC)) return launch<JR, JC, false>(a);
  else return -2;
}

using Launcher = int (*)(const Args&);

template <int... I>
constexpr std::array<Launcher, sizeof...(I)> launchers(std::integer_sequence<int, I...>) {
  return {&launch_if_taken<I / kMaxSlots + 1, I % kMaxSlots + 1>...};
}

constexpr std::array<Launcher, kMaxSlots * kMaxSlots> kLaunchers =
    launchers(std::make_integer_sequence<int, kMaxSlots * kMaxSlots>{});

}  // namespace

// Dynamic shared memory one CTA of a rows x cols lattice needs in a cluster
// of k CTAs a stream in the shared form, in bytes.
extern "C" long long relax_sweep_shared_bytes(int rows, int cols, int k) {
  return layout(rows, cols, k).floats * static_cast<long long>(sizeof(float));
}

// The global form's kept levels of one CTA, in device memory, in bytes.
extern "C" long long relax_sweep_level_bytes(int rows, int cols, int k) {
  return layout(rows, cols, k, true).floats * static_cast<long long>(sizeof(float));
}

// The longest line (cells) the kernel takes, and the most CTAs a stream.
extern "C" int relax_sweep_max_line() { return kMaxLine; }
extern "C" int relax_sweep_max_cluster() { return kMaxCluster; }

// The most dynamic shared memory one CTA of the kernel can have on card
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
// rows, columns), all pointers on card `device`, in clusters of k CTAs a
// stream. The global form when `scratch` is not null: B * 4 * R * (C|1)
// floats of fields, then B * k CTAs' kept levels of
// relax_sweep_level_bytes(R, C, k) bytes each, on the card; the shared form
// when it is null. Returns the cudaError_t of the launch (0 on success); -1
// when a line is longer than relax_sweep_max_line(), k is not one that
// gives each warp at most one line a side (ceil(longer side / 32) <= k <=
// 8), or the scratch is not addressed by 32-bit offsets (2**31 floats); -2
// when a CTA's shared memory exceeds relax_sweep_shared_cap(device); -3
// when no such cluster can be placed on the card. Launches on `stream`,
// does not synchronise. This library carries its own CUDA runtime, so the
// card is set here when it is not the current one.
extern "C" int relax_sweep_launch(const float* enter, const int* start, const float* turn,
                                  float* out, int* passes, int* scans, int batch, int rows,
                                  int cols, int max_passes, int k, float* scratch, int device,
                                  void* stream) {
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  const int longest = rows > cols ? rows : cols;
  if (rows < 1 || cols < 1 || longest > kMaxLine || batch < 1) return -1;
  if (k < ceil_div(longest, kMaxWarps) || k > kMaxCluster) return -1;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool global = scratch != nullptr;
  const long long smem = global ? 0 : relax_sweep_shared_bytes(rows, cols, k);
  static int cap[64] = {};  // asked once a card
  if (cap[device] == 0 && (cap[device] = relax_sweep_shared_cap(device)) < 0) {
    cap[device] = 0;
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  if (smem > cap[device]) return -2;
  const long long fields = 4LL * batch * rows * (cols | 1);
  const Layout lay = layout(rows, cols, k, true);
  if (global && fields + 1LL * batch * k * (lay.lev[0] + lay.lev[1]) >= (1LL << 31)) return -1;
  const Args a{enter, start, turn, out, passes, scans, scratch,
               global ? scratch + fields : nullptr, batch, rows, cols, max_passes, k,
               device, smem, static_cast<cudaStream_t>(stream)};
  if (global) return launch<kMaxSlots, kMaxSlots, true>(a);
  const int jr = ceil_div(cols, kWarp), jc = ceil_div(rows, kWarp);
  return kLaunchers[(jr - 1) * kMaxSlots + (jc - 1)](a);
}
