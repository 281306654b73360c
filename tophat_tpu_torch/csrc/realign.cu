// Event realignment on Hopper: best split of every read row across every
// event of one insertion-length group.
//
// Replaces the Pallas TPU kernel tophat_tpu/ops/pallas/realign_kernel.py
// (_realign_kernel via realign_pallas), which computes the same result as
// two bf16 one-hot matmuls per split point on the MXU.
//
// For row r (read codes, length len) and event e:
//   mm(t) = len - match(t),  1 <= t <= min(L - 1, len - 1 - q)
//   match(t) = #{u < L : read[u] == T[L - t + u]},  T = [flankL | comb]
// where flankL ends at the event's left base, comb = [inserted seq (q) |
// right flank], and a position matches iff both codes are equal and lie in
// 0..7 (read padding -1 never matches; genome N (4) matches read N (4);
// out-of-genome flank positions carry 5 and never match a read base).
// Outputs: the leftmost argmin best_t, mm = min (32767 if above max_mm),
// ok = mm <= max_mm. Rows with no interior split, or none with mm below
// 32767, give best_t 0, mm 32767, ok 0. Two epilogues: dense (R, E)
// tables, or sparse records (row, event, best_t, mm) of the ok pairs of
// valid events, appended with an atomic counter (the wrapper sorts them;
// it relaunches if `cap` was too small).
//
// What bounds it: one split is one product. With reads and targets as
// 8-channel one-hots (K = 8 L bytes a row), match(t) is the dot product of
// the read row with the K-byte window of the event's target that starts
// at byte 8 (L - t). So the work is 2 * R * E * (#splits) * 8 L integer
// operations, at the int8 tensor-core peak (1,979 TOP/s on an H100 SXM);
// the bytes (reads, targets, results) are small beside it.
//
// Design: one kernel, realign_mma_kernel<S, Op>, for every width L up to
// MAX_L = 262,143 (the argmin's int32 range, below); Op says where its
// operands sit (OneHots for L <= 256; ShiftCodes above while a 64 x 16
// tile's rows and two event tiles fit in shared memory, to L = 1,783;
// StreamedCodes wider) and how its argmin is kept.
// mma.sync.m16n8k32 s8 -> s32 on the tensor cores, 0/1 products summed in
// int32 (exact). mma.sync and not wgmma because the B operand moves every
// split: the window starts at position L - t, which is 4-byte but not
// 16-byte aligned, and an m16n8k32 B fragment is two 32-bit words of 4
// consecutive K bytes each, which a lane loads (or builds in registers)
// itself at any t, where wgmma's descriptors and ldmatrix need 16-byte
// aligned rows. The cost: mma.sync peaks near 1,280 TOP/s on an H100 SXM
// (scripts/mma_sync_peak.cu), two thirds of the bound's rate.
//  - Operands, L <= 256 (OneHots): reads carry 64 and targets 4 in the
//    byte of their code, so a match adds 256. A small prep kernel writes
//    every event's target [flankL | comb] as one-hots, zero-padded on both
//    sides, into the device scratch buffer. A block builds its rows'
//    one-hots once per row tile in shared memory, in fragment order (one
//    16-byte load a lane per K step, a warp reading 512 contiguous
//    bytes), and copies the event tiles' targets in by cp.async,
//    double-buffered: the next tile loads while this one computes. The
//    event stride is 8 words mod 32, so the 16 lanes of each half of a
//    64-bit B load hit 32 banks.
//  - Operands, L > 256 (ShiftCodes): one-hots take 8 bytes a position;
//    at L = 1,000 a 16-row tile of them is 128 KB and two event tiles of
//    targets 512 KB, over the 227 KB a block may hold. So both operands
//    stay one byte a position, a shift code (8 c for a code c in 0..7,
//    else 0xff), and become one-hot words in registers as they are
//    loaded: ONE << s and ONE << (s ^ 32) (shl clamps amounts of 32 and
//    more to a zero result, so codes 0..3 land in the first word, 4..7 in
//    the second, 0xff in neither; a match adds ONE^2 = 4,096): about a
//    dozen integer instructions a K step beside the S products they feed.
//    The whole row tile (one 16-bit word a lane per K step: rows g and
//    g + 8) and two whole event tiles (P = 16 mod 128 bytes an event, so
//    the 8 events of a warp's byte loads hit distinct banks) sit in shared
//    memory, the next event tile loading by cp.async as on the fast path.
//    Shift codes would serve every width, but at L <= 256 they took 18-29%
//    longer than one-hots (3% at L = 150; scripts/realign_ab.py on an
//    NVIDIA H100 80GB HBM3 at 700 W, PERF.md section 6), so one-hots keep
//    those widths.
//  - Operands, wider rows (StreamedCodes): the shift codes stream through
//    shared memory in chunks of KC = 64 K steps, for one warp's 16 x 8
//    tile a block (every loop bound is warp-uniform; 14.6 KB, so about 16
//    warps an SM, where the whole-tile layout held one or two warps a
//    block, one block an SM, and took 2.9-5.8x longer at L = 2,048 to
//    4,097, PERF.md section 6). A prep kernel also writes the rows' shift
//    codes in fragment order to the scratch buffer, so a chunk of a row
//    tile is 64 KC contiguous bytes. A split group t0 .. t0 + 4 (S - 1)
//    reads, per chunk, those bytes and each event's window [L - t0 -
//    4 (S - 1), L - t0 + 4 KC) from its chunk start (widened to 16-byte
//    bounds for cp.async), double-buffered: the next chunk (of this group,
//    or the first of the next) loads while this one computes, and the
//    S x 4 accumulators stay in registers across the chunks. One group
//    reloads about 16 L + 8 L bytes, from L2, for 2 x 16 x 8 x S x 8 L
//    operations (~680 a byte at S = 8), so the reloads cost little
//    against the products.
//  - Warps: a block holds BR = 16 WR rows and BE = 8 WE events; each of
//    its WR x WE warps owns 16 rows x 8 events, i.e. one m16n8 tile.
//  - Splits of one phase (t mod 4) are taken S at a time: t0, t0 + 4,
//    ..., t0 + 4 (S - 1). The window of split t0 + 4 s at K step kk is the
//    window of t0 at K step kk - s, so one B fragment loaded from shared
//    memory feeds S products, and one A fragment (reloaded per K step)
//    feeds S products too: shared-memory traffic is 24 bytes a lane per
//    S products (3 with shift codes). S = 8 above L = 64; S = 4 at or
//    below, where a group has few K steps to share and the kernel fits
//    twice on an SM.
//  - The argmin stays fused, a compile-time property of Op. One-hot
//    tiles pack it: a split t starts at T - t (T = 255), so its
//    accumulator ends at 256 match + T - t and a running maximum over the
//    splits is the most matches at the leftmost split. Shift codes, of
//    any width, hold the leftmost split explicitly: split s of a group
//    starts at 7 - s, so the group's maximum is its most matches at its
//    leftmost split; a phase's groups come in increasing t, so a group
//    replaces the phase's best only with strictly more matches, and as
//    the four phases interleave t, each phase's best joins the row's as
//    more matches or as many at a smaller t. That is a few integer
//    instructions a group and nothing a K step, but on one-hots at L = 25
//    it took 7.4% longer than packing, where the shift-code kernel ran
//    1-3% faster with it than packed (scripts/realign_ab.py, PERF.md
//    section 6), so each keeps its faster form. Splits above a row's
//    min(L - 1, len - 1 - q) start at NEG = -2^30 and never win; products
//    of splits above every row of the warp are not issued (resident
//    tiles; a streamed group computes all S, those past the row's last
//    split starting at NEG). The sums stay exact in int32 while -2^30 +
//    4,096 L + 7 < 0, which caps L at MAX_L = 2^18 - 1 (the wrapper
//    raises ValueError above it, and this file returns
//    cudaErrorInvalidValue).
//    The start values are set in registers, not passed as the first
//    product's C: that would make a second, predicated copy of every mma,
//    and an mma whose predicate is off still holds the tensor pipe (it
//    halved the rate). Nothing per split reaches device memory; the
//    epilogue writes dense tables or records.
//  - Tiles per L: one-hots take 8 warps (64 rows x 16 events) while the
//    shared memory fits (L up to 216), else 4 warps (32 x 16); shift
//    codes 64 x 16 up to L = 1,783, then streamed 16 x 8. Above 48 KB it
//    is dynamic shared memory. The grid is persistent: as many blocks as
//    fit on the SMs, each walking a contiguous run of (row tile, event
//    tile) units, row tile major, counted in 64 bits, so the sizes are
//    capped only by int32 R and E. R = 8,192, E = 69 on 132 SMs is 128
//    row tiles x 5 event tiles = 640 units, 4 or 5 on every SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int FAST_MAX_L = 256;
constexpr int MAX_L = (1 << 18) - 1;  // NEG + 4,096 MAX_L + 7 < 0
constexpr int S_MAX = 8;           // splits of one phase per group, at most
constexpr int SMALL_L = 64;        // widths up to this take groups of 4
constexpr int PAD_L = 4 * S_MAX;   // empty positions left of each target
constexpr int KC = 64;             // K steps a streamed chunk
constexpr int BIG = 32767;
constexpr int NEG = -(1 << 30);    // start of a split the row does not have
constexpr int MAX_SMEM = 232448;   // shared memory one block may use

// Where results go: dense tables, or sparse records of the ok pairs.
struct Out {
  int32_t* best_t;      // dense (R, E); null in sparse mode
  int32_t* mm;
  uint8_t* ok;
  const uint8_t* valid; // sparse: (E,) events that may emit records
  int32_t* rec;         // sparse: (4, cap) rows, events, best_t, mm
  int cap;
  unsigned long long* count;  // sparse: records found (may exceed cap)
};

// Layout for width L: P target positions an event, K steps, warps along
// rows (WR) and events (WE), dynamic shared memory bytes; streamed: PC
// bytes an event's chunk takes in shared memory.
struct Tiles {
  int P, KS, WR, WE, PC;
  bool stream;
  size_t smem;
};

// DENSE: out.best_t is set (a template argument where a kernel is
// instantiated per mode, so the other mode's code is not compiled in).
template <bool DENSE>
__device__ __forceinline__ void emit(const Out& out, int r, int E, int e,
                                     int best, int bt, int max_mm) {
  const bool ok = best <= max_mm;
  if constexpr (DENSE) {
    const size_t o = size_t(r) * E + e;
    out.best_t[o] = bt;
    out.mm[o] = ok ? best : BIG;
    out.ok[o] = ok ? 1 : 0;
  } else if (ok && out.valid[e]) {
    const unsigned long long i = atomicAdd(out.count, 1ULL);
    if (i < (unsigned long long)out.cap) {
      out.rec[i] = r;
      out.rec[size_t(out.cap) + i] = e;
      out.rec[2 * size_t(out.cap) + i] = bt;
      out.rec[3 * size_t(out.cap) + i] = best;
    }
  }
}

// x << s with PTX's clamp: s >= 32 gives 0.
__device__ __forceinline__ uint32_t shl(uint32_t x, uint32_t s) {
  uint32_t r;
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(s));
  return r;
}

// The argmin over a row's splits, per accumulator slot (slots 0, 1: row
// g; 2, 3: row g + 8), in registers. start(t, s) is the start value of
// split t = t0 + 4 s; group() takes a group's accumulators, phase() ends
// a phase; matches(j) < 0 where the row has no split, else its most
// matches, at split(j), the leftmost split that has them.
//
// Packed (one-hot tiles): a split starts at T - t, so its accumulator
// ends at 2^SHIFT match + T - t and the running maximum is the most
// matches at the leftmost split; exact while L <= T + 1.
template <int SHIFT, int T>
struct PackedArgmin {
  int best[4] = {-1, -1, -1, -1};
  __device__ static int start(int t, int) { return T - t; }
  template <int NA>
  __device__ void group(const int (&acc)[NA][4], int) {
#pragma unroll
    for (int s = 0; s < NA; ++s)
#pragma unroll
      for (int j = 0; j < 4; ++j) best[j] = max(best[j], acc[s][j]);
  }
  __device__ void phase() {}
  __device__ int matches(int j) const { return best[j] >> SHIFT; }
  __device__ int split(int j) const { return T - (best[j] & T); }
};

// Leftmost (shift codes, rows of any width): a split starts at
// 7 - s, so a group's maximum is its most matches at its leftmost split.
// A phase's groups come in increasing t, so a group replaces the phase's
// best (pv, packed the same way, found in the group at pt) only with
// strictly more matches; the four phases interleave t, so each phase's
// best is folded into the row's (bm matches at split bt) as more matches,
// or as many at a smaller t.
template <int SHIFT>
struct LeftmostArgmin {
  int pv[4] = {-1, -1, -1, -1}, pt[4] = {0, 0, 0, 0};
  int bm[4] = {-1, -1, -1, -1}, bt[4] = {0, 0, 0, 0};
  __device__ static int start(int, int s) { return 7 - s; }
  template <int NA>
  __device__ void group(const int (&acc)[NA][4], int t0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int m = acc[0][j];
#pragma unroll
      for (int s = 1; s < NA; ++s) m = max(m, acc[s][j]);
      if ((m >> SHIFT) > (pv[j] >> SHIFT)) pv[j] = m, pt[j] = t0;
    }
  }
  __device__ void phase() {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = pv[j] >> SHIFT, t = pt[j] + 4 * (7 - (pv[j] & 7));
      if (m > bm[j] || (m == bm[j] && t < bt[j])) bm[j] = m, bt[j] = t;
      pv[j] = -1, pt[j] = 0;
    }
  }
  __device__ int matches(int j) const { return bm[j]; }
  __device__ int split(int j) const { return bt[j]; }
};

// ---- operands ------------------------------------------------------------
// Each Op gives: A, the row tile's element (one a lane per K step, in
// fragment order: rows g and g + 8 at position 4 kk + tig); B, the
// targets' element, PER_POS of them a position; a(af, kk), the A
// fragment {row g codes 0..3, row g + 8 codes 0..3, row g codes 4..7,
// row g + 8 codes 4..7} of K step kk; b(bj, J), the B fragment {codes
// 0..3, codes 4..7} of this lane's event at position 4 J + tig past the
// window; row(ca, cb), the A element of codes ca (row g) and cb (row
// g + 8); target(c), one target position; STREAM, whether the operands
// stream through shared memory; Argmin, how the argmin is kept.

struct OneHots {                  // L <= 256: 8 bytes a position
  using A = uint4;
  using B = uint32_t;
  static constexpr int PER_POS = 2;
  static constexpr bool STREAM = false;
  using Argmin = PackedArgmin<8, 255>;
  static constexpr uint32_t A_ONE = 64, B_ONE = 4;  // a match adds 256
  __device__ static uint4 a(const uint4* af, int kk) { return af[32 * kk]; }
  __device__ static uint2 b(const uint32_t* bj, int j) {
    return *reinterpret_cast<const uint2*>(bj + 8 * j);
  }
  __device__ static uint4 row(int ca, int cb) {
    const uint32_t va = ca >= 0 && ca < 8 ? A_ONE << (8 * (ca & 3)) : 0u;
    const uint32_t vb = cb >= 0 && cb < 8 ? A_ONE << (8 * (cb & 3)) : 0u;
    return make_uint4(ca < 4 ? va : 0u, cb < 4 ? vb : 0u, ca >= 4 ? va : 0u,
                      cb >= 4 ? vb : 0u);
  }
  __device__ static uint2 target(int c) {
    const uint32_t v = c >= 0 && c < 8 ? B_ONE << (8 * (c & 3)) : 0u;
    return make_uint2(c < 4 ? v : 0u, c >= 4 ? v : 0u);
  }
};

struct ShiftCodes {               // L > 256: 1 byte a position
  using A = uint16_t;
  using B = uint8_t;
  static constexpr int PER_POS = 1;
  static constexpr bool STREAM = false;
  using Argmin = LeftmostArgmin<12>;
  static constexpr uint32_t ONE = 64;  // both operands: a match adds 4096
  __device__ static uint32_t code(int c) {
    return c >= 0 && c < 8 ? uint32_t(8 * c) : 0xffu;
  }
  __device__ static uint2 onehot(uint32_t s) {
    return make_uint2(shl(ONE, s), shl(ONE, s ^ 32u));
  }
  __device__ static uint4 a(const uint16_t* af, int kk) {
    const uint32_t v = af[32 * kk];
    const uint2 x = onehot(v & 0xffu), y = onehot(v >> 8);
    return make_uint4(x.x, y.x, x.y, y.y);
  }
  __device__ static uint2 b(const uint8_t* bj, int j) {
    return onehot(bj[4 * j]);
  }
  __device__ static uint16_t row(int ca, int cb) {
    return uint16_t(code(ca) | code(cb) << 8);
  }
  __device__ static uint8_t target(int c) { return uint8_t(code(c)); }
};

struct StreamedCodes : ShiftCodes {  // rows too wide for resident tiles
  static constexpr bool STREAM = true;
};

// Every event's target [flankL | comb] as Op's elements, [event][P
// positions]: PAD_L empty positions, flankL, comb, empty positions.
template <class Op>
__global__ void target_kernel(const int8_t* __restrict__ flank_l,
                              const int8_t* __restrict__ comb, int E, int L,
                              int P, typename Op::B* __restrict__ tgt) {
  const size_t total = size_t(E) * P;
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < total;
       i += size_t(gridDim.x) * blockDim.x) {
    const int e = int(i / P), u = int(i % P) - PAD_L;
    const int c = u < 0 || u >= 2 * L ? -1
                  : u < L             ? flank_l[size_t(e) * L + u]
                                      : comb[size_t(e) * L + u - L];
    auto v = Op::target(c);
    static_assert(sizeof(v) == Op::PER_POS * sizeof(typename Op::B), "");
    *reinterpret_cast<decltype(v)*>(tgt + i * Op::PER_POS) = v;
  }
}

// Streamed layout: every row tile's A elements in fragment order,
// [row tile][K step][lane] (rows 16 rt + g and + 8 at position 4 kk + tig;
// rows >= R and positions >= L are empty).
template <class Op>
__global__ void rows_kernel(const int8_t* __restrict__ reads, int R, int L,
                            int KS, typename Op::A* __restrict__ rows) {
  const size_t total = size_t((R + 15) / 16) * KS * 32;
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < total;
       i += size_t(gridDim.x) * blockDim.x) {
    const int lane = int(i % 32), kk = int(i / 32 % KS);
    const int ra = 16 * int(i / 32 / KS) + (lane >> 2);
    const int x = 4 * kk + (lane & 3);
    const int ca = ra < R && x < L ? reads[size_t(ra) * L + x] : -1;
    const int cb = ra + 8 < R && x < L ? reads[size_t(ra + 8) * L + x] : -1;
    rows[i] = Op::row(ca, cb);
  }
}

// D = A B + D.
__device__ __forceinline__ void mma_s8(int (&d)[4], uint4 a, uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One event tile's targets (BE events x P positions, contiguous in
// device memory and in shared memory) by 16-byte cp.async; events past E
// are zero-filled.
template <class Op>
__device__ __forceinline__ void load_targets(typename Op::B* dst,
                                             const typename Op::B* tgt,
                                             int e0, int BE, int E, int P) {
  constexpr int per16 = 16 / (Op::PER_POS * sizeof(typename Op::B));
  const uint4* src =
      reinterpret_cast<const uint4*>(tgt + size_t(e0) * P * Op::PER_POS);
  const int n_in = max(0, min(BE, E - e0)) * (P / per16);  // chunks
  for (int i = threadIdx.x; i < BE * (P / per16); i += blockDim.x)
    cp_async16(reinterpret_cast<uint4*>(dst) + i,
               i < n_in ? src + i : reinterpret_cast<const uint4*>(tgt),
               i < n_in ? 16 : 0);
  cp_commit();
}

// NA splits of one phase, t0, t0 + 4, ..., t0 + 4 (NA - 1), over nk K
// steps, for this warp's 16 rows x 8 events. The window of split t0 + 4 s
// at K step kk is the window of t0 at step kk - s, so B_J (the fragment
// at K step J past the window of t0) is loaded once and used by NA
// products; it sits in bw[J mod NA].
template <int NA, class Op>
__device__ __forceinline__ void mma_steps(int (&acc)[NA][4],
                                          const typename Op::A* af,
                                          const typename Op::B* bj, int nk) {
  uint2 bw[NA];
#pragma unroll
  for (int j = 1; j < NA; ++j) bw[NA - j] = Op::b(bj, -j);
  for (int kk0 = 0; kk0 < nk; kk0 += NA) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int kk = kk0 + i;
      if (kk < nk) {
        const uint4 a = Op::a(af, kk);
        bw[i] = Op::b(bj, kk);
#pragma unroll
        for (int s = 0; s < NA; ++s)
          mma_s8(acc[s], a, bw[(i - s + NA) % NA]);
      }
    }
  }
}

// Accumulator s of the group at t0 starts at Argmin::start, or at NEG
// where the row has no split t0 + 4 s.
template <class Argmin, int NA>
__device__ __forceinline__ void start_group(int (&acc)[NA][4], int t0,
                                            int tm_lo, int tm_hi) {
#pragma unroll
  for (int s = 0; s < NA; ++s) {
    const int t = t0 + 4 * s;
    acc[s][0] = acc[s][1] = t <= tm_lo ? Argmin::start(t, s) : NEG;
    acc[s][2] = acc[s][3] = t <= tm_hi ? Argmin::start(t, s) : NEG;
  }
}

// One resident group of na <= NA splits (split_group<NA> dispatches on the
// run-time na, so no product of a split past tmax is issued).
template <int NA, class Op>
__device__ __forceinline__ void split_group(int na, const typename Op::A* af,
                                            const typename Op::B* bj, int KS,
                                            int t0, int tm_lo, int tm_hi,
                                            typename Op::Argmin& am) {
  if constexpr (NA > 1) {
    if (na < NA) {
      split_group<NA - 1, Op>(na, af, bj, KS, t0, tm_lo, tm_hi, am);
      return;
    }
  }
  int acc[NA][4];
  start_group<typename Op::Argmin, NA>(acc, t0, tm_lo, tm_hi);
  mma_steps<NA, Op>(acc, af, bj, KS);
  am.group(acc, t0);
}

// The streamed operands of one unit (16 rows from r0's row tile, 8 events
// from e0): chunk c of the group at t0 is K steps [KC c, KC c + nk) of the
// rows and each event's target positions [lo, hi) around that chunk of
// the windows, in shared-memory buffer `buf` (of two).
template <int S, class Op>
struct Stream {
  using A = typename Op::A;
  using B = typename Op::B;
  const A* rows;  // this row tile's fragments, KS x 32
  const B* tgt;
  A* sA;          // 2 x KC x 32
  B* sB;          // 2 x 8 events x PC
  int e0, E, L, P, PC, KS;

  __device__ int nk(int c) const { return min(KC, KS - KC * c); }
  __device__ int pos0(int t0, int c) const {
    return PAD_L + L - t0 + 4 * KC * c;
  }
  __device__ int lo(int t0, int c) const {
    return (pos0(t0, c) - 4 * (S - 1)) & ~15;
  }

  // cp.async the chunk into `buf` and commit (events past E zero-fill).
  __device__ void issue(int t0, int c, int buf) const {
    const int lane = threadIdx.x;
    const char* a = reinterpret_cast<const char*>(rows + size_t(KC) * c * 32);
    char* sa = reinterpret_cast<char*>(sA + buf * KC * 32);
    for (int i = lane; i < 4 * nk(c); i += 32)
      cp_async16(sa + 16 * i, a + 16 * i, 16);
    const int l = lo(t0, c);
    const int n16 = (((pos0(t0, c) + 4 * nk(c) + 15) & ~15) - l) / 16;
    B* sb = sB + buf * 8 * PC;
    for (int i = lane; i < 8 * n16; i += 32) {
      const int ev = i / n16, x = 16 * (i % n16);
      const bool in = e0 + ev < E;
      cp_async16(sb + ev * PC + x,
                 in ? tgt + size_t(e0 + ev) * P + l + x : tgt, in ? 16 : 0);
    }
    cp_commit();
  }

  // The S splits at t0 over every chunk; after the last chunk, the chunk
  // at (next_t0, 0) is in flight (next_t0 = 0: none).
  __device__ void group(int (&acc)[S][4], int t0, int next_t0,
                        int& buf) const {
    const int lane = threadIdx.x, nch = (KS + KC - 1) / KC;
    for (int c = 0; c < nch; ++c) {
      if (c + 1 < nch)
        issue(t0, c + 1, buf ^ 1);
      else if (next_t0 > 0)
        issue(next_t0, 0, buf ^ 1);
      else
        cp_commit();
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      __syncthreads();
      const B* bj = sB + buf * 8 * PC + (lane >> 2) * PC +
                    (pos0(t0, c) - lo(t0, c)) + (lane & 3);
      mma_steps<S, Op>(acc, sA + buf * KC * 32 + lane, bj, nk(c));
      __syncthreads();  // done with `buf` before it is refilled
      buf ^= 1;
    }
  }
};

// S splits a group: 8 for wide rows; 4 for narrow ones, whose few K
// steps give a group little to share, so that two blocks fit on an SM.
// Warps: WR along rows, WE along events.
template <int S, class Op>
__global__ void __launch_bounds__(256, S <= 4 || Op::PER_POS == 1 ? 2 : 1)
realign_mma_kernel(const int8_t* __restrict__ reads,
                   const int32_t* __restrict__ lengths,
                   const typename Op::B* __restrict__ tgt,
                   const typename Op::A* __restrict__ rows, int R, int E,
                   int L, int q, int max_mm, Tiles w, Out out) {
  using A = typename Op::A;
  using B = typename Op::B;
  extern __shared__ __align__(16) uint32_t smem[];
  const int P = w.P, KS = w.KS, WR = w.WR, WE = w.WE;
  const int BR = 16 * WR, BE = 8 * WE;
  const int tile = Op::STREAM ? 8 * w.PC : BE * P * Op::PER_POS;  // a buffer
  B* sB = reinterpret_cast<B*>(smem);             // 2 buffers
  A* sA = reinterpret_cast<A*>(sB + 2 * tile);  // WR KS 32, or 2 KC 32
  int* sLen = reinterpret_cast<int*>(sA + WR * KS * 32);  // BR (resident)

  // a persistent block: its share of the (row tile, event tile) units,
  // row tile major, so the rows are rebuilt only when the row tile
  // changes; the tile indices step along, so no unit divides in 64 bits
  const int n_ev_tiles = (E + BE - 1) / BE;
  const long long units = (long long)((R + BR - 1) / BR) * n_ev_tiles;
  const long long u0 = units * blockIdx.x / gridDim.x;
  const long long u1 = units * (blockIdx.x + 1) / gridDim.x;
  if (u0 >= u1) return;
  int rt = int(u0 / n_ev_tiles), et = int(u0 % n_ev_tiles);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wrow = warp % WR, wev = warp / WR;
  const int lr0 = 16 * wrow + g;  // this thread's rows: lr0, lr0 + 8
  const A* af = sA + wrow * KS * 32 + lane;  // its A fragments (resident)

  if constexpr (!Op::STREAM)
    load_targets<Op>(sB, tgt, et * BE, BE, E, P);
  int r0 = -1;
  for (long long u = u0; u < u1; ++u) {
    const int buf = int(u - u0) & 1;
    const int next_et = et + 1 < n_ev_tiles ? et + 1 : 0;
    int len_lo, len_hi;
    if constexpr (Op::STREAM) {
      r0 = rt * BR;
      len_lo = r0 + g < R ? lengths[r0 + g] : 0;
      len_hi = r0 + g + 8 < R ? lengths[r0 + g + 8] : 0;
    } else {
      if (u + 1 < u1)
        load_targets<Op>(sB + (buf ^ 1) * tile, tgt, next_et * BE, BE, E, P);
      else
        cp_commit();
      if (rt * BR != r0) {
        // the rows in fragment order: lane (g, tig) of the warps owning
        // rows 16 w .. 16 w + 15 finds, at K step kk, position p = 4 kk +
        // tig of rows g and g + 8 in sA[(w KS + kk) 32 + lane] (positions
        // >= L are empty)
        r0 = rt * BR;
#pragma unroll 4
        for (int f = warp; f < WR * KS; f += blockDim.x >> 5) {
          const int ra = r0 + 16 * (f / KS) + g, x = 4 * (f % KS) + tig;
          const int ca = ra < R && x < L ? reads[size_t(ra) * L + x] : -1;
          const int cb = ra + 8 < R && x < L ? reads[size_t(ra + 8) * L + x]
                                             : -1;
          sA[f * 32 + lane] = Op::row(ca, cb);
        }
        for (int i = threadIdx.x; i < BR; i += blockDim.x)
          sLen[i] = r0 + i < R ? lengths[r0 + i] : 0;
      }
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      __syncthreads();
      len_lo = sLen[lr0], len_hi = sLen[lr0 + 8];
    }

    const int tm_lo = min(L - 1, len_lo - 1 - q);
    const int tm_hi = min(L - 1, len_hi - 1 - q);
    const int tmax = __reduce_max_sync(0xffffffffu, max(tm_lo, tm_hi));
    typename Op::Argmin am;

    if constexpr (Op::STREAM) {
      const Stream<S, Op> st{rows + size_t(r0 / 16) * KS * 32, tgt, sA, sB,
                             et * BE, E, L, P, w.PC, KS};
      int acc[S][4], sbuf = 0;
      if (tmax >= 1) st.issue(1, 0, 0);
      for (int p = 1; p <= 4 && p <= tmax; ++p) {
        for (int t0 = p; t0 <= tmax; t0 += 4 * S) {
          const int next = t0 + 4 * S <= tmax         ? t0 + 4 * S
                           : p < 4 && p + 1 <= tmax ? p + 1
                                                      : 0;
          start_group<typename Op::Argmin, S>(acc, t0, tm_lo, tm_hi);
          st.group(acc, t0, next, sbuf);
          am.group(acc, t0);
        }
        am.phase();
      }
    } else {
      // this thread's B: event 8 wev + g of the tile, position tig
      const B* b_ev =
          sB + buf * tile + ((8 * wev + g) * P + tig) * Op::PER_POS;
      for (int p = 1; p <= 4; ++p) {
        for (int t0 = p; t0 <= tmax; t0 += 4 * S) {
          // the splits of this phase up to tmax, at most S of them
          split_group<S, Op>(min(S, (tmax - t0) / 4 + 1), af,
                             b_ev + (PAD_L + L - t0) * Op::PER_POS, KS, t0,
                             tm_lo, tm_hi, am);
        }
        am.phase();
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + lr0 + (j >> 1) * 8;
      const int e = et * BE + 8 * wev + 2 * tig + (j & 1);
      if (r < R && e < E) {
        // no split, or none below BIG (rows of 32,767 or more): t = 0
        const int m = am.matches(j);
        const int mm = m < 0 ? BIG : min(BIG, (j < 2 ? len_lo : len_hi) - m);
        const int t = mm < BIG ? am.split(j) : 0;
        if (out.best_t)
          emit<true>(out, r, E, e, mm, t, max_mm);
        else
          emit<false>(out, r, E, e, mm, t, max_mm);
      }
    }
    rt += next_et == 0;
    et = next_et;
    if constexpr (!Op::STREAM)
      __syncthreads();  // every warp is done with `buf` and the rows
  }                     // before they are refilled
}

// Layout for width L. One-hots: P >= PAD_L + 2L + 4, = 4 mod 16 (an
// event's stride is 8 words mod 32); 64 x 16, 32 x 16 or 16 x 16 rows x
// events. Shift codes: P >= PAD_L + 2L + 2, = 16 mod 128 (4 words mod
// 32); 64 x 16 resident; else streamed 16 x 8, a chunk's event bytes
// PC = 16 mod 128 too.
Tiles tiles(int L) {
  const bool fast = L <= FAST_MAX_L;
  const int pos = fast ? 8 : 1;   // target bytes a position
  const int a16 = fast ? 16 : 2;  // row-tile bytes a lane per K step
  Tiles w;
  w.P = PAD_L + 2 * L + (fast ? 4 : 2);
  w.P += fast ? ((4 - w.P) % 16 + 16) % 16 : ((16 - w.P) % 128 + 128) % 128;
  w.KS = (L + 3) / 4;
  w.PC = 0;
  w.stream = false;
  const int shapes[3][2] = {{4, 2}, {2, 2}, {1, 2}};
  for (int i = 0; i < (fast ? 3 : 1); ++i) {
    w.WR = shapes[i][0], w.WE = shapes[i][1];
    w.smem = size_t(2) * 8 * w.WE * w.P * pos +
             size_t(w.WR) * w.KS * 32 * a16 + size_t(16 * w.WR) * 4;
    if (w.smem <= MAX_SMEM) return w;
  }
  // a chunk's window, widened to 16-byte bounds: at most this many bytes
  const int need = (4 * KC + 4 * (S_MAX - 1) + 30) / 16 * 16;
  w.stream = true;
  w.WR = w.WE = 1;
  w.PC = need + ((16 - need) % 128 + 128) % 128;
  w.smem = size_t(2) * 8 * w.PC + size_t(2) * KC * 32 * a16;
  return w;
}

// Scratch bytes: the targets, then (streamed) the rows in fragment order.
long long target_bytes(const Tiles& w, int E, int L) {
  return (1LL * E * w.P * (L <= FAST_MAX_L ? 8 : 1) + 15) / 16 * 16;
}

long long scratch_bytes(int R, int E, int L) {
  const Tiles w = tiles(L);
  return target_bytes(w, E, L) +
         (w.stream ? 64LL * ((R + 15) / 16) * w.KS : 0);
}

template <int S, class Op>
int launch(const int8_t* reads, const int32_t* lengths,
           const int8_t* flank_l, const int8_t* comb, int R, int E, int L,
           int q, int max_mm, const Out& out, uint32_t* scratch,
           cudaStream_t stream) {
  const Tiles w = tiles(L);
  if (w.stream != Op::STREAM || (uintptr_t(scratch) & 15))
    return int(cudaErrorInvalidValue);
  auto* tgt = reinterpret_cast<typename Op::B*>(scratch);
  const long long prep_blocks = (1LL * E * w.P + 255) / 256;
  target_kernel<Op><<<unsigned(prep_blocks < 1024 ? prep_blocks : 1024), 256,
                      0, stream>>>(flank_l, comb, E, L, w.P, tgt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  typename Op::A* rows = nullptr;
  if constexpr (Op::STREAM) {
    rows = reinterpret_cast<typename Op::A*>(
        reinterpret_cast<char*>(scratch) + target_bytes(w, E, L));
    const long long n = 32LL * ((R + 15) / 16) * w.KS;
    rows_kernel<Op><<<unsigned(n / 256 + 1 < 1024 ? n / 256 + 1 : 1024),
                      256, 0, stream>>>(reads, R, L, w.KS, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }
  auto kernel = realign_mma_kernel<S, Op>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(w.smem));
  if (err != cudaSuccess) return int(err);
  // one persistent block per resident slot: as many as fit on the SMs
  int dev = 0, n_sm = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const int threads = 32 * w.WR * w.WE;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                w.smem);
  const long long units = (long long)((R + 16 * w.WR - 1) / (16 * w.WR)) *
                          ((E + 8 * w.WE - 1) / (8 * w.WE));
  const long long slots = (long long)n_sm * (per_sm > 0 ? per_sm : 1);
  kernel<<<unsigned(units < slots ? units : slots), threads, w.smem,
           stream>>>(reads, lengths, tgt, rows, R, E, L, q, max_mm, w, out);
  return int(cudaGetLastError());
}

}  // namespace

// uint32 words of device scratch realign_launch needs: the targets, as
// one-hots (8 bytes a position) up to L = 256, else shift codes (1 byte),
// and for streamed widths the rows' shift codes in fragment order.
extern "C" long long realign_scratch_words(int R, int E, int L) {
  return scratch_bytes(R, E, L) / 4;
}

// The widest row realign_launch takes (the argmin's int32 range).
extern "C" int realign_max_width() { return MAX_L; }

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// `scratch` holds realign_scratch_words(R, E, L) words, 16-byte aligned.
// Dense mode when best_t is not null, else sparse mode: records
// of ok pairs of valid events into rec (4 x cap int32), their number
// (which may exceed cap; 64 bits) into *count, which the caller zeroes.
extern "C" int realign_launch(const int8_t* reads, const int32_t* lengths,
                              const int8_t* flank_l, const int8_t* comb,
                              int R, int E, int L, int q, int max_mm, int32_t* best_t,
                              int32_t* mm, uint8_t* ok, const uint8_t* valid,
                              int32_t* rec, int cap,
                              unsigned long long* count, uint32_t* scratch,
                              cudaStream_t stream) {
  if (R <= 0 || E <= 0 || L < 1 || L > MAX_L || q < 0 || q >= L)
    return int(cudaErrorInvalidValue);
  if (best_t ? !(mm && ok) : !(valid && rec && count && cap >= 0))
    return int(cudaErrorInvalidValue);
  const Out out{best_t, mm, ok, valid, rec, cap, count};
  auto go = L <= SMALL_L      ? launch<4, OneHots>
            : L <= FAST_MAX_L ? launch<S_MAX, OneHots>
            : tiles(L).stream ? launch<S_MAX, StreamedCodes>
                              : launch<S_MAX, ShiftCodes>;
  return go(reads, lengths, flank_l, comb, R, E, L, q, max_mm, out, scratch,
            stream);
}

extern "C" const char* realign_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}
