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
// ok = mm <= max_mm. Rows with no interior split give best_t 0, mm 32767,
// ok 0. Two epilogues: dense (R, E) tables, or sparse records (row, event,
// best_t, mm) of the ok pairs of valid events, appended with an atomic
// counter (the wrapper sorts them; it relaunches if `cap` was too small).
//
// What bounds it: one split is one product. With reads and targets as
// 8-channel one-hots (K = 8 L bytes a row), match(t) is the dot product of
// the read row with the K-byte window of the event's target that starts
// at byte 8 (L - t). So the work is 2 * R * E * (#splits) * 8 L integer
// operations, at the int8 tensor-core peak (1,979 TOP/s on an H100 SXM);
// the bytes (reads, targets, results) are small beside it.
//
// Design: one kernel, realign_mma_kernel<S, Op>, for every width L up to
// WIDE_MAX_L = 4,096; Op says how its operands sit in shared memory
// (OneHots for L <= 256, ShiftCodes above). mma.sync.m16n8k32 s8 -> s32
// on the tensor cores, 0/1 products summed in int32 (exact). mma.sync and
// not wgmma because the B operand moves every split: the window starts at
// position L - t, which is 4-byte but not 16-byte aligned, and an
// m16n8k32 B fragment is two 32-bit words of 4 consecutive K bytes each,
// which a lane loads (or builds in registers) itself at any t, where
// wgmma's descriptors and ldmatrix need 16-byte aligned rows. The cost:
// mma.sync peaks near 1,280 TOP/s on an H100 SXM
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
//    the second, 0xff in neither): about a dozen integer instructions a K
//    step beside the S products they feed. The whole row tile (one 16-bit
//    word a lane per K step: rows g and g + 8) and two whole event tiles
//    (P = 16 mod 128 bytes an event, so the 8 events of a warp's byte
//    loads hit distinct banks) sit in shared memory, the next event tile
//    loading by cp.async as on the fast path; no window needs streaming:
//    at L = 4,096 a 16 x 8 tile takes 199 KB. Shift codes would serve
//    every width, but at L <= 256 they took 18-29% longer than one-hots
//    (3% at L = 150; scripts/realign_ab.py on an NVIDIA H100 80GB HBM3 at
//    700 W, PERF.md section 6), so one-hots keep those widths.
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
//  - The argmin stays fused: each accumulator starts at T - t, so it ends
//    at 2^SHIFT match + T - t, and its running maximum over the splits is
//    the most matches at the leftmost split (T = 255, SHIFT = 8 for
//    one-hots; T = 4,095, SHIFT = 12 for shift codes, where a match adds
//    ONE^2 = 4,096: that caps L at 4,096, and wider rows are refused, by
//    the wrapper with ValueError and here with cudaErrorInvalidValue).
//    Splits above a row's min(L - 1, len - 1 - q) start at -2^30 and
//    never win; products of splits above every row of the warp are not
//    issued. The start values are set in registers, not passed as the
//    first product's C: that would make a second, predicated copy of
//    every mma, and an mma whose predicate is off still holds the tensor
//    pipe (it halved the rate). Nothing per split reaches device memory;
//    the epilogue writes dense tables or records.
//  - Tiles per L: one-hots take 8 warps (64 rows x 16 events) while the
//    shared memory fits (L up to 216), else 4 warps (32 x 16); shift
//    codes 64 x 16 up to L = 1,783, then 16 x 16 (to 2,871) and 16 x 8
//    (one warp a block: rows that wide are left untuned); above 48 KB it
//    is dynamic shared memory. The grid is
//    persistent: as many blocks as fit on the SMs, each walking a
//    contiguous run of (row tile, event tile) units, row tile major, so
//    the event count is capped only by int32 sizes. R = 8,192, E = 69 on
//    132 SMs is 128 row tiles x 5 event tiles = 640 units, 4 or 5 on
//    every SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int FAST_MAX_L = 256;
constexpr int WIDE_MAX_L = 4096;   // widest row any path takes
constexpr int S_MAX = 8;           // splits of one phase per group, at most
constexpr int SMALL_L = 64;        // widths up to this take groups of 4
constexpr int PAD_L = 4 * S_MAX;   // empty positions left of each target
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
  int32_t* count;       // sparse: records found (may exceed cap)
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
    const int i = atomicAdd(out.count, 1);
    if (i < out.cap) {
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

// ---- operands ------------------------------------------------------------
// Each Op gives: A, the row tile's element (one a lane per K step, in
// fragment order: rows g and g + 8 at position 4 kk + tig); B, the
// targets' element, PER_POS of them a position; a(af, kk), the A
// fragment {row g codes 0..3, row g + 8 codes 0..3, row g codes 4..7,
// row g + 8 codes 4..7} of K step kk; b(bj, J), the B fragment {codes
// 0..3, codes 4..7} of this lane's event at position 4 J + tig past the
// window; row(ca, cb), the A element of codes ca (row g) and cb (row
// g + 8); target(c), one target position; and the argmin packing, a
// match adding 2^SHIFT and a split t starting at T - t.

struct OneHots {                  // L <= 256: 8 bytes a position
  using A = uint4;
  using B = uint32_t;
  static constexpr int PER_POS = 2, SHIFT = 8, T = 255;
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
  static constexpr int PER_POS = 1, SHIFT = 12, T = WIDE_MAX_L - 1;
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
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// NA splits of one phase, t0, t0 + 4, ..., t0 + 4 (NA - 1), for this
// warp's 16 rows x 8 events. The window of split t0 + 4 s at K step kk is
// the window of t0 at step kk - s, so B_J (the fragment at K step J past
// the window of t0) is loaded once and used by NA products; it sits in
// bw[J mod NA]. Accumulators start at T - t (or NEG where the row has no
// split t), so acc = 2^SHIFT match + T - t and max(acc) is the most
// matches at the leftmost split.
template <int NA, class Op>
__device__ __forceinline__ void split_group_n(const typename Op::A* af,
                                              const typename Op::B* bj,
                                              int KS, int t0, int tm_lo,
                                              int tm_hi, int (&best)[4]) {
  int acc[NA][4];
#pragma unroll
  for (int s = 0; s < NA; ++s) {
    const int t = t0 + 4 * s;
    acc[s][0] = acc[s][1] = t <= tm_lo ? Op::T - t : NEG;
    acc[s][2] = acc[s][3] = t <= tm_hi ? Op::T - t : NEG;
  }
  uint2 bw[NA];
#pragma unroll
  for (int j = 1; j < NA; ++j) bw[NA - j] = Op::b(bj, -j);
  for (int kk0 = 0; kk0 < KS; kk0 += NA) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int kk = kk0 + i;
      if (kk < KS) {
        const uint4 a = Op::a(af, kk);
        bw[i] = Op::b(bj, kk);
#pragma unroll
        for (int s = 0; s < NA; ++s)
          mma_s8(acc[s], a, bw[(i - s + NA) % NA]);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < NA; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j) best[j] = max(best[j], acc[s][j]);
}

// split_group_n<na> for a run-time na <= NA.
template <int NA, class Op>
__device__ __forceinline__ void split_group(int na, const typename Op::A* af,
                                            const typename Op::B* bj, int KS,
                                            int t0, int tm_lo, int tm_hi,
                                            int (&best)[4]) {
  if constexpr (NA > 1) {
    if (na < NA) {
      split_group<NA - 1, Op>(na, af, bj, KS, t0, tm_lo, tm_hi, best);
      return;
    }
  }
  split_group_n<NA, Op>(af, bj, KS, t0, tm_lo, tm_hi, best);
}

// S splits a group: 8 for wide rows; 4 for narrow ones, whose few K
// steps give a group little to share, so that two blocks fit on an SM.
// Warps: WR along rows, WE along events.
template <int S, class Op>
__global__ void __launch_bounds__(256, S <= 4 || Op::PER_POS == 1 ? 2 : 1)
realign_mma_kernel(const int8_t* __restrict__ reads,
                   const int32_t* __restrict__ lengths,
                   const typename Op::B* __restrict__ tgt, int R, int E,
                   int L, int q, int max_mm, int P, int KS, int WR, int WE,
                   Out out) {
  using A = typename Op::A;
  using B = typename Op::B;
  extern __shared__ __align__(16) uint32_t smem[];
  const int BR = 16 * WR, BE = 8 * WE;
  const int tile = BE * P * Op::PER_POS;          // B elements a tile
  B* sB = reinterpret_cast<B*>(smem);             // 2 tiles
  A* sA = reinterpret_cast<A*>(sB + 2 * tile);    // WR x KS x 32
  int* sLen = reinterpret_cast<int*>(sA + WR * KS * 32);  // BR

  // a persistent block: its share of the (row tile, event tile) units,
  // row tile major, so the rows are rebuilt only when the row tile
  // changes
  const int n_ev_tiles = (E + BE - 1) / BE;
  const long long units = (long long)((R + BR - 1) / BR) * n_ev_tiles;
  const int u0 = int(units * blockIdx.x / gridDim.x);
  const int u1 = int(units * (blockIdx.x + 1) / gridDim.x);
  if (u0 >= u1) return;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wrow = warp % WR, wev = warp / WR;
  const int lr0 = 16 * wrow + g;  // this thread's rows: lr0, lr0 + 8
  const A* af = sA + wrow * KS * 32 + lane;  // its A fragments

  load_targets<Op>(sB, tgt, (u0 % n_ev_tiles) * BE, BE, E, P);
  int r0 = -1;
  for (int u = u0; u < u1; ++u) {
    const int buf = (u - u0) & 1;
    const int et = u % n_ev_tiles;
    if (u + 1 < u1)
      load_targets<Op>(sB + (buf ^ 1) * tile, tgt,
                       ((u + 1) % n_ev_tiles) * BE, BE, E, P);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    if ((u / n_ev_tiles) * BR != r0) {
      // the rows in fragment order: lane (g, tig) of the warps owning
      // rows 16 w .. 16 w + 15 finds, at K step kk, position p = 4 kk +
      // tig of rows g and g + 8 in sA[(w KS + kk) 32 + lane] (positions
      // >= L are empty)
      r0 = (u / n_ev_tiles) * BR;
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

    const int len_lo = sLen[lr0], len_hi = sLen[lr0 + 8];
    const int tm_lo = min(L - 1, len_lo - 1 - q);
    const int tm_hi = min(L - 1, len_hi - 1 - q);
    const int tmax = __reduce_max_sync(0xffffffffu, max(tm_lo, tm_hi));
    // this thread's B: event 8 wev + g of the tile, position tig
    const B* b_ev = sB + buf * tile + ((8 * wev + g) * P + tig) * Op::PER_POS;
    int best[4] = {-1, -1, -1, -1};

    for (int p = 1; p <= 4; ++p) {
      for (int t0 = p; t0 <= tmax; t0 += 4 * S) {
        // the splits of this phase up to tmax, at most S of them
        split_group<S, Op>(min(S, (tmax - t0) / 4 + 1), af,
                           b_ev + (PAD_L + L - t0) * Op::PER_POS, KS, t0,
                           tm_lo, tm_hi, best);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + lr0 + (j >> 1) * 8;
      const int e = et * BE + 8 * wev + 2 * tig + (j & 1);
      if (r < R && e < E) {
        const bool none = best[j] < 0;
        const int len = j < 2 ? len_lo : len_hi;
        const int mm = none ? BIG : len - (best[j] >> Op::SHIFT);
        const int bt = none ? 0 : Op::T - (best[j] & Op::T);
        if (out.best_t)
          emit<true>(out, r, E, e, mm, bt, max_mm);
        else
          emit<false>(out, r, E, e, mm, bt, max_mm);
      }
    }
    __syncthreads();  // every warp is done with `buf` and the rows before
  }                   // they are refilled
}

// Layout for width L: P target positions an event, K steps, warps along
// rows (WR) and events (WE), dynamic shared memory bytes. One-hots: P >=
// PAD_L + 2L + 4, = 4 mod 16 (an event's stride is 8 words mod 32); 64 x
// 16, 32 x 16 or 16 x 16 rows x events. Shift codes: P >= PAD_L + 2L + 2,
// = 16 mod 128 (4 words mod 32); 64 x 16, 16 x 16 or 16 x 8. WR = 0 if
// none fits.
struct Tiles {
  int P, KS, WR, WE;
  size_t smem;
};

Tiles tiles(int L) {
  const bool fast = L <= FAST_MAX_L;
  const int pos = fast ? 8 : 1;   // target bytes a position
  const int a16 = fast ? 16 : 2;  // row-tile bytes a lane per K step
  Tiles w;
  w.P = PAD_L + 2 * L + (fast ? 4 : 2);
  w.P += fast ? ((4 - w.P) % 16 + 16) % 16 : ((16 - w.P) % 128 + 128) % 128;
  w.KS = (L + 3) / 4;
  const int shapes[2][3][2] = {{{4, 2}, {2, 2}, {1, 2}},
                               {{4, 2}, {1, 2}, {1, 1}}};
  for (const auto& s : shapes[fast ? 0 : 1]) {
    w.WR = s[0], w.WE = s[1];
    w.smem = size_t(2) * 8 * w.WE * w.P * pos +
             size_t(w.WR) * w.KS * 32 * a16 + size_t(16 * w.WR) * 4;
    if (w.smem <= MAX_SMEM) return w;
  }
  w.WR = 0;
  return w;
}

template <int S, class Op>
int launch(const int8_t* reads, const int32_t* lengths,
           const int8_t* flank_l, const int8_t* comb, int R, int E, int L,
           int q, int max_mm, const Out& out, uint32_t* scratch,
           cudaStream_t stream) {
  const Tiles w = tiles(L);
  if (w.WR < 1 || (uintptr_t(scratch) & 15))
    return int(cudaErrorInvalidValue);
  auto* tgt = reinterpret_cast<typename Op::B*>(scratch);
  const long long prep_blocks = (1LL * E * w.P + 255) / 256;
  target_kernel<Op><<<unsigned(prep_blocks < 1024 ? prep_blocks : 1024), 256,
                      0, stream>>>(flank_l, comb, E, L, w.P, tgt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
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
  if (units > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const long long slots = (long long)n_sm * (per_sm > 0 ? per_sm : 1);
  kernel<<<unsigned(units < slots ? units : slots), threads, w.smem,
           stream>>>(reads, lengths, tgt, R, E, L, q, max_mm, w.P, w.KS, w.WR,
                     w.WE, out);
  return int(cudaGetLastError());
}

}  // namespace

// uint32 words of device scratch realign_launch needs: the targets, as
// one-hots (8 bytes a position) up to L = 256, else shift codes (1 byte).
extern "C" long long realign_scratch_words(int R, int E, int L) {
  return 1LL * E * tiles(L).P * (L <= FAST_MAX_L ? 8 : 1) / 4;
}

// The widest row realign_launch takes.
extern "C" int realign_max_width() { return WIDE_MAX_L; }

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// `scratch` holds realign_scratch_words(R, E, L) words, 16-byte aligned.
// Dense mode when best_t is not null, else sparse mode: records
// of ok pairs of valid events into rec (4 x cap int32), their number
// (which may exceed cap) into *count, which the caller zeroes.
extern "C" int realign_launch(const int8_t* reads, const int32_t* lengths,
                              const int8_t* flank_l, const int8_t* comb,
                              int R, int E, int L, int q, int max_mm, int32_t* best_t,
                              int32_t* mm, uint8_t* ok, const uint8_t* valid,
                              int32_t* rec, int cap, int32_t* count,
                              uint32_t* scratch, cudaStream_t stream) {
  if (R <= 0 || E <= 0 || L < 1 || L > WIDE_MAX_L || q < 0 || q >= L)
    return int(cudaErrorInvalidValue);
  if (best_t ? !(mm && ok) : !(valid && rec && count && cap >= 0))
    return int(cudaErrorInvalidValue);
  const Out out{best_t, mm, ok, valid, rec, cap, count};
  auto go = L <= SMALL_L     ? launch<4, OneHots>
            : L <= FAST_MAX_L ? launch<S_MAX, OneHots>
                              : launch<S_MAX, ShiftCodes>;
  return go(reads, lengths, flank_l, comb, R, E, L, q, max_mm, out, scratch,
            stream);
}

extern "C" const char* realign_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}
