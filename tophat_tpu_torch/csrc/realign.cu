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
// Design (fast path, L <= 256): mma.sync.m16n8k32 s8 -> s32 on the
// tensor cores, 0/1 products summed in int32 (exact). mma.sync and not
// wgmma because the B operand moves every split: the window starts at
// byte 8 (L - t), which is 4-byte but not 16-byte aligned, and an
// m16n8k32 B fragment is two 32-bit words of 4 consecutive K bytes each,
// so it loads as plain shared-memory words at any t, where wgmma's
// descriptors and ldmatrix need 16-byte aligned rows. The cost: mma.sync
// peaks near 1,280 TOP/s on an H100 SXM (scripts/mma_sync_peak.cu), two
// thirds of the bound's rate.
//  - Operands: reads carry 64 and targets 4 in the byte of their code, so
//    a match adds 256. A small prep kernel writes every event's target
//    [flankL | comb] as one-hots, zero-padded on both sides, into the
//    device scratch buffer. A block builds its rows' one-hots once per row
//    tile in shared memory, in fragment order (one 16-byte load a lane
//    per K step, a warp reading 512 contiguous bytes), and copies the
//    event tiles' targets in by cp.async, double-buffered: the next tile
//    loads while this one computes. The event stride is 8 words mod 32,
//    so the 16 lanes of each half of a 64-bit B load hit 32 banks.
//  - Warps: a block holds BR = 16 WR rows and BE = 8 WE events; each of
//    its WR x WE warps owns 16 rows x 8 events, i.e. one m16n8 tile.
//  - Splits of one phase (t mod 4) are taken S at a time: t0, t0 + 4,
//    ..., t0 + 4 (S - 1). The window of split t0 + 4 s at K step kk is the
//    window of t0 at K step kk - s, so one B fragment loaded from shared
//    memory feeds S products, and one A fragment (reloaded per K step)
//    feeds S products too: shared-memory traffic is 24 bytes a lane per
//    S products. S = 8 above L = 64; S = 4 at or below, where a group
//    has few K steps to share and the kernel fits twice on an SM.
//  - The argmin stays fused: each accumulator starts at 255 - t, so it
//    ends at 256 match + 255 - t, and its running maximum over the splits
//    is the most matches at the leftmost split. Splits above a row's
//    min(L - 1, len - 1 - q) start at -2^30 and never win; products of
//    splits above every row of the warp are not issued. The start values
//    are set in registers, not passed as the first product's C: that
//    would make a second, predicated copy of every mma, and an mma whose
//    predicate is off still holds the tensor pipe (it halved the rate).
//    Nothing per split reaches device memory; the epilogue writes dense
//    tables or records.
//  - Tiles per L: 8 warps (64 rows x 16 events) while the shared memory
//    fits (L up to about 200), else 4 warps (32 x 16); above 48 KB it is
//    dynamic shared memory. The grid is persistent: as many blocks as fit
//    on the SMs, each walking a contiguous run of (row tile, event tile)
//    units, row tile major. R = 8,192, E = 69 on 132 SMs is 128 row tiles
//    x 5 event tiles = 640 units, 4 or 5 on every SM.
//
// Wide path (L > 256): the earlier bit-plane kernel, one thread per (row,
// event) pair. Codes become bit planes (3 code bits + a validity bit, one
// bit per position, NW = ceil(L/32) words) in a device scratch buffer
// (rows as [plane][word][row]; events zero-padded on both sides), and one
// split costs a few funnel shifts, XORs and popcounts per word. Event
// tiles are folded into grid.x, so neither path caps the event count
// other than by int32 sizes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int FAST_MAX_L = 256;
constexpr int S_MAX = 8;           // splits of one phase per group, at most
constexpr int SMALL_L = 64;        // widths up to this take groups of 4
constexpr int PAD_L = 4 * S_MAX;   // zero positions left of each target
constexpr int BIG = 32767;
constexpr int MAX_SMEM = 232448;   // shared memory one block may use
constexpr int BLOCK_R = 128;       // wide path: rows per block
constexpr int TILE_E = 32;         // wide path: events per block

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

// ---- fast path: int8 tensor cores (L <= FAST_MAX_L) ----------------------

// Targets as one-hots in device memory, [event][P positions][8 bytes]:
// PAD_L zero positions, flankL, comb, zeros; byte c of a position is
// B_ONE iff its code is c in 0..7. Read one-hots carry A_ONE, so one match
// adds A_ONE * B_ONE = 256 to a product.
constexpr int A_ONE = 64, B_ONE = 4;

__global__ void target_onehots_kernel(const int8_t* __restrict__ flank_l,
                                      const int8_t* __restrict__ comb, int E,
                                      int L, int P,
                                      uint2* __restrict__ tgt) {
  const size_t total = size_t(E) * P;
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < total;
       i += size_t(gridDim.x) * blockDim.x) {
    const int e = int(i / P), u = int(i % P) - PAD_L;
    const int c = u < 0 || u >= 2 * L ? -1
                  : u < L             ? flank_l[size_t(e) * L + u]
                                      : comb[size_t(e) * L + u - L];
    const uint32_t v = (c >= 0 && c < 8) ? uint32_t(B_ONE) << (8 * (c & 3))
                                         : 0u;
    tgt[i] = make_uint2(c < 4 ? v : 0u, c >= 4 ? v : 0u);
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

// One event tile's one-hot targets (BE events x P positions x 8 bytes,
// contiguous in device memory and in shared memory) by 16-byte cp.async;
// events past E are zero-filled.
__device__ __forceinline__ void load_targets(uint32_t* dst,
                                             const uint2* tgt, int e0,
                                             int BE, int E, int P) {
  const uint2* src = tgt + size_t(e0) * P;
  const int n_in = max(0, min(BE, E - e0)) * (P / 2);  // 16-byte chunks
  for (int i = threadIdx.x; i < BE * (P / 2); i += blockDim.x)
    cp_async16(dst + 4 * i, i < n_in ? src + 2 * i : tgt, i < n_in ? 16 : 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// NA splits of one phase, t0, t0 + 4, ..., t0 + 4 (NA - 1), for this
// warp's 16 rows x 8 events. The window of split t0 + 4 s at K step kk is
// the window of t0 at step kk - s, so B_J (the 8 words at 8 J past the
// window of t0) is loaded once and used by NA products; it sits in
// bw[J mod NA]. Each lane loads words 2 tig and 2 tig + 1 of a K step as
// one 64-bit word (K chunks tig and tig + 4 in the mma's order); its A
// fragment holds the same two words of rows g and g + 8, laid out in
// shared memory in fragment order (see the kernel), so the sums are
// unchanged. Accumulators start at 255 - t (or NEG where the row has no
// split t), so acc = 256 match + 255 - t and max(acc) is the most matches
// at the leftmost split.
constexpr int NEG = -(1 << 30);

template <int NA>
__device__ __forceinline__ void split_group_n(const uint4* af,
                                            const uint32_t* bj, int KS,
                                            int t0, int tm_lo, int tm_hi,
                                            int (&best)[4]) {
  int acc[NA][4];
#pragma unroll
  for (int s = 0; s < NA; ++s) {
    const int t = t0 + 4 * s;
    acc[s][0] = acc[s][1] = t <= tm_lo ? 255 - t : NEG;
    acc[s][2] = acc[s][3] = t <= tm_hi ? 255 - t : NEG;
  }
  uint2 bw[NA];
#pragma unroll
  for (int j = 1; j < NA; ++j)
    bw[NA - j] = *reinterpret_cast<const uint2*>(bj - 8 * j);
  for (int kk0 = 0; kk0 < KS; kk0 += NA) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int kk = kk0 + i;
      if (kk < KS) {
        const uint4 a = af[32 * kk];
        bw[i] = *reinterpret_cast<const uint2*>(bj + 8 * kk);
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
template <int NA>
__device__ __forceinline__ void split_group(int na, const uint4* af,
                                            const uint32_t* bj, int KS,
                                            int t0, int tm_lo, int tm_hi,
                                            int (&best)[4]) {
  if constexpr (NA > 1) {
    if (na < NA) {
      split_group<NA - 1>(na, af, bj, KS, t0, tm_lo, tm_hi, best);
      return;
    }
  }
  split_group_n<NA>(af, bj, KS, t0, tm_lo, tm_hi, best);
}

// S splits a group: 8 for wide rows; 4 for narrow ones, whose few K
// steps give a group little to share, so that two blocks fit on an SM.
template <int S>
__global__ void __launch_bounds__(256, S <= 4 ? 2 : 1)
realign_mma_kernel(const int8_t* __restrict__ reads,
                   const int32_t* __restrict__ lengths,
                   const uint2* __restrict__ tgt, int R, int E, int L,
                   int q, int max_mm, int P, int KS, int WR, int WE,
                   Out out) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int BR = 16 * WR, BE = 8 * WE;
  uint4* sA = reinterpret_cast<uint4*>(smem);   // WR x KS x 32 fragments
  uint32_t* sB = smem + BR * 8 * KS;            // 2 x BE x 2P words
  int* sLen = reinterpret_cast<int*>(sB + 2 * BE * 2 * P);  // BR

  // a persistent block: its share of the (row tile, event tile) units,
  // row tile major, so the rows' one-hots are rebuilt only when the row
  // tile changes
  const int n_ev_tiles = (E + BE - 1) / BE;
  const long long units = (long long)((R + BR - 1) / BR) * n_ev_tiles;
  const int u0 = int(units * blockIdx.x / gridDim.x);
  const int u1 = int(units * (blockIdx.x + 1) / gridDim.x);
  if (u0 >= u1) return;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wrow = warp % WR, wev = warp / WR;
  const int lr0 = 16 * wrow + g;  // this thread's rows: lr0, lr0 + 8
  const uint4* af = sA + wrow * KS * 32 + lane;  // its A fragments

  load_targets(sB, tgt, (u0 % n_ev_tiles) * BE, BE, E, P);
  int r0 = -1;
  for (int u = u0; u < u1; ++u) {
    const int buf = (u - u0) & 1;
    const int et = u % n_ev_tiles;
    if (u + 1 < u1)
      load_targets(sB + (buf ^ 1) * BE * 2 * P, tgt,
                   ((u + 1) % n_ev_tiles) * BE, BE, E, P);
    else
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    if ((u / n_ev_tiles) * BR != r0) {
      // the rows' one-hots in fragment order: lane (g, tig) of the warp
      // owning rows 16 w .. 16 w + 15 finds, at K step kk, position
      // p = 4 kk + tig of rows g and g + 8 as {row g lo, row g + 8 lo,
      // row g hi, row g + 8 hi} in sA[(w KS + kk) 32 + lane], where lo
      // and hi are the words for codes 0..3 and 4..7 (byte c & 3 set to
      // A_ONE for code c; positions >= L are zero)
      r0 = (u / n_ev_tiles) * BR;
#pragma unroll 4
      for (int f = warp; f < WR * KS; f += blockDim.x >> 5) {
        const int ra = r0 + 16 * (f / KS) + g, x = 4 * (f % KS) + tig;
        const int ca = ra < R && x < L ? reads[size_t(ra) * L + x] : -1;
        const int cb = ra + 8 < R && x < L ? reads[size_t(ra + 8) * L + x]
                                           : -1;
        const uint32_t va =
            ca >= 0 && ca < 8 ? uint32_t(A_ONE) << (8 * (ca & 3)) : 0u;
        const uint32_t vb =
            cb >= 0 && cb < 8 ? uint32_t(A_ONE) << (8 * (cb & 3)) : 0u;
        sA[f * 32 + lane] = make_uint4(ca < 4 ? va : 0u, cb < 4 ? vb : 0u,
                                       ca >= 4 ? va : 0u, cb >= 4 ? vb : 0u);
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
    // this thread's B words: event 8 wev + g of the tile, K word 2 tig
    const uint32_t* b_ev = sB + (buf * BE + 8 * wev + g) * 2 * P + 2 * tig;
    int best[4] = {-1, -1, -1, -1};

    for (int p = 1; p <= 4; ++p) {
      for (int t0 = p; t0 <= tmax; t0 += 4 * S) {
        // the splits of this phase up to tmax, at most S of them
        split_group<S>(min(S, (tmax - t0) / 4 + 1), af,
                       b_ev + 2 * (PAD_L + L - t0), KS, t0, tm_lo, tm_hi,
                       best);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + lr0 + (j >> 1) * 8;
      const int e = et * BE + 8 * wev + 2 * tig + (j & 1);
      if (r < R && e < E) {
        const bool none = best[j] < 0;
        const int len = j < 2 ? len_lo : len_hi;
        const int mm = none ? BIG : len - (best[j] >> 8);
        const int bt = none ? 0 : 255 - (best[j] & 255);
        if (out.best_t)
          emit<true>(out, r, E, e, mm, bt, max_mm);
        else
          emit<false>(out, r, E, e, mm, bt, max_mm);
      }
    }
    __syncthreads();  // every warp is done with `buf` (and the rows)
  }                   // before they are refilled
}

// ---- wide rows (L > FAST_MAX_L) -----------------------------------------

// Planes of one code word group: bit u of word w is position 32*w + u.
__device__ __forceinline__ void code_planes(const int8_t* codes, int n,
                                            int w, uint32_t& p0,
                                            uint32_t& p1, uint32_t& p2,
                                            uint32_t& v) {
  p0 = p1 = p2 = v = 0u;
  for (int b = 0; b < 32; ++b) {
    int u = 32 * w + b;
    if (u >= n) break;
    int c = codes[u];
    if (c >= 0 && c < 8) {
      v |= 1u << b;
      p0 |= uint32_t(c & 1) << b;
      p1 |= uint32_t((c >> 1) & 1) << b;
      p2 |= uint32_t((c >> 2) & 1) << b;
    }
  }
}

// Row planes, [plane][word][row]: word w of plane p of row r at
// (p * NW + w) * R + r.
__global__ void row_planes_kernel(const int8_t* __restrict__ reads, int R,
                                  int L, int NW, uint32_t* __restrict__ out) {
  const size_t total = size_t(R) * NW;
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < total;
       i += size_t(gridDim.x) * blockDim.x) {
    const int r = int(i % R), w = int(i / R);
    uint32_t p0, p1, p2, v;
    code_planes(reads + size_t(r) * L, L, w, p0, p1, p2, v);
    out[(0 * size_t(NW) + w) * R + r] = p0;
    out[(1 * size_t(NW) + w) * R + r] = p1;
    out[(2 * size_t(NW) + w) * R + r] = p2;
    out[(3 * size_t(NW) + w) * R + r] = v;
  }
}

// Event planes, [event][side][plane][3 NW], data words at [NW, 2NW) and
// zeros around them.
__global__ void event_planes_kernel(const int8_t* __restrict__ flank_l,
                                    const int8_t* __restrict__ comb, int E,
                                    int L, int NW,
                                    uint32_t* __restrict__ out) {
  const int SW = 3 * NW;
  const size_t total = size_t(E) * 2 * SW;
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < total;
       i += size_t(gridDim.x) * blockDim.x) {
    const int e = int(i / (2 * SW));
    const int s = int((i / SW) % 2);
    const int w = int(i % SW) - NW;
    uint32_t p0 = 0u, p1 = 0u, p2 = 0u, v = 0u;
    if (w >= 0 && w < NW)
      code_planes((s == 0 ? flank_l : comb) + size_t(e) * L, L, w, p0, p1,
                  p2, v);
    uint32_t* dst = out + (size_t(e) * 2 + s) * 4 * SW + (w + NW);
    dst[0 * SW] = p0;
    dst[1 * SW] = p1;
    dst[2 * SW] = p2;
    dst[3 * SW] = v;
  }
}

template <bool DENSE>
__global__ void __launch_bounds__(BLOCK_R)
realign_wide_kernel(const uint32_t* __restrict__ rpl,
                    const int32_t* __restrict__ lengths,
                    const uint32_t* __restrict__ epl, int R, int E, int L,
                    int NW, int q, int max_mm, int n_row_blocks, Out out) {
  const int SW = 3 * NW;
  const int r = (blockIdx.x % n_row_blocks) * BLOCK_R + threadIdx.x;
  const int e0 = (blockIdx.x / n_row_blocks) * TILE_E;
  const int ne = min(TILE_E, E - e0);
  if (r >= R) return;
  const int len = lengths[r];
  const uint32_t* rp0 = rpl + r;
  const uint32_t* rp1 = rp0 + size_t(NW) * R;
  const uint32_t* rp2 = rp1 + size_t(NW) * R;
  const uint32_t* rv = rp2 + size_t(NW) * R;

  for (int e = 0; e < ne; ++e) {
    const uint32_t* pl = epl + size_t(e0 + e) * 2 * 4 * SW;
    const uint32_t* pc = pl + 4 * SW;
    int best = BIG;
    int bt = 0;
    for (int t = 1; t < L && t + q <= len - 1; ++t) {
      // prefix: flankL shifted right by L - t lines flankL[L - t + u] up
      // with read position u; suffix: comb shifted left by t lines
      // comb[u - t] up with u
      const int s = L - t;
      const int ws = NW + (s >> 5), bs = s & 31;
      const int wt = NW - (t >> 5), bl = t & 31;
      int match = 0;
      for (int w = 0; w < NW; ++w) {
        const size_t rw = size_t(w) * R;
        const uint32_t x0 = rp0[rw], x1 = rp1[rw], x2 = rp2[rw], xv = rv[rw];
        const int i = ws + w, j = wt + w;
        uint32_t a0 = __funnelshift_r(pl[i], pl[i + 1], bs);
        uint32_t a1 = __funnelshift_r(pl[SW + i], pl[SW + i + 1], bs);
        uint32_t a2 = __funnelshift_r(pl[2 * SW + i], pl[2 * SW + i + 1], bs);
        uint32_t av = __funnelshift_r(pl[3 * SW + i], pl[3 * SW + i + 1], bs);
        match += __popc(xv & av & ~((x0 ^ a0) | (x1 ^ a1) | (x2 ^ a2)));
        uint32_t c0 = __funnelshift_l(pc[j - 1], pc[j], bl);
        uint32_t c1 = __funnelshift_l(pc[SW + j - 1], pc[SW + j], bl);
        uint32_t c2 = __funnelshift_l(pc[2 * SW + j - 1], pc[2 * SW + j], bl);
        uint32_t cv = __funnelshift_l(pc[3 * SW + j - 1], pc[3 * SW + j], bl);
        match += __popc(xv & cv & ~((x0 ^ c0) | (x1 ^ c1) | (x2 ^ c2)));
      }
      const int mm = len - match;  // (t - matchL) + ((len - t) - matchC)
      if (mm < best) {
        best = mm;
        bt = t;
      }
    }
    emit<DENSE>(out, r, E, e0 + e, best, bt, max_mm);
  }
}

// Fast-path layout for width L: P target positions (>= PAD_L + 2L + 4,
// = 4 mod 16, so an event's stride is 8 words mod 32), K steps, warps
// along rows (WR) and events (WE), and the dynamic shared memory bytes.
struct FastTiles {
  int P, KS, WR, WE;
  size_t smem;
};

FastTiles fast_tiles(int L) {
  FastTiles f;
  f.P = PAD_L + 2 * L + 4;
  f.P += ((4 - f.P) % 16 + 16) % 16;
  f.KS = (L + 3) / 4;
  f.WE = 2;
  for (f.WR = 4; f.WR >= 1; f.WR /= 2) {
    f.smem = size_t(16 * f.WR) * (8 * f.KS + 1) * 4 +
             size_t(2) * 8 * f.WE * 2 * f.P * 4;
    if (f.smem <= MAX_SMEM) break;
  }
  return f;
}

int launch_fast(const int8_t* reads, const int32_t* lengths,
                const int8_t* flank_l, const int8_t* comb, int R, int E,
                int L, int q, int max_mm, const Out& out, uint32_t* scratch,
                cudaStream_t stream) {
  const FastTiles f = fast_tiles(L);
  if (f.WR < 1 || (uintptr_t(scratch) & 15))
    return int(cudaErrorInvalidValue);
  uint2* tgt = reinterpret_cast<uint2*>(scratch);
  const long long prep_blocks = (2LL * E * f.P + 255) / 256;
  target_onehots_kernel<<<unsigned(prep_blocks < 1024 ? prep_blocks : 1024),
                          256, 0, stream>>>(flank_l, comb, E, L, f.P, tgt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  auto kernel = L <= SMALL_L ? realign_mma_kernel<4> : realign_mma_kernel<8>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(f.smem));
  if (err != cudaSuccess) return int(err);
  // one persistent block per resident slot: as many as fit on the SMs
  int dev = 0, n_sm = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const int threads = 32 * f.WR * f.WE;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                f.smem);
  const long long units = (long long)((R + 16 * f.WR - 1) / (16 * f.WR)) *
                          ((E + 8 * f.WE - 1) / (8 * f.WE));
  if (units > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const long long slots = (long long)n_sm * (per_sm > 0 ? per_sm : 1);
  kernel<<<unsigned(units < slots ? units : slots), threads, f.smem,
           stream>>>(reads, lengths, tgt, R, E, L, q, max_mm, f.P, f.KS, f.WR,
                     f.WE, out);
  return int(cudaGetLastError());
}

int launch_wide(const int8_t* reads, const int32_t* lengths,
                const int8_t* flank_l, const int8_t* comb, int R, int E,
                int L, int q, int max_mm, const Out& out, uint32_t* scratch,
                cudaStream_t stream) {
  const int n_row_blocks = (R + BLOCK_R - 1) / BLOCK_R;
  const long long blocks =
      (long long)n_row_blocks * ((E + TILE_E - 1) / TILE_E);
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const int NW = (L + 31) / 32;
  uint32_t* rpl = scratch;
  uint32_t* epl = scratch + size_t(4) * NW * R;
  row_planes_kernel<<<1024, 256, 0, stream>>>(reads, R, L, NW, rpl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  event_planes_kernel<<<1024, 256, 0, stream>>>(flank_l, comb, E, L, NW, epl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  auto kernel = out.best_t ? realign_wide_kernel<true>
                           : realign_wide_kernel<false>;
  kernel<<<unsigned(blocks), BLOCK_R, 0, stream>>>(
      rpl, lengths, epl, R, E, L, NW, q, max_mm, n_row_blocks, out);
  return int(cudaGetLastError());
}

}  // namespace

// uint32 words of device scratch realign_launch needs: the one-hot
// targets on the fast path, the bit planes on the wide path.
extern "C" long long realign_scratch_words(int R, int E, int L) {
  if (L <= FAST_MAX_L) return 2LL * E * fast_tiles(L).P;
  const long long NW = (L + 31) / 32;
  return 4 * NW * R + 2LL * 4 * 3 * NW * E;
}

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
  if (R <= 0 || E <= 0 || L < 1 || q < 0 || q >= L)
    return int(cudaErrorInvalidValue);
  if (best_t ? !(mm && ok) : !(valid && rec && count && cap >= 0))
    return int(cudaErrorInvalidValue);
  const Out out{best_t, mm, ok, valid, rec, cap, count};
  if (L <= FAST_MAX_L)
    return launch_fast(reads, lengths, flank_l, comb, R, E, L, q, max_mm, out,
                       scratch, stream);
  return launch_wide(reads, lengths, flank_l, comb, R, E, L, q, max_mm, out,
                     scratch, stream);
}

extern "C" const char* realign_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}
