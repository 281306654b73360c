// Event realignment on Hopper: best split of every read row across every
// event of one insertion-length group.
//
// Replaces the Pallas TPU kernel tophat_tpu/ops/pallas/realign_kernel.py
// (_realign_kernel via realign_pallas), which computes the same result as
// two bf16 one-hot matmuls per split point on the MXU.
//
// For row r (read codes, length len) and event e:
//   mm(t) = (t - matchL(t)) + ((len - t) - matchC(t)),  1 <= t <= len-1-q
//   matchL(t) = #{u < t      : read[u] == flankL[L - t + u]}
//   matchC(t) = #{t <= u < L : read[u] == comb[u - t]}
// where flankL ends at the event's left base, comb = [inserted seq (q) |
// right flank], and a position matches iff both codes are equal and lie in
// 0..7 (read padding -1 never matches; genome N (4) matches read N (4);
// out-of-genome flank positions carry 5 and never match). Outputs: the
// leftmost argmin best_t, mm = min (32767 if above max_mm), ok = mm <=
// max_mm. Rows with no interior split give best_t 0, mm 32767, ok 0.
//
// What bounds it: integer ALU work, O(R * E * L * L/32) word operations;
// the inputs (R*L + 2*E*L bytes) and outputs (9 bytes per pair) are small
// next to that. Design: codes become bit planes (3 code bits + a validity
// bit, one bit per position, NW = ceil(L/32) words), so one split point
// costs a few funnel shifts, XORs and popcounts per word instead of L
// byte compares. One thread per (row, event) pair; a block of BLOCK_R rows
// walks a tile of TILE_E events, reading the event planes as warp-wide
// broadcasts (every thread of a block uses the same event and split at the
// same time). The argmin and the max_mm threshold are fused into the split
// loop. Tensor cores and TMA are not used yet.
//
// Two paths, one result:
//  - fast (L <= FAST_MAX_L = 256, NW <= 8): NW is a template parameter, the
//    row's planes sit in registers and the event tile's planes in static
//    shared memory (3,072 * NW bytes, at most 24 KB).
//  - wide (any L > 256): register arrays of 4 * NW words would spill and the
//    event tile would outgrow static shared memory, so two small kernels
//    first write the planes to a scratch buffer in device memory (rows as
//    [plane][word][row], coalesced across a warp; events zero-padded as in
//    the fast path's tile), and the split loop runs over NW at run time.
// Event tiles are folded into grid.x (row blocks fastest), so neither path
// has a cap on the event count other than the int32 sizes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int FAST_MAX_L = 256;
constexpr int FAST_MAX_W = FAST_MAX_L / 32;
constexpr int BLOCK_R = 128;
constexpr int TILE_E = 32;
constexpr int BIG = 32767;

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

__device__ __forceinline__ void store_result(int r, int E, int e, int best,
                                             int bt, int max_mm,
                                             int32_t* best_t_out,
                                             int32_t* mm_out,
                                             uint8_t* ok_out) {
  const bool ok = best <= max_mm;
  const size_t o = size_t(r) * E + e;
  best_t_out[o] = bt;
  mm_out[o] = ok ? best : BIG;
  ok_out[o] = ok ? 1 : 0;
}

template <int NW>
__global__ void __launch_bounds__(BLOCK_R)
realign_kernel(const int8_t* __restrict__ reads,
               const int32_t* __restrict__ lengths,
               const int8_t* __restrict__ flank_l,
               const int8_t* __restrict__ comb, int R, int E, int L, int q,
               int max_mm, int n_row_blocks, int32_t* __restrict__ best_t_out,
               int32_t* __restrict__ mm_out, uint8_t* __restrict__ ok_out) {
  // per event: [seq L | seq C] x [p0 p1 p2 v] x SW words; data words sit
  // at [NW, 2NW), zero pads on both sides absorb every shifted access
  constexpr int SW = 3 * NW;
  __shared__ uint32_t tgt[TILE_E][2][4][SW];

  const int row_block = blockIdx.x % n_row_blocks;
  const int e0 = (blockIdx.x / n_row_blocks) * TILE_E;
  const int ne = min(TILE_E, E - e0);
  for (int task = threadIdx.x; task < TILE_E * 2 * SW; task += blockDim.x) {
    int e = task / (2 * SW);
    int s = (task / SW) % 2;
    int w = task % SW - NW;
    uint32_t p0 = 0u, p1 = 0u, p2 = 0u, v = 0u;
    if (e < ne && w >= 0 && w < NW) {
      const int8_t* src = (s == 0 ? flank_l : comb) + size_t(e0 + e) * L;
      code_planes(src, L, w, p0, p1, p2, v);
    }
    tgt[e][s][0][w + NW] = p0;
    tgt[e][s][1][w + NW] = p1;
    tgt[e][s][2][w + NW] = p2;
    tgt[e][s][3][w + NW] = v;
  }
  __syncthreads();

  const int r = row_block * BLOCK_R + threadIdx.x;
  if (r >= R) return;
  const int len = lengths[r];
  uint32_t rp0[NW], rp1[NW], rp2[NW], rv[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w)
    code_planes(reads + size_t(r) * L, L, w, rp0[w], rp1[w], rp2[w], rv[w]);

  for (int e = 0; e < ne; ++e) {
    const uint32_t(*pl)[SW] = tgt[e][0];
    const uint32_t(*pc)[SW] = tgt[e][1];
    int best = BIG;
    int bt = 0;
    for (int t = 1; t < L && t + q <= len - 1; ++t) {
      // prefix: flankL shifted right by L - t lines flankL[L - t + u] up
      // with read position u (zero past u = t - 1)
      const int s = L - t;
      const int ws = NW + (s >> 5), bs = s & 31;
      // suffix: comb shifted left by t lines comb[u - t] up with u
      const int wt = NW - (t >> 5), bl = t & 31;
      int match = 0;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        uint32_t a0 = __funnelshift_r(pl[0][ws + w], pl[0][ws + w + 1], bs);
        uint32_t a1 = __funnelshift_r(pl[1][ws + w], pl[1][ws + w + 1], bs);
        uint32_t a2 = __funnelshift_r(pl[2][ws + w], pl[2][ws + w + 1], bs);
        uint32_t av = __funnelshift_r(pl[3][ws + w], pl[3][ws + w + 1], bs);
        match += __popc(rv[w] & av &
                        ~((rp0[w] ^ a0) | (rp1[w] ^ a1) | (rp2[w] ^ a2)));
        uint32_t c0 = __funnelshift_l(pc[0][wt + w - 1], pc[0][wt + w], bl);
        uint32_t c1 = __funnelshift_l(pc[1][wt + w - 1], pc[1][wt + w], bl);
        uint32_t c2 = __funnelshift_l(pc[2][wt + w - 1], pc[2][wt + w], bl);
        uint32_t cv = __funnelshift_l(pc[3][wt + w - 1], pc[3][wt + w], bl);
        match += __popc(rv[w] & cv &
                        ~((rp0[w] ^ c0) | (rp1[w] ^ c1) | (rp2[w] ^ c2)));
      }
      const int mm = len - match;  // (t - matchL) + ((len - t) - matchC)
      if (mm < best) {
        best = mm;
        bt = t;
      }
    }
    store_result(r, E, e0 + e, best, bt, max_mm, best_t_out, mm_out, ok_out);
  }
}

// ---- wide rows (L > FAST_MAX_L) -----------------------------------------

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
// zeros around them (the fast path's tile layout, in device memory).
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

__global__ void __launch_bounds__(BLOCK_R)
realign_wide_kernel(const uint32_t* __restrict__ rpl,
                    const int32_t* __restrict__ lengths,
                    const uint32_t* __restrict__ epl, int R, int E, int L,
                    int NW, int q, int max_mm, int n_row_blocks,
                    int32_t* __restrict__ best_t_out,
                    int32_t* __restrict__ mm_out,
                    uint8_t* __restrict__ ok_out) {
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
      const int mm = len - match;
      if (mm < best) {
        best = mm;
        bt = t;
      }
    }
    store_result(r, E, e0 + e, best, bt, max_mm, best_t_out, mm_out, ok_out);
  }
}

using Kernel = void (*)(const int8_t*, const int32_t*, const int8_t*,
                       const int8_t*, int, int, int, int, int, int, int32_t*,
                       int32_t*, uint8_t*);
// one fast instance per row width in 32-position words (NW = 1..8)
const Kernel kKernels[FAST_MAX_W] = {
    realign_kernel<1>, realign_kernel<2>, realign_kernel<3>,
    realign_kernel<4>, realign_kernel<5>, realign_kernel<6>,
    realign_kernel<7>, realign_kernel<8>};

}  // namespace

// uint32 words of device scratch realign_launch needs (0 on the fast path).
extern "C" long long realign_scratch_words(int R, int E, int L) {
  if (L <= FAST_MAX_L) return 0;
  const long long NW = (L + 31) / 32;
  return 4 * NW * R + 2LL * 4 * 3 * NW * E;
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
// `scratch` holds realign_scratch_words(R, E, L) words (unused when 0).
extern "C" int realign_launch(const int8_t* reads, const int32_t* lengths,
                              const int8_t* flank_l, const int8_t* comb,
                              int R, int E, int L, int q, int max_mm,
                              int32_t* best_t, int32_t* mm, uint8_t* ok,
                              uint32_t* scratch, cudaStream_t stream) {
  if (R <= 0 || E <= 0 || L < 1 || q < 0 || q >= L)
    return int(cudaErrorInvalidValue);
  const int n_row_blocks = (R + BLOCK_R - 1) / BLOCK_R;
  const long long blocks =
      (long long)n_row_blocks * ((E + TILE_E - 1) / TILE_E);
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const int NW = (L + 31) / 32;
  if (L <= FAST_MAX_L) {
    kKernels[NW - 1]<<<unsigned(blocks), BLOCK_R, 0, stream>>>(
        reads, lengths, flank_l, comb, R, E, L, q, max_mm, n_row_blocks,
        best_t, mm, ok);
    return int(cudaGetLastError());
  }
  uint32_t* rpl = scratch;
  uint32_t* epl = scratch + size_t(4) * NW * R;
  row_planes_kernel<<<1024, 256, 0, stream>>>(reads, R, L, NW, rpl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  event_planes_kernel<<<1024, 256, 0, stream>>>(flank_l, comb, E, L, NW, epl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  realign_wide_kernel<<<unsigned(blocks), BLOCK_R, 0, stream>>>(
      rpl, lengths, epl, R, E, L, NW, q, max_mm, n_row_blocks, best_t, mm,
      ok);
  return int(cudaGetLastError());
}

extern "C" const char* realign_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}
