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
// byte compares. One thread per (row, event) pair keeps its row's planes
// in registers; a block of BLOCK_R rows shares a tile of TILE_E events
// whose planes sit in shared memory, read as warp-wide broadcasts (every
// thread of a block uses the same event and split at the same time). The
// argmin and the max_mm threshold are fused into the split loop. Tensor
// cores and TMA are not used yet.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_L = 256;
constexpr int MAX_W = MAX_L / 32;
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

template <int NW>
__global__ void __launch_bounds__(BLOCK_R)
realign_kernel(const int8_t* __restrict__ reads,
               const int32_t* __restrict__ lengths,
               const int8_t* __restrict__ flank_l,
               const int8_t* __restrict__ comb, int R, int E, int L, int q,
               int max_mm, int32_t* __restrict__ best_t_out,
               int32_t* __restrict__ mm_out, uint8_t* __restrict__ ok_out) {
  // per event: [seq L | seq C] x [p0 p1 p2 v] x SW words; data words sit
  // at [NW, 2NW), zero pads on both sides absorb every shifted access
  constexpr int SW = 3 * NW;
  __shared__ uint32_t tgt[TILE_E][2][4][SW];

  const int e0 = blockIdx.y * TILE_E;
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

  const int r = blockIdx.x * BLOCK_R + threadIdx.x;
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
    const bool ok = best <= max_mm;
    const size_t o = size_t(r) * E + (e0 + e);
    best_t_out[o] = bt;
    mm_out[o] = ok ? best : BIG;
    ok_out[o] = ok ? 1 : 0;
  }
}

using Kernel = void (*)(const int8_t*, const int32_t*, const int8_t*,
                       const int8_t*, int, int, int, int, int, int32_t*,
                       int32_t*, uint8_t*);
// one instance per row width in 32-position words (NW = 1..MAX_W)
const Kernel kKernels[MAX_W] = {
    realign_kernel<1>, realign_kernel<2>, realign_kernel<3>,
    realign_kernel<4>, realign_kernel<5>, realign_kernel<6>,
    realign_kernel<7>, realign_kernel<8>};

}  // namespace

extern "C" int realign_max_len() { return MAX_L; }

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int realign_launch(const int8_t* reads, const int32_t* lengths,
                              const int8_t* flank_l, const int8_t* comb,
                              int R, int E, int L, int q, int max_mm,
                              int32_t* best_t, int32_t* mm, uint8_t* ok,
                              cudaStream_t stream) {
  if (R <= 0 || E <= 0 || L < 1 || L > MAX_L || q < 0 || q >= L ||
      (E + TILE_E - 1) / TILE_E > 65535)  // grid.y limit
    return int(cudaErrorInvalidValue);
  dim3 grid((R + BLOCK_R - 1) / BLOCK_R, (E + TILE_E - 1) / TILE_E);
  kKernels[(L + 31) / 32 - 1]<<<grid, BLOCK_R, 0, stream>>>(
      reads, lengths, flank_l, comb, R, E, L, q, max_mm, best_t, mm, ok);
  return int(cudaGetLastError());
}

extern "C" const char* realign_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}
