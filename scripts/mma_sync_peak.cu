// Peak rate of mma.sync.m16n8k32 s8 -> s32 on this card: a loop of 8
// independent products per warp (no memory traffic), at 1, 2, 4 and 8
// warps per SM sub-partition. The ceiling of the realign kernel's design
// (tophat_tpu_torch/csrc/realign.cu), beside the int8 peak of wgmma.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o /tmp/mma_sync_peak \
//       scripts/mma_sync_peak.cu && /tmp/mma_sync_peak
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

template <int CH>
__global__ void bench(int iters, int* out) {
  int acc[CH][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  uint32_t b[2] = {threadIdx.x ^ 5u, 11u};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < CH; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+r"(acc[c][0]), "+r"(acc[c][1]), "+r"(acc[c][2]),
            "+r"(acc[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  int s = 0;
  for (int c = 0; c < CH; ++c)
    s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

int main() {
  int* out;
  if (cudaMalloc(&out, 1 << 26) != cudaSuccess) return 1;
  int nsm = 0;
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, 0);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  const int iters = 4096;
  for (int warps : {4, 8, 16, 32}) {  // per SM, in blocks of 4 warps
    const int blocks = nsm * (warps / 4);
    bench<8><<<blocks, 128>>>(iters, out);  // warm-up
    cudaEventRecord(a);
    bench<8><<<blocks, 128>>>(iters, out);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms = 0.f;
    cudaEventElapsedTime(&ms, a, b);
    const double ops = double(blocks) * 4 * iters * 8 * (16.0 * 8 * 32 * 2);
    printf("warps/SM %d: %.3f ms, %.1f TOP/s\n", warps, ms,
           ops / ms / 1e9);
  }
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
