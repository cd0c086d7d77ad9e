// Kernel B2: the auction's fused top-2 bid, for Hopper (sm_90a).
//
// Replaces tpu_faas/sched/pallas_kernels.py:189 bid_top2_pallas (kernel
// _bid_top2_kernel). Per task row t it computes the best value v1, its
// first argmax slot `best` and the runner-up v2 of
//
//     v[t,s] = -size[t]*inv_speed[s] + u(t,s)*jitter - price[s]
//
// (-inf where valid[s] == 0), where u is the Wang hash of the uint32 cell
// index (row_offset + t) * n_slots_total + s, shifted right by 8 and scaled
// by 2^-24. The [T, S] matrix is never built.
//
// What bounds it: operations. Each cell costs the index product, the hash
// (three shift-xor pairs and two products), the int->float conversion, the
// 2^-24 scale and four float ops, while the bytes are O(T + S): each input
// read once, three T-long outputs. The design keeps every cell in
// registers: one warp per kRows task rows, its lanes striding the slots and
// merging by shuffles (bid_top2.cuh, shared with the auction branch of the
// fused resident tick, documents the loop, the tie rules and the op order
// that makes the kernel equal its plain version bit for bit).
//
// The kernel launches on the caller's stream, does not synchronise and
// allocates nothing; the C entry returns the launch's CUDA error code.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bid_top2.cuh"

namespace {

constexpr int kWarps = 4;  // warps per block
constexpr int kRows = 4;   // task rows per warp

__global__ void __launch_bounds__(kWarps * 32)
bid_top2_kernel(const float* __restrict__ size,
                const float* __restrict__ inv_speed,
                const float* __restrict__ valid,
                const float* __restrict__ price, float jitter, int T, int S,
                uint32_t row_offset, uint32_t n_slots_total,
                float* __restrict__ out_v1, int* __restrict__ out_best,
                float* __restrict__ out_v2) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int t0 = warp * kRows;
  if (t0 >= T) return;  // whole warp leaves together

  float neg_size[kRows];
  uint32_t row_base[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = min(t0 + r, T - 1);  // rows past T compute, never store
    neg_size[r] = -size[t];
    row_base[r] = (row_offset + (uint32_t)(t0 + r)) * n_slots_total;
  }
  float v1[kRows], v2[kRows];
  int best[kRows];
  tpu_faas_bid::warp_top2<kRows>(neg_size, row_base, inv_speed, valid, price,
                                 jitter, 0, S, v1, best, v2);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = t0 + r;
    if (lane == 0 && t < T) {
      out_v1[t] = v1[r];
      out_best[t] = best[r];
      out_v2[t] = v2[r];
    }
  }
}

}  // namespace

extern "C" int tpu_faas_bid_top2(const float* size, const float* inv_speed,
                                 const float* valid, const float* price,
                                 float jitter, int T, int S,
                                 unsigned int row_offset,
                                 unsigned int n_slots_total, float* v1,
                                 int* best, float* v2, void* stream) {
  if (T <= 0) return 0;
  const int rows_per_block = kWarps * kRows;
  const int blocks = (T + rows_per_block - 1) / rows_per_block;
  bid_top2_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      size, inv_speed, valid, price, jitter, T, S, row_offset, n_slots_total,
      v1, best, v2);
  return (int)cudaGetLastError();
}
