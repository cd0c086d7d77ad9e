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
// NaN cells: a pre-pass (one block, O(S)) flags a valid slot with a
// non-finite inverse speed or price, or a non-finite jitter; then every
// warp sweeps with JAX's NaN rule, and otherwise only a warp with a
// non-finite size among its rows does. The finite loop pays nothing.
//
// The kernel launches on the caller's stream, does not synchronise and
// allocates nothing; the C entry returns the launch's CUDA error code.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bid_top2.cuh"

namespace {

constexpr int kWarps = 4;  // warps per block
constexpr int kRows = 4;   // task rows per warp

// flag[0] = 1 when some cell of any row can be NaN through a slot or the
// jitter: a valid slot with a non-finite inverse speed or price.
__global__ void __launch_bounds__(1024)
bid_flag_kernel(const float* __restrict__ inv_speed,
                const float* __restrict__ valid,
                const float* __restrict__ price, float jitter, int S,
                int* __restrict__ flag) {
  bool bad = !isfinite(jitter);
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    bad |= tpu_faas_bid::slot_nonfinite(inv_speed[s], valid[s], price[s]);
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) flag[0] = bad ? 1 : 0;
}

__global__ void __launch_bounds__(kWarps * 32)
bid_top2_kernel(const float* __restrict__ size,
                const float* __restrict__ inv_speed,
                const float* __restrict__ valid,
                const float* __restrict__ price, float jitter, int T, int S,
                uint32_t row_offset, uint32_t n_slots_total,
                const int* __restrict__ flag, float* __restrict__ out_v1,
                int* __restrict__ out_best, float* __restrict__ out_v2) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int t0 = warp * kRows;
  if (t0 >= T) return;  // whole warp leaves together

  float neg_size[kRows];
  uint32_t row_base[kRows];
  bool nan_rule = flag[0] != 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = min(t0 + r, T - 1);  // rows past T compute, never store
    neg_size[r] = -size[t];
    nan_rule |= !isfinite(neg_size[r]);
    row_base[r] = (row_offset + (uint32_t)(t0 + r)) * n_slots_total;
  }
  float v1[kRows], v2[kRows];
  int best[kRows];
  if (nan_rule) {  // warp-uniform: every lane read the same rows and flag
    tpu_faas_bid::warp_top2<kRows, true>(neg_size, row_base, inv_speed,
                                         valid, price, jitter, 0, S, v1,
                                         best, v2);
  } else {
    tpu_faas_bid::warp_top2<kRows>(neg_size, row_base, inv_speed, valid,
                                   price, jitter, 0, S, v1, best, v2);
  }
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

// flag: one int of scratch, written by the pre-pass before the bid reads it.
extern "C" int tpu_faas_bid_top2(const float* size, const float* inv_speed,
                                 const float* valid, const float* price,
                                 float jitter, int T, int S,
                                 unsigned int row_offset,
                                 unsigned int n_slots_total, int* flag,
                                 float* v1, int* best, float* v2,
                                 void* stream) {
  if (T <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  bid_flag_kernel<<<1, 1024, 0, st>>>(inv_speed, valid, price, jitter, S,
                                      flag);
  const int rows_per_block = kWarps * kRows;
  const int blocks = (T + rows_per_block - 1) / rows_per_block;
  bid_top2_kernel<<<blocks, kWarps * 32, 0, st>>>(
      size, inv_speed, valid, price, jitter, T, S, row_offset, n_slots_total,
      flag, v1, best, v2);
  return (int)cudaGetLastError();
}
