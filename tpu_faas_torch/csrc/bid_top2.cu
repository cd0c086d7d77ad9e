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
// registers:
//   - one warp per ROWS task rows; lane l walks slots l, l+32, ... in
//     increasing order, so the three slot loads of a step are coalesced
//     and cached, and each load feeds ROWS independent hash chains (ILP);
//   - each lane keeps a running top-2 per row: if v > v1 then
//     (v2, v1, best) = (v1, v, s), else v2 = max(v2, v) -- the first argmax
//     within the lane, and a duplicated max gives v2 == v1;
//   - the 32 lanes merge by shuffles: the larger v1 wins, a tie goes to
//     the smaller slot index (the global first argmax, as JAX's argmax),
//     and v2 = max(v2a, v2b, min(v1a, v1b)).
// The products and sums use __fmul_rn/__fadd_rn/__fsub_rn in the plain
// version's order, ((-size)*inv + u*jitter) - price, so nvcc contracts
// nothing into an FMA and the kernel equals the plain version bit for bit.
// A row whose slots are all invalid gives v1 = v2 = -inf and best = 0.
//
// The kernel launches on the caller's stream, does not synchronise and
// allocates nothing; the C entry returns the launch's CUDA error code.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // warps per block
constexpr int kRows = 4;   // task rows per warp

__device__ __forceinline__ uint32_t wang_hash(uint32_t x) {
  x = (x ^ 61u) ^ (x >> 16);
  x = x * 9u;
  x = x ^ (x >> 4);
  x = x * 0x27D4EB2Du;
  return x ^ (x >> 15);
}

// merge (v1b, bb, v2b) into (v1, b, v2): the two cover disjoint slot sets
__device__ __forceinline__ void merge(float& v1, int& b, float& v2, float v1b,
                                      int bb, float v2b) {
  const bool take = v1b > v1 || (v1b == v1 && bb < b);
  v2 = fmaxf(fmaxf(v2, v2b), fminf(v1, v1b));
  if (take) {
    v1 = v1b;
    b = bb;
  }
}

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
  float v1[kRows], v2[kRows];
  int best[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int t = min(t0 + r, T - 1);  // rows past T compute, never store
    neg_size[r] = -size[t];
    row_base[r] = (row_offset + (uint32_t)(t0 + r)) * n_slots_total;
    v1[r] = -CUDART_INF_F;
    v2[r] = -CUDART_INF_F;
    best[r] = 0;
  }

  for (int s = lane; s < S; s += 32) {
    const float inv = inv_speed[s];
    const float p = price[s];
    const bool ok = valid[s] > 0.0f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const uint32_t h = wang_hash(row_base[r] + (uint32_t)s);
      const float u = (float)(int)(h >> 8) * 0x1p-24f;
      float v = __fsub_rn(
          __fadd_rn(__fmul_rn(neg_size[r], inv), __fmul_rn(u, jitter)), p);
      if (!ok) v = -CUDART_INF_F;
      if (v > v1[r]) {
        v2[r] = v1[r];
        v1[r] = v;
        best[r] = s;
      } else {
        v2[r] = fmaxf(v2[r], v);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o1 = __shfl_xor_sync(0xffffffffu, v1[r], off);
      const int ob = __shfl_xor_sync(0xffffffffu, best[r], off);
      const float o2 = __shfl_xor_sync(0xffffffffu, v2[r], off);
      merge(v1[r], best[r], v2[r], o1, ob, o2);
    }
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
