// The auction's streamed top-2 bid for one warp, shared by kernel B2
// (bid_top2.cu) and the auction branch of the fused resident tick
// (fused_tick.cu), so both bid with the same code.
//
// For each of ROWS task rows it computes the best value v1, its first
// argmax slot `best` and the runner-up v2, over the slots [s_lo, s_hi), of
//
//     v[t,s] = -size[t]*inv_speed[s] + u(t,s)*jitter - price[s]
//
// (-inf where valid[s] == 0), where u is the Wang hash of the uint32 cell
// index row_base[r] + s, shifted right by 8 and scaled by 2^-24:
//   - lane l walks slots s_lo+l, s_lo+l+32, ... in increasing order, so the
//     three slot loads of a step are coalesced and cached, and each load
//     feeds ROWS
//     independent hash chains (ILP);
//   - each lane keeps a running top-2 per row: if v > v1 then
//     (v2, v1, best) = (v1, v, s), else v2 = max(v2, v) -- the first argmax
//     within the lane, and a duplicated max gives v2 == v1;
//   - the 32 lanes merge by xor shuffles: the larger v1 wins, a tie goes to
//     the smaller slot index (the global first argmax, as JAX's argmax),
//     and v2 = max(v2a, v2b, min(v1a, v1b)). The merge is symmetric, so
//     every lane ends with the same result.
// The products and sums use __fmul_rn/__fadd_rn/__fsub_rn in the plain
// version's order, ((-size)*inv + u*jitter) - price, so nvcc contracts
// nothing into an FMA and the result equals the plain version
// (tpu_faas_torch/sched/bid.py::bid_top2_stream_impl) bit for bit.
// A row whose slots are all invalid gives v1 = v2 = -inf and best = 0.
//
// NaN cells follow JAX's bid_top2_xla: the first NaN is the maximum (v1 =
// NaN, best = its slot), and v2, the maximum over every other cell,
// propagates a NaN. With finite sizes, inverse speeds, prices and jitter a
// cell cannot be NaN (only its product term can overflow), so the callers
// flag, once per launch, the rows and slots with a non-finite input, and
// only a flagged warp sweeps with the NaN rule (NAN_RULE = true); the
// loop for finite inputs is the one above.
//
// Top-2 results over disjoint slot sets merge exactly in any order and any
// grouping (`merge`): v1 is the maximum (a NaN first) with ties to the
// lower slot, v2 the largest of the runner-ups and of the maximum that
// loses, a NaN among them propagated. So a row's slots may be split into
// chunks, each swept by its own warp, and the chunks' results merged: the
// outcome equals one warp's sweep over [0, S) bit for bit.
//
// warp_top2_listed sweeps a list of valid slots instead (the fused tick's
// kept slots, ascending): the same cell (top2_cell), the same merge, with
// `best` a list position. An invalid slot contributes -inf, the identity of
// the top-2, so over the list of the sweep's valid slots every result is
// the sweep's.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace tpu_faas_bid {

__device__ __forceinline__ uint32_t wang_hash(uint32_t x) {
  x = (x ^ 61u) ^ (x >> 16);
  x = x * 9u;
  x = x ^ (x >> 4);
  x = x * 0x27D4EB2Du;
  return x ^ (x >> 15);
}

// merge (v1b, bb, v2b) into (v1, b, v2): the two cover disjoint slot sets.
// Without NaN_RULE the inputs hold no NaN (a finite sweep's).
template <bool NAN_RULE = false>
__device__ __forceinline__ void merge(float& v1, int& b, float& v2, float v1b,
                                      int bb, float v2b) {
  if (!NAN_RULE) {
    const bool take = v1b > v1 || (v1b == v1 && bb < b);
    v2 = fmaxf(fmaxf(v2, v2b), fminf(v1, v1b));
    if (take) {
      v1 = v1b;
      b = bb;
    }
    return;
  }
  const bool na = v1 != v1, nb = v1b != v1b;
  const bool take = nb ? (!na || bb < b)
                       : (!na && (v1b > v1 || (v1b == v1 && bb < b)));
  // the losing maximum is the number of a NaN and a number: fminf picks
  // it, and only two NaNs make the runner-up NaN through it
  const bool nan2 = v2 != v2 || v2b != v2b || (na && nb);
  v2 = nan2 ? CUDART_NAN_F : fmaxf(fmaxf(v2, v2b), fminf(v1, v1b));
  if (take) {
    v1 = v1b;
    b = bb;
  }
}

// Merge every lane's (v1, b, v2) into the warp's, in every lane.
template <bool NAN_RULE = false>
__device__ __forceinline__ void warp_merge(float& v1, int& b, float& v2) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o1 = __shfl_xor_sync(0xffffffffu, v1, off);
    const int ob = __shfl_xor_sync(0xffffffffu, b, off);
    const float o2 = __shfl_xor_sync(0xffffffffu, v2, off);
    merge<NAN_RULE>(v1, b, v2, o1, ob, o2);
  }
}

// One cell of a row's running top-2: slot s (its hash index row_base[r] +
// s), reported as `at`, with inverse speed inv, price p and validity ok.
template <int ROWS, bool NAN_RULE>
__device__ __forceinline__ void top2_cell(
    const float (&neg_size)[ROWS], const uint32_t (&row_base)[ROWS],
    uint32_t s, int at, float inv, float p, bool ok, float jitter,
    float (&v1)[ROWS], int (&best)[ROWS], float (&v2)[ROWS]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const uint32_t h = wang_hash(row_base[r] + s);
    const float u = (float)(int)(h >> 8) * 0x1p-24f;
    float v = __fsub_rn(
        __fadd_rn(__fmul_rn(neg_size[r], inv), __fmul_rn(u, jitter)), p);
    if (!ok) v = -CUDART_INF_F;
    if (NAN_RULE) {
      // the first NaN takes v1; v2 keeps every other cell's NaN
      const bool vn = v != v, n1 = v1[r] != v1[r];
      if ((vn && !n1) || v > v1[r]) {
        v2[r] = v1[r];
        v1[r] = v;
        best[r] = at;
      } else {
        v2[r] = (vn || v2[r] != v2[r]) ? CUDART_NAN_F : fmaxf(v2[r], v);
      }
    } else if (v > v1[r]) {
      v2[r] = v1[r];
      v1[r] = v;
      best[r] = at;
    } else {
      v2[r] = fmaxf(v2[r], v);
    }
  }
}

template <int ROWS>
__device__ __forceinline__ void top2_init(float (&v1)[ROWS],
                                          int (&best)[ROWS],
                                          float (&v2)[ROWS]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    v1[r] = -CUDART_INF_F;
    v2[r] = -CUDART_INF_F;
    best[r] = 0;
  }
}

// The top-2 of ROWS rows over slots [s_lo, s_hi), in every lane of the
// calling warp. neg_size[r] is -size of row r; row_base[r] its hash base,
// the uint32 product (global row id) * n_slots_total.
template <int ROWS, bool NAN_RULE = false>
__device__ __forceinline__ void warp_top2(
    const float (&neg_size)[ROWS], const uint32_t (&row_base)[ROWS],
    const float* inv_speed, const float* valid, const float* price,
    float jitter, int s_lo, int s_hi, float (&v1)[ROWS], int (&best)[ROWS],
    float (&v2)[ROWS]) {
  const int lane = threadIdx.x & 31;
  top2_init(v1, best, v2);
  for (int s = s_lo + lane; s < s_hi; s += 32)
    top2_cell<ROWS, NAN_RULE>(neg_size, row_base, (uint32_t)s, s,
                              inv_speed[s], price[s], valid[s] > 0.0f,
                              jitter, v1, best, v2);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) warp_merge<NAN_RULE>(v1[r], best[r], v2[r]);
}

// The same over a list of valid slots: positions [i_lo, i_hi) of a list
// whose position i holds slot slot_id[i] (ascending in i), its inverse
// speed inv[i] and price price[i]; `best` is a position. The lane walk and
// the merge keep ascending positions, so ties go to the lower slot; a slot
// left out of the list would only give -inf, the top-2's identity, so over
// the list of a sweep's valid slots every result equals the sweep's, bit
// for bit (best as the position of its slot).
template <int ROWS, bool NAN_RULE = false>
__device__ __forceinline__ void warp_top2_listed(
    const float (&neg_size)[ROWS], const uint32_t (&row_base)[ROWS],
    const int32_t* slot_id, const float* inv, const float* price,
    float jitter, int i_lo, int i_hi, float (&v1)[ROWS], int (&best)[ROWS],
    float (&v2)[ROWS]) {
  const int lane = threadIdx.x & 31;
  top2_init(v1, best, v2);
  for (int i = i_lo + lane; i < i_hi; i += 32)
    top2_cell<ROWS, NAN_RULE>(neg_size, row_base, (uint32_t)slot_id[i], i,
                              inv[i], price[i], true, jitter, v1, best, v2);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) warp_merge<NAN_RULE>(v1[r], best[r], v2[r]);
}

// A slot whose inputs can make a cell NaN: valid, with a non-finite
// inverse speed or price.
__device__ __forceinline__ bool slot_nonfinite(float inv, float valid,
                                               float price) {
  return valid > 0.0f && !(isfinite(inv) && isfinite(price));
}

}  // namespace tpu_faas_bid
