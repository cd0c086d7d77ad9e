// The resident scheduling tick as ONE hand-written CUDA kernel (Hopper, sm_90a).
//
// Replaces the TPU kernel tpu_faas/sched/pallas_fused.py::_fused_resident_tick_impl
// (the pl.pallas_call that runs the whole resident tick) for rank placement
// with tenancy and speculation off. Its plain PyTorch version is
// tpu_faas_torch/sched/resident.py::_resident_tick_impl; the two agree exactly
// on every output and every state leaf (integers by contract, and the float
// leaves are only scattered, never computed).
//
// One launch per tick, ONE thread block of 1024 threads, phases in order with
// __syncthreads() between them:
//   1. apply the delta packet: masked scatters with sentinel-drop, ADDITIVE
//      free counts (atomicAdd), arrivals into the first KA invalid pending
//      slots found by a block-wide scan, capped at min(n_arr, n_invalid);
//   2. liveness (hb_age = now - last_hb <= tte, on the post-scatter state),
//      purge, and the compacted redispatch of in-flight slots of dead rows;
//   3. rank placement (tpu_faas/sched/greedy.py): expand slots, stable sort by
//      -speed, admission (FCFS scan, or stable sort of the priority key),
//      stable sort of -task_key, rank-for-rank pairing;
//   4. compaction: the first KP placements (clearing their valid bit and
//      taking their free slot on the device), and n_pending.
// The state tensors are updated in place: the counterpart of the Pallas
// kernel's input_output_aliases is that their addresses never change.
//
// Sorts are block-wide stable LSD radix sorts over 32-bit order-preserving
// keys, 4 passes of 8 bits (a pass whose digit is the same for every key is
// skipped: it would be the identity). Ties keep index order, exactly as
// jnp.argsort / torch.argsort(stable=True). -0.0 is canonicalised to +0.0 and
// NaN to one positive quiet NaN before the key is built, so -0.0 ties with
// 0.0 and NaN sorts last, as both frameworks sort them.
//
// What bounds it on this card: the work is a few MB of state, packet and sort
// traffic; against 3.35 TB/s of HBM that is a few microseconds. This
// single-SM design runs at one SM's share of the memory system and is
// latency-bound on its ~400 block-wide barriers per tick, far from that
// bound; a multi-block persistent design is the later step.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Interface: plain C (ctypes), launches on the given stream, allocates nothing,
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 1024;          // threads in the one block
constexpr int NWARP = NT / 32;
constexpr int RADIX = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr int HEADER = 9;

struct Dims {
  int T, W, I, KA, KH, KF, KI, KS, KB, KP, KR, KG, K, use_priority, flush;
};

struct State {
  float* sizes;
  uint8_t* valid;
  int32_t* prio;
  float* last_hb;
  int32_t* free_cnt;
  int32_t* inflight;
  uint8_t* prev_live;
  float* speed;
  uint8_t* active;
};

struct Out {
  int32_t* placed_slots;  // [KP]
  int32_t* placed_rows;   // [KP]
  int32_t* arrival_slots; // [KA]
  int32_t* redispatch;    // [KR]
  int32_t* n_pending;     // [1]
  int32_t* straggler;     // [KG]
  uint8_t* purged;        // [W]
  uint8_t* live;          // [W]
};

struct Scratch {
  uint32_t* sk[2];  // slot sort keys, ping-pong [S]
  int32_t* sv[2];   // slot sort values [S]
  uint32_t* tk[2];  // task sort keys [T]
  int32_t* tv[2];   // task sort values [T]
  int32_t* assign;  // [T] worker per task, -1 queued
  int32_t* admitted;// [T] 0/1
};

struct Smem {
  int cnt[NWARP][RADIX];     // per-warp digit counts, then offsets
  int hist[4][RADIX];        // digit histogram of every pass
  int bucket[RADIX];         // running start of each digit's bucket
  int trivial[4];            // pass p has one digit for every key
  int scan[NWARP];           // block scan scratch
};

// f32 -> i32 as XLA converts: truncate, saturate, NaN -> 0 (cvt.rzi.s32.f32)
__device__ __forceinline__ int f2i(float x) { return __float2int_rz(x); }

// JAX .at[i] with mode="drop": negative wraps once, out of range -> -1 (drop)
__device__ __forceinline__ int drop_index(int i, int n) {
  if (i < 0) i += n;
  return (i >= 0 && i < n) ? i : -1;
}

// order-preserving unsigned key of a float (ascending key = ascending float)
__device__ __forceinline__ uint32_t float_key(float x) {
  uint32_t b = __float_as_uint(x);
  if (x == 0.0f) b = 0u;                 // -0.0 ties with +0.0
  if (x != x) b = 0x7fc00000u;           // every NaN sorts last
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ uint32_t int_key(int32_t x) {
  return static_cast<uint32_t>(x) ^ 0x80000000u;
}

// Exclusive block-wide prefix sum of one int per thread; *total gets the sum.
// Every thread of the block must call it.
__device__ int block_exclusive_scan(int v, int* total, Smem& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sm.scan[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = sm.scan[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    sm.scan[lane] = s;
  }
  __syncthreads();
  const int excl = (warp ? sm.scan[warp - 1] : 0) + x - v;
  *total = sm.scan[NWARP - 1];
  __syncthreads();  // sm.scan is reused by the next call
  return excl;
}

// Each thread's contiguous chunk of [0, n): chunks in thread order keep every
// compaction in index order.
__device__ __forceinline__ void chunk_of(int n, int* lo, int* hi) {
  const int c = (n + NT - 1) / NT;
  *lo = min(threadIdx.x * c, n);
  *hi = min(*lo + c, n);
}

// Indices of the first K set bits of mask(i) over [0, n), in index order,
// -1 padded, into out[K]; emit(i, pos) runs in the owning thread for each
// reported index. Returns the number of set bits in the whole mask.
template <class Mask, class Emit>
__device__ int first_k(int n, int K, int32_t* out, Mask mask, Emit emit,
                       Smem& sm) {
  int lo, hi;
  chunk_of(n, &lo, &hi);
  int c = 0;
  for (int i = lo; i < hi; ++i) c += mask(i) ? 1 : 0;
  int total;
  int p = block_exclusive_scan(c, &total, sm);
  for (int j = total + threadIdx.x; j < K; j += NT) out[j] = -1;
  for (int i = lo; i < hi && p < K; ++i) {
    if (mask(i)) {
      out[p] = i;
      emit(i, p);
      ++p;
    }
  }
  return total;
}

// Stable ascending LSD radix sort of n (key, value) pairs held in k[0]/v[0];
// k[1]/v[1] are the ping-pong buffers. Returns which buffer holds the result.
__device__ int block_radix_sort(uint32_t* const k[2], int32_t* const v[2],
                                int n, Smem& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  for (int i = threadIdx.x; i < 4 * RADIX; i += NT) (&sm.hist[0][0])[i] = 0;
  if (threadIdx.x < 4) sm.trivial[threadIdx.x] = 0;
  __syncthreads();
  // histograms of all four digits, warp-aggregated
  for (int base = 0; base < n; base += NT) {
    const int i = base + threadIdx.x;
    const bool ok = i < n;
    const uint32_t key = ok ? k[0][i] : 0u;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int d = (key >> (8 * p)) & 0xff;
      const unsigned peers = __match_any_sync(FULL, ok ? d : 0x100);
      if (ok && (peers & lt_mask) == 0) atomicAdd(&sm.hist[p][d], __popc(peers));
    }
  }
  __syncthreads();
  if (threadIdx.x < RADIX) {
#pragma unroll
    for (int p = 0; p < 4; ++p)
      if (sm.hist[p][threadIdx.x] == n) sm.trivial[p] = 1;
  }
  __syncthreads();

  int src = 0;
  for (int p = 0; p < 4; ++p) {
    if (sm.trivial[p]) continue;  // block-uniform
    const int shift = 8 * p;
    int total;
    const int h = threadIdx.x < RADIX ? sm.hist[p][threadIdx.x] : 0;
    const int start = block_exclusive_scan(h, &total, sm);
    if (threadIdx.x < RADIX) sm.bucket[threadIdx.x] = start;
    const uint32_t* ks = k[src];
    const int32_t* vs = v[src];
    uint32_t* kd = k[src ^ 1];
    int32_t* vd = v[src ^ 1];
    for (int base = 0; base < n; base += NT) {
      const int i = base + threadIdx.x;
      const bool ok = i < n;
      const uint32_t key = ok ? ks[i] : 0u;
      const int32_t val = ok ? vs[i] : 0;
      const int d = (key >> shift) & 0xff;
      // this warp's row of counts: cleared by its own lanes, then filled by
      // the first lane of each digit group
      __syncwarp();
#pragma unroll
      for (int j = lane; j < RADIX; j += 32) sm.cnt[warp][j] = 0;
      __syncwarp();
      const unsigned peers = __match_any_sync(FULL, ok ? d : 0x100);
      const int rank = __popc(peers & lt_mask);
      if (ok && rank == 0) sm.cnt[warp][d] = __popc(peers);
      __syncthreads();
      // digit owners turn counts into each warp's start within the bucket
      if (threadIdx.x < RADIX) {
        int run = sm.bucket[threadIdx.x];
        for (int w = 0; w < NWARP; ++w) {
          const int c = sm.cnt[w][threadIdx.x];
          sm.cnt[w][threadIdx.x] = run;
          run += c;
        }
        sm.bucket[threadIdx.x] = run;
      }
      __syncthreads();
      if (ok) {
        const int pos = sm.cnt[warp][d] + rank;
        kd[pos] = key;
        vd[pos] = val;
      }
    }
    __syncthreads();
    src ^= 1;
  }
  return src;
}

__global__ void __launch_bounds__(NT, 1)
fused_tick_kernel(const float* __restrict__ packet, Dims D, State st, Out out,
                  Scratch sc) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int T = D.T, W = D.W, I = D.I, K = D.K;

  // ---- phase 1: apply the delta packet (resident.py::_apply_deltas) ------
  const float now = packet[0];
  const int n_arr = f2i(packet[1]);
  const int n_hb = f2i(packet[2]);
  const int n_free = f2i(packet[3]);
  const int n_infl = f2i(packet[4]);
  const int n_speed = f2i(packet[5]);
  const int n_active = f2i(packet[6]);
  const float tte = packet[8];
  int off = HEADER;
  const float* arr_sizes = packet + off; off += D.KA;
  const float* arr_prio = packet + off; if (D.use_priority) off += D.KA;
  const float* hb_idx = packet + off; off += D.KH;
  const float* hb_val = packet + off; off += D.KH;
  const float* free_idx = packet + off; off += D.KF;
  const float* free_val = packet + off; off += D.KF;
  const float* infl_idx = packet + off; off += D.KI;
  const float* infl_val = packet + off; off += D.KI;
  const float* sp_idx = packet + off; off += D.KS;
  const float* sp_val = packet + off; off += D.KS;
  const float* ac_idx = packet + off; off += D.KB;
  const float* ac_val = packet + off;

  for (int j = tid; j < D.KH && j < n_hb; j += NT) {
    const int r = drop_index(f2i(hb_idx[j]), W);
    if (r >= 0) st.last_hb[r] = hb_val[j];
  }
  for (int j = tid; j < D.KF && j < n_free; j += NT) {
    const int r = drop_index(f2i(free_idx[j]), W);
    if (r >= 0) atomicAdd(&st.free_cnt[r], f2i(free_val[j]));
  }
  for (int j = tid; j < D.KI && j < n_infl; j += NT) {
    const int s = drop_index(f2i(infl_idx[j]), I);
    if (s >= 0) st.inflight[s] = f2i(infl_val[j]);
  }
  for (int j = tid; j < D.KS && j < n_speed; j += NT) {
    const int r = drop_index(f2i(sp_idx[j]), W);
    if (r >= 0) st.speed[r] = sp_val[j];
  }
  for (int j = tid; j < D.KB && j < n_active; j += NT) {
    const int r = drop_index(f2i(ac_idx[j]), W);
    if (r >= 0) st.active[r] = ac_val[j] > 0.5f ? 1 : 0;
  }
  // arrivals: the first KA invalid pending slots, in index order
  const int n_invalid = first_k(
      T, D.KA, out.arrival_slots, [&](int i) { return st.valid[i] == 0; },
      [](int, int) {}, sm);
  __syncthreads();
  const int accept = min(n_arr, n_invalid);
  for (int j = tid; j < D.KA; j += NT) {
    if (j < accept) {
      const int s = out.arrival_slots[j];
      st.sizes[s] = arr_sizes[j];
      st.valid[s] = 1;
      if (D.use_priority) st.prio[s] = f2i(arr_prio[j]);
    } else {
      out.arrival_slots[j] = -1;
    }
  }
  if (D.flush) return;
  __syncthreads();

  // ---- phase 2: liveness, purge, redispatch (state.py) --------------------
  for (int w = tid; w < W; w += NT) {
    const float age = now - st.last_hb[w];
    const uint8_t l = (st.active[w] && age <= tte) ? 1 : 0;
    out.purged[w] = (st.prev_live[w] && !l) ? 1 : 0;
    out.live[w] = l;
    st.prev_live[w] = l;
  }
  __syncthreads();
  first_k(
      I, D.KR, out.redispatch,
      [&](int i) {
        const int iw = st.inflight[i];
        return iw >= 0 && !out.live[min(iw, W - 1)];
      },
      [](int, int) {}, sm);
  for (int j = tid; j < D.KG; j += NT) out.straggler[j] = -1;

  // ---- phase 3: rank placement (greedy.py::rank_match_placement_impl) -----
  const int S = W * K;
  int my_slots = 0;
  for (int s = tid; s < S; s += NT) {
    const int w = s / K;
    const int f = out.live[w] ? st.free_cnt[w] : 0;
    const bool ok = (s - w * K) < f;
    my_slots += ok ? 1 : 0;
    sc.sk[0][s] = float_key(-(ok ? st.speed[w] : neg_inf()));
    sc.sv[0][s] = s;
  }
  int n_slots_total;
  block_exclusive_scan(my_slots, &n_slots_total, sm);
  const int slot_buf = block_radix_sort(sc.sk, sc.sv, S, sm);
  const int32_t* slot_order = sc.sv[slot_buf];

  // admission
  if (D.use_priority) {
    for (int t = tid; t < T; t += NT) {
      const int32_t key = st.valid[t]
          ? static_cast<int32_t>(0u - static_cast<uint32_t>(st.prio[t]))
          : INT32_MAX;
      sc.tk[0][t] = int_key(key);
      sc.tv[0][t] = t;
    }
    __syncthreads();
    const int b = block_radix_sort(sc.tk, sc.tv, T, sm);
    for (int r = tid; r < T; r += NT) {
      const int t = sc.tv[b][r];
      sc.admitted[t] = (r < n_slots_total && st.valid[t]) ? 1 : 0;
    }
  } else {
    int lo, hi;
    chunk_of(T, &lo, &hi);
    int c = 0;
    for (int t = lo; t < hi; ++t) c += st.valid[t] ? 1 : 0;
    int total;
    int rank = block_exclusive_scan(c, &total, sm);
    for (int t = lo; t < hi; ++t) {
      const bool v = st.valid[t] != 0;
      sc.admitted[t] = (v && rank < n_slots_total) ? 1 : 0;
      rank += v ? 1 : 0;
    }
  }
  __syncthreads();
  int my_tasks = 0;
  for (int t = tid; t < T; t += NT) {
    const bool adm = sc.admitted[t] != 0;
    my_tasks += adm ? 1 : 0;
    sc.tk[0][t] = float_key(-(adm ? st.sizes[t] : neg_inf()));
    sc.tv[0][t] = t;
    sc.assign[t] = -1;
  }
  int n_tasks;
  block_exclusive_scan(my_tasks, &n_tasks, sm);
  const int task_buf = block_radix_sort(sc.tk, sc.tv, T, sm);
  const int32_t* task_order = sc.tv[task_buf];
  // pair rank-for-rank over L = min(T, S); positions past n_pairs stay -1
  const int n_pairs = min(min(n_slots_total, n_tasks), min(T, S));
  for (int i = tid; i < n_pairs; i += NT)
    sc.assign[task_order[i]] = slot_order[i] / K;
  __syncthreads();

  // ---- phase 4: compaction (resident.py::_resident_tick_impl) ------------
  const int32_t* assign = sc.assign;
  const int n_placed = first_k(
      T, D.KP, out.placed_slots, [&](int t) { return assign[t] >= 0; },
      [&](int t, int p) {
        const int row = assign[t];
        out.placed_rows[p] = row;
        st.valid[t] = 0;  // clear ONLY reported placements
        atomicAdd(&st.free_cnt[row], -1);
      },
      sm);
  for (int j = n_placed + tid; j < D.KP; j += NT) out.placed_rows[j] = -1;
  __syncthreads();
  int my_pending = 0;
  for (int t = tid; t < T; t += NT) my_pending += st.valid[t] ? 1 : 0;
  int n_pending;
  block_exclusive_scan(my_pending, &n_pending, sm);
  if (tid == 0) out.n_pending[0] = n_pending;
}

}  // namespace

extern "C" int tpu_faas_fused_resident_tick(
    const float* packet, float* sizes, uint8_t* valid, int32_t* prio,
    float* last_hb, int32_t* free_cnt, int32_t* inflight, uint8_t* prev_live,
    float* speed, uint8_t* active, int32_t* out_i32, uint8_t* out_b8,
    int32_t* scratch, int T, int W, int I, int KA, int KH, int KF, int KI,
    int KS, int KB, int KP, int KR, int KG, int max_slots, int use_priority,
    int flush, void* stream) {
  Dims d{T, W, I, KA, KH, KF, KI, KS, KB, KP, KR, KG, max_slots, use_priority,
         flush};
  State st{sizes, valid, prio, last_hb, free_cnt, inflight, prev_live, speed,
           active};
  // out_i32 = placed_slots ++ placed_rows ++ arrival_slots ++ redispatch ++
  //           n_pending ++ straggler; out_b8 = purged ++ live
  Out o{out_i32,
        out_i32 + KP,
        out_i32 + 2 * KP,
        out_i32 + 2 * KP + KA,
        out_i32 + 2 * KP + KA + KR,
        out_i32 + 2 * KP + KA + KR + 1,
        out_b8,
        out_b8 + W};
  // scratch = sk0 sk1 sv0 sv1 [S each] ++ tk0 tk1 tv0 tv1 assign admitted [T each]
  const long S = static_cast<long>(W) * max_slots;
  int32_t* p = scratch;
  Scratch sc;
  sc.sk[0] = reinterpret_cast<uint32_t*>(p); p += S;
  sc.sk[1] = reinterpret_cast<uint32_t*>(p); p += S;
  sc.sv[0] = p; p += S;
  sc.sv[1] = p; p += S;
  sc.tk[0] = reinterpret_cast<uint32_t*>(p); p += T;
  sc.tk[1] = reinterpret_cast<uint32_t*>(p); p += T;
  sc.tv[0] = p; p += T;
  sc.tv[1] = p; p += T;
  sc.assign = p; p += T;
  sc.admitted = p;
  fused_tick_kernel<<<1, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      packet, d, st, o, sc);
  return static_cast<int>(cudaGetLastError());
}
