// The resident scheduling tick as hand-written CUDA kernels (Hopper, sm_90a).
//
// Replaces the TPU kernel tpu_faas/sched/pallas_fused.py::_fused_resident_tick_impl
// (the pl.pallas_call that runs the whole resident tick) for rank, auction and
// Sinkhorn placement, with the tenancy and speculation lanes each on or off.
// Its plain PyTorch version is
// tpu_faas_torch/sched/resident.py::_resident_tick_impl; the two agree exactly
// on every output and every state leaf (Sinkhorn: under the contract below).
//
// Phases, shared by the three placements:
//   1. apply the delta packet: masked scatters with sentinel-drop, ADDITIVE
//      free counts (atomicAdd), arrivals into the first KA invalid pending
//      slots of the pre-arrival state, capped at min(n_arr, n_invalid);
//      with speculation, each arrival's avoid row, and for each in-flight
//      scatter its predicted runtime and dispatch stamp (now, 0 on a clear);
//   2. liveness (hb_age = now - last_hb <= tte, on the post-scatter state),
//      purge, and the compacted redispatch of in-flight slots of dead rows;
//      with speculation, the first KG straggler slots (tpu_faas/spec/
//      straggler.py: occupied on a live row, pred > 0, now - start past
//      max(mult * pred, min_s) with NaN propagating);
//      with tenancy, then the admission (tpu_faas/tenancy/fairshare.py):
//      the within-tenant FCFS rank j, the inflight-cap eligibility that
//      every placement reads as its valid set, the tenants with demand,
//      and for rank the admitted set of the admission order (eligible
//      tasks by -eff_prio, then v, then index);
//   3. placement (below); with speculation, then the hedge fixup over the
//      grid (straggler.py::hedge_fixup_impl; grid_fixup below): the veto of
//      tasks placed on their avoid row, the free slots left after placement
//      from the RAW free counts, and the first 64 vetoed tasks in index
//      order each placed in turn on the first-argmax live row with slots
//      left, never its avoid row (ties to the lower row, NaN the maximum),
//      walked by one warp over the first 65 rows of that order;
//   4. with tenancy, the deficit carry from the final assignment: integer
//      counts per tenant, each block its tile's (in shared memory up to
//      1,024 tenant rows, global atomics past that, so NT is bounded only
//      by the int32 segment key), then on block 0 the share sum, ONE
//      float64 running sum in index order rounded once, as the plain
//      version takes it, and each row's expression;
//   5. compaction: the first KP placements (clearing their valid bit and
//      taking their free slot on the device), and n_pending.
// The state tensors are updated in place: the counterpart of the Pallas
// kernel's input_output_aliases is that their addresses never change.
//
// Rank placement (fused_rank_kernel): one COOPERATIVE launch of one
// 1024-thread block per SM, phases separated by grid barriers. Every index
// range is cut into one contiguous tile per block, walked in chunks of 1024
// consecutive indices; a block counts what it keeps, and after a barrier
// takes its offset from the scan of the blocks' counts, so every list it
// emits (arrival slots, redispatches, stragglers, valid slots, admitted
// tasks, placements) is in index order. Phase 3 is tpu_faas/sched/
// greedy.py without its full-length sorts: the valid slots (live, below
// the free count) compacted in index order; the admission as a threshold
// on the tasks' keys -- FCFS one key for every valid task, priority
// greedy.py's (-prio, wrapping; INT32_MAX on an invalid task, which still
// holds a rank), tenancy (int_key(-eff_prio), float_key(v)) on the
// eligible tasks -- found by a radix select (below), and the admitted
// tasks compacted in index order: every task below the threshold and the
// first n_slots - below equal to it, exactly greedy.py's stable ranks
// below n_slots. Block 0 then sorts the valid slots by -speed while block 1
// sorts the admitted tasks by -size; both lists are in index order, so the
// stable sorts give the full sorts' first n_slots and n_tasks positions,
// and the grid pairs them rank for rank. A valid slot whose speed or an
// admitted task whose size is -inf or NaN would sort among the invalid ones
// in greedy.py's sorts: a flag raised before the sorts sends such a tick
// to the full-length sorts on block 0 (rank_place), counted in the
// scratch. The tenancy lane's j: each block stably sorts its tile by
// segment, a warp scans each tenant row's tile counts over the blocks, and
// j is that offset plus the position in the tile's run. The flush mode
// (phase 1 alone) is one block (fused_flush_kernel).
//
// The radix select: the n_slots-th smallest 64-bit key, most significant
// byte first. Each pass histograms the keys of the chosen bucket by the
// first byte where its least and greatest key differ (so a byte every key
// shares is skipped), with each digit's least and greatest key, in shared
// memory and then by atomics in global memory; after a grid barrier every
// block picks the same digit. It ends when a bucket holds one key: at most
// 8 passes, 2 on the resident loop's priorities, none for FCFS.
//
// Auction placement (fused_auction_kernel): one COOPERATIVE launch of one
// 1024-thread block per SM (at most kMaxRankBlocks), phases separated by
// grid barriers. Phase 3 is tpu_faas/sched/auction.py::auction_placement_impl
// on the resident carry, over compacted lists built as the rank branch
// builds its own (every index range one tile per block, each list in index
// order at the blocks' scanned offsets):
//   - phases 1 and 2 over the grid as the rank branch runs them
//     (grid_arrivals, grid_liveness; with the tenancy lane, then the
//     eligibility; with the speculation lane, the grid lists the stragglers
//     at the close);
//   - the opening: the free slots (live, below the free count) listed with
//     their -speed keys, the placeable tasks counted, n_match = min(free
//     slots, placeable tasks), and the first n_match placeable tasks
//     admitted FCFS and listed (au.adm) with their -size keys; on a refresh
//     tick every carried price is zeroed, else the grid finds their least
//     positive one and re-bases them all (auction.py::_rebase). Block 0 sorts
//     the free list by -speed and keeps the n_match fastest, listed in
//     ascending slot order (au.kept); on a refresh tick block 1 sorts the
//     admitted list by -size and block 0 prices the kept slots by the
//     rank-dual seed. Both lists are in index order, so the stable sorts give
//     the full-length sorts' first positions;
//   - then at most warm_rounds bidding rounds across the whole grid while an
//     admitted task has no slot, bidding on positions of the kept list (an
//     invalid slot would only give -inf, the top-2's identity, so each bid
//     is the full sweep's bit for bit). Each round: every bidder's top-2 bid
//     with the code of kernel B2 (bid_top2.cuh's listed sweep: the cell
//     index stays row * S + slot; JAX's NaN rule for a row with a non-finite
//     size, and for every row once the opening or an installed price flags
//     a slot or the jitter), spread over the grid's warps as (4 bidders,
//     position chunk) work items when bidders are few, the chunks' partial
//     top-2s merged exactly by the group's last warp (bid_round); each bid an
//     atomicMin on its position's 64-bit key (order-preserving bits of
//     -bid_price, then the task index, so the highest bid wins and a tie goes
//     to the lower task, as the plain version's lexsort decides); a grid
//     barrier; every won position evicts its previous owner and installs the
//     winner and its price (the evicted owners never bid, so the two index
//     sets are disjoint); a barrier; the next round's bidders collected from
//     the admitted list; a barrier. Every block reads the loop condition from
//     the device after the barrier: no host round trip;
//   - block 0 closes the tick over the same lists (auction_close_listed: the
//     rank spill of the leftover tasks and slots, each sorted alone, and
//     refresh) while the grid writes the kept prices back; with a lane on,
//     the grid runs the lanes' close (lanes_close: the hedge fixup and the
//     deficit carry); the grid compacts the first KP placements
//     (grid_compact).
// A free slot whose speed or an admitted task whose size is -inf or NaN
// would sort among the invalid ones in the plain version's full-length
// sorts: a flag raised before the sorts sends such a tick to the
// full-length opening and close on block 0 (auction_open, auction_close),
// and the fourth aux word reports it. That opening lists its kept slots
// as the compacted one does, so the rounds are the same on both paths. The
// Sinkhorn branch opens and closes its lanes as block 0 and the grid did
// here before the lists: block 0's packet and liveness, lanes_close.
// The seed's reversed cumsum is ONE float64 running sum from the end,
// rounded per element: the order the plain version's host cumsum uses.
// Every product and sum of the seed and the round is spelled with
// __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn in the plain version's order, so
// nvcc contracts nothing into an FMA.
//
// Sorts are block-wide stable LSD radix sorts over 32-bit order-preserving
// keys, 4 passes of 8 bits (a pass whose digit is the same for every key is
// skipped: it would be the identity). Ties keep index order, exactly as
// jnp.argsort / torch.argsort(stable=True). -0.0 is canonicalised to +0.0 and
// NaN to one positive quiet NaN before the key is built, so -0.0 ties with
// 0.0 and NaN sorts last, as both frameworks sort them.
//
// What bounds them on this card. Rank: under 1 MB of state and packet
// traffic a tick, a fraction of a microsecond of HBM time; the grid design
// is latency-bound on its 7-11 grid barriers (about 1 us each) and the
// block-wide sorts of the compacted lists (hundreds of keys a tick on the
// resident loop). Auction: a few hundred kept slots and admitted tasks a
// tick, so a round's (bidder, slot) cells are a few microseconds of the
// integer pipe (the Wang hash, the index and the compares: 64 a clock per
// SM); a round is bound by its three grid barriers and the chain of
// dependent loads and atomics in its bids, install and collection.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// Interface: plain C (ctypes), launches on the given stream, allocates nothing,
// returns cudaGetLastError() (or a negative code: see the auction entry).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bid_top2.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 1024;          // threads in a block
constexpr int NWARP = NT / 32;
constexpr int RADIX = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr int HEADER = 9;
constexpr int kRows = 4;          // bidders per work item of a bidding round
constexpr int kMinChunk = 256;    // fewest slots a work item sweeps
constexpr int kMaxItems = 8192;   // work items that keep a partial top-2
constexpr unsigned long long kNoBid = ~0ull;
constexpr int kSmemTenants = 1024;  // tenancy: rows counted in shared memory
constexpr int kFixupK = 64;       // speculation: vetoed rows re-placed a tick
constexpr int kMaxRankBlocks = 256;  // blocks of the rank and auction grids,
                                     // at most (and of the Sinkhorn grid
                                     // with a lane on)
constexpr int kSelPasses = 8;  // one byte of the 64-bit key a pass, at most
constexpr unsigned long long kNoKey = ~0ull;  // not ranked by a select

// The auction's phase stamps (a probe build, -DTPU_FAAS_PROBE, alone writes
// them; the layout exists in every build): 0 start, 1 packet, liveness and
// tenancy admission, 2 the opening (lists, admission, sorts, the kept
// slots and their prices), 3 the opening's last grid barrier; then per
// round r < kStampRounds five words from kStampRound + 5r: the round's
// bidders, the last block's end of its bids (the largest clock over the
// blocks), and block 0's clock after the bids' barrier, after the install
// pass and its barrier, and after the bidder collection and its barrier;
// then the close (spill, refresh) and the end (fixup, deficit,
// compaction); then the lanes' words: block 0's clock after the packet and
// after liveness (both inside the opening), after the hedge fixup and
// after the deficit carry (both inside the end; 0 with the lanes off);
// then the opening's words: block 0's clock after the lists' barrier, the
// admission's and the sorts' (the re-base alone on the full-length path);
// then the counts:
// free slots, placeable tasks, n_match, 1 on the full-length path.
constexpr int kStampRounds = 64;
constexpr int kStampRound = 4;
constexpr int kStampClose = kStampRound + 5 * kStampRounds;
constexpr int kStampLanes = kStampClose + 2;
constexpr int kStampOpen = kStampLanes + 4;
constexpr int kStampCount = kStampOpen + 3;
constexpr int kAuStamps = kStampCount + 4;
#ifdef TPU_FAAS_PROBE
#define PROBE(...) __VA_ARGS__
#else
#define PROBE(...)
#endif

struct Dims {
  int T, W, I, KA, KH, KF, KI, KS, KB, KP, KR, KG, K, use_priority, flush;
};

struct State {
  float* sizes;
  uint8_t* valid;
  // the set placement reads as valid: `valid` itself with tenancy off, the
  // eligibility mask (valid minus the tasks past their tenant's inflight
  // allowance) with it on; arrivals, compaction and n_pending read `valid`
  const uint8_t* place_valid;
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
  int32_t* aux;           // [4] auction: rounds run, tasks spilled,
                          //     bidder rows summed over the rounds, and 1
                          //     on a tick that took the full-length path
};

struct Scratch {
  uint32_t* sk[2];  // slot sort keys, ping-pong [S]
  int32_t* sv[2];   // slot sort values [S]
  uint32_t* tk[2];  // task sort keys [T]
  int32_t* tv[2];   // task sort values [T]
  int32_t* assign;  // [T] worker per task, -1 queued
  int32_t* admitted;// [T] 0/1
};

// The auction's grid words: 0 the tick takes the full-length path, 1 the
// bits of the carried prices' least positive one (positive floats order as
// their bits), 2 the sorted admitted tasks' buffer, 3 the full-length
// opening's count of kept slots.
enum AuWord { kAuBad, kAuMin, kAuTaskBuf, kAuKept, kAuWords };

// The auction's carried leaves, its per-tick scratch and its constants. The
// rounds bid on positions of the kept list: position i is the kept slot
// kept[i], on either path.
struct Auction {
  float* price;          // [S] state leaf: slot prices
  uint8_t* refresh;      // [1] state leaf: open from the seed this tick
  unsigned long long* slot_bid;  // [S] this round's best (key, task) bid
                                 //     per position
  float* inv;            // [S] 1 / max(slot speed, 1e-6) per position
  int32_t* owner;        // [S] task owning the position, -1 none
  int32_t* assigned;     // [T] position of the task, -1 none
  int32_t* adm;          // [T] the admitted tasks, index order
  int32_t* free_id;      // [S] compacted path: the free slots, index order
  int32_t* kpos;         // [S] each free-list entry's (compacted path) or
                         //     slot's (full-length path) kept position, -1
                         //     none
  int32_t* kept;         // [S] the kept slots, ascending
  float* kprice;         // [S] ... and their prices
  int32_t* counts;       // [kRankCounts kMaxRankBlocks] per-block counts
  int32_t* word;         // [kAuWords]
  float* bid;            // [T] this round's bid price of each bidder
  int32_t* list[2];      // [T] bidders of even and odd rounds
  int32_t* cnt;          // [2] their counts
  int32_t* nonfinite;    // [1] a valid slot's inverse speed or price, or
                         //     the jitter, is not finite: bid by JAX's NaN
                         //     rule (bid_top2.cuh) in every row
  float* part_v1;        // [kMaxItems kRows] a round's partial top-2 per
  int32_t* part_b;       //   work item and row: v1, best, v2
  float* part_v2;
  int32_t* ticket;       // [kMaxItems] work items done per bidder group
  unsigned long long* stamps;  // [kAuStamps] phase clocks (probe build)
  float eps, jitter;
  int warm_rounds;
};

// The tenancy lane's leaves, packet tail, output and scratch.
struct Tenancy {
  int on;                  // use_tenancy
  int n;                   // NT: tenant rows
  int32_t* tenant;         // [T] state leaf: dense tenant row per task
  float* deficit;          // [n] state leaf: per-tenant deficit carry
  const float* share;      // [n] packet tail: weights
  const float* ahead;      // [n] packet tail: inflight per tenant
  const float* cap;        // [n] packet tail: inflight ceilings, 0 = none
  uint8_t* elig;           // [T] output: the placement's valid set
  int32_t* cnt;            // [n] scratch: placements per tenant row
  uint8_t* demand;         // [n] scratch: an eligible task this tick
  int32_t* tile_cnt;       // [n kMaxRankBlocks] scratch: per tenant
                           //   row, its tasks in each block's tile, then
                           //   their offsets over the blocks
  int32_t* tile_first;     // [n kMaxRankBlocks] ... its first position in
                           //   the tile's segment sort
  float starve_deficit, deficit_cap;
  int starve_boost;
};

// A radix select's scratch (radix_select): per pass each digit's count,
// least and greatest key; and the members' least and greatest key.
struct Select {
  unsigned long long* key;  // [n] the keys, kNoKey on a non-member
  int32_t* cnt;             // [kSelPasses RADIX]
  unsigned long long* mn;   // [kSelPasses RADIX]
  unsigned long long* mx;   // [kSelPasses RADIX]
  unsigned long long* mm;   // [2]
};

// The hedge fixup's per-block count rows.
enum FixCount { kFixVetoed, kFixCand, kFixStraggler, kFixCounts };

// The hedge fixup's grid scratch, in each branch's layout (fixup_layout).
struct Fixup {
  int32_t* cnt;               // [kFixCounts kMaxRankBlocks] per-block counts
  Select sel;                 // the candidate rows' keys [W] and their select
  unsigned long long* cand;   // [kFixupK + 1] the selected keys, unordered
  int32_t* n_cand;            // [1] their count
  int32_t* vet;               // [kFixupK] the first vetoed tasks, index order
};

// The speculation lane's leaves, packet lanes and scratch.
struct Spec {
  int on;                  // use_spec
  float* start;            // [I] state leaf: dispatch stamp per slot
  float* pred;             // [I] state leaf: predicted runtime per slot
  int32_t* avoid;          // [T] state leaf: forbidden worker row per task
  const float* tail;       // [2] packet: the multiplier and the floor
  int32_t* free_rem;       // [W] scratch: placements kept per row, then
                           //   the free slots left for the fixup
  Fixup fx;                // the fixup's grid scratch (the branch's layout)
};

struct Smem {
  union {
    int cnt[NWARP][RADIX];   // per-warp digit counts, then offsets
    unsigned long long sel_mm[2][RADIX];  // the rank select: each digit's
                                          // least and greatest key
  };
  int hist[4][RADIX];        // digit histogram of every pass
  int bucket[RADIX];         // running start of each digit's bucket
  int trivial[4];            // pass p has one digit for every key
  int scan[NWARP];           // block scan scratch
  int bcast[2];              // a value one thread hands the block
  int ten_cnt[kSmemTenants];  // tenancy: a tile's placements per tenant row,
                              // for n <= kSmemTenants
  float ten_wsum;            // tenancy: the share sum
  // speculation, the fixup's walk: the candidate keys as gathered, then
  // the candidates' rows in key order and whether their speed is NaN
  unsigned long long fx_key[kFixupK + 1];
  int fx_row[kFixupK + 1];
  uint8_t fx_nan[kFixupK + 1];
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

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// torch's clamp_min(x, m) on a float: NaN stays NaN, a tie keeps x
__device__ __forceinline__ float clamp_min(float x, float m) {
  return x < m ? m : x;
}

// ... and clamp_max
__device__ __forceinline__ float clamp_max(float x, float m) {
  return x > m ? m : x;
}

// torch.argmax / jnp.argmax order: a NaN is the maximum, and a tie goes to
// the lower index.
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  const bool an = a != a, bn = b != b;
  if (an || bn) return an && (!bn || ia < ib);
  return a > b || (a == b && ia < ib);
}

// Merge each lane's (value, index) into the warp's first maximum; every lane
// gets it.
__device__ __forceinline__ void warp_argmax_merge(float* v, int* i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(FULL, *v, o);
    const int i2 = __shfl_xor_sync(FULL, *i, o);
    if (beats(v2, i2, *v, *i)) {
      *v = v2;
      *i = i2;
    }
  }
}

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

// Minimum over the block of one float per thread (no NaN among them).
// Every thread of the block must call it; every thread gets the result.
__device__ float block_min(float v, Smem& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  if (lane == 0) sm.scan[warp] = __float_as_int(v);
  __syncthreads();
  float m = __int_as_float(sm.scan[0]);
  for (int w = 1; w < NWARP; ++w) m = fminf(m, __int_as_float(sm.scan[w]));
  __syncthreads();  // sm.scan is reused by the next call
  return m;
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

// ---- phase 1: apply the delta packet (resident.py::_apply_deltas) --------
// The packet's counts and lanes.
struct PacketLanes {
  int n_arr, n_hb, n_free, n_infl, n_speed, n_active;
  const float *arr_sizes, *arr_prio, *arr_tenant, *arr_avoid;
  const float *hb_idx, *hb_val, *free_idx, *free_val, *infl_idx, *infl_val,
      *pred_val, *sp_idx, *sp_val, *ac_idx, *ac_val;
};

// Parses the packet; *now and *tte get its clock and time_to_expire.
__device__ PacketLanes packet_lanes(const float* packet, const Dims& D,
                                    const Tenancy& tn, const Spec& sp,
                                    float* now, float* tte) {
  PacketLanes pk;
  *now = packet[0];
  pk.n_arr = f2i(packet[1]);
  pk.n_hb = f2i(packet[2]);
  pk.n_free = f2i(packet[3]);
  pk.n_infl = f2i(packet[4]);
  pk.n_speed = f2i(packet[5]);
  pk.n_active = f2i(packet[6]);
  *tte = packet[8];
  int off = HEADER;
  pk.arr_sizes = packet + off; off += D.KA;
  pk.arr_prio = packet + off; if (D.use_priority) off += D.KA;
  pk.arr_tenant = packet + off; if (tn.on) off += D.KA;
  pk.arr_avoid = packet + off; if (sp.on) off += D.KA;
  pk.hb_idx = packet + off; off += D.KH;
  pk.hb_val = packet + off; off += D.KH;
  pk.free_idx = packet + off; off += D.KF;
  pk.free_val = packet + off; off += D.KF;
  pk.infl_idx = packet + off; off += D.KI;
  pk.infl_val = packet + off; off += D.KI;
  pk.pred_val = packet + off; if (sp.on) off += D.KI;
  pk.sp_idx = packet + off; off += D.KS;
  pk.sp_val = packet + off; off += D.KS;
  pk.ac_idx = packet + off; off += D.KB;
  pk.ac_val = packet + off;
  return pk;
}

// The masked scatters (sentinel-drop; free counts additive), lane j taken by
// the threads first, first + stride, ...
__device__ void scatter_lanes(const PacketLanes& pk, const Dims& D,
                              const State& st, const Spec& sp, float now,
                              int first, int stride) {
  const int W = D.W, I = D.I;
  for (int j = first; j < D.KH && j < pk.n_hb; j += stride) {
    const int r = drop_index(f2i(pk.hb_idx[j]), W);
    if (r >= 0) st.last_hb[r] = pk.hb_val[j];
  }
  for (int j = first; j < D.KF && j < pk.n_free; j += stride) {
    const int r = drop_index(f2i(pk.free_idx[j]), W);
    if (r >= 0) atomicAdd(&st.free_cnt[r], f2i(pk.free_val[j]));
  }
  for (int j = first; j < D.KI && j < pk.n_infl; j += stride) {
    const int s = drop_index(f2i(pk.infl_idx[j]), I);
    if (s < 0) continue;
    const int v = f2i(pk.infl_val[j]);
    st.inflight[s] = v;
    if (sp.on) {
      // a dispatch is stamped with the packet's clock; a clear zeroes both
      sp.start[s] = v >= 0 ? now : 0.0f;
      sp.pred[s] = v >= 0 ? pk.pred_val[j] : 0.0f;
    }
  }
  for (int j = first; j < D.KS && j < pk.n_speed; j += stride) {
    const int r = drop_index(f2i(pk.sp_idx[j]), W);
    if (r >= 0) st.speed[r] = pk.sp_val[j];
  }
  for (int j = first; j < D.KB && j < pk.n_active; j += stride) {
    const int r = drop_index(f2i(pk.ac_idx[j]), W);
    if (r >= 0) st.active[r] = pk.ac_val[j] > 0.5f ? 1 : 0;
  }
}

// Arrival j (below the accepted count) into pending slot s.
__device__ __forceinline__ void put_arrival(const PacketLanes& pk,
                                            const Dims& D, const State& st,
                                            const Tenancy& tn,
                                            const Spec& sp, int j, int s) {
  st.sizes[s] = pk.arr_sizes[j];
  st.valid[s] = 1;
  if (D.use_priority) st.prio[s] = f2i(pk.arr_prio[j]);
  if (tn.on) tn.tenant[s] = f2i(pk.arr_tenant[j]);
  if (sp.on) sp.avoid[s] = f2i(pk.arr_avoid[j]);
}

// The whole phase on one block (the auction and Sinkhorn branches, and the
// flush). Returns the packet's clock and time_to_expire.
__device__ void apply_deltas(const float* packet, const Dims& D,
                             const State& st, const Tenancy& tn,
                             const Spec& sp, const Out& out, Smem& sm,
                             float* now, float* tte) {
  const int tid = threadIdx.x;
  const PacketLanes pk = packet_lanes(packet, D, tn, sp, now, tte);
  scatter_lanes(pk, D, st, sp, *now, tid, NT);
  // arrivals: the first KA invalid pending slots, in index order
  const int n_invalid = first_k(
      D.T, D.KA, out.arrival_slots, [&](int i) { return st.valid[i] == 0; },
      [](int, int) {}, sm);
  __syncthreads();
  const int accept = min(pk.n_arr, n_invalid);
  for (int j = tid; j < D.KA; j += NT) {
    if (j < accept) {
      put_arrival(pk, D, st, tn, sp, j, out.arrival_slots[j]);
    } else {
      out.arrival_slots[j] = -1;
    }
  }
}

// ---- phase 2: liveness, purge, redispatch (state.py) ----------------------
// jnp.maximum: a NaN in either operand is the result
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// liveness: hb_age = now - last_hb <= tte, on the post-scatter state
__device__ __forceinline__ bool row_live(const State& st, int w, float now,
                                         float tte) {
  const float age = now - st.last_hb[w];
  return st.active[w] && age <= tte;
}

// An in-flight slot of a dead row (redispatched), from out.live.
__device__ __forceinline__ bool dead_slot(const State& st, const Out& out,
                                          int W, int i) {
  const int iw = st.inflight[i];
  return iw >= 0 && !out.live[min(iw, W - 1)];
}

// A straggler (tpu_faas/spec/straggler.py): occupied on a live row, pred >
// 0, now - start past max(mult * pred, min_s) with NaN propagating.
__device__ __forceinline__ bool straggling(const State& st, const Out& out,
                                           const Spec& sp, int W, int i,
                                           float now) {
  const int iw = st.inflight[i];
  if (iw < 0 || !out.live[min(iw, W - 1)]) return false;
  const float pred = sp.pred[i];
  const float thr = max_nan(__fmul_rn(sp.tail[0], pred), sp.tail[1]);
  return pred > 0.0f && __fsub_rn(now, sp.start[i]) > thr;
}

__device__ void liveness(const Dims& D, const State& st, const Spec& sp,
                         const Out& out, float now, float tte, Smem& sm) {
  const int tid = threadIdx.x;
  const int W = D.W;
  for (int w = tid; w < W; w += NT) {
    const uint8_t l = row_live(st, w, now, tte) ? 1 : 0;
    out.purged[w] = (st.prev_live[w] && !l) ? 1 : 0;
    out.live[w] = l;
    st.prev_live[w] = l;
  }
  __syncthreads();
  first_k(D.I, D.KR, out.redispatch,
          [&](int i) { return dead_slot(st, out, W, i); }, [](int, int) {},
          sm);
  // with the speculation lane the grid lists the stragglers at the close
  // (fixup_rows): nothing this tick changes what they read after here
  if (!sp.on)
    for (int j = tid; j < D.KG; j += NT) out.straggler[j] = -1;
}

// Slot expansion (greedy.py's layout: slot s is process s % K of worker
// s / K, valid when live and below the free count free_cnt[w]), stably
// sorted by -speed with invalid slots last. Returns the sc.sv buffer holding
// the order; *n_slots gets the number of valid slots.
__device__ int sort_slots(const Dims& D, const State& st, const Out& out,
                          const int32_t* free_cnt, const Scratch& sc,
                          Smem& sm, int* n_slots) {
  const int K = D.K, S = D.W * K;
  int my_slots = 0;
  for (int s = threadIdx.x; s < S; s += NT) {
    const int w = s / K;
    const int f = out.live[w] ? free_cnt[w] : 0;
    const bool ok = (s - w * K) < f;
    my_slots += ok ? 1 : 0;
    sc.sk[0][s] = float_key(-(ok ? st.speed[w] : neg_inf()));
    sc.sv[0][s] = s;
  }
  block_exclusive_scan(my_slots, n_slots, sm);
  return block_radix_sort(sc.sk, sc.sv, S, sm);
}

// ---- phase 2b: tenancy admission (fairshare.py) --------------------------
__device__ __forceinline__ int tenant_row(const Tenancy& tn, int t) {
  return min(max(tn.tenant[t], 0), tn.n - 1);
}

// int32 arithmetic as XLA's: wraps
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

// The inflight-cap allowance of tenant row g: a task is eligible when its
// FCFS rank j within the tenant's valid backlog is below it.
__device__ __forceinline__ int tenant_allowance(const Dims& D,
                                                const Tenancy& tn, int g) {
  const int cap = f2i(tn.cap[g]);
  return cap > 0 ? max(wrap_sub(cap, f2i(tn.ahead[g])), 0) : D.T;
}

// ---- phase 3, rank over every slot and task (greedy.py) ------------------
// Places the tasks with task_ok[t] set onto the live workers' free_cnt
// slots, admitting FCFS, with greedy.py's full-length stable sorts on one
// block. Fills sc.assign (worker per task, -1 queued). Sinkhorn's spill
// passes its spilled tasks and remaining capacity; the rank branch passes
// its admitted set on a tick that a -inf or NaN speed or size sends down
// the full-length path (the set is no larger than the valid slots, so FCFS
// admits all of it).
template <class TaskOk>
__device__ void rank_place(const Dims& D, const State& st, const Out& out,
                           TaskOk task_ok, const int32_t* free_cnt,
                           const Scratch& sc, Smem& sm,
                           unsigned long long* stamp = nullptr) {
  const int tid = threadIdx.x;
  const int T = D.T, K = D.K, S = D.W * K;
  int n_slots_total;
  const int slot_buf =
      sort_slots(D, st, out, free_cnt, sc, sm, &n_slots_total);
  const int32_t* slot_order = sc.sv[slot_buf];
  PROBE(if (stamp && tid == 0) *stamp = global_ns();)

  // FCFS admission
  int lo, hi;
  chunk_of(T, &lo, &hi);
  int c = 0;
  for (int t = lo; t < hi; ++t) c += task_ok(t) ? 1 : 0;
  int total;
  int rank = block_exclusive_scan(c, &total, sm);
  for (int t = lo; t < hi; ++t) {
    const bool v = task_ok(t);
    sc.admitted[t] = (v && rank < n_slots_total) ? 1 : 0;
    rank += v ? 1 : 0;
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
}

// ---- phase 4: compaction (resident.py::_resident_tick_impl) --------------
__device__ void compact(const Dims& D, const State& st, const Out& out,
                        const int32_t* assign, Smem& sm) {
  const int tid = threadIdx.x;
  const int T = D.T;
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

// ---- rank placement over the grid (fused_rank_kernel) ---------------------
// One cooperative launch of one 1024-thread block per SM. Each index range
// (tasks, workers, in-flight slots) is cut into one contiguous tile per
// block; a block walks its tile in chunks of NT consecutive indices (one
// per thread, so a warp's loads coalesce), counts what it keeps, and after a
// grid barrier takes its offset from the scan of the blocks' counts: every
// list it emits stays in index order, as greedy.py's stable sorts need.
// per-block counts, one row of kMaxRankBlocks each
enum RankCount {
  kCntInvalid,     // invalid pending slots (arrivals)
  kCntRedispatch,  // in-flight slots of dead rows
  kCntStraggler,   // straggler slots (speculation)
  kCntSlots,       // valid slots
  kCntMembers,     // tasks the admission ranks (key != kNoKey)
  kCntLt,          // members whose key is below the threshold
  kCntEq,          // members whose key equals it
  kCntPlaced,      // tasks with a worker
  kCntValid,       // valid pending slots
  kRankCounts
};
// The rank branch's words: 0 a valid slot or an admitted task sorts among
// the invalid ones (take the full-length path), 1 admitted tasks, 2 the
// sorted slot buffer, 3 the sorted task buffer, 4 ticks that took the
// full-length path (kept across launches: the wrapper zeroes it once), 5
// padding (an even count keeps the stamps after them aligned).
enum RankWord { kWordBad, kWordTasks, kWordSlotBuf, kWordTaskBuf,
                kWordFallbacks, kWordPad, kRankWords };
// The rank branch's phase stamps (a probe build alone writes them): 0
// start, then block 0's clock at the end of 1 the packet's scatters, 2 the
// arrivals and liveness, 3 the lists (the valid slots, the admission keys
// or, with tenancy, the tiles' segment sorts), 4 the tenancy lane's j,
// eligibility and keys, 5 the select, 6 the admission with the redispatch
// and straggler lists, 7 the sorts, 8 the pairing, 9 the hedge fixup, 10
// the counts for compaction and the deficit's, their barrier and block 0's
// deficit carry, 11 the compaction; then
// the counts 12 valid slots, 13 admitted tasks, 14 select passes, 15 1 on
// the full-length path. Each grid phase ends at its barrier.
constexpr int kRkStamps = 16;

__device__ __forceinline__ unsigned long long min64(unsigned long long a,
                                                    unsigned long long b) {
  return a < b ? a : b;
}
__device__ __forceinline__ unsigned long long max64(unsigned long long a,
                                                    unsigned long long b) {
  return a > b ? a : b;
}

struct Rank {
  int32_t* cnt;                // [kRankCounts kMaxRankBlocks]
  unsigned long long* key;     // [T] admission keys
  int32_t* sel_cnt;            // [kSelPasses RADIX] a pass's digit counts
  unsigned long long* sel_min; // [kSelPasses RADIX] ... each digit's least key
  unsigned long long* sel_max; // [kSelPasses RADIX] ... and greatest
  unsigned long long* key_mm;  // [2] the members' least and greatest key
  int32_t* word;               // [kRankWords]
  unsigned long long* stamps;  // [kRkStamps]
};

// This block's contiguous tile of [0, n).
__device__ __forceinline__ void tile_of(int n, int* lo, int* hi) {
  const int c = (n + gridDim.x - 1) / gridDim.x;
  *lo = min(static_cast<int>(blockIdx.x) * c, n);
  *hi = min(*lo + c, n);
}

// Row r of a table of per-block counts (kMaxRankBlocks words a row).
__device__ __forceinline__ int32_t* count_row(int32_t* cnt, int r) {
  return cnt + r * kMaxRankBlocks;
}

// One block's count into a row of per-block counts (every thread calls it).
__device__ __forceinline__ void put_count(int32_t* row, int mine, Smem& sm) {
  int total;
  block_exclusive_scan(mine, &total, sm);
  if (threadIdx.x == 0) row[blockIdx.x] = total;
}

__device__ __forceinline__ void put_count(const Rank& rk, int r, int mine,
                                          Smem& sm) {
  put_count(count_row(rk.cnt, r), mine, sm);
}

// This block's offset in the scan of a count row over the blocks; *total
// gets the grid's sum. Every thread calls it, after a grid barrier.
__device__ int grid_offset(const int32_t* row, int* total, Smem& sm) {
  const int tid = threadIdx.x;
  const int v = tid < static_cast<int>(gridDim.x) ? row[tid] : 0;
  const int excl = block_exclusive_scan(v, total, sm);
  if (tid == static_cast<int>(blockIdx.x)) sm.bcast[0] = excl;
  __syncthreads();
  const int off = sm.bcast[0];
  __syncthreads();
  return off;
}

__device__ __forceinline__ int grid_offset(const Rank& rk, int r, int* total,
                                           Smem& sm) {
  return grid_offset(count_row(rk.cnt, r), total, sm);
}

// The i in [lo, hi) with mask(i), in index order, at base + their rank:
// emit(i, position). Every thread calls it (the loop is block-uniform).
template <class Mask, class Emit>
__device__ void tile_emit(int lo, int hi, int base, Mask mask, Emit emit,
                          Smem& sm) {
  for (int c = lo; c < hi; c += NT) {
    const int i = c + threadIdx.x;
    const bool m = i < hi && mask(i);
    int total;
    const int at = block_exclusive_scan(m ? 1 : 0, &total, sm);
    if (m) emit(i, base + at);
    base += total;
  }
}

// The first K indices of mask over [0, n) into out[K], -1 padded, from the
// blocks' counts in `row` (rank_count put them there before the barrier).
template <class Mask>
__device__ void grid_first_k(const int32_t* row, int n, int K, int32_t* out,
                             Mask mask, Smem& sm) {
  int total;
  const int off = grid_offset(row, &total, sm);
  int lo, hi;
  tile_of(n, &lo, &hi);
  if (off < K)
    tile_emit(lo, hi, off, mask, [&](int i, int p) { if (p < K) out[p] = i; },
              sm);
  const int gthread = blockIdx.x * NT + threadIdx.x;
  for (int j = total + gthread; j < K; j += gridDim.x * NT) out[j] = -1;
}

template <class Mask>
__device__ __forceinline__ void grid_first_k(const Rank& rk, int r, int n,
                                             int K, int32_t* out, Mask mask,
                                             Smem& sm) {
  grid_first_k(count_row(rk.cnt, r), n, K, out, mask, sm);
}

// The count of mask over this block's tile of [0, n) into a count row.
template <class Mask>
__device__ void rank_count(int32_t* row, int n, Mask mask, Smem& sm) {
  int lo, hi;
  tile_of(n, &lo, &hi);
  int mine = 0;
  for (int i = lo + threadIdx.x; i < hi; i += NT) mine += mask(i) ? 1 : 0;
  put_count(row, mine, sm);
}

template <class Mask>
__device__ __forceinline__ void rank_count(const Rank& rk, int r, int n,
                                           Mask mask, Smem& sm) {
  rank_count(count_row(rk.cnt, r), n, mask, sm);
}

// The valid slots of row w: min(free, K) on a live row (free may be
// negative or past K).
__device__ __forceinline__ int row_slots(const Dims& D, const State& st,
                                         const Out& out, int w) {
  return out.live[w] ? min(max(st.free_cnt[w], 0), D.K) : 0;
}

// ---- grid phases shared by the rank and auction branches -----------------
// Each takes the branch's table of per-block counts (RankCount rows).

// Phase 2's arrivals, after the invalid pending slots were counted into row
// kCntInvalid and a grid barrier: the first min(n_arr, invalid, KA) invalid
// pending slots of the pre-arrival state, in index order.
__device__ void grid_arrivals(const PacketLanes& pk, const Dims& D,
                              const State& st, const Tenancy& tn,
                              const Spec& sp, const Out& out, int32_t* cnt,
                              Smem& sm) {
  int n_invalid;
  const int off = grid_offset(count_row(cnt, kCntInvalid), &n_invalid, sm);
  const int accept = max(min(min(pk.n_arr, n_invalid), D.KA), 0);
  int lo, hi;
  tile_of(D.T, &lo, &hi);
  if (off < accept)
    tile_emit(lo, hi, off, [&](int i) { return st.valid[i] == 0; },
              [&](int s, int j) {
                if (j >= accept) return;
                out.arrival_slots[j] = s;
                put_arrival(pk, D, st, tn, sp, j, s);
              },
              sm);
  for (int j = accept + blockIdx.x * NT + threadIdx.x; j < D.KA;
       j += gridDim.x * NT)
    out.arrival_slots[j] = -1;
}

// Phase 2's liveness: each row's liveness, purge and carried flag, and its
// valid slots counted into row kCntSlots; *bad_word gets 1 where a valid
// slot's -speed would sort among the invalid slots' +inf (a -inf or NaN
// speed).
__device__ void grid_liveness(const Dims& D, const State& st, const Out& out,
                              float now, float tte, int32_t* cnt,
                              int32_t* bad_word, Smem& sm) {
  int lo, hi;
  tile_of(D.W, &lo, &hi);
  int slots = 0;
  bool bad = false;
  for (int w = lo + threadIdx.x; w < hi; w += NT) {
    const uint8_t l = row_live(st, w, now, tte) ? 1 : 0;
    out.purged[w] = (st.prev_live[w] && !l) ? 1 : 0;
    out.live[w] = l;
    st.prev_live[w] = l;
    const int n = l ? min(max(st.free_cnt[w], 0), D.K) : 0;
    slots += n;
    bad |= n > 0 && !(st.speed[w] > neg_inf());
  }
  put_count(count_row(cnt, kCntSlots), slots, sm);
  if (__syncthreads_or(bad) && threadIdx.x == 0) *bad_word = 1;
}

// Phase 3's valid slots (live, below the free count) listed in index order
// from the counts of row kCntSlots: emit(p, s, key) for list position p,
// slot s and its sort key float_key(-speed). Returns the valid slots.
template <class Emit>
__device__ int grid_slot_list(const Dims& D, const State& st, const Out& out,
                              int32_t* cnt, Emit emit, Smem& sm) {
  int n_slots;
  const int off = grid_offset(count_row(cnt, kCntSlots), &n_slots, sm);
  int lo, hi;
  tile_of(D.W, &lo, &hi);
  int base = off;
  for (int c = lo; c < hi; c += NT) {
    const int w = c + threadIdx.x;
    const int n = w < hi ? row_slots(D, st, out, w) : 0;
    int total;
    const int p = base + block_exclusive_scan(n, &total, sm);
    if (n) {
      const uint32_t key = float_key(-st.speed[w]);
      for (int k = 0; k < n; ++k) emit(p + k, w * D.K + k, key);
    }
    base += total;
  }
  return n_slots;
}

// The compaction's counts: the tasks with a worker (row kCntPlaced) and the
// valid tasks (row kCntValid).
__device__ void compact_counts(const Dims& D, const State& st,
                               const int32_t* assign, int32_t* cnt,
                               Smem& sm) {
  int lo, hi;
  tile_of(D.T, &lo, &hi);
  int placed = 0, valid = 0;
  for (int t = lo + threadIdx.x; t < hi; t += NT) {
    placed += assign[t] >= 0;
    valid += st.valid[t];
  }
  put_count(count_row(cnt, kCntPlaced), placed, sm);
  put_count(count_row(cnt, kCntValid), valid, sm);
}

// The compaction, after compact_counts and a grid barrier: the first KP
// placements in index order (each clears its valid bit and takes its slot
// on the device), and n_pending, added into out.n_pending (zeroed before
// the first barrier): the valid tasks less those the reported placements
// cleared (a full-length path can place an invalid task, as greedy.py's
// sorts do when a -inf or NaN size ties them).
__device__ void grid_compact(const Dims& D, const State& st, const Out& out,
                             const int32_t* assign, int32_t* cnt, Smem& sm) {
  int n_placed, n_valid;
  const int off = grid_offset(count_row(cnt, kCntPlaced), &n_placed, sm);
  grid_offset(count_row(cnt, kCntValid), &n_valid, sm);
  int lo, hi;
  tile_of(D.T, &lo, &hi);
  int cleared = 0;
  if (off < D.KP)
    tile_emit(lo, hi, off, [&](int t) { return assign[t] >= 0; },
              [&](int t, int p) {
                if (p >= D.KP) return;
                const int row = assign[t];
                out.placed_slots[p] = t;
                out.placed_rows[p] = row;
                cleared += st.valid[t];
                st.valid[t] = 0;  // clear ONLY reported placements
                atomicAdd(&st.free_cnt[row], -1);
              },
              sm);
  for (int j = n_placed + blockIdx.x * NT + threadIdx.x; j < D.KP;
       j += gridDim.x * NT) {
    out.placed_slots[j] = -1;
    out.placed_rows[j] = -1;
  }
  int total;
  block_exclusive_scan(cleared, &total, sm);
  if (threadIdx.x == 0)
    atomicAdd(out.n_pending, (blockIdx.x == 0 ? n_valid : 0) - total);
}

// The tenancy lane's admission over the grid, part 1 (after the arrivals):
// each block stably sorts its tile of tasks by segment (the tenant row, N
// for an invalid task) in place in the task scratch, and writes per tenant
// row g its count in the tile (tile_cnt[g * kMaxRankBlocks + b], 0 when
// absent) and the first sorted position (tile_first, when present).
// Returns the sort's buffer.
__device__ int rank_tenancy_tiles(const Dims& D, const State& st,
                                  const Tenancy& tn, const Scratch& sc,
                                  Smem& sm) {
  const int tid = threadIdx.x, N = tn.n, b = blockIdx.x;
  int lo, hi;
  tile_of(D.T, &lo, &hi);
  const int n = hi - lo;
  for (int i = tid; i < n; i += NT) {
    const int t = lo + i;
    sc.tk[0][t] = st.valid[t] ? static_cast<uint32_t>(tenant_row(tn, t))
                              : static_cast<uint32_t>(N);
    sc.tv[0][t] = t;
  }
  for (int g = tid; g < N; g += NT) tn.tile_cnt[g * kMaxRankBlocks + b] = 0;
  __syncthreads();
  uint32_t* const k[2] = {sc.tk[0] + lo, sc.tk[1] + lo};
  int32_t* const v[2] = {sc.tv[0] + lo, sc.tv[1] + lo};
  const int buf = block_radix_sort(k, v, n, sm);
  const uint32_t* seg = k[buf];
  for (int i = tid; i < n; i += NT) {
    const uint32_t g = seg[i];
    if (g >= static_cast<uint32_t>(N)) continue;
    const int at = static_cast<int>(g) * kMaxRankBlocks + b;
    if (i == 0 || seg[i - 1] != g) {
      tn.tile_first[at] = i;
      atomicSub(&tn.tile_cnt[at], i);
    }
    if (i == n - 1 || seg[i + 1] != g) atomicAdd(&tn.tile_cnt[at], i + 1);
  }
  return buf;
}

// Part 2: each tenant row's tile counts become exclusive offsets over the
// blocks, one warp a row.
__device__ void rank_tenancy_scan(const Tenancy& tn) {
  const int lane = threadIdx.x & 31;
  const int G = gridDim.x;
  const int per = (G + 31) / 32;
  for (int g = blockIdx.x * NWARP + (threadIdx.x >> 5); g < tn.n;
       g += gridDim.x * NWARP) {
    int32_t* row = tn.tile_cnt + g * kMaxRankBlocks;
    int mine = 0;
    for (int i = lane * per; i < min(G, lane * per + per); ++i) mine += row[i];
    int x = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    int run = x - mine;
    for (int i = lane * per; i < min(G, lane * per + per); ++i) {
      const int c = row[i];
      row[i] = run;
      run += c;
    }
  }
}

// Part 3: j (the FCFS rank within the tenant's valid backlog), the
// eligibility, the demand words and each task's admission key: eligible
// tasks by int_key(-eff_prio), then float_key(v), with v = (j + 1 - d) /
// share as the plain version rounds it and eff_prio in XLA's int32
// arithmetic; kNoKey on the others. Returns this block's members.
__device__ int rank_tenancy_keys(const Dims& D, const State& st,
                                 const Tenancy& tn, const Scratch& sc,
                                 const Rank& rk, int buf,
                                 unsigned long long* kmin,
                                 unsigned long long* kmax) {
  const int N = tn.n, b = blockIdx.x;
  int lo, hi;
  tile_of(D.T, &lo, &hi);
  const uint32_t* seg = sc.tk[buf] + lo;
  const int32_t* by_seg = sc.tv[buf] + lo;
  int mine = 0;
  for (int i = threadIdx.x; i < hi - lo; i += NT) {
    const uint32_t g = seg[i];
    const int t = by_seg[i];
    unsigned long long key = kNoKey;
    if (g < static_cast<uint32_t>(N)) {
      const int at = static_cast<int>(g) * kMaxRankBlocks + b;
      const int j = tn.tile_cnt[at] + i - tn.tile_first[at];
      if (j < tenant_allowance(D, tn, g)) {
        tn.demand[g] = 1;
        const float v = __fdiv_rn(
            __fsub_rn(__fadd_rn(static_cast<float>(j), 1.0f), tn.deficit[g]),
            clamp_min(tn.share[g], 1e-6f));
        const int prio = D.use_priority ? st.prio[t] : 0;
        const int boost =
            tn.deficit[g] >= tn.starve_deficit ? tn.starve_boost : 0;
        key = (static_cast<unsigned long long>(
                   int_key(wrap_sub(0, wrap_add(prio, boost))))
               << 32) |
              float_key(v);
        ++mine;
        *kmin = min64(*kmin, key);
        *kmax = max64(*kmax, key);
      }
    }
    tn.elig[t] = key != kNoKey ? 1 : 0;
    rk.key[t] = key;
  }
  return mine;
}

// The members' least and greatest key, from each thread's, into mm[2].
__device__ void put_key_range(unsigned long long* mm, unsigned long long kmin,
                              unsigned long long kmax) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    kmin = min64(kmin, __shfl_xor_sync(FULL, kmin, o));
    kmax = max64(kmax, __shfl_xor_sync(FULL, kmax, o));
  }
  if ((threadIdx.x & 31) == 0 && kmin <= kmax) {
    atomicMin(mm, kmin);
    atomicMax(mm + 1, kmax);
  }
}

// The key at position k - 1 of the members' stable order over sel.key[n]
// (the rank admission's threshold: the n_slots-th smallest; the hedge
// fixup's candidate cut), found by a radix select, most significant byte
// first. Each pass histograms the members that share the chosen bucket's
// prefix by the first byte where its least and greatest key differ, with
// each digit's least and greatest key; a grid barrier; then every block
// picks the same digit. It ends when a bucket holds one key. *below gets
// the members below the threshold; returns the threshold and *passes the
// passes run. Every block calls it, after a barrier that orders sel.mm and
// after sel's per-pass words were reset.
__device__ unsigned long long radix_select(const Select& sel, int n, int k,
                                          int* below, int* passes, Smem& sm,
                                          cg::grid_group& grid) {
  const int tid = threadIdx.x;
  unsigned long long bmin = sel.mm[0], bmax = sel.mm[1];
  int lo, hi;
  tile_of(n, &lo, &hi);
  int p = 0;
  *below = 0;
  while (bmin != bmax) {
    const int top = 63 - __clzll(static_cast<long long>(bmin ^ bmax));
    const int shift = top & ~7;
    unsigned long long* mn = sm.sel_mm[0];
    unsigned long long* mx = sm.sel_mm[1];
    if (tid < RADIX) {
      sm.hist[0][tid] = 0;
      mn[tid] = kNoKey;
      mx[tid] = 0;
    }
    __syncthreads();
    for (int t = lo + tid; t < hi; t += NT) {
      const unsigned long long key = sel.key[t];
      if (key == kNoKey) continue;
      if (shift < 56 && ((key ^ bmin) >> (shift + 8)) != 0) continue;
      const int d = static_cast<int>((key >> shift) & 0xff);
      atomicAdd(&sm.hist[0][d], 1);
      atomicMin(mn + d, key);
      atomicMax(mx + d, key);
    }
    __syncthreads();
    if (tid < RADIX && sm.hist[0][tid]) {
      atomicAdd(sel.cnt + p * RADIX + tid, sm.hist[0][tid]);
      atomicMin(sel.mn + p * RADIX + tid, mn[tid]);
      atomicMax(sel.mx + p * RADIX + tid, mx[tid]);
    }
    grid.sync();
    // the digit whose keys hold position k - 1 - below
    const int c = tid < RADIX ? sel.cnt[p * RADIX + tid] : 0;
    int n_in;
    const int at = block_exclusive_scan(c, &n_in, sm);
    const int r = k - 1 - *below;
    if (tid < RADIX && at <= r && r < at + c) {
      sm.bcast[0] = tid;
      sm.bcast[1] = at;
    }
    __syncthreads();
    const int d = sm.bcast[0];
    *below += sm.bcast[1];
    bmin = sel.mn[p * RADIX + d];
    bmax = sel.mx[p * RADIX + d];
    __syncthreads();
    ++p;
  }
  *passes = p;
  return bmin;
}

// ---- the lanes over the grid ----------------------------------------------
// The tenancy lane's eligibility in the auction and Sinkhorn branches (after
// block 0's packet and liveness and a grid barrier): the rank branch's tiles
// and their scan, then per task j, the eligibility tn.elig and the demand
// words as rank_tenancy_keys computes them (these branches admit FCFS from
// the eligibility alone: no keys). Every block calls it; the caller's grid
// barrier orders its writes.
__device__ void grid_tenancy_elig(const Dims& D, const State& st,
                                  const Tenancy& tn, const Scratch& sc,
                                  Smem& sm, cg::grid_group& grid) {
  const int buf = rank_tenancy_tiles(D, st, tn, sc, sm);
  grid.sync();
  rank_tenancy_scan(tn);
  grid.sync();
  const int N = tn.n, b = blockIdx.x;
  int lo, hi;
  tile_of(D.T, &lo, &hi);
  const uint32_t* seg = sc.tk[buf] + lo;
  const int32_t* by_seg = sc.tv[buf] + lo;
  for (int i = threadIdx.x; i < hi - lo; i += NT) {
    const uint32_t g = seg[i];
    bool e = false;
    if (g < static_cast<uint32_t>(N)) {
      const int at = static_cast<int>(g) * kMaxRankBlocks + b;
      const int j = tn.tile_cnt[at] + i - tn.tile_first[at];
      e = j < tenant_allowance(D, tn, g);
      if (e) tn.demand[g] = 1;
    }
    tn.elig[by_seg[i]] = e ? 1 : 0;
  }
}

// ---- phase 4: the deficit carry (fairshare.py::tenant_deficit_update_impl)
// The counts, every block over its tile of the final assignment: a
// shared-memory histogram added into tn.cnt (zeroed before the kernel's
// first grid barrier) for up to kSmemTenants rows, global atomics past
// that. They are integers: the order of the adds does not matter.
__device__ void deficit_counts(const Dims& D, const Tenancy& tn,
                               const int32_t* assign, Smem& sm) {
  const int tid = threadIdx.x, N = tn.n;
  int lo, hi;
  tile_of(D.T, &lo, &hi);
  if (N > kSmemTenants) {
    for (int t = lo + tid; t < hi; t += NT)
      if (assign[t] >= 0) atomicAdd(&tn.cnt[tenant_row(tn, t)], 1);
    return;
  }
  for (int g = tid; g < N; g += NT) sm.ten_cnt[g] = 0;
  __syncthreads();
  for (int t = lo + tid; t < hi; t += NT)
    if (assign[t] >= 0) atomicAdd(&sm.ten_cnt[tenant_row(tn, t)], 1);
  __syncthreads();
  for (int g = tid; g < N; g += NT)
    if (sm.ten_cnt[g]) atomicAdd(&tn.cnt[g], sm.ten_cnt[g]);
}

// The carry, on block 0 after a grid barrier, in the plain version's order:
// the placements summed from the counts, the share sum ONE float64 running
// sum in index order rounded once (its terms staged in shared memory by the
// block for up to kSumTerms rows, so that one thread's running sum waits on
// no global load), then each tenant row's expression.
constexpr int kSumTerms = NWARP * RADIX;  // floats in Smem::cnt
__device__ __forceinline__ float share_term(const Tenancy& tn, int i) {
  return tn.demand[i] ? clamp_min(tn.share[i], 1e-6f) : 0.0f;
}

__device__ void deficit_carry(const Tenancy& tn, Smem& sm) {
  const int tid = threadIdx.x, N = tn.n;
  float* terms = reinterpret_cast<float*>(&sm.cnt[0][0]);
  const bool staged = N <= kSumTerms;
  int mine = 0;
  for (int g = tid; g < N; g += NT) {
    mine += tn.cnt[g];
    if (staged) terms[g] = share_term(tn, g);
  }
  int total;
  block_exclusive_scan(mine, &total, sm);  // also the barrier for terms
  if (tid == 0) {
    // w.sum(): ONE float64 running sum in index order, rounded once
    double acc = 0.0;
    if (staged) {
#pragma unroll 8
      for (int i = 0; i < N; ++i) acc += static_cast<double>(terms[i]);
    } else {
      for (int i = 0; i < N; ++i)
        acc += static_cast<double>(share_term(tn, i));
    }
    sm.ten_wsum = static_cast<float>(acc);
  }
  __syncthreads();
  const float wsum = clamp_min(sm.ten_wsum, 1e-9f);
  for (int i = tid; i < N; i += NT) {
    float d = 0.0f;
    if (tn.demand[i]) {
      const float w = clamp_min(tn.share[i], 1e-6f);
      const float entitled =
          __fmul_rn(__fdiv_rn(w, wsum), static_cast<float>(total));
      d = __fsub_rn(__fadd_rn(tn.deficit[i], entitled),
                    static_cast<float>(tn.cnt[i]));
      d = clamp_max(clamp_min(d, 0.0f), tn.deficit_cap);
    }
    tn.deficit[i] = d;
  }
  __syncthreads();
}

// The hedge fixup (straggler.py::hedge_fixup_impl), in every branch after
// placement: the veto of tasks placed on their avoid row, the free slots
// left (the RAW free count on a live row less the placements kept after the
// veto, int32 wrapping as XLA's, floored at 0), and the first kFixupK vetoed
// tasks in index order, each placed in turn on jnp.argmax's row of `live &
// slots left & not its avoid row ? speed : -inf` (the first maximum, a NaN
// the maximum); a task whose best is -inf or NaN stays queued and takes no
// slot. Over the grid, in four parts with a grid barrier between them:
//   1. each block counts its tile's vetoed tasks and adds each placement it
//      keeps into its row's word of sp.free_rem;
//   2. the first kFixupK vetoed tasks listed in index order at the blocks'
//      offsets, every vetoed task cleared, each row's slots left into
//      sp.free_rem, and each candidate row's key: a row with slots left
//      whose speed is not -inf (such a row never beats the mask's -inf),
//      keyed (~float_key(speed) << 32) | row, so ascending keys run NaN
//      first, then by speed down, ties to the lower row (-0.0 is +0.0), and
//      every key is distinct;
//   3. with more than kFixupK + 1 candidates, the (kFixupK + 1)-th smallest
//      key by radix_select; every candidate key up to it gathered;
//   4. one warp of block 0 sorts the gathered keys (each key's rank among
//      them) into shared memory and walks the vetoed tasks: one ballot over
//      the list a task for the first row with slots left that is not its
//      avoid row; a NaN row there keeps the task queued, any other takes it
//      and one of its slots. No block barrier a step.
// Why kFixupK + 1 rows are enough: in key order, the rows before step k's
// pick are rows an earlier step emptied (a step takes one slot, so at most
// k of them, and k < kFixupK) and the task's own avoid row. So the pick lies
// among the first k + 2 <= kFixupK + 1 candidates, or there is none
// (tests/test_torch_lane_select.py holds the plain model of this walk,
// straggler.py::hedge_fixup_listed, to the reference, with a pick at list
// position kFixupK).
// The auction and Sinkhorn branches list the straggler slots in parts 1 and
// 2 as well; the rank branch lists them with its other lists.
static_assert(kFixupK <= 64, "the walk holds two steps a lane");

// The fixup's scratch, before the kernel's first grid barrier.
__device__ void fixup_reset(const Spec& sp, int W, int gthread,
                            int n_gthread) {
  const Select& sel = sp.fx.sel;
  for (int i = gthread; i < kSelPasses * RADIX; i += n_gthread) {
    sel.cnt[i] = 0;
    sel.mn[i] = kNoKey;
    sel.mx[i] = 0;
  }
  for (int w = gthread; w < W; w += n_gthread) sp.free_rem[w] = 0;
  if (gthread == 0) {
    sel.mm[0] = kNoKey;
    sel.mm[1] = 0;
    sp.fx.n_cand[0] = 0;
  }
}

__device__ __forceinline__ bool vetoed(const Spec& sp, const int32_t* assign,
                                       int t) {
  const int a = assign[t];
  return a >= 0 && sp.avoid[t] == a;
}

// Part 1, every block.
__device__ void fixup_count(const Dims& D, const State& st, const Out& out,
                            const Spec& sp, const int32_t* assign,
                            bool stragglers, float now, Smem& sm) {
  int lo, hi;
  tile_of(D.T, &lo, &hi);
  int mine = 0;
  for (int t = lo + threadIdx.x; t < hi; t += NT) {
    const int a = assign[t];
    if (a < 0) continue;
    if (sp.avoid[t] == a) {
      ++mine;
    } else {
      atomicAdd(&sp.free_rem[a], 1);
    }
  }
  put_count(count_row(sp.fx.cnt, kFixVetoed), mine, sm);
  if (stragglers)
    rank_count(count_row(sp.fx.cnt, kFixStraggler), D.I,
               [&](int i) { return straggling(st, out, sp, D.W, i, now); },
               sm);
}

// Part 2, every block. Returns the vetoed tasks (the same in every block).
__device__ int fixup_rows(const Dims& D, const State& st, const Out& out,
                          const Spec& sp, int32_t* assign, bool stragglers,
                          float now, Smem& sm) {
  const Fixup& fx = sp.fx;
  if (stragglers)
    grid_first_k(count_row(fx.cnt, kFixStraggler), D.I, D.KG, out.straggler,
                 [&](int i) { return straggling(st, out, sp, D.W, i, now); },
                 sm);
  int n_vet;
  grid_offset(count_row(fx.cnt, kFixVetoed), &n_vet, sm);
  if (n_vet == 0) return 0;
  grid_first_k(count_row(fx.cnt, kFixVetoed), D.T, kFixupK, fx.vet,
               [&](int t) { return vetoed(sp, assign, t); }, sm);
  __syncthreads();
  int lo, hi;
  tile_of(D.T, &lo, &hi);
  for (int t = lo + threadIdx.x; t < hi; t += NT)
    if (vetoed(sp, assign, t)) assign[t] = -1;
  tile_of(D.W, &lo, &hi);
  unsigned long long kmin = kNoKey, kmax = 0;
  int mine = 0;
  for (int w = lo + threadIdx.x; w < hi; w += NT) {
    const int rem =
        max(wrap_sub(out.live[w] ? st.free_cnt[w] : 0, sp.free_rem[w]), 0);
    sp.free_rem[w] = rem;
    const float v = st.speed[w];
    unsigned long long key = kNoKey;
    if (rem > 0 && v != neg_inf()) {
      key = (static_cast<unsigned long long>(~float_key(v)) << 32) |
            static_cast<uint32_t>(w);
      ++mine;
      kmin = min64(kmin, key);
      kmax = max64(kmax, key);
    }
    fx.sel.key[w] = key;
  }
  put_count(count_row(fx.cnt, kFixCand), mine, sm);
  put_key_range(fx.sel.mm, kmin, kmax);
  return n_vet;
}

// Part 3, every block.
__device__ void fixup_select(const Dims& D, const Spec& sp, Smem& sm,
                             cg::grid_group& grid) {
  const Fixup& fx = sp.fx;
  int n_cand;
  grid_offset(count_row(fx.cnt, kFixCand), &n_cand, sm);
  unsigned long long thr = kNoKey;
  if (n_cand > kFixupK + 1) {
    int below, passes;
    thr = radix_select(fx.sel, D.W, kFixupK + 1, &below, &passes, sm, grid);
  }
  int lo, hi;
  tile_of(D.W, &lo, &hi);
  for (int w = lo + threadIdx.x; w < hi; w += NT) {
    const unsigned long long key = fx.sel.key[w];
    if (key != kNoKey && key <= thr) fx.cand[atomicAdd(fx.n_cand, 1)] = key;
  }
}

// Part 4, the first warp of block 0.
__device__ void fixup_walk(const State& st, const Spec& sp, int32_t* assign,
                           int n_vet, Smem& sm) {
  const int lane = threadIdx.x & 31;
  const Fixup& fx = sp.fx;
  const int n_cand = fx.n_cand[0];
  for (int e = lane; e < n_cand; e += 32) sm.fx_key[e] = fx.cand[e];
  __syncwarp();
  for (int e = lane; e < n_cand; e += 32) {
    const unsigned long long key = sm.fx_key[e];
    int r = 0;
    for (int j = 0; j < n_cand; ++j) r += sm.fx_key[j] < key ? 1 : 0;
    const int w = static_cast<int>(static_cast<uint32_t>(key));
    sm.fx_row[r] = w;
    sm.fx_nan[r] = st.speed[w] != st.speed[w];
  }
  __syncwarp();
  // list position 32 q + lane in register q
  constexpr int kPer = (kFixupK + 1 + 31) / 32;
  int row[kPer], rem[kPer];
  bool nan_row[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int e = 32 * q + lane;
    row[q] = e < n_cand ? sm.fx_row[e] : -1;
    rem[q] = e < n_cand ? sp.free_rem[row[q]] : 0;
    nan_row[q] = e < n_cand && sm.fx_nan[e];
  }
  // step k's task and its avoid row in register k / 32 of lane k % 32
  const int n_steps = min(n_vet, kFixupK);
  int task[2], avoid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = 32 * h + lane;
    task[h] = k < n_steps ? fx.vet[k] : -1;
    avoid[h] = task[h] >= 0 ? sp.avoid[task[h]] : -1;
  }
  for (int k = 0; k < n_steps; ++k) {
    const int t = __shfl_sync(FULL, k < 32 ? task[0] : task[1], k & 31);
    const int av = __shfl_sync(FULL, k < 32 ? avoid[0] : avoid[1], k & 31);
    int pick = -1;  // warp-uniform: the first list position that fits
#pragma unroll
    for (int q = kPer - 1; q >= 0; --q) {
      const unsigned fit = __ballot_sync(FULL, rem[q] > 0 && row[q] != av);
      if (fit) pick = 32 * q + __ffs(fit) - 1;
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      if (pick == 32 * q + lane && !nan_row[q]) {
        assign[t] = row[q];
        --rem[q];
      }
    }
  }
}

// The fixup, parts 1-4; every block calls it. Returns whether it changed
// the assignment (then the caller orders block 0's walk before any other
// read of it).
__device__ bool grid_fixup(const Dims& D, const State& st, const Out& out,
                           const Spec& sp, int32_t* assign, bool stragglers,
                           float now, Smem& sm, cg::grid_group& grid) {
  fixup_count(D, st, out, sp, assign, stragglers, now, sm);
  grid.sync();
  const int n_vet = fixup_rows(D, st, out, sp, assign, stragglers, now, sm);
  if (n_vet == 0) return false;
  grid.sync();
  fixup_select(D, sp, sm, grid);
  grid.sync();
  if (blockIdx.x == 0 && threadIdx.x < 32)
    fixup_walk(st, sp, assign, n_vet, sm);
  return true;
}

// The lanes' close in the auction and Sinkhorn branches, after block 0 closed
// the placement: the hedge fixup (with the straggler list) and the deficit
// carry, over the grid. Every block calls it; block 0 then holds the final
// assignment and has carried the deficit. A probe build stamps block 0's
// clock after the fixup (stamps[0]) and after the carry (stamps[1]).
__device__ void lanes_close(const Dims& D, const State& st, const Out& out,
                            const Tenancy& tn, const Spec& sp,
                            int32_t* assign, float now,
                            unsigned long long* stamps, Smem& sm,
                            cg::grid_group& grid) {
  PROBE(const bool stamp = blockIdx.x == 0 && threadIdx.x == 0;)
  grid.sync();  // block 0's close wrote the assignment
  if (sp.on && grid_fixup(D, st, out, sp, assign, true, now, sm, grid) &&
      tn.on)
    grid.sync();  // block 0's walk, before every block's counts
  __syncthreads();
  PROBE(if (stamp) stamps[0] = global_ns();)
  if (tn.on) {
    deficit_counts(D, tn, assign, sm);
    grid.sync();
    if (blockIdx.x == 0) deficit_carry(tn, sm);
  }
  PROBE(if (stamp) stamps[1] = global_ns();)
}

__global__ void __launch_bounds__(NT, 1)
fused_rank_kernel(const float* __restrict__ packet, Dims D, State st,
                  Out out, Scratch sc, Rank rk, Tenancy tn, Spec sp) {
  __shared__ Smem sm;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, b = blockIdx.x, G = gridDim.x;
  const int gthread = b * NT + tid, n_gthread = G * NT;
  const int T = D.T, W = D.W, I = D.I, K = D.K, S = W * K;
  PROBE(const bool stamp = b == 0 && tid == 0;
        if (stamp) rk.stamps[0] = global_ns();)

  // -- 1: the packet's scatters; the invalid pending slots counted --------
  float now, tte;
  PacketLanes pk = packet_lanes(packet, D, tn, sp, &now, &tte);
  scatter_lanes(pk, D, st, sp, now, gthread, n_gthread);
  rank_count(rk, kCntInvalid, T, [&](int i) { return st.valid[i] == 0; },
             sm);
  // scratch the later phases accumulate into
  for (int i = gthread; i < kSelPasses * RADIX; i += n_gthread) {
    rk.sel_cnt[i] = 0;
    rk.sel_min[i] = kNoKey;
    rk.sel_max[i] = 0;
  }
  if (tn.on) {
    for (int g = gthread; g < tn.n; g += n_gthread) {
      tn.demand[g] = 0;
      tn.cnt[g] = 0;
    }
  }
  if (sp.on) fixup_reset(sp, W, gthread, n_gthread);
  if (gthread == 0) {
    rk.key_mm[0] = kNoKey;
    rk.key_mm[1] = 0;
    rk.word[kWordBad] = 0;
    rk.word[kWordTasks] = 0;
    out.n_pending[0] = 0;  // the compaction's blocks add into it
  }
  grid.sync();
  PROBE(if (stamp) rk.stamps[1] = global_ns();)

  // -- 2: arrivals into the first invalid pending slots; liveness; the
  // valid slots counted ---------------------------------------------------
  grid_arrivals(pk, D, st, tn, sp, out, rk.cnt, sm);
  grid_liveness(D, st, out, now, tte, rk.cnt, rk.word + kWordBad, sm);
  grid.sync();
  PROBE(if (stamp) rk.stamps[2] = global_ns();)

  // -- 3: redispatches and stragglers counted; the valid slots with their
  // sort keys; the admission keys (with tenancy: the tiles' segment sorts)
  rank_count(rk, kCntRedispatch, I,
             [&](int i) { return dead_slot(st, out, W, i); }, sm);
  if (sp.on)
    rank_count(rk, kCntStraggler, I,
               [&](int i) { return straggling(st, out, sp, W, i, now); },
               sm);
  const int n_slots = grid_slot_list(
      D, st, out, rk.cnt,
      [&](int p, int s, uint32_t key) {
        sc.sk[0][p] = key;
        sc.sv[0][p] = s;
      },
      sm);
  int lo_t, hi_t;
  tile_of(T, &lo_t, &hi_t);
  for (int t = lo_t + tid; t < hi_t; t += NT) sc.assign[t] = -1;
  int tile_buf = 0;
  if (tn.on) {
    tile_buf = rank_tenancy_tiles(D, st, tn, sc, sm);
  } else {
    // priority: greedy.py's key, -prio (wrapping) on a valid task and
    // INT32_MAX on the others, every task ranked; FCFS: the valid tasks,
    // all one key
    unsigned long long kmin = kNoKey, kmax = 0;
    int mine = 0;
    for (int t = lo_t + tid; t < hi_t; t += NT) {
      const bool v = st.valid[t] != 0;
      unsigned long long key;
      if (D.use_priority) {
        const int32_t k32 =
            v ? static_cast<int32_t>(0u - static_cast<uint32_t>(st.prio[t]))
              : INT32_MAX;
        key = static_cast<unsigned long long>(int_key(k32)) << 32;
      } else {
        key = v ? 0ull : kNoKey;
      }
      rk.key[t] = key;
      if (key != kNoKey) {
        ++mine;
        kmin = min64(kmin, key);
        kmax = max64(kmax, key);
      }
    }
    put_count(rk, kCntMembers, mine, sm);
    put_key_range(rk.key_mm, kmin, kmax);
  }
  grid.sync();
  PROBE(if (stamp) rk.stamps[3] = global_ns();)

  // -- 4: tenancy: j, the eligibility and the keys ------------------------
  if (tn.on) {
    rank_tenancy_scan(tn);
    grid.sync();
    unsigned long long kmin = kNoKey, kmax = 0;
    const int mine =
        rank_tenancy_keys(D, st, tn, sc, rk, tile_buf, &kmin, &kmax);
    put_count(rk, kCntMembers, mine, sm);
    put_key_range(rk.key_mm, kmin, kmax);
    grid.sync();
  }
  PROBE(if (stamp) rk.stamps[4] = global_ns();)

  // -- 5: the select: the threshold key and how many members equal to it
  // are admitted (the first `need` in index order) ------------------------
  int n_members;
  grid_offset(rk, kCntMembers, &n_members, sm);
  unsigned long long thr;
  int need = 0, passes = 0;
  bool counted = false;  // the kCntLt/kCntEq rows hold this tick's counts
  if (n_slots == 0) {
    thr = 0;  // nothing below it, and no equal one admitted
  } else if (n_slots >= n_members) {
    thr = kNoKey;  // every member below it
  } else {
    int below;
    thr = radix_select(
        Select{rk.key, rk.sel_cnt, rk.sel_min, rk.sel_max, rk.key_mm}, T,
        n_slots, &below, &passes, sm, grid);
    need = n_slots - below;
    if (passes) {
      int lt = 0, eq = 0;
      for (int t = lo_t + tid; t < hi_t; t += NT) {
        const unsigned long long key = rk.key[t];
        if (key == kNoKey) continue;
        lt += key < thr;
        eq += key == thr;
      }
      put_count(rk, kCntLt, lt, sm);
      put_count(rk, kCntEq, eq, sm);
      grid.sync();
      counted = true;
    }
  }
  PROBE(if (stamp) rk.stamps[5] = global_ns();)

  // -- 6: the redispatches and stragglers; the admission: the admitted
  // tasks in index order, keyed by -size for the task sort (a priority rank
  // held by an invalid task, only at the INT32_MAX key, leaves a hole keyed
  // past every size) --------------------------------------------------------
  grid_first_k(rk, kCntRedispatch, I, D.KR, out.redispatch,
               [&](int i) { return dead_slot(st, out, W, i); }, sm);
  if (sp.on) {
    grid_first_k(rk, kCntStraggler, I, D.KG, out.straggler,
                 [&](int i) { return straggling(st, out, sp, W, i, now); },
                 sm);
  } else {
    for (int j = gthread; j < D.KG; j += n_gthread) out.straggler[j] = -1;
  }
  int n_list;
  {
    int off_lt, off_eq, n_lt, n_eq;
    if (counted) {
      off_lt = grid_offset(rk, kCntLt, &n_lt, sm);
      off_eq = grid_offset(rk, kCntEq, &n_eq, sm);
    } else {
      // one key for every member (FCFS), all below the threshold, or none
      // admitted: the members' counts are the counts
      int n_m;
      const int off = grid_offset(rk, kCntMembers, &n_m, sm);
      const bool all_eq = thr != kNoKey;
      off_lt = all_eq ? 0 : off;
      n_lt = all_eq ? 0 : n_m;
      off_eq = all_eq ? off : 0;
      n_eq = all_eq ? n_m : 0;
    }
    n_list = n_lt + min(n_eq, need);
    int my_tasks = 0;
    bool bad = false;
    for (int c = lo_t; c < hi_t; c += NT) {
      const int t = c + tid;
      const unsigned long long key = t < hi_t ? rk.key[t] : kNoKey;
      const bool lt = key != kNoKey && key < thr;
      const bool eq = key != kNoKey && key == thr;
      int total;
      // lt and eq counts packed in one scan (each below 2^16 in a chunk)
      const int at = block_exclusive_scan((lt ? 1 << 16 : 0) | (eq ? 1 : 0),
                                          &total, sm);
      const int lt_before = off_lt + (at >> 16);
      const int eq_before = off_eq + (at & 0xffff);
      const bool cand = lt || (eq && eq_before < need);
      bool adm = false;
      if (cand) {
        const int p = lt_before + min(eq_before, need);
        adm = st.place_valid[t] != 0;
        const float size = st.sizes[t];
        sc.tk[0][p] = adm ? float_key(-size) : 0xffffffffu;
        sc.tv[0][p] = t;
        bad |= adm && !(size > neg_inf());
        my_tasks += adm;
      }
      if (t < hi_t) sc.admitted[t] = adm ? 1 : 0;
      off_lt += total >> 16;
      off_eq += total & 0xffff;
    }
    int total;
    block_exclusive_scan(my_tasks, &total, sm);
    if (tid == 0 && total) atomicAdd(rk.word + kWordTasks, total);
    if (__syncthreads_or(bad) && tid == 0) rk.word[kWordBad] = 1;
  }
  grid.sync();
  PROBE(if (stamp) rk.stamps[6] = global_ns();)

  // -- 7: the sorts: the valid slots by -speed on block 0, the admitted
  // tasks by -size on block 1, each list in index order, so the stable
  // sorts give greedy.py's first n_slots and n_tasks positions; a -inf or
  // NaN speed or size would sort among the invalid ones there, and such a
  // tick takes greedy.py's full-length sorts on block 0 ---------------------
  const bool bad = rk.word[kWordBad] != 0;
  const int n_tasks = rk.word[kWordTasks];
  if (bad) {
    if (b == 0) {
      rank_place(
          D, st, out, [&](int t) { return sc.admitted[t] != 0; },
          st.free_cnt, sc, sm);
      if (tid == 0) rk.word[kWordFallbacks] += 1;
    }
  } else {
    if (b == 0) {
      const int sb = block_radix_sort(sc.sk, sc.sv, n_slots, sm);
      if (tid == 0) rk.word[kWordSlotBuf] = sb;
    }
    if (b == (G > 1 ? 1 : 0)) {
      const int tb = block_radix_sort(sc.tk, sc.tv, n_list, sm);
      if (tid == 0) rk.word[kWordTaskBuf] = tb;
    }
  }
  grid.sync();
  PROBE(if (stamp) rk.stamps[7] = global_ns();)

  // -- 8: rank-for-rank pairs -------------------------------------------
  if (!bad) {
    const int32_t* slot_order = sc.sv[rk.word[kWordSlotBuf]];
    const int32_t* task_order = sc.tv[rk.word[kWordTaskBuf]];
    const int n_pairs = min(min(n_slots, n_tasks), min(T, S));
    for (int i = gthread; i < n_pairs; i += n_gthread)
      sc.assign[task_order[i]] = slot_order[i] / K;
    grid.sync();
  }
  PROBE(if (stamp) rk.stamps[8] = global_ns();)

  // -- 9: the hedge fixup over the grid -----------------------------------
  if (sp.on && grid_fixup(D, st, out, sp, sc.assign, false, now, sm, grid))
    grid.sync();
  PROBE(if (stamp) rk.stamps[9] = global_ns();)

  // -- 10: the placements and the valid tasks counted, and the deficit's
  // placements per tenant; the deficit carry on block 0 -----------------------
  compact_counts(D, st, sc.assign, rk.cnt, sm);
  if (tn.on) deficit_counts(D, tn, sc.assign, sm);
  grid.sync();
  if (tn.on && b == 0) deficit_carry(tn, sm);
  PROBE(if (stamp) rk.stamps[10] = global_ns();)

  // -- 11: the first KP placements and n_pending (grid_compact) ---------
  grid_compact(D, st, out, sc.assign, rk.cnt, sm);
  PROBE(if (stamp) {
    rk.stamps[11] = global_ns();
    rk.stamps[12] = n_slots;
    rk.stamps[13] = n_tasks;
    rk.stamps[14] = passes;
    rk.stamps[15] = bad;
  })
}

// The flush mode: the delta packet alone, on one block.
__global__ void __launch_bounds__(NT, 1)
fused_flush_kernel(const float* __restrict__ packet, Dims D, State st,
                   Out out, Tenancy tn, Spec sp) {
  __shared__ Smem sm;
  float now, tte;
  apply_deltas(packet, D, st, tn, sp, out, sm, &now, &tte);
}

// ---- the auction: the full-length opening (block 0) ----------------------
// A tick whose free slot has a -inf or NaN speed, or whose admitted task has
// a -inf or NaN size, opens here: such a key would sort among the invalid
// ones in the plain version's full-length sorts, which these keep.
//
// auction.py::_rank_dual_seed's prices in sorted order, p_sorted[j] for j <
// n: the j-th largest admitted size (size_sorted) against the j-th fastest
// slot (inv_sorted, its inverse speed), each price step the midpoint of its
// stability interval, summed from the slowest matched slot up; positions j
// >= n_match - 1 contribute +0.0 and keep a +0.0 sum. The reversed sum is
// ONE float64 running sum from the end, rounded per element: the order of
// the plain version's host cumsum.
template <class Size, class Inv>
__device__ void seed_prices(float* p_sorted, int n, int n_match,
                            Size size_sorted, Inv inv_sorted) {
  const int tid = threadIdx.x;
  for (int j = tid; j < n; j += NT) {
    float c = 0.0f;
    if (j + 1 < n_match) {  // j + 1 < min(T, S): both neighbours exist
      const float mid =
          __fmul_rn(__fadd_rn(size_sorted(j), size_sorted(j + 1)), 0.5f);
      const float diff = __fsub_rn(inv_sorted(j + 1), inv_sorted(j));
      c = __fmul_rn(mid, clamp_min(diff, 0.0f));
    }
    p_sorted[j] = c;
  }
  __syncthreads();
  if (tid == 0) {
    double acc = 0.0;
#pragma unroll 8
    for (int j = n_match - 2; j >= 0; --j) {
      acc += static_cast<double>(p_sorted[j]);
      p_sorted[j] = static_cast<float>(acc);
    }
  }
  __syncthreads();
}

// The seed over every slot and task into au.price.
__device__ void rank_dual_seed(const Dims& D, const State& st, const Out& out,
                               const Scratch& sc, const Auction& au,
                               const int32_t* slot_order, int n_match,
                               Smem& sm) {
  const int tid = threadIdx.x;
  const int T = D.T, K = D.K, S = D.W * K;
  // the admitted sizes in descending order: the stable sort of -tkey
  for (int t = tid; t < T; t += NT) {
    const float tkey = sc.admitted[t] ? st.sizes[t] : neg_inf();
    sc.tk[0][t] = float_key(-tkey);
    sc.tv[0][t] = t;
  }
  __syncthreads();
  const int b = block_radix_sort(sc.tk, sc.tv, T, sm);
  const int32_t* by_size = sc.tv[b];
  auto size_sorted = [&](int i) {
    const int t = by_size[i];
    return clamp_min(sc.admitted[t] ? st.sizes[t] : neg_inf(), 0.0f);
  };
  auto inv_sorted = [&](int i) {
    const int s = slot_order[i], w = s / K;
    const int f = out.live[w] ? st.free_cnt[w] : 0;
    const float key = (s - w * K) < f ? st.speed[w] : neg_inf();
    return __fdiv_rn(1.0f, clamp_min(key, 1e-6f));
  };
  float* p_sorted = reinterpret_cast<float*>(sc.sk[0]);
  seed_prices(p_sorted, S, n_match, size_sorted, inv_sorted);
  for (int i = tid; i < S; i += NT) au.price[slot_order[i]] = p_sorted[i];
}

// auction.py::_expand_and_square and the opening prices over every slot and
// task: the rank-dual seed on a refresh tick (on any other the grid
// re-based the carried prices). The kept slots -- the valid ones among the
// n_match fastest -- listed in ascending slot order as the compacted
// opening lists its own (au.kept, au.kpos by slot id, their count in
// au.word[kAuKept]), each position with its inverse speed, price, no owner
// and no bid; the non-finite flag over them; the admitted list and the
// first round's bidders (every admitted task, in index order). Returns
// n_match.
__device__ int auction_open(const Dims& D, const State& st, const Out& out,
                            const Scratch& sc, const Auction& au, Smem& sm) {
  const int tid = threadIdx.x;
  const int T = D.T, K = D.K, S = D.W * K;
  const bool refresh = au.refresh[0] != 0;  // read before it is rewritten
  int n_slots;
  const int slot_buf = sort_slots(D, st, out, st.free_cnt, sc, sm, &n_slots);
  const int32_t* slot_order = sc.sv[slot_buf];
  // FCFS admission of the first n_match valid tasks
  int lo, hi;
  chunk_of(T, &lo, &hi);
  int c = 0;
  for (int t = lo; t < hi; ++t) c += st.place_valid[t] ? 1 : 0;
  int n_valid;
  int rank = block_exclusive_scan(c, &n_valid, sm);
  const int n_match = min(n_slots, n_valid);
  for (int t = lo; t < hi; ++t) {
    const bool v = st.place_valid[t] != 0;
    const bool adm = v && rank < n_match;
    sc.admitted[t] = adm ? 1 : 0;
    au.assigned[t] = -1;
    if (adm) au.list[0][rank] = au.adm[rank] = t;
    rank += v ? 1 : 0;
  }
  // the valid slots among the n_match fastest are the auction's (a -inf or
  // NaN speed sorts among the invalid ones: they may be fewer than n_match)
  for (int s = tid; s < S; s += NT) au.kpos[s] = 0;
  __syncthreads();
  for (int i = tid; i < n_match; i += NT) {
    const int s = slot_order[i], w = s / K;
    const int f = out.live[w] ? st.free_cnt[w] : 0;
    if ((s - w * K) < f) au.kpos[s] = 1;
  }
  __syncthreads();
  int n_kept = 0;
  for (int c = 0; c < S; c += NT) {
    const int s = c + tid;
    const bool kept = s < S && au.kpos[s] != 0;
    int total;
    const int at = n_kept + block_exclusive_scan(kept ? 1 : 0, &total, sm);
    if (s < S) au.kpos[s] = kept ? at : -1;
    if (kept) au.kept[at] = s;
    n_kept += total;
  }
  if (refresh) rank_dual_seed(D, st, out, sc, au, slot_order, n_match, sm);
  __syncthreads();
  bool bad = !isfinite(au.jitter);
  for (int i = tid; i < n_kept; i += NT) {
    const int s = au.kept[i];
    au.inv[i] = __fdiv_rn(1.0f, clamp_min(st.speed[s / K], 1e-6f));
    au.owner[i] = -1;
    au.slot_bid[i] = kNoBid;
    au.kprice[i] = au.price[s];
    bad |= tpu_faas_bid::slot_nonfinite(au.inv[i], 1.0f, au.kprice[i]);
  }
  bad = __syncthreads_or(bad);
  if (tid == 0) {
    au.nonfinite[0] = bad ? 1 : 0;
    au.word[kAuKept] = n_kept;
    au.cnt[0] = n_match;
    au.cnt[1] = 0;
  }
  return n_match;
}

// ---- the auction: the opening over compacted lists (block 0) -------------
// After the grid listed the free slots (au.free_id, index order) and the
// admitted tasks (au.adm, index order), block 0 sorted the free slots by
// -speed (values: their list positions, in sc.sv[slot_buf]), block 1 sorted
// the admitted tasks by -size on a refresh tick (sc.tv[au.word
// [kAuTaskBuf]]), the grid re-based the carried prices on any other tick,
// and a grid barrier.
// Both lists are in index order, so the stable sorts give the full-length
// sorts' first n_slots and n_match positions. Here: the kept slots -- the
// n_match fastest free slots -- listed in ascending slot order (au.kept,
// with au.kpos the kept position of each free-list entry, -1 none), each
// position with its inverse speed, price (the rank-dual seed on a refresh
// tick, else the re-based carried price), no owner and no bid; the
// non-finite flag over the kept slots; the first round's bidders.
__device__ void auction_open_listed(const Dims& D, const State& st,
                                    const Scratch& sc, const Auction& au,
                                    int n_slots, int n_match, int slot_buf,
                                    bool refresh, Smem& sm) {
  const int tid = threadIdx.x, K = D.K;
  const int32_t* by_speed = sc.sv[slot_buf];
  if (n_match < n_slots) {
    for (int p = tid; p < n_slots; p += NT) au.kpos[p] = 0;
    __syncthreads();
    for (int i = tid; i < n_match; i += NT) au.kpos[by_speed[i]] = 1;
    __syncthreads();
    int base = 0;
    for (int c = 0; c < n_slots; c += NT) {
      const int p = c + tid;
      const bool kept = p < n_slots && au.kpos[p] != 0;
      int total;
      const int at = base + block_exclusive_scan(kept ? 1 : 0, &total, sm);
      if (p < n_slots) au.kpos[p] = kept ? at : -1;
      if (kept) au.kept[at] = au.free_id[p];
      base += total;
    }
  } else {
    for (int p = tid; p < n_slots; p += NT) {
      au.kpos[p] = p;
      au.kept[p] = au.free_id[p];
    }
  }
  __syncthreads();
  for (int i = tid; i < n_match; i += NT) {
    const int s = au.kept[i];
    au.inv[i] = __fdiv_rn(1.0f, clamp_min(st.speed[s / K], 1e-6f));
    au.owner[i] = -1;
    au.slot_bid[i] = kNoBid;
    if (!refresh) au.kprice[i] = au.price[s];
    au.list[0][i] = au.adm[i];
  }
  if (refresh) {
    // the seed over the sorted lists
    const int32_t* by_size = sc.tv[au.word[kAuTaskBuf]];
    auto size_sorted = [&](int j) {
      return clamp_min(st.sizes[by_size[j]], 0.0f);
    };
    auto inv_sorted = [&](int j) {
      const int w = au.free_id[by_speed[j]] / K;
      return __fdiv_rn(1.0f, clamp_min(st.speed[w], 1e-6f));
    };
    // the sorted keys are spent: their buffer holds the prices
    float* p_sorted = reinterpret_cast<float*>(sc.sk[slot_buf]);
    seed_prices(p_sorted, n_match, n_match, size_sorted, inv_sorted);
    for (int j = tid; j < n_match; j += NT)
      au.kprice[au.kpos[by_speed[j]]] = p_sorted[j];
  }
  __syncthreads();
  bool bad = !isfinite(au.jitter);
  for (int i = tid; i < n_match; i += NT)
    bad |= tpu_faas_bid::slot_nonfinite(au.inv[i], 1.0f, au.kprice[i]);
  bad = __syncthreads_or(bad);
  if (tid == 0) {
    au.nonfinite[0] = bad ? 1 : 0;
    au.cnt[0] = n_match;
    au.cnt[1] = 0;
  }
}

// ---- the auction: one bidding round's bids (whole grid) -------------------
// A round bids on the kept positions [0, n_kept): position i is the kept
// slot au.kept[i] (ascending), its price au.kprice[i] and inverse speed
// au.inv[i]; au.owner and au.slot_bid are by position too.

// One bidder's bid (auction.py's round): the increment v1 - v2 + eps (1 + eps
// when a single slot is valid), the bid price over the slot's price, and the
// 64-bit atomicMin on the slot's key. A row with no valid slot (v1 = -inf)
// does not bid.
__device__ __forceinline__ void issue_bid(const Auction& au, int row,
                                          float v1, int best, float v2) {
  if (!isfinite(v1)) return;
  const float incr =
      __fadd_rn(isfinite(v2) ? __fsub_rn(v1, v2) : 1.0f, au.eps);
  const float bp = __fadd_rn(au.kprice[best], incr);
  au.bid[row] = bp;
  const unsigned long long key =
      (static_cast<unsigned long long>(float_key(-bp)) << 32) |
      static_cast<uint32_t>(row);
  atomicMin(au.slot_bid + best, key);
}

// The round's work split, the same in every block (it depends on n_bid,
// the positions and the grid alone): groups of kRows bidders, and chunks
// of `len` positions (a multiple of 32, at least kMinChunk) so that groups
// x chunks fills the grid's warps when bidders are few.
struct BidPlan {
  int groups, chunks, len;
};

__device__ __forceinline__ BidPlan bid_plan(int n_bid, int n) {
  const int warps = min(static_cast<int>(gridDim.x) * NWARP, kMaxItems);
  const int groups = (n_bid + kRows - 1) / kRows;
  const int most = max((n + kMinChunk - 1) / kMinChunk, 1);
  const int chunks = min(max(warps / groups, 1), most);
  const int len = max((((n + chunks - 1) / chunks) + 31) & ~31, 32);
  return BidPlan{groups, (n + len - 1) / len, len};
}

// Every bidder's top-2 bid over the whole grid. Warp w of block b takes the
// work items (group, chunk) w * blocks + b, w * blocks + b + grid warps, ...
// (a round's items reach every SM before any SM takes two): its kRows rows'
// top-2 over its chunk with the code of kernel B2 (bid_top2.cuh). With one
// chunk the warp bids at once. Otherwise lane r stores row r's partial, the
// warp fences and takes a ticket on its group's counter, and the warp that
// draws the last ticket merges the group's partials (through L2, never a
// stale L1 line: they merge exactly in any order, bid_top2.cuh), bids, and
// resets the counter for the next round, which the round's barriers order.
// A cell's hash index is row * S + the kept slot's id, S = W * K.
__device__ void bid_round(const Dims& D, const State& st, const Auction& au,
                          int n_kept, const int32_t* bidders, int n_bid) {
  const int lane = threadIdx.x & 31;
  const int S = D.W * D.K;
  const BidPlan pl = bid_plan(n_bid, n_kept);
  const int n_items = pl.groups * pl.chunks;
  const int n_gwarp = gridDim.x * NWARP;
  // read after the round's barriers (they order the opening's and the
  // installs' writes); it only decides a second sweep
  const bool slots_nonfinite = au.nonfinite[0] != 0;
  for (int item = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
       item < n_items; item += n_gwarp) {
    const int g = item / pl.chunks, c = item - g * pl.chunks;
    float neg_size[kRows];
    uint32_t row_base[kRows];
    int row[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      // rows past the list repeat its last bidder and store nothing
      row[r] = bidders[min(g * kRows + r, n_bid - 1)];
      neg_size[r] = -st.sizes[row[r]];
      row_base[r] = static_cast<uint32_t>(row[r]) * static_cast<uint32_t>(S);
    }
    float v1[kRows], v2[kRows];
    int best[kRows];
    const int lo = c * pl.len;
    const int hi = min(lo + pl.len, n_kept);
    tpu_faas_bid::warp_top2_listed<kRows, false>(
        neg_size, row_base, au.kept, au.inv, au.kprice, au.jitter, lo, hi, v1,
        best, v2);
    // a row or slot that can make a cell NaN: sweep again by JAX's NaN
    // rule (warp-uniform: the same rows and flag in every lane). Deciding
    // after the sweep keeps the flag and the sizes off its loads' path.
    bool nan_rule = slots_nonfinite;
#pragma unroll
    for (int r = 0; r < kRows; ++r) nan_rule |= !isfinite(neg_size[r]);
    if (nan_rule)
      tpu_faas_bid::warp_top2_listed<kRows, true>(
          neg_size, row_base, au.kept, au.inv, au.kprice, au.jitter, lo, hi,
          v1, best, v2);
    if (pl.chunks > 1) {
      const int base = g * pl.chunks * kRows;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (lane != r) continue;
        const int i = base + c * kRows + r;
        au.part_v1[i] = v1[r];
        au.part_b[i] = best[r];
        au.part_v2[i] = v2[r];
      }
      __threadfence();
      __syncwarp();
      int ticket = 0;
      if (lane == 0) ticket = atomicAdd(au.ticket + g, 1);
      if (__shfl_sync(FULL, ticket, 0) != pl.chunks - 1) continue;
      __threadfence();
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float a1 = neg_inf(), a2 = neg_inf();
        int ab = 0;
        for (int k = lane; k < pl.chunks; k += 32) {
          const int i = base + k * kRows + r;
          const float p1 = __ldcg(au.part_v1 + i), p2 = __ldcg(au.part_v2 + i);
          const int pb = __ldcg(au.part_b + i);
          if (nan_rule) {
            tpu_faas_bid::merge<true>(a1, ab, a2, p1, pb, p2);
          } else {
            tpu_faas_bid::merge(a1, ab, a2, p1, pb, p2);
          }
        }
        if (nan_rule) {
          tpu_faas_bid::warp_merge<true>(a1, ab, a2);
        } else {
          tpu_faas_bid::warp_merge(a1, ab, a2);
        }
        v1[r] = a1;
        best[r] = ab;
        v2[r] = a2;
      }
      if (lane == 0) au.ticket[g] = 0;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (lane == r && g * kRows + r < n_bid)
        issue_bid(au, row[r], v1[r], best[r], v2[r]);
  }
}

// ---- the auction: close (block 0), auction.py::_rank_spill_close ---------
// The refresh flag and the aux words, from the close's counts.
__device__ void close_words(const Auction& au, const Out& out, int n_lt,
                            int n_spill, int n_match, int n_stranded,
                            int rounds, int bid_rows) {
  const bool stale = n_lt > 0 && n_spill * 20 > max(n_match, 1) &&
                     n_spill > 8;
  au.refresh[0] = (n_stranded > 0 || stale) ? 1 : 0;
  out.aux[0] = rounds;
  out.aux[1] = n_spill;
  out.aux[2] = bid_rows;
}

// The full-length close, over every task and slot (a slot is a leftover
// where it is kept and its position unowned).
__device__ void auction_close(const Dims& D, const State& st,
                              const Scratch& sc, const Auction& au,
                              const Out& out, int n_match, int rounds,
                              int bid_rows, Smem& sm) {
  const int tid = threadIdx.x;
  const int T = D.T, K = D.K, S = D.W * K;
  auto leftover_task = [&](int t) {
    return sc.admitted[t] != 0 && au.assigned[t] < 0;
  };
  auto leftover_slot = [&](int s) {
    const int j = au.kpos[s];
    return j >= 0 && au.owner[j] < 0;
  };
  int c_t = 0, c_s = 0;
  for (int t = tid; t < T; t += NT) c_t += leftover_task(t) ? 1 : 0;
  for (int s = tid; s < S; s += NT) c_s += leftover_slot(s) ? 1 : 0;
  int n_lt, n_ls;
  block_exclusive_scan(c_t, &n_lt, sm);
  block_exclusive_scan(c_s, &n_ls, sm);
  const int n_spill = min(n_lt, n_ls);
  if (n_spill > 0) {
    // largest leftover task to fastest leftover slot
    for (int t = tid; t < T; t += NT) {
      sc.tk[0][t] = float_key(-(leftover_task(t) ? st.sizes[t] : neg_inf()));
      sc.tv[0][t] = t;
    }
    for (int s = tid; s < S; s += NT) {
      sc.sk[0][s] =
          float_key(-(leftover_slot(s) ? st.speed[s / K] : neg_inf()));
      sc.sv[0][s] = s;
    }
    __syncthreads();
    const int tb = block_radix_sort(sc.tk, sc.tv, T, sm);
    const int sb = block_radix_sort(sc.sk, sc.sv, S, sm);
    for (int i = tid; i < n_spill; i += NT)
      au.assigned[sc.tv[tb][i]] = au.kpos[sc.sv[sb][i]];
    __syncthreads();
  }
  int c_str = 0;
  for (int t = tid; t < T; t += NT) {
    const int a = au.assigned[t];
    c_str += (sc.admitted[t] && a < 0) ? 1 : 0;
    sc.assign[t] = a >= 0 ? au.kept[a] / K : -1;
  }
  int n_stranded;
  block_exclusive_scan(c_str, &n_stranded, sm);
  if (tid == 0)
    close_words(au, out, n_lt, n_spill, n_match, n_stranded, rounds,
                bid_rows);
  __syncthreads();
}

// The close over the compacted lists: the leftover tasks (admitted,
// unassigned) and slots (kept, unowned) listed in index order with their
// keys and sorted alone, which gives the full-length sorts' first n_spill
// pairs; the admitted tasks' workers into sc.assign (the grid set every
// other task's to -1).
__device__ void auction_close_listed(const Dims& D, const State& st,
                                     const Scratch& sc, const Auction& au,
                                     const Out& out, int n_match, int rounds,
                                     int bid_rows, Smem& sm) {
  const int tid = threadIdx.x, K = D.K;
  int n_lt = 0, n_ls = 0;
  for (int c = 0; c < n_match; c += NT) {
    const int j = c + tid;
    const bool in = j < n_match;
    const int t = in ? au.adm[j] : 0;
    const bool lt = in && au.assigned[t] < 0;
    const bool ls = in && au.owner[j] < 0;
    int total;
    // both counts packed in one scan (each below 2^16 in a chunk)
    const int at = block_exclusive_scan((lt ? 1 << 16 : 0) | (ls ? 1 : 0),
                                        &total, sm);
    if (lt) {
      const int q = n_lt + (at >> 16);
      sc.tk[0][q] = float_key(-st.sizes[t]);
      sc.tv[0][q] = t;
    }
    if (ls) {
      const int q = n_ls + (at & 0xffff);
      sc.sk[0][q] = float_key(-st.speed[au.kept[j] / K]);
      sc.sv[0][q] = j;
    }
    n_lt += total >> 16;
    n_ls += total & 0xffff;
  }
  const int n_spill = min(n_lt, n_ls);
  if (n_spill > 0) {
    __syncthreads();
    const int tb = block_radix_sort(sc.tk, sc.tv, n_lt, sm);
    const int sb = block_radix_sort(sc.sk, sc.sv, n_ls, sm);
    for (int i = tid; i < n_spill; i += NT)
      au.assigned[sc.tv[tb][i]] = sc.sv[sb][i];
    __syncthreads();
  }
  int c_str = 0;
  for (int j = tid; j < n_match; j += NT) {
    const int t = au.adm[j], a = au.assigned[t];
    c_str += a < 0 ? 1 : 0;
    sc.assign[t] = a >= 0 ? au.kept[a] / K : -1;
  }
  int n_stranded;
  block_exclusive_scan(c_str, &n_stranded, sm);
  if (tid == 0)
    close_words(au, out, n_lt, n_spill, n_match, n_stranded, rounds,
                bid_rows);
  __syncthreads();
}

__device__ __forceinline__ int load_volatile(const int32_t* p) {
  return *reinterpret_cast<const volatile int32_t*>(p);
}

// kLanes: the instance launched with a lane on; the one with both lanes off
// holds none of their code, so the lanes' registers never weigh on its
// rounds.
template <bool kLanes>
__global__ void __launch_bounds__(NT, 1)
fused_auction_kernel(const float* __restrict__ packet, Dims D, State st,
                     Out out, Scratch sc, Auction au, Tenancy tn, Spec sp) {
  __shared__ Smem sm;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, b = blockIdx.x;
  const int G = gridDim.x;
  const int T = D.T, W = D.W, I = D.I, K = D.K, S = W * K;
  const int gthread = b * NT + tid;
  const int n_gthread = G * NT;
  int32_t* const cnt = au.counts;
  PROBE(const bool stamp = b == 0 && tid == 0;
        if (stamp) au.stamps[0] = global_ns();)
  PROBE(unsigned long long* ls = au.stamps + kStampLanes;
        unsigned long long* os = au.stamps + kStampOpen;)
  const bool refresh = au.refresh[0] != 0;  // the close rewrites it

  // -- 1: the packet's scatters; the invalid pending slots counted; the
  // scratch the later phases accumulate into -------------------------------
  float now, tte;
  const PacketLanes pk = packet_lanes(packet, D, tn, sp, &now, &tte);
  scatter_lanes(pk, D, st, sp, now, gthread, n_gthread);
  rank_count(count_row(cnt, kCntInvalid), T,
             [&](int i) { return st.valid[i] == 0; }, sm);
  // the bidder groups' tickets start at 0
  for (int i = gthread; i < kMaxItems; i += n_gthread) au.ticket[i] = 0;
  if (kLanes && tn.on) {
    for (int g = gthread; g < tn.n; g += n_gthread) {
      tn.demand[g] = 0;
      tn.cnt[g] = 0;
    }
  }
  if (kLanes && sp.on) fixup_reset(sp, W, gthread, n_gthread);
  if (gthread == 0) {
    au.word[kAuBad] = 0;
    au.word[kAuMin] = static_cast<int32_t>(__float_as_uint(CUDART_INF_F));
    out.n_pending[0] = 0;  // the compaction's blocks add into it
  }
  PROBE(if (b == 0) for (int i = 1 + tid; i < kAuStamps; i += NT)
          au.stamps[i] = 0;)
  grid.sync();
  PROBE(if (stamp) ls[0] = global_ns();)

  // -- 2: arrivals; liveness; the free slots counted ------------------------
  grid_arrivals(pk, D, st, tn, sp, out, cnt, sm);
  grid_liveness(D, st, out, now, tte, cnt, au.word + kAuBad, sm);
  // with the speculation lane the grid lists the stragglers at the close
  // (fixup_rows): nothing this tick changes what they read after here
  if (!sp.on)
    for (int j = gthread; j < D.KG; j += n_gthread) out.straggler[j] = -1;
  grid.sync();
  PROBE(if (stamp) ls[1] = global_ns();)
  // the auction sees the eligibility mask alone (FCFS admission)
  if (kLanes && tn.on) {
    grid_tenancy_elig(D, st, tn, sc, sm, grid);
    grid.sync();
  }
  PROBE(if (stamp) au.stamps[1] = global_ns();)

  // -- 3: redispatches counted; the free slots listed in index order with
  // their -speed keys; the placeable tasks counted; every task's worker
  // -1; the carried prices zeroed on a refresh tick (the seed prices the
  // kept slots), else their least positive one found --------------------
  rank_count(count_row(cnt, kCntRedispatch), I,
             [&](int i) { return dead_slot(st, out, W, i); }, sm);
  const int n_slots = grid_slot_list(
      D, st, out, cnt,
      [&](int p, int s, uint32_t key) {
        sc.sk[0][p] = key;
        sc.sv[0][p] = p;
        au.free_id[p] = s;
      },
      sm);
  rank_count(count_row(cnt, kCntMembers), T,
             [&](int t) { return st.place_valid[t] != 0; }, sm);
  int lo_t, hi_t;
  tile_of(T, &lo_t, &hi_t);
  for (int t = lo_t + tid; t < hi_t; t += NT) sc.assign[t] = -1;
  {
    int lo, hi;
    tile_of(S, &lo, &hi);
    if (refresh) {
      for (int s = lo + tid; s < hi; s += NT) au.price[s] = 0.0f;
    } else {
      float m = CUDART_INF_F;
      for (int s = lo + tid; s < hi; s += NT) {
        const float p = au.price[s];
        if (p > 0.0f) m = fminf(m, p);
      }
      m = block_min(m, sm);
      // positive floats order as their bits
      if (tid == 0 && m < CUDART_INF_F)
        atomicMin(reinterpret_cast<unsigned*>(au.word + kAuMin),
                  __float_as_uint(m));
    }
  }
  grid.sync();
  PROBE(if (stamp) os[0] = global_ns();)

  // -- 4: the redispatch list; the FCFS admission: the first n_match
  // placeable tasks listed in index order with their -size keys -----------
  grid_first_k(count_row(cnt, kCntRedispatch), I, D.KR, out.redispatch,
               [&](int i) { return dead_slot(st, out, W, i); }, sm);
  int n_valid;
  const int off_v = grid_offset(count_row(cnt, kCntMembers), &n_valid, sm);
  int n_match = min(n_slots, n_valid);
  {
    bool bad = false;
    if (off_v < n_match)
      tile_emit(lo_t, hi_t, off_v,
                [&](int t) { return st.place_valid[t] != 0; },
                [&](int t, int j) {
                  if (j >= n_match) return;
                  au.adm[j] = t;
                  au.assigned[t] = -1;
                  const float size = st.sizes[t];
                  sc.tk[0][j] = float_key(-size);
                  sc.tv[0][j] = t;
                  // a -size that sorts among the non-admitted ones' +inf
                  bad |= !(size > neg_inf());
                },
                sm);
    if (__syncthreads_or(bad) && tid == 0) au.word[kAuBad] = 1;
  }
  grid.sync();
  PROBE(if (stamp) os[1] = global_ns();)

  // -- 5: the grid re-bases the carried prices (auction.py::_rebase: shift
  // by the least positive one, clamped at 0) unless the tick refreshes;
  // block 0 sorts the free slots and (refresh) block 1 the admitted
  // tasks, unless a -inf or NaN speed on a free slot or size on an admitted
  // task sends the tick down the full-length path ----------------------------
  const bool full = au.word[kAuBad] != 0;
  if (!refresh) {
    const float m = __uint_as_float(static_cast<uint32_t>(au.word[kAuMin]));
    const float shift = isfinite(m) ? m : 0.0f;
    int lo, hi;
    tile_of(S, &lo, &hi);
    for (int s = lo + tid; s < hi; s += NT)
      au.price[s] = clamp_min(__fsub_rn(au.price[s], shift), 0.0f);
  }
  int slot_buf = 0;
  if (!full && b == 0)
    slot_buf = block_radix_sort(sc.sk, sc.sv, n_slots, sm);
  if (!full && refresh && b == (G > 1 ? 1 : 0)) {
    const int tb = block_radix_sort(sc.tk, sc.tv, n_match, sm);
    if (tid == 0) au.word[kAuTaskBuf] = tb;
  }
  grid.sync();
  PROBE(if (stamp) os[2] = global_ns();)

  // -- 6: block 0 opens: the kept slots and their prices, or the
  // full-length opening over every slot and task ----------------------------
  if (b == 0) {
    if (full) {
      n_match = auction_open(D, st, out, sc, au, sm);
    } else {
      auction_open_listed(D, st, sc, au, n_slots, n_match, slot_buf, refresh,
                          sm);
    }
  }
  if (gthread == 0) out.aux[3] = full ? 1 : 0;
  PROBE(if (b == 0) __syncthreads(); if (stamp) au.stamps[2] = global_ns();)
  grid.sync();
  PROBE(if (stamp) au.stamps[3] = global_ns();)

  // -- 7: the bidding rounds --------------------------------------------------
  const int n_kept = full ? load_volatile(au.word + kAuKept) : n_match;
  int rounds = 0, bid_rows = 0;
  for (;;) {
    // every thread reads the same count after the barrier: the loop ends
    // on the device, in every block at once
    const int p = rounds & 1;
    const int n_bid = load_volatile(au.cnt + p);
    if (rounds >= au.warm_rounds || n_bid == 0) break;
    bid_rows += n_bid;
    PROBE(unsigned long long* rs = au.stamps + kStampRound + 5 * rounds;
          const bool rstamp = rounds < kStampRounds;
          if (stamp && rstamp) rs[0] = n_bid;)
    if (gthread == 0) au.cnt[p ^ 1] = 0;  // last read before this round
    bid_round(D, st, au, n_kept, au.list[p], n_bid);
    PROBE(__syncthreads();
          if (tid == 0 && rstamp) atomicMax(rs + 1, global_ns());)
    grid.sync();
    PROBE(if (stamp && rstamp) rs[2] = global_ns();)
    // each won position: evict the previous owner, install the winner
    for (int i = gthread; i < n_kept; i += n_gthread) {
      const unsigned long long k = au.slot_bid[i];
      if (k == kNoBid) continue;
      au.slot_bid[i] = kNoBid;
      const int t = static_cast<int>(static_cast<uint32_t>(k));
      const int prev = au.owner[i];
      if (prev >= 0) au.assigned[prev] = -1;
      au.owner[i] = t;
      const float bp = au.bid[t];
      au.kprice[i] = bp;
      au.assigned[t] = i;
      // a bid price past the float range (a huge v1 - v2): the next
      // round's cells may be NaN; the barriers order the flag
      if (!isfinite(bp)) au.nonfinite[0] = 1;
    }
    grid.sync();
    PROBE(if (stamp && rstamp) rs[3] = global_ns();)
    // the next round's bidders: admitted tasks still without a slot (their
    // order does not matter: each bid depends on its row alone)
    int32_t* next = au.list[p ^ 1];
    const unsigned lt_mask = (1u << lane) - 1u;
    for (int base = b * NT; base < n_match; base += n_gthread) {
      const int j = base + tid;
      const int t = j < n_match ? au.adm[j] : 0;
      const bool want = j < n_match && au.assigned[t] < 0;
      const unsigned m = __ballot_sync(FULL, want);
      int pos = 0;
      if (lane == 0 && m) pos = atomicAdd(au.cnt + (p ^ 1), __popc(m));
      pos = __shfl_sync(FULL, pos, 0);
      if (want) next[pos + __popc(m & lt_mask)] = t;
    }
    grid.sync();
    PROBE(if (stamp && rstamp) rs[4] = global_ns();)
    ++rounds;
  }

  // -- 8: the close on block 0 (the rank spill and refresh); the grid
  // writes the kept slots' prices back meanwhile ---------------------------
  for (int i = gthread; i < n_kept; i += n_gthread)
    au.price[au.kept[i]] = au.kprice[i];
  if (b == 0) {
    if (full) {
      auction_close(D, st, sc, au, out, n_match, rounds, bid_rows, sm);
    } else {
      auction_close_listed(D, st, sc, au, out, n_match, rounds, bid_rows,
                           sm);
    }
    PROBE(if (stamp) au.stamps[kStampClose] = global_ns();)
  }
  // -- 9: with a lane on, the lanes' close (the hedge fixup and the deficit
  // carry) over the grid; then the compaction over the grid ---------------
  if (kLanes && (sp.on || tn.on)) {
    unsigned long long* lane_stamps = nullptr;
    PROBE(lane_stamps = ls + 2;)
    lanes_close(D, st, out, tn, sp, sc.assign, now, lane_stamps, sm, grid);
  }
  grid.sync();  // the close's (and the fixup's walk's) assignment
  compact_counts(D, st, sc.assign, cnt, sm);
  grid.sync();
  grid_compact(D, st, out, sc.assign, cnt, sm);
  PROBE(__syncthreads(); if (stamp) {
    au.stamps[kStampClose + 1] = global_ns();
    unsigned long long* cs = au.stamps + kStampCount;
    cs[0] = n_slots;
    cs[1] = n_valid;
    cs[2] = n_match;
    cs[3] = full;
  })
}

// ---- Sinkhorn placement (sinkhorn.py, the tick's branch at state.py) -----
// The route is the wrapper's static choice, state.py's: bucketed (sizes
// quantized onto nb log-spaced classes, the [nb+1, W+1] problem, bucket
// rounding) when T*W > 2^24, else dense (the [T+1, W+1] problem, per-task
// rounding). The [R, C] matrices are never built: every cell of -cost/tau is
// recomputed from the row and column vectors.
//
// The iterations (what bounds them: one exp per cell on the SFU, 16 a clock
// per SM, and a few issue slots around it). Each update is a logsumexp per
// row (f) or per column (g), spread over the grid as lines: block b takes
// ceil(lines / blocks) consecutive lines and gives each several warps when
// they are fewer than its 32 (bucketed f-update: 8 rows a block, 4 warps a
// row), so every warp works. A lane folds its cells into an online
// (max, sum) pair in base 2, four cells at a time: one evaluation and one
// ex2 a cell, the sum rescaled only when a batch raises the max. The pairs
// merge per warp by shuffles and per line through shared memory, with a
// __syncthreads and no grid barrier. A cell is ONE fma on vectors staged in
// shared memory: -rep[r] (row, 0 on absent rows) times inv[c] * log2(e)/tau
// (column, 0 on the slack column) plus g[c]/tau * log2(e) (column: -inf on a
// closed one, and the slack cost folded into the slack column) or plus
// f[r]/tau * log2(e) (row). JAX 0.9's hazards hold: a non-finite max is
// replaced by 0 (so an all -inf line gives -inf, and exp(-inf - -inf) never
// runs), a NaN cell is skipped by the max and reaches the sum, an absent
// line gets a -inf potential, and a row whose representative size is not
// finite takes an exact path in which a closed column gives -inf. The
// potentials differ from the plain version's by rounding only (PERF.md,
// contract (b): within 1e-4 of tau); the rounding candidates that follow
// replay the plain expression op by op.
//
// The close (capacity repair and spill) runs on block 0 over compacted
// lists: the grid gathers each task's candidate (valid and not sent to
// slack) into per-block lists in index order; block 0 sorts only the
// candidates by (worker, -best_p) and keeps each worker's first cap; then
// the spill pairs the first (by index) spilled tasks, sorted by size, with
// the valid slots left, sorted by speed: both compacted in index order, so
// the stable sorts give rank_place's own pairs. A valid slot whose speed or
// an admitted task whose size is -inf or NaN would sort among the invalid
// ones there; such a tick takes rank_place itself.
constexpr int kRed = 7;  // grid reductions, see sinkhorn_reduce
constexpr int kMaxBlocks = 1024;  // the close's per-block candidate lists
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// the iteration vectors stay in shared memory up to this many floats
// (227 KB a block, less the static Smem); past it they are read from
// global memory
constexpr int kVecSmemFloats = 40960;
constexpr int kStamps = 8;  // phase stamps, see fused_sinkhorn_kernel
// The probe build's Sinkhorn split (-DTPU_FAAS_PROBE alone writes it; the
// layout follows the phase stamps in every build): per iteration it <
// kSkIters four words from kSkIter + 4 it: the last block's end of its
// f-update (the largest clock over the blocks), block 0's clock after the
// f-update's barrier, the last block's end of its g-update, block 0's after
// its barrier; then the close's clocks from kSkClose: the candidates'
// keys built, the repair's first and second sort (or their counterparts),
// the repair done, the spill's slot order, the spill done; then its counts
// from kSkCount: candidates (valid and not to_slack), spilled tasks,
// spilled pairs placed, and 1 when the spill took rank placement's own
// sorts (a non-finite size or speed); then the lanes' words from kSkLanes:
// block 0's clock after the packet and after liveness (inside phase 1),
// after the hedge fixup and after the deficit carry (inside phase 7; 0 with
// the lanes off).
constexpr int kSkIters = 64;
constexpr int kSkIter = kStamps;
constexpr int kSkClose = kSkIter + 4 * kSkIters;
constexpr int kSkCount = kSkClose + 6;
constexpr int kSkLanes = kSkCount + 4;
constexpr int kSkStamps = kSkLanes + 4;

struct Sinkhorn {
  int bucketed;         // 1: bucketed solver and rounding; 0: dense
  int nb;               // buckets (bucketed)
  int n_iters;
  int R, C;             // rows (nb + 1 or T + 1) and columns (W + 1)
  float tau_rel;        // temperature relative to the cost scale
  float* f;             // [R] output: final row potentials
  float* g;             // [C] output: final column potentials
  float* tau_out;       // [1] output: the effective temperature
  unsigned long long* stamps;  // [kSkStamps] block 0's clock at each phase,
                               // then the probe build's split
  float* rowv;          // [R-1] bucket representative size, or task size
  int32_t* row_ok;      // [R-1] bucket populated, or task valid
  float* loga;          // [R] log row supplies
  float* ft;            // [R] f / tau
  float* logb;          // [C] log column demands
  float* colv;          // [W] 1 / speed_safe (bucketed), speed_safe (dense)
  float* capf;          // [W] capacity as float
  float* gt;            // [C] g / tau
  float* logs;          // [T] log of the safe size (bucketed)
  int32_t* bucket;      // [T]
  int32_t* best_w;      // [T] argmax worker per task
  float* best_p;        // [T] its plan mass (dense) or log-mass (bucketed)
  int32_t* to_slack;    // [T]
  int32_t* a0;          // [T] the capacity repair's assignment
  int32_t* spilled;     // [T]
  int32_t* counts;      // [nb] bucket populations
  int32_t* best_w_b;    // [nb] each bucket's candidate
  int32_t* to_slack_b;  // [nb]
  int32_t* used;        // [W]
  int32_t* remaining;   // [W]
  int32_t* seg_first;   // [W] first sorted position of each worker
  uint32_t* red;        // [kRed]
  // the iterations' cell vectors, in base-2 units (see above)
  float* col_a;         // [C] inv * log2(e) / tau, 0 on the slack column
  float* col_g;         // [C] g/tau * log2(e); -inf closed; slack cost folded
  float* row_a;         // [R] -rep (or -size); 0 on absent and slack rows
  float* row_f;         // [R] f/tau * log2(e)
  int vec_smem;         // 1: the block stages the four in shared memory
  // the close's candidate lists: block b's candidates, in index order, at
  // cand[b * chunk], their count cand_n[b], then their offsets
  int32_t* cand;        // [T]
  int32_t* cand_n;      // [kMaxBlocks]
  int32_t* cand_off;    // [kMaxBlocks]
};

// The scalars every thread derives from the grid reductions.
struct SkScalars {
  float n_tasks, total_cap, lo, span, slack, tau, neg_slack_over_tau;
};

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// the inverse of float_key
__device__ __forceinline__ float key_float(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// sinkhorn.py::_log_marginal
__device__ __forceinline__ float log_marginal(float a) {
  return a > 0.0f ? logf(clamp_min(a, 1e-30f)) : neg_inf();
}

__device__ __forceinline__ int capacity(const Dims& D, const State& st,
                                        const Out& out, int w) {
  return out.live[w] ? min(st.free_cnt[w], D.K) : 0;
}

// Reduction words: 0 valid tasks, 1 total capacity (integer sums, exact in
// any order); 2 min and 3 max of the valid tasks' log sizes, 4 a NaN among
// them, 5 max of the masked safe sizes, 6 max of the open columns' inverse
// speeds (bucketed) or of the masked cost cells (dense): float_key maxima
// and minima, exact in any order.
__device__ uint32_t red_identity(int i) {
  switch (i) {
    case 2: return float_key(pos_inf());
    case 3: case 5: case 6: return float_key(neg_inf());
    default: return 0u;
  }
}

__device__ void sinkhorn_reduce(const Dims& D, const State& st,
                                const Out& out, const Sinkhorn& sk) {
  const int T = D.T, W = D.W;
  const int gthread = blockIdx.x * NT + threadIdx.x;
  const int n_gthread = gridDim.x * NT;
  int n_valid = 0, cap_sum = 0;
  unsigned nan = 0;
  uint32_t lo = red_identity(2), hi = red_identity(3);
  uint32_t smax = red_identity(5), cmax = red_identity(6);
  for (int t = gthread; t < T; t += n_gthread) {
    const bool v = st.place_valid[t] != 0;
    n_valid += v ? 1 : 0;
    if (sk.bucketed) {
      const float ss = clamp_min(st.sizes[t], 1e-30f);
      const float l = logf(ss);
      sk.logs[t] = l;
      if (v && l != l) nan = 1u;
      if (v && l == l) {
        lo = min(lo, float_key(l));
        hi = max(hi, float_key(l));
      }
      smax = max(smax, float_key(v ? ss : 0.0f));
    }
  }
  for (int w = gthread; w < W; w += n_gthread) {
    const int cap = capacity(D, st, out, w);
    cap_sum += cap;
    sk.capf[w] = static_cast<float>(cap);
    const float ss = clamp_min(st.speed[w], 1e-6f);
    if (sk.bucketed) {
      const float inv = __fdiv_rn(1.0f, ss);
      sk.colv[w] = inv;
      cmax = max(cmax, float_key(cap > 0 ? inv : 0.0f));
    } else {
      sk.colv[w] = ss;
    }
  }
  if (!sk.bucketed) {
    // the dense cost's max over every (task, worker) cell, as the plain
    // version takes it (T*W <= 2^24 on this route)
    const int n = T * W;
    for (int i = gthread; i < n; i += n_gthread) {
      const int t = i / W, w = i - t * W;
      const bool fin = st.place_valid[t] && capacity(D, st, out, w) > 0;
      const float c = fin ? __fdiv_rn(st.sizes[t],
                                      clamp_min(st.speed[w], 1e-6f))
                          : 0.0f;
      cmax = max(cmax, float_key(c));
    }
  }
  n_valid = __reduce_add_sync(FULL, n_valid);
  cap_sum = __reduce_add_sync(FULL, cap_sum);
  nan = __reduce_or_sync(FULL, nan);
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  smax = __reduce_max_sync(FULL, smax);
  cmax = __reduce_max_sync(FULL, cmax);
  if ((threadIdx.x & 31) == 0) {
    int* ired = reinterpret_cast<int*>(sk.red);
    if (n_valid) atomicAdd(ired + 0, n_valid);
    if (cap_sum) atomicAdd(ired + 1, cap_sum);
    atomicMin(sk.red + 2, lo);
    atomicMax(sk.red + 3, hi);
    if (nan) atomicOr(sk.red + 4, nan);
    atomicMax(sk.red + 5, smax);
    atomicMax(sk.red + 6, cmax);
  }
}

__device__ SkScalars sk_scalars(const Sinkhorn& sk) {
  SkScalars s;
  uint32_t red[kRed];
  for (int i = 0; i < kRed; ++i)
    red[i] = static_cast<uint32_t>(
        load_volatile(reinterpret_cast<const int32_t*>(sk.red + i)));
  s.n_tasks = static_cast<float>(static_cast<int32_t>(red[0]));
  s.total_cap = static_cast<float>(static_cast<int32_t>(red[1]));
  float cmax;
  if (sk.bucketed) {
    float lo = key_float(red[2]), hi = key_float(red[3]);
    if (red[4]) lo = hi = __int_as_float(0x7fc00000);  // a NaN min/max
    // an all-invalid tick keeps lo/hi infinite: any finite placeholder
    lo = isfinite(lo) ? lo : 0.0f;
    hi = isfinite(hi) ? hi : 1.0f;
    s.lo = lo;
    s.span = clamp_min(__fsub_rn(hi, lo), 1e-9f);
    cmax = __fmul_rn(key_float(red[5]), key_float(red[6]));
  } else {
    s.lo = 0.0f;
    s.span = 1.0f;
    cmax = key_float(red[6]);
  }
  s.slack = __fadd_rn(cmax, 1.0f);
  s.tau = __fmul_rn(sk.tau_rel, clamp_min(cmax, 1e-30f));
  s.neg_slack_over_tau = __fdiv_rn(-s.slack, s.tau);
  return s;
}

// Cell (r, c) of -cost/tau, forbidden cells -inf, as the plain version
// builds the matrix: bucketed, -(rep*inv)/tau on open cells, the slack
// column -slack/tau, the slack row 0; dense, -cost/tau of the cost matrix
// (size/speed_safe, slack cost, 0, or inf where forbidden).
__device__ __forceinline__ float sk_negc(const Sinkhorn& sk,
                                         const SkScalars& s, int r, int c) {
  const int W = sk.C - 1, nr = sk.R - 1;
  const bool col_open = c < W && sk.capf[c] > 0.0f;
  if (sk.bucketed) {
    if (r == nr) return col_open ? 0.0f : neg_inf();
    if (!sk.row_ok[r]) return neg_inf();
    if (c == W) return s.neg_slack_over_tau;
    return col_open ? __fdiv_rn(-__fmul_rn(sk.rowv[r], sk.colv[c]), s.tau)
                    : neg_inf();
  }
  float cost;
  if (r == nr) {
    cost = col_open ? 0.0f : pos_inf();
  } else if (c == W) {
    cost = sk.row_ok[r] ? s.slack : pos_inf();
  } else {
    cost = (sk.row_ok[r] && col_open) ? __fdiv_rn(sk.rowv[r], sk.colv[c])
                                      : pos_inf();
  }
  return __fdiv_rn(-cost, s.tau);
}

// The rows' and columns' setup after the reductions: each task's bucket
// and the populations (bucketed) or the task rows (dense), the column
// demands, and g = 0.
__device__ void sinkhorn_setup(const Dims& D, const State& st,
                               const Sinkhorn& sk, const SkScalars& s) {
  const int T = D.T, W = D.W;
  const int gthread = blockIdx.x * NT + threadIdx.x;
  const int n_gthread = gridDim.x * NT;
  for (int t = gthread; t < T; t += n_gthread) {
    if (sk.bucketed) {
      const float x = __fmul_rn(__fdiv_rn(__fsub_rn(sk.logs[t], s.lo), s.span),
                                static_cast<float>(sk.nb));
      const int b = min(max(f2i(x), 0), sk.nb - 1);
      sk.bucket[t] = b;
      if (st.place_valid[t]) atomicAdd(sk.counts + b, 1);
    } else {
      const bool v = st.place_valid[t] != 0;
      sk.rowv[t] = st.sizes[t];
      sk.row_ok[t] = v ? 1 : 0;
      sk.loga[t] = log_marginal(v ? 1.0f : 0.0f);
      sk.row_a[t] = v ? -st.sizes[t] : 0.0f;
    }
  }
  // the cell vectors: cost/tau = rep * (inv / tau) in base 2; g starts at 0
  const float a = __fdiv_rn(kLog2e, s.tau);
  for (int c = gthread; c < sk.C; c += n_gthread) {
    sk.logb[c] = log_marginal(
        c < W ? sk.capf[c]
              : clamp_min(__fsub_rn(s.n_tasks, s.total_cap), 0.0f));
    sk.gt[c] = __fdiv_rn(0.0f, s.tau);
    if (c < W) {
      const float inv = sk.bucketed ? sk.colv[c] : __frcp_rn(sk.colv[c]);
      sk.col_a[c] = __fmul_rn(inv, a);
      sk.col_g[c] = sk.capf[c] > 0.0f ? 0.0f : neg_inf();
    } else {
      sk.col_a[c] = 0.0f;
      sk.col_g[c] = __fmul_rn(s.neg_slack_over_tau, kLog2e);
    }
  }
  if (gthread == 0) {
    sk.loga[sk.R - 1] =
        log_marginal(clamp_min(__fsub_rn(s.total_cap, s.n_tasks), 0.0f));
    sk.row_a[sk.R - 1] = 0.0f;
  }
}

// The bucket rows (bucketed only, after the populations are complete):
// rep = exp(lo + (k + 0.5) / nb * span); nb is a power of two, so the plain
// version's division equals the reciprocal product torch takes for it.
__device__ void sinkhorn_buckets(const Sinkhorn& sk, const SkScalars& s) {
  const int gthread = blockIdx.x * NT + threadIdx.x;
  const int n_gthread = gridDim.x * NT;
  for (int k = gthread; k < sk.nb; k += n_gthread) {
    const float q = __fdiv_rn(__fadd_rn(static_cast<float>(k), 0.5f),
                              static_cast<float>(sk.nb));
    const float rep = expf(__fadd_rn(s.lo, __fmul_rn(q, s.span)));
    sk.rowv[k] = rep;
    const int n = sk.counts[k];
    sk.row_ok[k] = n > 0 ? 1 : 0;
    sk.loga[k] = log_marginal(static_cast<float>(n));
    sk.row_a[k] = n > 0 ? -rep : 0.0f;
  }
}

// ---- the iterations: online logsumexp in base 2 -------------------------
__device__ __forceinline__ float fin0(float m) { return isfinite(m) ? m : 0.0f; }

// 2^x on the SFU (MUFU.EX2): -inf gives +0, NaN gives NaN
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// An online logsumexp over base-2 cells: m is the largest non-NaN cell
// (-inf while there is none), s the sum of 2^(x - fin0(m)) over the cells
// (a NaN cell makes it NaN). fin0 is JAX's replacement of a non-finite max
// by 0, so 2^(-inf - -inf) never runs: an all -inf line keeps s = 0.
struct Lse {
  float m, s;
};

// Fold the cells x(i), i = i0, i0 + step, ... < n, four at a time: one
// evaluation and one ex2 a cell; s is rescaled only when a batch raises
// the max past a finite one.
template <class X>
__device__ __forceinline__ void lse_fold(Lse& a, int i0, int n, int step,
                                         X x) {
  for (int i = i0; i < n; i += 4 * step) {
    float v[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = i + b * step;
      v[b] = j < n ? x(j) : neg_inf();
    }
    // fmaxf skips a NaN; four NaNs give NaN, which raises nothing
    const float bm = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
    if (bm > a.m) {
      const float mh = fin0(a.m), bh = fin0(bm);
      if (a.s != 0.0f && bh != mh) a.s *= ex2(mh - bh);
      a.m = bm;
    }
    const float mh = fin0(a.m);
#pragma unroll
    for (int b = 0; b < 4; ++b) a.s += ex2(v[b] - mh);
  }
}

// Merge two folds over disjoint cells (exact up to rounding in any order;
// sched/sinkhorn.py::split_logsumexp is its plain form).
__device__ __forceinline__ void lse_merge(Lse& a, const Lse& b) {
  const float m = fmaxf(a.m, b.m);  // neither is NaN
  const float mh = fin0(m);
  const float sa = a.s == 0.0f ? 0.0f : a.s * ex2(fin0(a.m) - mh);
  const float sb = b.s == 0.0f ? 0.0f : b.s * ex2(fin0(b.m) - mh);
  a.m = m;
  a.s = sa + sb;
}

__device__ __forceinline__ void warp_lse_merge(Lse& a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Lse b{__shfl_xor_sync(FULL, a.m, o), __shfl_xor_sync(FULL, a.s, o)};
    lse_merge(a, b);
  }
}

// The natural logsumexp of a fold: ln(s) + fin0(m) ln 2 (-inf when s = 0).
__device__ __forceinline__ float lse_value(const Lse& a) {
  return __fadd_rn(logf(a.s), __fmul_rn(fin0(a.m), kLn2));
}

// The iteration vectors as each block reads them: shared memory when
// sk.vec_smem, else the global scratch (one code path: generic pointers).
struct SkVecs {
  const float* col_a;
  float* col_g;
  const float* row_a;
  float* row_f;
  Lse* part;  // [NWARP] the warps' folds, for the line merge
};

// One update's lines (rows or columns) over the grid: block b takes lines
// [b * per_block, (b + 1) * per_block), `at_once` of them at a time with
// `warps` warps each (32 / at_once; one when a block has more lines than
// warps). Every block takes the same plan.
struct LinePlan {
  int per_block, at_once, warps, rounds;
};

__device__ __forceinline__ LinePlan line_plan(int n_lines) {
  const int per_block = (n_lines + gridDim.x - 1) / gridDim.x;
  const int at_once = min(per_block, NWARP);
  return LinePlan{per_block, at_once, NWARP / at_once,
                  (per_block + at_once - 1) / at_once};
}

// For every line of this block's plan: each of its warps folds its lanes'
// cells (fold(line, lse, first cell, stride)), the folds merge, and one
// lane calls finish(line, lse). Every thread of the block must call it.
template <class Fold, class Finish>
__device__ void lines_lse(int n_lines, const SkVecs& v, Fold fold,
                          Finish finish) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const LinePlan pl = line_plan(n_lines);
  const int slot = warp / pl.warps, part = warp - slot * pl.warps;
  for (int r = 0; r < pl.rounds; ++r) {
    const int j = r * pl.at_once + slot;
    const int line = blockIdx.x * pl.per_block + j;
    const bool mine = slot < pl.at_once && j < pl.per_block && line < n_lines;
    Lse a{neg_inf(), 0.0f};
    if (mine) fold(line, a, part * 32 + lane, pl.warps * 32);
    warp_lse_merge(a);
    if (pl.warps > 1) {
      if (lane == 0) v.part[warp] = a;
      __syncthreads();
      if (mine && part == 0) {
        a = lane < pl.warps ? v.part[warp + lane] : Lse{neg_inf(), 0.0f};
        warp_lse_merge(a);
      }
      __syncthreads();  // v.part is reused by the next round
    }
    if (mine && part == 0 && lane == 0) finish(line, a);
  }
}

// One Sinkhorn iteration's f-update (rows hit their supply): f = tau *
// (loga - lse_c(negc + g/tau)), -inf on absent rows. The slack row's cells
// are g/tau on the open columns and -inf on the slack column.
__device__ void sinkhorn_f_update(const Sinkhorn& sk, const SkScalars& s,
                                  const SkVecs& v) {
  const int W = sk.C - 1, nr = sk.R - 1;
  if (sk.vec_smem) {  // this iteration's g, staged
    for (int c = threadIdx.x; c < sk.C; c += NT) v.col_g[c] = sk.col_g[c];
    __syncthreads();
  }
  const float* ca = v.col_a;
  const float* cg = v.col_g;
  lines_lse(
      sk.R, v,
      [&](int r, Lse& a, int i0, int step) {
        if (!isfinite(sk.loga[r])) return;  // f = -inf whatever the lse
        const float ra = v.row_a[r];
        if (r == nr) {
          lse_fold(a, i0, W, step, [&](int c) { return cg[c]; });
        } else if (isfinite(ra)) {
          lse_fold(a, i0, sk.C, step,
                   [&](int c) { return fmaf(ra, ca[c], cg[c]); });
        } else {
          // a non-finite size class: a closed column stays -inf
          lse_fold(a, i0, sk.C, step, [&](int c) {
            if (c == W) return cg[c];
            return sk.capf[c] > 0.0f ? fmaf(ra, ca[c], cg[c]) : neg_inf();
          });
        }
      },
      [&](int r, const Lse& a) {
        const float la = sk.loga[r];
        const float f = isfinite(la)
                            ? __fmul_rn(s.tau, __fsub_rn(la, lse_value(a)))
                            : neg_inf();
        sk.f[r] = f;
        const float ft = __fdiv_rn(f, s.tau);
        sk.ft[r] = ft;
        sk.row_f[r] = __fmul_rn(ft, kLog2e);
      });
}

// ... and its g-update (columns hit their demand). The slack column's
// cells are f/tau - slack/tau on the real rows and -inf on the slack row.
__device__ void sinkhorn_g_update(const Sinkhorn& sk, const SkScalars& s,
                                  const SkVecs& v) {
  const int W = sk.C - 1, nr = sk.R - 1;
  if (sk.vec_smem) {  // this iteration's f, staged
    for (int r = threadIdx.x; r < sk.R; r += NT) v.row_f[r] = sk.row_f[r];
    __syncthreads();
  }
  const float* ra = v.row_a;
  const float* rf = v.row_f;
  const float slack = __fmul_rn(s.neg_slack_over_tau, kLog2e);
  lines_lse(
      sk.C, v,
      [&](int c, Lse& a, int i0, int step) {
        if (!isfinite(sk.logb[c])) return;  // g = -inf whatever the lse
        if (c == W) {
          lse_fold(a, i0, nr, step,
                   [&](int r) { return __fadd_rn(rf[r], slack); });
        } else {
          const float cc = v.col_a[c];
          lse_fold(a, i0, sk.R, step,
                   [&](int r) { return fmaf(ra[r], cc, rf[r]); });
        }
      },
      [&](int c, const Lse& a) {
        const float lb = sk.logb[c];
        const float g = isfinite(lb)
                            ? __fmul_rn(s.tau, __fsub_rn(lb, lse_value(a)))
                            : neg_inf();
        sk.g[c] = g;
        const float gt = __fdiv_rn(g, s.tau);
        sk.gt[c] = gt;
        sk.col_g[c] = __fmul_rn(c == W ? __fadd_rn(gt, s.neg_slack_over_tau)
                                       : gt,
                                kLog2e);
      });
}

// The first maximum of x(0..W-1) by one warp: every lane gets (value, index).
template <class X>
__device__ void warp_argmax(int n, X x, float* best, int* at) {
  float v = neg_inf();
  int i_best = INT32_MAX;  // loses to every real element
  for (int i = threadIdx.x & 31; i < n; i += 32) {
    const float xi = x(i);
    if (beats(xi, i, v, i_best)) {
      v = xi;
      i_best = i;
    }
  }
  warp_argmax_merge(&v, &i_best);
  *best = v;
  *at = i_best;
}

// The rounding's argmax candidates (whole grid). Bucketed: one warp per
// bucket over z = negc + g/tau, and its slack test. Dense: one warp per task
// over the plan exp(negc + (f + g)/tau) itself (an underflow to 0 ties, as
// in the plain version), and its slack test.
__device__ void sinkhorn_candidates(const Dims& D, const Sinkhorn& sk,
                                    const SkScalars& s) {
  const int W = D.W;
  const int gwarp = (blockIdx.x * NT + threadIdx.x) >> 5;
  const int n_gwarp = gridDim.x * NWARP;
  const bool lane0 = (threadIdx.x & 31) == 0;
  if (sk.bucketed) {
    for (int k = gwarp; k < sk.nb; k += n_gwarp) {
      float best;
      int at;
      warp_argmax(W, [&](int w) {
        return __fadd_rn(sk_negc(sk, s, k, w), sk.gt[w]);
      }, &best, &at);
      if (lane0) {
        sk.best_w_b[k] = at;
        sk.to_slack_b[k] =
            __fadd_rn(sk_negc(sk, s, k, W), sk.gt[W]) >= best ? 1 : 0;
      }
    }
    return;
  }
  auto plan = [&](int t, int w) {
    const float fg = __fdiv_rn(__fadd_rn(sk.f[t], sk.g[w]), s.tau);
    return expf(__fadd_rn(sk_negc(sk, s, t, w), fg));
  };
  for (int t = gwarp; t < D.T; t += n_gwarp) {
    float best;
    int at;
    warp_argmax(W, [&](int w) { return plan(t, w); }, &best, &at);
    if (lane0) {
      sk.best_w[t] = at;
      sk.best_p[t] = best;
      sk.to_slack[t] = plan(t, W) >= best ? 1 : 0;
    }
  }
}

// ---- Sinkhorn close: sinkhorn.py::_repair_candidates ---------------------
// Each task's candidate (whole grid, after the rounding candidates): the
// bucket's worker, its per-task log-mass and the slack test (bucketed), or
// the task's own (dense); the candidates (valid and not to_slack) of block
// b's tasks [b * chunk, (b + 1) * chunk) compacted in index order into
// sk.cand at b * chunk, their count in sk.cand_n[b]. Also clears the
// assignment, the repair's and the per-worker counts.
__device__ void sinkhorn_task_candidates(const Dims& D, const State& st,
                                         const Scratch& sc,
                                         const Sinkhorn& sk,
                                         const SkScalars& s, Smem& sm) {
  const int T = D.T, W = D.W, tid = threadIdx.x;
  const int chunk = (T + gridDim.x - 1) / gridDim.x;
  const int lo = min(static_cast<int>(blockIdx.x) * chunk, T);
  const int hi = min(lo + chunk, T);
  int n = 0;
  for (int base = lo; base < hi; base += NT) {  // block-uniform
    const int t = base + tid;
    bool cand = false;
    if (t < hi) {
      const bool v = st.place_valid[t] != 0;
      if (sk.bucketed) {
        const int b = sk.bucket[t];
        const int w = sk.best_w_b[b];
        sk.best_w[t] = w;
        const float ss = clamp_min(st.sizes[t], 1e-30f);
        sk.best_p[t] = __fdiv_rn(
            __fsub_rn(sk.g[w], __fmul_rn(ss, sk.colv[min(max(w, 0), W - 1)])),
            s.tau);
        sk.to_slack[t] = (sk.to_slack_b[b] || !v) ? 1 : 0;
      }
      cand = v && !sk.to_slack[t];
      sk.a0[t] = -1;
      sc.assign[t] = -1;
    }
    int total;
    const int at = block_exclusive_scan(cand ? 1 : 0, &total, sm);
    if (cand) sk.cand[lo + n + at] = t;
    n += total;
  }
  if (tid == 0) sk.cand_n[blockIdx.x] = n;
  const int gthread = blockIdx.x * NT + tid;
  for (int w = gthread; w < W; w += gridDim.x * NT) sk.used[w] = 0;
}

// The close on block 0: the candidates gathered in index order, sorted by
// (worker, -best_p) as two stable radix sorts (the secondary key first);
// each worker keeps its first cap; then the spill: the first spilled tasks
// in index order (as many as there are valid slots left), sorted by -size,
// paired rank for rank with the valid slots left, sorted by -speed. Fills
// sc.assign.
__device__ void sinkhorn_close(const Dims& D, const State& st,
                               const Out& out, const Scratch& sc,
                               const Sinkhorn& sk, Smem& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = D.T, W = D.W, K = D.K, S = W * K;
  const int G = gridDim.x;
  const int chunk = (T + G - 1) / G;
  PROBE(unsigned long long* cs = sk.stamps + kSkClose;)
  // the candidates in index order: block b's list at its offset
  int n_cand;
  {
    const int c = tid < G ? sk.cand_n[tid] : 0;
    const int off = block_exclusive_scan(c, &n_cand, sm);
    if (tid < G) sk.cand_off[tid] = off;
    __syncthreads();
  }
  for (int b = warp; b < G; b += NWARP) {
    const int n = sk.cand_n[b], off = sk.cand_off[b];
    for (int i = lane; i < n; i += 32) {
      const int t = sk.cand[b * chunk + i];
      sc.tk[0][off + i] = float_key(-sk.best_p[t]);
      sc.tv[0][off + i] = t;
    }
  }
  PROBE(if (tid == 0) sk.stamps[kSkCount] = n_cand;)
  __syncthreads();
  PROBE(if (tid == 0) cs[0] = global_ns();)
  const int b1 = block_radix_sort(sc.tk, sc.tv, n_cand, sm);
  PROBE(if (tid == 0) cs[1] = global_ns();)
  uint32_t* const k2[2] = {sc.tk[b1 ^ 1], sc.tk[b1]};
  int32_t* const v2[2] = {sc.tv[b1 ^ 1], sc.tv[b1]};
  for (int i = tid; i < n_cand; i += NT) {
    const int t = sc.tv[b1][i];
    k2[0][i] = static_cast<uint32_t>(sk.best_w[t]);
    v2[0][i] = t;
  }
  __syncthreads();
  const int b2 = block_radix_sort(k2, v2, n_cand, sm);
  PROBE(if (tid == 0) cs[2] = global_ns();)
  const uint32_t* sorted_w = k2[b2];
  const int32_t* order = v2[b2];
  for (int i = tid; i < n_cand; i += NT) {
    const int w = static_cast<int>(sorted_w[i]);
    if (i == 0 || static_cast<int>(sorted_w[i - 1]) != w) sk.seg_first[w] = i;
  }
  __syncthreads();
  int my_kept = 0;
  for (int i = tid; i < n_cand; i += NT) {
    const int w = static_cast<int>(sorted_w[i]);
    if (i - sk.seg_first[w] < capacity(D, st, out, w)) {
      const int t = order[i];
      sk.a0[t] = w;
      sc.assign[t] = w;
      atomicAdd(sk.used + w, 1);
      ++my_kept;
    }
  }
  int n_kept;
  block_exclusive_scan(my_kept, &n_kept, sm);  // also orders sk.used
  // the valid slots left, in index order: worker w's first remaining[w]
  int lo_w, hi_w;
  chunk_of(W, &lo_w, &hi_w);
  int my_slots = 0;
  bool bad = false;  // a valid slot that would sort among the invalid ones
  for (int w = lo_w; w < hi_w; ++w) {
    const int rem = max(capacity(D, st, out, w) - sk.used[w], 0);
    sk.remaining[w] = rem;
    my_slots += rem;
    bad |= rem > 0 && !(st.speed[w] > neg_inf());
  }
  int n_slots;
  int p = block_exclusive_scan(my_slots, &n_slots, sm);
  for (int w = lo_w; w < hi_w; ++w) {
    for (int k = 0; k < sk.remaining[w]; ++k, ++p) {
      sc.sk[0][p] = float_key(-st.speed[w]);
      sc.sv[0][p] = w * K + k;
    }
  }
  PROBE(if (tid == 0) cs[3] = global_ns();)
  // the spill's admission: the first n_adm spilled tasks in index order
  int lo_t, hi_t;
  chunk_of(T, &lo_t, &hi_t);
  auto spilled = [&](int t) {
    return st.place_valid[t] != 0 && sk.a0[t] < 0;
  };
  int my_spill = 0;
  for (int t = lo_t; t < hi_t; ++t) my_spill += spilled(t) ? 1 : 0;
  int n_spill;
  int q = block_exclusive_scan(my_spill, &n_spill, sm);
  const int n_adm = min(n_slots, n_spill);
  for (int t = lo_t; t < hi_t && q < n_adm; ++t) {
    if (!spilled(t)) continue;
    const float size = st.sizes[t];
    bad |= !(size > neg_inf());
    sc.tk[0][q] = float_key(-size);
    sc.tv[0][q] = t;
    ++q;
  }
  PROBE(if (tid == 0) sk.stamps[kSkCount + 1] = n_spill;)
  if (__syncthreads_or(bad)) {
    // rank_place's own sorts over every slot and task
    for (int t = tid; t < T; t += NT) sk.spilled[t] = spilled(t) ? 1 : 0;
    __syncthreads();
    unsigned long long* slot_stamp = nullptr;
    PROBE(slot_stamp = cs + 4; if (tid == 0) sk.stamps[kSkCount + 3] = 1;)
    rank_place(
        D, st, out, [&](int t) { return sk.spilled[t] != 0; }, sk.remaining,
        sc, sm, slot_stamp);
    for (int t = tid; t < T; t += NT) {
      PROBE(if (sk.a0[t] < 0 && sc.assign[t] >= 0)
              atomicAdd(sk.stamps + kSkCount + 2, 1ull);)
      if (sk.a0[t] >= 0) sc.assign[t] = sk.a0[t];
    }
    __syncthreads();
    PROBE(if (tid == 0) cs[5] = global_ns();)
    return;
  }
  const int sb = block_radix_sort(sc.sk, sc.sv, n_slots, sm);
  PROBE(if (tid == 0) cs[4] = global_ns();)
  const int tb = block_radix_sort(sc.tk, sc.tv, n_adm, sm);
  const int n_pairs = min(n_adm, min(T, S));
  for (int i = tid; i < n_pairs; i += NT)
    sc.assign[sc.tv[tb][i]] = sc.sv[sb][i] / K;
  __syncthreads();
  PROBE(if (tid == 0) {
    sk.stamps[kSkCount + 2] = n_pairs;
    cs[5] = global_ns();
  })
}

// Block 0's thread 0 stamps the clock at the start and at the end of each
// phase into sk.stamps (scratch, read back by the wrapper on request):
// 0 start, 1 packet and liveness (and the tenancy lane's eligibility), 2
// reductions, 3 setup, 4 iterations, 5 rounding candidates, 6 capacity
// repair and spill, 7 the hedge fixup (speculation), the deficit carry
// (tenancy) and compaction.
// kLanes as in fused_auction_kernel.
template <bool kLanes>
__global__ void __launch_bounds__(NT, 1)
fused_sinkhorn_kernel(const float* __restrict__ packet, Dims D, State st,
                      Out out, Scratch sc, Sinkhorn sk, Tenancy tn, Spec sp) {
  __shared__ Smem sm;
  // the lines' folds [2 NWARP], then (sk.vec_smem) col_a col_g [C each]
  // and row_a row_f [R each]
  extern __shared__ float sk_dyn[];
  cg::grid_group grid = cg::this_grid();
  const bool stamp = blockIdx.x == 0 && threadIdx.x == 0;
  if (stamp) sk.stamps[0] = global_ns();
  PROBE(unsigned long long* ls = sk.stamps + kSkLanes;)
  const int gthread = blockIdx.x * NT + threadIdx.x;
  const int n_gthread = gridDim.x * NT;
  if (kLanes && tn.on) {
    for (int g = gthread; g < tn.n; g += n_gthread) {
      tn.demand[g] = 0;
      tn.cnt[g] = 0;
    }
  }
  if (kLanes && sp.on) fixup_reset(sp, D.W, gthread, n_gthread);
  if (blockIdx.x == 0) {
    PROBE(for (int i = kStamps + threadIdx.x; i < kSkStamps; i += NT)
            sk.stamps[i] = 0;
          __syncthreads();)
    float now, tte;
    apply_deltas(packet, D, st, tn, sp, out, sm, &now, &tte);
    PROBE(__syncthreads(); if (stamp) ls[0] = global_ns();)
    __syncthreads();
    liveness(D, st, sp, out, now, tte, sm);
    PROBE(__syncthreads(); if (stamp) ls[1] = global_ns();)
    if (threadIdx.x < kRed) sk.red[threadIdx.x] = red_identity(threadIdx.x);
    if (sk.bucketed)
      for (int k = threadIdx.x; k < sk.nb; k += NT) sk.counts[k] = 0;
  }
  // the eligibility every block's placement reads, before the barrier
  if (kLanes && tn.on) {
    grid.sync();
    grid_tenancy_elig(D, st, tn, sc, sm, grid);
  }
  if (stamp) sk.stamps[1] = global_ns();
  grid.sync();
  sinkhorn_reduce(D, st, out, sk);
  grid.sync();
  if (stamp) sk.stamps[2] = global_ns();
  const SkScalars s = sk_scalars(sk);
  if (stamp) sk.tau_out[0] = s.tau;
  sinkhorn_setup(D, st, sk, s);
  grid.sync();
  if (sk.bucketed) {
    sinkhorn_buckets(sk, s);
    grid.sync();
  }
  SkVecs v{sk.col_a, sk.col_g, sk.row_a, sk.row_f,
           reinterpret_cast<Lse*>(sk_dyn)};
  if (sk.vec_smem) {
    float* p = sk_dyn + 2 * NWARP;
    // the fixed vectors once; g and f before each update that reads them
    for (int c = threadIdx.x; c < sk.C; c += NT) p[c] = sk.col_a[c];
    for (int r = threadIdx.x; r < sk.R; r += NT) p[2 * sk.C + r] = sk.row_a[r];
    v = SkVecs{p, p + sk.C, p + 2 * sk.C, p + 2 * sk.C + sk.R, v.part};
  }
  if (stamp) sk.stamps[3] = global_ns();
  for (int it = 0; it < sk.n_iters; ++it) {
    PROBE(unsigned long long* is = sk.stamps + kSkIter + 4 * it;
          const bool istamp = it < kSkIters;)
    sinkhorn_f_update(sk, s, v);
    PROBE(__syncthreads();
          if (threadIdx.x == 0 && istamp) atomicMax(is, global_ns());)
    grid.sync();
    PROBE(if (stamp && istamp) is[1] = global_ns();)
    sinkhorn_g_update(sk, s, v);
    PROBE(__syncthreads();
          if (threadIdx.x == 0 && istamp) atomicMax(is + 2, global_ns());)
    grid.sync();
    PROBE(if (stamp && istamp) is[3] = global_ns();)
  }
  if (stamp) sk.stamps[4] = global_ns();
  sinkhorn_candidates(D, sk, s);
  grid.sync();
  sinkhorn_task_candidates(D, st, sc, sk, s, sm);
  grid.sync();
  // with a lane on, every block stays for the lanes' close
  const bool lanes = kLanes && (sp.on || tn.on);
  if (blockIdx.x != 0 && !lanes) return;
  if (blockIdx.x == 0) {
    if (stamp) sk.stamps[5] = global_ns();
    sinkhorn_close(D, st, out, sc, sk, sm);
    if (stamp) sk.stamps[6] = global_ns();
  }
  if (lanes) {
    unsigned long long* lane_stamps = nullptr;
    PROBE(lane_stamps = ls + 2;)
    lanes_close(D, st, out, tn, sp, sc.assign, packet[0], lane_stamps, sm,
                grid);
    if (blockIdx.x != 0) return;
  }
  compact(D, st, out, sc.assign, sm);
  if (stamp) sk.stamps[7] = global_ns();
}

// n grid barriers and nothing else, on one 1024-thread block per SM (the
// Sinkhorn kernel's grid): the cost of a barrier alone.
__global__ void __launch_bounds__(NT, 1) barrier_probe_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

// scratch = sk0 sk1 sv0 sv1 [S each] ++ tk0 tk1 tv0 tv1 assign admitted [T each]
Scratch sort_scratch(int32_t* p, long S, long T) {
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
  return sc;
}

// out_i32 = placed_slots ++ placed_rows ++ arrival_slots ++ redispatch ++
//           n_pending ++ straggler [++ aux]; out_b8 = purged ++ live
Out outputs(int32_t* out_i32, uint8_t* out_b8, int W, int KA, int KP, int KR,
            int KG) {
  return Out{out_i32,
             out_i32 + KP,
             out_i32 + 2 * KP,
             out_i32 + 2 * KP + KA,
             out_i32 + 2 * KP + KA + KR,
             out_i32 + 2 * KP + KA + KR + 1,
             out_b8,
             out_b8 + W,
             out_i32 + 2 * KP + KA + KR + 1 + KG};
}

// The packet's lanes end where the speculation tail (2 floats) starts; the
// tenancy tail (share ++ ahead ++ cap, n floats each) follows it and ends
// the packet.
long lanes_len(const Dims& d, int tenancy, int spec) {
  const long lanes = 1 + d.use_priority + tenancy + spec;
  return HEADER + d.KA * lanes + 2L * (d.KH + d.KF + d.KI + d.KS + d.KB) +
         (spec ? d.KI : 0);
}

// The tenancy lane's arguments; off, every pointer is null.
// The tenancy scratch, in int32 words: cnt [n] ++ demand [ceil(n / 4)] ++
// tile_cnt tile_first [n kMaxRankBlocks each]. With p null it only counts.
long long tenancy_layout(int32_t* p, long long n, Tenancy* tn) {
  long long off = 0;
  auto take = [&](long long k) {
    int32_t* q = p ? p + off : nullptr;
    off += k;
    return q;
  };
  tn->cnt = take(n);
  tn->demand = reinterpret_cast<uint8_t*>(take((n + 3) / 4));
  tn->tile_cnt = take(n * kMaxRankBlocks);
  tn->tile_first = take(n * kMaxRankBlocks);
  return off;
}

Tenancy tenancy_args(const float* packet, const Dims& d, int on, int n,
                     int32_t* tenant, float* deficit, uint8_t* elig,
                     int32_t* scratch, float starve_deficit,
                     int starve_boost, float deficit_cap, int spec) {
  Tenancy tn{};
  tn.on = on;
  tn.n = n;
  if (!on) return tn;
  const float* tail = packet + lanes_len(d, 1, spec) + (spec ? 2 : 0);
  tn.tenant = tenant;
  tn.deficit = deficit;
  tn.share = tail;
  tn.ahead = tail + n;
  tn.cap = tail + 2 * n;
  tn.elig = elig;
  tenancy_layout(scratch, n, &tn);
  tn.starve_deficit = starve_deficit;
  tn.starve_boost = starve_boost;
  tn.deficit_cap = deficit_cap;
  return tn;
}

// The speculation lane's arguments; off, every pointer is null.
Spec spec_args(const float* packet, const Dims& d, int on, int tenancy,
               float* start, float* pred, int32_t* avoid, int32_t* free_rem) {
  Spec sp{};
  sp.on = on;
  if (!on) return sp;
  sp.start = start;
  sp.pred = pred;
  sp.avoid = avoid;
  sp.tail = packet + lanes_len(d, tenancy, 1);
  sp.free_rem = free_rem;
  return sp;
}

// One cooperative launch of as many NT-thread blocks as the card holds at
// once (at most max_blocks), each with smem bytes of dynamic shared memory.
// Returns 0, a CUDA error code, -1 when the device has no cooperative
// launch, or -2 when no block of the kernel fits on an SM.
int cooperative_launch(const void* kernel, void** args, void* stream,
                       int smem = 0, int max_blocks = 1 << 30) {
  int dev = 0, coop = 0, n_sm = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 0)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return -1;
  if (per_sm < 1) return -2;
  e = cudaLaunchCooperativeKernel(kernel, dim3(min(per_sm * n_sm, max_blocks)),
                                  dim3(NT), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Every entry takes the tenancy lane's arguments, then the speculation
// lane's, last before the stream: the tenant and t_deficit leaves, the
// eligibility output [T], the tenancy scratch
// (tpu_faas_fused_tenancy_scratch_words(NT) words, tenancy_layout),
// use_tenancy, NT, starve_deficit, starve_boost, deficit_cap; the infl_start,
// infl_pred and avoid leaves, the fixup's scratch free_rem [W], use_spec.
// With a lane off its pointers may be null.
#define LANE_PARAMS                                                         \
  int32_t *tenant, float *t_deficit, uint8_t *elig, int32_t *ten_scratch, \
      int use_tenancy, int n_tenants, float starve_deficit,               \
      int starve_boost, float deficit_cap, float *infl_start,             \
      float *infl_pred, int32_t *avoid, int32_t *free_rem, int use_spec
#define TENANCY_ARGS(packet, d)                                             \
  tenancy_args(packet, d, use_tenancy, n_tenants, tenant, t_deficit, elig, \
               ten_scratch, starve_deficit, starve_boost, deficit_cap,     \
               use_spec)
#define SPEC_ARGS(packet, d)                                                \
  spec_args(packet, d, use_spec, use_tenancy, infl_start, infl_pred, avoid, \
            free_rem)

// The hedge fixup's scratch, in int32 words (at an even offset): cnt
// [kFixCounts kMaxRankBlocks] ++ sel.cnt [kSelPasses RADIX] ++ sel.key [2W]
// ++ sel.mn sel.mx [2 kSelPasses RADIX each] ++ sel.mm [4] ++ cand
// [2 (kFixupK + 1)] ++ n_cand [2] ++ vet [kFixupK]; every count is even.
// With p null it only counts; returns the words.
long long fixup_layout(int32_t* p, long long W, Fixup* fx) {
  long long off = 0;
  auto take = [&](long long n) {
    int32_t* q = p ? p + off : nullptr;
    off += n;
    return q;
  };
  auto take64 = [&](long long n) {
    return reinterpret_cast<unsigned long long*>(take(2 * n));
  };
  fx->cnt = take(kFixCounts * kMaxRankBlocks);
  fx->sel.cnt = take(kSelPasses * RADIX);
  fx->sel.key = take64(W);
  fx->sel.mn = take64(kSelPasses * RADIX);
  fx->sel.mx = take64(kSelPasses * RADIX);
  fx->sel.mm = take64(2);
  fx->cand = take64(kFixupK + 1);
  fx->n_cand = take(2);
  fx->vet = take(kFixupK);
  return off;
}

// Scratch of the rank branch, in int32 words: the rank layout [4S + 6T] ++
// cnt [kRankCounts kMaxRankBlocks] ++ sel_cnt [kSelPasses RADIX] ++ key
// [2T] ++ sel_min sel_max [2 kSelPasses RADIX each] ++ key_mm [4] ++ the
// fixup's (fixup_layout) ++ word [kRankWords] ++ stamps [2 kRkStamps];
// every count is even, so the 64-bit words stay aligned. With p null it
// only counts; returns the words.
long long rank_layout(int32_t* p, long long T, long long W, long long S,
                      Scratch* sc, Rank* rk, Fixup* fx) {
  long long off = 0;
  auto take = [&](long long n) {
    int32_t* q = p ? p + off : nullptr;
    off += n;
    return q;
  };
  auto take64 = [&](long long n) {
    return reinterpret_cast<unsigned long long*>(take(2 * n));
  };
  int32_t* rank = take(4 * S + 6 * T);
  if (p) *sc = sort_scratch(rank, S, T);
  rk->cnt = take(kRankCounts * kMaxRankBlocks);
  rk->sel_cnt = take(kSelPasses * RADIX);
  rk->key = take64(T);
  rk->sel_min = take64(kSelPasses * RADIX);
  rk->sel_max = take64(kSelPasses * RADIX);
  rk->key_mm = take64(2);
  off += fixup_layout(p ? p + off : nullptr, W, fx);
  rk->word = take(kRankWords);
  rk->stamps = take64(kRkStamps);
  return off;
}

// The rank tick, or (flush) the delta packet alone. The rank tick is one
// cooperative launch and returns as the auction entry does; scratch holds
// tpu_faas_fused_rank_scratch_words() words, zeroed once before the first
// launch (it keeps the count of ticks that took the full-length path).
extern "C" int tpu_faas_fused_resident_tick(
    const float* packet, float* sizes, uint8_t* valid, int32_t* prio,
    float* last_hb, int32_t* free_cnt, int32_t* inflight, uint8_t* prev_live,
    float* speed, uint8_t* active, int32_t* out_i32, uint8_t* out_b8,
    int32_t* scratch, int T, int W, int I, int KA, int KH, int KF, int KI,
    int KS, int KB, int KP, int KR, int KG, int max_slots, int use_priority,
    int flush, LANE_PARAMS, void* stream) {
  Dims d{T, W, I, KA, KH, KF, KI, KS, KB, KP, KR, KG, max_slots, use_priority,
         flush};
  Tenancy tn = TENANCY_ARGS(packet, d);
  Spec sp = SPEC_ARGS(packet, d);
  State st{sizes, valid, use_tenancy ? elig : valid, prio, last_hb, free_cnt,
           inflight, prev_live, speed, active};
  Out o = outputs(out_i32, out_b8, W, KA, KP, KR, KG);
  if (flush) {
    fused_flush_kernel<<<1, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        packet, d, st, o, tn, sp);
    return static_cast<int>(cudaGetLastError());
  }
  Scratch sc;
  Rank rk;
  rank_layout(scratch, T, W, static_cast<long long>(W) * max_slots, &sc, &rk,
              &sp.fx);
  void* args[] = {&packet, &d, &st, &o, &sc, &rk, &tn, &sp};
  return cooperative_launch(reinterpret_cast<const void*>(fused_rank_kernel),
                            args, stream, 0, kMaxRankBlocks);
}

extern "C" long long tpu_faas_fused_rank_scratch_words(int T, int W,
                                                       int max_slots) {
  Rank rk;
  Fixup fx;
  return rank_layout(nullptr, T, W, static_cast<long long>(W) * max_slots,
                     nullptr, &rk, &fx);
}

// The int32 offsets in the rank scratch of its phase stamps (kRkStamps
// uint64 words, written by a probe build alone) and of the count of ticks
// that took the full-length path (every build).
extern "C" long long tpu_faas_fused_rank_stamps_offset(int T, int W,
                                                       int max_slots) {
  return tpu_faas_fused_rank_scratch_words(T, W, max_slots) - 2 * kRkStamps;
}

extern "C" long long tpu_faas_fused_rank_fallbacks_offset(int T, int W,
                                                          int max_slots) {
  return tpu_faas_fused_rank_stamps_offset(T, W, max_slots) - kRankWords +
         kWordFallbacks;
}

extern "C" int tpu_faas_fused_rank_stamp_count() { return kRkStamps; }

extern "C" long long tpu_faas_fused_tenancy_scratch_words(int n_tenants) {
  Tenancy tn;
  return tenancy_layout(nullptr, n_tenants, &tn);
}

// Scratch of the auction branch, in int32 words: slot_bid [2S] ++ the rank
// layout [4S + 6T] ++ inv owner free_id kpos kept kprice [S each]
// ++ assigned bid list0 list1 adm [T each] ++ counts [kRankCounts
// kMaxRankBlocks] ++ word [kAuWords] ++ cnt [2] ++ nonfinite [1] ++
// part_v1 part_b part_v2 [kMaxItems kRows each] ++ ticket [kMaxItems] ++
// (8-byte alignment) ++ the fixup's (fixup_layout) ++ stamps [2 kAuStamps].
// With p null it only counts; returns the words.
long long auction_layout(int32_t* p, long long T, long long W, long long S,
                         Scratch* sc, Auction* au, Fixup* fx) {
  long long off = 0;
  auto take = [&](long long n) {
    int32_t* q = p ? p + off : nullptr;
    off += n;
    return q;
  };
  auto takef = [&](long long n) { return reinterpret_cast<float*>(take(n)); };
  au->slot_bid = reinterpret_cast<unsigned long long*>(take(2 * S));
  int32_t* rank = take(4 * S + 6 * T);
  if (p) *sc = sort_scratch(rank, S, T);
  au->inv = takef(S);
  au->owner = take(S);
  au->free_id = take(S);
  au->kpos = take(S);
  au->kept = take(S);
  au->kprice = takef(S);
  au->assigned = take(T);
  au->bid = takef(T);
  au->list[0] = take(T);
  au->list[1] = take(T);
  au->adm = take(T);
  au->counts = take(kRankCounts * kMaxRankBlocks);
  au->word = take(kAuWords);
  au->cnt = take(2);
  au->nonfinite = take(1);
  au->part_v1 = takef(kMaxItems * kRows);
  au->part_b = take(kMaxItems * kRows);
  au->part_v2 = takef(kMaxItems * kRows);
  au->ticket = take(kMaxItems);
  take(off & 1);
  off += fixup_layout(p ? p + off : nullptr, W, fx);
  au->stamps = reinterpret_cast<unsigned long long*>(take(2 * kAuStamps));
  return off;
}

// The auction branch: one cooperative launch of at most kMaxRankBlocks
// blocks (its per-block count rows). Returns 0, a CUDA error code, -1 when
// the device has no cooperative launch, or -2 when no block of the kernel
// fits on an SM. out_i32 ends with the four aux words (rounds, spilled,
// bidder rows summed over the rounds, 1 on the full-length path). scratch
// holds tpu_faas_fused_auction_scratch_words() words.
extern "C" int tpu_faas_fused_resident_auction(
    const float* packet, float* sizes, uint8_t* valid, int32_t* prio,
    float* last_hb, int32_t* free_cnt, int32_t* inflight, uint8_t* prev_live,
    float* speed, uint8_t* active, float* price, uint8_t* refresh,
    int32_t* out_i32, uint8_t* out_b8, int32_t* scratch, int T, int W, int I,
    int KA, int KH, int KF, int KI, int KS, int KB, int KP, int KR, int KG,
    int max_slots, int use_priority, int warm_rounds, float eps, float jitter,
    LANE_PARAMS, void* stream) {
  Dims d{T, W, I, KA, KH, KF, KI, KS, KB, KP, KR, KG, max_slots, use_priority,
         0};
  Tenancy tn = TENANCY_ARGS(packet, d);
  Spec sp = SPEC_ARGS(packet, d);
  State st{sizes, valid, use_tenancy ? elig : valid, prio, last_hb, free_cnt,
           inflight, prev_live, speed, active};
  Out o = outputs(out_i32, out_b8, W, KA, KP, KR, KG);
  Auction au;
  au.price = price;
  au.refresh = refresh;
  Scratch sc;
  auction_layout(scratch, T, W, static_cast<long long>(W) * max_slots, &sc,
                 &au, &sp.fx);
  au.eps = eps;
  au.jitter = jitter;
  au.warm_rounds = warm_rounds;

  void* args[] = {&packet, &d, &st, &o, &sc, &au, &tn, &sp};
  const bool lanes = use_tenancy || use_spec;
  return cooperative_launch(
      lanes ? reinterpret_cast<const void*>(fused_auction_kernel<true>)
            : reinterpret_cast<const void*>(fused_auction_kernel<false>),
      args, stream, 0, kMaxRankBlocks);
}

extern "C" long long tpu_faas_fused_auction_scratch_words(int T, int W,
                                                          int max_slots) {
  Auction au;
  Fixup fx;
  return auction_layout(nullptr, T, W, static_cast<long long>(W) * max_slots,
                        nullptr, &au, &fx);
}

// The scratch offset, in int32 words, of the auction branch's phase stamps
// (kAuStamps uint64 nanosecond clocks of the last launch on that scratch;
// written by a probe build alone).
extern "C" long long tpu_faas_fused_auction_stamps_offset(int T, int W,
                                                          int max_slots) {
  return tpu_faas_fused_auction_scratch_words(T, W, max_slots) - 2 * kAuStamps;
}

extern "C" int tpu_faas_fused_auction_stamp_count() { return kAuStamps; }

// Scratch of the Sinkhorn branch, in int32 words: the rank layout
// [4S + 6T] ++ rowv row_ok loga ft row_a row_f [R each] ++ logb gt col_a
// col_g [C each] ++ colv capf used remaining seg_first [W each] ++ logs
// bucket best_w best_p to_slack a0 spilled cand [T each] ++ counts best_w_b
// to_slack_b [nb each] ++ cand_n cand_off [kMaxBlocks each] ++ red [kRed]
// ++ (8-byte alignment) ++ the fixup's (fixup_layout) ++ stamps
// [2 kSkStamps].
// With p null it only counts; returns the words.
long long sinkhorn_layout(int32_t* p, long long T, long long W,
                          long long S, Scratch* sc, Sinkhorn* sk,
                          Fixup* fx) {
  const long long R = sk->R, C = sk->C, nb = sk->nb;
  long long off = 0;
  auto take = [&](long long n) {
    int32_t* q = p ? p + off : nullptr;
    off += n;
    return q;
  };
  auto takef = [&](long long n) { return reinterpret_cast<float*>(take(n)); };
  int32_t* rank = take(4 * S + 6 * T);
  if (p) *sc = sort_scratch(rank, S, T);
  sk->rowv = takef(R);
  sk->row_ok = take(R);
  sk->loga = takef(R);
  sk->ft = takef(R);
  sk->row_a = takef(R);
  sk->row_f = takef(R);
  sk->logb = takef(C);
  sk->gt = takef(C);
  sk->col_a = takef(C);
  sk->col_g = takef(C);
  sk->colv = takef(W);
  sk->capf = takef(W);
  sk->used = take(W);
  sk->remaining = take(W);
  sk->seg_first = take(W);
  sk->logs = takef(T);
  sk->bucket = take(T);
  sk->best_w = take(T);
  sk->best_p = takef(T);
  sk->to_slack = take(T);
  sk->a0 = take(T);
  sk->spilled = take(T);
  sk->cand = take(T);
  sk->counts = take(nb);
  sk->best_w_b = take(nb);
  sk->to_slack_b = take(nb);
  sk->cand_n = take(kMaxBlocks);
  sk->cand_off = take(kMaxBlocks);
  sk->red = reinterpret_cast<uint32_t*>(take(kRed));
  take(off & 1);  // 8-byte alignment for the stamps
  off += fixup_layout(p ? p + off : nullptr, W, fx);
  sk->stamps = reinterpret_cast<unsigned long long*>(take(2 * kSkStamps));
  return off;
}

Sinkhorn sinkhorn_shape(int T, int W, int bucketed, int n_buckets) {
  Sinkhorn sk{};
  sk.bucketed = bucketed;
  sk.nb = bucketed ? n_buckets : 0;
  sk.R = (bucketed ? n_buckets : T) + 1;
  sk.C = W + 1;
  sk.vec_smem = 2LL * (sk.R + sk.C) <= kVecSmemFloats;
  return sk;
}

extern "C" long long tpu_faas_fused_sinkhorn_scratch_words(
    int T, int W, int max_slots, int bucketed, int n_buckets) {
  Sinkhorn sk = sinkhorn_shape(T, W, bucketed, n_buckets);
  Fixup fx;
  return sinkhorn_layout(nullptr, T, W, static_cast<long long>(W) * max_slots,
                         nullptr, &sk, &fx);
}

// The Sinkhorn branch: one cooperative launch. Returns as the auction entry
// does. f [R] and g [W+1] receive the final potentials, R = n_buckets + 1
// (bucketed) or T + 1 (dense); scratch holds
// tpu_faas_fused_sinkhorn_scratch_words() words; tau [1] receives the
// effective temperature.
extern "C" int tpu_faas_fused_resident_sinkhorn(
    const float* packet, float* sizes, uint8_t* valid, int32_t* prio,
    float* last_hb, int32_t* free_cnt, int32_t* inflight, uint8_t* prev_live,
    float* speed, uint8_t* active, int32_t* out_i32, uint8_t* out_b8,
    float* f, float* g, float* tau_out, int32_t* scratch, int T, int W,
    int I, int KA, int KH, int KF, int KI, int KS, int KB, int KP, int KR,
    int KG, int max_slots, int use_priority, int bucketed, int n_buckets,
    int n_iters, float tau, LANE_PARAMS, void* stream) {
  Dims d{T, W, I, KA, KH, KF, KI, KS, KB, KP, KR, KG, max_slots, use_priority,
         0};
  Tenancy tn = TENANCY_ARGS(packet, d);
  Spec sp = SPEC_ARGS(packet, d);
  State st{sizes, valid, use_tenancy ? elig : valid, prio, last_hb, free_cnt,
           inflight, prev_live, speed, active};
  Out o = outputs(out_i32, out_b8, W, KA, KP, KR, KG);
  Sinkhorn sk = sinkhorn_shape(T, W, bucketed, n_buckets);
  sk.n_iters = n_iters;
  sk.tau_rel = tau;
  sk.f = f;
  sk.g = g;
  sk.tau_out = tau_out;
  Scratch sc;
  sinkhorn_layout(scratch, T, W, static_cast<long long>(W) * max_slots, &sc,
                  &sk, &sp.fx);
  void* args[] = {&packet, &d, &st, &o, &sc, &sk, &tn, &sp};
  const int smem = static_cast<int>(
      sizeof(float) * (2 * NWARP + (sk.vec_smem ? 2 * (sk.R + sk.C) : 0)));
  // a lane's per-block rows hold kMaxRankBlocks blocks
  const bool lanes = use_tenancy || use_spec;
  return cooperative_launch(
      lanes ? reinterpret_cast<const void*>(fused_sinkhorn_kernel<true>)
            : reinterpret_cast<const void*>(fused_sinkhorn_kernel<false>),
      args, stream, smem, lanes ? kMaxRankBlocks : kMaxBlocks);
}

// expf and logf of n floats, compiled as the Sinkhorn branch compiles them:
// for checking them bit for bit against torch.exp and torch.log on the card.
__global__ void math_probe_kernel(const float* x, float* e, float* l, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    e[i] = expf(x[i]);
    l[i] = logf(x[i]);
  }
}

extern "C" int tpu_faas_math_probe(const float* x, float* e, float* l, int n,
                                   void* stream) {
  math_probe_kernel<<<256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, e, l, n);
  return static_cast<int>(cudaGetLastError());
}

// The scratch offset, in int32 words, of the Sinkhorn branch's phase stamps
// (kSkStamps uint64 nanosecond clocks and counts of the last launch on that
// scratch: the phases in every build, then the probe build's split).
extern "C" long long tpu_faas_fused_sinkhorn_stamps_offset(
    int T, int W, int max_slots, int bucketed, int n_buckets) {
  Sinkhorn sk = sinkhorn_shape(T, W, bucketed, n_buckets);
  Fixup fx;
  return sinkhorn_layout(nullptr, T, W, static_cast<long long>(W) * max_slots,
                         nullptr, &sk, &fx) - 2 * kSkStamps;
}

extern "C" int tpu_faas_fused_sinkhorn_stamp_count() { return kSkStamps; }

extern "C" int tpu_faas_barrier_probe(int n, void* stream) {
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&n};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(
                                      barrier_probe_kernel),
                                  dim3(n_sm), dim3(NT), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
