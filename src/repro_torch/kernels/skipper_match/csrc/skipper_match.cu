// Hand-written Hopper (sm_90a) kernels for the single-pass matcher's two
// tiers, with a plain C interface loaded by kernel.py through ctypes.
//
// All kernels run one tile body, match_tile(): the first-claim rounds and
// the exact fallback of src/repro/core/engine.py (run_first_claim_rounds,
// :482; greedy_fallback_rounds, :564) on T edges, one thread per lane:
//
//   free_l    = valid_l && !matched_l && state[u_l] == ACC && state[v_l] == ACC
//   blocked_l = free_l && some free j < l shares an endpoint with edge l
//   commit_l  = free_l && !blocked_l     -> state[u_l] = state[v_l] = MCHD
//
// The first `vector_rounds` rounds count blocked rounds into conflicts[l];
// further rounds run until no edge of the tile is free (the fallback: its
// fixpoint is the sequential index-order greedy over the tile). A round in
// which nothing is free changes nothing, so one loop that stops at the
// first such round computes both. `blocked` is the O(T) per-lane scan of
// earlier lanes in shared memory (engine.py:28 allows any of its forms).
// The TPU kernel's one-hot MXU matmuls are only its device for gather and
// scatter; here state cells are indexed directly.
//
// State is ACC = 0 / MCHD = 2 at the StateSpec's kernel width S (uint8 or
// int32); matched/conflicts are written at the counter width C.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMatched = 2;

__host__ __device__ inline size_t align4(size_t n) { return (n + 3) & ~size_t(3); }

// Shared-memory layout of the window-tier kernel:
// [state row: window * sizeof(S), padded to 4][u: T ints][v: T ints][free: T bytes]
template <typename S>
__host__ __device__ inline size_t window_tier_smem(int window, int tile) {
  return align4(size_t(window) * sizeof(S)) + size_t(tile) * 9;
}

// Window tier: tile-local ids index the block's shared-memory row.
template <typename S>
struct RowCell {
  S* row;
  __device__ S* operator()(int id) const { return row + id; }
};

// Global tier: offset-local ids address the pair's two rows of the
// [num_windows, window] device state. u side: blk_u * W + id; v side of a
// cross-block pair (id >= W): blk_v * W + id - W. A same-block pair has
// every id < W, so it reads and writes row blk_u only.
template <typename S>
struct PairCell {
  S* row_u;
  S* row_v;
  int window;
  __device__ S* operator()(int id) const {
    return id < window ? row_u + id : row_v + (id - window);
  }
};

// Scratch of the free-list blocked test: a count per warp and the free
// lanes' u and v ids (T ints each), in arrays of their own.
struct FreeList {
  int* counts;
  int* u;
  int* v;
};

// Whether this lane's edge is blocked: some free j < l shares an endpoint.
// The same predicate as match_tile's lane-by-lane scan, over the free
// lanes only: the free lanes' ids are compacted, in lane order, into the
// free list through warp ballots and a prefix over the warps, and a free
// lane scans the entries before its own. Every lane of the block calls it
// (two barriers inside).
__device__ __forceinline__ bool blocked_by_free_list(bool fr, int uu, int vv,
                                                     FreeList fl) {
  const int l = threadIdx.x, T = blockDim.x, lane = l & 31, warp = l >> 5;
  const int in_warp = min(T - (l & ~31), 32);
  const unsigned mask = in_warp == 32 ? 0xffffffffu : (1u << in_warp) - 1u;
  const unsigned ballot = __ballot_sync(mask, fr);
  int* counts = fl.counts;
  int* lu = fl.u;
  int* lv = fl.v;
  if (lane == 0) counts[warp] = __popc(ballot);
  __syncthreads();  // every warp's count is visible
  int rank = __popc(ballot & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) rank += counts[w];
  if (fr) {
    lu[rank] = uu;
    lv[rank] = vv;
  }
  __syncthreads();  // the list is complete
  bool hit = false;
  if (fr) {
#pragma unroll 4
    for (int i = 0; i < rank; ++i) {
      const int a = lu[i], b = lv[i];
      hit |= a == uu || a == vv || b == uu || b == vv;
    }
  }
  return hit;
}

// One tile; lane = threadIdx.x, T = blockDim.x. tu/tv hold the tile's ids
// (visible to every lane before the call), frs is T bytes of scratch.
// With kFreeList the blocked test is blocked_by_free_list, on free_list;
// without it, the lane-by-lane scan of frs.
// Every lane returns together, after a barrier that follows its last read
// of tu/tv/frs/free_list and its last state write, with the number of
// rounds in which some lane was free (the same in every lane).
template <typename S, typename Cell, bool kFreeList = false>
__device__ int match_tile(int uu, int vv, const int* tu, const int* tv,
                          unsigned char* frs, Cell cell, int vector_rounds,
                          bool fallback, bool& matched, int& conflicts,
                          FreeList free_list = {}) {
  const int l = threadIdx.x;
  const bool valid = uu >= 0 && uu != vv;
  matched = false;
  conflicts = 0;
  int r = 0;
  for (;; ++r) {
    if (!fallback && r >= vector_rounds) break;  // uniform over the block
    bool fr = false;
    if (valid && !matched) fr = *cell(uu) == 0 && *cell(vv) == 0;
    frs[l] = fr;
    // barrier: every lane's state reads and free flag precede any write
    if (!__syncthreads_or(fr)) break;
    bool blocked = false;
    if constexpr (kFreeList) {
      blocked = blocked_by_free_list(fr, uu, vv, free_list);
    } else if (fr) {
      for (int j = 0; j < l; ++j) {
        if (frs[j]) {
          const int a = tu[j], b = tv[j];
          if (a == uu || a == vv || b == uu || b == vv) {
            blocked = true;
            break;
          }
        }
      }
    }
    if (blocked && r < vector_rounds) ++conflicts;
    if (fr && !blocked) {  // committed edges are endpoint-disjoint
      *cell(uu) = S(kMatched);
      *cell(vv) = S(kMatched);
      matched = true;
    }
    __syncthreads();  // commits and frs reads precede the next round
  }
  return r;
}

// Replaces src/repro/kernels/skipper_match/kernel.py::skipper_pipeline_kernel
// (:158) and, launched with one row, skipper_window_kernel (:121).
// One block per schedule row (rows are independent windows), T threads.
// The row's W-cell state lives in dynamic shared memory for all of the
// row's tiles, which the block walks in order.
// Bound on this card: bytes are ~10 per slot (ids in, counters out), but
// what limits it today is the serial chain of tiles inside one block and
// the O(T) blocked scan per round; with one row (the full-scale schedule)
// one SM does the whole tier. This is the simple first design, superseded
// on the main path by skipper_window_async_kernel below; it stays as that
// kernel's yardstick, for shapes whose ring does not fit, and as the body
// the dropped_dma_wait canary copies.
template <typename S, typename C>
__global__ void skipper_window_tier_kernel(
    const int* __restrict__ u, const int* __restrict__ v,
    const S* __restrict__ state_in, S* __restrict__ state_out,
    C* __restrict__ matched, C* __restrict__ conflicts, int window,
    int tiles_per_row, int vector_rounds, int fallback) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x, l = threadIdx.x;
  S* st = reinterpret_cast<S*>(smem);
  int* tu = reinterpret_cast<int*>(smem + align4(size_t(window) * sizeof(S)));
  int* tv = tu + T;
  unsigned char* frs = reinterpret_cast<unsigned char*>(tv + T);
  const size_t row = blockIdx.x;
  for (int i = l; i < window; i += T) st[i] = state_in[row * window + i];
  const size_t slots = size_t(tiles_per_row) * T;
  const RowCell<S> cell{st};
  for (int t = 0; t < tiles_per_row; ++t) {
    const size_t k = row * slots + size_t(t) * T + l;
    const int uu = u[k], vv = v[k];
    tu[l] = uu;
    tv[l] = vv;
    __syncthreads();  // ids (and, at t == 0, the state row) visible
    bool m;
    int c;
    match_tile<S>(uu, vv, tu, tv, frs, cell, vector_rounds, fallback != 0, m, c);
    matched[k] = C(m);
    conflicts[k] = C(c);
  }
  __syncthreads();
  for (int i = l; i < window; i += T) state_out[row * window + i] = st[i];
}

// Replaces src/repro/kernels/skipper_match/kernel.py::skipper_boundary_kernel
// (:196). ONE persistent block walks the block-pair grouped global-tier
// tiles in schedule order, so tile k sees every earlier tile's commits
// without any cross-block synchronisation. State cells are addressed in
// device memory directly (the 4 MB state of the full-scale graph sits in
// the 50 MB L2); the TPU kernel's v-then-u write-back is moot here.
// Bound on this card: ~10 bytes per slot, but the serial tile chain in one
// block is the real limit today. This is the simple first design.
template <typename S, typename C>
__global__ void skipper_boundary_kernel(
    const int* __restrict__ blk_u, const int* __restrict__ blk_v,
    const int* __restrict__ u, const int* __restrict__ v, S* state,
    C* __restrict__ matched, C* __restrict__ conflicts, int window,
    int num_tiles, int vector_rounds, int fallback) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x, l = threadIdx.x;
  int* tu = reinterpret_cast<int*>(smem);
  int* tv = tu + T;
  unsigned char* frs = reinterpret_cast<unsigned char*>(tv + T);
  for (int t = 0; t < num_tiles; ++t) {
    const size_t k = size_t(t) * T + l;
    const int uu = u[k], vv = v[k];
    const PairCell<S> cell{state + size_t(blk_u[t]) * window,
                           state + size_t(blk_v[t]) * window, window};
    tu[l] = uu;
    tv[l] = vv;
    __syncthreads();
    bool m;
    int c;
    match_tile<S>(uu, vv, tu, tv, frs, cell, vector_rounds, fallback != 0, m, c);
    matched[k] = C(m);
    conflicts[k] = C(c);
  }
}

// ---- asynchronous copies (the global tier fed ahead of use) ----------------

// the ring: kRing stages of kGroup consecutive tiles each
constexpr int kGroup = 4;
constexpr int kRing = 4;
// counters of the asynchronous global tier's optional cycle profile
constexpr int kProfileFields = 8;
// the largest tile (threads a block) the kernels take
constexpr int kMaxTile = 1024;
// the largest tile skipper_boundary_async_kernel takes: its 64-67
// registers a thread (72 allocated) fit a block of 896 lanes, not 1,024.
// The analyzer's registers rule holds it to that; a __launch_bounds__
// forcing fewer registers slowed its tile body by about 90 cycles
// (PERF.md, PR 16). kernel.py sends wider tiles to skipper_boundary_kernel.
constexpr int kMaxAsyncBoundaryTile = 896;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// 4 bytes global -> shared, asynchronously
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(src)
               : "memory");
}

// the barrier counts this lane's arrival once its earlier cp.async land
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::
                   "l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// One ring stage holds kGroup consecutive tiles:
// [blk_u: kGroup ints][blk_v: kGroup ints][u: kGroup * T ints][v: the same].
// Consecutive tiles' ids and pairs are contiguous in device memory, so a
// whole group arrives by four bulk copies.
__host__ __device__ inline size_t ring_stage_bytes(int tile) {
  return 8 * kGroup + 8 * size_t(kGroup) * tile;
}

// Dynamic shared memory of the asynchronous global tier:
// [two state rows: 2 * window * sizeof(S), staged instance only]
// [ring: kRing stages]. The free flags, the warp counts and the free
// lists are static arrays of the kernel, sized for kMaxTile.
template <typename S>
__host__ __device__ inline size_t boundary_async_smem(int window, int tile,
                                                      bool staged) {
  return (staged ? 2 * size_t(window) * sizeof(S) : 0) +
         kRing * ring_stage_bytes(tile);
}

// Lane 0 fills a ring stage with tile group g: a whole group by four bulk
// copies (16-byte aligned: its first tile is a multiple of kGroup),
// completing with their bytes on the stage's "full" barrier (arrival 1);
// a last, partial group by 4-byte cp.async. Its cp.async arrive (arrival
// 2) completes once those land.
__device__ __forceinline__ void fill_group(unsigned char* stage, uint32_t bar,
                                           const int* blk_u, const int* blk_v,
                                           const int* u, const int* v, int g,
                                           int num_tiles, int T) {
  const int t0 = kGroup * g, n = min(kGroup, num_tiles - t0);
  const uint32_t base = smem_addr(stage);
  const uint32_t du = base + 8 * kGroup, dv = du + 4 * kGroup * T;
  const size_t k0 = size_t(t0) * T;
  if (n == kGroup) {
    mbar_expect_tx(bar, uint32_t(ring_stage_bytes(T)));
    bulk_load(base, blk_u + t0, 4 * kGroup, bar);
    bulk_load(base + 4 * kGroup, blk_v + t0, 4 * kGroup, bar);
    bulk_load(du, u + k0, 4 * kGroup * T, bar);
    bulk_load(dv, v + k0, 4 * kGroup * T, bar);
  } else {
    mbar_expect_tx(bar, 0);
    for (int i = 0; i < n; ++i) {
      cp_async4(base + 4 * i, blk_u + t0 + i);
      cp_async4(base + 4 * kGroup + 4 * i, blk_v + t0 + i);
    }
    for (int i = 0; i < n * T; ++i) {
      cp_async4(du + 4 * i, u + k0 + i);
      cp_async4(dv + 4 * i, v + k0 + i);
    }
  }
  cp_async_arrive(bar);
}

// Replaces src/repro/kernels/skipper_match/kernel.py::skipper_boundary_kernel
// (:196), as skipper_boundary_kernel did, with the same tile arithmetic
// and the same result bit for bit: ONE block walks the global-tier tiles
// in schedule order. It stays one block on purpose: on the full-scale RMAT
// schedule the tiles' dependency chains leave no parallelism across blocks
// (a host replay of the schedule: critical path 146,921 of 158,396 tiles
// by block pair, 144,864 by exact vertex, 1.08x and 1.09x), and the result
// must equal the serial order.
// What it changes is what each tile waits for. Bound on this card: ~10
// bytes a slot, but the limit is the latency chain of each tile, and that
// kernel's chain began with device-memory loads of the ids and of the
// pair's state cells. Here:
//   * the ids come ahead of use: lane 0 fills a ring of kRing stages of
//     kGroup tiles with bulk copies (fill_group), each completing on the
//     stage's "full" mbarrier, so a tile waits on a barrier that completed
//     long before. Each warp releases a stage on its "empty" mbarrier (one
//     arrive a warp, after __syncwarp) when it is done with the stage's
//     last tile; then lane 0 refills the stage of the group before, which
//     every warp released a group earlier, with the group kRing - 1
//     ahead;
//   * the blocked test scans only the free lanes before a lane
//     (blocked_by_free_list), not every earlier lane one shared-memory
//     latency at a time: a tile has few free lanes, and the last of them
//     set the tile's time;
//   * kStaged: the pair's two state rows live in shared memory. Pairs come
//     in lexicographic order (graphs/windows.py), so the u row changes at
//     most num_windows times and the v row once a pair; a changed row is
//     written back with a bulk store (after fence.proxy.async: its cells
//     were last written by generic stores) and the new one loaded with a
//     bulk copy that completes on an mbarrier. A same-block pair uses one
//     row. Without kStaged (rows that do not fit beside the ring) the
//     state stays in device memory, addressed as skipper_boundary_kernel
//     does; the ring still feeds the ids.
// profile (null unless asked for): thread 0's clock64 cycles over the tile
// loop, summed over the tiles, into kProfileFields counters (the order of
// kernel.py's PROFILE_FIELDS).
template <typename S, typename C, bool kStaged>
__global__ void skipper_boundary_async_kernel(
    const int* __restrict__ blk_u, const int* __restrict__ blk_v,
    const int* __restrict__ u, const int* __restrict__ v, S* state,
    C* __restrict__ matched, C* __restrict__ conflicts, int window,
    int num_tiles, int vector_rounds, int fallback,
    unsigned long long* __restrict__ profile) {
  __shared__ __align__(8) uint64_t full_bar[kRing];
  __shared__ __align__(8) uint64_t empty_bar[kRing];
  __shared__ __align__(8) uint64_t row_bar;
  __shared__ unsigned char frs[kMaxTile];
  __shared__ int warp_counts[32];
  __shared__ int free_u[kMaxTile];
  __shared__ int free_v[kMaxTile];
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x, l = threadIdx.x;
  // scalars, not arrays: a small array indexed at run time would live in
  // local memory
  const size_t row_bytes = kStaged ? size_t(window) * sizeof(S) : 0;
  const uint32_t rb = uint32_t(row_bytes);
  unsigned char* const ring = smem + 2 * row_bytes;
  const size_t stage_bytes = ring_stage_bytes(T);
  const uint32_t bar0 = smem_addr(full_bar), ebar0 = smem_addr(empty_bar);
  const uint32_t rbar = smem_addr(&row_bar);
  const int warps = (T + 31) / 32;
  // this lane's warp (the last one may be partial), for __syncwarp
  const int in_warp = min(T - (l & ~31), 32);
  const unsigned warp_mask =
      in_warp == 32 ? 0xffffffffu : (1u << in_warp) - 1u;
  if (l == 0) {
    for (int i = 0; i < kRing; ++i) {
      mbar_init(bar0 + 8 * i, 2);
      mbar_init(ebar0 + 8 * i, warps);
    }
    mbar_init(rbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int num_groups = (num_tiles + kGroup - 1) / kGroup;
  if (l == 0)
    for (int g = 0; g < kRing && g < num_groups; ++g)
      fill_group(ring + g * stage_bytes, bar0 + 8 * g, blk_u, blk_v, u, v, g,
                 num_tiles, T);
  int res0 = -1, res1 = -1;  // block held by each state slot (staged)
  uint32_t row_phase = 0;
  const bool timed = profile != nullptr && l == 0;
  unsigned long long spans[kProfileFields] = {};
  long long c0 = 0, c1 = 0, c2 = 0, c3 = 0;
  for (int t = 0; t < num_tiles; ++t) {
    if (timed) c0 = clock64();
    const int g = t / kGroup, i = t % kGroup, st = g % kRing;
    // a completed phase: every tile of the group waits, and passes
    mbar_wait(bar0 + 8 * st, (g / kRing) & 1);
    const int* grp = reinterpret_cast<const int*>(ring + st * stage_bytes);
    const int* tu = grp + 2 * kGroup + i * T;
    const int* tv = tu + kGroup * T;
    const int bu = grp[i], bv = grp[kGroup + i];
    if (timed) c1 = clock64();
    const int uu = tu[l], vv = tv[l];
    S* row_u;
    S* row_v;
    if constexpr (kStaged) {
      // the pair's rows in the two slots; every lane decides alike
      int su = res0 == bu ? 0 : res1 == bu ? 1 : -1;
      int load0 = -1, load1 = -1;
      if (su < 0) {
        su = (bv != bu && res0 == bv) ? 1 : 0;
        (su == 0 ? load0 : load1) = bu;
      }
      const int sv = bv == bu ? su : 1 - su;
      if (bv != bu && (sv == 0 ? res0 : res1) != bv)
        (sv == 0 ? load0 : load1) = bv;
      if (load0 >= 0 || load1 >= 0) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncthreads();  // every lane's state writes precede the stores
        if (l == 0) {
          if (load0 >= 0 && res0 >= 0)
            bulk_store(state + size_t(res0) * window, smem_addr(smem), rb);
          if (load1 >= 0 && res1 >= 0)
            bulk_store(state + size_t(res1) * window, smem_addr(smem + rb),
                       rb);
          bulk_wait_all();  // written back before any row is read again
          mbar_expect_tx(rbar, rb * ((load0 >= 0) + (load1 >= 0)));
          if (load0 >= 0)
            bulk_load(smem_addr(smem), state + size_t(load0) * window, rb,
                      rbar);
          if (load1 >= 0)
            bulk_load(smem_addr(smem + rb), state + size_t(load1) * window,
                      rb, rbar);
        }
        if (load0 >= 0) res0 = load0;
        if (load1 >= 0) res1 = load1;
        mbar_wait(rbar, row_phase);
        row_phase ^= 1;
      }
      row_u = reinterpret_cast<S*>(smem + su * row_bytes);
      row_v = reinterpret_cast<S*>(smem + sv * row_bytes);
    } else {
      row_u = state + size_t(bu) * window;
      row_v = state + size_t(bv) * window;
    }
    const size_t k = size_t(t) * T + l;
    bool m;
    int c;
    if (timed) c2 = clock64();
    const int rounds = match_tile<S, PairCell<S>, true>(
        uu, vv, tu, tv, frs, PairCell<S>{row_u, row_v, window},
        vector_rounds, fallback != 0, m, c,
        FreeList{warp_counts, free_u, free_v});
    if (timed) c3 = clock64();
    matched[k] = C(m);
    conflicts[k] = C(c);
    if (i == kGroup - 1) {
      __syncwarp(warp_mask);  // the warp is done with the stage
      if ((l & 31) == 0) {
        mbar_arrive(ebar0 + 8 * st);
        const int next = g - 1 + kRing;
        if (l == 0 && g >= 1 && next < num_groups) {
          const int sp = next % kRing;
          mbar_wait(ebar0 + 8 * sp, ((g - 1) / kRing) & 1);
          fill_group(ring + sp * stage_bytes, bar0 + 8 * sp, blk_u, blk_v, u,
                     v, next, num_tiles, T);
        }
      }
    }
    if (timed) {
      const long long c4 = clock64();
      spans[0] += c1 - c0;  // the stage's barrier, the pair and ids
      spans[1] += c2 - c1;  // the state rows (staged)
      spans[2] += c3 - c2;  // the tile body
      spans[3] += c4 - c3;  // counters, release, refill
      if (rounds > 0) {     // tiles in which some lane was free
        spans[4] += 1;
        spans[5] += c3 - c2;
        spans[6] += rounds;
      }
      spans[7] += c4 - c0;
    }
  }
  if (timed)
    for (int f = 0; f < kProfileFields; ++f) profile[f] = spans[f];
  if constexpr (kStaged) {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (l == 0) {
      if (res0 >= 0)
        bulk_store(state + size_t(res0) * window, smem_addr(smem), rb);
      if (res1 >= 0)
        bulk_store(state + size_t(res1) * window, smem_addr(smem + rb), rb);
      bulk_wait_all();
    }
  }
}

// ---- the window tier fed ahead of use ---------------------------------------

// a window-tier ring stage holds kWinGroup consecutive tiles of a row; the
// ring has at most kWinMaxStages stages (kernel.py picks the depth)
constexpr int kWinGroup = 16;
constexpr int kWinMaxStages = 8;

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// One stage: [u: kWinGroup * T ints][v: the same].
__host__ __device__ inline size_t win_stage_bytes(int tile) {
  return 8 * size_t(kWinGroup) * tile;
}

// Dynamic shared memory of the asynchronous window tier:
// [state row: window * sizeof(S), padded to 16][ring: stages stages]. The
// free flags, the free list, the warp counts and the stage's tile bits are
// static arrays of the kernel, sized for kMaxTile.
template <typename S>
__host__ __device__ inline size_t window_async_smem(int window, int tile,
                                                    int stages) {
  return align16(size_t(window) * sizeof(S)) +
         size_t(stages) * win_stage_bytes(tile);
}

// Lane 0 fills a stage with the n tiles that start at slot k0 of the row's
// ids (consecutive tiles of a row are contiguous); the stage's "full"
// barrier expects one arrival. A whole stage whose ids start on a 16-byte
// boundary comes by two bulk copies, completing with their bytes on the
// barrier after its one arrival (expect_tx); the row's last, partial stage,
// or a row whose slots start off a 16-byte boundary, by 4-byte cp.async:
// their arrive (without .noinc: it adds one to the pending count, so the
// phase waits for them) and then the one arrival.
__device__ __forceinline__ void fill_window_stage(unsigned char* stage,
                                                  uint32_t bar, const int* u,
                                                  const int* v, size_t k0,
                                                  int n, int T) {
  const uint32_t du = smem_addr(stage), dv = du + 4 * kWinGroup * T;
  const uint32_t bytes = 4u * uint32_t(n) * uint32_t(T);
  const uintptr_t a = reinterpret_cast<uintptr_t>(u + k0) |
                      reinterpret_cast<uintptr_t>(v + k0);
  if (n == kWinGroup && (a & 15) == 0) {
    mbar_expect_tx(bar, 2 * bytes);
    bulk_load(du, u + k0, bytes, bar);
    bulk_load(dv, v + k0, bytes, bar);
  } else {
    for (int i = 0; i < n * T; ++i) {
      cp_async4(du + 4 * i, u + k0 + i);
      cp_async4(dv + 4 * i, v + k0 + i);
    }
    asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(bar)
                 : "memory");
    mbar_arrive(bar);
  }
}

// Zeros of a dead stage's counters: its n * T slots from slot k0 of the
// row are contiguous, so the block clears them by 16-byte stores, the lanes
// on consecutive units; a stage that does not start and end on a 16-byte
// boundary is cleared slot by slot.
template <typename C>
__device__ __forceinline__ void zero_stage(C* mr, C* cr, size_t k0, int n,
                                           int T, int l) {
  const size_t bytes = size_t(n) * T * sizeof(C);
  const uintptr_t a = reinterpret_cast<uintptr_t>(mr + k0) |
                      reinterpret_cast<uintptr_t>(cr + k0) | bytes;
  if ((a & 15) == 0) {
    uint4* const pm = reinterpret_cast<uint4*>(mr + k0);
    uint4* const pc = reinterpret_cast<uint4*>(cr + k0);
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int i = l; i < int(bytes / 16); i += T) {
      pm[i] = zero;
      pc[i] = zero;
    }
  } else {
    for (int j = 0; j < n; ++j) {
      mr[k0 + size_t(j) * T + l] = C(0);
      cr[k0 + size_t(j) * T + l] = C(0);
    }
  }
}

// thread 0's cycle profile: a reduction into device memory (no register
// array stays live across the tiles, and rows add up)
__device__ __forceinline__ void profile_add(unsigned long long* profile,
                                            int field, long long cycles) {
  atomicAdd(profile + field, static_cast<unsigned long long>(cycles));
}

// Replaces src/repro/kernels/skipper_match/kernel.py::skipper_pipeline_kernel
// (:158) and, launched with one row, skipper_window_kernel (:121), as
// skipper_window_tier_kernel did, with the same tile arithmetic and the same
// result bit for bit: one block per schedule row, T threads, the row's state
// in dynamic shared memory, the row's tiles walked in order.
// Bound on this card: ~10 bytes a slot, but the limit is the chain of tiles
// inside one block (at full scale one row: one SM walks the whole tier), and
// in the first kernel every tile paid on that chain a device-memory load of
// its ids, two CTA barriers and, with a free lane, the lane-by-lane blocked
// scan. Here:
//   * the ids come ahead of use: lane 0 fills a ring of `stages` stages of
//     kWinGroup tiles (fill_window_stage) with bulk copies completing on
//     each stage's "full" mbarrier, and refills a stage with the group
//     `stages` ahead once every lane is done with it: in a dead stage right
//     after the stage's one barrier (every lane's reads of the stage
//     precede it), in a live one after the walk and one more barrier. The
//     CTA barriers are the stages' release, so no "empty" mbarriers;
//   * dead stages pass with one barrier: before it walks a stage, every
//     lane tests its slots against the state as it is now, and one
//     __syncthreads_or says whether any slot of the stage is free. This is
//     exact. State is monotone (a commit turns ACC into MCHD; nothing turns
//     MCHD back), so a slot that is not free now is not free at its own
//     tile, and a tile with no free lane stops in match_tile's round 0 with
//     matched = 0, conflicts = 0 and no state write, for every
//     vector_rounds and with fallback on or off. A dead stage only writes
//     its counters' zeros, by 16-byte stores (zero_stage): every counter is
//     then written once, by the kernel (the wrapper allocates with
//     torch.empty as the other wrappers do), and no store is on a
//     dependence chain. In a live stage warp reductions of the lanes' tile
//     bits, through shared memory and one more barrier, say which tiles
//     hold a free slot; the others get zeros slot by slot, and the rest
//     are walked one by one through match_tile, exactly as before;
//   * the blocked test scans only the free lanes before a lane
//     (blocked_by_free_list), as the asynchronous global tier does;
//   * the state row comes in by a bulk copy completing on an mbarrier and
//     leaves by a bulk store (after fence.proxy.async: its cells were last
//     written by generic stores), so a row is a whole number of 16-byte
//     units at 16-byte aligned addresses (kernel.py's window_instance).
// It takes up to kMaxTile threads, so at most 64 registers a thread.
// profile (null unless asked for): thread 0's clock64 cycles over the stage
// loop, added into device memory over the stages and the rows, in the
// order of kernel.py's WINDOW_PROFILE_FIELDS (the wrapper fills
// counters_release_refill, the rest of the loop, from the total).
template <typename S, typename C>
__global__ void __launch_bounds__(kMaxTile)
    skipper_window_async_kernel(
        const int* __restrict__ u, const int* __restrict__ v,
        const S* __restrict__ state_in, S* __restrict__ state_out,
        C* __restrict__ matched, C* __restrict__ conflicts, int window,
        int tiles_per_row, int vector_rounds, int fallback, int stages,
        unsigned long long* __restrict__ profile) {
  __shared__ __align__(8) uint64_t full_bar[kWinMaxStages];
  __shared__ __align__(8) uint64_t row_bar;
  __shared__ unsigned char frs[kMaxTile];
  __shared__ int warp_counts[32];
  __shared__ int free_u[kMaxTile];
  __shared__ int free_v[kMaxTile];
  __shared__ unsigned tile_bits[32];
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x, l = threadIdx.x;
  const size_t row = blockIdx.x;
  const size_t row_bytes = size_t(window) * sizeof(S);
  S* const st = reinterpret_cast<S*>(smem);
  unsigned char* const ring = smem + align16(row_bytes);
  const size_t stage_bytes = win_stage_bytes(T);
  const uint32_t bar0 = smem_addr(full_bar), rbar = smem_addr(&row_bar);
  const int warps = (T + 31) / 32;
  // this lane's warp (the last one may be partial), for the warp reduction
  const int in_warp = min(T - (l & ~31), 32);
  const unsigned warp_mask =
      in_warp == 32 ? 0xffffffffu : (1u << in_warp) - 1u;
  const size_t slots = size_t(tiles_per_row) * T;
  const int* const ur = u + row * slots;
  const int* const vr = v + row * slots;
  C* const mr = matched + row * slots;
  C* const cr = conflicts + row * slots;
  const int num_groups = (tiles_per_row + kWinGroup - 1) / kWinGroup;
  if (l == 0) {
    for (int i = 0; i < stages; ++i) mbar_init(bar0 + 8 * i, 1);
    mbar_init(rbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (l == 0) {
    mbar_expect_tx(rbar, uint32_t(row_bytes));
    bulk_load(smem_addr(st), state_in + row * window, uint32_t(row_bytes),
              rbar);
    for (int g = 0; g < stages && g < num_groups; ++g)
      fill_window_stage(ring + g * stage_bytes, bar0 + 8 * g, ur, vr,
                        size_t(g) * kWinGroup * T,
                        min(kWinGroup, tiles_per_row - g * kWinGroup), T);
  }
  mbar_wait(rbar, 0);  // the state row has arrived
  const RowCell<S> cell{st};
  const FreeList free_list{warp_counts, free_u, free_v};
  const bool timed = profile != nullptr && l == 0;
  int si = 0;             // the group's ring stage: g % stages
  uint32_t phase = 0;     // and its use's parity: (g / stages) & 1
  for (int g = 0; g < num_groups; ++g) {
    const long long c0 = timed ? clock64() : 0;
    const int n = min(kWinGroup, tiles_per_row - g * kWinGroup);
    const size_t k0 = size_t(g) * kWinGroup * T;
    // a completed phase: the stage's ids arrived long before, as a rule
    mbar_wait(bar0 + 8 * si, phase);
    const long long c1 = timed ? clock64() : 0;
    const int* const su = reinterpret_cast<const int*>(ring + si * stage_bytes);
    const int* const sv = su + kWinGroup * T;
    // the dead test: this lane's slots against the state as it is now, all
    // loads issued before any is used
    int a[kWinGroup], b[kWinGroup];
#pragma unroll
    for (int j = 0; j < kWinGroup; ++j) {
      a[j] = j < n ? su[j * T + l] : -1;
      b[j] = j < n ? sv[j * T + l] : -1;
    }
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < kWinGroup; ++j) {
      const bool ok = (a[j] >= 0) & (a[j] != b[j]);
      const bool acc = (st[ok ? a[j] : 0] == 0) & (st[ok ? b[j] : 0] == 0);
      bits |= unsigned(ok & acc) << j;
    }
    // barrier: every lane's reads of the stage precede the refill, and
    // every lane's state reads precede any commit of this stage's tiles
    const bool live = __syncthreads_or(bits != 0);
    const long long c2 = timed ? clock64() : 0;
    const int next = g + stages;  // the group that refills this stage
    if (!live) {
      if (l == 0 && next < num_groups) {
        fill_window_stage(ring + si * stage_bytes, bar0 + 8 * si, ur, vr,
                          size_t(next) * kWinGroup * T,
                          min(kWinGroup, tiles_per_row - next * kWinGroup), T);
        if (timed) profile_add(profile, 5, clock64() - c2);
      }
      zero_stage(mr, cr, k0, n, T, l);
      if (timed) profile_add(profile, 6, 1);
    } else {
      const unsigned wbits = __reduce_or_sync(warp_mask, bits);
      if ((l & 31) == 0) tile_bits[l >> 5] = wbits;
      __syncthreads();  // every warp's bits are visible
      unsigned tiles = 0;  // the stage's tiles that hold a free slot
      for (int w = 0; w < warps; ++w) tiles |= tile_bits[w];
      if (timed) profile_add(profile, 2, clock64() - c2);
#pragma unroll 1
      for (int j = 0; j < n; ++j) {
        const size_t k = k0 + size_t(j) * T + l;
        if (!((tiles >> j) & 1u)) {  // a dead tile
          mr[k] = C(0);
          cr[k] = C(0);
          continue;
        }
        bool m;
        int c;
        const long long b0 = timed ? clock64() : 0;
        const int rounds = match_tile<S, RowCell<S>, true>(
            su[j * T + l], sv[j * T + l], nullptr, nullptr, frs, cell,
            vector_rounds, fallback != 0, m, c, free_list);
        if (timed) {
          const long long body = clock64() - b0;
          profile_add(profile, 3, body);
          profile_add(profile, 7, 1);
          if (rounds > 0) {  // tiles in which some lane was free
            profile_add(profile, 8, 1);
            profile_add(profile, 9, body);
          }
        }
        mr[k] = C(m);
        cr[k] = C(c);
      }
      __syncthreads();  // every lane's reads of the stage precede the refill
      if (l == 0 && next < num_groups) {
        const long long r0 = timed ? clock64() : 0;
        fill_window_stage(ring + si * stage_bytes, bar0 + 8 * si, ur, vr,
                          size_t(next) * kWinGroup * T,
                          min(kWinGroup, tiles_per_row - next * kWinGroup), T);
        if (timed) profile_add(profile, 5, clock64() - r0);
      }
    }
    if (++si == stages) {
      si = 0;
      phase ^= 1;
    }
    if (timed) {
      profile_add(profile, 0, c1 - c0);
      profile_add(profile, 1, c2 - c1);
      profile_add(profile, 10, clock64() - c0);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();  // every lane's state writes precede the store
  if (l == 0) {
    bulk_store(state_out + row * window, smem_addr(st), uint32_t(row_bytes));
    bulk_wait_all();
  }
}

template <typename S, typename C>
int launch_window_tier(const int* u, const int* v, const void* state_in,
                       void* state_out, void* matched, void* conflicts,
                       int num_rows, int tiles_per_row, int tile_size,
                       int window, int vector_rounds, int fallback,
                       int smem_bytes, void* stream) {
  if (size_t(smem_bytes) < window_tier_smem<S>(window, tile_size))
    return int(cudaErrorInvalidValue);
  auto kernel = skipper_window_tier_kernel<S, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return int(err);
  kernel<<<num_rows, tile_size, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      u, v, static_cast<const S*>(state_in), static_cast<S*>(state_out),
      static_cast<C*>(matched), static_cast<C*>(conflicts), window,
      tiles_per_row, vector_rounds, fallback);
  return int(cudaGetLastError());
}

template <typename S, typename C>
int launch_window_async(const int* u, const int* v, const void* state_in,
                        void* state_out, void* matched, void* conflicts,
                        int num_rows, int tiles_per_row, int tile_size,
                        int window, int vector_rounds, int fallback,
                        int stages, int smem_bytes, void* profile,
                        void* stream) {
  if (stages < 1 || stages > kWinMaxStages ||
      size_t(smem_bytes) < window_async_smem<S>(window, tile_size, stages))
    return int(cudaErrorInvalidValue);
  // bulk copies move whole 16-byte units between 16-byte aligned addresses
  if (((size_t(window) * sizeof(S)) |
       reinterpret_cast<uintptr_t>(state_in) |
       reinterpret_cast<uintptr_t>(state_out)) % 16 != 0)
    return int(cudaErrorInvalidValue);
  auto kernel = skipper_window_async_kernel<S, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return int(err);
  kernel<<<num_rows, tile_size, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      u, v, static_cast<const S*>(state_in), static_cast<S*>(state_out),
      static_cast<C*>(matched), static_cast<C*>(conflicts), window,
      tiles_per_row, vector_rounds, fallback, stages,
      static_cast<unsigned long long*>(profile));
  return int(cudaGetLastError());
}

template <typename S, typename C>
int launch_boundary(const int* blk_u, const int* blk_v, const int* u,
                    const int* v, void* state, void* matched, void* conflicts,
                    int num_tiles, int tile_size, int window,
                    int vector_rounds, int fallback, void* stream) {
  skipper_boundary_kernel<S, C>
      <<<1, tile_size, size_t(tile_size) * 9, static_cast<cudaStream_t>(stream)>>>(
          blk_u, blk_v, u, v, static_cast<S*>(state), static_cast<C*>(matched),
          static_cast<C*>(conflicts), window, num_tiles, vector_rounds,
          fallback);
  return int(cudaGetLastError());
}

template <typename S, typename C>
int launch_boundary_async(const int* blk_u, const int* blk_v, const int* u,
                          const int* v, void* state, void* matched,
                          void* conflicts, int num_tiles, int tile_size,
                          int window, int vector_rounds, int fallback,
                          int staged, int smem_bytes, void* profile,
                          void* stream) {
  if (size_t(smem_bytes) < boundary_async_smem<S>(window, tile_size, staged))
    return int(cudaErrorInvalidValue);
  if (tile_size > kMaxAsyncBoundaryTile) return int(cudaErrorInvalidValue);
  if (staged && (size_t(window) * sizeof(S)) % 16 != 0)
    return int(cudaErrorInvalidValue);  // bulk copies move 16-byte units
  auto kernel = staged ? skipper_boundary_async_kernel<S, C, true>
                       : skipper_boundary_async_kernel<S, C, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return int(err);
  kernel<<<1, tile_size, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      blk_u, blk_v, u, v, static_cast<S*>(state), static_cast<C*>(matched),
      static_cast<C*>(conflicts), window, num_tiles, vector_rounds, fallback,
      static_cast<unsigned long long*>(profile));
  return int(cudaGetLastError());
}

}  // namespace

// C entry points, one per (state width, counter width). Each returns the
// launch's cudaError_t (0 = success).
#define SKIPPER_ENTRY_POINTS(SN, S, CN, C)                                     \
  extern "C" int skipper_window_tier_##SN##_##CN(                              \
      const int* u, const int* v, const void* state_in, void* state_out,       \
      void* matched, void* conflicts, int num_rows, int tiles_per_row,         \
      int tile_size, int window, int vector_rounds, int fallback,              \
      int smem_bytes, void* stream) {                                          \
    return launch_window_tier<S, C>(u, v, state_in, state_out, matched,        \
                                    conflicts, num_rows, tiles_per_row,        \
                                    tile_size, window, vector_rounds,          \
                                    fallback, smem_bytes, stream);             \
  }                                                                            \
  extern "C" int skipper_window_async_##SN##_##CN(                             \
      const int* u, const int* v, const void* state_in, void* state_out,       \
      void* matched, void* conflicts, int num_rows, int tiles_per_row,         \
      int tile_size, int window, int vector_rounds, int fallback, int stages,  \
      int smem_bytes, void* profile, void* stream) {                           \
    return launch_window_async<S, C>(u, v, state_in, state_out, matched,       \
                                     conflicts, num_rows, tiles_per_row,       \
                                     tile_size, window, vector_rounds,         \
                                     fallback, stages, smem_bytes, profile,    \
                                     stream);                                  \
  }                                                                            \
  extern "C" int skipper_boundary_##SN##_##CN(                                 \
      const int* blk_u, const int* blk_v, const int* u, const int* v,          \
      void* state, void* matched, void* conflicts, int num_tiles,              \
      int tile_size, int window, int vector_rounds, int fallback,              \
      void* stream) {                                                          \
    return launch_boundary<S, C>(blk_u, blk_v, u, v, state, matched,           \
                                 conflicts, num_tiles, tile_size, window,      \
                                 vector_rounds, fallback, stream);             \
  }                                                                            \
  extern "C" int skipper_boundary_async_##SN##_##CN(                           \
      const int* blk_u, const int* blk_v, const int* u, const int* v,          \
      void* state, void* matched, void* conflicts, int num_tiles,              \
      int tile_size, int window, int vector_rounds, int fallback, int staged,  \
      int smem_bytes, void* profile, void* stream) {                           \
    return launch_boundary_async<S, C>(blk_u, blk_v, u, v, state, matched,     \
                                       conflicts, num_tiles, tile_size,        \
                                       window, vector_rounds, fallback,        \
                                       staged, smem_bytes, profile, stream);   \
  }

SKIPPER_ENTRY_POINTS(uint8, uint8_t, uint8, uint8_t)
SKIPPER_ENTRY_POINTS(uint8, uint8_t, int32, int32_t)
SKIPPER_ENTRY_POINTS(int32, int32_t, uint8, uint8_t)
SKIPPER_ENTRY_POINTS(int32, int32_t, int32, int32_t)

extern "C" const char* skipper_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
