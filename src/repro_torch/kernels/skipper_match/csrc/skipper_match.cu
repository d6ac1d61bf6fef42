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
// (two barriers inside). A free lane's place in the list goes to `rank`
// where the caller asks for it. kWarpSum adds the earlier warps' counts
// across the warp's lanes, not one after the other in each lane: the
// device-memory instance's tile waits on it (a chain of up to 27 loads
// and adds in the last warps), so only that instance takes it.
template <bool kWarpSum = false>
__device__ __forceinline__ bool blocked_by_free_list(bool fr, int uu, int vv,
                                                     FreeList fl,
                                                     int* rank_out = nullptr) {
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
  if constexpr (kWarpSum) {
    // a last warp may have fewer lanes than there are warps before it
    int before = 0;
    for (int w = lane; w < warp; w += in_warp) before += counts[w];
    rank += __reduce_add_sync(mask, before);
  } else {
    for (int w = 0; w < warp; ++w) rank += counts[w];
  }
  if (rank_out != nullptr) *rank_out = rank;
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
// the device-memory instance reads a tile's state cells this many tiles
// ahead, and keeps the commits of that many tiles, and its own, in shared
// memory (two ahead, its u cells two tiles and its v cells one tile ahead,
// ran slower on the raw stream at scale 22: PERF.md section 6)
constexpr int kPrefetch = 1;
constexpr int kCommitLists = kPrefetch + 1;
// the slots of the commit lists' filter (CommitLists): 2^13
constexpr int kFilterSlots = 8192;
// counters of the asynchronous global tier's optional cycle profile: the
// first kSpanFields in both instances, then the device instance's own two
constexpr int kSpanFields = 8;
constexpr int kProfileFields = kSpanFields + 2;
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

// a cycle profile's counter: a reduction into device memory (no register
// array stays live across the tiles, and rows add up)
__device__ __forceinline__ void profile_add(unsigned long long* profile,
                                            int field, long long cycles) {
  atomicAdd(profile + field, static_cast<unsigned long long>(cycles));
}

// One state cell, read from L2 (ld.global.cg) where the call stands: the
// device-memory instance issues it a tile ahead of use, while other lanes
// may be committing that cell. Either value is sound: MCHD is final, and
// an ACC is checked against the commit list before it counts.
__device__ __forceinline__ int load_cell(const uint8_t* p) {
  unsigned int x;
  asm volatile("ld.global.cg.u8 %0, [%1];" : "=r"(x) : "l"(p) : "memory");
  return int(x);
}

__device__ __forceinline__ int load_cell(const int32_t* p) {
  int x;
  asm volatile("ld.global.cg.s32 %0, [%1];" : "=r"(x) : "l"(p) : "memory");
  return x;
}

// the state cell of offset-local id `id` in the pair whose rows start at
// cells ru and rv (PairCell's rule, as a flat index)
__device__ __forceinline__ size_t pair_cell(int id, size_t ru, size_t rv,
                                            int window) {
  return id < window ? ru + id : rv + (id - window);
}

// The device-memory instance's commit lists, one a tile in flight: list q
// holds, an entry a lane free in its tile's round 0, the pair of flat state
// cells that lane committed (none where it did not), count[q] entries; and
// one filter for all tiles, kFilterSlots byte tags: each committed cell
// writes its tile's low byte into the slots of its two hashes. A lane
// whose cells' slots do not all hold the list's tile skips the list: an
// exact scan costs a shared-memory load an entry, and a tile waits for its
// slowest warp, so a scan in any warp (a list holds up to one entry a
// lane: about 300 in the raw uniform stream's first tiles) would set the
// tile's time. A tag written 256 tiles before, or by another cell, only
// costs a scan; the filter is never cleared, and needs no atomic.
struct CommitLists {
  ulonglong2* entries;  // [kCommitLists][T]
  int* count;           // [kCommitLists]
  unsigned char* tags;  // [kFilterSlots]

  __device__ static unsigned hash(size_t c, unsigned k) {
    return ((unsigned(c) ^ unsigned(c >> 32)) * k) >> 19;  // kFilterSlots
  }
  // whether the filter may hold cell cu or cv for tile t: its four slots
  // are read side by side, not one after the other
  __device__ bool filter(int t, size_t cu, size_t cv) const {
    const unsigned want = static_cast<unsigned char>(t);
    const unsigned a = tags[hash(cu, 0x9E3779B1u)];
    const unsigned b = tags[hash(cu, 0x85EBCA77u)];
    const unsigned c = tags[hash(cv, 0x9E3779B1u)];
    const unsigned d = tags[hash(cv, 0x85EBCA77u)];
    return ((a == want) & (b == want)) | ((c == want) & (d == want));
  }
  // whether tile t's list holds cell cu or cv
  __device__ bool holds(int t, size_t cu, size_t cv) const {
    if (!filter(t, cu, cv)) return false;
    const int q = t % kCommitLists;
    const ulonglong2* e = entries + size_t(q) * blockDim.x;
    const int n = count[q];
    bool hit = false;
#pragma unroll 4
    for (int i = 0; i < n; ++i)
      hit |= e[i].x == cu || e[i].x == cv || e[i].y == cu || e[i].y == cv;
    return hit;
  }
  __device__ void add(int t, int entry, size_t cu, size_t cv) const {
    entries[size_t(t % kCommitLists) * blockDim.x + entry] =
        make_ulonglong2(cu, cv);
    const unsigned char tag = static_cast<unsigned char>(t);
    tags[hash(cu, 0x9E3779B1u)] = tag;
    tags[hash(cu, 0x85EBCA77u)] = tag;
    tags[hash(cv, 0x9E3779B1u)] = tag;
    tags[hash(cv, 0x85EBCA77u)] = tag;
  }
};

// One ring stage holds kGroup consecutive tiles:
// [blk_u: kGroup ints][blk_v: kGroup ints][u: kGroup * T ints][v: the same].
// Consecutive tiles' ids and pairs are contiguous in device memory, so a
// whole group arrives by four bulk copies.
__host__ __device__ inline size_t ring_stage_bytes(int tile) {
  return 8 * kGroup + 8 * size_t(kGroup) * tile;
}

// The device-memory instance's commit lists (CommitLists): kCommitLists
// lists of up to tile entries (16 bytes each), then their counts, padded
// to 16 bytes. The filter's tags are a static array of that instance.
static_assert(kPrefetch == 1 && kCommitLists <= 4, "the read-ahead depth");
__host__ __device__ inline size_t commit_lists_bytes(int tile) {
  return kCommitLists * 16 * size_t(tile) + 16;
}

// Dynamic shared memory of the asynchronous global tier:
// [two state rows: 2 * window * sizeof(S), staged instance; the commit
// lists, device instance][ring: kRing stages]. The free flags, the warp
// counts and the free lists are static arrays of the kernel, sized for
// kMaxTile.
template <typename S>
__host__ __device__ inline size_t boundary_async_smem(int window, int tile,
                                                      bool staged) {
  return (staged ? 2 * size_t(window) * sizeof(S) : commit_lists_bytes(tile)) +
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

// Device-memory instance: this lane's slot of tile s, once the ring stage
// that holds the tile has arrived (long before, as a rule): whether it is
// valid, and its two cells' flat indices (a padding slot's are the row's
// first cell).
__device__ __forceinline__ bool slot_cells(const unsigned char* ring,
                                           size_t stage_bytes, uint32_t bar0,
                                           int window, int s, size_t& cu,
                                           size_t& cv) {
  const int T = blockDim.x, l = threadIdx.x;
  const int g = s / kGroup, i = s % kGroup, st = g % kRing;
  mbar_wait(bar0 + 8 * st, (g / kRing) & 1);
  const int* grp = reinterpret_cast<const int*>(ring + st * stage_bytes);
  const int uu = grp[2 * kGroup + i * T + l];
  const int vv = grp[2 * kGroup + (kGroup + i) * T + l];
  const size_t ru = size_t(grp[i]) * window;
  const size_t rv = size_t(grp[kGroup + i]) * window;
  cu = pair_cell(max(uu, 0), ru, rv, window);
  cv = pair_cell(max(vv, 0), ru, rv, window);
  return uu >= 0 && uu != vv;
}

// Whether this lane is free at round 0 of tile t, from its reading ahead
// (`acc`: both cells read ACC) and the list of the tile in between.
__device__ __forceinline__ bool free_at_round0(bool acc, int uu, int vv,
                                               size_t cu, size_t cv, int t,
                                               CommitLists lists,
                                               unsigned long long* profile) {
  const bool read_free = acc && uu >= 0 && uu != vv;
  if (read_free && t >= 1 && lists.holds(t - 1, cu, cv)) {
    if (profile != nullptr) profile_add(profile, kSpanFields, 1);  // stale
    return false;
  }
  return read_free;
}

// Device-memory instance: tile t's body, with match_tile's rounds and
// result, and no state read of its own. A lane's two cells were read
// kPrefetch tiles ahead, after every tile before those in between had
// committed; the commit lists hold the commits of those tiles as flat
// state cells (never tile-local ids: consecutive tiles may be other block
// pairs).
//   * round 0: an ACC/ACC lane is free unless an in-between tile committed
//     one of its cells (free_at_round0, `cand`: a stale lane otherwise; an
//     MCHD read is final, state being monotone). Then match_tile's blocked
//     test, conflicts and commits. Each free lane takes the entry of this
//     tile's list at its place in the free list, and a commit fills it and
//     tags the filter; warp 0 writes the count from the warp counts. No
//     atomic.
//   * one barrier ends a round, __syncthreads_or(blocked): a lane can be
//     free in round r + 1 only if it was blocked in round r, so a tile with
//     no blocked lane ends there. In a later round only the lanes blocked
//     in the round before take part, each free unless this tile's list
//     holds one of its cells: the state as match_tile would read it. Such
//     a lane was free in round 0, so its commit fills its entry there.
// Returns, in warp 0, the rounds with a free lane (match_tile's count),
// and in every lane whether a round after round 0 ran (`later`).
template <typename S>
__device__ __forceinline__ int prefetched_tile(
    int uu, int vv, bool cand, size_t cu, size_t cv, S* state, int t,
    CommitLists lists, FreeList free_list, int vector_rounds, bool fallback,
    bool& matched, int& conflicts, bool& later) {
  const int T = blockDim.x, l = threadIdx.x;
  const int own = t % kCommitLists;
  matched = false;
  conflicts = 0;
  later = false;
  int rounds = 0, entry = 0;
  for (int r = 0;; ++r) {
    if (!fallback && r >= vector_rounds) break;  // uniform over the block
    later = r > 0;
    const bool fr = cand && (r == 0 || !lists.holds(t, cu, cv));
    int rank;
    const bool blocked =
        blocked_by_free_list<true>(fr, uu, vv, free_list, &rank);
    if (blocked && r < vector_rounds) ++conflicts;
    if (r == 0) entry = rank;
    if (fr && !blocked) {  // committed edges are endpoint-disjoint
      state[cu] = S(kMatched);
      state[cv] = S(kMatched);
      matched = true;
      lists.add(t, entry, cu, cv);
    } else if (r == 0 && fr) {
      lists.entries[size_t(own) * T + entry] = make_ulonglong2(~0ull, ~0ull);
    }
    if (l < 32) {  // warp 0: the round's free lanes, from the warp counts
      const unsigned mask = T >= 32 ? 0xffffffffu : (1u << T) - 1u;
      const int n = __reduce_add_sync(
          mask, l < (T + 31) / 32 ? free_list.counts[l] : 0);
      if (r == 0 && l == 0) lists.count[own] = n;
      rounds += n > 0;
    }
    cand = blocked;
    // barrier: the round's commits, entries, tags and count precede the
    // next round's checks and the next tile's, and every read of the warp
    // counts precedes their next writes
    if (!__syncthreads_or(blocked)) break;
  }
  return rounds;
}

// The staged and device-memory instances of skipper_boundary_async_kernel
// (below). Replaces src/repro/kernels/skipper_match/kernel.py::
// skipper_boundary_kernel (:196), as skipper_boundary_kernel did, with the
// same tile arithmetic and the same result bit for bit: ONE block walks the
// global-tier tiles in schedule order. The tiles' endpoint-sharing chains
// leave little parallelism across blocks (a host replay of the full-scale
// RMAT schedule: critical path 146,921 of 158,396 tiles by block pair,
// 144,864 by exact vertex, 1.08x and 1.09x), and the result must equal the
// serial order; the filtered instance (further down) parallelises what
// sharing a vertex does not order: the lanes the state already kills.
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
//     does; the ring still feeds the ids, and the tile body is
//     prefetched_tile, not match_tile: while tile t runs (after tile t - 1's
//     last barrier, and after its own check) each lane reads its two cells
//     of tile t + 1. So a tile waits on no state read, checks an ACC/ACC
//     reading against the commit list of the tile in between (through a
//     Bloom filter: a scan would set the tile's time), and takes later
//     rounds from its own commits. At the raw stream's scale 22 a tile of
//     match_tile waited on 3-4 chained L2 reads (both cells, and again in
//     the round after any round with a free lane).
// profile (null unless asked for; the wrapper zeroes it): thread 0's
// clock64 cycles over the tile loop, summed over the tiles, into
// kSpanFields counters, then the device instance's stale lanes and tiles
// with a later round (the order of kernel.py's PROFILE_FIELDS).
template <typename S, typename C, bool kStaged>
__device__ __forceinline__ void boundary_async_body(
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
  unsigned char* const ring =
      smem + (kStaged ? 2 * row_bytes : commit_lists_bytes(T));
  // device instance: the commit lists
  // device instance: the commit lists, and the filter's tags (a static
  // array of that instance alone)
  unsigned char* tags = nullptr;
  if constexpr (!kStaged) {
    __shared__ unsigned char filter_tags[kFilterSlots];
    tags = filter_tags;
  }
  const CommitLists lists{
      reinterpret_cast<ulonglong2*>(smem),
      reinterpret_cast<int*>(smem + kCommitLists * 16 * size_t(T)), tags};
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
  if constexpr (!kStaged) {
    for (int i = l; i < kCommitLists; i += T) lists.count[i] = 0;
    for (int i = l; i < kFilterSlots; i += T) tags[i] = 0xFF;  // no tile
  }
  __syncthreads();
  const int num_groups = (num_tiles + kGroup - 1) / kGroup;
  if (l == 0)
    for (int g = 0; g < kRing && g < num_groups; ++g)
      fill_group(ring + g * stage_bytes, bar0 + 8 * g, blk_u, blk_v, u, v, g,
                 num_tiles, T);
  // device instance: this lane's u and v cells of the tile to run, as read
  // ahead. Each register takes a new load only once its value has been
  // used, so no copy waits on a load in flight.
  int ua = kMatched, va = kMatched;
  if constexpr (!kStaged) {
    size_t cu, cv;
    if (slot_cells(ring, stage_bytes, bar0, window, 0, cu, cv)) {
      ua = load_cell(state + cu);
      va = load_cell(state + cv);
    }
  }
  int res0 = -1, res1 = -1;  // block held by each state slot (staged)
  uint32_t row_phase = 0;
  const bool timed = profile != nullptr && l == 0;
  unsigned long long spans[kSpanFields] = {};  // staged instance
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
    const size_t k = size_t(t) * T + l;
    bool m, later = false;
    int c, rounds;
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
      S* const row_u = reinterpret_cast<S*>(smem + su * row_bytes);
      S* const row_v = reinterpret_cast<S*>(smem + sv * row_bytes);
      if (timed) c2 = clock64();
      rounds = match_tile<S, PairCell<S>, true>(
          uu, vv, tu, tv, frs, PairCell<S>{row_u, row_v, window},
          vector_rounds, fallback != 0, m, c,
          FreeList{warp_counts, free_u, free_v});
    } else {
      // tile t's cells, read ahead, are checked against the list first,
      // whose shared-memory reads would otherwise queue behind the
      // scattered loads; then tile t + 1's cells are read
      const size_t cu = pair_cell(max(uu, 0), size_t(bu) * window,
                                  size_t(bv) * window, window);
      const size_t cv = pair_cell(max(vv, 0), size_t(bu) * window,
                                  size_t(bv) * window, window);
      const bool cand = free_at_round0(ua == 0 && va == 0, uu, vv, cu, cv, t,
                                       lists, profile);
      size_t cu1, cv1;
      if (t + 1 < num_tiles &&
          slot_cells(ring, stage_bytes, bar0, window, t + 1, cu1, cv1)) {
        ua = load_cell(state + cu1);
        va = load_cell(state + cv1);
      }
      if (timed) c2 = clock64();
      rounds = prefetched_tile<S>(
          uu, vv, cand, cu, cv, state, t, lists,
          FreeList{warp_counts, free_u, free_v}, vector_rounds, fallback != 0,
          m, c, later);
    }
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
      if constexpr (kStaged) {
        spans[0] += c1 - c0;  // the stage's barrier, the pair and ids
        spans[1] += c2 - c1;  // the state rows
        spans[2] += c3 - c2;  // the tile body
        spans[3] += c4 - c3;  // counters, release, refill
        if (rounds > 0) {     // tiles in which some lane was free
          spans[4] += 1;
          spans[5] += c3 - c2;
          spans[6] += rounds;
        }
        spans[7] += c4 - c0;
      } else {  // into device memory a tile: its registers are near the cap
        profile_add(profile, 0, c1 - c0);
        profile_add(profile, 1, c2 - c1);  // the check and the read-ahead
        profile_add(profile, 2, c3 - c2);
        profile_add(profile, 3, c4 - c3);
        if (rounds > 0) {
          profile_add(profile, 4, 1);
          profile_add(profile, 5, c3 - c2);
          profile_add(profile, 6, rounds);
        }
        profile_add(profile, 7, c4 - c0);
        if (later) profile_add(profile, kSpanFields + 1, 1);
      }
    }
  }
  if constexpr (kStaged) {
    if (timed)
      for (int f = 0; f < kSpanFields; ++f) profile[f] = spans[f];
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

// ---- the filtered instance: dead lanes dropped on every SM ------------------

// The instances of skipper_boundary_async_kernel: the pair's rows in device
// memory, in shared memory, or (one state row only) the filtered pass.
constexpr int kInstanceDevice = 0;
constexpr int kInstanceStaged = 1;
constexpr int kInstanceFiltered = 2;
// its block: every block takes this many threads; the in-order block
// resolves up to one survivor a thread at a time (a pack)
constexpr int kFilteredThreads = 1024;
constexpr int kPack = kFilteredThreads;
// the ring's slots (tiles): a filter block reads tile t's cells only once
// the in-order block has resolved every tile before t - kLag + 1, so the
// ring holds kLag tiles and the filter's snapshot lags at most kLag - 1
// tiles (about eight times the H100's 132 SMs). While the in-order block
// has resolved fewer than kLag - kRampLag tiles, the lag is kRampLag plus
// those: the first tiles' lanes, read against a state with few commits,
// nearly all survive, and a shorter lag lets the first commits kill more
constexpr int kLag = 1024;
constexpr int kRampLag = 64;
// the most tiles a filter block takes at once (tiles narrower than
// kFilteredThreads / kFilteredGroup lanes leave threads idle)
constexpr int kFilteredGroup = 32;
// the in-order block's hash tables: 2^12 slots for the up to 2 * kPack
// keys of a pack
constexpr int kTableBits = 12;
constexpr int kTable = 1 << kTableBits;
// a claim: (kTopRound - round) above kRoundShift bits of pack index, so a
// later round's claims are smaller than an earlier round's, and 0 (no
// claim ever) marks a cell a pack commit took
constexpr unsigned kRoundShift = 10;
constexpr unsigned kTopRound = (1u << 21) - 1;
constexpr unsigned kNoClaim = 0xFFFFFFFFu;
constexpr unsigned long long kNoPair = ~0ull;
constexpr int kNoRound = 0x7FFFFFFF;
// a wait on another block that lasts beyond this many cycles (about forty
// seconds) traps: a fault shows as a launch error, never as a hung card
constexpr long long kSpinLimit = 1ll << 36;
// the scratch's control words (int32): the filter's ticket and the
// in-order block's progress, each on a 128-byte line of its own
constexpr int kTicketWord = 0;
constexpr int kDoneWord = 32;
constexpr int kCtrlWords = 64;
static_assert(kPack == 1 << kRoundShift, "a claim's pack index");
static_assert(kLag <= kFilteredThreads && kFilteredGroup <= kRampLag &&
                  kRampLag <= kLag,
              "the in-order block reads each ring slot's flag in one step, "
              "and the ramp admits the group of the first unresolved tile");

// The scratch (int32 words, the first filtered_ring_head() of them zeroed
// by the launch): [control][flags: kLag][counts: kLag][entries: kLag * T int2]
// [lanes: kLag * T uint16]. Slot t % kLag holds tile t's survivors, in
// lane order: their (u, v) ids and lanes, `counts` of them; its flag reads
// t + 1 once they are written.
__host__ __device__ inline size_t filtered_ring_head() {
  return kCtrlWords + 2 * size_t(kLag);
}
__host__ __device__ inline size_t filtered_scratch_words(int tile) {
  return filtered_ring_head() + 2 * size_t(kLag) * tile +
         (size_t(kLag) * tile + 1) / 2;
}

struct FilteredRing {
  int* ticket;
  int* done;
  int* flags;
  int* counts;
  int2* entries;
  unsigned short* lanes;
  int tile;
  __device__ FilteredRing(int* scratch, int T)
      : ticket(scratch + kTicketWord),
        done(scratch + kDoneWord),
        flags(scratch + kCtrlWords),
        counts(scratch + kCtrlWords + kLag),
        entries(reinterpret_cast<int2*>(scratch + filtered_ring_head())),
        lanes(reinterpret_cast<unsigned short*>(
            scratch + filtered_ring_head() + 2 * size_t(kLag) * T)),
        tile(T) {}
};

// Dynamic shared memory of the filtered instance (every block takes it;
// the filter blocks use the scan words and bases alone):
// [pair keys: kTable u64][pair claims][cell keys][cell claims][owners:
// kTable 32-bit][bases: kLag + 1][scan: 32][scalars: 4][commit rounds:
// kPack int32][shared marks: kTable bytes]
struct FilteredSmem {
  unsigned long long* pkey;  // (pack tile, cell) of the tile rounds
  unsigned* pclaim;
  int* vkey;  // cell of the pack rounds
  unsigned* vclaim;
  int* owner;     // the pack entry that took each cell
  int* base;      // a pack's first entry of each of its tiles; a filter
                  // block's first survivor of each tile of its group
  int* scan;      // block_inclusive_sum's warp totals
  int* scalars;   // [0]: a filter block's group
  int* rounds;    // the tile round in which each pack entry commits
  unsigned char* shared;  // whether two of the pack's entries hold the cell
  __device__ explicit FilteredSmem(unsigned char* p)
      : pkey(reinterpret_cast<unsigned long long*>(p)),
        pclaim(reinterpret_cast<unsigned*>(pkey + kTable)),
        vkey(reinterpret_cast<int*>(pclaim + kTable)),
        vclaim(reinterpret_cast<unsigned*>(vkey + kTable)),
        owner(reinterpret_cast<int*>(vclaim + kTable)),
        base(owner + kTable),
        scan(base + kLag + 1),
        scalars(scan + 32),
        rounds(scalars + 4),
        shared(reinterpret_cast<unsigned char*>(rounds + kPack)) {}
  // marks the cell of slot s as held by two entries: an atomic on the
  // mark's 32-bit word, as the table's inserts are
  __device__ void mark_shared(unsigned s) const {
    atomicOr(reinterpret_cast<unsigned*>(shared) + (s >> 2),
             1u << (8 * (s & 3)));
  }
};
__host__ __device__ inline size_t filtered_smem() {
  return size_t(kTable) * (8 + 4 + 4 + 4 + 4 + 1) +
         4 * size_t(kLag + 1 + 32 + 4 + kPack);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int x;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(x)
               : "l"(p)
               : "memory");
  return x;
}

__device__ __forceinline__ void st_release(int* p, int x) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(x)
               : "memory");
}

__device__ __forceinline__ void st_relaxed(int* p, int x) {
  asm volatile("st.relaxed.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(x)
               : "memory");
}

// the state cell of id `id` in the one row of `window` cells, every tile
// the pair (0, 0) (pair_cell's rule)
__device__ __forceinline__ int row_cell(int id, int window) {
  return id < window ? id : id - window;
}

// The inclusive sum of x over the block (a whole number of warps); every
// lane calls it (two barriers inside). Each warp scans the warp totals
// itself, so `scan` is written once and then only read.
__device__ __forceinline__ int block_inclusive_sum(int x, int* scan) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scan[warp] = x;
  __syncthreads();  // every warp's total is visible
  int w = lane < warps ? scan[lane] : 0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, w, o);
    if (lane >= o) w += y;
  }
  const int before = __shfl_sync(0xffffffffu, w, (warp + 31) & 31);
  if (warp > 0) x += before;
  __syncthreads();  // every read of `scan` precedes its next writes
  return x;
}

// The slot of `key` in an open-addressed table of kTable slots (linear
// probing), inserting it where it is not there yet; `seen` says whether
// another insert had put it there.
__device__ __forceinline__ unsigned table_slot(int* keys, int key,
                                               bool& seen) {
  unsigned h = (unsigned(key) * 0x9E3779B1u) >> (32 - kTableBits);
  for (;;) {
    const int prev = atomicCAS(keys + h, -1, key);
    seen = prev == key;
    if (prev == -1 || seen) return h;
    h = (h + 1) & (kTable - 1);
  }
}

__device__ __forceinline__ unsigned table_slot(unsigned long long* keys,
                                               unsigned long long key) {
  unsigned h = unsigned((key * 0x9E3779B97F4A7C15ull) >> (64 - kTableBits));
  for (;;) {
    const unsigned long long prev = atomicCAS(keys + h, kNoPair, key);
    if (prev == kNoPair || prev == key) return h;
    h = (h + 1) & (kTable - 1);
  }
}

// A filter block (every block but block 0): it takes groups of up to
// kFilteredGroup consecutive tiles in ticket order. Once the in-order block
// has resolved every tile before the group's last tile - kLag + 1 (the
// throttle: the ring's slots are free, and the snapshot lags at most kLag
// - 1 tiles; less at first, kRampLag), each lane reads its two cells
// (ld.global.cg) and writes its outputs' zeros. State is
// monotone and written only by commits, in tile order, of tiles the
// in-order block has already resolved: a lane that reads MCHD at either
// cell was not free when its tile began, so it stays unmatched with no
// conflict, blocks no lane and commits nothing, and is final here. Every
// other valid lane (ACC, or any other reading) survives: it is compacted,
// in lane order, into its tile's ring slot. Each tile then publishes its
// flag with release semantics. Padding and self-loops are settled here
// too; a survivor's outputs are written again only where they are not 0.
template <typename S, typename C>
__device__ void filter_tiles(const int* __restrict__ u,
                             const int* __restrict__ v, const S* state,
                             C* __restrict__ matched,
                             C* __restrict__ conflicts, int window,
                             int num_tiles, FilteredRing ring, FilteredSmem sm) {
  const int i = threadIdx.x, T = ring.tile;
  const int g = min(int(blockDim.x) / T, kFilteredGroup);
  const int groups = (num_tiles + g - 1) / g;
  const int j = i / T, l = i - j * T;  // this thread's tile and lane
  for (;;) {
    if (i == 0) sm.scalars[0] = atomicAdd(ring.ticket, 1);
    __syncthreads();  // the group is visible
    const int grp = sm.scalars[0];
    if (grp >= groups) break;  // uniform over the block
    const int t0 = grp * g, nt = min(g, num_tiles - t0);
    if (i == 0) {  // the throttle
      const long long c0 = clock64();
      for (;;) {
        const int d = ld_acquire(ring.done);
        if (t0 + nt - 1 < d + min(kLag, kRampLag + d)) break;
        __nanosleep(128);
        if (clock64() - c0 > kSpinLimit) __trap();
      }
    }
    __syncthreads();
    const bool mine = j < nt;
    const int t = t0 + j;
    const size_t k = size_t(t) * T + l;
    int uu = -1, vv = -1;
    bool surv = false;
    if (mine) {
      uu = u[k];
      vv = v[k];
      if (uu >= 0 && uu != vv)
        surv = load_cell(state + row_cell(uu, window)) != kMatched &&
               load_cell(state + row_cell(vv, window)) != kMatched;
      matched[k] = C(0);  // final unless a survivor matches or conflicts
      conflicts[k] = C(0);
    }
    const int incl = block_inclusive_sum(surv, sm.scan);
    if (mine && l == 0) sm.base[j] = incl - surv;
    __syncthreads();  // each tile's first rank is visible
    const int slot = t % kLag;
    if (surv) {
      const size_t e = size_t(slot) * T + (incl - 1 - sm.base[j]);
      ring.entries[e] = make_int2(uu, vv);
      ring.lanes[e] = static_cast<unsigned short>(l);
    }
    const bool last = mine && l == T - 1;
    if (last) ring.counts[slot] = incl - sm.base[j];
    if (surv || last) __threadfence();  // entries and count before flags
    __syncthreads();
    if (i < nt) st_release(ring.flags + (t0 + i) % kLag, t0 + i + 1);
  }
}

// The in-order block (block 0): the survivors of consecutive filtered
// tiles, up to kPack of them (a pack: one entry a thread), in (tile, lane)
// order, strictly in tile order. For each pack:
//   * every ready tile's flag is acquired and the pack is the longest run
//     of ready tiles from the first unresolved one whose survivors fit;
//   * each entry re-reads its two cells (the state after every tile
//     before the pack): an entry with a cell MCHD is not free at its
//     tile's start (as in the filter) and is final;
//   * the pack's mask: a tile's result is the sequential greedy over its
//     lanes (match_tile's rounds and fallback, engine.py), so the pack's
//     is the sequential greedy over its entries in pack order. An entry
//     none of whose cells another free entry holds (the cell table marks
//     a cell inserted twice) commits at once, and neither blocks nor is
//     blocked. First-claim rounds over the others compute the rest: an
//     entry claims its two cells (atomicMin of a round-tagged index into
//     the cell table), is dead once a commit took one (its claim returns
//     0), and commits where it holds both. A dying entry's last claim can
//     only delay a later entry by a round, and the smallest live entry
//     always commits or dies, so the mask is the greedy's however the
//     claims interleave;
//   * the conflicts: an entry is free at its tile's round 0 when no commit
//     of an earlier tile of the pack took a cell (the cells' owners), and
//     each tile then runs its vector rounds as match_tile does, its
//     blocked test among the free lanes of its own tile (claims on a table
//     of (tile, cell) pairs), a commit of round r taking its cells from
//     round r + 1 (the owners and the round each commits in). Only an
//     entry that shares a cell can be blocked; a pack without one skips
//     the rounds. Later rounds only add to the mask, which the pack's
//     rounds already hold;
//   * the outputs that are not 0 (the filter wrote the zeros before its
//     flag), the commits into the state, and the progress that lets the
//     filter blocks on. It is a relaxed store: every load of the
//     ring's slots it frees has returned, and a filter may read the state
//     at any age.
// Entries the filter dropped are not free at their tile, so they neither
// block nor commit: the result is the serial order's, bit for bit, however
// stale the filter's snapshot was. Shared memory: between two barriers the
// block only reads it, only stores to it, or only updates it with atomics
// (smem-barrier's ATOMIC_ORDERED).
template <typename S, typename C>
__device__ void resolve_in_order(S* state, C* __restrict__ matched,
                                 C* __restrict__ conflicts, int window,
                                 int num_tiles, int vector_rounds,
                                 FilteredRing ring, FilteredSmem sm,
                                 unsigned long long* survivors) {
  const int i = threadIdx.x, T = ring.tile;
  for (int s = i; s < kTable; s += blockDim.x) {
    sm.pkey[s] = kNoPair;
    sm.pclaim[s] = kNoClaim;
    sm.vkey[s] = -1;
    sm.vclaim[s] = kNoClaim;
    sm.owner[s] = -1;
    sm.shared[s] = 0;
  }
  sm.rounds[i] = kNoRound;
  __syncthreads();
  int done = 0;
  unsigned long long passed = 0;
  while (done < num_tiles) {
    // the pack: ready tiles from `done` whose survivors fit
    const int span = min(kLag, num_tiles - done);
    int c = kPack + 1;
    if (i < span) {
      const int slot = (done + i) % kLag;
      if (ld_acquire(ring.flags + slot) == done + i + 1)
        c = __ldcg(ring.counts + slot);
    }
    const int incl = block_inclusive_sum(c, sm.scan);
    const bool fits = i < span && incl <= kPack;
    const int n = __syncthreads_count(fits);
    if (n == 0) {  // tile `done` is not filtered yet
      if (i == 0) {
        const long long c0 = clock64();
        while (ld_acquire(ring.flags + done % kLag) != done + 1) {
          __nanosleep(32);
          if (clock64() - c0 > kSpinLimit) __trap();
        }
      }
      __syncthreads();
      continue;
    }
    if (fits) sm.base[i] = incl - c;
    if (i == n - 1) sm.base[n] = incl;
    __syncthreads();  // the pack's bases are visible
    const int total = sm.base[n];
    // this thread's entry: its tile j (the last with base <= i), its ids
    const bool have = i < total;
    int j = 0, b0 = 0, b1 = 0, cu = 0, cv = 0;
    size_t k = 0;
    bool fr = false;
    if (have) {
      int lo = 0, hi = n - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (sm.base[mid] <= i) lo = mid; else hi = mid - 1;
      }
      j = lo;
      b0 = sm.base[j];
      b1 = sm.base[j + 1];
      const size_t e = size_t((done + j) % kLag) * T + (i - b0);
      const int2 ids = __ldcg(ring.entries + e);
      k = size_t(done + j) * T + __ldcg(ring.lanes + e);
      cu = row_cell(ids.x, window);
      cv = row_cell(ids.y, window);
      fr = load_cell(state + cu) == 0 && load_cell(state + cv) == 0;
    }
    unsigned su = 0, sv = 0;
    __syncthreads();  // every read of the bases precedes the table's inserts
    if (fr) {
      bool seen_u, seen_v;
      su = table_slot(sm.vkey, cu, seen_u);
      sv = table_slot(sm.vkey, cv, seen_v);
      if (seen_u) sm.mark_shared(su);
      if (seen_v) sm.mark_shared(sv);
    }
    __syncthreads();  // the cell table and its marks are complete
    // the pack's mask: an entry that shares no cell commits (its cells are
    // its own: no other entry reads their slots); the others take
    // first-claim rounds, a round's commits beside the next round's claims
    const bool shared = fr && (sm.shared[su] | sm.shared[sv]);
    bool won = fr && !shared, active = shared;
    const bool any_shared = __syncthreads_or(shared);
    bool commit = false;
    for (unsigned r = 0; any_shared; ++r) {
      if (commit) {
        atomicExch(sm.vclaim + su, 0u);
        atomicExch(sm.vclaim + sv, 0u);
        atomicExch(sm.owner + su, i);
        atomicExch(sm.owner + sv, i);
        commit = false;
      }
      const unsigned key = ((kTopRound - r) << kRoundShift) | unsigned(i);
      if (active) {
        const unsigned ou = atomicMin(sm.vclaim + su, key);
        const unsigned ov = atomicMin(sm.vclaim + sv, key);
        active = ou != 0u && ov != 0u;
      }
      if (!__syncthreads_or(active)) break;
      // commits are cell-disjoint: an entry that holds both its cells
      // holds them against every claim of the round
      commit = active && sm.vclaim[su] == key && sm.vclaim[sv] == key;
      if (commit) {
        won = true;
        active = false;
      }
      __syncthreads();  // every read of the claims precedes the commits
    }
    // the conflicts: each tile's vector rounds among its own free lanes
    int conf = 0;
    unsigned pu = 0, pv = 0;
    bool paired = false;
    if (vector_rounds > 0 && any_shared) {  // uniform over the block
      bool tile_free = false;
      if (shared) {
        const int ou = sm.owner[su], ov = sm.owner[sv];
        tile_free = !(ou >= 0 && ou < b0) && !(ov >= 0 && ov < b0);
      }
      __syncthreads();  // every read of the owners precedes the pair table
      if (tile_free) {
        const unsigned long long tile_key = (unsigned long long)j << 32;
        pu = table_slot(sm.pkey, tile_key | unsigned(cu));
        pv = table_slot(sm.pkey, tile_key | unsigned(cv));
        paired = true;
      }
      for (int r = 0;; ++r) {
        const unsigned key = ((kTopRound - r) << kRoundShift) | unsigned(i);
        if (tile_free) {
          atomicMin(sm.pclaim + pu, key);
          atomicMin(sm.pclaim + pv, key);
        }
        __syncthreads();  // every claim of the round is in
        const bool blocked =
            tile_free && (sm.pclaim[pu] != key || sm.pclaim[pv] != key);
        conf += blocked;
        if (r + 1 == vector_rounds || !__syncthreads_or(blocked)) break;
        if (tile_free && !blocked) sm.rounds[i] = r;
        __syncthreads();  // the round's commits are visible
        // a blocked lane is free next round unless a commit of its own
        // tile took a cell by now
        if (blocked) {
          const int ou = sm.owner[su], ov = sm.owner[sv];
          tile_free = !(ou >= b0 && ou < b1 && sm.rounds[ou] <= r) &&
                      !(ov >= b0 && ov < b1 && sm.rounds[ov] <= r);
        } else {
          tile_free = false;
        }
        __syncthreads();  // every read of the rounds precedes the claims
      }
    }
    __syncthreads();  // every read of the tables precedes their clearing
    if (won) {  // the filter wrote the zeros, before its flag
      matched[k] = C(1);
      state[cu] = S(kMatched);
      state[cv] = S(kMatched);
    }
    if (conf > 0) conflicts[k] = C(conf);
    if (fr) {  // the tables' slots this entry used, emptied
      sm.vkey[su] = -1;
      sm.vclaim[su] = kNoClaim;
      sm.owner[su] = -1;
      sm.shared[su] = 0;
      sm.vkey[sv] = -1;
      sm.vclaim[sv] = kNoClaim;
      sm.owner[sv] = -1;
      sm.shared[sv] = 0;
    }
    if (paired) {
      sm.pkey[pu] = kNoPair;
      sm.pclaim[pu] = kNoClaim;
      sm.pkey[pv] = kNoPair;
      sm.pclaim[pv] = kNoClaim;
    }
    sm.rounds[i] = kNoRound;
    passed += total;
    done += n;
    __syncthreads();  // commits and clearing precede the next pack
    if (i == 0) st_relaxed(ring.done, done);
  }
  if (i == 0 && survivors != nullptr) atomicAdd(survivors, passed);
}

// skipper_boundary_async_kernel: kInstance picks the instance. Device
// (kInstanceDevice) and staged (kInstanceStaged): one block of T lanes,
// boundary_async_body. Filtered (kInstanceFiltered, one state row, every
// tile the pair (0, 0), the fallback on): a cooperative grid of
// kFilteredThreads-thread blocks, every block resident; block 0 is the
// in-order block (resolve_in_order), the others filter (filter_tiles).
// Neither waits on a block that may not run: the filters wait only on the
// in-order block's progress, which needs only tiles already handed out.
// `tile` is the tile width (the filtered instance's blocks are wider);
// `scratch` the filtered instance's ring and `survivors` (or null) the
// lanes it passed to its in-order block, added.
template <typename S, typename C, int kInstance>
__global__ void skipper_boundary_async_kernel(
    const int* __restrict__ blk_u, const int* __restrict__ blk_v,
    const int* __restrict__ u, const int* __restrict__ v, S* state,
    C* __restrict__ matched, C* __restrict__ conflicts, int window,
    int num_tiles, int vector_rounds, int fallback,
    unsigned long long* __restrict__ profile, int tile, int* scratch,
    unsigned long long* survivors) {
  if constexpr (kInstance == kInstanceFiltered) {
    extern __shared__ __align__(16) unsigned char smem[];
    const FilteredSmem sm(smem);
    const FilteredRing ring(scratch, tile);
    if (blockIdx.x == 0)
      resolve_in_order<S, C>(state, matched, conflicts, window, num_tiles,
                             vector_rounds, ring, sm, survivors);
    else
      filter_tiles<S, C>(u, v, state, matched, conflicts, window, num_tiles,
                         ring, sm);
  } else {
    boundary_async_body<S, C, kInstance == kInstanceStaged>(
        blk_u, blk_v, u, v, state, matched, conflicts, window, num_tiles,
        vector_rounds, fallback, profile);
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
                          int instance, int smem_bytes, void* profile,
                          void* scratch, size_t scratch_words,
                          void* survivors, void* stream) {
  if (tile_size > kMaxAsyncBoundaryTile) return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  S* const rows = static_cast<S*>(state);
  C* const m = static_cast<C*>(matched);
  C* const c = static_cast<C*>(conflicts);
  auto* const prof = static_cast<unsigned long long*>(profile);
  int* const ring = static_cast<int*>(scratch);
  auto* const surv = static_cast<unsigned long long*>(survivors);
  if (instance == kInstanceFiltered) {
    // the in-order pass resolves the greedy: the fallback is on; the
    // filters need the ring, and the cycle profile is the others'
    if (!fallback || scratch == nullptr || profile != nullptr ||
        size_t(smem_bytes) < filtered_smem() ||
        scratch_words < filtered_scratch_words(tile_size))
      return int(cudaErrorInvalidValue);
    auto kernel = skipper_boundary_async_kernel<S, C, kInstanceFiltered>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err == cudaSuccess)  // the ring's control words, flags and counts
      err = cudaMemsetAsync(scratch, 0, 4 * filtered_ring_head(), st);
    if (err != cudaSuccess) return int(err);
    int device = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kFilteredThreads, smem_bytes);
    if (err != cudaSuccess) return int(err);
    const int grid = per_sm * sms;  // every block resident: cooperative
    if (grid < 2) return int(cudaErrorCooperativeLaunchTooLarge);
    void* args[] = {&blk_u,    &blk_v,  &u,         &v,
                    (void*)&rows, (void*)&m, (void*)&c, &window,
                    &num_tiles, &vector_rounds, &fallback, (void*)&prof,
                    &tile_size, (void*)&ring, (void*)&surv};
    return int(cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(kernel), dim3(grid), dim3(kFilteredThreads),
        args, size_t(smem_bytes), st));
  }
  const bool staged = instance == kInstanceStaged;
  if (size_t(smem_bytes) < boundary_async_smem<S>(window, tile_size, staged))
    return int(cudaErrorInvalidValue);
  if (staged && (size_t(window) * sizeof(S)) % 16 != 0)
    return int(cudaErrorInvalidValue);  // bulk copies move 16-byte units
  auto kernel = staged
                    ? skipper_boundary_async_kernel<S, C, kInstanceStaged>
                    : skipper_boundary_async_kernel<S, C, kInstanceDevice>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return int(err);
  kernel<<<1, tile_size, smem_bytes, st>>>(
      blk_u, blk_v, u, v, rows, m, c, window, num_tiles, vector_rounds,
      fallback, prof, tile_size, ring, surv);
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
      int tile_size, int window, int vector_rounds, int fallback,              \
      int instance, int smem_bytes, void* profile, void* scratch,              \
      size_t scratch_words, void* survivors, void* stream) {                   \
    return launch_boundary_async<S, C>(                                        \
        blk_u, blk_v, u, v, state, matched, conflicts, num_tiles, tile_size,   \
        window, vector_rounds, fallback, instance, smem_bytes, profile,        \
        scratch, scratch_words, survivors, stream);                            \
  }

SKIPPER_ENTRY_POINTS(uint8, uint8_t, uint8, uint8_t)
SKIPPER_ENTRY_POINTS(uint8, uint8_t, int32, int32_t)
SKIPPER_ENTRY_POINTS(int32, int32_t, uint8, uint8_t)
SKIPPER_ENTRY_POINTS(int32, int32_t, int32, int32_t)

// The filtered instance's geometry, for the wrapper: its block, its ring's
// slots, its dynamic shared memory and its scratch's int32 words.
extern "C" int skipper_filtered_threads() { return kFilteredThreads; }
extern "C" int skipper_filtered_lag() { return kLag; }
extern "C" size_t skipper_filtered_smem() { return filtered_smem(); }
extern "C" size_t skipper_filtered_scratch_words(int tile) {
  return filtered_scratch_words(tile);
}

extern "C" const char* skipper_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
