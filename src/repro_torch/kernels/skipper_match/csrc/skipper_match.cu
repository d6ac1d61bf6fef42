// Hand-written Hopper (sm_90a) kernels for the single-pass matcher's two
// tiers, with a plain C interface loaded by kernel.py through ctypes.
//
// Both kernels run one tile body, match_tile(): the first-claim rounds and
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

// One tile; lane = threadIdx.x, T = blockDim.x. tu/tv hold the tile's ids
// (visible to every lane before the call), frs is T bytes of scratch.
// Every lane returns together, after a barrier that follows its last read
// of tu/tv/frs and its last state write.
template <typename S, typename Cell>
__device__ void match_tile(int uu, int vv, const int* tu, const int* tv,
                           unsigned char* frs, Cell cell, int vector_rounds,
                           bool fallback, bool& matched, int& conflicts) {
  const int l = threadIdx.x;
  const bool valid = uu >= 0 && uu != vv;
  matched = false;
  conflicts = 0;
  for (int r = 0;; ++r) {
    if (!fallback && r >= vector_rounds) break;  // uniform over the block
    bool fr = false;
    if (valid && !matched) fr = *cell(uu) == 0 && *cell(vv) == 0;
    frs[l] = fr;
    // barrier: every lane's state reads and free flag precede any write
    if (!__syncthreads_or(fr)) break;
    bool blocked = false;
    if (fr) {
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
}

// Replaces src/repro/kernels/skipper_match/kernel.py::skipper_pipeline_kernel
// (:158) and, launched with one row, skipper_window_kernel (:121).
// One block per schedule row (rows are independent windows), T threads.
// The row's W-cell state lives in dynamic shared memory for all of the
// row's tiles, which the block walks in order.
// Bound on this card: bytes are ~10 per slot (ids in, counters out), but
// what limits it today is the serial chain of tiles inside one block and
// the O(T) blocked scan per round; with one row (the full-scale schedule)
// one SM does the whole tier. This is the simple first design.
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
  extern "C" int skipper_boundary_##SN##_##CN(                                 \
      const int* blk_u, const int* blk_v, const int* u, const int* v,          \
      void* state, void* matched, void* conflicts, int num_tiles,              \
      int tile_size, int window, int vector_rounds, int fallback,              \
      void* stream) {                                                          \
    return launch_boundary<S, C>(blk_u, blk_v, u, v, state, matched,           \
                                 conflicts, num_tiles, tile_size, window,      \
                                 vector_rounds, fallback, stream);             \
  }

SKIPPER_ENTRY_POINTS(uint8, uint8_t, uint8, uint8_t)
SKIPPER_ENTRY_POINTS(uint8, uint8_t, int32, int32_t)
SKIPPER_ENTRY_POINTS(int32, int32_t, uint8, uint8_t)
SKIPPER_ENTRY_POINTS(int32, int32_t, int32, int32_t)

extern "C" const char* skipper_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
