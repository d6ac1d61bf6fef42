// The analyzer's kernel canaries: hand-written Hopper (sm_90a) copies of
// the matcher's production kernels, each with exactly one line group
// changed and marked `// MUTATION:`, behind a plain C interface loaded by
// analysis/mutations.py through ctypes.
//
// Replace src/repro/analysis/mutations.py's three Pallas mutants of the TPU
// boundary kernel (_mutant_dropped_dma_wait :42, _mutant_swapped_writeback
// :86, _mutant_dynamic_gather :132). Each keeps the reference's name and
// breaks the Hopper form of the invariant the reference's mutant broke:
//
//   dropped_dma_wait   copy of skipper_window_tier_kernel without the
//                      barrier after the state row's load: the first tile
//                      reads shared state before every lane has stored it
//                      (caught by smem-barrier; racy, so it has no plain
//                      version).
//   swapped_writeback  copy of skipper_boundary_kernel that walks the
//                      global tier from its last tile to its first (caught
//                      by tier-order; equals ref.py's boundary plain
//                      version over the reversed tile order bit for bit).
//   dynamic_gather     copy of skipper_boundary_kernel whose slot ids pass
//                      through a per-thread array indexed at run time,
//                      which ptxas places in local memory (caught by
//                      local-memory; equals the production plain version
//                      bit for bit, so only the analyzer sees it).
//
// The production source is included, so the canaries share its tile body
// (match_tile) and cells; tests/test_torch_analysis.py holds each canary's
// body to its production kernel's body outside the MUTATION group. Bound on
// this card: as the production kernels (a serial chain of tiles in one
// block); the canaries are timed only at the analyzer's canonical shape.

#include "../../kernels/skipper_match/csrc/skipper_match.cu"

namespace {

template <typename S, typename C>
__global__ void mutant_dropped_dma_wait_kernel(
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
    // MUTATION: the barrier that makes the ids and, at t == 0, the state
    // row visible is dropped.
    bool m;
    int c;
    match_tile<S>(uu, vv, tu, tv, frs, cell, vector_rounds, fallback != 0, m, c);
    matched[k] = C(m);
    conflicts[k] = C(c);
  }
  __syncthreads();
  for (int i = l; i < window; i += T) state_out[row * window + i] = st[i];
}

template <typename S, typename C>
__global__ void mutant_swapped_writeback_kernel(
    const int* __restrict__ blk_u, const int* __restrict__ blk_v,
    const int* __restrict__ u, const int* __restrict__ v, S* state,
    C* __restrict__ matched, C* __restrict__ conflicts, int window,
    int num_tiles, int vector_rounds, int fallback) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x, l = threadIdx.x;
  int* tu = reinterpret_cast<int*>(smem);
  int* tv = tu + T;
  unsigned char* frs = reinterpret_cast<unsigned char*>(tv + T);
  // MUTATION: the global tier is walked from its last tile to its first.
  for (int t = num_tiles - 1; t >= 0; --t) {
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
__global__ void mutant_dynamic_gather_kernel(
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
    // MUTATION: the slot's ids pass through a per-thread array indexed at
    // run time, which registers cannot hold, so it lives in local memory.
    int ids[64];
    for (int i = 0; i < 64; ++i) ids[i] = (i & 1) ? v[k] : u[k];
    const int uu = ids[2 * (t & 31)], vv = ids[2 * (t & 31) + 1];
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

}  // namespace

// C entry points at the default StateSpec (uint8 state, uint8 counters),
// with the production entry points' arguments. Each returns the launch's
// cudaError_t (0 = success).
extern "C" int mutant_dropped_dma_wait(
    const int* u, const int* v, const void* state_in, void* state_out,
    void* matched, void* conflicts, int num_rows, int tiles_per_row,
    int tile_size, int window, int vector_rounds, int fallback,
    int smem_bytes, void* stream) {
  if (size_t(smem_bytes) < window_tier_smem<uint8_t>(window, tile_size))
    return int(cudaErrorInvalidValue);
  auto kernel = mutant_dropped_dma_wait_kernel<uint8_t, uint8_t>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return int(err);
  kernel<<<num_rows, tile_size, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      u, v, static_cast<const uint8_t*>(state_in),
      static_cast<uint8_t*>(state_out), static_cast<uint8_t*>(matched),
      static_cast<uint8_t*>(conflicts), window, tiles_per_row, vector_rounds,
      fallback);
  return int(cudaGetLastError());
}

#define MUTANT_BOUNDARY_ENTRY(NAME)                                            \
  extern "C" int mutant_##NAME(                                                \
      const int* blk_u, const int* blk_v, const int* u, const int* v,          \
      void* state, void* matched, void* conflicts, int num_tiles,              \
      int tile_size, int window, int vector_rounds, int fallback,              \
      void* stream) {                                                          \
    mutant_##NAME##_kernel<uint8_t, uint8_t>                                   \
        <<<1, tile_size, size_t(tile_size) * 9,                                \
           static_cast<cudaStream_t>(stream)>>>(                               \
            blk_u, blk_v, u, v, static_cast<uint8_t*>(state),                  \
            static_cast<uint8_t*>(matched), static_cast<uint8_t*>(conflicts),  \
            window, num_tiles, vector_rounds, fallback);                       \
    return int(cudaGetLastError());                                            \
  }

MUTANT_BOUNDARY_ENTRY(swapped_writeback)
MUTANT_BOUNDARY_ENTRY(dynamic_gather)
