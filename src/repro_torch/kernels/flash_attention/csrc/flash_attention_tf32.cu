// Hand-written Hopper (sm_90a) flash attention on the TF32 tensor cores in
// three terms, for f32 inputs at head dim 64, 80 and 128 and for bf16 at
// head dim 80, with a plain C interface loaded by kernel.py through ctypes.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel
// (the Pallas TPU kernel; pallas_call in build_flash_attention) for those
// inputs; flash_attention_wgmma.cu keeps bf16 at D 64 and 128, and
// flash_attention.cu (the CUDA-core kernel) stays only as a yardstick. It
// computes that kernel's function: causal (or full) GQA attention with an
// optional sliding window, f32 scores f32(q) * scale . k^T, masked to the
// -1e30 sentinel, the online softmax in f32, and acc / (l > 0 ? l : 1)
// rounded once to the output dtype. The function does not depend on the kv
// chunking (flash_attention_wgmma.cu's note), so the kernel uses its own
// tile and trims its kv loop to [lo, hi) as ref.kv_range does for it.
//
// Three TF32 terms. One TF32 product keeps about 11 bits of each operand,
// too few for f32's 2e-5. Each f32 operand is split, x = hi + lo with
// hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), and a product is
// a_hi b_hi + a_hi b_lo + a_lo b_hi (the a_lo b_lo term is below f32's
// rounding). Products of TF32 values are exact in the f32 accumulator. bf16
// values are exact in TF32, so for bf16 inputs K and V have no lo and the
// kernel issues two products each for QK^T and PV instead of three.
//
// Two kernels:
//   * flash_split_tf32_kernel, the pre-pass: Q * scale, K and V (input
//     dtype) to f32 hi and lo planes. Q and K as [heads, S, Dp] rows, Dp the
//     head dim padded with zeros to a multiple of 32 floats (one 128-byte
//     swizzle atom: D = 80 becomes 96); V transposed to [heads, D, S],
//     because TF32 wgmma reads B only K-major (the transposed-B mode is for
//     16-bit types), with the keys of each group of 8 stored in the order
//     0 2 4 6 1 3 5 7 (see P below).
//   * flash_attention_tf32x3_kernel, the main kernel. One block per
//     (64 * kConsumers query rows, query head, batch):
//       - warpgroup 0, the producer: one thread issues TMA loads of the Q
//         planes and of each chunk's K and V^T planes into a ring of
//         kStages stages (128-byte swizzle, one 32-float column block a
//         box), completing on mbarriers;
//       - the consumer warpgroups, 64 query rows each: S = Q_hi K_hi^T +
//         Q_hi K_lo^T + Q_lo K_hi^T as wgmma.mma_async .tf32 on the planes
//         in shared memory; the mask and the online softmax in f32 on the
//         accumulator; P split to P_hi, P_lo in registers and PV = P_hi
//         V_hi + P_hi V_lo + P_lo V_hi with P as the register operand A,
//         into a fresh accumulator; then acc = acc * alpha + pv on the CUDA
//         cores (the plain version's order; a running sum left in the tensor
//         core drifted in flash_attention_wgmma.cu). A thread's accumulator
//         holds keys 2c and 2c + 1 of each group of 8 where the tf32 A
//         fragment wants keys c and c + 4; the pre-pass's key order in V^T
//         makes the two agree without a shuffle.
//     The shared-memory layout (Layout, below) is computed on the host and
//     passed in: the wrapper checks its size, and each plane is a region
//     of its own at a run-time offset from the aligned base.
//
// Bound on this card: the causal work is 2*B*Hq*S^2*D flops of the function
// (both products over half the square); the three terms issue three times
// that at the dense TF32 rate (494.7 TFLOP/s), far above the bytes of q, k,
// v and o. Geometry by head dim (Geometry<D>): shared memory holds the two
// Q planes and kStages stages of four K/V^T planes; a consumer thread holds
// S, the two P planes, pv and acc in registers under its setmaxnreg share.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Dp: the padded head dim; kConsumers: consumer warpgroups (64 query rows
// each); BK: keys a chunk; kStages: chunks in the ring; kProducerRegs /
// kConsumerRegs: setmaxnreg shares (0: none). D = 64: Q 64 KB and two
// stages of 64 keys (64 KB each); D = 80: Q 96 KB and two stages of 32 keys
// (44 KB each); D = 128: 64 query rows (Q 64 KB; 128 would leave no room
// for a stage) and two stages of 32 keys (64 KB each).
template <int D>
struct Geometry;
template <>
struct Geometry<64> {
  static constexpr int Dp = 64, kConsumers = 2, BK = 64, kStages = 2;
  static constexpr int kProducerRegs = 40, kConsumerRegs = 232;
};
template <>
struct Geometry<80> {
  static constexpr int Dp = 96, kConsumers = 2, BK = 32, kStages = 2;
  static constexpr int kProducerRegs = 40, kConsumerRegs = 232;
};
template <>
struct Geometry<128> {
  static constexpr int Dp = 128, kConsumers = 1, BK = 32, kStages = 2;
  static constexpr int kProducerRegs = 0, kConsumerRegs = 0;
};

template <int D>
struct Shape : Geometry<D> {
  using G = Geometry<D>;
  static constexpr int kRows = 64 * G::kConsumers;
  static constexpr int kThreads = 128 * (1 + G::kConsumers);
  static constexpr uint32_t kQBytes = uint32_t(G::Dp) * kRows * 4;  // a plane
  static constexpr uint32_t kKBytes = uint32_t(G::Dp) * G::BK * 4;  // a chunk
  static constexpr uint32_t kVBytes = uint32_t(D) * G::BK * 4;      // a chunk
};

// Byte offsets of the planes and barriers from the 1024-aligned base, and
// the dynamic shared memory a block requests (1024 of it to align the
// base). Stage s of a K or V^T plane lies s * kKBytes (kVBytes) past it.
struct Layout {
  uint32_t q_hi, q_lo, k_hi, k_lo, v_hi, v_lo;
  uint32_t q_bar, full_bar, empty_bar;
  uint32_t bytes;
};

template <int D>
__host__ __device__ constexpr Layout make_layout() {
  using S = Shape<D>;
  Layout L{};
  L.q_hi = 0;
  L.q_lo = L.q_hi + S::kQBytes;
  L.k_hi = L.q_lo + S::kQBytes;
  L.k_lo = L.k_hi + S::kStages * S::kKBytes;
  L.v_hi = L.k_lo + S::kStages * S::kKBytes;
  L.v_lo = L.v_hi + S::kStages * S::kVBytes;
  L.q_bar = L.v_lo + S::kStages * S::kVBytes;
  L.full_bar = L.q_bar + 8;
  L.empty_bar = L.full_bar + 8 * S::kStages;
  L.bytes = L.empty_bar + 8 * S::kStages + 1024;
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
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

// TMA: a {32, rows, 1} box of a 3-D f32 map at (c0, c1, c2) into shared
// memory, completing on mbarrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (each >> 4), layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) |
         (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// cvt.rna.tf32.f32: x rounded to TF32 (10 mantissa bits, to nearest, ties
// away from zero), as the bits of an f32 whose low 13 bits are zero.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// D[64 x 32] (+)= A[64 x 8] * B[8 x 32] in tf32, A and B from shared memory
// (K-major, 128-byte swizzle); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %18, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n\t}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 8] * B[8 x 64] in tf32, A and B from shared memory
// (K-major, 128-byte swizzle); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n\t}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 8] * B[8 x 64] in tf32, A from registers (four
// tf32 a thread), B from shared memory (K-major, 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n\t}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D[64 x 80] (+)= A[64 x 8] * B[8 x 80] in tf32, A from registers (four
// tf32 a thread), B from shared memory (K-major, 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_n80(float* d, const uint32_t* a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %45, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1;\n\t}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 8] * B[8 x 128] in tf32, A from registers (four
// tf32 a thread), B from shared memory (K-major, 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n\t}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}


template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int scale_d) {
  if constexpr (N == 32) wgmma_ss_n32(d, a, b, scale_d);
  else wgmma_ss_n64(d, a, b, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b, int scale_d) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, b, scale_d);
  else if constexpr (N == 80) wgmma_rs_n80(d, a, b, scale_d);
  else wgmma_rs_n128(d, a, b, scale_d);
}

__device__ inline float to_f32(float x) { return x; }
__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// ------------------------------------------------------------ pre-pass --

// The stored position of key r of a group of 8 in a V^T row: keys 0 2 4 6
// 1 3 5 7 go to positions 0..7 (position p holds key 2 (p % 4) + p / 4).
constexpr int kSplitKeys = 32;  // keys (rows) of one pre-pass block

// One block per (32 rows, plane): blockIdx.y < nq splits Q * scale into
// [nq, S, Dp] hi and lo rows, then nkv blocks split K the same way (scale
// 1), then nkv blocks split V into [nkv, D, S] hi and lo, transposed
// through shared memory. The lo planes of K and V are null for bf16 input
// (their lo is zero).
template <typename T, int D>
__global__ void __launch_bounds__(256) flash_split_tf32_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, float* __restrict__ q_hi,
    float* __restrict__ q_lo, float* __restrict__ k_hi,
    float* __restrict__ k_lo, float* __restrict__ v_hi,
    float* __restrict__ v_lo, int nq, int nkv, int seq_len,
    float sm_scale) {
  constexpr int Dp = Geometry<D>::Dp;
  __shared__ float tile_hi[D][kSplitKeys + 1];
  __shared__ float tile_lo[D][kSplitKeys + 1];
  const int s0 = blockIdx.x * kSplitKeys;
  const int plane = blockIdx.y;
  if (plane < nq + nkv) {
    const bool is_q = plane < nq;
    const int head = is_q ? plane : plane - nq;
    const T* src = (is_q ? q : k) + size_t(head) * seq_len * D;
    float* hi = (is_q ? q_hi : k_hi) + size_t(head) * seq_len * Dp;
    float* lo = (is_q ? q_lo : k_lo);
    if (lo != nullptr) lo += size_t(head) * seq_len * Dp;
    const float scale = is_q ? sm_scale : 1.f;
    for (int i = threadIdx.x; i < kSplitKeys * Dp; i += blockDim.x) {
      const int s = s0 + i / Dp, d = i % Dp;
      if (s >= seq_len) break;
      const float x = d < D ? to_f32(src[size_t(s) * D + d]) * scale : 0.f;
      const uint32_t h = to_tf32(x);
      hi[size_t(s) * Dp + d] = __uint_as_float(h);
      if (lo != nullptr)
        lo[size_t(s) * Dp + d] = __uint_as_float(to_tf32(x - __uint_as_float(h)));
    }
    return;
  }
  const int head = plane - nq - nkv;
  const T* src = v + size_t(head) * seq_len * D;
  for (int i = threadIdx.x; i < kSplitKeys * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const float x = s0 + r < seq_len ? to_f32(src[size_t(s0 + r) * D + d])
                                     : 0.f;
    const uint32_t h = to_tf32(x);
    tile_hi[d][r] = __uint_as_float(h);
    tile_lo[d][r] = __uint_as_float(to_tf32(x - __uint_as_float(h)));
  }
  __syncthreads();
  float* hi = v_hi + size_t(head) * D * seq_len;
  float* lo = v_lo == nullptr ? nullptr : v_lo + size_t(head) * D * seq_len;
  for (int i = threadIdx.x; i < kSplitKeys * D; i += blockDim.x) {
    const int d = i / kSplitKeys, p = i % kSplitKeys;
    if (s0 + p >= seq_len) continue;
    const int r = (p & ~7) + 2 * (p & 3) + ((p >> 2) & 1);
    hi[size_t(d) * seq_len + s0 + p] = tile_hi[d][r];
    if (lo != nullptr) lo[size_t(d) * seq_len + s0 + p] = tile_lo[d][r];
  }
}

// --------------------------------------------------------- main kernel --

template <int D, typename T>
__global__ void __launch_bounds__(Shape<D>::kThreads, 1)
    flash_attention_tf32x3_kernel(
        const __grid_constant__ CUtensorMap qh_map,
        const __grid_constant__ CUtensorMap ql_map,
        const __grid_constant__ CUtensorMap kh_map,
        const __grid_constant__ CUtensorMap kl_map,
        const __grid_constant__ CUtensorMap vh_map,
        const __grid_constant__ CUtensorMap vl_map, const Layout lay,
        T* __restrict__ o, int hq, int hkv, int seq_len, int causal,
        int window) {
  using S = Shape<D>;
  constexpr int Dp = S::Dp, BK = S::BK, kStages = S::kStages;
  constexpr int kRows = S::kRows;
  constexpr bool kLo = sizeof(T) == 4;  // f32 input: K and V have a lo
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_hi = base + lay.q_hi, q_lo = base + lay.q_lo;
  const uint32_t k_hi = base + lay.k_hi, k_lo = base + lay.k_lo;
  const uint32_t v_hi = base + lay.v_hi, v_lo = base + lay.v_lo;
  const uint32_t q_bar = base + lay.q_bar;
  const uint32_t full = base + lay.full_bar, empty = base + lay.empty_bar;

  // longest causal rows first: the last query block has the most chunks
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int q0 = qi * kRows;
  const int num_kv = (seq_len + BK - 1) / BK;
  const int hi = causal ? min((q0 + kRows + BK - 1) / BK, num_kv) : num_kv;
  const int lo = (causal && window > 0) ? max(q0 - window + 1, 0) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * S::kConsumers);  // every consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer ----
    if constexpr (S::kProducerRegs > 0)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
          S::kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, 2 * S::kQBytes);
      for (int cb = 0; cb < Dp / 32; ++cb) {
        tma_load(q_hi + cb * kRows * 128, &qh_map, q_bar, cb * 32, q0,
                 b * hq + h);
        tma_load(q_lo + cb * kRows * 128, &ql_map, q_bar, cb * 32, q0,
                 b * hq + h);
      }
      for (int j = lo, it = 0; j < hi; ++j, ++it) {
        const int stage = it % kStages;
        if (it >= kStages)
          mbar_wait(empty + 8 * stage, ((it / kStages) & 1) ^ 1);
        const uint32_t bar = full + 8 * stage;
        mbar_expect_tx(bar, (kLo ? 2 : 1) * (S::kKBytes + S::kVBytes));
        const uint32_t ko = stage * S::kKBytes, vo = stage * S::kVBytes;
        for (int cb = 0; cb < Dp / 32; ++cb) {
          tma_load(k_hi + ko + cb * BK * 128, &kh_map, bar, cb * 32, j * BK,
                   b * hkv + hk);
          if (kLo)
            tma_load(k_lo + ko + cb * BK * 128, &kl_map, bar, cb * 32,
                     j * BK, b * hkv + hk);
        }
        for (int cb = 0; cb < BK / 32; ++cb) {
          tma_load(v_hi + vo + cb * D * 128, &vh_map, bar, j * BK + cb * 32,
                   0, b * hkv + hk);
          if (kLo)
            tma_load(v_lo + vo + cb * D * 128, &vl_map, bar,
                     j * BK + cb * 32, 0, b * hkv + hk);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup g = wg - 1 owns query rows 64g .. 64g + 63 ----
  if constexpr (S::kConsumerRegs > 0)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
        S::kConsumerRegs));
  const int g = wg - 1;
  const int t = threadIdx.x % 128;
  const int r = (t % 32) / 4, c = t % 4;
  const int row0 = q0 + 64 * g + 16 * (t / 32) + r;  // and row0 + 8
  const int qmin = q0 + 64 * g, qmax = qmin + 63;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(q_bar, 0);
  for (int j = lo, it = 0; j < hi; ++j, ++it) {
    const int stage = it % kStages;
    mbar_wait(full + 8 * stage, (it / kStages) & 1);
    const uint32_t kh = k_hi + stage * S::kKBytes;
    const uint32_t kl = k_lo + stage * S::kKBytes;
    const uint32_t vh = v_hi + stage * S::kVBytes;
    const uint32_t vl = v_lo + stage * S::kVBytes;

    // S = Q_hi K_hi^T + Q_hi K_lo^T + Q_lo K_hi^T over Dp in k8 steps
    float s[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Dp / 8; ++kk) {
      const uint32_t col = (kk % 4) * 32;  // 8 floats of a 128-B row
      const uint32_t qo = (kk / 4) * kRows * 128 + g * 64 * 128 + col;
      const uint32_t ko = (kk / 4) * BK * 128 + col;
      const uint64_t qh = desc_sw128(q_hi + qo, 16, 1024);
      const uint64_t kh_d = desc_sw128(kh + ko, 16, 1024);
      wgmma_ss<BK>(s, qh, kh_d, kk > 0);
      if (kLo) wgmma_ss<BK>(s, qh, desc_sw128(kl + ko, 16, 1024), 1);
      wgmma_ss<BK>(s, desc_sw128(q_lo + qo, 16, 1024), kh_d, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<BK / 2>(s);

    // mask, online softmax; thread holds rows row0 (e < 2) and row0 + 8
    // (e >= 2), columns 8 * jj + 2 * c + (e & 1)
    const int kv0 = j * BK;
    const bool whole = kv0 + BK <= seq_len &&
                       (!causal || kv0 + BK - 1 <= qmin) &&
                       (window <= 0 || kv0 > qmax - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * jj + e];
        if (!whole) {
          const int col = kv0 + 8 * jj + 2 * c + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          bool keep = col < seq_len;
          if (causal) keep = keep && col <= row;
          if (window > 0) keep = keep && col > row - window;
          x = keep ? x : kNegInf;
        }
        s[4 * jj + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f((m[i] - m_new) * kLog2e);
      m[i] = m_new;
    }
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[4 * jj + e] - m[e >> 1]) * kLog2e);
        s[4 * jj + e] = p;
        psum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + psum[i];
    // P as the A operand of m64nDk8, one k8 step per 8 keys: fragment
    // element i holds row r + 8 (i & 1), k column c + 4 (i >> 1), which
    // the V^T key order maps to key 2c + (i >> 1) of the group: the
    // accumulator's own elements 0, 2, 1, 3
    uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = s[4 * kk + 2 * (i & 1) + (i >> 1)];
        ph[kk][i] = to_tf32(p);
        pl[kk][i] = to_tf32(p - __uint_as_float(ph[kk][i]));
      }
    }
    // the chunk's P_hi V_hi + P_hi V_lo + P_lo V_hi in a fresh
    // accumulator, then acc = acc * alpha + pv in f32 on the CUDA cores
    float pv[D / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint32_t vo = (kk / 4) * D * 128 + (kk % 4) * 32;
      const uint64_t vh_d = desc_sw128(vh + vo, 16, 1024);
      wgmma_rs<D>(pv, ph[kk], vh_d, kk > 0);
      if (kLo) wgmma_rs<D>(pv, ph[kk], desc_sw128(vl + vo, 16, 1024), 1);
      wgmma_rs<D>(pv, pl[kk], vh_d, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<D / 2>(pv);
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[4 * jj + e] = __fadd_rn(__fmul_rn(acc[4 * jj + e], alpha[e >> 1]),
                                    pv[4 * jj + e]);
    }
    mbar_arrive(empty + 8 * stage);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = l[i] > 0.f ? l[i] : 1.f;
  }
  T* o_bh = o + (size_t(b) * hq + h) * seq_len * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= seq_len) continue;
    T* dst = o_bh + size_t(row) * D + 2 * c;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      const float x0 = acc[4 * jj + 2 * i] / l[i];
      const float x1 = acc[4 * jj + 2 * i + 1] / l[i];
      if constexpr (kLo) {
        *reinterpret_cast<float2*>(dst + 8 * jj) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jj) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

// ---------------------------------------------------------------- host --

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// An f32 [heads, rows, cols] tensor as a 3-D map with {32, box_rows, 1}
// boxes, 128-byte swizzle; out-of-range elements read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int heads, int rows,
              int cols, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(rows),
                              cuuint64_t(heads)};
  const cuuint64_t strides[2] = {cuuint64_t(cols) * 4,
                                 cuuint64_t(rows) * cols * 4};
  const cuuint32_t box[3] = {32, cuuint32_t(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D>
int launch_split(const void* q, const void* k, const void* v, void* q_hi,
                 void* q_lo, void* k_hi, void* k_lo, void* v_hi, void* v_lo,
                 int batch, int hq, int hkv, int seq_len, float sm_scale,
                 void* stream) {
  const int nq = batch * hq, nkv = batch * hkv;
  dim3 grid((seq_len + kSplitKeys - 1) / kSplitKeys, nq + 2 * nkv);
  flash_split_tf32_kernel<T, D><<<grid, 256, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(q_hi),
      static_cast<float*>(q_lo), static_cast<float*>(k_hi),
      static_cast<float*>(k_lo), static_cast<float*>(v_hi),
      static_cast<float*>(v_lo), nq, nkv, seq_len, sm_scale);
  return int(cudaGetLastError());
}

template <int D, typename T>
int launch_main(const void* q_hi, const void* q_lo, const void* k_hi,
                const void* k_lo, const void* v_hi, const void* v_lo,
                void* o, int batch, int hq, int hkv, int seq_len, int causal,
                int window, void* stream) {
  using S = Shape<D>;
  constexpr bool kLo = sizeof(T) == 4;
  const Layout lay = make_layout<D>();
  // without a lo plane (bf16 input) its map is the hi plane's, never read
  if (!kLo) {
    k_lo = k_hi;
    v_lo = v_hi;
  }
  CUtensorMap qh, ql, kh, kl, vh, vl;
  if (!make_map(&qh, q_hi, batch * hq, seq_len, S::Dp, S::kRows) ||
      !make_map(&ql, q_lo, batch * hq, seq_len, S::Dp, S::kRows) ||
      !make_map(&kh, k_hi, batch * hkv, seq_len, S::Dp, S::BK) ||
      !make_map(&kl, k_lo, batch * hkv, seq_len, S::Dp, S::BK) ||
      !make_map(&vh, v_hi, batch * hkv, D, seq_len, D) ||
      !make_map(&vl, v_lo, batch * hkv, D, seq_len, D))
    return int(cudaErrorInvalidValue);
  auto kernel = flash_attention_tf32x3_kernel<D, T>;
  if constexpr (S::kProducerRegs > 0) {
    // setmaxnreg moves registers inside the block's own allocation: the
    // consumers' raise must be covered by what the launch holds
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return int(err);
    if (attr.numRegs * S::kThreads <
        128 * S::kProducerRegs + 128 * S::kConsumers * S::kConsumerRegs)
      return int(cudaErrorInvalidConfiguration);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
  if (err != cudaSuccess) return int(err);
  dim3 grid((seq_len + S::kRows - 1) / S::kRows, hq, batch);
  kernel<<<grid, S::kThreads, lay.bytes, static_cast<cudaStream_t>(stream)>>>(
      qh, ql, kh, kl, vh, vl, lay, static_cast<T*>(o), hq, hkv, seq_len,
      causal, window);
  return int(cudaGetLastError());
}

}  // namespace

// The pre-pass: q [B, Hq, S, D] (f32 or bf16: bf16 != 0), k/v [B, Hkv, S,
// D] to f32 planes q_hi/q_lo [B*Hq, S, Dp], k_hi/k_lo [B*Hkv, S, Dp] and
// v_hi/v_lo [B*Hkv, D, S] (keys of each group of 8 in the order 0 2 4 6 1
// 3 5 7); for bf16 k_lo and v_lo are null and not written. Returns the
// launch's cudaError_t (0 = success).
extern "C" int flash_attention_tf32_split(
    const void* q, const void* k, const void* v, void* q_hi, void* q_lo,
    void* k_hi, void* k_lo, void* v_hi, void* v_lo, int bf16, int batch,
    int hq, int hkv, int seq_len, int head_dim, float sm_scale,
    void* stream) {
#define SPLIT(T, D)                                                        \
  return launch_split<T, D>(q, k, v, q_hi, q_lo, k_hi, k_lo, v_hi, v_lo,   \
                            batch, hq, hkv, seq_len, sm_scale, stream)
  if (bf16) {
    if (head_dim == 80) SPLIT(__nv_bfloat16, 80);
  } else {
    if (head_dim == 64) SPLIT(float, 64);
    if (head_dim == 80) SPLIT(float, 80);
    if (head_dim == 128) SPLIT(float, 128);
  }
#undef SPLIT
  return int(cudaErrorInvalidValue);
}

// The main kernel on the pre-pass's planes; o [B, Hq, S, D] in the input
// dtype (f32 at D 64, 80 and 128, bf16 at D 80).
extern "C" int flash_attention_tf32x3(
    const void* q_hi, const void* q_lo, const void* k_hi, const void* k_lo,
    const void* v_hi, const void* v_lo, void* o, int bf16, int batch, int hq,
    int hkv, int seq_len, int head_dim, int causal, int window,
    void* stream) {
#define MAIN(D, T)                                                        \
  return launch_main<D, T>(q_hi, q_lo, k_hi, k_lo, v_hi, v_lo, o, batch,  \
                           hq, hkv, seq_len, causal, window, stream)
  if (bf16) {
    if (head_dim == 80) MAIN(80, __nv_bfloat16);
  } else {
    if (head_dim == 64) MAIN(64, float);
    if (head_dim == 80) MAIN(80, float);
    if (head_dim == 128) MAIN(128, float);
  }
#undef MAIN
  return int(cudaErrorInvalidValue);
}

// Dynamic shared memory one main-kernel block requests (kernel.py checks
// it), -1 for an unsupported head dim.
extern "C" int flash_attention_tf32_smem_bytes(int head_dim) {
  return head_dim == 64    ? int(make_layout<64>().bytes)
         : head_dim == 80  ? int(make_layout<80>().bytes)
         : head_dim == 128 ? int(make_layout<128>().bytes)
                           : -1;
}

extern "C" const char* flash_attention_tf32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
