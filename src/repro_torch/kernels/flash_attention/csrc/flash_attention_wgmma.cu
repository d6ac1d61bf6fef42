// Hand-written Hopper (sm_90a) flash attention for bf16 on the tensor
// cores, with a plain C interface loaded by kernel.py through ctypes.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel
// (the Pallas TPU kernel; pallas_call in build_flash_attention) for bf16
// inputs with head dim 64 or 128; flash_attention.cu keeps f32 (TF32 cannot
// hold f32's 2e-5) and D = 80 (160-byte rows fit no 128-byte swizzle atom).
// It computes the same function as that kernel: causal (or full) GQA
// attention with an optional sliding window, scores scaled in f32, masked
// to the -1e30 sentinel, the online softmax in f32, and
// acc / (l > 0 ? l : 1) rounded once to bf16.
//
// The function does not depend on the kv chunking: every row keeps at least
// one key (its diagonal when causal, q_pos itself when a window is set, all
// keys otherwise), so a chunk that is wholly masked for a row either comes
// after a real score (p = exp(-1e30 - m) = 0) or before one (its p = 1 terms
// are wiped by alpha = exp(-1e30 - m) = 0). This kernel therefore uses its
// own tile (128 query rows, BK keys a chunk) whatever block_q / block_k the
// caller names, and trims its kv loop to [lo, hi) as ref.kv_range does for
// its own tile; chunks past the sequence's end are masked.
//
// Design (the hopper-kernels guide, section 1). One block per (128 query
// rows, query head, batch), three warpgroups:
//   * warpgroup 0, the producer: one thread issues TMA loads
//     (cp.async.bulk.tensor, completion on an mbarrier) of the Q tile and of
//     the K and V chunks into a ring of kStages stages, 128-byte swizzled
//     (a D = 128 row is loaded as two 64-column halves). It gives registers
//     away with setmaxnreg.
//   * warpgroups 1 and 2, the consumers, 64 query rows each: S = Q K^T as
//     wgmma.mma_async on the bf16 tiles in shared memory, accumulated in
//     f32; scale, mask and the online softmax on the f32 accumulator; then
//     P V with P taken from registers, one chunk at a time, added to the
//     f32 output accumulator on the CUDA cores as acc * alpha + pv (the
//     plain version's order; left in the tensor core across chunks, the
//     running sum drifted past one bf16 step on some outputs). P
//     is split into three bf16 terms, P_1 = bf16(P), P_2 = bf16(P - P_1),
//     P_3 = bf16(P - P_1 - P_2), each through the tensor cores, so P keeps
//     about 24 bits. One term adds about 2^-9 relative error to every
//     product and two about 2^-17; either leaves outputs more than one
//     bf16 step from the plain version where a row has few keys and its
//     terms cancel (chip_smoke.py phase 5 counts them). Each consumer
//     thread arrives on the stage's "empty" mbarrier when its products are
//     done, which hands the stage back to the producer.
// The output is written from registers.
//
// Bound on this card: the causal work is 2*B*Hq*S^2*D flops (both products,
// half the square) at the bf16 tensor-core rate, far above the bytes of q,
// k, v and o. The three-term P makes the kernel issue 2x those flops (one
// QK^T and three PV products); the bound counts the function's work.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 128;  // two consumer warpgroups of 64 rows
constexpr int kStages = 3;
constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout of one block, in bytes from a 1024-aligned base:
// [Q: D/64 halves x 128 rows x 128 B][K: kStages x D/64 halves x BK x 128 B]
// [V: the same][barriers: q_full, full[kStages], empty[kStages]].
// BK = 64 keys a chunk: with the three P terms, the P V accumulator and
// the output accumulator, a consumer thread's registers fit its 232 (a
// 128-key chunk at D = 64 spilled, and with its terms formed four k16
// steps at a time it ran no faster).
template <int D>
struct Geometry {
  static constexpr int BK = 64;  // keys a chunk
  static constexpr int kHalves = D / 64;         // 128-byte column halves
  static constexpr int kQBytes = kBlockQ * D * 2;
  static constexpr int kChunkBytes = BK * D * 2;  // one K (or V) chunk
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + kStages * kChunkBytes;
  static constexpr int kBarOff = kVOff + kStages * kChunkBytes;
  static constexpr int kSmem = kBarOff + 8 * (1 + 2 * kStages) + 1024;
};

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

// TMA: a {64, rows, 1} box of a 3-D map at (c0, c1, c2) into shared memory.
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

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B from shared memory
// (K-major, 128-byte swizzle); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n\t}\n"
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

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B from shared memory
// (K-major, 128-byte swizzle); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n\t}\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A from registers (four bf16x2
// per thread), B from shared memory, MN-major (transposed), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}\n"
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

// D[64 x 128] += A[64 x 16] * B[16 x 128], A from registers (four bf16x2
// per thread), B from shared memory, MN-major (transposed), 128-byte swizzle.
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %69, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n\t}\n"
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
  if constexpr (N == 64) wgmma_ss_n64(d, a, b, scale_d);
  else wgmma_ss_n128(d, a, b, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b, int scale_d) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, b, scale_d);
  else wgmma_rs_n128(d, a, b, scale_d);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The leading bf16 term of a pair of f32 values, packed, and the pair's
// remainders (exact in f32).
__device__ __forceinline__ uint32_t split_pack(float& a, float& b) {
  const float ha = __bfloat162float(__float2bfloat16_rn(a));
  const float hb = __bfloat162float(__float2bfloat16_rn(b));
  a -= ha;
  b -= hb;
  return pack_bf16(ha, hb);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ o,
    int hq, int hkv, int seq_len, float sm_scale, int causal, int window,
    int p_terms) {
  using G = Geometry<D>;
  constexpr int BK = G::BK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  const uint32_t q_s = base, k_s = base + G::kKOff, v_s = base + G::kVOff;
  const uint32_t q_full = base + G::kBarOff;
  const uint32_t full = q_full + 8, empty = full + 8 * kStages;

  // longest causal rows first: the last query block has the most chunks
  const int qi = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int q0 = qi * kBlockQ;
  const int num_kv = (seq_len + BK - 1) / BK;
  const int hi = causal ? min((q0 + kBlockQ + BK - 1) / BK, num_kv) : num_kv;
  const int lo = (causal && window > 0) ? max(q0 - window + 1, 0) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, G::kQBytes);
      for (int half = 0; half < G::kHalves; ++half)
        tma_load(q_s + half * kBlockQ * 128, &q_map, q_full, half * 64, q0,
                 b * hq + h);
      for (int j = lo, it = 0; j < hi; ++j, ++it) {
        const int stage = it % kStages;
        const uint32_t parity = (it / kStages) & 1;
        if (it >= kStages) mbar_wait(empty + 8 * stage, parity ^ 1);
        mbar_expect_tx(full + 8 * stage, 2 * G::kChunkBytes);
        for (int half = 0; half < G::kHalves; ++half) {
          const uint32_t off = stage * G::kChunkBytes + half * BK * 128;
          tma_load(k_s + off, &k_map, full + 8 * stage, half * 64, j * BK,
                   b * hkv + hk);
          tma_load(v_s + off, &v_map, full + 8 * stage, half * 64, j * BK,
                   b * hkv + hk);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup g = wg - 1 owns query rows 64g .. 64g + 63 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int g = wg - 1;
  const int t = threadIdx.x % 128;
  const int r = (t % 32) / 4, c = t % 4;
  const int row0 = q0 + 64 * g + 16 * (t / 32) + r;  // and row0 + 8
  const int qmin = q0 + 64 * g, qmax = qmin + 63;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int j = lo, it = 0; j < hi; ++j, ++it) {
    const int stage = it % kStages;
    mbar_wait(full + 8 * stage, (it / kStages) & 1);
    const uint32_t ks = k_s + stage * G::kChunkBytes;
    const uint32_t vs = v_s + stage * G::kChunkBytes;

    // S = Q K^T over D in k16 steps (K-major operands)
    float s[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;  // 16 bf16 of a 128-B row
      const uint64_t da = desc_sw128(
          q_s + (kk / 4) * kBlockQ * 128 + g * 64 * 128 + col, 16, 1024);
      const uint64_t db = desc_sw128(ks + (kk / 4) * BK * 128 + col, 16, 1024);
      wgmma_ss<BK>(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<BK / 2>(s);

    // scale, mask, online softmax; thread holds rows row0 (e < 2) and
    // row0 + 8 (e >= 2), columns 8 * jj + 2 * c + (e & 1)
    const int kv0 = j * BK;
    const bool whole = kv0 + BK <= seq_len &&
                       (!causal || kv0 + BK - 1 <= qmin) &&
                       (window <= 0 || kv0 > qmax - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * jj + e] * sm_scale;
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
    // P as the A operand of m64nDk16, one k16 step per 16 keys (the
    // accumulator layout of S is the register layout of A), in p_terms
    // bf16 terms: P_1 = bf16(P), P_2 = bf16(P - P_1), P_3 = bf16(P - P_1 -
    // P_2); three keep P to about 24 bits
    uint32_t pt[3][BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float a = s[8 * kk + 2 * i], b = s[8 * kk + 2 * i + 1];
#pragma unroll
        for (int n = 0; n < 3; ++n) pt[n][kk][i] = split_pack(a, b);
      }
    }
    // the chunk's sum over the terms of P_n V (V is MN-major: keys are
    // rows, D contiguous) in a fresh accumulator, then acc = acc * alpha +
    // pv in f32 on the CUDA cores, as the plain version orders it: the
    // tensor core sums only one chunk's products, never the running total
    float pv[D / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = desc_sw128(vs + kk * 16 * 128, BK * 128, 1024);
      wgmma_rs<D>(pv, pt[0][kk], dv, kk > 0);
      if (p_terms > 1) wgmma_rs<D>(pv, pt[1][kk], dv, 1);
      if (p_terms > 2) wgmma_rs<D>(pv, pt[2][kk], dv, 1);
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
  __nv_bfloat16* o_bh = o + (size_t(b) * hq + h) * seq_len * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= seq_len) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(o_bh + size_t(row) * D);
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      dst[4 * jj + c] = pack_bf16(acc[4 * jj + 2 * i] / l[i],
                                  acc[4 * jj + 2 * i + 1] / l[i]);
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

// A [heads, seq_len, D] bf16 tensor as a 3-D map with {64, rows, 1} boxes,
// 128-byte swizzle; rows past seq_len read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int heads, int seq_len,
              int d, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {cuuint64_t(d), cuuint64_t(seq_len),
                              cuuint64_t(heads)};
  const cuuint64_t strides[2] = {cuuint64_t(d) * 2,
                                 cuuint64_t(seq_len) * d * 2};
  const cuuint32_t box[3] = {64, cuuint32_t(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int hq, int hkv, int seq_len, float sm_scale, int causal,
           int window, int p_terms, void* stream) {
  using G = Geometry<D>;
  CUtensorMap q_map, k_map, v_map;
  if (!make_map(&q_map, q, batch * hq, seq_len, D, kBlockQ) ||
      !make_map(&k_map, k, batch * hkv, seq_len, D, G::BK) ||
      !make_map(&v_map, v, batch * hkv, seq_len, D, G::BK))
    return int(cudaErrorInvalidValue);
  auto kernel = flash_attention_wgmma_kernel<D>;
  // setmaxnreg moves registers inside the block's own allocation: the
  // consumers' raise must be covered by what the launch holds
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return int(err);
  if (attr.numRegs * kThreads < 128 * kProducerRegs + 256 * kConsumerRegs)
    return int(cudaErrorInvalidConfiguration);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return int(err);
  dim3 grid((seq_len + kBlockQ - 1) / kBlockQ, hq, batch);
  kernel<<<grid, kThreads, G::kSmem, static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), hq, hkv, seq_len,
      sm_scale, causal, window, p_terms);
  return int(cudaGetLastError());
}

}  // namespace

// bf16 q [B, Hq, S, D], k/v [B, Hkv, S, D], o like q; D 64 or 128.
// p_terms (1 to 3) is the number of bf16 terms P is split into; the entry
// point passes 3, the measurement of why asks for fewer. Returns the
// launch's cudaError_t (0 = success).
extern "C" int flash_attention_wgmma_bfloat16(
    const void* q, const void* k, const void* v, void* o, int batch, int hq,
    int hkv, int seq_len, int head_dim, float sm_scale, int causal,
    int window, int p_terms, void* stream) {
  if (p_terms < 1 || p_terms > 3) return int(cudaErrorInvalidValue);
  switch (head_dim) {
    case 64:
      return launch<64>(q, k, v, o, batch, hq, hkv, seq_len, sm_scale, causal,
                        window, p_terms, stream);
    case 128:
      return launch<128>(q, k, v, o, batch, hq, hkv, seq_len, sm_scale,
                         causal, window, p_terms, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory one block requests (kernel.py checks it).
extern "C" int flash_attention_wgmma_smem_bytes(int head_dim) {
  return head_dim == 64 ? Geometry<64>::kSmem
                        : head_dim == 128 ? Geometry<128>::kSmem : -1;
}

extern "C" const char* flash_attention_wgmma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
