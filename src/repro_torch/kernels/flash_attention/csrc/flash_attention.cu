// Hand-written Hopper (sm_90a) flash attention, with a plain C interface
// loaded by kernel.py through ctypes.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel
// (the Pallas TPU kernel; built by build_flash_attention). It computes what
// that kernel computes: causal (or full) GQA attention with an optional
// sliding window, the online-softmax recurrence over kv chunks in f32:
//
//   q      = f32(q_tile) * sm_scale
//   s      = q k^T over one block_k chunk, masked to -1e30 (not -inf)
//   m_new  = max(m, rowmax(s));  p = exp(s - m_new);  alpha = exp(m - m_new)
//   l      = l * alpha + rowsum(p);  acc = acc * alpha + p v
//   out    = acc / (l > 0 ? l : 1)                   (written as q's type)
//
// with the kv loop trimmed to [lo, hi): hi at the causal frontier whenever
// causal is set, lo at the window only when causal and window are both set.
//
// Design. One block per (q block, query head, batch); kv head = h / group.
// Four consecutive lanes own one query row: each holds a quarter of the
// row's q (pre-scaled) and of its accumulator in registers, the four
// partial dot products meet through two xor shuffles, and every lane of the
// four then holds the same score. Shared memory holds one k chunk and one v
// chunk, converted to f32 (rows padded so the four quarters fall in distinct
// banks), and the block_q x block_k scores of the chunk. All arithmetic is
// f32 FMA on the CUDA cores.
//
// Bound on this card: the causal work is 2*B*Hq*S^2*D flops (both products,
// half the square), far above the bytes of q, k, v and o, so the tensor
// cores' rate bounds it. This first kernel runs on the CUDA cores and reads
// every k and v element from shared memory once per FMA, so it sits well
// above that bound; wgmma and TMA are for a later kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kLanesPerRow = 4;
constexpr float kNegInf = -1e30f;

__device__ inline float to_f32(float x) { return x; }
__device__ inline float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ inline T from_f32(float x);
template <>
__device__ inline float from_f32<float>(float x) { return x; }
template <>
__device__ inline __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Floats of one padded k or v row in shared memory: four quarters of D/4,
// each followed by one pad float.
template <int D>
__host__ __device__ constexpr int kv_row_floats() {
  return kLanesPerRow * (D / kLanesPerRow + 1);
}

// Dynamic shared memory (kernel.py's smem_bytes computes its size):
//   [k chunk: block_k x kv_row_floats][v chunk: the same]
//   [scores: block_q x (block_k + 1)], all f32.
// blockDim.x = block_q * 4 (a multiple of 32); grid = (S / block_q, Hq, B).
constexpr int kMaxThreads = 512;  // block_q <= 128

template <typename T, int D>
__global__ void __launch_bounds__(kMaxThreads) flash_attention_kernel(const T* __restrict__ q,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v,
                                       T* __restrict__ o, int hq, int hkv,
                                       int seq_len, int block_q, int block_k,
                                       float sm_scale, int causal, int window) {
  constexpr int Q = D / kLanesPerRow;  // a lane's quarter of the head
  constexpr int KS = kv_row_floats<D>();
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + block_k * KS;
  float* sc = v_s + block_k * KS;  // [block_q][block_k + 1]

  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int row = threadIdx.x / kLanesPerRow;
  const int part = threadIdx.x % kLanesPerRow;
  const int q_pos = qi * block_q + row;

  const size_t q_off =
      ((size_t(b) * hq + h) * seq_len + q_pos) * D + size_t(part) * Q;
  const size_t kv_base = (size_t(b) * hkv + hk) * seq_len * D;

  float qr[Q], acc[Q], pv[Q];
#pragma unroll
  for (int d = 0; d < Q; ++d) {
    qr[d] = to_f32(q[q_off + d]) * sm_scale;
    acc[d] = 0.f;
  }
  float m_i = kNegInf, l_i = 0.f;

  const int num_kv = seq_len / block_k;
  const int hi = causal ? min(((qi + 1) * block_q + block_k - 1) / block_k, num_kv)
                        : num_kv;
  const int lo = (causal && window > 0) ? max(qi * block_q - window + 1, 0) / block_k
                                        : 0;
  float* my_sc = sc + row * (block_k + 1);
  const float* k_part = k_s + part * (Q + 1);
  const float* v_part = v_s + part * (Q + 1);

  for (int j = lo; j < hi; ++j) {
    __syncthreads();  // the previous chunk's readers are done
    const T* kc = k + kv_base + size_t(j) * block_k * D;
    const T* vc = v + kv_base + size_t(j) * block_k * D;
    for (int e = threadIdx.x; e < block_k * D; e += blockDim.x) {
      const int r = e / D, dd = e % D;
      const int dst = r * KS + (dd / Q) * (Q + 1) + dd % Q;
      k_s[dst] = to_f32(kc[e]);
      v_s[dst] = to_f32(vc[e]);
    }
    __syncthreads();

    float mx = kNegInf;
    for (int c = 0; c < block_k; ++c) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < Q; ++d) dot = fmaf(qr[d], k_part[c * KS + d], dot);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kv_pos = j * block_k + c;
      bool keep = true;
      if (causal) keep = kv_pos <= q_pos;
      if (window > 0) keep = keep && kv_pos > q_pos - window;
      const float s = keep ? dot : kNegInf;
      if ((c % kLanesPerRow) == part) my_sc[c] = s;
      mx = fmaxf(mx, s);
    }
    __syncwarp();  // the row's scores are visible to its four lanes

    const float m_new = fmaxf(m_i, mx);
    const float alpha = expf(m_i - m_new);
    float psum = 0.f;
#pragma unroll
    for (int d = 0; d < Q; ++d) pv[d] = 0.f;
    for (int c = 0; c < block_k; ++c) {
      const float p = expf(my_sc[c] - m_new);
      psum += p;
#pragma unroll
      for (int d = 0; d < Q; ++d) pv[d] = fmaf(p, v_part[c * KS + d], pv[d]);
    }
    l_i = l_i * alpha + psum;
#pragma unroll
    for (int d = 0; d < Q; ++d) acc[d] = acc[d] * alpha + pv[d];
    m_i = m_new;
    __syncwarp();  // reads of my_sc precede the next chunk's writes
  }

  const float l_safe = l_i > 0.f ? l_i : 1.f;
#pragma unroll
  for (int d = 0; d < Q; ++d) o[q_off + d] = from_f32<T>(acc[d] / l_safe);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int hq, int hkv, int seq_len, int block_q, int block_k,
           float sm_scale, int causal, int window, int smem, void* stream) {
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  dim3 grid(seq_len / block_q, hq, batch);
  kernel<<<grid, block_q * kLanesPerRow, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, seq_len, block_q,
      block_k, sm_scale, causal, window);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int batch,
             int hq, int hkv, int seq_len, int head_dim, int block_q,
             int block_k, float sm_scale, int causal, int window, int smem,
             void* stream) {
  switch (head_dim) {
    case 64:
      return launch<T, 64>(q, k, v, o, batch, hq, hkv, seq_len, block_q,
                           block_k, sm_scale, causal, window, smem, stream);
    case 80:
      return launch<T, 80>(q, k, v, o, batch, hq, hkv, seq_len, block_q,
                           block_k, sm_scale, causal, window, smem, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, batch, hq, hkv, seq_len, block_q,
                            block_k, sm_scale, causal, window, smem, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention_float32(
    const void* q, const void* k, const void* v, void* o, int batch, int hq,
    int hkv, int seq_len, int head_dim, int block_q, int block_k,
    float sm_scale, int causal, int window, int smem, void* stream) {
  return dispatch<float>(q, k, v, o, batch, hq, hkv, seq_len, head_dim,
                         block_q, block_k, sm_scale, causal, window, smem,
                         stream);
}

extern "C" int flash_attention_bfloat16(
    const void* q, const void* k, const void* v, void* o, int batch, int hq,
    int hkv, int seq_len, int head_dim, int block_q, int block_k,
    float sm_scale, int causal, int window, int smem, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, batch, hq, hkv, seq_len,
                                 head_dim, block_q, block_k, sm_scale, causal,
                                 window, smem, stream);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
