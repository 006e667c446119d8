// Flash attention (online softmax, f32 statistics) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel K7 of src/repro/kernels/flash_attention.py:
//
//   flash_attention_pallas (flash_attention.py:67; pallas_call at :83, body
//   _flash_kernel)
//
//     out = softmax(q k^T / sqrt(hd), masked causally or not) v
//
// over q/k/v [BH, S, hd] (heads flattened, KV already repeated), f32 or
// bf16, out in q's dtype.  As the Pallas kernel does, every input is
// converted to f32 and everything is computed in f32: the scores, the
// running max m (starting at -1e30, the mask value), the denominator l and
// the output accumulator; the result is acc / max(l, 1e-30), stored with
// __float2bfloat16_rn for bf16.
//
// The TPU's grid was (BH, q blocks, kv blocks) with the kv dimension
// sequential, carrying m, l and acc in VMEM scratch.  Here one block owns
// one 64-row query tile of one (bh) and a loop inside the block walks the
// 64-key tiles; with causal it stops after the tile that holds the
// diagonal, because a fully masked tile adds exp(-1e30 - m) = 0 to l and
// acc and multiplies them by exp(0) = 1, exactly nothing.  The tile sizes
// are the kernel's own: block_q and block_k only fix the reference's order
// of summation, which changes the result by f32 rounding alone, and the
// wrapper checks them as the reference asserts them.
//
// Bound.  4 * BH * S^2 * hd operations (halved when causal) against
// 4 * BH * S * hd elements moved: at llama3-8b's hd = 128 and S = 8192 the
// operations bound it (989 TFLOP/s for bf16 on the tensor cores).
//
// Design, simple first (f32 on the CUDA cores, no tensor cores, no TMA):
//  * 256 threads as 16 x 16: thread (ty, tx) owns query rows 4ty..4ty+3,
//    score columns tx + 16j (j < 4) and output columns tx + 16j
//    (j < hd / 16), so the output row is spread over 16 threads and a
//    thread holds at most 4 x 8 accumulators (no spills at hd = 128);
//  * the Q tile stays in shared memory; K and then V of each key tile
//    share one buffer (loaded one after the other), and the probabilities
//    go through a 64 x 64 tile; rows are padded by one float so that the
//    16 threads reading 16 different key rows hit 16 different banks;
//  * row max and row sum are reduced over the 16 threads of a row with
//    __shfl_xor_sync, so every one of them holds m and l;
//  * blocks are issued heaviest first (the last query tiles under causal).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 64;          // query rows per block
constexpr int kK = 64;          // keys per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int HD>
constexpr int smem_floats() {
  return kQ * (HD + 1) + kK * (HD + 1) + kQ * (kK + 1);
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int bh_count,
                 int s_len, int causal, float scale) {
  constexpr int kCols = HD / 16;                 // output columns a thread
  extern __shared__ float smem[];
  float* q_s = smem;                             // [kQ][HD + 1]
  float* kv_s = q_s + kQ * (HD + 1);             // [kK][HD + 1]
  float* p_s = kv_s + kK * (HD + 1);             // [kQ][kK + 1]

  const int nq = (s_len + kQ - 1) / kQ;
  const int qt = nq - 1 - (int)(blockIdx.x / bh_count);   // heaviest first
  const long long bh = blockIdx.x % bh_count;
  const int q0 = qt * kQ;
  const long long base = bh * (long long)s_len * HD;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  for (int e = tid; e < kQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    q_s[r * (HD + 1) + d] =
        q0 + r < s_len ? to_f32(q[base + (long long)(q0 + r) * HD + d]) : 0.f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  const int k_end = causal ? min(s_len, q0 + kQ) : s_len;
  for (int k0 = 0; k0 < k_end; k0 += kK) {
    __syncthreads();                             // kv_s, p_s free again
    for (int e = tid; e < kK * HD; e += kThreads) {
      const int r = e / HD, d = e % HD;
      kv_s[r * (HD + 1) + d] =
          k0 + r < s_len ? to_f32(k[base + (long long)(k0 + r) * HD + d])
                         : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(4 * ty + i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kv_s[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        s[i][j] *= scale;
        if ((causal && kpos > qpos) || kpos >= s_len) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const float p = kpos < s_len ? expf(s[i][j] - m_new) : 0.f;
        p_s[(4 * ty + i) * (kK + 1) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
    __syncthreads();                             // done with K, p_s written

    for (int e = tid; e < kK * HD; e += kThreads) {
      const int r = e / HD, d = e % HD;
      kv_s[r * (HD + 1) + d] =
          k0 + r < s_len ? to_f32(v[base + (long long)(k0 + r) * HD + d])
                         : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kK; ++kk) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(4 * ty + i) * (kK + 1) + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = kv_s[kk * (HD + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= s_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      store(&out[base + (long long)r * HD + tx + 16 * j], acc[i][j] / denom);
  }
}

template <int HD, typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int bh,
              int s_len, int causal, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  auto kernel = flash_kernel<HD, T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long nq = (s_len + kQ - 1) / kQ;
  kernel<<<(unsigned int)(nq * bh), kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, bh, s_len, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* out, int bh,
             int s_len, int hd, int causal, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_hd<32, T>(q, k, v, out, bh, s_len, causal, scale, stream);
    case 64: return launch_hd<64, T>(q, k, v, out, bh, s_len, causal, scale, stream);
    case 128: return launch_hd<128, T>(q, k, v, out, bh, s_len, causal, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q/k/v/out: [bh, s_len, hd] contiguous, f32 (dtype 0) or bf16 (dtype 1);
// hd in {32, 64, 128}; scale = 1 / sqrt(hd).  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for another hd or dtype).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int bh, int s_len, int hd, int causal,
                           int dtype, float scale, void* stream) {
  if (bh <= 0 || s_len <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_t<float>(q, k, v, out, bh, s_len, hd, causal, scale, st);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(q, k, v, out, bh, s_len, hd, causal, scale,
                                   st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
