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
// bf16, out in q's dtype.  As in the Pallas kernel the statistics are f32:
// the running row max m (masked scores are -1e30 in the reference), the
// denominator l and the output accumulator; the result is
// acc / max(l, 1e-30), rounded once to q's dtype.
//
// The TPU's grid was (BH, q blocks, kv blocks) with the kv dimension
// sequential, carrying m, l and acc in VMEM scratch.  Here one block owns
// one query tile of one (bh) and a loop inside the block walks the key
// tiles; with causal it stops after the tile that holds the diagonal (a
// fully masked tile adds nothing) and masks that tile elementwise.
// Blocks are issued heaviest first (the last query tiles under causal).
// The tile sizes are the kernel's own: block_q and block_k only fix the
// reference's order of summation, which moves the result by rounding
// alone, and the wrapper checks them as the reference asserts them.  S
// need not be a multiple of any tile: query rows past S are not written
// and keys past S get p = 0.
//
// Bound.  4 * BH * S^2 * hd operations (halved when causal) against
// 4 * BH * S * hd elements moved: at llama3-8b's hd = 128 and S = 8192 the
// operations bound it, at 989 TFLOP/s for bf16 on the tensor cores.
//
// bf16: tensor cores (flash_tc_kernel), in FlashAttention-3's shape.
// 384 threads: a producer warpgroup and two consumer warpgroups of 64
// query rows each, a 128-row query tile a block.
//  * One producer thread loads everything by TMA (3-D tensor maps over
//    [BH, S, hd], 128-byte swizzle, 64-byte at hd = 32; rows past S read
//    as zeros): Q once, then K and V tiles of 128 keys through a 2-stage
//    ring, each stage with a "full" mbarrier (TMA bytes) and an "empty"
//    one (one arrival per consumer warp).  setmaxnreg gives the producer
//    24 registers and the consumers 240.
//  * S = Q K^T is wgmma m64n128k16 with both operands in shared memory
//    (K-major), accumulated in f32 registers.  The online softmax runs on
//    that fragment: a row lives on the 4 threads of a quad, so its max is
//    reduced with two __shfl_xor_sync; the sum stays per thread until the
//    end.  exp is ex2.approx of scores pre-scaled by log2(e) / sqrt(hd).
//  * O += P V is wgmma m64n{hd}k16 with P from registers (the S fragment
//    repacked as the A operand) and V from shared memory (MN-major).
//  * Key tile j issues S_j = Q K_j^T together with O += P_{j-1} V_{j-1};
//    the softmax of S_j runs while the second product is on the tensor
//    cores, and O is rescaled once it is done.  The two consumer
//    warpgroups take turns to issue (named barriers 1 and 2), so one's
//    products run while the other does its softmax.
//  * P is split into two bf16 operands, P_hi = bf16(p) and
//    P_lo = bf16(p - P_hi), and both products go into the same f32
//    accumulator.  bf16 x bf16 products are exact in f32, so only the
//    order of summation moves; a single bf16 P would add a relative error
//    of up to 2^-9 on every weight, and at S = 512-2048 that alone breaks
//    the tolerance of 1e-3 + 8e-3 |want| by up to 1.6x, while the split
//    (16 significant bits of p) stays within it
//    (tests/test_torch_flash.py pins this on the CPU).  It costs half
//    again the tensor work of the bound (6 instead of 4 * S^2 * hd).
//  * ptxas (CUDA 12.9, sm_90a): 168 registers a thread at launch (the
//    share of __launch_bounds__(384, 1), before setmaxnreg), no spills, at
//    every head dim; shared memory is dynamic, TcTile<hd>::kSmem =
//    164,992 / 83,072 / 42,112 bytes a block at hd = 128 / 64 / 32, so
//    one block an SM.  chip_smoke.py (b) prints both.

// f32: CUDA cores (flash_kernel, the simple first kernel kept as it
// was).  Tensor cores would take f32 operands only as TF32, whose 10-bit
// mantissa cannot hold the f32 tolerance of 3e-5, so f32 stays on FMA:
//  * 256 threads as 16 x 16: thread (ty, tx) owns query rows 4ty..4ty+3,
//    score columns tx + 16j (j < 4) and output columns tx + 16j
//    (j < hd / 16); Q, then K and V of each 64-key tile (one buffer) and
//    the probabilities sit in shared memory, rows padded by one float;
//  * row max and row sum are reduced over the 16 threads of a row with
//    __shfl_xor_sync.

#include <cuda.h>  // CUtensorMap; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// -- f32 on the CUDA cores (the simple first kernel, unchanged) ------------

constexpr int kThreads = 256;
constexpr int kQ = 64;          // query rows per block
constexpr int kK = 64;          // keys per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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


// -- bf16 on the tensor cores ------------------------------------------------

constexpr int kTcThreads = 384;   // a producer and two consumer warpgroups
constexpr int kTcQ = 128;         // query rows per block, 64 per consumer
constexpr int kTcK = 128;         // keys per tile
constexpr int kTcStages = 2;      // K and V tiles in flight
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskInf = -__builtin_huge_valf();   // a masked score: p = 0

// A [rows][HD] bf16 tile in shared memory is kBlocks column blocks of
// [rows][kRow bytes], each written by TMA with the 128-byte (hd = 32:
// 64-byte) swizzle from a 1024-byte aligned base: the layout wgmma's
// descriptors of the same swizzle read.

template <int HD>
struct TcTile {
  static constexpr int kRow = HD * 2 >= 128 ? 128 : HD * 2;  // swizzle span
  static constexpr int kBox = kRow / 2;                     // bf16 a box row
  static constexpr int kBlocks = HD * 2 / kRow;             // column blocks
  static constexpr uint64_t kLayout = kRow == 128 ? 1 : 2;  // B128 or B64
  static constexpr int kQBytes = kTcQ * HD * 2;
  static constexpr int kKVBytes = kTcK * HD * 2;
  static constexpr int kTiles = kQBytes + 2 * kTcStages * kKVBytes;
  static constexpr int kSmem = 1024 + kTiles + 128;  // alignment, barriers
};

// S[64 x 128] (+)= Q[64 x 16] K^T[16 x 128], both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(
    float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O[64 x hd] += P[64 x 16] V[16 x hd]: P in registers (the A fragment),
// V MN-major in shared memory; one overload a head dim
__device__ __forceinline__ void wgmma_rs(
    float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(
    float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(
    float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the two consumer warpgroups take turns to issue their products (named
// barriers 1 and 2, 256 threads each): one's wgmma run while the other
// does its softmax
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

// one arrival per consumer warp on an "empty" barrier
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(bar);
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    __nv_bfloat16* __restrict__ out, int bh_count, int s_len,
                    int causal, float scale_log2) {
  using L = TcTile<HD>;
  constexpr int kRow = L::kRow;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk0 = sq + L::kQBytes;                  // K stages, then V
  const uint32_t sv0 = sk0 + kTcStages * L::kKVBytes;
  const uint32_t bars = sq + L::kTiles;
  const uint32_t q_full = bars;                          // 8 bytes each
  const uint32_t k_full = bars + 8, v_full = k_full + 8 * kTcStages;
  const uint32_t k_empty = v_full + 8 * kTcStages;
  const uint32_t v_empty = k_empty + 8 * kTcStages;

  const int nq = (s_len + kTcQ - 1) / kTcQ;
  const int qt = nq - 1 - (int)(blockIdx.x / bh_count);   // heaviest first
  const int bh = (int)(blockIdx.x % bh_count);
  const int q0 = qt * kTcQ;
  const int k_end = causal ? min(s_len, q0 + kTcQ) : s_len;
  const int nk = (k_end + kTcK - 1) / kTcK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kTcStages; ++s) {
      hopper::mbar_init(k_full + 8 * s, 1);
      hopper::mbar_init(v_full + 8 * s, 1);
      hopper::mbar_init(k_empty + 8 * s, 8);             // consumer warps
      hopper::mbar_init(v_empty + 8 * s, 8);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {
    // producer: one thread issues every TMA load of the block
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      hopper::mbar_expect_tx(q_full, L::kQBytes);
      for (int cb = 0; cb < L::kBlocks; ++cb)
        for (int half = 0; half < 2; ++half)
          hopper::tma_load_3d(sq + cb * kTcQ * kRow + half * 64 * kRow, &qmap,
                              q_full, cb * L::kBox, q0 + 64 * half, bh);
      for (int j = 0; j < nk; ++j) {
        const int s = j % kTcStages, ph = (j / kTcStages) & 1;
        hopper::mbar_wait(k_empty + 8 * s, ph ^ 1);
        hopper::mbar_expect_tx(k_full + 8 * s, L::kKVBytes);
        for (int cb = 0; cb < L::kBlocks; ++cb)
          for (int rr = 0; rr < kTcK / 64; ++rr)
            hopper::tma_load_3d(
                sk0 + s * L::kKVBytes + (cb * kTcK + rr * 64) * kRow, &kmap,
                k_full + 8 * s, cb * L::kBox, j * kTcK + rr * 64, bh);
        hopper::mbar_wait(v_empty + 8 * s, ph ^ 1);
        hopper::mbar_expect_tx(v_full + 8 * s, L::kKVBytes);
        for (int cb = 0; cb < L::kBlocks; ++cb)
          for (int rr = 0; rr < kTcK / 64; ++rr)
            hopper::tma_load_3d(
                sv0 + s * L::kKVBytes + (cb * kTcK + rr * 64) * kRow, &vmap,
                v_full + 8 * s, cb * L::kBox, j * kTcK + rr * 64, bh);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int ctid = tid - 128, wg = ctid >> 7, lane = tid & 31;
  const int quad_row = lane >> 2, quad_col = lane & 3;
  const int wq0 = q0 + wg * 64;
  const int row0 = wq0 + ((ctid >> 5) & 3) * 16 + quad_row;  // the thread's
                                                 // rows: row0 and row0 + 8
  float o[HD / 2], s[kTcK / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kTcK / 2; ++i) s[i] = 0.f;
  uint32_t p_hi[kTcK / 16][4], p_lo[kTcK / 16][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];

  // S = Q K^T of the tile in stage st: A = this warpgroup's 64 Q rows,
  // B = the tile's kTcK keys, both K-major; k steps of 16 along hd
  auto issue_qk = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int byte = kk * 32;
      const uint64_t da = hopper::make_desc(
          sq + (byte / kRow) * kTcQ * kRow + wg * 64 * kRow + byte % kRow,
          16, 8 * kRow, L::kLayout);
      const uint64_t db = hopper::make_desc(
          sk0 + st * L::kKVBytes + (byte / kRow) * kTcK * kRow + byte % kRow,
          16, 8 * kRow, L::kLayout);
      wgmma_ss(s, da, db, kk > 0);
    }
    hopper::wgmma_commit();
  };
  // O += P_hi V + P_lo V: B = V of stage st, MN-major (hd contiguous); k
  // steps of 16 keys; column blocks of kRow bytes are kTcK * kRow apart
  auto issue_pv = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < kTcK / 16; ++kk) {
      const uint64_t db =
          hopper::make_desc(sv0 + st * L::kKVBytes + kk * 16 * kRow,
                            kTcK * kRow, 8 * kRow, L::kLayout);
      wgmma_rs(o, p_hi[kk], db);
      wgmma_rs(o, p_lo[kk], db);
    }
    hopper::wgmma_commit();
  };
  auto fence_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kTcK / 16; ++kk) {
      hopper::fence_regs(p_hi[kk]);
      hopper::fence_regs(p_lo[kk]);
    }
  };
  // online softmax of the tile at key k0 on the fragment: s[4n + 2h + e]
  // is row row0 + 8h, key k0 + 8n + 2 quad_col + e.  Leaves p in s and the
  // factor that rescales O from the old row max to the new in corr.
  auto softmax = [&](int k0) {
    const bool edge = (causal && k0 + kTcK - 1 > wq0) || k0 + kTcK > s_len;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qpos = row0 + 8 * h;
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < kTcK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * n + 2 * h + e];
          if (edge) {
            const int kpos = k0 + 8 * n + 2 * quad_col + e;
            if ((causal && kpos > qpos) || kpos >= s_len) x = kMaskInf;
          }
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      corr[h] = ex2((m[h] - m_new) * scale_log2);
      const float msc = m_new * scale_log2;
      m[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kTcK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * n + 2 * h + e];
          x = ex2(fmaf(x, scale_log2, -msc));     // masked: 2^-inf = 0
          sum += x;
        }
      l[h] = l[h] * corr[h] + sum;
    }
  };
  // P as the A operand of k step kk (keys 16kk..16kk+15): registers
  // (row, keys) = (r, 2c), (r + 8, 2c), (r, 2c + 8), (r + 8, 2c + 8),
  // each split into bf16 hi + bf16 lo
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kTcK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int at = 4 * (2 * kk + (i >> 1)) + 2 * (i & 1);
        const float x0 = s[at], x1 = s[at + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        p_hi[kk][i] = *reinterpret_cast<const uint32_t*>(&hi);
        p_lo[kk][i] = pack_bf16(x0 - __low2float(hi), x1 - __high2float(hi));
      }
  };

  if (wg == 1) turn_pass(wg);                     // warpgroup 0 goes first
  hopper::mbar_wait(q_full, 0);
  hopper::mbar_wait(k_full, 0);
  hopper::fence_regs(s);
  hopper::wgmma_fence();
  turn_wait(wg);
  issue_qk(0);
  turn_pass(wg);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(s);
  release(k_empty, lane);
  softmax(0);
  pack_p();

  // tile j: S_j = Q K_j^T runs beside O += P_{j-1} V_{j-1}; the softmax of
  // S_j overlaps the second product, and O is rescaled once it is done
  for (int j = 1; j < nk; ++j) {
    const int st = j % kTcStages, pst = (j - 1) % kTcStages;
    hopper::mbar_wait(k_full + 8 * st, (j / kTcStages) & 1);
    hopper::mbar_wait(v_full + 8 * pst, ((j - 1) / kTcStages) & 1);
    hopper::fence_regs(s);
    hopper::fence_regs(o);
    fence_p();
    hopper::wgmma_fence();
    turn_wait(wg);
    issue_qk(st);
    issue_pv(pst);
    turn_pass(wg);
    hopper::wgmma_wait<1>();                      // S_j is in
    hopper::fence_regs(s);
    release(k_empty + 8 * st, lane);
    softmax(j * kTcK);
    hopper::wgmma_wait<0>();                      // and O
    hopper::fence_regs(o);
    fence_p();
    release(v_empty + 8 * pst, lane);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[4 * n] *= corr[0];
      o[4 * n + 1] *= corr[0];
      o[4 * n + 2] *= corr[1];
      o[4 * n + 3] *= corr[1];
    }
    pack_p();
  }
  const int lst = (nk - 1) % kTcStages;
  hopper::mbar_wait(v_full + 8 * lst, ((nk - 1) / kTcStages) & 1);
  hopper::fence_regs(o);
  fence_p();
  hopper::wgmma_fence();
  turn_wait(wg);
  issue_pv(lst);
  if (wg == 0) turn_pass(wg);                     // as many passes as waits
  hopper::wgmma_wait<0>();
  hopper::fence_regs(o);
  fence_p();

  const long long base = (long long)bh * s_len * HD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int r = row0 + 8 * h;
    if (r >= s_len) continue;
    const float denom = fmaxf(sum, 1e-30f);
    uint32_t* dst = reinterpret_cast<uint32_t*>(
        out + base + (long long)r * HD + 2 * quad_col);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      dst[4 * n] = pack_bf16(o[4 * n + 2 * h] / denom,
                             o[4 * n + 2 * h + 1] / denom);
  }
}

// cuTensorMapEncodeTiled, looked up at run time by the CUDA runtime's
// entry-point query, so the library links only the runtime
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// (a function-local static: C++ initialises it once, safely under
// concurrent first calls)
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    return cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                            12000, cudaEnableDefault,
                                            &found) == cudaSuccess &&
                   found == cudaDriverEntryPointSuccess
               ? (EncodeTiled)p
               : nullptr;
  }();
  return fn;
}

// [bh, S, HD] bf16 as a 3-D map with boxes of 64 rows x kBox columns; rows
// past S read as zeros
template <int HD>
bool make_map(CUtensorMap* map, const void* base, int bh, int s_len) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)HD, (cuuint64_t)s_len,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)HD * 2,
                                 (cuuint64_t)s_len * HD * 2};
  const cuuint32_t box[3] = {(cuuint32_t)TcTile<HD>::kBox, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                TcTile<HD>::kRow == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                        : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* out, int bh,
              int s_len, int causal, float scale, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  if (!make_map<HD>(&qmap, q, bh, s_len) || !make_map<HD>(&kmap, k, bh, s_len)
      || !make_map<HD>(&vmap, v, bh, s_len))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = TcTile<HD>::kSmem;
  auto kernel = flash_tc_kernel<HD>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long nq = (s_len + kTcQ - 1) / kTcQ;
  kernel<<<(unsigned int)(nq * bh), kTcThreads, smem, stream>>>(
      qmap, kmap, vmap, (__nv_bfloat16*)out, bh, s_len, causal,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int bh,
               int s_len, int hd, int causal, float scale,
               cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_hd<32, float>(q, k, v, out, bh, s_len, causal, scale, stream);
    case 64: return launch_hd<64, float>(q, k, v, out, bh, s_len, causal, scale, stream);
    case 128: return launch_hd<128, float>(q, k, v, out, bh, s_len, causal, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int bh, int s_len, int hd, int causal, float scale,
                cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_tc<32>(q, k, v, out, bh, s_len, causal, scale, stream);
    case 64: return launch_tc<64>(q, k, v, out, bh, s_len, causal, scale, stream);
    case 128: return launch_tc<128>(q, k, v, out, bh, s_len, causal, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dynamic shared memory of a block of the kernel that takes this head dim
// and dtype (0 f32, 1 bf16); -1 for one it does not take
int flash_attention_smem_bytes(int hd, int dtype) {
  const bool bf16 = dtype == 1;
  if (dtype != 0 && !bf16) return -1;
  switch (hd) {
    case 32: return bf16 ? TcTile<32>::kSmem : smem_floats<32>() * 4;
    case 64: return bf16 ? TcTile<64>::kSmem : smem_floats<64>() * 4;
    case 128: return bf16 ? TcTile<128>::kSmem : smem_floats<128>() * 4;
    default: return -1;
  }
}

// q/k/v/out: [bh, s_len, hd] contiguous, f32 (dtype 0) or bf16 (dtype 1,
// 16-byte aligned); hd in {32, 64, 128}; scale = 1 / sqrt(hd).  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for another
// hd or dtype).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int bh, int s_len, int hd, int causal,
                           int dtype, float scale, void* stream) {
  if (bh <= 0 || s_len <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_f32(q, k, v, out, bh, s_len, hd, causal, scale, st);
  if (dtype == 1)
    return launch_bf16(q, k, v, out, bh, s_len, hd, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
