// Block-sparse boolean pull SpMV for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel K6 of src/repro/kernels/pull_spmv.py:
//
//   pull_spmv_blocks (pull_spmv.py:43; pallas_call at :69, body _kernel)
//
//     out[block_row[i]] += blocks[i] @ frontier[block_col[i]]     (f32)
//
// over bf16 0/1 adjacency tiles blocks[nb, b, b] (CSC orientation: rows are
// children, columns parents) and a bf16 0/1 frontier[ncb, b, L] of L
// lanes; out is f32[rb, b, L] and the caller thresholds it at > 0.
//
// The TPU ran its grid in order and carried one output tile in VMEM across
// the consecutive tiles of a row run, zeroing it at row_first.  Blocks on
// the card run in no order, so each block adds its tile's product into
// out with f32 atomicAdd, and the wrapper allocates out with zeros.  A row
// block with no tile therefore reads 0, as the plain version (and the
// reference's oracle) give; the TPU kernel left such rows unwritten.
// row_first is not needed.
//
// Exactness.  Tiles and frontier hold only 0 and 1, so every product is 0
// or 1 and every partial sum is an integer no larger than the number of
// tiles of the row times b (far below 2^24).  f32 adds integers below 2^24
// exactly, in any order, so the atomics' order changes nothing and the
// result is bit-exact against the plain version, not merely close.  Zero
// partial sums are not added: adding +0.0 to a non-negative sum changes
// no bit.
//
// Indices out of range behave as in the plain version: a negative index is
// wrapped once (i + n); block_col is then clamped into [0, ncb) and a
// block_row still outside [0, rb) drops its tile.
//
// Bound.  The tiles dominate the bytes (nb * b * b * 2), and the work is
// 2 * nb * b * b * L operations: against 989 TFLOP/s (bf16 tensor cores)
// and 3.35 TB/s the bytes bound it for L below about 295 (989 / 3.35),
// i.e. at every width up to the 128 lanes the reference's tests use.
//
// Design, simple first (no tensor cores yet; a plain f32 FMA loop):
//  * grid (nb, ceil(b / 32), ceil(L / 64)): one block per tile, per 32
//    output rows of it and per 64 lanes, 256 threads, 8 outputs a thread;
//  * the k loop stages a 32x32 slice of the tile and the matching 32x64
//    slice of the frontier in shared memory as f32, each element read from
//    device memory once per block; rows and lanes past b or L are masked;
//  * a warp's 32 threads share one output row and take 32 neighbouring
//    lanes, so each tile value is a shared-memory broadcast and each
//    frontier value a conflict-free read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;      // output rows per block
constexpr int kLanes = 64;     // output lanes per block
constexpr int kDepth = 32;     // k slice staged per step
constexpr int kPerThread = kRows * kLanes / kThreads;

__global__ void pull_spmv_kernel(const __nv_bfloat16* __restrict__ blocks,
                                 const int* __restrict__ block_row,
                                 const int* __restrict__ block_col,
                                 const __nv_bfloat16* __restrict__ frontier,
                                 float* __restrict__ out, int b, int lanes,
                                 int ncb, int rb) {
  __shared__ float a_s[kRows][kDepth];
  __shared__ float f_s[kDepth][kLanes];
  const long long tile = blockIdx.x;
  long long row = block_row[tile];
  if (row < 0) row += rb;
  if (row < 0 || row >= rb) return;              // dropped, as a scatter
  long long col = block_col[tile];
  if (col < 0) col += ncb;
  col = col < 0 ? 0 : (col >= ncb ? ncb - 1 : col);
  const int r0 = blockIdx.y * kRows;
  const int l0 = blockIdx.z * kLanes;
  const __nv_bfloat16* a = blocks + tile * b * b;
  const __nv_bfloat16* f = frontier + col * b * lanes;

  float acc[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < b; k0 += kDepth) {
    for (int e = threadIdx.x; e < kRows * kDepth; e += kThreads) {
      const int r = e / kDepth, k = e % kDepth;
      a_s[r][k] = (r0 + r < b && k0 + k < b)
                      ? __bfloat162float(a[(long long)(r0 + r) * b + k0 + k])
                      : 0.f;
    }
    for (int e = threadIdx.x; e < kDepth * kLanes; e += kThreads) {
      const int k = e / kLanes, l = e % kLanes;
      f_s[k][l] = (k0 + k < b && l0 + l < lanes)
                      ? __bfloat162float(f[(long long)(k0 + k) * lanes + l0 + l])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int o = threadIdx.x + j * kThreads;
      const int r = o / kLanes, l = o % kLanes;
      float s = acc[j];
#pragma unroll 8
      for (int k = 0; k < kDepth; ++k) s = fmaf(a_s[r][k], f_s[k][l], s);
      acc[j] = s;
    }
    __syncthreads();
  }

  float* o_tile = out + row * b * lanes;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int o = threadIdx.x + j * kThreads;
    const int r = r0 + o / kLanes, l = l0 + o % kLanes;
    if (r < b && l < lanes && acc[j] != 0.f)
      atomicAdd(&o_tile[(long long)r * lanes + l], acc[j]);
  }
}

}  // namespace

extern "C" {

// blocks: bf16[nb, b, b]; block_row/block_col: int32[nb];
// frontier: bf16[ncb, b, L]; out: f32[rb, b, L], zeroed by the caller.
// Returns cudaGetLastError() after the launch (0 when nb == 0).
int pull_spmv_blocks_launch(const void* blocks, const void* block_row,
                            const void* block_col, const void* frontier,
                            void* out, long long nb, int b, int lanes, int ncb,
                            int rb, void* stream) {
  if (nb <= 0 || b <= 0 || lanes <= 0 || ncb <= 0 || rb <= 0)
    return (int)cudaSuccess;
  const dim3 grid((unsigned int)nb, (unsigned int)((b + kRows - 1) / kRows),
                  (unsigned int)((lanes + kLanes - 1) / kLanes));
  pull_spmv_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)blocks, (const int*)block_row,
      (const int*)block_col, (const __nv_bfloat16*)frontier, (float*)out, b,
      lanes, ncb, rb);
  return (int)cudaGetLastError();
}

}  // extern "C"
