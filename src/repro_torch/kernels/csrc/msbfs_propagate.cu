// Fused P2->P3 MS-BFS propagate kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/msbfs_propagate.py:
//
//   K1  msbfs_propagate_planes        (pallas_call at msbfs_propagate.py:182,
//       body _kernel)       -> propagate_scatter_kernel + propagate_p3_kernel
//   K2  msbfs_propagate_planes_tiled  (pallas_call at msbfs_propagate.py:300,
//       body _tiled_kernel) -> propagate_tiled_kernel
//
// Both compute, over packed plane words (uint32 bits held in int32 storage),
//     cand[tgt[e]] (+)= msg[e]          (+) = OR, or unsigned MAX
//     new = cand & ~seen;  seen_out = seen | new;  count += popcount(new)
// where K1 gathers msg[e] = frontier[src[e]] itself and K2 reads messages
// that the caller already gathered and bucketed by target row tile.
//
// Bound.  Per edge slot and word: one 4-byte gather of the frontier word
// (K1; random rows) or one streamed 4-byte message (K2), the 4-byte target
// index, and one atomic read-modify-write on the candidate word; then P3
// reads cand and seen and writes new and seen_out once each (4 plane
// arrays).  Everything is a few bytes of work per byte moved, so the card's
// memory system bounds both kernels, never its arithmetic; the random
// gathers and the atomics' contention on hub rows are what keep them from
// the streaming rate.
//
// Design against that bound, simple first:
//  * K1 runs edge- and word-parallel over a grid-stride loop and skips
//    zero messages before the atomic (most frontier words are zero at the
//    ends of a traversal).  Its candidate array is the fresh `cand` buffer
//    the wrapper zeroed; with the plane arrays of a mid-size graph it stays
//    in the 50 MB L2, where the global atomics resolve.
//  * K2 keeps one row tile's accumulator in shared memory, so the atomics
//    stay on the SM; one CTA loops over its tile's whole chunk run (the TPU
//    kernel carried the accumulator across sequential grid steps instead)
//    and then applies P3 to the tile's rows, reading seen and writing new
//    and seen_out exactly once.
//  * Counts are reduced in the block (warp shuffles) and added with one
//    global atomicAdd per block.
// Warp-aggregated atomics, L2-resident planes for K2's seen, and fusing P3
// into the last CTA of K1 are left for later work.
//
// Count width: the count and the engine's statvec are int32, so n_rows * nw
// * 32 (every bit discovered at once) must stay below 2^31: rmat20 at B=64
// is 2^26.  Indices into the message stream are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOpOr = 0;
constexpr int kOpMax = 1;

__device__ __forceinline__ void combine_global(unsigned int* p, unsigned int v,
                                               int op) {
  if (op == kOpOr) {
    atomicOr(p, v);
  } else {
    atomicMax(p, v);
  }
}

// Sum of `v` over the block, valid in thread 0.
__device__ __forceinline__ int block_sum(int v) {
  __shared__ int warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0;
  if (warp == 0) {
    v = lane < (blockDim.x >> 5) ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// K1, launch A: cand[tgt[e], w] (+)= frontier[src[e], w].
__global__ void propagate_scatter_kernel(const unsigned int* __restrict__ frontier,
                                         const int* __restrict__ src,
                                         const int* __restrict__ tgt,
                                         unsigned int* __restrict__ cand,
                                         long long m, int nw, int n_rows, int op) {
  const long long items = m * nw;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < items;
       i += stride) {
    const long long e = i / nw;
    const int w = (int)(i - e * nw);
    const int s = src[e];
    const int t = tgt[e];
    if (s < 0 || s >= n_rows || t < 0 || t >= n_rows) continue;
    const unsigned int msg = frontier[(long long)s * nw + w];
    if (msg == 0u) continue;
    combine_global(&cand[(long long)t * nw + w], msg, op);
  }
}

// K1, launch B: P3 + popcount over whole plane arrays (cand may alias new).
__global__ void propagate_p3_kernel(const unsigned int* cand,
                                    const unsigned int* __restrict__ seen,
                                    unsigned int* new_out,
                                    unsigned int* __restrict__ seen_out,
                                    int* __restrict__ count, long long words) {
  int local = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < words;
       i += stride) {
    const unsigned int s = seen[i];
    const unsigned int nf = cand[i] & ~s;
    new_out[i] = nf;
    seen_out[i] = s | nf;
    local += __popc(nf);
  }
  const int total = block_sum(local);
  if (threadIdx.x == 0 && total) atomicAdd(count, total);
}

// K2: one CTA per row tile.  chunk_off[t]..chunk_off[t+1] is tile t's run of
// edge chunks in the bucketed stream (msg[L, nw], tgt[L]).
__global__ void propagate_tiled_kernel(const unsigned int* __restrict__ seen,
                                       const unsigned int* __restrict__ msg,
                                       const int* __restrict__ tgt,
                                       const int* __restrict__ chunk_off,
                                       unsigned int* __restrict__ new_out,
                                       unsigned int* __restrict__ seen_out,
                                       int* __restrict__ count, int tile_rows,
                                       int nw, int block_edges, int op) {
  extern __shared__ unsigned int acc[];
  const int tile = blockIdx.x;
  const int tile_words = tile_rows * nw;
  for (int j = threadIdx.x; j < tile_words; j += blockDim.x) acc[j] = 0u;
  __syncthreads();

  const long long row0 = (long long)tile * tile_rows;
  const long long first = (long long)chunk_off[tile] * block_edges * nw;
  const long long last = (long long)chunk_off[tile + 1] * block_edges * nw;
  for (long long i = first + threadIdx.x; i < last; i += blockDim.x) {
    const unsigned int v = msg[i];
    if (v == 0u) continue;
    const long long e = i / nw;
    const int w = (int)(i - e * nw);
    const long long r = (long long)tgt[e] - row0;
    if (r < 0 || r >= tile_rows) continue;   // outside this tile: dropped
    unsigned int* p = &acc[r * nw + w];
    if (op == kOpOr) {
      atomicOr(p, v);
    } else {
      atomicMax(p, v);
    }
  }
  __syncthreads();

  int local = 0;
  const long long base = row0 * nw;
  for (int j = threadIdx.x; j < tile_words; j += blockDim.x) {
    const unsigned int s = seen[base + j];
    const unsigned int nf = acc[j] & ~s;
    new_out[base + j] = nf;
    seen_out[base + j] = s | nf;
    local += __popc(nf);
  }
  const int total = block_sum(local);
  if (threadIdx.x == 0 && total) atomicAdd(count, total);
}

int grid_for(long long items) {
  long long blocks = (items + kThreads - 1) / kThreads;
  // grid-stride loops: a few waves of CTAs per SM are enough
  const long long cap = 132LL * 16;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

extern "C" {

// K1.  `cand` must be zeroed by the caller; it is overwritten with `new`
// (the P3 pass reads each word before it writes the same word).
int msbfs_propagate_planes_launch(const void* frontier, const void* seen,
                                  const void* src, const void* tgt, void* cand,
                                  void* seen_out, void* count, long long m,
                                  int n_rows, int nw, int op, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (m > 0) {
    propagate_scatter_kernel<<<grid_for(m * nw), kThreads, 0, st>>>(
        (const unsigned int*)frontier, (const int*)src, (const int*)tgt,
        (unsigned int*)cand, m, nw, n_rows, op);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long words = (long long)n_rows * nw;
  propagate_p3_kernel<<<grid_for(words), kThreads, 0, st>>>(
      (const unsigned int*)cand, (const unsigned int*)seen, (unsigned int*)cand,
      (unsigned int*)seen_out, (int*)count, words);
  return (int)cudaGetLastError();
}

// K2.  `count` must be zeroed by the caller.
int msbfs_propagate_planes_tiled_launch(const void* seen, const void* msg,
                                        const void* tgt, const void* chunk_off,
                                        void* new_out, void* seen_out, void* count,
                                        int num_tiles, int tile_rows, int nw,
                                        int block_edges, int op, void* stream) {
  const size_t smem = (size_t)tile_rows * nw * sizeof(unsigned int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        propagate_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  propagate_tiled_kernel<<<num_tiles, kThreads, smem, (cudaStream_t)stream>>>(
      (const unsigned int*)seen, (const unsigned int*)msg, (const int*)tgt,
      (const int*)chunk_off, (unsigned int*)new_out, (unsigned int*)seen_out,
      (int*)count, tile_rows, nw, block_edges, op);
  return (int)cudaGetLastError();
}

}  // extern "C"
