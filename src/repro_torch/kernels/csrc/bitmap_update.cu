// Fused P3 bitmap-update kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/bitmap_update.py:
//
//   K4  bitmap_update        (pallas_call at bitmap_update.py:101, body _kernel)
//   K3  bitmap_update_batch  (pallas_call at bitmap_update.py:75, body
//       _kernel_batch)
//
// Both compute, over packed words (uint32 bits held in int32 storage),
//     new = cand & ~visited;  visited_out = visited | new;  count = popcount(new)
// K4 on one flat word array with one count, K3 on g planes of w words each
// (planes-major, [g, w]) with one count per plane.  One kernel serves both:
// blockIdx.y is the plane (K4 is the case g = 1).
//
// Bound.  Each word is read twice (cand, visited) and written twice (new,
// visited_out): 16 bytes for a handful of integer operations, so the card's
// memory bandwidth bounds the kernel, never its arithmetic.  At rmat20
// (K4: w = 32,768 words, 512 KB in all) the byte bound is 0.16 us and the
// launch itself dominates; K3 at B = 64 (g = 2, w = 1,048,576) moves 32 MB.
//
// Design against that bound, simple first:
//  * a grid-stride loop over 128-bit loads and stores (uint4) where the four
//    arrays are 16-byte aligned and each plane starts aligned, with a scalar
//    tail for the last w % 4 words (and a scalar loop otherwise);
//  * the count is reduced in the warp (__reduce_add_sync), then across the
//    block's warps in shared memory.  K3 adds each block's sum with one
//    atomicAdd into its plane's int32 count, which the caller zeroes.  K4
//    needs no zeroed count: each block stores its partial in a scratch
//    array, and the last block to arrive (an arrival counter the kernel
//    resets) sums them and stores the count; a grid of one block stores
//    its sum directly.  Its wrapper takes optional `out=` buffers, so the
//    single-source runner allocates nothing a level.  At rmat20 (w =
//    32,768) the kernel sits at launch latency: on an H100 (chip_smoke.py
//    (c), CUDA-graph replay) it takes 0.0034 ms against 0.0021 for the
//    first design's atomics into a count zeroed beforehand (the zero fill
//    is a launch of its own), and one CTA of 1024 threads took 0.0074 ms.
//    Its wrapper, three allocations and a zero fill before, took 7x the
//    kernel (0.0302 against 0.0042 ms).
//
// Count width: a count is at most w * 32, which must stay below 2^31 (rmat20
// at B = 64 has w * 32 = 2^25 per plane).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// the grid's cap: a few waves of CTAs per SM (132 SMs) over all planes
constexpr long long kMaxBlocks = 132LL * 16;

// Sum of `v` over the block, valid in thread 0.
__device__ __forceinline__ int block_sum(int v) {
  __shared__ int warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = __reduce_add_sync(0xffffffffu, v);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0;
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_sums[lane] : 0;
    v = __reduce_add_sync(0xffffffffu, v);
  }
  __syncthreads();   // warp_sums may be reused by a second call
  return v;
}

__device__ __forceinline__ unsigned int p3_word(unsigned int c, unsigned int v,
                                                unsigned int* v_out, int* local) {
  const unsigned int nf = c & ~v;
  *v_out = v | nf;
  *local += __popc(nf);
  return nf;
}

// grid (blocks_per_plane, g): block (x, p) strides over plane p's w words.
// counts: K3 (scratch null) adds each block's popcount to its plane's
// count, which the caller zeroes.  K4 (g = 1, scratch int32[1 + grid]:
// an arrival counter, zero between launches, then one partial a block)
// writes the count itself: one block stores its sum; with more, each block
// stores its partial, and the last to arrive sums them, stores the count
// and resets the counter.
__global__ void p3_update_kernel(const unsigned int* __restrict__ cand,
                                 const unsigned int* __restrict__ vis,
                                 unsigned int* __restrict__ new_out,
                                 unsigned int* __restrict__ vis_out,
                                 int* __restrict__ counts, int* scratch,
                                 long long w, int vec) {
  const long long base = (long long)blockIdx.y * w;
  const unsigned int* c = cand + base;
  const unsigned int* v = vis + base;
  unsigned int* nf = new_out + base;
  unsigned int* vo = vis_out + base;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  int local = 0;
  long long head = 0;
  if (vec) {
    const long long w4 = w >> 2;
    const uint4* c4 = reinterpret_cast<const uint4*>(c);
    const uint4* v4 = reinterpret_cast<const uint4*>(v);
    uint4* nf4 = reinterpret_cast<uint4*>(nf);
    uint4* vo4 = reinterpret_cast<uint4*>(vo);
    for (long long i = tid; i < w4; i += stride) {
      const uint4 a = c4[i];
      const uint4 b = v4[i];
      uint4 n, o;
      n.x = p3_word(a.x, b.x, &o.x, &local);
      n.y = p3_word(a.y, b.y, &o.y, &local);
      n.z = p3_word(a.z, b.z, &o.z, &local);
      n.w = p3_word(a.w, b.w, &o.w, &local);
      nf4[i] = n;
      vo4[i] = o;
    }
    head = w4 << 2;
  }
  for (long long i = head + tid; i < w; i += stride) {
    unsigned int o;
    nf[i] = p3_word(c[i], v[i], &o, &local);
    vo[i] = o;
  }

  __shared__ int last;
  const int total = block_sum(local);
  if (threadIdx.x == 0) {
    last = 0;
    if (scratch == nullptr) {
      if (total) atomicAdd(&counts[blockIdx.y], total);
    } else if (gridDim.x == 1) {
      counts[0] = total;
    } else {
      scratch[1 + blockIdx.x] = total;
      __threadfence();
      last = atomicAdd(scratch, 1) == (int)gridDim.x - 1;
    }
  }
  __syncthreads();
  if (last) {
    __threadfence();
    int part = 0;
    for (unsigned int b = threadIdx.x; b < gridDim.x; b += blockDim.x)
      part += __ldcg(scratch + 1 + b);
    const int sum = block_sum(part);
    if (threadIdx.x == 0) {
      counts[0] = sum;
      scratch[0] = 0;
    }
  }
}

int launch(const void* cand, const void* vis, void* new_out, void* vis_out,
           void* counts, void* scratch, int g, long long w, void* stream) {
  if (g <= 0 || w <= 0) return (int)cudaSuccess;
  const uintptr_t any = (uintptr_t)cand | (uintptr_t)vis | (uintptr_t)new_out |
                        (uintptr_t)vis_out;
  // every plane starts 16-byte aligned only when w is a multiple of 4
  const int vec = (any % 16 == 0) && (g == 1 || w % 4 == 0);
  const long long per_thread = vec ? 4 : 1;
  long long blocks = (w + kThreads * per_thread - 1) / (kThreads * per_thread);
  // grid-stride loops: a few waves of CTAs per SM over all planes suffice
  long long cap = kMaxBlocks / g;
  if (cap < 1) cap = 1;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const dim3 grid((unsigned int)blocks, (unsigned int)g);
  p3_update_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned int*)cand, (const unsigned int*)vis,
      (unsigned int*)new_out, (unsigned int*)vis_out, (int*)counts,
      (int*)scratch, w, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4: flat words [w].  `scratch`: int32[1 + 132 * 16], zeroed once before
// its first launch; the kernel leaves it zero again, so launches that share
// it must not overlap (one stream).  Nothing else needs zeroing.
int bitmap_update_launch(const void* cand, const void* vis, void* new_out,
                         void* vis_out, void* count, void* scratch,
                         long long w, void* stream) {
  return launch(cand, vis, new_out, vis_out, count, scratch, 1, w, stream);
}

// K3: planes-major words [g, w]; `counts` (g int32) must be zeroed by the
// caller.
int bitmap_update_batch_launch(const void* cand, const void* vis, void* new_out,
                               void* vis_out, void* counts, int g, long long w,
                               void* stream) {
  return launch(cand, vis, new_out, vis_out, counts, nullptr, g, w, stream);
}

}  // extern "C"
