// Paged CSR gather (the HBM reader) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel K5 of src/repro/kernels/csr_gather.py:
//
//   gather_pages (csr_gather.py:32; pallas_call at :48, body _kernel)
//
//     out[i, :] = edges_paged[page_ids[i], :]     int32[m, page]
//
// The TPU kernel scalar-prefetched the page table and let a BlockSpec index
// map issue one HBM->VMEM DMA per work item.  An id outside [0, num_pages)
// gives what the reference's jnp indexing gives: wrapped once if negative
// (id + num_pages, as numpy does), then clamped into [0, num_pages).  The
// kernel never reads outside edges_paged.
//
// Bound.  A copy: m * page * 4 bytes read, the same written, plus the ids;
// no arithmetic, so the card's memory bandwidth bounds it.  Pages of a BFS
// level's neighbour lists are scattered over the edge array, so each page
// is a separate 4 * page byte run (512 bytes at page = 128).
//
// Design against that bound, simple first:
//  * one warp per work item (page), eight items per 256-thread block, a
//    grid-stride loop over items for any m;
//  * 16-byte accesses (int4) when page % 4 == 0 and both base pointers are
//    16-byte aligned: at page = 128 the 32 lanes copy the 512-byte page
//    with one int4 each, neighbouring lanes on neighbouring addresses;
//    otherwise a scalar loop (lane, lane + 32, ...) coalesced the same way;
//  * the warp's lane 0 reads the id and broadcasts it (__shfl_sync), so
//    the page table is read once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void gather_pages_kernel(const int* __restrict__ edges,
                                    const int* __restrict__ page_ids,
                                    int* __restrict__ out, long long num_pages,
                                    long long m, int page, int vec) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long nwarps = (long long)gridDim.x * kWarps;
  for (long long i = warp; i < m; i += nwarps) {
    long long p = 0;
    if (lane == 0) {
      p = page_ids[i];
      if (p < 0) p += num_pages;                 // numpy's wrap, once
      p = p < 0 ? 0 : (p >= num_pages ? num_pages - 1 : p);
    }
    p = __shfl_sync(0xffffffffu, p, 0);
    const int* src = edges + p * page;
    int* dst = out + i * page;
    if (vec) {
      const int4* s4 = reinterpret_cast<const int4*>(src);
      int4* d4 = reinterpret_cast<int4*>(dst);
      for (int j = lane; j < (page >> 2); j += 32) d4[j] = s4[j];
    } else {
      for (int j = lane; j < page; j += 32) dst[j] = src[j];
    }
  }
}

}  // namespace

extern "C" {

// edges: int32[num_pages, page]; page_ids: int32[m]; out: int32[m, page].
// Returns cudaGetLastError() after the launch (0 when m == 0: nothing runs).
int gather_pages_launch(const void* edges, const void* page_ids, void* out,
                        long long num_pages, long long m, int page,
                        void* stream) {
  if (m <= 0 || page <= 0 || num_pages <= 0) return (int)cudaSuccess;
  const uintptr_t any = (uintptr_t)edges | (uintptr_t)out;
  const int vec = (page % 4 == 0) && (any % 16 == 0);
  long long blocks = (m + kWarps - 1) / kWarps;
  const long long cap = 132LL * 64;              // grid-stride past this
  if (blocks > cap) blocks = cap;
  gather_pages_kernel<<<(unsigned int)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const int*)edges, (const int*)page_ids, (int*)out, num_pages, m, page,
      vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
