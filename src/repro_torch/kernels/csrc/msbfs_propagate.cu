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
// Bound.  K1, per edge slot and word: one 4-byte gather of the frontier
// word (random rows), the 4-byte src and tgt indices and one atomic
// read-modify-write on the candidate word; then P3 reads cand and seen and
// writes new and seen_out once each (4 plane arrays).  K2: the messages and
// targets of the real edges (nw * 4 + 4 bytes an edge) and three plane
// arrays (seen read, new and seen_out written); pad slots are no work.
// Everything is a few bytes of work per byte moved, so the card's memory
// system bounds both kernels, never its arithmetic.
//
// Design against that bound, simple first:
//  * K1 runs edge- and word-parallel over a grid-stride loop and skips
//    zero messages before the atomic (most frontier words are zero at the
//    ends of a traversal).  Its candidate array is the fresh `cand` buffer
//    the wrapper zeroed; with the plane arrays of a mid-size graph it stays
//    in the 50 MB L2, where the global atomics resolve.
//  * K2 keeps one row tile's accumulator in shared memory, so the combines
//    stay on the SM.  Its first design ran one CTA per tile over the tile's
//    whole chunk run.  That lost twice: the bucketing hands every unused
//    trailing chunk of the stream to the last tile, so one CTA scanned
//    about 67 M zero words alone (about 107 ms a late pull level at
//    rmat20-16, B = 64, on an H100), and with 289 tiles on 132 SMs the
//    longest run (a hub tile's) set the time.  It also took one 4-byte
//    word a thread, with a 64-bit division and a reload of tgt per word.
//    Now:
//    - the wrapper hands over each tile's run as [run_first, run_first +
//      run length) and the prefix `work_off` of the run lengths; with the
//      bucketing's real chunk counts a run stops at its real chunks, so
//      no pad chunk is read;
//    - a persistent grid (as many CTAs an SM as the accumulator's shared
//      memory allows, at most four; the SM count queried once per device
//      and cached) cuts the concatenated runs into equal contiguous
//      slices of slots: no CTA scans more than ceil(slots / grid) of
//      them, however the degree is skewed;
//    - a tile whose run lies inside one slice gets P3 straight from shared
//      memory.  A tile split across CTAs: each part flushes its non-zero
//      accumulator words into `new_out` (zeroed by the wrapper, in L2) by
//      global atomicOr / atomicMax, fences, and counts itself in the
//      tile's arrival counter; the last part to arrive applies P3 from
//      `new_out` and resets the counter.  A thread-block cluster sharing
//      the accumulator through distributed shared memory was the other
//      choice; it would cap a tile's parts at the cluster size (8), and a
//      hub tile at a busy level needs more;
//    - one edge a thread: its nw words in one vector load where nw is 1,
//      2 or 4 (uint4 groups where nw % 4 == 0, scalar otherwise), tgt
//      loaded once and only for an edge with a non-zero message, four
//      edges in flight a thread, the stream read with evict-first loads;
//    - P3 and the copy of an empty tile move uint4s where the tile's
//      words allow (scalar otherwise); tiles with no real slot only copy
//      seen to seen_out (new is 0).
//    The wide loads pay on an H100 at rmat20-16, B = 256 (nw = 8), K2
//    alone (chip_smoke.py (c)): uint4 message groups 0.57 ms a level on
//    average against 0.70 for uint2 groups; the uint4 P3 0.076 ms against
//    0.096 for a scalar one on a sparse level, where P3 is nearly all the
//    work.  At B = 64 (nw = 2) the P3 width makes no difference.
//  * Counts are reduced in the block (warp shuffles) and added with one
//    global atomicAdd per block.
// Warp-aggregated atomics and fusing P3 into the last CTA of K1 are left
// for later work.
//
// Count width: the count and the engine's statvec are int32, so n_rows * nw
// * 32 (every bit discovered at once) must stay below 2^31: rmat20 at
// B=256 is 2^28.  Indices into the message stream are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kOpOr = 0;
constexpr int kOpMax = 1;
constexpr int kUnroll = 4;          // K2: edges in flight a thread
constexpr int kMaxBlocksPerSm = 4;  // K2: persistent CTAs an SM
constexpr int kMaxDevices = 64;

template <int OP>
__device__ __forceinline__ void combine(unsigned int* p, unsigned int v) {
  if (OP == kOpOr) {
    atomicOr(p, v);
  } else {
    atomicMax(p, v);
  }
}

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

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------

// VEC consecutive words of one message row, streamed (read once).
template <int VEC>
__device__ __forceinline__ void load_words(const unsigned int* p,
                                           unsigned int (&w)[VEC]) {
  if constexpr (VEC == 4) {
    const uint4 x = __ldcs(reinterpret_cast<const uint4*>(p));
    w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
  } else if constexpr (VEC == 2) {
    const uint2 x = __ldcs(reinterpret_cast<const uint2*>(p));
    w[0] = x.x; w[1] = x.y;
  } else {
    w[0] = __ldcs(p);
  }
}

// acc[tgt[s] - row0] (+)= msg[s] for the slots s in [s0, s1); a target
// outside the tile is dropped.  VEC divides nw; one slot a thread.
template <int OP, int VEC>
__device__ __forceinline__ void scan_slots(unsigned int* acc,
                                           const unsigned int* __restrict__ msg,
                                           const int* __restrict__ tgt,
                                           long long s0, long long s1, int row0,
                                           int tile_rows, int nw) {
  const int groups = nw / VEC;
  for (long long b = s0 + threadIdx.x; b < s1;
       b += (long long)kThreads * kUnroll) {
    unsigned int w[kUnroll][VEC];
    int r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long s = b + (long long)u * kThreads;
      if (s < s1) {
        load_words<VEC>(msg + s * nw, w[u]);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) w[u][k] = 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long s = b + (long long)u * kThreads;
      unsigned int any = groups > 1 ? 1u : 0u;
#pragma unroll
      for (int k = 0; k < VEC; ++k) any |= w[u][k];
      r[u] = (s < s1 && any) ? __ldcs(tgt + s) - row0 : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if ((unsigned int)r[u] >= (unsigned int)tile_rows) continue;
      unsigned int* a = acc + r[u] * nw;
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        if (w[u][k]) combine<OP>(a + k, w[u][k]);
      const long long s = b + (long long)u * kThreads;
      for (int g = 1; g < groups; ++g) {
        unsigned int x[VEC];
        load_words<VEC>(msg + s * nw + g * VEC, x);
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          if (x[k]) combine<OP>(a + g * VEC + k, x[k]);
      }
    }
  }
}

// P3 over one tile's words; `cand` is shared memory, or (FROM_L2) the
// flushed partial sums in new_out, read past L1.  Returns this thread's
// popcount.
template <bool FROM_L2>
__device__ __forceinline__ int p3_tile(const unsigned int* cand,
                                       const unsigned int* __restrict__ seen,
                                       unsigned int* new_out,
                                       unsigned int* __restrict__ seen_out,
                                       int words, int vec4) {
  int local = 0;
  if (vec4) {
    const uint4* s4 = reinterpret_cast<const uint4*>(seen);
    const uint4* c4 = reinterpret_cast<const uint4*>(cand);
    uint4* n4 = reinterpret_cast<uint4*>(new_out);
    uint4* o4 = reinterpret_cast<uint4*>(seen_out);
    for (int j = threadIdx.x; j < words / 4; j += kThreads) {
      const uint4 s = s4[j];
      const uint4 c = FROM_L2 ? __ldcg(c4 + j) : c4[j];
      const uint4 nf = make_uint4(c.x & ~s.x, c.y & ~s.y, c.z & ~s.z,
                                  c.w & ~s.w);
      n4[j] = nf;
      o4[j] = make_uint4(s.x | nf.x, s.y | nf.y, s.z | nf.z, s.w | nf.w);
      local += __popc(nf.x) + __popc(nf.y) + __popc(nf.z) + __popc(nf.w);
    }
  } else {
    for (int j = threadIdx.x; j < words; j += kThreads) {
      const unsigned int s = seen[j];
      const unsigned int nf = (FROM_L2 ? __ldcg(cand + j) : cand[j]) & ~s;
      new_out[j] = nf;
      seen_out[j] = s | nf;
      local += __popc(nf);
    }
  }
  return local;
}

// The block whose slice holds slot s: slice b is [b*W/G, (b+1)*W/G), and
// none is empty when G <= W.
__device__ __forceinline__ long long slice_of(long long s, long long work,
                                              long long grid) {
  return ((s + 1) * grid - 1) / work;
}

// K2.  Tile t's run is the slots [run_first[t], run_first[t] + len_t) of
// the bucketed stream (msg[L, nw], tgt[L]), len_t = work_off[t+1] -
// work_off[t]; the runs laid end to end are cut into min(gridDim.x, slots)
// equal slices, none empty.  new_out and arrivals must be zeroed by the
// caller.
template <int OP, int VEC>
__global__ void __launch_bounds__(kThreads)
propagate_tiled_kernel(const unsigned int* __restrict__ seen,
                       const unsigned int* __restrict__ msg,
                       const int* __restrict__ tgt,
                       const long long* __restrict__ run_first,
                       const long long* __restrict__ work_off,
                       unsigned int* new_out, unsigned int* __restrict__ seen_out,
                       int* count, int* arrivals, int num_tiles, int tile_rows,
                       int nw, int vec4) {
  extern __shared__ __align__(16) unsigned int acc[];
  __shared__ int last_part;
  const int tile_words = tile_rows * nw;
  const long long work = work_off[num_tiles];
  // slices over at most `work` blocks, so that none is empty and a tile's
  // parts are the blocks from its first slot's slice to its last's
  const long long grid = work < gridDim.x ? work : gridDim.x;
  int local = 0;

  // tiles with no slot: new stays 0, seen_out = seen
  for (int t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    if (work_off[t + 1] != work_off[t]) continue;
    const long long base = (long long)t * tile_words;
    if (vec4) {
      const uint4* s4 = reinterpret_cast<const uint4*>(seen + base);
      uint4* o4 = reinterpret_cast<uint4*>(seen_out + base);
      for (int j = threadIdx.x; j < tile_words / 4; j += kThreads) o4[j] = s4[j];
    } else {
      for (int j = threadIdx.x; j < tile_words; j += kThreads)
        seen_out[base + j] = seen[base + j];
    }
  }

  if (blockIdx.x < grid) {
    const long long lo = blockIdx.x * work / grid;
    const long long hi = (blockIdx.x + 1) * work / grid;
    // the last tile whose run starts at or before lo (its run holds lo)
    int a = 0, z = num_tiles;
    while (z - a > 1) {
      const int mid = (a + z) >> 1;
      if (work_off[mid] <= lo) a = mid; else z = mid;
    }
    for (int t = a; t < num_tiles && work_off[t] < hi; ++t) {
      const long long w0 = work_off[t], w1 = work_off[t + 1];
      if (w1 == w0) continue;
      const long long from = w0 > lo ? w0 : lo;
      const long long to = w1 < hi ? w1 : hi;
      const long long parts =
          slice_of(w1 - 1, work, grid) - slice_of(w0, work, grid) + 1;
      for (int j = threadIdx.x; j < tile_words; j += kThreads) acc[j] = 0u;
      __syncthreads();
      scan_slots<OP, VEC>(acc, msg, tgt, run_first[t] + (from - w0),
                          run_first[t] + (to - w0), t * tile_rows, tile_rows,
                          nw);
      __syncthreads();
      const long long base = (long long)t * tile_words;
      if (parts == 1) {
        local += p3_tile<false>(acc, seen + base, new_out + base,
                                seen_out + base, tile_words, vec4);
      } else {
        for (int j = threadIdx.x; j < tile_words; j += kThreads)
          if (acc[j]) combine<OP>(new_out + base + j, acc[j]);
        __threadfence();
        __syncthreads();
        if (threadIdx.x == 0)
          last_part = atomicAdd(arrivals + t, 1) == (int)(parts - 1);
        __syncthreads();
        if (last_part) {
          __threadfence();
          local += p3_tile<true>(new_out + base, seen + base, new_out + base,
                                 seen_out + base, tile_words, vec4);
          if (threadIdx.x == 0) arrivals[t] = 0;
        }
      }
      __syncthreads();   // acc and last_part are reused by the next tile
    }
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

template <int OP, int VEC>
cudaError_t launch_tiled(const void* seen, const void* msg, const void* tgt,
                         const void* run_first, const void* work_off,
                         void* new_out, void* seen_out, void* count,
                         void* arrivals, int num_tiles, int tile_rows, int nw,
                         int vec4, int grid, size_t smem, cudaStream_t st) {
  propagate_tiled_kernel<OP, VEC><<<grid, kThreads, smem, st>>>(
      (const unsigned int*)seen, (const unsigned int*)msg, (const int*)tgt,
      (const long long*)run_first, (const long long*)work_off,
      (unsigned int*)new_out, (unsigned int*)seen_out, (int*)count,
      (int*)arrivals, num_tiles, tile_rows, nw, vec4);
  return cudaGetLastError();
}

// The SM count of the current device, queried once per device (the query
// costs about as much host time as a launch), under a lock since the
// caller may launch from several threads.
cudaError_t sm_count(int* sms) {
  static int cached[kMaxDevices];
  static std::mutex lock;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(lock);
  if (cached[dev] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    // every K2 instance may take a whole block's shared memory, less its
    // static part
    const void* kernels[] = {
        (const void*)propagate_tiled_kernel<kOpOr, 1>,
        (const void*)propagate_tiled_kernel<kOpOr, 2>,
        (const void*)propagate_tiled_kernel<kOpOr, 4>,
        (const void*)propagate_tiled_kernel<kOpMax, 1>,
        (const void*)propagate_tiled_kernel<kOpMax, 2>,
        (const void*)propagate_tiled_kernel<kOpMax, 4>};
    int max_smem = 0;
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    for (const void* k : kernels) {
      cudaFuncAttributes attr;
      err = cudaFuncGetAttributes(&attr, k);
      if (err != cudaSuccess) return err;
      err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 max_smem - (int)attr.sharedSizeBytes);
      if (err != cudaSuccess) return err;
    }
    cached[dev] = n;
  }
  *sms = cached[dev];
  return cudaSuccess;
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

// K2.  run_first / work_off: int64[num_tiles] / int64[num_tiles + 1] (see
// the kernel).  `new_out`, `count` and `arrivals` (int32[num_tiles]) must be
// zeroed by the caller; arrivals are zero again when the kernel ends.
// vec: 4, 2 or 1, the message load width (divides nw, stream aligned to
// it); vec4: the tile words % 4 == 0 and the plane arrays are 16-byte
// aligned.
int msbfs_propagate_planes_tiled_launch(
    const void* seen, const void* msg, const void* tgt, const void* run_first,
    const void* work_off, void* new_out, void* seen_out, void* count,
    void* arrivals, int num_tiles, int tile_rows, int nw, int op, int vec,
    int vec4, void* stream) {
  if (num_tiles <= 0) return (int)cudaSuccess;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)tile_rows * nw * sizeof(unsigned int);
  // as many CTAs as fit an SM at this accumulator size, at most
  // kMaxBlocksPerSm (each SM's 228 KB, 1 KB of it reserved a block)
  int per_sm = (int)((228 * 1024) / (smem + 1024));
  if (per_sm > kMaxBlocksPerSm) per_sm = kMaxBlocksPerSm;
  if (per_sm < 1) per_sm = 1;
  const int grid = sms * per_sm;
  cudaStream_t st = (cudaStream_t)stream;
#define K2_ARGS                                                              \
  seen, msg, tgt, run_first, work_off, new_out, seen_out, count, arrivals,  \
      num_tiles, tile_rows, nw, vec4, grid, smem, st
  if (op == kOpOr) {
    err = vec == 4   ? launch_tiled<kOpOr, 4>(K2_ARGS)
          : vec == 2 ? launch_tiled<kOpOr, 2>(K2_ARGS)
                     : launch_tiled<kOpOr, 1>(K2_ARGS);
  } else {
    err = vec == 4   ? launch_tiled<kOpMax, 4>(K2_ARGS)
          : vec == 2 ? launch_tiled<kOpMax, 2>(K2_ARGS)
                     : launch_tiled<kOpMax, 1>(K2_ARGS);
  }
#undef K2_ARGS
  return (int)err;
}

}  // extern "C"
