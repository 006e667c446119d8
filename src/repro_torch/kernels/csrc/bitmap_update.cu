// Fused P3 bitmap-update kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/bitmap_update.py:
//
//   K4  bitmap_update        (pallas_call at bitmap_update.py:101, body _kernel)
//   K3  bitmap_update_batch  (pallas_call at bitmap_update.py:75, body
//       _kernel_batch)
//
// All compute, over packed words (uint32 bits held in int32 storage),
//     new = cand & ~visited;  visited_out = visited | new;  count = popcount(new)
// with one count per plane.  Three forms, two kernels:
//
//  * rows (K3 as the engine holds its planes): int32[n, nw], a row per
//    vertex, plane j = column j; counts[j] = popcount of column j.  It is
//    bitmap_update_batch(cand.T, visited.T) with the outputs transposed
//    back, so the bool-plane engine calls it on its words as they are:
//    no transposes around the call.  Kernel p3_rows_kernel.
//  * planes-major (K3 as the TPU kernel takes it): int32[g, w], plane p =
//    row p.  Kernel p3_planes_kernel, blockIdx.y the plane.
//  * flat (K4): int32[w], one count: the planes-major kernel at g = 1.
//
// Bound.  Each word is read twice (cand, visited) and written twice (new,
// visited_out): 16 bytes for a handful of integer operations, so the card's
// memory bandwidth bounds every form, never its arithmetic.  The bool-plane
// wave at rmat20, B = 64 (n = 1,048,576, nw = 2) moves 33,554,440 bytes a
// call: 0.01002 ms at 3.35 TB/s.  K4 at rmat20 (w = 32,768 words, 512 KB)
// is 0.16 us of bytes; the launch itself dominates it.
//
// Design against that bound:
//  * 128-bit loads and stores over the flat words (four words a vector),
//    where all four arrays are 16-byte aligned (and, planes-major with
//    g > 1, each plane starts aligned: w % 4 == 0); a scalar kernel
//    otherwise, the same code at one word a vector;
//  * a grid of the card's resident CTAs at most (SMs times the kernel's
//    occupancy, asked of the runtime once per device), each thread with
//    kUnroll (2) vectors of each input in flight, loads before stores;
//  * rows form, the counts by column in registers: a thread's vectors
//    i = tid, tid + S, tid + 2S, ... and the grid stride S is a multiple
//    of the period P = nw / gcd(nw, 4) (in vectors), so lane j of every
//    vector the thread takes lies in the one column (4 (tid % P) + j) % nw.
//    A thread keeps one counter a lane.  Where P divides 32 (nw = 1, 2, 4,
//    8, 16, ..., 128: every width the engine runs), the lanes of a warp
//    with one residue fold by xor shuffles, and P lanes of each warp add
//    into the block's per-column sums in shared memory; for any other nw
//    (3, 5, 6, 7, ...; B = 96 gives nw = 3) each thread adds its counters
//    there by shared atomics.  The fewer than four words past the last
//    whole vector go to the grid's first threads, one word each;
//  * the counts written by the kernel itself, no zero fill: each CTA adds
//    its non-zero per-column sums into one accumulator a column in a
//    per-stream scratch (scratch[1 + c]; an atomic a column a CTA), and
//    the last CTA to arrive (an arrival counter in scratch[0]) takes each
//    accumulator into counts by atomicExch(.., 0) and re-zeroes the
//    counter; a grid of one CTA stores its sums directly.  The scratch is
//    zeroed once when made and every launch leaves it zero, ready for the
//    next one on its stream.  Collecting costs the last CTA one load a
//    column; storing a partial a CTA a column instead would cost it
//    (CTAs * ncols / 256) dependent loads a thread, about 25 at nw = 8.
//    The TPU kernel's planes-major form (and K4) ends the same way.
//
// Against the earlier design.  The first port of K3 took only the
// planes-major form (a grid-stride loop, blockIdx.y the plane, an atomic
// a CTA into counts the caller zeroed), so the engine transposed both
// [n_pad, nw] inputs around every call and read strided views after it.
// chip_smoke.py (c), on an H100 80GB HBM3 at 700 W, over the 8 calls of a
// bool-plane wave at rmat20-16, B = 64 (bound 0.01002 ms): that route
// (two transposes + the planes-major wrapper) 0.0665 ms a call, the rows
// wrapper as the engine now calls it 0.0391 ms (both bound by host time);
// the rows kernel alone 0.0099 ms with its inputs warm in the L2 (a call's
// 33.5 MB fits the 50 MB L2), 0.0204 ms with the L2 flushed first (its
// outputs' write-back included); the planes-major kernel alone 0.0093.
// PERF.md section 6 keeps these beside the B = 256 width's.
//
// Count width: a count is at most n * 32 (rows) or w * 32 (planes), which
// must stay below 2^31 (rmat20 at B = 64 has 2^25 per plane).

#include <atomic>

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;       // vectors of each input a thread has in flight
constexpr int kMaxDevices = 64;
// K4's scratch: an arrival counter and one accumulator
constexpr long long kK4ScratchWords = 2;
// the rows kernel's per-column sums live in dynamic shared memory, which a
// launch may take up to 48 KB of without an attribute
constexpr int kMaxRowsCols = 48 * 1024 / 4;

template <int V>
struct alignas(4 * V) Vec {
  unsigned int w[V];
};

// Sum of `v` over the block, valid in thread 0.
__device__ __forceinline__ int block_sum(int v) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = __reduce_add_sync(0xffffffffu, v);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0;
  if (warp == 0) {
    v = lane < kWarps ? warp_sums[lane] : 0;
    v = __reduce_add_sync(0xffffffffu, v);
  }
  __syncthreads();   // warp_sums may be reused by a second call
  return v;
}

// P3 on one vector: new and visited_out into n and o, each lane's
// popcount added to cnt[lane].
template <int V>
__device__ __forceinline__ void p3_vec(const Vec<V>& c, const Vec<V>& v,
                                       Vec<V>* n, Vec<V>* o, int* cnt) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const unsigned int nf = c.w[j] & ~v.w[j];
    n->w[j] = nf;
    o->w[j] = v.w[j] | nf;
    cnt[j] += __popc(nf);
  }
}

// The vectors i, i + stride, ..., i + (kUnroll - 1) * stride below nv of
// each array: loads first, then P3 and the stores.
template <int V>
__device__ __forceinline__ void p3_run(const Vec<V>* __restrict__ c,
                                       const Vec<V>* __restrict__ v,
                                       Vec<V>* __restrict__ n,
                                       Vec<V>* __restrict__ o, long long i,
                                       long long stride, long long nv,
                                       int* cnt) {
  Vec<V> a[kUnroll], b[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long k = i + u * stride;
    if (k < nv) {
      a[u] = c[k];
      b[u] = v[k];
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long k = i + u * stride;
    if (k < nv) {
      Vec<V> nf, vo;
      p3_vec<V>(a[u], b[u], &nf, &vo, cnt);
      n[k] = nf;
      o[k] = vo;
    }
  }
}

// The end of a launch of more than one CTA, called by every thread once
// its block has added its sums into the accumulators scratch[1 + c] (c
// of ncols): the last of the `nblocks` CTAs to arrive (the arrival counter
// scratch[0]) takes each accumulator into counts[c], leaving it 0, and
// re-zeroes the counter.
__device__ void arrive_and_collect(int* __restrict__ counts, int* scratch,
                                   int ncols, unsigned int nblocks) {
  __shared__ int last;
  __threadfence();          // this thread's adds, before the arrival
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(scratch, 1) == (int)nblocks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int c = threadIdx.x; c < ncols; c += blockDim.x)
    counts[c] = atomicExch(scratch + 1 + c, 0);
  if (threadIdx.x == 0) scratch[0] = 0;
}

// Planes-major: grid (nblk, g), CTA (x, p) strides over plane p's w words
// (nv vectors of V words, then the w % V words past them).  K4 is g = 1.
template <int V>
__global__ void __launch_bounds__(kThreads)
p3_planes_kernel(const unsigned int* __restrict__ cand,
                 const unsigned int* __restrict__ vis,
                 unsigned int* __restrict__ new_out,
                 unsigned int* __restrict__ vis_out,
                 int* __restrict__ counts, int* scratch, long long w) {
  const long long base = (long long)blockIdx.y * w;
  const unsigned int* c = cand + base;
  const unsigned int* v = vis + base;
  unsigned int* nf = new_out + base;
  unsigned int* vo = vis_out + base;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long nv = w / V;
  int cnt[V] = {};
  for (long long i = tid; i < nv; i += kUnroll * stride)
    p3_run<V>(reinterpret_cast<const Vec<V>*>(c),
              reinterpret_cast<const Vec<V>*>(v),
              reinterpret_cast<Vec<V>*>(nf), reinterpret_cast<Vec<V>*>(vo),
              i, stride, nv, cnt);
  int local = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) local += cnt[j];
  for (long long i = nv * V + tid; i < w; i += stride) {
    const unsigned int x = c[i] & ~v[i];
    nf[i] = x;
    vo[i] = v[i] | x;
    local += __popc(x);
  }
  const int total = block_sum(local);
  const unsigned int nblocks = gridDim.x * gridDim.y;
  if (nblocks == 1) {
    if (threadIdx.x == 0) counts[0] = total;
    return;
  }
  if (threadIdx.x == 0 && total) atomicAdd(scratch + 1 + blockIdx.y, total);
  arrive_and_collect(counts, scratch, gridDim.y, nblocks);
}

// Rows: the flat n * nw words of int32[n, nw] as nv vectors of V words
// (then the total % V words past them); word k lies in column k % nw.
// period = nw / gcd(nw, V) (vectors); stride, a multiple of it, at most
// the grid's threads.  FOLD: period divides 32, so nw is a power of two
// and a thread's residue is its lane's: masks, no division.
template <int V, bool FOLD>
__global__ void __launch_bounds__(kThreads)
p3_rows_kernel(const unsigned int* __restrict__ cand,
               const unsigned int* __restrict__ vis,
               unsigned int* __restrict__ new_out,
               unsigned int* __restrict__ vis_out, int* __restrict__ counts,
               int* scratch, long long total, int nw, int period,
               long long stride) {
  extern __shared__ int col_sum[];
  for (int c = threadIdx.x; c < nw; c += blockDim.x) col_sum[c] = 0;
  __syncthreads();
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nv = total / V;
  int cnt[V] = {};
  if (tid < stride) {
    for (long long i = tid; i < nv; i += kUnroll * stride)
      p3_run<V>(reinterpret_cast<const Vec<V>*>(cand),
                reinterpret_cast<const Vec<V>*>(vis),
                reinterpret_cast<Vec<V>*>(new_out),
                reinterpret_cast<Vec<V>*>(vis_out), i, stride, nv, cnt);
  }
  // lane j of this thread's vectors lies in column (V * r + j) % nw
  if (FOLD) {
    // xor offsets of period and up join the lanes of one residue
    const int r = threadIdx.x & (period - 1);
#pragma unroll
    for (int j = 0; j < V; ++j)
      for (int off = 16; off >= period; off >>= 1)
        cnt[j] += __shfl_xor_sync(0xffffffffu, cnt[j], off);
    if ((int)(threadIdx.x & 31) < period) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (cnt[j]) atomicAdd(&col_sum[(V * r + j) & (nw - 1)], cnt[j]);
    }
  } else {
    const int r = (int)(tid % period);
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (cnt[j]) atomicAdd(&col_sum[(V * r + j) % nw], cnt[j]);
  }
  // the words past the last whole vector (fewer than V)
  const long long k = nv * V + tid;
  if (tid < V && k < total) {
    const unsigned int x = cand[k] & ~vis[k];
    new_out[k] = x;
    vis_out[k] = vis[k] | x;
    atomicAdd(&col_sum[k % nw], __popc(x));
  }
  __syncthreads();
  const unsigned int nblocks = gridDim.x;
  for (int c = threadIdx.x; c < nw; c += blockDim.x) {
    if (nblocks == 1)
      counts[c] = col_sum[c];
    else if (col_sum[c])
      atomicAdd(scratch + 1 + c, col_sum[c]);
  }
  if (nblocks == 1) return;
  arrive_and_collect(counts, scratch, nw, nblocks);
}

int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// CTAs of `kernel` (kThreads threads, `smem` bytes of dynamic shared
// memory) device `dev` holds at once: SMs times occupancy.
template <typename K>
int resident_ctas(K kernel, int dev, int smem, long long* out) {
  int sms = 0, occ = 0;
  int e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (e) return e;
  e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel,
                                                         kThreads, smem);
  if (e) return e;
  *out = (long long)sms * (occ > 0 ? occ : 1);
  return (int)cudaSuccess;
}

bool aligned16(const void* a, const void* b, const void* c, const void* d) {
  return (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)d) % 16) ==
         0;
}

template <int V>
int planes_launch_v(const void* cand, const void* vis, void* new_out,
                    void* vis_out, void* counts, void* scratch, int g,
                    long long w, cudaStream_t stream) {
  static std::atomic<long long> resident_cache[kMaxDevices];
  int dev = 0;
  int e = (int)cudaGetDevice(&dev);
  if (e) return e;
  long long resident = dev < kMaxDevices ? resident_cache[dev].load() : 0;
  if (resident <= 0) {
    e = resident_ctas(p3_planes_kernel<V>, dev, 0, &resident);
    if (e) return e;
    if (dev < kMaxDevices) resident_cache[dev].store(resident);
  }
  const long long nv = w / V;
  long long blocks = (nv + (long long)kThreads * kUnroll - 1) /
                     ((long long)kThreads * kUnroll);
  const long long cap = resident / g;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const dim3 grid((unsigned int)blocks, (unsigned int)g);
  p3_planes_kernel<V><<<grid, kThreads, 0, stream>>>(
      (const unsigned int*)cand, (const unsigned int*)vis,
      (unsigned int*)new_out, (unsigned int*)vis_out, (int*)counts,
      (int*)scratch, w);
  return (int)cudaGetLastError();
}

int planes_launch(const void* cand, const void* vis, void* new_out,
                  void* vis_out, void* counts, void* scratch,
                  long long scratch_words, int g, long long w, void* stream) {
  if (g <= 0 || g > 65535 || w < 0 || scratch_words < 1LL + g)
    return (int)cudaErrorInvalidValue;
  // every plane starts 16-byte aligned only when w is a multiple of 4
  if (aligned16(cand, vis, new_out, vis_out) && (g == 1 || w % 4 == 0))
    return planes_launch_v<4>(cand, vis, new_out, vis_out, counts, scratch,
                              g, w, (cudaStream_t)stream);
  return planes_launch_v<1>(cand, vis, new_out, vis_out, counts, scratch, g,
                            w, (cudaStream_t)stream);
}

template <int V, bool FOLD>
int rows_launch_v(const void* cand, const void* vis, void* new_out,
                  void* vis_out, void* counts, void* scratch, long long n,
                  int nw, int period, cudaStream_t stream) {
  // the occupancy at up to 256 columns' shared memory is the kernel's
  // (kThreads threads bound it); wider rows ask each time
  constexpr int kCachedCols = 256;
  static std::atomic<long long> resident_cache[kMaxDevices];
  const int smem = nw * 4;
  int dev = 0;
  int e = (int)cudaGetDevice(&dev);
  if (e) return e;
  const bool cached = nw <= kCachedCols && dev < kMaxDevices;
  long long resident = cached ? resident_cache[dev].load() : 0;
  if (resident <= 0) {
    e = resident_ctas(p3_rows_kernel<V, FOLD>, dev,
                      cached ? kCachedCols * 4 : smem, &resident);
    if (e) return e;
    if (cached) resident_cache[dev].store(resident);
  }
  const long long total = n * nw;
  const long long nv = total / V;
  long long blocks = (nv + (long long)kThreads * kUnroll - 1) /
                     ((long long)kThreads * kUnroll);
  if (blocks > resident) blocks = resident;
  // at least `period` threads, so the stride is a whole period
  const long long least = (period + kThreads - 1) / kThreads;
  if (blocks < least) blocks = least;
  if (blocks < 1) blocks = 1;
  const long long threads = blocks * kThreads;
  p3_rows_kernel<V, FOLD><<<(unsigned int)blocks, kThreads, smem, stream>>>(
      (const unsigned int*)cand, (const unsigned int*)vis,
      (unsigned int*)new_out, (unsigned int*)vis_out, (int*)counts,
      (int*)scratch, total, nw, period, threads - threads % period);
  return (int)cudaGetLastError();
}

template <int V>
int rows_launch(const void* cand, const void* vis, void* new_out,
                void* vis_out, void* counts, void* scratch, long long n,
                int nw, cudaStream_t stream) {
  const int period = nw / gcd(nw, V);
  if (32 % period == 0)
    return rows_launch_v<V, true>(cand, vis, new_out, vis_out, counts,
                                  scratch, n, nw, period, stream);
  return rows_launch_v<V, false>(cand, vis, new_out, vis_out, counts,
                                 scratch, n, nw, period, stream);
}

}  // namespace

extern "C" {

// K4: flat words [w].  `scratch`: int32[2] or more, zeroed once before
// its first launch; the kernel leaves it zero again, so launches that
// share it must not overlap (one stream).  Nothing else needs zeroing.
int bitmap_update_launch(const void* cand, const void* vis, void* new_out,
                         void* vis_out, void* count, void* scratch,
                         long long w, void* stream) {
  if (w <= 0) return (int)cudaSuccess;
  return planes_launch(cand, vis, new_out, vis_out, count, scratch,
                       kK4ScratchWords, 1, w, stream);
}

// K3, planes-major words [g, w] (the TPU kernel's form): counts int32[g],
// written by the kernel (no zero fill).  `scratch`: int32[scratch_words]
// as K4's, at least 1 + g words; w may be 0 (the counts come back 0).
int bitmap_update_batch_launch(const void* cand, const void* vis,
                               void* new_out, void* vis_out, void* counts,
                               void* scratch, long long scratch_words, int g,
                               long long w, void* stream) {
  return planes_launch(cand, vis, new_out, vis_out, counts, scratch,
                       scratch_words, g, w, stream);
}

// K3, the engine's rows [n, nw] (plane j = column j): counts int32[nw],
// counts[j] the popcount of column j of new, written by the kernel.
// `scratch`: int32[scratch_words] as K4's, at least 1 + nw words; n may
// be 0.  nw at most 12,288.
int bitmap_update_rows_launch(const void* cand, const void* vis,
                              void* new_out, void* vis_out, void* counts,
                              void* scratch, long long scratch_words,
                              long long n, int nw, void* stream) {
  if (nw <= 0 || nw > kMaxRowsCols || n < 0 || scratch_words < 1LL + nw)
    return (int)cudaErrorInvalidValue;
  if (aligned16(cand, vis, new_out, vis_out))
    return rows_launch<4>(cand, vis, new_out, vis_out, counts, scratch, n,
                          nw, (cudaStream_t)stream);
  return rows_launch<1>(cand, vis, new_out, vis_out, counts, scratch, n, nw,
                        (cudaStream_t)stream);
}

}  // extern "C"
