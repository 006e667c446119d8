// Fused P2->P3 MS-BFS propagate kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/msbfs_propagate.py:
//
//   K1  msbfs_propagate_planes        (pallas_call at msbfs_propagate.py:182,
//       body _kernel)       -> whole_zero_kernel, whole_scatter_kernel,
//                              whole_p3_kernel
//   K2  msbfs_propagate_planes_tiled  (pallas_call at msbfs_propagate.py:300,
//       body _tiled_kernel) -> propagate_tiled_kernel
//
// Both compute, over packed plane words (uint32 bits held in int32 storage),
//     cand[tgt[e]] (+)= msg[e]          (+) = OR, or unsigned MAX
//     new = cand & ~seen;  seen_out = seen | new;  count += popcount(new)
// where K1 gathers msg[e] = frontier[src[e]] itself and K2 reads messages
// that the caller already gathered and bucketed by target row tile.
//
// Bound.  K1: what a level's data makes it move, each input read once and
// each output written once: the src and valid bytes of each slot below
// n_edges, the tgt of each real edge whose message is not zero, each
// distinct frontier row the real edges read, seen, and the outputs new
// and seen_out.  K2: the messages and targets of the real edges (nw * 4 +
// 4 bytes an edge) and three plane arrays (seen read, new and seen_out
// written); pad slots are no work.  Everything is a few bytes of work per
// byte moved, so the card's memory system bounds both kernels, never its
// arithmetic.
//
// Design against that bound:
//  * K1 reads the engine's edge list as it stands: src, tgt and the valid
//    mask unmodified, and the expansion's edge total `n_edges` as a device
//    scalar, so it reads no slot at or after min(n_edges, m) and the host
//    never syncs.  A slot whose valid byte is 0 or whose src or tgt lies
//    outside [0, n_rows) is dropped here, so the caller builds no trash row
//    and no rewritten index arrays.  Its first design ran one item a (slot,
//    word) over the whole padded budget (2^25 slots at rmat20-16), with a
//    64-bit division and a reload of src and tgt for every word, after the
//    wrapper had zeroed the accumulator and copied both plane arrays to
//    append the trash row.  Now three plain launches on one stream:
//    - zero the accumulator (the fresh `new`) and the count;
//    - scatter, one slot a thread, four in flight: src (and valid) read
//      once a slot, the row's nw words in one or two vector loads where nw
//      is 1, 2, 4 or 8 (scalars otherwise), tgt read only for a non-zero
//      message.  A warp aggregates where some live lane's target equals
//      its left neighbour's: the lanes whose targets match
//      (__match_any_sync) reduce their words (__reduce_or_sync or
//      __reduce_max_sync) and the group's lowest lane issues the atomic;
//      other warps issue one atomic a non-zero word;
//    - P3 + popcount over the whole arrays, one count atomic a block.
//    Measured on an H100 at rmat20-16 (chip_smoke.py (c), K1 alone by
//    CUDA-graph replay, means over a wave's 8 levels): aggregating in
//    every warp took B = 64 from 0.31 to 0.093 ms (the dense pull levels
//    from 1.2 to 0.30 ms) but doubled a push level whose targets do not
//    repeat (0.036 to 0.079 ms); aggregating only where neighbours share a
//    target keeps both gains (0.0875 ms; at B = 256 0.44 ms against 0.43
//    in every warp and 1.64 without).  One cooperative launch with grid
//    barriers between the phases, or a zero launch before a cooperative
//    scatter + P3, ran within 1% of the three launches, and an L2
//    access-policy window on the accumulator at B = 256 won 1.6%: below
//    the 3% a more complex path must win by, so neither stayed.
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
constexpr int kUnroll = 4;          // edges in flight a thread
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

// ---------------------------------------------------------------------------
// K1
// ---------------------------------------------------------------------------

struct WholeArgs {
  const unsigned int* frontier;   // [n_rows, nw]
  const unsigned int* seen;       // [n_rows, nw]
  const int* src;                 // [m]
  const int* tgt;                 // [m]
  const unsigned char* valid;     // [m] bool, or null: every slot valid
  const int* n_edges;             // device scalar, or null: m slots
  unsigned int* acc;              // the candidate words; P3 leaves new here
  unsigned int* seen_out;
  int* count;
  long long m;
  long long words;                // n_rows * nw
  int n_rows;
  int nw;
  int vec4;                       // zero and P3 move uint4s
};

// The NW words of one frontier row (NW = 1, 2, 4 or 8, the row aligned to
// min(NW, 4) words), in one or two vector loads.
template <int NW>
__device__ __forceinline__ void load_row(const unsigned int* p,
                                         unsigned int (&w)[NW]) {
  if constexpr (NW == 1) {
    w[0] = __ldg(p);
  } else if constexpr (NW == 2) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = x.x; w[1] = x.y;
  } else {
#pragma unroll
    for (int g = 0; g < NW / 4; ++g) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p) + g);
      w[4 * g] = x.x; w[4 * g + 1] = x.y; w[4 * g + 2] = x.z; w[4 * g + 3] = x.w;
    }
  }
}

// One candidate word's combine.  With `agg` (warp-uniform) the lanes of
// `grp` (one target row) reduce their words in the warp (OR, or unsigned
// MAX) and the group's lowest lane issues the one atomic.
template <int OP>
__device__ __forceinline__ void emit(unsigned int* p, unsigned int v, bool agg,
                                     unsigned int grp, bool leader) {
  if (agg) {
    v = OP == kOpOr ? __reduce_or_sync(grp, v) : __reduce_max_sync(grp, v);
    if (!leader) return;
  }
  if (v) combine<OP>(p, v);
}

// K1, launch 1: acc = 0 and the count = 0.
__global__ void __launch_bounds__(kThreads)
whole_zero_kernel(unsigned int* acc, int* count, long long words, int vec4) {
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  if (vec4) {
    uint4* z = reinterpret_cast<uint4*>(acc);
    for (long long i = tid; i < words / 4; i += stride)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
  } else {
    for (long long i = tid; i < words; i += stride) acc[i] = 0u;
  }
  if (tid == 0) *count = 0;
}

// K1, launch 2: acc[tgt[s]] (+)= frontier[src[s]] over the slots s <
// min(*n_edges, m), dropping a slot whose valid byte is 0, whose src or
// tgt lies outside [0, n_rows) or whose message is zero.  One slot a
// thread, kUnroll in flight; src (and valid) read once a slot, tgt only
// for a non-zero message.  NW > 0: the row's words held in registers;
// NW == 0: any nw, scalar loads.  A warp aggregates a slot group's
// combines (__match_any_sync on the target) only where some live lane's
// target equals its left neighbour's: a pull level's slots come grouped
// by child, a push level's targets rarely repeat.  The loop is
// warp-uniform, so every lane reaches each ballot.
template <int OP, int NW>
__global__ void __launch_bounds__(kThreads)
whole_scatter_kernel(WholeArgs a) {
  constexpr int HW = NW > 0 ? NW : 1;
  const int nw = NW > 0 ? NW : a.nw;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kThreads;
  long long slots = a.m;
  if (a.n_edges != nullptr) {
    const long long n = *a.n_edges;
    slots = n < 0 ? 0 : (n < slots ? n : slots);
  }
  for (long long base = (long long)blockIdx.x * kThreads + (threadIdx.x - lane);
       base < slots; base += stride * kUnroll) {
    int row[kUnroll];
    unsigned int w[kUnroll][HW];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long s = base + lane + u * stride;
      int r = -1;
      if (s < slots && (a.valid == nullptr || __ldcs(a.valid + s)))
        r = __ldcs(a.src + s);
      unsigned int any = 0u;
      if ((unsigned int)r < (unsigned int)a.n_rows) {
        const unsigned int* f = a.frontier + (long long)r * nw;
        if constexpr (NW > 0) {
          load_row<NW>(f, w[u]);
#pragma unroll
          for (int k = 0; k < NW; ++k) any |= w[u][k];
        } else {
          for (int k = 0; k < nw; ++k) any |= __ldg(f + k);
        }
      }
      row[u] = any ? r : -1;
    }
    int t[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int x = row[u] >= 0 ? __ldcs(a.tgt + base + lane + u * stride) : -1;
      t[u] = (unsigned int)x < (unsigned int)a.n_rows ? x : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool live = t[u] >= 0;
      const unsigned int act = __ballot_sync(0xffffffffu, live);
      const int left = __shfl_up_sync(0xffffffffu, t[u], 1);
      const bool agg =
          __ballot_sync(0xffffffffu, live && lane > 0 && left == t[u]) != 0u;
      unsigned int grp = 0u;
      bool leader = true;
      if (live && agg) {
        grp = __match_any_sync(act, t[u]);
        leader = lane == __ffs(grp) - 1;
      }
      if (!live) continue;
      unsigned int* dst = a.acc + (long long)t[u] * nw;
      if constexpr (NW > 0) {
#pragma unroll
        for (int k = 0; k < NW; ++k) emit<OP>(dst + k, w[u][k], agg, grp, leader);
      } else {
        const unsigned int* f = a.frontier + (long long)row[u] * nw;
        for (int k = 0; k < nw; ++k) emit<OP>(dst + k, __ldg(f + k), agg, grp, leader);
      }
    }
  }
}

// K1, launch 3: P3 over the whole arrays, grid-stride: new = acc & ~seen
// written over acc, seen_out = seen | new, one count atomic a block.
__global__ void __launch_bounds__(kThreads)
whole_p3_kernel(WholeArgs a) {
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kThreads;
  int local = 0;
  if (a.vec4) {
    const uint4* s4 = reinterpret_cast<const uint4*>(a.seen);
    uint4* c4 = reinterpret_cast<uint4*>(a.acc);
    uint4* o4 = reinterpret_cast<uint4*>(a.seen_out);
    for (long long i = tid; i < a.words / 4; i += stride) {
      const uint4 s = __ldcs(s4 + i);
      const uint4 c = c4[i];
      const uint4 nf = make_uint4(c.x & ~s.x, c.y & ~s.y, c.z & ~s.z,
                                  c.w & ~s.w);
      c4[i] = nf;
      o4[i] = make_uint4(s.x | nf.x, s.y | nf.y, s.z | nf.z, s.w | nf.w);
      local += __popc(nf.x) + __popc(nf.y) + __popc(nf.z) + __popc(nf.w);
    }
  } else {
    for (long long i = tid; i < a.words; i += stride) {
      const unsigned int s = __ldcs(a.seen + i);
      const unsigned int nf = a.acc[i] & ~s;
      a.acc[i] = nf;
      a.seen_out[i] = s | nf;
      local += __popc(nf);
    }
  }
  const int total = block_sum(local);
  if (threadIdx.x == 0 && total) atomicAdd(a.count, total);
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

// K1's grid: as many CTAs as the scatter instance keeps resident (its
// occupancy at kThreads times the SM count), queried once per device and
// instance; the zero and P3 launches take the same grid.
template <int OP, int NW>
cudaError_t whole_grid(int* grid) {
  static int cached[kMaxDevices];
  static std::mutex lock;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(lock);
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = sm_count(&sms);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, whole_scatter_kernel<OP, NW>, kThreads, 0);
    if (err != cudaSuccess) return err;
    cached[dev] = sms * (per_sm < 1 ? 1 : per_sm);
  }
  *grid = cached[dev];
  return cudaSuccess;
}

// K1's three launches, those whose bit is set in `phases` (1 zero, 2
// scatter, 4 P3), in that order on one stream.
template <int OP, int NW>
cudaError_t launch_whole(const WholeArgs& a, int phases, cudaStream_t st) {
  int grid = 0;
  cudaError_t err = whole_grid<OP, NW>(&grid);
  if (err != cudaSuccess) return err;
  if (phases & 1) {
    whole_zero_kernel<<<grid, kThreads, 0, st>>>(a.acc, a.count, a.words,
                                                 a.vec4);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (phases & 2) {
    whole_scatter_kernel<OP, NW><<<grid, kThreads, 0, st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (phases & 4) {
    whole_p3_kernel<<<grid, kThreads, 0, st>>>(a);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

extern "C" {

// K1.  frontier / seen / new_out / seen_out: [n_rows, nw] words; src / tgt:
// int32[m]; valid: bool[m] or null; n_edges: a device int32 scalar or
// null.  Nothing needs zeroing: the first launch clears new_out (the
// accumulator) and the count.  phases: the launches to run (7: all three;
// a subset for timing one).
int msbfs_propagate_planes_launch(const void* frontier, const void* seen,
                                  const void* src, const void* tgt,
                                  const void* valid, const void* n_edges,
                                  void* new_out, void* seen_out, void* count,
                                  long long m, int n_rows, int nw, int op,
                                  int phases, void* stream) {
  WholeArgs a;
  a.frontier = (const unsigned int*)frontier;
  a.seen = (const unsigned int*)seen;
  a.src = (const int*)src;
  a.tgt = (const int*)tgt;
  a.valid = (const unsigned char*)valid;
  a.n_edges = (const int*)n_edges;
  a.acc = (unsigned int*)new_out;
  a.seen_out = (unsigned int*)seen_out;
  a.count = (int*)count;
  a.m = m;
  a.words = (long long)n_rows * nw;
  a.n_rows = n_rows;
  a.nw = nw;
  const uintptr_t planes = (uintptr_t)seen | (uintptr_t)new_out |
                           (uintptr_t)seen_out;
  a.vec4 = a.words % 4 == 0 && planes % 16 == 0;
  // rows held in registers where nw is 1, 2, 4 or 8 and the frontier is
  // aligned to the vector load; any other nw reads scalars
  const uintptr_t f = (uintptr_t)frontier;
  const int row = nw == 1                               ? 1
                  : nw == 2 && f % 8 == 0               ? 2
                  : (nw == 4 || nw == 8) && f % 16 == 0 ? nw
                                                        : 0;
  cudaStream_t st = (cudaStream_t)stream;
#define K1_CASE(OPV, NWV) \
  if (op == OPV && row == NWV) return (int)launch_whole<OPV, NWV>(a, phases, st);
  K1_CASE(kOpOr, 0) K1_CASE(kOpOr, 1) K1_CASE(kOpOr, 2) K1_CASE(kOpOr, 4)
  K1_CASE(kOpOr, 8) K1_CASE(kOpMax, 0) K1_CASE(kOpMax, 1) K1_CASE(kOpMax, 2)
  K1_CASE(kOpMax, 4) K1_CASE(kOpMax, 8)
#undef K1_CASE
  return (int)cudaErrorInvalidValue;
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
