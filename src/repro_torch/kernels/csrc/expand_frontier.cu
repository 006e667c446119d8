// Frontier expansion for Hopper (sm_90a): the P1 compaction and the P2
// neighbour expansion of one budgeted BFS level, in five launches.
//
// Replaces no TPU kernel.  The reference expands with jnp (src/repro/core/
// bfs_local.py `compact_indices` + `expand_edges`), and the port's first
// version did so with PyTorch ops (`core/bfs_local.py`, kept as the plain
// version).  Those ops made about 20 passes over the whole edge budget in
// int64: an arange, a searchsorted of every slot over the degree prefix,
// gathers of the owner's prefix and degree, casts and three selects, about
// 330 bytes of device memory traffic a slot.  Since the budget only grows
// within a wave, every level after the largest paid for 2^27 slots (Graph500
// scale 22, edge factor 16) or 2^30 (edge factor 64): on an H100 that glue
// took 153 of a wave's 165 ms of levels at scale 22 / 16 and 417 of 431 ms
// at scale 22 / 64, and one host-to-device copy of a scalar a level.
//
// What it computes, for a bool mask over n vertices and a CSR (indptr,
// indices):
//     the active vertices a_0 < a_1 < ... (mask set), their lists flattened
//     in that order into `budget` slots: src[e] = owner, nbr[e] = the
//     neighbour, valid[e] = 1 for e < total, and -1, -1, 0 at and after
//     total = the active vertices' degree sum (which may exceed budget: the
//     caller retries deeper).
//
// Bound.  Each input read once, each output written once: the mask (n
// bytes), indptr (4 (n + 1) bytes), the min(total, budget) neighbour ids
// read (4 bytes each), and the three outputs (9 bytes a slot of the budget)
// and the total.  A few integer operations a byte, so the memory system
// bounds it; at the largest level nearly all of it is the 13 bytes a slot.
//
// Design against that bound:
//  * (a) one pass over the vertices, cut in tiles of 2048 (8 a thread):
//    `tile_reduce_kernel` counts each tile's owners and sums their degrees,
//    `top_scan_kernel` (one block) turns those into exclusive tile offsets
//    and writes the edge total and the owner count on the device, and
//    `compact_kernel` rescans each tile and writes, for each owner k, its
//    inclusive degree prefix cum[k] and (vertex, indptr[vertex] - the
//    exclusive prefix), so that slot e of owner k reads indices[e + that].
//    An owner is an active vertex with a non-empty list: a vertex of degree
//    0 owns no slot, and leaving it out makes cum strictly increasing, so a
//    tile of slots never holds more owners than slots.  Prefixes are int32
//    (the graph's indices are int32, so E < 2^31); slot positions are
//    64-bit.
//  * (b) load-balanced by merge path over the output slots, cut in tiles of
//    1024 (4 a thread): `partition_kernel` binary-searches cum once a tile
//    for the owner of its first slot (no search a slot), and
//    `expand_kernel`, a persistent grid over the tiles, stages the tile's
//    owners (at most 1025) in shared memory, lets each thread find the
//    owner of its first slot there and walk its four slots, reading each
//    list contiguously from `indices`, and writes src / nbr as one 16-byte
//    store and valid as one 4-byte store a thread (a warp writes 512
//    contiguous bytes of each).  A tile at or past the device total writes
//    the pads alone.
//  * Every size comes from the caller's ints (n, budget) and every total
//    stays on the device, so the host never waits; nothing of budget length
//    is written but the three outputs.
// Measured on an H100 at a wave's largest pull level (every vertex active):
// 0.77 ms for 2^27 slots at scale 22 / 16 (67% of the 0.52-ms bound; the
// PyTorch version 17.6 ms) and 2.74 ms for 2^29 slots at scale 22 / 64
// (74%; 66.3 ms); the vertex scan is 0.08-0.11 ms of it.  A tail level's
// pads alone run at 86-91% of their write bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kScanItems = 8;                      // vertices a thread
constexpr int kScanTile = kThreads * kScanItems;   // vertices a tile
constexpr int kTopThreads = 1024;
constexpr int kSlotItems = 4;                      // slots a thread
constexpr int kSlotTile = kThreads * kSlotItems;   // slots a tile
constexpr int kMaxDevices = 64;

// Inclusive scan of the pair (c, s) over the warp.
__device__ __forceinline__ void warp_scan(int& c, int& s) {
  const int lane = threadIdx.x & 31;
  for (int off = 1; off < 32; off <<= 1) {
    const int oc = __shfl_up_sync(0xffffffffu, c, off);
    const int os = __shfl_up_sync(0xffffffffu, s, off);
    if (lane >= off) {
      c += oc;
      s += os;
    }
  }
}

// Exclusive scan of the pair (c, s) over a block of NT threads (NT a
// multiple of 32, at most 1024); the block's sums land in (tc, ts) in every
// thread.  Ends with a barrier, so it may be called again.
template <int NT>
__device__ __forceinline__ void block_scan(int& c, int& s, int& tc, int& ts) {
  __shared__ int wc[NT / 32];
  __shared__ int ws[NT / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int ic = c, is = s;
  warp_scan(ic, is);
  if (lane == 31) {
    wc[warp] = ic;
    ws[warp] = is;
  }
  __syncthreads();
  if (warp == 0) {
    int xc = lane < NT / 32 ? wc[lane] : 0;
    int xs = lane < NT / 32 ? ws[lane] : 0;
    warp_scan(xc, xs);
    if (lane < NT / 32) {
      wc[lane] = xc;
      ws[lane] = xs;
    }
  }
  __syncthreads();
  const int pc = warp ? wc[warp - 1] : 0;
  const int ps = warp ? ws[warp - 1] : 0;
  tc = wc[NT / 32 - 1];
  ts = ws[NT / 32 - 1];
  c = pc + ic - c;
  s = ps + is - s;
  __syncthreads();
}

// Degree of vertex v if it owns slots (masked, non-empty list), else 0.
__device__ __forceinline__ int owned_degree(const unsigned char* __restrict__ mask,
                                            const int* __restrict__ indptr, int v) {
  if (!mask[v]) return 0;
  return __ldg(indptr + v + 1) - __ldg(indptr + v);
}

// (a1) each vertex tile's owner count and degree sum.
__global__ void __launch_bounds__(kThreads)
    tile_reduce_kernel(const unsigned char* __restrict__ mask,
                       const int* __restrict__ indptr, int n,
                       int* __restrict__ tile_cnt, int* __restrict__ tile_sum) {
  const long long v0 = (long long)blockIdx.x * kScanTile + threadIdx.x * kScanItems;
  int c = 0, s = 0;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const long long v = v0 + j;
    if (v < n) {
      const int d = owned_degree(mask, indptr, (int)v);
      c += d > 0;
      s += d;
    }
  }
  int tc, ts;
  block_scan<kThreads>(c, s, tc, ts);
  if (threadIdx.x == 0) {
    tile_cnt[blockIdx.x] = tc;
    tile_sum[blockIdx.x] = ts;
  }
}

// (a2) one block: tile sums to exclusive offsets, in place; the edge total
// and the owner count into scalars[0], scalars[1].
__global__ void __launch_bounds__(kTopThreads)
    top_scan_kernel(int* __restrict__ tile_cnt, int* __restrict__ tile_sum,
                    int n_tiles, int* __restrict__ scalars) {
  int carry_c = 0, carry_s = 0;
  for (int base = 0; base < n_tiles; base += kTopThreads) {
    const int i = base + threadIdx.x;
    int c = i < n_tiles ? tile_cnt[i] : 0;
    int s = i < n_tiles ? tile_sum[i] : 0;
    int tc, ts;
    block_scan<kTopThreads>(c, s, tc, ts);
    if (i < n_tiles) {
      tile_cnt[i] = carry_c + c;
      tile_sum[i] = carry_s + s;
    }
    carry_c += tc;
    carry_s += ts;
  }
  if (threadIdx.x == 0) {
    scalars[0] = carry_s;
    scalars[1] = carry_c;
  }
}

// (a3) each owner k: cum[k] (inclusive degree prefix) and info[k] =
// (vertex, indptr[vertex] - exclusive prefix).
__global__ void __launch_bounds__(kThreads)
    compact_kernel(const unsigned char* __restrict__ mask,
                   const int* __restrict__ indptr, int n,
                   const int* __restrict__ tile_cnt, const int* __restrict__ tile_sum,
                   int* __restrict__ cum, int2* __restrict__ info) {
  const long long v0 = (long long)blockIdx.x * kScanTile + threadIdx.x * kScanItems;
  int d[kScanItems];
  int c = 0, s = 0;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const long long v = v0 + j;
    d[j] = v < n ? owned_degree(mask, indptr, (int)v) : 0;
    c += d[j] > 0;
    s += d[j];
  }
  int tc, ts;
  block_scan<kThreads>(c, s, tc, ts);
  int k = tile_cnt[blockIdx.x] + c;
  int excl = tile_sum[blockIdx.x] + s;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    if (d[j] > 0) {
      const int v = (int)(v0 + j);
      cum[k] = excl + d[j];
      info[k] = make_int2(v, __ldg(indptr + v) - excl);
      ++k;
      excl += d[j];
    }
  }
}

// (b1) part[t] = the owner of slot t * kSlotTile (the first k with cum[k] >
// the slot), or the owner count at and past the total.
__global__ void __launch_bounds__(kThreads)
    partition_kernel(const int* __restrict__ cum, const int* __restrict__ scalars,
                     int* __restrict__ part, long long n_parts) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_parts) return;
  const long long slot = t * kSlotTile;
  const int total = scalars[0];
  const int n_own = scalars[1];
  int lo = n_own;
  if (slot < total) {
    const int e = (int)slot;
    lo = 0;
    int hi = n_own - 1;            // cum[n_own - 1] = total > e
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(cum + mid) > e) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
  }
  part[t] = lo;
}

// Writes four slots from e0 (a multiple of 4; the outputs 16- and 4-byte
// aligned, as the launch checks): one 16-byte store each of src and nbr
// and one 4-byte store of valid where all four lie inside the budget, else
// one by one up to it (the budget's last partial group).
__device__ __forceinline__ void store4(int* __restrict__ src, int* __restrict__ nbr,
                                       unsigned char* __restrict__ valid, long long e0,
                                       long long budget, const int (&s)[kSlotItems],
                                       const int (&t)[kSlotItems],
                                       const unsigned char (&ok)[kSlotItems]) {
  if (e0 + kSlotItems <= budget) {
    *reinterpret_cast<int4*>(src + e0) = make_int4(s[0], s[1], s[2], s[3]);
    *reinterpret_cast<int4*>(nbr + e0) = make_int4(t[0], t[1], t[2], t[3]);
    *reinterpret_cast<uchar4*>(valid + e0) = make_uchar4(ok[0], ok[1], ok[2], ok[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < kSlotItems; ++i) {
    if (e0 + i < budget) {
      src[e0 + i] = s[i];
      nbr[e0 + i] = t[i];
      valid[e0 + i] = ok[i];
    }
  }
}

// (b2) the slots: a persistent grid over tiles of kSlotTile slots.
__global__ void __launch_bounds__(kThreads)
    expand_kernel(const int* __restrict__ indices, const int* __restrict__ cum,
                  const int2* __restrict__ info, const int* __restrict__ part,
                  const int* __restrict__ scalars, int* __restrict__ src,
                  int* __restrict__ nbr, unsigned char* __restrict__ valid,
                  long long budget, long long n_tiles) {
  __shared__ int s_cum[kSlotTile + 1];
  __shared__ int2 s_info[kSlotTile + 1];
  const int total = scalars[0];
  const int n_own = scalars[1];
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long s0 = t * kSlotTile;
    const long long e0 = s0 + threadIdx.x * kSlotItems;
    int sv[kSlotItems], tv[kSlotItems];
    unsigned char ok[kSlotItems];
#pragma unroll
    for (int i = 0; i < kSlotItems; ++i) {
      sv[i] = -1;
      tv[i] = -1;
      ok[i] = 0;
    }
    if (s0 >= total) {             // the same for the whole block
      if (e0 < budget) store4(src, nbr, valid, e0, budget, sv, tv, ok);
      continue;
    }
    const int k0 = part[t];
    const int k1 = min(part[t + 1], n_own - 1);
    const int cnt = k1 - k0 + 1;   // <= kSlotTile + 1: cum strictly increases
    for (int i = threadIdx.x; i < cnt; i += kThreads) {
      s_cum[i] = __ldg(cum + k0 + i);
      s_info[i] = info[k0 + i];
    }
    __syncthreads();
    if (e0 < budget) {
      if (e0 < total) {
        int lo = 0, hi = cnt - 1;  // the owner of e0 lies in [k0, k1]
        const int e = (int)e0;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_cum[mid] > e) {
            hi = mid;
          } else {
            lo = mid + 1;
          }
        }
#pragma unroll
        for (int i = 0; i < kSlotItems; ++i) {
          const long long ei = e0 + i;
          if (ei < total) {
            const int x = (int)ei;
            while (s_cum[lo] <= x) ++lo;
            const int2 o = s_info[lo];
            sv[i] = o.x;
            tv[i] = __ldg(indices + (x + o.y));
            ok[i] = 1;
          }
        }
      }
      store4(src, nbr, valid, e0, budget, sv, tv, ok);
    }
    __syncthreads();               // s_cum / s_info are refilled next tile
  }
}

// The persistent grid of expand_kernel on the current device: SMs x
// resident blocks an SM, queried once per device under a lock.
cudaError_t expand_grid(int* grid) {
  static int cached[kMaxDevices];
  static std::mutex lock;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(lock);
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, expand_kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return err;
    cached[dev] = sms * (per_sm < 1 ? 1 : per_sm);
  }
  *grid = cached[dev];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// mask: bool[n]; indptr: int32[n + 1]; indices: int32[E].  Scratch (no
// zeroing needed): tile_cnt, tile_sum: int32[ceil(n / 2048)]; cum: int32[n];
// info: int32[2 n] (8-byte aligned); part: int32[ceil(budget / 1024) + 1];
// scalars: int32[2], the edge total (returned to the caller) then the owner
// count.  Outputs: src, nbr: int32[budget], 16-byte aligned; valid:
// bool[budget], 4-byte aligned (else cudaErrorMisalignedAddress, launching
// nothing).  phases: 1 the vertex pass (a), 2 the slot pass (b), 3 both;
// (b) alone reads what an earlier (a) left in the scratch.
int expand_frontier_launch(const void* mask, const void* indptr, const void* indices,
                           void* tile_cnt, void* tile_sum, void* cum, void* info,
                           void* part, void* scalars, void* src, void* nbr, void* valid,
                           int n, long long budget, int phases, void* stream) {
  if (((uintptr_t)src | (uintptr_t)nbr) % 16 != 0 || (uintptr_t)valid % 4 != 0) {
    return (int)cudaErrorMisalignedAddress;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int n_vtiles = (n + kScanTile - 1) / kScanTile;
  const long long n_stiles = (budget + kSlotTile - 1) / kSlotTile;
  const unsigned char* m = (const unsigned char*)mask;
  const int* p = (const int*)indptr;
  if (phases & 1) {
    if (n_vtiles > 0) {
      tile_reduce_kernel<<<n_vtiles, kThreads, 0, st>>>(m, p, n, (int*)tile_cnt,
                                                        (int*)tile_sum);
    }
    top_scan_kernel<<<1, kTopThreads, 0, st>>>((int*)tile_cnt, (int*)tile_sum, n_vtiles,
                                               (int*)scalars);
    if (n_vtiles > 0) {
      compact_kernel<<<n_vtiles, kThreads, 0, st>>>(m, p, n, (const int*)tile_cnt,
                                                    (const int*)tile_sum, (int*)cum,
                                                    (int2*)info);
    }
  }
  if ((phases & 2) && n_stiles > 0) {
    const long long n_parts = n_stiles + 1;
    partition_kernel<<<(unsigned)((n_parts + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        (const int*)cum, (const int*)scalars, (int*)part, n_parts);
    int grid = 0;
    const cudaError_t err = expand_grid(&grid);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)(n_stiles < grid ? n_stiles : grid);
    expand_kernel<<<blocks, kThreads, 0, st>>>(
        (const int*)indices, (const int*)cum, (const int2*)info, (const int*)part,
        (const int*)scalars, (int*)src, (int*)nbr, (unsigned char*)valid, budget,
        n_stiles);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
