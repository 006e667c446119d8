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
// lanes; out is f32[rb, b, L], zeroed by the wrapper, and the caller
// thresholds it at > 0.  A row block with no tile therefore reads 0, as
// the plain version (and the reference's oracle) give; the TPU kernel left
// such rows unwritten.  row_first is not needed.
//
// Exactness.  Tiles and frontier hold only 0 and 1, so every product is 0
// or 1 and every partial sum is an integer no larger than the number of
// tiles of the row times b (far below 2^24).  The tensor cores multiply
// bf16 exactly and add in f32, and f32 adds integers below 2^24 exactly in
// any order, so neither the order inside the mma nor the order of the
// flushes changes a bit: the result is bit-exact against the plain
// version, not merely close.
//
// Indices out of range behave as in the plain version: a negative index is
// wrapped once (i + n); block_col is then clamped into [0, ncb) and a
// block_row still outside [0, rb) drops its tile.
//
// Bound.  The tiles dominate the bytes (nb * b * b * 2), and the work is
// 2 * nb * b * b * L operations: against 989 TFLOP/s (bf16 tensor cores)
// and 3.35 TB/s the bytes bound it for L below about 295 (989 / 3.35),
// i.e. at every width up to the 128 lanes the reference's tests use.  So
// the design reads every tile byte once and keeps the sums in registers.
//
// Design (tensor cores, wgmma m64n{64,128}k16 bf16 -> f32):
//  * the TPU ran its grid in order and carried one output tile in VMEM
//    across the tiles of a row run.  Here a block takes a contiguous run
//    [t0, t1) of the tile list, of a fixed length chosen by the launcher
//    so that the grid is one wave of as many blocks as fit on the card at
//    once (two an SM at L <= 64).  It carries the output tile of the
//    current row block in registers and flushes it when the wrapped row
//    changes and once at the end.  Sorted rows cost one flush per block
//    and row block instead of one atomic per tile and output; unsorted or
//    repeated rows are still right, with more flushes;
//  * a flush adds the non-zero sums to out by f32 atomicAdd (red.global
//    .add, as the result is unused).  At the hub size a block's run spans
//    one or two row blocks, so it flushes once or twice;
//  * a block covers 128 output rows and 64 or 128 lanes of the tile (grid
//    y and z split larger b and L), so at b <= 128 and L <= 128 every tile
//    byte is read from device memory once.  Each of its two warpgroups
//    owns 64 rows: per k step of 16 it issues one wgmma with the tile
//    slice as A (K-major) and the frontier slice as B (MN-major), both
//    read by the tensor cores from shared memory;
//  * 64-column slices of a tile and the matching 64 frontier rows stream
//    through a 3-stage ring in shared memory by 16-byte cp.async (scalar
//    copies where b or L is not a multiple of 8 or the base is not 16-byte
//    aligned), in wgmma's 128-byte swizzle.  The ring is zeroed once, so
//    rows past b, lanes past L and the columns of a short last slice up to
//    the next k step of 16 are zeros;
//  * a slice's products stay in flight while the threads wait for the
//    next slice; they are waited for only before that slice's stage is
//    refilled, or before a flush;
//  * ptxas (CUDA 12.9, sm_90a): 98 registers a thread at N = 64 (two
//    blocks an SM), 150 at N = 128 (one), no spills; shared memory is
//    dynamic: 1 KB of alignment and 3 x (16 KB + 8 or 16 KB) of ring
//    (74,752 bytes at L <= 64, 99,328 above).  chip_smoke.py (b) prints
//    both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;                     // two warpgroups
constexpr int kRows = 128;                        // output rows per block
constexpr int kLanes = 128;                       // output lanes per block
constexpr int kDepth = 64;                        // tile columns per stage
constexpr int kStages = 3;
constexpr int kABytes = kRows * kDepth * 2;       // 16,384
constexpr int kFBlock = kDepth * 128;             // 64 frontier rows x 64 lanes
constexpr int kMaxDevices = 64;

// Staged slices use wgmma's 128-byte swizzle: a slice is column blocks of
// 64 bf16 (128 bytes) a row, and the 16-byte chunk c of row r sits at
// chunk c ^ (r & 7) of its row (the stage is 1024-byte aligned).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}
// byte offset of element (k, lane) of a staged frontier slice
__device__ __forceinline__ uint32_t f_at(int k, int lane) {
  return (lane >> 6) * kFBlock + swz(k, (lane >> 3) & 7) + (lane & 7) * 2;
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], A K-major and B MN-major (lanes
// contiguous) in shared memory
__device__ __forceinline__ void wgmma_tb(
    float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tb(
    float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 1;\n}\n"
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

// N: the lanes a block computes (64, or 128 where L > 64); one block an
// SM at 128.
template <int N>
__global__ void __launch_bounds__(kThreads, N <= 64 ? 2 : 1)
    pull_spmv_wgmma_kernel(const __nv_bfloat16* __restrict__ blocks,
                           const int* __restrict__ block_row,
                           const int* __restrict__ block_col,
                           const __nv_bfloat16* __restrict__ frontier,
                           float* __restrict__ out, long long nb, int b,
                           int lanes, int ncb, int rb, int run, int vec_a,
                           int vec_f) {
  constexpr int kFBytes = (N / 64) * kFBlock;
  constexpr int kStage = kABytes + kFBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s0 = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int band = tid >> 5;                      // the warp's 16 rows
  const int r0 = blockIdx.y * kRows, l0 = blockIdx.z * kLanes;
  const int rows = min(kRows, b - r0), nl = min(kLanes, lanes - l0);
  const int nkc = (b + kDepth - 1) / kDepth;      // column slices a tile
  const long long t0 = (long long)blockIdx.x * run;
  const int units = (int)(min(nb, t0 + run) - t0) * nkc;
  const uint16_t* blocks16 = reinterpret_cast<const uint16_t*>(blocks);
  const uint16_t* front16 = reinterpret_cast<const uint16_t*>(frontier);

  // zero the ring once: padding rows, lanes and columns stay zero
  for (int o = tid * 16; o < kStages * kStage; o += kThreads * 16)
    hopper::st_shared_zero16(s0 + o);
  __syncthreads();

  // unit u = column slice u % nkc of tile t0 + u / nkc, into stage u % kStages
  auto issue = [&](int u) {
    const long long tile = t0 + u / nkc;
    const int kb = (u % nkc) * kDepth, kv = min(kDepth, b - kb);
    const uint32_t sa = s0 + (u % kStages) * kStage;
    const uint32_t sf = sa + kABytes;
    long long col = block_col[tile];
    if (col < 0) col += ncb;
    col = col < 0 ? 0 : (col >= ncb ? ncb - 1 : col);
    const long long a0 = tile * b * b + (long long)r0 * b + kb;
    const long long f0 = (col * b + kb) * lanes + l0;
    if (vec_a) {                                  // 8 threads a row
      const int c = tid & 7;
      if (c < kv / 8)
        for (int r = tid >> 3; r < rows; r += kThreads / 8)
          hopper::cp_async16(sa + swz(r, c),
                             blocks + a0 + (long long)r * b + c * 8);
    } else {
      for (int e = tid; e < rows * kv; e += kThreads) {
        const int r = e / kv, c = e % kv;
        hopper::st_shared_u16(sa + swz(r, c >> 3) + (c & 7) * 2,
                              __ldg(blocks16 + a0 + (long long)r * b + c));
      }
    }
    if (vec_f) {                                  // 16 threads a row
      const int c = tid & 15;
      if (c < nl / 8)
        for (int k = tid >> 4; k < kv; k += kThreads / 16)
          hopper::cp_async16(sf + f_at(k, c * 8),
                             frontier + f0 + (long long)k * lanes + c * 8);
    } else {
      for (int e = tid; e < kv * nl; e += kThreads) {
        const int k = e / nl, c = e % nl;
        hopper::st_shared_u16(sf + f_at(k, c),
                              __ldg(front16 + f0 + (long long)k * lanes + c));
      }
    }
    // a short last slice: zero its columns (and frontier rows) up to the
    // next k step, which a full slice may have left behind
    const int gap = ((kv + 15) & ~15) - kv;
    for (int e = tid; e < rows * gap; e += kThreads) {
      const int r = e / gap, c = kv + e % gap;
      hopper::st_shared_u16(sa + swz(r, c >> 3) + (c & 7) * 2, 0);
    }
    for (int e = tid; e < gap * (N / 8); e += kThreads)
      hopper::st_shared_zero16(sf + f_at(kv + e / (N / 8), e % (N / 8) * 8));
  };

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;

  // this warpgroup's 64 rows times the slice's frontier, k steps of 16:
  // A K-major (SBO: 8 rows of 128 bytes), B MN-major (LBO: the next 64
  // lanes, SBO: the next 8 frontier rows)
  auto compute = [&](int u) {
    const int kv = min(kDepth, b - (u % nkc) * kDepth);
    const uint32_t sa = s0 + (u % kStages) * kStage + wg * 64 * 128;
    const uint32_t sf = s0 + (u % kStages) * kStage + kABytes;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kDepth / 16; ++ks) {
      if (ks * 16 >= kv) break;
      wgmma_tb(acc, hopper::make_desc(sa + ks * 32, 16, 1024, 1),
               hopper::make_desc(sf + ks * 16 * 128, kFBlock, 1024, 1), 1);
    }
    hopper::wgmma_commit();
  };

  // add the carried sums into output row block `row` and clear them; the
  // fragment holds, for n8 piece j, (row g, lanes 8j + 2c, + 1) and
  // (row g + 8, ...) of the warp's band
  auto flush = [&](long long row) {
    float* o = out + (row * b + r0) * (long long)lanes + l0;
    const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int l = j * 8 + c2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = band * 16 + g + 8 * h;
        const float x0 = acc[4 * j + 2 * h], x1 = acc[4 * j + 2 * h + 1];
        acc[4 * j + 2 * h] = acc[4 * j + 2 * h + 1] = 0.f;
        if (r >= rows || l >= nl) continue;
        float* p = o + (long long)r * lanes + l;
        if (x0 != 0.f) atomicAdd(p, x0);
        if (l + 1 < nl && x1 != 0.f) atomicAdd(p + 1, x1);
      }
    }
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < units) issue(s);
    hopper::cp_async_commit();
  }
  long long cur = -1;                             // row block carried
  bool live = false;                              // the current tile counts
  for (int u = 0; u < units; ++u) {
    hopper::wgmma_wait<0>();                      // unit u - 1's products
    hopper::fence_regs(acc);
    hopper::cp_async_wait<kStages - 2>();         // unit u has landed
    hopper::fence_proxy_async();                  // for wgmma's reads
    __syncthreads();                              // and u - 1's stage is free
    if (u + kStages - 1 < units) issue(u + kStages - 1);
    hopper::cp_async_commit();
    if (u % nkc == 0) {
      long long row = block_row[t0 + u / nkc];
      if (row < 0) row += rb;
      live = row >= 0 && row < rb;                // else dropped, as a scatter
      if (live && row != cur) {
        if (cur >= 0) flush(cur);
        cur = row;
      }
    }
    if (live) compute(u);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  if (cur >= 0) flush(cur);
}

}  // namespace

extern "C" {

// dynamic shared memory of a block at L lanes: the ring of tile slices
// and frontier rows, and 1 KB to align the ring for the swizzle
int pull_spmv_smem_bytes(int lanes) {
  return 1024 + kStages * (kABytes + (lanes <= 64 ? 1 : 2) * kFBlock);
}

// blocks: bf16[nb, b, b]; block_row/block_col: int32[nb];
// frontier: bf16[ncb, b, L]; out: f32[rb, b, L], zeroed by the caller.
// Returns cudaGetLastError() after the launch (0 when nb == 0).
int pull_spmv_blocks_launch(const void* blocks, const void* block_row,
                            const void* block_col, const void* frontier,
                            void* out, long long nb, int b, int lanes, int ncb,
                            int rb, void* stream) {
  if (nb <= 0 || b <= 0 || lanes <= 0 || ncb <= 0 || rb <= 0)
    return (int)cudaSuccess;
  const int wide = lanes > 64;
  const int smem = pull_spmv_smem_bytes(lanes);
  auto kernel =
      wide ? pull_spmv_wgmma_kernel<128> : pull_spmv_wgmma_kernel<64>;
  // blocks that fit on the card at once, found once per device and kernel
  // (the queries cost as much host time as a launch), under a lock since
  // the caller may launch from several threads
  static int slots[kMaxDevices][2];
  static std::mutex lock;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int fit;
  {
    std::lock_guard<std::mutex> hold(lock);
    if (slots[dev][wide] == 0) {
      int sms = 0, per_sm = 0;
      if ((err = cudaFuncSetAttribute(
               kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
              cudaSuccess ||
          (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev)) != cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, kernel, kThreads, smem)) != cudaSuccess)
        return (int)err;
      slots[dev][wide] = sms * (per_sm > 0 ? per_sm : 1);
    }
    fit = slots[dev][wide];
  }
  const int row_chunks = (b + kRows - 1) / kRows;
  const int lane_chunks = (lanes + kLanes - 1) / kLanes;
  // one wave: as many runs as blocks fit on the card at once (two an SM
  // at L <= 64), each as long as that makes it
  const long long want = nb * row_chunks * lane_chunks;
  const long long run = (want + fit - 1) / fit;
  const dim3 grid((unsigned int)((nb + run - 1) / run),
                  (unsigned int)row_chunks, (unsigned int)lane_chunks);
  const int vec_a = (uintptr_t)blocks % 16 == 0 && b % 8 == 0;
  const int vec_f = (uintptr_t)frontier % 16 == 0 && lanes % 8 == 0;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)blocks, (const int*)block_row,
      (const int*)block_col, (const __nv_bfloat16*)frontier, (float*)out, nb,
      b, lanes, ncb, rb, (int)run, vec_a, vec_f);
  return (int)cudaGetLastError();
}

}  // extern "C"
