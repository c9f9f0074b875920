// GTChain segment sum for Hopper (sm_90a), over a destination-sorted stream:
//   y[r, :] = sum_{j in [row_ptr[r], row_ptr[r + 1])} data_sorted[j, :].
//
// Replaces the Pallas kernel segment_matmul_sorted
// (src/repro/kernels/segment_matmul/kernel.py), which reduces
// destination-sorted 128-edge tiles with a one-hot MXU matmul into a VMEM
// output block.  As there, the permutation into destination order happens
// outside the kernel (the engine's per-snapshot sweep plan, or the one-off
// wrapper's sort + gather), so the kernel reads one contiguous stream.
//
// Bound: bytes -- the stream read once, row_ptr read once, each output row
// written once, over 3.35 TB/s.  One add per item and feature is no work
// for a tensor core, so only the bytes count.
//
// Design:
//   * merge-path split (Merrill & Garland's CSR SpMV): the rows and the
//     items together form one merged sequence, cut into tiles of M merge
//     items by merge_path_partition (kernels/segment_matmul/ops.py).  Every
//     tile costs the same whether its rows are hubs or empty, so RMAT's
//     skew leaves no warp idle and no hub row walked by one warp;
//   * a persistent grid (4 CTAs per SM) walks the tiles; each CTA copies
//     tile w + grid's slice of the stream and of row_ptr into one of two
//     shared-memory stages with cp.async (16-byte copies, 4-byte ones at a
//     misaligned head and tail) while it sums tile w: the paper's prefetch,
//     on the stream.  A stage holds the values from its front and the row
//     ends from its back (48 KB for the two: opted in past the 48 KB
//     default);
//   * within a tile, 256 / FL feature groups of FL lanes (FL = F rounded
//     up to a power of two, at most 32) each walk 24 merge items; the lanes
//     of a group read neighbouring features of the same item.  Each lane
//     sums its run in stream order in float64;
//   * runs are combined across groups by a fixed-tree segmented scan
//     (shuffles inside a warp, then across the 8 warp totals);
//   * measured on an H100 (chip_smoke.py): loading alone and summing alone
//     each take about the bytes bound, and the two overlap only in part, so
//     the kernel sits near 2x its bound; the merge walk's dependent
//     shared-memory loads bound the summing;
//   * a row whose items and end lie in one tile is written there.  Each
//     tile's first row and its trailing partial row go to a float64 carry
//     buffer (head, tail); a second small kernel adds the carries of a row
//     that spans tiles in tile order and writes it once.  No atomics: every
//     row is written exactly once (empty rows as 0) and the same inputs give
//     the same bits on every run;
//   * F > 32 is walked in chunks of 32 features, one tile and chunk at a
//     time; offsets row * F + f are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The Python wrapper mirrors kThreads and kItemsPerGroup in
// csr_items_per_cta (kernels/segment_matmul/ops.py).  24 items a group and
// at least 4 CTAs an SM (64 registers a thread) were the fastest of the
// 8-40 items, 128-256 threads and 2-3 stages tried at the LiveJournal-size
// push stream on an H100.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItemsPerGroup = 24;               // merge items a group walks
constexpr int kMinBlocks = 4;
// one stage holds a tile's values from the front and its row ends from the
// back: items * min(F, 32) + rows <= M * FL = kThreads * kItemsPerGroup
// words, plus 3 for the alignment pad
constexpr int kStageWords = kThreads * kItemsPerGroup + 4;
constexpr int kMaxFeatLanes = 32;

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

struct TileWork {
  int r0, i0, r1, i1;   // first row, first item; row and item after the tile
  int64_t c;            // tile
  int f0, fc;           // feature chunk [f0, f0 + fc)
  int pad;              // stage slot of the tile's first value (alignment)
};

// a tile's bounds (parts[c], parts[c + 1]) as one int4; zeros past the work
__device__ __forceinline__ int4 tile_bounds(const int2* __restrict__ parts,
                                           int64_t w, int n_chunks,
                                           int64_t n_work) {
  if (w >= n_work) return make_int4(0, 0, 0, 0);
  const int64_t c = n_chunks == 1 ? w : w / n_chunks;
  const int2 a = parts[c], b = parts[c + 1];
  return make_int4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ TileWork tile_work(int4 bounds, const float* data,
                                              int64_t w, int F,
                                              int n_chunks) {
  TileWork t;
  t.c = n_chunks == 1 ? w : w / n_chunks;
  const int chunk = (int)(w - t.c * n_chunks);
  t.r0 = bounds.x; t.i0 = bounds.y; t.r1 = bounds.z; t.i1 = bounds.w;
  t.f0 = chunk * kMaxFeatLanes;
  t.fc = n_chunks == 1 ? F : min(kMaxFeatLanes, F - t.f0);
  // the contiguous copy (one chunk) keeps 16-byte global addresses on
  // 16-byte shared slots: the first value lands at its address's phase
  t.pad = n_chunks == 1
              ? (int)(((uintptr_t)(data + (int64_t)t.i0 * F) >> 2) & 3)
              : 0;
  return t;
}

__device__ __forceinline__ int* stage_rowends(float* stage, int nrows) {
  return reinterpret_cast<int*>(stage) + kStageWords - nrows;
}

// issue the cp.async copies of one tile's row ends and values into a stage
__device__ __forceinline__ void load_tile(const TileWork& t,
                                          const float* __restrict__ data,
                                          const int* __restrict__ row_ptr,
                                          float* stage, int F, int n_chunks) {
  const int tid = threadIdx.x;
  int* rowend = stage_rowends(stage, t.r1 - t.r0);
  for (int k = tid; k < t.r1 - t.r0; k += kThreads)
    cp_async4(rowend + k, row_ptr + t.r0 + 1 + k);
  if (n_chunks == 1) {
    const int64_t g0 = (int64_t)t.i0 * F, g1 = (int64_t)t.i1 * F;
    int64_t ga = g0 + ((4 - t.pad) & 3);          // first 16-byte address
    if (ga > g1) ga = g1;
    const int64_t n16 = (g1 - ga) >> 2;
    const int64_t gb = ga + 4 * n16;
    float* s = stage + t.pad;                     // s[g - g0] holds data[g]
    for (int64_t e = g0 + tid; e < ga; e += kThreads)
      cp_async4(s + (e - g0), data + e);
    for (int64_t q = tid; q < n16; q += kThreads)
      cp_async16(s + (ga - g0) + 4 * q, data + ga + 4 * q);
    for (int64_t e = gb + tid; e < g1; e += kThreads)
      cp_async4(s + (e - g0), data + e);
  } else {
    const int n = (t.i1 - t.i0) * t.fc;
    for (int e = tid; e < n; e += kThreads) {
      const int i = e / t.fc;
      cp_async4(stage + e,
                data + (int64_t)(t.i0 + i) * F + t.f0 + (e - i * t.fc));
    }
  }
}

template <int FL>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
csr_sum_tiles(const float* __restrict__ data, const int* __restrict__ row_ptr,
              const int2* __restrict__ parts, double* __restrict__ head,
              double* __restrict__ tail, float* __restrict__ out, int F,
              int n_chunks, int64_t n_tiles) {
  constexpr int G = kThreads / FL;              // feature groups
  extern __shared__ __align__(16) float s_dyn[];  // two stages
  __shared__ int s_wkey[kWarps];
  __shared__ double s_wval[kWarps][FL];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int fl = tid % FL, g = tid / FL;
  const int64_t n_work = n_tiles * n_chunks;
  const int64_t step = gridDim.x;
  int64_t w = blockIdx.x;
  if (w >= n_work) return;
  // two stages: tile w is summed while tile w + step lands; the bounds of
  // a tile are read one iteration before its copies are issued
  TileWork cur = tile_work(tile_bounds(parts, w, n_chunks, n_work), data, w,
                           F, n_chunks);
  load_tile(cur, data, row_ptr, s_dyn, F, n_chunks);
  cp_async_commit();
  int4 next_bounds = tile_bounds(parts, w + step, n_chunks, n_work);
  for (int b = 0; w < n_work; w += step, b ^= 1) {
    const int64_t wn = w + step;
    const TileWork nxt = tile_work(next_bounds, data, wn, F, n_chunks);
    next_bounds = tile_bounds(parts, wn + step, n_chunks, n_work);
    if (wn < n_work)
      load_tile(nxt, data, row_ptr, s_dyn + (b ^ 1) * kStageWords, F,
                n_chunks);
    cp_async_commit();
    cp_async_wait_one();                        // tile w has landed
    __syncthreads();

    const int nrows = cur.r1 - cur.r0, nitems = cur.i1 - cur.i0;
    float* stage = s_dyn + b * kStageWords;
    const float* vals = stage + cur.pad;
    const int* rowend = stage_rowends(stage, nrows);
    const int total = nrows + nitems;
    const int fc = FL == 1 ? 1 : cur.fc;        // F = 1 is the only FL = 1
    const bool live = FL == 1 || fl < cur.fc;
    // this group's merge items [d0, d1): find its start by a diagonal search
    const int d0 = min(g * kItemsPerGroup, total);
    const int d1 = min(d0 + kItemsPerGroup, total);
    int lo = max(0, d0 - nitems), hi = min(d0, nrows);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (rowend[mid] <= cur.i0 + d0 - mid - 1) lo = mid + 1; else hi = mid;
    }
    // item positions relative to the tile's first item
    int row = lo, item = d0 - lo;
    int rend = row < nrows ? rowend[row] - cur.i0 : 0x7fffffff;
    double acc = 0, first_val = 0;
    int first_row = -1;
    const int64_t col = cur.f0 + fl;
#pragma unroll
    for (int k = 0; k < kItemsPerGroup; ++k) {
      if (d0 + k < d1) {
        if (item >= rend) {                       // row `row` ends here
          if (first_row < 0) {
            first_row = row;
            first_val = acc;
          } else if (live) {                      // a row inside the tile
            out[(int64_t)(cur.r0 + row) * F + col] = (float)acc;
          }
          acc = 0;
          ++row;
          rend = row < nrows ? rowend[row] - cur.i0 : 0x7fffffff;
        } else {
          if (live) acc += (double)vals[item * fc + fl];
          ++item;
        }
      }
    }

    // segmented inclusive scan of (row at the run's end, its partial sum)
    int key = row;
    double val = acc;
#pragma unroll
    for (int off = FL; off < 32; off <<= 1) {
      const int k2 = __shfl_up_sync(0xffffffffu, key, off);
      const double v2 = __shfl_up_sync(0xffffffffu, val, off);
      if (lane >= off && k2 == key) val = v2 + val;
    }
    if (lane >= 32 - FL) {
      s_wkey[warp] = key;
      s_wval[warp][fl] = val;
    }
    __syncthreads();
    int pk = -1;                                  // the warps before
    double pv = 0;
    if constexpr (FL == 1) {                      // a shuffle scan of 8 totals
      int qk = lane < kWarps ? s_wkey[lane] : -1;
      double qv = lane < kWarps ? s_wval[lane][0] : 0;
#pragma unroll
      for (int off = 1; off < kWarps; off <<= 1) {
        const int k2 = __shfl_up_sync(0xffffffffu, qk, off);
        const double v2 = __shfl_up_sync(0xffffffffu, qv, off);
        if (lane >= off && k2 == qk) qv = v2 + qv;
      }
      const int k2 = __shfl_sync(0xffffffffu, qk, (warp + 31) & 31);
      const double v2 = __shfl_sync(0xffffffffu, qv, (warp + 31) & 31);
      if (warp > 0) {
        pk = k2;
        pv = v2;
      }
    } else {                                      // in warp order
      for (int q = 0; q < warp; ++q) {
        const int k2 = s_wkey[q];
        const double v2 = s_wval[q][fl];
        pv = k2 == pk ? pv + v2 : v2;
        pk = k2;
      }
    }
    if (pk == key) val = pv + val;
    int ek = __shfl_up_sync(0xffffffffu, key, FL);    // the group before
    double ev = __shfl_up_sync(0xffffffffu, val, FL);
    if (lane < FL) {
      ek = pk;
      ev = pv;
    }
    const int64_t carry = cur.c * F + col;
    if (first_row >= 0 && live) {
      const double v = ek == first_row ? ev + first_val : first_val;
      if (first_row == 0) head[carry] = v;        // may have begun earlier
      else out[(int64_t)(cur.r0 + first_row) * F + col] = (float)v;
    }
    if (g == G - 1 && live) {                     // the tile's trailing row
      if (key == 0) {                             // no row ends in the tile
        head[carry] = val;
        tail[carry] = 0.0;
      } else {
        tail[carry] = val;
      }
    }
    __syncthreads();                              // stage b is free again
    cur = nxt;
  }
}

// the rows that span tiles: tile c's first row, if it ends in tile c, is
// tail[k0 - 1] + head[k0] + ... + head[c] over the tiles k0..c it lies in
__global__ void csr_sum_fixup(const int2* __restrict__ parts,
                              const double* __restrict__ head,
                              const double* __restrict__ tail,
                              float* __restrict__ out, int F,
                              int64_t n_tiles) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_tiles * F) return;
  const int64_t c = t / F;
  const int f = (int)(t - c * F);
  const int r = parts[c].x;
  if (r >= parts[c + 1].x) return;              // its end is in a later tile
  int64_t k0 = c;
  while (k0 > 0 && parts[k0 - 1].x == r) --k0;
  double acc = k0 > 0 ? tail[(k0 - 1) * F + f] : 0.0;
  for (int64_t k = k0; k <= c; ++k) acc += head[k * F + f];
  out[(int64_t)r * F + f] = (float)acc;
}

template <int FL>
int launch_tiles(const float* data, const int* row_ptr, const int2* parts,
                 double* head, double* tail, float* out, int F,
                 int n_chunks, int64_t n_tiles, cudaStream_t s) {
  constexpr size_t smem = sizeof(float) * 2 * kStageWords;
  static int grid_cap = 0;                      // resident CTAs, per template
  if (grid_cap == 0) {
    // dynamic shared memory past 48 KB has to be asked for
    cudaError_t e = cudaFuncSetAttribute(
        csr_sum_tiles<FL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, csr_sum_tiles<FL>,
                                                  kThreads, smem);
    grid_cap = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t work = n_tiles * n_chunks;
  const unsigned grid = (unsigned)(work < grid_cap ? work : grid_cap);
  csr_sum_tiles<FL><<<grid, kThreads, smem, s>>>(data, row_ptr, parts, head,
                                                 tail, out, F, n_chunks,
                                                 n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// carry: float64 scratch of 2 * n_tiles * F (head, then tail); parts:
// int32 [n_tiles + 1, 2] (row, item) from merge_path_partition with
// 2048 / min(next_pow2(F), 32) merge items per tile.
extern "C" int segment_sum_csr_f32(const float* data, const int* row_ptr,
                                   const int* parts, double* carry,
                                   float* out, long long num_rows, int F,
                                   long long n_tiles, void* stream) {
  if (num_rows <= 0 || F <= 0) return 0;
  if (n_tiles <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int2* p = reinterpret_cast<const int2*>(parts);
  double* head = carry;
  double* tail = carry + n_tiles * F;
  const int n_chunks = F > kMaxFeatLanes ? (F + kMaxFeatLanes - 1) /
                                               kMaxFeatLanes : 1;
  int err;
  if (F == 1) err = launch_tiles<1>(data, row_ptr, p, head, tail, out, F, 1, n_tiles, s);
  else if (F == 2) err = launch_tiles<2>(data, row_ptr, p, head, tail, out, F, 1, n_tiles, s);
  else if (F <= 4) err = launch_tiles<4>(data, row_ptr, p, head, tail, out, F, 1, n_tiles, s);
  else if (F <= 8) err = launch_tiles<8>(data, row_ptr, p, head, tail, out, F, 1, n_tiles, s);
  else if (F <= 16) err = launch_tiles<16>(data, row_ptr, p, head, tail, out, F, 1, n_tiles, s);
  else err = launch_tiles<32>(data, row_ptr, p, head, tail, out, F, n_chunks, n_tiles, s);
  if (err != 0) return err;
  const int64_t n_fix = n_tiles * F;
  csr_sum_fixup<<<(unsigned)((n_fix + 255) / 256), 256, 0, s>>>(
      p, head, tail, out, F, n_tiles);
  return (int)cudaGetLastError();
}
