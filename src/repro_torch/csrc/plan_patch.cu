// Sweep-plan patch for Hopper (sm_90a): a SweepPlan's lanes stream, sorted
// by (dst, src), brought to the next snapshot by the net changes of the
// flushes since it was laid out, instead of laying out every lane again.
//
// Replaces no TPU kernel: the sweep plan is the port's own
// (src/repro_torch/core/engine.py); the JAX package sorts its lanes inside
// each sweep.  Two entry points:
//   * plan_patch_locate: one thread a record (K ~ 10^5), a binary search of
//     the record's src in its destination's segment of the old stream: the
//     lane it deletes (found) or the lane it is inserted before (pos).  Up
//     to log2 of a hub's segment (~17 steps at Graph500 scale 24) dependent
//     reads a thread, all threads independent;
//   * plan_patch_merge: the old src / w streams copied into the new ones,
//     the deleted lanes dropped and the inserts placed.
//
// Bound of the merge: bytes -- the old stream's src and w read once (8 B a
// lane), the new one written once (8 B a lane): at 2^28 lanes 4.3 GB, 1.28
// ms at 3.35 TB/s; the records (a few MB) do not count against it.  So:
//   * a first pass finds, for each tile of kTile old lanes, the records
//     whose position lies before it (a binary search over the sorted
//     positions, one thread a tile boundary, all in flight together), so a
//     tile's CTA starts with two loads and no dependent search;
//   * a tile no record lands in (nearly every one: 10^5 records over 2^28
//     lanes leave ~99.9 % of the 2,048-lane tiles untouched) moves by one
//     shift; a tile with records searches the few of them per lane;
//   * every load and store of a warp covers 128 contiguous bytes (lane
//     t + u * kThreads of the tile for thread t): the shift is any integer,
//     so the new stream's addresses are not 16-byte aligned and 16-byte
//     vectors would leave a warp's stores straddling; 4-byte accesses in
//     full warps fill whole sectors either way.  Eight lanes a thread, all
//     loads issued before the stores, keep enough bytes in flight;
//   * the streams are read and written with evict-first hints (__ldcs /
//     __stcs): they pass through once, and the records' positions and
//     prefix counts (a few hundred KB) stay in L2 for the searches;
//   * the inserts are written by a third pass, one thread a record.
//
// Offsets are int32: a plan refuses a stream past INT32_MAX lanes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;   // old lanes a CTA

// first index in [lo, hi) of the ascending a[] with a[k] >= x (kUpper:
// a[k] > x); hi when there is none
template <bool kUpper>
__device__ __forceinline__ int bound(const int* __restrict__ a, int lo,
                                     int hi, int x) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    const int v = __ldg(a + mid);
    if (kUpper ? v <= x : v < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
locate(const int* __restrict__ src, const int* __restrict__ row_ptr,
       const int* __restrict__ rdst, const int* __restrict__ rsrc, int n,
       int* __restrict__ pos, bool* __restrict__ found) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= n) return;
  const int d = rdst[k], s = rsrc[k];
  const int hi = __ldg(row_ptr + d + 1);
  const int p = bound<false>(src, __ldg(row_ptr + d), hi, s);
  pos[k] = p;
  found[k] = p < hi && __ldg(src + p) == s;
}

// tile_lo[t]: the records whose position lies before old lane t * kTile
__global__ void __launch_bounds__(kThreads)
tile_bounds(const int* __restrict__ pos, int n, int n_bounds,
            int* __restrict__ tile_lo) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_bounds) return;
  const long long start = (long long)t * kTile;
  tile_lo[t] = start > 0x7fffffffLL ? n
                                    : bound<false>(pos, 0, n, (int)start);
}

// old lane i goes to i - (deleted lanes before it) + (inserts at or before
// it), unless a record deletes it
__global__ void __launch_bounds__(kThreads)
copy_lanes(const int* __restrict__ src, const float* __restrict__ w, int V,
           const int* __restrict__ pos, const int* __restrict__ cum_found,
           const int* __restrict__ cum_ins, const int* __restrict__ tile_lo,
           int* __restrict__ new_src, float* __restrict__ new_w) {
  const int a = tile_lo[blockIdx.x], b = tile_lo[blockIdx.x + 1];
  // the last tile may reach past INT32_MAX: a lane's index is formed wide
  const long long t0 = (long long)blockIdx.x * kTile + threadIdx.x;
  int sv[kPerThread];
  float wv[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const long long i = t0 + u * kThreads;
    if (i < V) {
      sv[u] = __ldcs(src + i);
      wv[u] = __ldcs(w + i);
    }
  }
  if (a == b) {                       // no record in this tile: one shift
    const int shift = __ldg(cum_ins + a) - __ldg(cum_found + a);
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const long long i = t0 + u * kThreads;
      if (i < V) {
        __stcs(new_src + i + shift, sv[u]);
        __stcs(new_w + i + shift, wv[u]);
      }
    }
    return;
  }
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    if (t0 + u * kThreads >= V) continue;
    const int i = (int)(t0 + u * kThreads);
    const int lo = bound<false>(pos, a, b, i);      // records before lane i
    const int hi = bound<true>(pos, lo, b, i);      // ... or at it
    const int dropped = __ldg(cum_found + lo);
    if (__ldg(cum_found + hi) != dropped) continue; // a record deletes it
    const int j = i - dropped + __ldg(cum_ins + hi);
    __stcs(new_src + j, sv[u]);
    __stcs(new_w + j, wv[u]);
  }
}

// insert k goes after the kept old lanes before its position and the
// inserts before it in (dst, src) order
__global__ void __launch_bounds__(kThreads)
place_inserts(const int* __restrict__ pos, const int* __restrict__ cum_found,
              const int* __restrict__ cum_ins, const int* __restrict__ rsrc,
              const float* __restrict__ rw, int n,
              int* __restrict__ new_src, float* __restrict__ new_w) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= n) return;
  const int before = cum_ins[k];
  if (cum_ins[k + 1] == before) return;            // not an insert
  const int p = pos[k];
  const int j = p - cum_found[bound<false>(pos, 0, k, p)] + before;
  new_src[j] = rsrc[k];
  new_w[j] = rw[k];
}

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int plan_patch_locate(const int* src, const int* row_ptr,
                                 const int* rdst, const int* rsrc, int* pos,
                                 bool* found, long long n, void* stream) {
  if (n <= 0) return 0;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  locate<<<blocks_for(n), kThreads, 0, s>>>(src, row_ptr, rdst, rsrc, (int)n,
                                            pos, found);
  return (int)cudaGetLastError();
}

// tile_lo: scratch of plan_patch_tiles(V) + 1 ints
extern "C" long long plan_patch_tiles(long long V) {
  return (V + kTile - 1) / kTile;
}

extern "C" int plan_patch_merge(const int* src, const float* w, long long V,
                                const int* pos, const int* cum_found,
                                const int* cum_ins, const int* rsrc,
                                const float* rw, long long n, int* tile_lo,
                                int* new_src, float* new_w, void* stream) {
  if (V < 0 || n < 0 || V > 0x7fffffffLL || n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = plan_patch_tiles(V);
  if (tiles > 0) {
    tile_bounds<<<blocks_for(tiles + 1), kThreads, 0, s>>>(
        pos, (int)n, (int)(tiles + 1), tile_lo);
    copy_lanes<<<(unsigned)tiles, kThreads, 0, s>>>(
        src, w, (int)V, pos, cum_found, cum_ins, tile_lo, new_src, new_w);
  }
  if (n > 0) {
    place_inserts<<<blocks_for(n), kThreads, 0, s>>>(
        pos, cum_found, cum_ins, rsrc, rw, (int)n, new_src, new_w);
  }
  return (int)cudaGetLastError();
}
