// FindNeighbor chain walks over the CBList block store for Hopper (sm_90a).
//
// Two entry points over one store (keys i32[NB, B] sorted ascending in each
// block and PAD-filled, count i32[NB], nxt i32[NB], NULL = -1):
//
//   * chain_walk_locate: for each query (qsrc, qdst, active), the first
//     block in chain order of vertex clamp(qsrc, 0, NV - 1) holding qdst and
//     the lane it sits in, (NULL, NULL) when the key is absent or the query
//     inactive.  Bit-exact with the lax.while_loop of
//     src/repro/core/updates.py:_locate (a block is searched with
//     searchsorted; in a sorted block the first lane equal to qdst is that
//     lower bound whenever the key is there);
//   * chain_walk_rank: out[v, j] = the key at rank ranks[v, j] of the chain
//     that starts at heads[v] (NULL heads give NULL), walking blocks by
//     their fill count, as the lax.while_loop of
//     src/repro/graph/sampler.py:_sample_neighbors does.
//
// Replaces no Pallas kernel: the JAX package writes both walks as
// lax.while_loops over whole-batch gathers.  It is the paper's FindNeighbor,
// the pointer chase that GastCoCo hides with coroutine prefetch.
//
// Bound: latency.  Each step of a walk is one dependent load of nxt[cur];
// the bytes (a 128-byte key row a step at width 32) are few, so a batch
// takes at least its longest walk's steps times one L2 / DRAM round trip.
// What the design does about it:
//   * every load of a step (the block's keys, count and nxt) depends only on
//     cur and is issued before any is used: one round trip a step, not two;
//   * many walks in flight: a query is a group of G lanes (G = the block's
//     16-byte chunks, at most 32; width 32 gives 8 lanes, four queries a
//     warp), a rank draw one thread, and no grid-stride loop, so one long
//     chain never delays the queries behind it.  The card's resident warps
//     play the part of the paper's coroutines;
//   * a group reads its block as 16-byte vectors (one each at width 32),
//     tests its four keys and takes the first hit with one ballot and one
//     shuffle.  Widths that are not a multiple of 4 read single keys.
// Any block width works: rows wider than R * G chunks are searched in
// passes of R chunk loads a lane.
//
// Measured on an H100 (chip_smoke.py, LiveJournal-size store, width 32):
// 2^20 locate queries in ~3.0 ms, the hub's 3,459-block chain at ~0.9 us
// a step under the batch's load, against ~0.5 ms for its steps at an L2
// hit's 150 ns; the rank walk's hub draws ~0.2 us a step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNull = -1;
constexpr int kThreads = 256;

__device__ __forceinline__ int first_eq(int4 v, int d) {
  return v.x == d ? 0 : v.y == d ? 1 : v.z == d ? 2 : v.w == d ? 3 : 4;
}
__device__ __forceinline__ int first_eq(int v, int d) {
  return v == d ? 0 : 1;
}

template <int W> struct Vec { using T = int4; };
template <> struct Vec<1> { using T = int; };

// G lanes a query, R chunks a lane loaded together, W keys a chunk
template <int G, int R, int W>
__global__ void __launch_bounds__(kThreads)
locate_kernel(const int* __restrict__ keys, const int* __restrict__ nxt,
              const int* __restrict__ v_head, const int* __restrict__ qsrc,
              const int* __restrict__ qdst,
              const unsigned char* __restrict__ active,
              int* __restrict__ fblk, int* __restrict__ flane, long long n,
              int width, int nv) {
  using T = typename Vec<W>::T;
  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1);
  const int gbase = lane & ~(G - 1);
  const unsigned gmask =
      G == 32 ? 0xffffffffu : (((1u << G) - 1u) << gbase);
  const long long q = ((long long)blockIdx.x * kThreads + threadIdx.x) / G;
  if (q >= n) return;                 // a group leaves whole
  const int chunks = width / W;
  const int d = __ldg(qdst + q);
  int cur = kNull;
  if (active[q] && nv > 0) {
    int s = __ldg(qsrc + q);
    s = s < 0 ? 0 : (s >= nv ? nv - 1 : s);
    cur = __ldg(v_head + s);
  }
  int hit_blk = kNull, hit_lane = kNull;
  while (cur != kNull) {
    const T* row = reinterpret_cast<const T*>(keys + (long long)cur * width);
    const int nx = __ldg(nxt + cur);      // issued with the first keys
    int pos = -1;
    for (int base = 0; base < chunks && pos < 0; base += R * G) {
      T v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int c = base + r * G + g;
        if (c < chunks) v[r] = __ldg(row + c);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int c = base + r * G + g;
        const int off = c < chunks ? first_eq(v[r], d) : W;
        const unsigned b = __ballot_sync(gmask, off < W) >> gbase;
        if (b) {
          const int first = __ffs(b) - 1;
          const int o = __shfl_sync(gmask, off, gbase + first);
          pos = (base + r * G + first) * W + o;
          break;
        }
      }
    }
    if (pos >= 0) {
      hit_blk = cur;
      hit_lane = pos;
      break;
    }
    cur = nx;
  }
  if (g == 0) {
    fblk[q] = hit_blk;
    flane[q] = hit_lane;
  }
}

// one thread a draw: the block's count, nxt and the key at the clamped rank
// are loaded together, so a step is one round trip
__global__ void __launch_bounds__(kThreads)
rank_kernel(const int* __restrict__ keys, const int* __restrict__ count,
            const int* __restrict__ nxt, const int* __restrict__ heads,
            const int* __restrict__ ranks, int* __restrict__ out,
            long long n_v, int k, int width) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_v * k) return;
  int cur = __ldg(heads + t / k);
  int rem = __ldg(ranks + t);
  int res = kNull;
  while (cur != kNull) {
    const int lane = rem < 0 ? 0 : (rem > width - 1 ? width - 1 : rem);
    const int cnt = __ldg(count + cur);
    const int nx = __ldg(nxt + cur);
    const int key = __ldg(keys + (long long)cur * width + lane);
    if (rem < cnt) {
      res = key;
      break;
    }
    rem -= cnt;
    cur = nx;
  }
  out[t] = res;
}

int pow2_at_least(long long n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

template <int G, int R, int W>
void launch_locate(const int* keys, const int* nxt, const int* v_head,
                   const int* qsrc, const int* qdst,
                   const unsigned char* active, int* fblk, int* flane,
                   long long n, int width, int nv, cudaStream_t s) {
  const long long threads = n * G;
  const unsigned grid = (unsigned)((threads + kThreads - 1) / kThreads);
  locate_kernel<G, R, W><<<grid, kThreads, 0, s>>>(
      keys, nxt, v_head, qsrc, qdst, active, fblk, flane, n, width, nv);
}

template <int G, int W>
void launch_locate_r(int R, const int* keys, const int* nxt,
                     const int* v_head, const int* qsrc, const int* qdst,
                     const unsigned char* active, int* fblk, int* flane,
                     long long n, int width, int nv, cudaStream_t s) {
  if (R <= 1)
    launch_locate<G, 1, W>(keys, nxt, v_head, qsrc, qdst, active, fblk,
                           flane, n, width, nv, s);
  else if (R == 2)
    launch_locate<G, 2, W>(keys, nxt, v_head, qsrc, qdst, active, fblk,
                           flane, n, width, nv, s);
  else
    launch_locate<G, 4, W>(keys, nxt, v_head, qsrc, qdst, active, fblk,
                           flane, n, width, nv, s);
}

template <int W>
void launch_locate_w(int G, int R, const int* keys, const int* nxt,
                     const int* v_head, const int* qsrc, const int* qdst,
                     const unsigned char* active, int* fblk, int* flane,
                     long long n, int width, int nv, cudaStream_t s) {
#define CW_CASE(GG)                                                        \
  case GG:                                                                 \
    launch_locate_r<GG, W>(R, keys, nxt, v_head, qsrc, qdst, active, fblk, \
                           flane, n, width, nv, s);                        \
    break;
  switch (G) {
    CW_CASE(1) CW_CASE(2) CW_CASE(4) CW_CASE(8) CW_CASE(16)
    default:
      launch_locate_r<32, W>(R, keys, nxt, v_head, qsrc, qdst, active, fblk,
                             flane, n, width, nv, s);
  }
#undef CW_CASE
}

}  // namespace

extern "C" int chain_walk_locate(const int* keys, const int* nxt,
                                 const int* v_head, const int* qsrc,
                                 const int* qdst, const unsigned char* active,
                                 int* fblk, int* flane, long long n,
                                 int width, int nv, void* stream) {
  if (n <= 0) return 0;
  if (width <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // 16-byte chunks when every row starts on a 16-byte boundary
  const int W = (width % 4 == 0 && ((uintptr_t)keys & 15) == 0) ? 4 : 1;
  const int chunks = width / W;
  const int G = pow2_at_least(chunks < 32 ? chunks : 32);
  const int rounds = (chunks + G - 1) / G;
  const int R = pow2_at_least(rounds < 4 ? rounds : 4);
  if (W == 4)
    launch_locate_w<4>(G, R, keys, nxt, v_head, qsrc, qdst, active, fblk,
                       flane, n, width, nv, s);
  else
    launch_locate_w<1>(G, R, keys, nxt, v_head, qsrc, qdst, active, fblk,
                       flane, n, width, nv, s);
  return (int)cudaGetLastError();
}

extern "C" int chain_walk_rank(const int* keys, const int* count,
                               const int* nxt, const int* heads,
                               const int* ranks, int* out, long long n_v,
                               int k, int width, void* stream) {
  if (n_v <= 0 || k <= 0) return 0;
  if (width <= 0) return (int)cudaErrorInvalidValue;
  const long long total = n_v * k;
  const unsigned grid = (unsigned)((total + kThreads - 1) / kThreads);
  rank_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      keys, count, nxt, heads, ranks, out, n_v, k, width);
  return (int)cudaGetLastError();
}
