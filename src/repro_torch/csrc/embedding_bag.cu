// EmbeddingBag for Hopper (sm_90a):
//   out[b, :] = sum_{i in bag b} w[i] * table[ids[i], :].
//
// Replaces the Pallas kernel embedding_bag_sorted
// (src/repro/kernels/embedding_bag/kernel.py:38), which takes one grid step
// per slot: the row ids and bag ids are scalar-prefetched so the DMA of a
// future table row is in flight while the current one is added into the
// bag's VMEM output block, revisited while `seg` repeats.  Hopper has no
// sequential grid to carry a bag across, so two kernels share the work,
// chosen by the wrapper from (num_bags, bag_len, F):
//
// embedding_bag_short -- fixed-length bags of 1..4 slots (the SASRec lookup
// passes [B*S, 1] bags: 204,800 one-slot bags a bulk chunk).  A warp per
// bag would load one id, then one 200-byte row on 25 lanes, and store it:
// two dependent latencies for 200 bytes.  Instead the output is laid out
// flat as (bag, vector) elements, a vector being a float2 where F is even
// and the table 8-byte aligned (F = 50: 25 float2 a row), else one float:
//   * each thread owns kShortUnroll elements, one grid stride apart, so a
//     warp's lanes cover neighbouring elements of one or two rows and its
//     loads and stores coalesce;
//   * it first loads all its elements' ids (and weights) -- the id stream
//     runs ahead of the rows, as the paper's software prefetch does -- then
//     issues every row load before it uses any (ld.global.nc with
//     L1::no_allocate: a table row is read once), then sums and stores;
//   * the grid is what the SMs hold at once (occupancy x SM count), each
//     thread striding over the rest, so no wave tail.
//
// embedding_bag_rows -- everything else: ragged bags (row_ptr) and bags of
// more than 4 slots.  One warp per bag; the warp loads up to 32 of the
// bag's ids and weights, one slot per lane, coalesced, and hands them to
// every lane with __shfl_sync; the row loads of kUnroll slots are issued
// before any of them is added; lanes cover the row.  Capped at 40
// registers, 6 blocks of 8 warps fit an SM.
//
// Both sum in float32 in slot order with fmaf, one thread per output
// element, no atomics: the same inputs give the same bits on every run and
// on both kernels.  A one-slot bag gives fmaf(w, row, 0) = w * row rounded
// once, bit for bit the plain version's product.
//
// Bound: bytes -- each live row the ids name read once, ids and weights read
// once, the output written once, over 3.35 TB/s; two flops per live element
// are nothing beside them.  Random 200-byte rows start anywhere in a 32-byte
// sector, so a row costs 7-8 sectors (224-256 bytes) of DRAM traffic.
//
// Weights: one a slot, or NULL and a number for every slot.
// Semantics: slots with ids < 0 contribute nothing, ids >= V read row V - 1
// (JAX clamps an out-of-range gather), and a bag with no slot is 0.  The
// plain version multiplies table[0] by 0 at a masked slot where these
// kernels skip the slot: the two differ only where row 0 holds an inf or a
// NaN.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 8;
constexpr unsigned kFull = 0xffffffffu;
// longest fixed-length bag of the short kernel (SHORT_BAG_MAX in
// kernels/embedding_bag/ops.py)
constexpr int kShortMax = 4;
// the warp-per-bag kernel capped at 40 registers: 6 blocks (48 warps) an
// SM rather than 4 at its uncapped 56-64
constexpr int kRowsBlocksPerSM = 6;
constexpr int kShortThreads = 256;
constexpr int kShortUnroll = 4;  // elements a thread, one grid stride apart

__device__ __forceinline__ void zero(float& v) { v = 0.0f; }
__device__ __forceinline__ void zero(float2& v) { v = make_float2(0.f, 0.f); }

__device__ __forceinline__ void fma_into(float& acc, float w, float r) {
  acc = fmaf(w, r, acc);
}
__device__ __forceinline__ void fma_into(float2& acc, float w, float2 r) {
  acc.x = fmaf(w, r.x, acc.x);
  acc.y = fmaf(w, r.y, acc.y);
}

// a table row's vector, read-only, not allocated in L1
__device__ __forceinline__ float load_row(const float* p) {
  float r;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];\n" : "=f"(r) : "l"(p));
  return r;
}
__device__ __forceinline__ float2 load_row(const float2* p) {
  float2 r;
  asm("ld.global.nc.L1::no_allocate.v2.f32 {%0, %1}, [%2];\n"
      : "=f"(r.x), "=f"(r.y)
      : "l"(p));
  return r;
}

struct Weights {
  const float* ptr;  // one a slot, or NULL: every slot weighs `value`
  float value;
  __device__ __forceinline__ float at(int64_t slot) const {
    return ptr ? ptr[slot] : value;
  }
};

// fixed-length bags of L <= kShortMax slots, flat over (bag, vector)
template <typename V, int L>
__global__ void __launch_bounds__(kShortThreads)
    embedding_bag_short(const V* __restrict__ table,
                        const int* __restrict__ ids, Weights w,
                        V* __restrict__ out, int64_t n_elems, int row_vecs,
                        int64_t num_rows) {
  const int64_t stride = (int64_t)gridDim.x * kShortThreads;
  for (int64_t e0 = (int64_t)blockIdx.x * kShortThreads + threadIdx.x;
       e0 < n_elems; e0 += kShortUnroll * stride) {
    int id[kShortUnroll][L];
    float wt[kShortUnroll][L];
    int64_t col[kShortUnroll];
    // ids and weights of every element first
#pragma unroll
    for (int u = 0; u < kShortUnroll; ++u) {
      const int64_t e = e0 + u * stride;
      const int64_t bag = e / row_vecs;
      col[u] = e - bag * row_vecs;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        id[u][l] = e < n_elems ? ids[bag * L + l] : -1;
        wt[u][l] = e < n_elems ? w.at(bag * L + l) : 0.f;
      }
    }
    // then every row load, before any is used
    V r[kShortUnroll][L];
#pragma unroll
    for (int u = 0; u < kShortUnroll; ++u)
#pragma unroll
      for (int l = 0; l < L; ++l) {
        zero(r[u][l]);
        if (id[u][l] >= 0) {
          const int64_t row = id[u][l] < num_rows ? id[u][l] : num_rows - 1;
          r[u][l] = load_row(table + row * row_vecs + col[u]);
        }
      }
#pragma unroll
    for (int u = 0; u < kShortUnroll; ++u) {
      const int64_t e = e0 + u * stride;
      V acc;
      zero(acc);
#pragma unroll
      for (int l = 0; l < L; ++l)
        if (id[u][l] >= 0) fma_into(acc, wt[u][l], r[u][l]);
      if (e < n_elems) out[e] = acc;
    }
  }
}

// V is float or float2; a row is row_vecs elements of V
template <typename V>
__global__ void __launch_bounds__(32 * kWarpsPerBlock, kRowsBlocksPerSM)
    embedding_bag_rows(const V* __restrict__ table,
                       const int* __restrict__ ids, Weights w,
                       const int64_t* __restrict__ row_ptr,
                       V* __restrict__ out, int64_t num_bags, int64_t bag_len,
                       int row_vecs, int64_t num_rows) {
  const int64_t bag =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= num_bags) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int64_t start = row_ptr ? row_ptr[bag] : bag * bag_len;
  const int64_t stop = row_ptr ? row_ptr[bag + 1] : start + bag_len;
  for (int v0 = 0; v0 < row_vecs; v0 += 32) {
    const int v = v0 + lane;
    const bool mine = v < row_vecs;
    V acc;
    zero(acc);
    for (int64_t c = start; c < stop; c += 32) {
      // the next 32 slots' ids and weights, one per lane
      int id = -1;
      float wl = 0.0f;
      if (c + lane < stop) {
        id = ids[c + lane];
        wl = w.at(c + lane);
      }
      const int n = stop - c < 32 ? (int)(stop - c) : 32;
      for (int j = 0; j < n; j += kUnroll) {  // j and n are warp-uniform
        V r[kUnroll];
        float wu[kUnroll];
        bool live[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int id_u = __shfl_sync(kFull, id, (j + u) & 31);
          wu[u] = __shfl_sync(kFull, wl, (j + u) & 31);
          live[u] = j + u < n && id_u >= 0;
          zero(r[u]);
          if (live[u] && mine) {
            const int64_t row = id_u < num_rows ? id_u : num_rows - 1;
            r[u] = table[row * row_vecs + v];
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (live[u]) fma_into(acc, wu[u], r[u]);
        }
      }
    }
    if (mine) out[bag * row_vecs + v] = acc;
  }
}

// blocks of the short kernel: as many as the SMs hold at once, no more than
// the elements need
template <typename V, int L>
int launch_short(const V* table, const int* ids, Weights w, V* out,
                 long long num_bags, int row_vecs, long long num_rows,
                 cudaStream_t s) {
  static int resident = 0;  // blocks the card holds at once, per template
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, embedding_bag_short<V, L>, kShortThreads, 0);
    if (err != cudaSuccess) return (int)err;
    resident = sms * per_sm;
  }
  const long long n_elems = num_bags * row_vecs;
  const long long per_block = (long long)kShortThreads * kShortUnroll;
  long long blocks = (n_elems + per_block - 1) / per_block;
  if (blocks > resident) blocks = resident;
  embedding_bag_short<V, L><<<(unsigned)blocks, kShortThreads, 0, s>>>(
      table, ids, w, out, n_elems, row_vecs, num_rows);
  return (int)cudaGetLastError();
}

template <typename V>
int launch(const float* table, const int* ids, Weights w,
           const int64_t* row_ptr, float* out, long long num_bags,
           long long bag_len, int row_vecs, long long num_rows,
           cudaStream_t s) {
  const V* t = reinterpret_cast<const V*>(table);
  V* o = reinterpret_cast<V*>(out);
  if (row_ptr == nullptr && bag_len >= 1 && bag_len <= kShortMax) {
    switch (bag_len) {
      case 1: return launch_short<V, 1>(t, ids, w, o, num_bags, row_vecs,
                                        num_rows, s);
      case 2: return launch_short<V, 2>(t, ids, w, o, num_bags, row_vecs,
                                        num_rows, s);
      case 3: return launch_short<V, 3>(t, ids, w, o, num_bags, row_vecs,
                                        num_rows, s);
      case 4: return launch_short<V, 4>(t, ids, w, o, num_bags, row_vecs,
                                        num_rows, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  const long long blocks = (num_bags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  embedding_bag_rows<V><<<(unsigned)blocks, 32 * kWarpsPerBlock, 0, s>>>(
      t, ids, w, row_ptr, o, num_bags, bag_len, row_vecs, num_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// The kernel is picked from the shape (kernel_route in
// kernels/embedding_bag/ops.py states the same rule): fixed-length bags of
// 1 to kShortMax slots (row_ptr NULL) go to the short-bag kernel, a ragged
// stream (row_ptr) and longer bags to the warp-per-bag kernel.
// weights: one float32 a slot, or NULL (every slot weighs `weight`).
extern "C" int embedding_bag_f32(const float* table, const int* ids,
                                 const float* weights, float weight,
                                 const int64_t* row_ptr,
                                 float* out, long long num_bags,
                                 long long bag_len, int F, long long num_rows,
                                 void* stream) {
  if (num_bags <= 0 || F <= 0) return 0;
  if (num_rows <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Weights w{weights, weight};
  const bool aligned8 =
      ((uintptr_t)table % 8 == 0) && ((uintptr_t)out % 8 == 0);
  if (F % 2 == 0 && aligned8)
    return launch<float2>(table, ids, w, row_ptr, out, num_bags, bag_len,
                          F / 2, num_rows, s);
  return launch<float>(table, ids, w, row_ptr, out, num_bags, bag_len, F,
                       num_rows, s);
}
