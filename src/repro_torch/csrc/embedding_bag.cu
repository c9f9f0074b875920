// EmbeddingBag for Hopper (sm_90a):
//   out[b, :] = sum_{i in bag b} w[i] * table[ids[i], :].
//
// Replaces the Pallas kernel embedding_bag_sorted
// (src/repro/kernels/embedding_bag/kernel.py), which takes one grid step per
// slot: the row ids and bag ids are scalar-prefetched so the DMA of a future
// table row is in flight while the current one is added into the bag's VMEM
// output block, revisited while `seg` repeats.  Hopper has no sequential
// grid to carry a bag across, so a bag is one warp's work instead:
//
//   * layout: one warp per bag; bag b's slots are row_ptr[b] .. row_ptr[b+1]
//     (or b*L .. (b+1)*L for fixed-length bags, row_ptr == NULL);
//   * prefetch: the warp first loads up to 32 of the bag's ids and weights,
//     one slot per lane, coalesced, and hands them to every lane with
//     __shfl_sync -- the id stream runs ahead of the row loads, as the
//     paper's software prefetch does;
//   * loads: the row loads of kUnroll slots are issued before any of them is
//     added, so kUnroll rows are in flight per warp; lanes cover the row,
//     as float2 where F is even and the table 8-byte aligned (F = 50: a
//     200-byte row is 25 lanes' float2);
//   * accumulation: float32, in slot order, one lane per output element, no
//     atomics: the same inputs give the same bits on every run.  A one-slot
//     bag gives fmaf(w, row, 0) = w * row rounded once, bit for bit the plain
//     version's product.
//
// Bound: bytes -- each live row the ids name read once, ids and weights read
// once, the output written once, over 3.35 TB/s; two flops per live element
// are nothing beside them.  The row loads land at data-dependent addresses,
// so latency, not bandwidth, is what the unrolled loads fight.
//
// Semantics: slots with ids < 0 contribute nothing, ids >= V read row V - 1
// (JAX clamps an out-of-range gather), and a bag with no slot is 0.  The
// plain version multiplies table[0] by 0 at a masked slot where this kernel
// skips the slot: the two differ only where row 0 holds an inf or a NaN.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void zero(float& v) { v = 0.0f; }
__device__ __forceinline__ void zero(float2& v) { v = make_float2(0.f, 0.f); }

__device__ __forceinline__ void fma_into(float& acc, float w, float r) {
  acc = fmaf(w, r, acc);
}
__device__ __forceinline__ void fma_into(float2& acc, float w, float2 r) {
  acc.x = fmaf(w, r.x, acc.x);
  acc.y = fmaf(w, r.y, acc.y);
}

// V is float or float2; a row is row_vecs elements of V
template <typename V>
__global__ void embedding_bag_rows(const V* __restrict__ table,
                                   const int* __restrict__ ids,
                                   const float* __restrict__ weights,
                                   const int64_t* __restrict__ row_ptr,
                                   V* __restrict__ out, int64_t num_bags,
                                   int64_t bag_len, int row_vecs,
                                   int64_t num_rows) {
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
      float w = 0.0f;
      if (c + lane < stop) {
        id = ids[c + lane];
        w = weights ? weights[c + lane] : 1.0f;
      }
      const int n = stop - c < 32 ? (int)(stop - c) : 32;
      for (int j = 0; j < n; j += kUnroll) {  // j and n are warp-uniform
        V r[kUnroll];
        float wu[kUnroll];
        bool live[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int id_u = __shfl_sync(kFull, id, (j + u) & 31);
          wu[u] = __shfl_sync(kFull, w, (j + u) & 31);
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

}  // namespace

extern "C" int embedding_bag_f32(const float* table, const int* ids,
                                 const float* weights, const int64_t* row_ptr,
                                 float* out, long long num_bags,
                                 long long bag_len, int F, long long num_rows,
                                 void* stream) {
  if (num_bags <= 0 || F <= 0) return 0;
  if (num_rows <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (num_bags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)blocks), block(32 * kWarpsPerBlock);
  const bool aligned8 =
      ((uintptr_t)table % 8 == 0) && ((uintptr_t)out % 8 == 0);
  if (F % 2 == 0 && aligned8) {
    embedding_bag_rows<float2><<<grid, block, 0, s>>>(
        reinterpret_cast<const float2*>(table), ids, weights, row_ptr,
        reinterpret_cast<float2*>(out), num_bags, bag_len, F / 2, num_rows);
  } else {
    embedding_bag_rows<float><<<grid, block, 0, s>>>(
        table, ids, weights, row_ptr, out, num_bags, bag_len, F, num_rows);
  }
  return (int)cudaGetLastError();
}
