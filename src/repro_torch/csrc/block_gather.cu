// Row-group gather for Hopper (sm_90a):
//   out[i*G : (i+1)*G, :] = table[ids[i]*G : (ids[i]+1)*G, :].
//
// Replaces the Pallas kernel block_gather
// (src/repro/kernels/block_gather/kernel.py), whose ids are scalar-prefetched
// so the DMA of row ids[i+k] is in flight while row ids[i] is copied.  On
// Hopper every thread reads its own ids and keeps several table loads in
// flight by itself, which is what the prefetch bought on the TPU.
//
// Bound: bytes -- ids read once, each table row the ids name read once,
// N*G*F floats written once, over 3.35 TB/s.  On the engine's path
// (x[src] over a destination-sorted sweep plan, F = 1) the table is a
// vertex vector of ~19 MB that fits the 50 MB L2, and ids and outputs are
// streams of ~280 MB each.  So:
//   * F = 1: each thread loads four ids as one 16-byte vector, issues their
//     four table loads together and stores one float4; a scalar head brings
//     the output to a 16-byte boundary and a scalar tail takes N % 4.  Ids
//     that are not 16-byte aligned there (a slice) are read as four scalars;
//   * ids are read and outputs written with evict-first hints (__ldcs /
//     __stcs), so the streams do not push the table's lines out of L2;
//   * 32-bit index arithmetic wherever every offset fits in 31 bits;
//   * wide rows: 16-byte vectors, one per thread, when the row is a multiple
//     of 4 floats (push_feat's F = 16); 8-byte vectors with one warp per row
//     group, four rows in flight, when it is even (SASRec retrieval's F = 50,
//     200-byte rows); single floats otherwise;
//   * measured on an H100 (chip_smoke.py): x[src] over the plan's 69 M ids
//     runs at about index_select's time, ~3x the bytes bound: each 4-byte
//     table read at a random address costs L2 a 32-byte sector, ~2.2 GB of
//     sectors, which the bytes bound does not count.
//
// Ids outside [0, R/G) are clamped, as JAX clamps an out-of-range gather, so
// a stray id can never read outside the table.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowUnroll = 4;   // rows a warp has in flight (wide F = 50 rows)

__device__ __forceinline__ int clamp_id(int id, int hi) {
  return id < 0 ? 0 : (id > hi ? hi : id);
}

// F = 1 (one float per id): [0, head) and [head + 4 * n_vec, n) scalar,
// the rest four ids a thread
template <typename Idx, bool kIdsVec>
__global__ void __launch_bounds__(kThreads)
gather_f1(const float* __restrict__ table, const int* __restrict__ ids,
          float* __restrict__ out, Idx n, Idx head, Idx n_vec, int hi) {
  const Idx stride = (Idx)gridDim.x * kThreads;
  const Idx t0 = (Idx)blockIdx.x * kThreads + threadIdx.x;
  for (Idx v = t0; v < n_vec; v += stride) {
    const Idx i = head + 4 * v;
    int4 id;
    if (kIdsVec) {
      id = __ldcs(reinterpret_cast<const int4*>(ids + i));
    } else {
      id.x = __ldcs(ids + i);
      id.y = __ldcs(ids + i + 1);
      id.z = __ldcs(ids + i + 2);
      id.w = __ldcs(ids + i + 3);
    }
    float4 o;
    o.x = __ldg(table + clamp_id(id.x, hi));
    o.y = __ldg(table + clamp_id(id.y, hi));
    o.z = __ldg(table + clamp_id(id.z, hi));
    o.w = __ldg(table + clamp_id(id.w, hi));
    __stcs(reinterpret_cast<float4*>(out + i), o);
  }
  const Idx rest = head + 4 * n_vec;
  Idx i = -1;
  if (t0 < head) i = t0;
  else if (t0 - head < n - rest) i = rest + (t0 - head);
  if (i >= 0) __stcs(out + i, __ldg(table + clamp_id(__ldcs(ids + i), hi)));
}

// one thread per vector V of the output (a float4, or a float)
template <typename V, typename Idx>
__global__ void __launch_bounds__(kThreads)
gather_rows_vec(const V* __restrict__ table, const int* __restrict__ ids,
                V* __restrict__ out, Idx n_ids, Idx row_vecs, int hi) {
  const Idx total = n_ids * row_vecs;
  const Idx stride = (Idx)gridDim.x * kThreads;
  for (Idx t = (Idx)blockIdx.x * kThreads + threadIdx.x; t < total;
       t += stride) {
    const Idx i = row_vecs == 1 ? t : t / row_vecs;
    const Idx r = t - i * row_vecs;
    __stcs(out + t, __ldg(table + (Idx)clamp_id(__ldcs(ids + i), hi)
                                      * row_vecs + r));
  }
}

// one warp per row group of 8-byte vectors (F = 50: 25 lanes of a warp)
template <typename Idx>
__global__ void __launch_bounds__(kThreads)
gather_rows_warp2(const float2* __restrict__ table,
                  const int* __restrict__ ids, float2* __restrict__ out,
                  Idx n_ids, int row_vecs, int hi) {
  const int lane = threadIdx.x & 31;
  const Idx warps = (Idx)gridDim.x * (kThreads / 32);
  for (Idx i0 = (Idx)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
       i0 < n_ids; i0 += warps * kRowUnroll) {
    for (int r = lane; r < row_vecs; r += 32) {
      float2 v[kRowUnroll];
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        const Idx i = i0 + u * warps;
        if (i < n_ids)
          v[u] = __ldg(table + (Idx)clamp_id(__ldcs(ids + i), hi) * row_vecs
                       + r);
      }
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        const Idx i = i0 + u * warps;
        if (i < n_ids) __stcs(out + i * row_vecs + r, v[u]);
      }
    }
  }
}

unsigned grid_for(int64_t work, int per_block) {
  const int64_t blocks = (work + per_block - 1) / per_block;
  const int64_t cap = 132LL * 64;   // enough resident blocks for 132 SMs
  return (unsigned)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

template <typename Idx>
void launch_f1(const float* table, const int* ids, float* out, int64_t n,
               int hi, cudaStream_t s) {
  // scalars until the output is 16-byte aligned
  int64_t head = (int64_t)((16 - ((uintptr_t)out & 15)) & 15) / 4;
  if (head > n) head = n;
  const int64_t n_vec = (n - head) / 4;
  const int64_t scalars = n - 4 * n_vec;
  const unsigned grid = grid_for(n_vec > scalars ? n_vec : scalars, kThreads);
  if (((uintptr_t)(ids + head) & 15) == 0) {
    gather_f1<Idx, true><<<grid, kThreads, 0, s>>>(table, ids, out, (Idx)n,
                                                    (Idx)head, (Idx)n_vec, hi);
  } else {
    gather_f1<Idx, false><<<grid, kThreads, 0, s>>>(table, ids, out, (Idx)n,
                                                     (Idx)head, (Idx)n_vec,
                                                     hi);
  }
}

template <typename V, typename Idx>
void launch_vec(const float* table, const int* ids, float* out, int64_t n,
                int64_t row_vecs, int hi, cudaStream_t s) {
  gather_rows_vec<V, Idx><<<grid_for(n * row_vecs, kThreads), kThreads, 0,
                            s>>>(reinterpret_cast<const V*>(table), ids,
                                 reinterpret_cast<V*>(out), (Idx)n,
                                 (Idx)row_vecs, hi);
}

}  // namespace

extern "C" int block_gather_f32(const float* table, const int* ids,
                                float* out, long long n_ids,
                                long long row_elems, long long n_groups,
                                void* stream) {
  if (n_ids <= 0 || row_elems <= 0) return 0;
  if (n_groups <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // ids are int32: a table past 2^31 groups is clamped at the largest id
  const int hi = (int)(n_groups - 1 < 0x7fffffffLL ? n_groups - 1
                                                    : 0x7fffffffLL);
  const uintptr_t align = (uintptr_t)table | (uintptr_t)out;
  // 32-bit offsets when every element offset of the table and the output fits
  const bool small = n_ids * row_elems < (1LL << 31)
                     && n_groups * row_elems < (1LL << 31);
  if (row_elems == 1) {
    if (small) launch_f1<int>(table, ids, out, n_ids, hi, s);
    else launch_f1<int64_t>(table, ids, out, n_ids, hi, s);
  } else if (row_elems % 4 == 0 && align % 16 == 0) {
    if (small) launch_vec<float4, int>(table, ids, out, n_ids, row_elems / 4, hi, s);
    else launch_vec<float4, int64_t>(table, ids, out, n_ids, row_elems / 4, hi, s);
  } else if (row_elems % 2 == 0 && align % 8 == 0) {
    const int row_vecs = (int)(row_elems / 2);
    const unsigned grid = grid_for(n_ids, kThreads / 32);
    const float2* t2 = reinterpret_cast<const float2*>(table);
    float2* o2 = reinterpret_cast<float2*>(out);
    if (small) gather_rows_warp2<int><<<grid, kThreads, 0, s>>>(t2, ids, o2, (int)n_ids, row_vecs, hi);
    else gather_rows_warp2<int64_t><<<grid, kThreads, 0, s>>>(t2, ids, o2, n_ids, row_vecs, hi);
  } else {
    if (small) launch_vec<float, int>(table, ids, out, n_ids, row_elems, hi, s);
    else launch_vec<float, int64_t>(table, ids, out, n_ids, row_elems, hi, s);
  }
  return (int)cudaGetLastError();
}
