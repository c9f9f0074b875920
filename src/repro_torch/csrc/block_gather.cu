// Row-group gather for Hopper (sm_90a):
//   out[i*G : (i+1)*G, :] = table[ids[i]*G : (ids[i]+1)*G, :].
//
// Replaces the Pallas kernel block_gather
// (src/repro/kernels/block_gather/kernel.py), whose ids are scalar-prefetched
// so the DMA of row ids[i+k] is in flight while row ids[i] is copied.  On
// Hopper there is no grid pipeline to feed: every thread reads its own id and
// the card keeps thousands of independent loads in flight by itself, which
// is what the prefetch bought on the TPU.
//
// Bound: bytes -- ids read once, each table row the ids name read once,
// N*G*F floats written once, over 3.35 TB/s.  With F = 1 (the engine's
// x[owner] and x[dst]) each read is a lone 4-byte load at a data-dependent
// address, so the achieved rate sits
// well under the bound whatever the kernel does; wide rows (G*F a multiple
// of 4) are copied as 16-byte vectors.
//
// Ids outside [0, R/G) are clamped, as JAX clamps an out-of-range gather, so
// a stray id can never read outside the table.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int64_t clamp_id(int id, int64_t n_groups) {
  int64_t g = id;
  return g < 0 ? 0 : (g >= n_groups ? n_groups - 1 : g);
}

// one thread per element V of the output (a float, or a 16-byte float4)
template <typename V>
__global__ void gather_rows(const V* __restrict__ table,
                            const int* __restrict__ ids, V* __restrict__ out,
                            int64_t n_ids, int64_t row_vecs,
                            int64_t n_groups) {
  const int64_t total = n_ids * row_vecs;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    // a 64-bit divide is a long instruction sequence; the engine's F = 1
    // rows need none (the branch is uniform across the grid)
    const int64_t i = row_vecs == 1 ? t : t / row_vecs;
    const int64_t r = t - i * row_vecs;
    out[t] = table[clamp_id(ids[i], n_groups) * row_vecs + r];
  }
}

unsigned grid_for(int64_t work, int threads) {
  int64_t blocks = (work + threads - 1) / threads;
  const int64_t cap = 132LL * 64;  // enough resident blocks to fill 132 SMs
  return (unsigned)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

}  // namespace

extern "C" int block_gather_f32(const float* table, const int* ids,
                                float* out, long long n_ids,
                                long long row_elems, long long n_groups,
                                void* stream) {
  if (n_ids <= 0 || row_elems <= 0) return 0;
  if (n_groups <= 0) return (int)cudaErrorInvalidValue;
  constexpr int kThreads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned16 =
      ((uintptr_t)table % 16 == 0) && ((uintptr_t)out % 16 == 0);
  if (row_elems % 4 == 0 && aligned16) {
    const int64_t row_vecs = row_elems / 4;
    gather_rows<float4><<<grid_for(n_ids * row_vecs, kThreads), kThreads,
                             0, s>>>(
        reinterpret_cast<const float4*>(table), ids,
        reinterpret_cast<float4*>(out), n_ids, row_vecs, n_groups);
  } else {
    gather_rows<float><<<grid_for(n_ids * row_elems, kThreads), kThreads,
                            0, s>>>(table, ids, out, n_ids, row_elems,
                                    n_groups);
  }
  return (int)cudaGetLastError();
}
