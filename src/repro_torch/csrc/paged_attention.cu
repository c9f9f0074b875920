// Paged decode attention for Hopper (sm_90a): one new token per sequence
// attends over the KV pages its block table names, with GQA, a sliding
// window and the Gemma-2 logit softcap; online softmax in float32.
//
// Replaces the Pallas kernel paged_attention
// (src/repro/kernels/paged_attention/kernel.py), whose grid walks
// (batch, kv head, page slot) with the block table and lengths
// scalar-prefetched so the DMA engine fetches page bt[b, j + 1] while page
// bt[b, j] is reduced.  Here one CTA owns one (batch, kv head): it reads its
// own block-table entries and walks only the pages that hold live keys, the
// G query heads of the group sharing every K and V load.
//
// What bounds it: bytes.  Each live key's K and V row is read once
// (2 * D * dtype bytes) for 2 * G * D multiply-adds, far below the card's
// ~295 operations per byte.
//
// Design:
//   * 256 threads; a page is taken in chunks of 64 keys.  Each chunk's K and
//     V rows are staged in shared memory as float32 first, all 256 threads
//     issuing their 16-byte loads together (one round trip to device memory
//     per chunk, not one per key).  Scores: warp w takes keys w, w + 8, ...,
//     each lane a strided slice of the key row, and reduces the G dot
//     products by shuffles.  Softmax: warp g updates row g's (m, l).
//     P @ V: thread t owns entries t, t + 256, ... of the [G, D] accumulator;
//   * block-table entries are clamped into [0, P): -1 reads page 0 (as the
//     TPU kernel's clamped DMA does) and an id >= P reads page P - 1 (as the
//     reference's clamped gather does); no address outside the pool is
//     formed.  Only slots below ceil(len / page), and from the window's
//     first page, are visited;
//   * masked scores are -1e30 as in the reference, so a sequence with no
//     live key (lengths == 0) averages V over every slot of its table, which
//     is the reference's value; the kernel then visits every slot;
//   * B * KVH CTAs run in one wave or less (128 for the serve batch on 132
//     SMs), and a chunk's loads do not overlap its arithmetic.  Splitting a
//     long sequence across CTAs (flash-decoding) and double-buffering the
//     next chunk with cp.async are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;                  // keys per chunk
constexpr int kKeysPerWarp = kChunk / kWarps;
constexpr int kMaxGD = 2048;                // G * DP
constexpr int kAccPerThread = kMaxGD / kThreads;
constexpr int kMaxG = 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// n rows of D elements from ``rows`` into smem[64][DP] as float32; 16-byte
// loads when ``vec`` (every row 16-byte aligned)
template <int DP, typename T>
__device__ __forceinline__ void stage_rows(float* smem, const T* rows, int n,
                                           int D, bool vec) {
  constexpr int EV = 16 / sizeof(T);  // elements per 16-byte load
  if (vec) {
    const int per_row = D / EV;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < n * per_row; idx += kThreads) {
      const int r = idx / per_row;
      const int d = (idx - r * per_row) * EV;
      const uint4 raw =
          *reinterpret_cast<const uint4*>(rows + (long long)r * D + d);
      const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < EV; e += 4)
        *reinterpret_cast<float4*>(&smem[r * DP + d + e]) =
            make_float4(to_f32(x[e]), to_f32(x[e + 1]), to_f32(x[e + 2]),
                        to_f32(x[e + 3]));
    }
  } else {
#pragma unroll 4
    for (int idx = threadIdx.x; idx < n * D; idx += kThreads) {
      const int r = idx / D;
      const int d = idx - r * D;
      smem[r * DP + d] = to_f32(rows[(long long)r * D + d]);
    }
  }
}

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads)
    paged_fwd(const T* __restrict__ q, const T* __restrict__ kp,
              const T* __restrict__ vp, const int* __restrict__ bt,
              const int* __restrict__ lens, T* __restrict__ o, int KVH, int G,
              int D, int P, int page, int npmax, float scale, int window,
              float softcap, int vec) {
  constexpr int NL = DP / 32;  // key-row elements per lane
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [kChunk][DP]
  float* Vs = Ks + kChunk * DP;                  // [kChunk][DP]
  __shared__ float qs[kMaxGD];
  __shared__ float sc[kMaxG * kChunk];
  __shared__ float m_s[kMaxG], l_s[kMaxG], corr_s[kMaxG];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int GD = G * DP;

  const T* qb = q + ((long long)b * KVH + kvh) * G * D;
  for (int e = tid; e < GD; e += kThreads) {
    const int g = e / DP, d = e - g * DP;
    qs[e] = d < D ? to_f32(qb[g * D + d]) : 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  if (D < DP) {  // the padding columns stay 0
    for (int e = tid; e < kChunk * DP; e += kThreads) Ks[e] = Vs[e] = 0.f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int r = 0; r < kAccPerThread; ++r) acc[r] = 0.f;

  // the slots that hold live keys; with none, every slot (uniform weights)
  const int len = lens[b];
  const long long cap = (long long)npmax * page;
  const long long lo = window > 0 ? max(0, len - window) : 0;
  const long long hi = min((long long)len, cap);
  int j_begin = 0, j_end = npmax;
  if (lo < hi) {
    j_begin = (int)(lo / page);
    j_end = (int)((hi + page - 1) / page);
  }
  const int* btb = bt + (long long)b * npmax;
  __syncthreads();

  for (int j = j_begin; j < j_end; ++j) {
    const int pid = min(max(btb[j], 0), P - 1);
    const long long page_row0 = ((long long)kvh * P + pid) * page;
    for (int c0 = 0; c0 < page; c0 += kChunk) {
      const int nkeys = min(kChunk, page - c0);
      stage_rows<DP>(Ks, kp + (page_row0 + c0) * D, nkeys, D, vec);
      stage_rows<DP>(Vs, vp + (page_row0 + c0) * D, nkeys, D, vec);
      __syncthreads();
      // scores of this chunk's keys against the G query rows
#pragma unroll 2
      for (int u = 0; u < kKeysPerWarp; ++u) {
        const int kk = warp + kWarps * u;
        float kr[NL];
#pragma unroll
        for (int i = 0; i < NL; ++i) kr[i] = Ks[kk * DP + lane + 32 * i];
        const long long ki = (long long)j * page + c0 + kk;
        bool live = ki < len;
        if (window > 0) live = live && ki >= (long long)len - window;
        for (int g = 0; g < G; ++g) {
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < NL; ++i)
            part += qs[g * DP + lane + 32 * i] * kr[i];
#pragma unroll
          for (int off = 16; off >= 1; off >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, off);
          if (lane == 0) {
            float x = part * scale;
            if (softcap > 0.f) x = softcap * tanhf(x / softcap);
            x = live ? x : kNegInf;
            if (kk >= nkeys) x = -INFINITY;  // past a short last chunk
            sc[g * kChunk + kk] = x;
          }
        }
      }
      __syncthreads();
      // online-softmax update of each query row
      for (int g = warp; g < G; g += kWarps) {
        float* row = sc + g * kChunk;
        float mx = -INFINITY;
        for (int kk = lane; kk < kChunk; kk += 32) mx = fmaxf(mx, row[kk]);
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int kk = lane; kk < kChunk; kk += 32) {
          const float p = expf(row[kk] - m_new);
          row[kk] = p;
          sum += p;
        }
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          corr_s[g] = corr;
          l_s[g] = l_s[g] * corr + sum;
          m_s[g] = m_new;
        }
      }
      __syncthreads();
      // acc = acc * corr + P @ V over the chunk
#pragma unroll
      for (int r = 0; r < kAccPerThread; ++r) {
        const int e = tid + kThreads * r;
        if (e >= GD) break;
        const int g = e / DP, d = e - g * DP;
        const float* prow = sc + g * kChunk;
        float a = acc[r] * corr_s[g];
#pragma unroll 8
        for (int kk = 0; kk < nkeys; ++kk) a += prow[kk] * Vs[kk * DP + d];
        acc[r] = a;
      }
      __syncthreads();  // before the next chunk overwrites K, V and scores
    }
  }

  T* ob = o + ((long long)b * KVH + kvh) * G * D;
#pragma unroll
  for (int r = 0; r < kAccPerThread; ++r) {
    const int e = tid + kThreads * r;
    if (e >= GD) break;
    const int g = e / DP, d = e - g * DP;
    if (d < D) store(&ob[g * D + d], acc[r] / fmaxf(l_s[g], 1e-30f));
  }
}

template <int DP, typename T>
int launch(const void* q, const void* kp, const void* vp, const int* bt,
           const int* lens, void* o, int B, int KVH, int G, int D, int P,
           int page, int npmax, float scale, int window, float softcap,
           int vec, cudaStream_t stream) {
  if (G * DP > kMaxGD || G > kMaxG) return (int)cudaErrorInvalidValue;
  const int smem = (int)(sizeof(float) * 2 * kChunk * DP);
  auto kern = paged_fwd<DP, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(KVH, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, lens, static_cast<T*>(o), KVH, G, D, P,
      page, npmax, scale, window, softcap, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* kp, const void* vp, const int* bt,
             const int* lens, void* o, int B, int KVH, int G, int D, int P,
             int page, int npmax, float scale, int window, float softcap,
             cudaStream_t stream) {
  // 16-byte loads need every page row to start 16-byte aligned
  const int vec = (D * sizeof(T)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(vp) % 16 == 0;
  if (D <= 64)
    return launch<64, T>(q, kp, vp, bt, lens, o, B, KVH, G, D, P, page,
                         npmax, scale, window, softcap, vec, stream);
  if (D <= 128)
    return launch<128, T>(q, kp, vp, bt, lens, o, B, KVH, G, D, P, page,
                          npmax, scale, window, softcap, vec, stream);
  return launch<256, T>(q, kp, vp, bt, lens, o, B, KVH, G, D, P, page, npmax,
                        scale, window, softcap, vec, stream);
}

}  // namespace

// q / o [B, KVH, G, D], k / v pages [KVH, P, page, D], block_table
// i32[B, npmax], lengths i32[B], all contiguous.  dtype 0 = float32,
// 1 = bfloat16 (q, pages and o alike).
extern "C" int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages, const int* block_table,
                                   const int* lengths, void* o, int dtype,
                                   int B, int KVH, int G, int D, int P,
                                   int page, int npmax, float scale,
                                   int window, float softcap, void* stream) {
  if (B <= 0 || KVH <= 0 || G <= 0) return 0;
  if (D <= 0 || D > 256 || P <= 0 || page <= 0 || npmax <= 0 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k_pages, v_pages, block_table, lengths, o, B,
                           KVH, G, D, P, page, npmax, scale, window, softcap,
                           st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k_pages, v_pages, block_table, lengths,
                                   o, B, KVH, G, D, P, page, npmax, scale,
                                   window, softcap, st);
  return (int)cudaErrorInvalidValue;
}
