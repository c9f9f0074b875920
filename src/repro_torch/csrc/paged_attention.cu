// Paged decode attention for Hopper (sm_90a): one new token per sequence
// attends over the KV pages its block table names, with GQA, a sliding
// window and the Gemma-2 logit softcap; online softmax in float32.
//
// Replaces the Pallas kernel paged_attention
// (src/repro/kernels/paged_attention/kernel.py), whose grid walks
// (batch, kv head, page slot) in order on one core, carrying (m, l, acc) in
// scratch from slot to slot, with the block table and lengths
// scalar-prefetched so the DMA engine fetches page bt[b, j + 1] while page
// bt[b, j] is reduced.
//
// What bounds it: bytes.  Each live key's K and V row is read once
// (2 * D * dtype bytes) for 2 * G * D multiply-adds, far below the card's
// ~295 operations per byte.  So the design is about keeping device memory
// busy: enough CTAs, and every CTA's next chunks in flight while it reduces
// the current one.
//
// Design (flash-decoding):
//   * split-KV grid (n_split, KVH, B): split s of a sequence covers the
//     block-table slots [s * pps, (s + 1) * pps).  n_split = ceil(npmax /
//     pps) comes from the shapes alone, so a captured CUDA graph stays valid
//     as the sequences grow.  A split with no slot in the sequence's live
//     page range writes an empty partial (m = -inf, l = 0) and returns;
//   * loads: a (kv head, page) is page * D contiguous elements, so each
//     chunk of up to 8 KB of K (and of V) rows is one cp.async.bulk (1-D
//     TMA) into shared memory, in the pages' own type (bf16 stays bf16), one
//     mbarrier per stage.  A 3-stage ring keeps two chunks in flight while
//     one is reduced.  The kernel is bound by latency more than by
//     throughput, so 3 CTAs an SM (48 KB of stages, <= 85 registers a
//     thread) beat 2 CTAs with 16 KB chunks and 1 CTA with 4 stages at the
//     serve shape.  Rows
//     that are not 16-byte aligned (D * size % 16 != 0) are loaded element
//     by element instead, synchronously;
//   * arithmetic: a warp takes a chunk's keys round robin, several at once;
//     the lanes of a key split its row into 16-byte vectors (q's slice in
//     registers), reduce the G dot products by shuffles, and keep their own
//     (m, l, acc) in float32 with no block-wide barrier inside a chunk.  At
//     the end the key slots of a warp merge by shuffles, the warps through
//     shared memory in warp order;
//   * combine: a second kernel merges the n_split partials of each
//     (sequence, kv head) in split order by log-sum-exp rescaling.  No
//     atomics on values, so two runs give the same bits;
//   * block-table entries are clamped into [0, P): -1 reads page 0 (as the
//     TPU kernel's clamped DMA does) and an id >= P reads page P - 1 (as the
//     reference's clamped gather does); no address outside the pool is
//     formed.  Only slots below ceil(len / page), and from the window's
//     first page, are visited;
//   * masked scores are -1e30 as in the reference, so a sequence with no
//     live key (lengths == 0) averages V over every slot of its table, which
//     is the reference's value; the kernel then visits every slot.  Keys
//     past a short last chunk are -inf (not part of the table).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;
constexpr int kStageBytes = 8192;   // K (and V) rows of one chunk
constexpr int kMinBlocks = 3;       // CTAs an SM
constexpr int kMaxG = 32;
constexpr int kMaxGD = 2048;        // G * D rounded up to a 16-byte vector
constexpr int kRingBytes = kStages * 2 * kStageBytes;
// the ring, then the warps' partials [kWarps][G][ds] in the same memory
constexpr int kSmemMax =
    kRingBytes > kWarps * kMaxGD * 4 ? kRingBytes : kWarps * kMaxGD * 4;
constexpr float kMasked = -1e30f;

struct Params {
  const void* q;
  const void* kp;
  const void* vp;
  const int* bt;
  const int* lens;
  float* o_part;   // [B, KVH, n_split, G, D]
  float* ml_part;  // [B, KVH, n_split, G, 2]
  int KVH, G, D, P, page, npmax, pps, n_split;
  float scale;
  int window;
  float softcap;
  int ds;     // shared-memory row stride: D rounded up to a 16-byte vector
  int nv;     // 16-byte vectors a row
  int tpv;    // lanes a key row (a power of 2)
  int gl;     // lanes across the G query rows
  int kh;     // keys a warp takes at once
  int chunk;  // keys a chunk
  int bulk;   // 1: cp.async.bulk copies; 0: element loads
};

// ---------------------------------------------------------------- PTX ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ``bytes`` contiguous bytes from global to shared memory, completion
// counted on ``bar``; both addresses and the size 16-byte multiples
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------- elements ----

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
struct Vec;  // one 16-byte vector of T as float32

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* s, float* x) {
    const float4 r = *reinterpret_cast<const float4*>(s);
    x[0] = r.x, x[1] = r.y, x[2] = r.z, x[3] = r.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* s,
                                              float* x) {
    const uint4 r = *reinterpret_cast<const uint4*>(s);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float safe_exp(float x, float m) {
  return m == -INFINITY ? 0.f : expf(x - m);
}

// ------------------------------------------------------------ kernels ----

// One split of one (sequence, kv head): the partial (m, l, acc) of its
// visited slots.  NG query rows and VL vectors of a row per lane.
template <typename T, int NG, int VL>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    paged_split(const Params p) {
  constexpr int EV = Vec<T>::N;
  // keys a slot takes between softmax updates: a 32-key bf16 chunk of
  // D = 128 is one step of every slot
  constexpr int KSTEP = NG >= 4 ? 1 : 4 / NG;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ float ml_s[kWarps][kMaxG][2];
  __shared__ float wt_s[kWarps][kMaxG];

  const int s = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.G, D = p.D, page = p.page;
  const long long part = ((long long)b * p.KVH + kvh) * p.n_split + s;

  // the pages with live keys; with none, every slot (uniform weights)
  const int len = p.lens[b];
  const long long cap = (long long)p.npmax * page;
  const long long lo = p.window > 0 ? max(0, len - p.window) : 0;
  const long long hi = min((long long)len, cap);
  int j_begin = 0, j_end = p.npmax;
  if (lo < hi) {
    j_begin = (int)(lo / page);
    j_end = (int)((hi + page - 1) / page);
  }
  const int jlo = max(j_begin, s * p.pps);
  const int jhi = min(j_end, (s + 1) * p.pps);
  if (jlo >= jhi) {  // nothing of this split is visited
    for (int g = tid; g < G; g += kThreads) {
      p.ml_part[(part * G + g) * 2] = -INFINITY;
      p.ml_part[(part * G + g) * 2 + 1] = 0.f;
    }
    return;
  }
  const int cpp = (page + p.chunk - 1) / p.chunk;  // chunks a page
  const int nchunks = (jhi - jlo) * cpp;
  const int* btb = p.bt + (long long)b * p.npmax;
  const T* kp = static_cast<const T*>(p.kp);
  const T* vp = static_cast<const T*>(p.vp);
  const int ds = p.ds;
  const int esize = (int)sizeof(T);

  auto stage_k = [&](int st) {
    return reinterpret_cast<T*>(smem + st * 2 * kStageBytes);
  };
  auto stage_v = [&](int st) {
    return reinterpret_cast<T*>(smem + st * 2 * kStageBytes + kStageBytes);
  };
  // first pool row and key count of chunk c
  auto chunk_at = [&](int c, long long& row0, int& c0, int& n, int& j) {
    j = jlo + c / cpp;
    c0 = (c - (j - jlo) * cpp) * p.chunk;
    n = min(p.chunk, page - c0);
    const int pid = min(max(btb[j], 0), p.P - 1);
    row0 = ((long long)kvh * p.P + pid) * page + c0;
  };
  auto fetch = [&](int c) {
    long long row0;
    int c0, n, j;
    chunk_at(c, row0, c0, n, j);
    const int st = c % kStages;
    const uint32_t bytes = (uint32_t)(n * D * esize);
    const uint32_t bar = smem_addr(&full[st]);
    mbar_expect_tx(bar, 2 * bytes);
    bulk_copy(smem_addr(stage_k(st)), kp + row0 * D, bytes, bar);
    bulk_copy(smem_addr(stage_v(st)), vp + row0 * D, bytes, bar);
  };

  if (p.bulk && tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(smem_addr(&full[st]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (p.bulk && tid == 0)
    for (int c = 0; c < min(kStages, nchunks); ++c) fetch(c);

  // lane = v + tpv * (gs + gl * ks): vector v of the row, query rows gs,
  // gs + gl, ..., key slot ks
  const int v = lane % p.tpv;
  const int gs = (lane / p.tpv) % p.gl;
  const int ks = lane / (p.tpv * p.gl);
  const int kstride = kWarps * p.kh;

  float qr[NG][VL][EV], acc[NG][VL][EV], m[NG], l[NG];
  const T* qb =
      static_cast<const T*>(p.q) + ((long long)b * p.KVH + kvh) * G * D;
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int g = gs + p.gl * i;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int jv = 0; jv < VL; ++jv)
#pragma unroll
      for (int e = 0; e < EV; ++e) {
        const int d = (v + p.tpv * jv) * EV + e;
        qr[i][jv][e] = g < G && d < D ? to_f32(qb[g * D + d]) : 0.f;
        acc[i][jv][e] = 0.f;
      }
  }

  for (int c = 0; c < nchunks; ++c) {
    const int st = c % kStages;
    long long row0;
    int c0, n, j;
    chunk_at(c, row0, c0, n, j);
    const T* Ks = stage_k(st);
    const T* Vs = stage_v(st);
    if (p.bulk) {
      mbar_wait(smem_addr(&full[st]), (uint32_t)((c / kStages) & 1));
    } else {  // element loads, the padding columns 0
      T* kd = stage_k(st);
      T* vd = stage_v(st);
      for (int idx = tid; idx < n * ds; idx += kThreads) {
        const int r = idx / ds, d = idx - r * ds;
        const long long src = (row0 + r) * D + d;
        kd[idx] = d < D ? kp[src] : T(0.f);
        vd[idx] = d < D ? vp[src] : T(0.f);
      }
      __syncthreads();
    }
    const long long kbase = (long long)j * page + c0;

    for (int k0 = warp * p.kh; k0 < n; k0 += KSTEP * kstride) {
      float sc[KSTEP][NG];
#pragma unroll
      for (int u = 0; u < KSTEP; ++u) {
        const int kk = k0 + ks + u * kstride;
        const bool in = kk < n;
        float dot[NG];
#pragma unroll
        for (int i = 0; i < NG; ++i) dot[i] = 0.f;
        if (in) {
#pragma unroll
          for (int jv = 0; jv < VL; ++jv) {
            const int vec = v + p.tpv * jv;
            if (vec < p.nv) {
              float x[EV];
              Vec<T>::load(Ks + kk * ds + vec * EV, x);
#pragma unroll
              for (int i = 0; i < NG; ++i)
#pragma unroll
                for (int e = 0; e < EV; ++e) dot[i] += qr[i][jv][e] * x[e];
            }
          }
        }
#pragma unroll
        for (int i = 0; i < NG; ++i)
          for (int off = p.tpv >> 1; off >= 1; off >>= 1)
            dot[i] += __shfl_xor_sync(0xffffffffu, dot[i], off);
        const long long ki = kbase + kk;
        bool live = ki < len;
        if (p.window > 0) live = live && ki >= (long long)len - p.window;
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          float x = dot[i] * p.scale;
          if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
          sc[u][i] = !in ? -INFINITY : live ? x : kMasked;
        }
      }
      // online softmax of this slot's keys, then acc += p @ V
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        float mx = sc[0][i];
#pragma unroll
        for (int u = 1; u < KSTEP; ++u) mx = fmaxf(mx, sc[u][i]);
        const float m_new = fmaxf(m[i], mx);
        const float corr = safe_exp(m[i], m_new);
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < KSTEP; ++u) {
          sc[u][i] = safe_exp(sc[u][i], m_new);
          sum += sc[u][i];
        }
        if (m_new != -INFINITY) {
          l[i] = l[i] * corr + sum;
          m[i] = m_new;
#pragma unroll
          for (int jv = 0; jv < VL; ++jv)
#pragma unroll
            for (int e = 0; e < EV; ++e) acc[i][jv][e] *= corr;
        }
      }
#pragma unroll
      for (int u = 0; u < KSTEP; ++u) {
        const int kk = k0 + ks + u * kstride;
        if (kk >= n) continue;
#pragma unroll
        for (int jv = 0; jv < VL; ++jv) {
          const int vec = v + p.tpv * jv;
          if (vec >= p.nv) continue;
          float x[EV];
          Vec<T>::load(Vs + kk * ds + vec * EV, x);
#pragma unroll
          for (int i = 0; i < NG; ++i)
#pragma unroll
            for (int e = 0; e < EV; ++e) acc[i][jv][e] += sc[u][i] * x[e];
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (p.bulk && tid == 0 && c + kStages < nchunks) fetch(c + kStages);
  }

  // merge the key slots of a warp (lanes tpv * gl apart), by shuffles
  for (int off = p.tpv * p.gl; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[i], off);
      const float mm = fmaxf(m[i], mo);
      const float a = safe_exp(m[i], mm), bo = safe_exp(mo, mm);
      l[i] = l[i] * a + lo_ * bo;
      m[i] = mm;
#pragma unroll
      for (int jv = 0; jv < VL; ++jv)
#pragma unroll
        for (int e = 0; e < EV; ++e) {
          const float ao = __shfl_xor_sync(0xffffffffu, acc[i][jv][e], off);
          acc[i][jv][e] = acc[i][jv][e] * a + ao * bo;
        }
    }
  }
  // then the warps, through shared memory (the stages are free now)
  float* red = reinterpret_cast<float*>(smem);  // [kWarps][G][ds]
  if (ks == 0) {
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int g = gs + p.gl * i;
      if (g >= G) continue;
      if (v == 0) {
        ml_s[warp][g][0] = m[i];
        ml_s[warp][g][1] = l[i];
      }
#pragma unroll
      for (int jv = 0; jv < VL; ++jv) {
        const int vec = v + p.tpv * jv;
        if (vec >= p.nv) continue;
#pragma unroll
        for (int e = 0; e < EV; ++e)
          red[(warp * G + g) * ds + vec * EV + e] = acc[i][jv][e];
      }
    }
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    float mm = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, ml_s[w][g][0]);
    float ll = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      wt_s[w][g] = safe_exp(ml_s[w][g][0], mm);
      ll += ml_s[w][g][1] * wt_s[w][g];
    }
    p.ml_part[(part * G + g) * 2] = mm;
    p.ml_part[(part * G + g) * 2 + 1] = ll;
  }
  __syncthreads();
  float* ob = p.o_part + part * G * D;
  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D, d = e - g * D;
    float o = 0.f;
    for (int w = 0; w < kWarps; ++w)
      o += red[(w * G + g) * ds + d] * wt_s[w][g];
    ob[e] = o;
  }
}

// o[b, kvh] = sum_s w_s acc_s / sum_s w_s l_s, w_s = exp(m_s - max m),
// over the splits in order
template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_combine(const float* __restrict__ o_part,
                  const float* __restrict__ ml_part, T* __restrict__ o, int G,
                  int D, int n_split) {
  const long long bh = blockIdx.x;
  const float* ml = ml_part + bh * n_split * G * 2;
  const float* op = o_part + bh * n_split * G * D;
  for (int e = threadIdx.x; e < G * D; e += kThreads) {
    const int g = e / D;
    float mm = -INFINITY;
    for (int s = 0; s < n_split; ++s)
      if (ml[(s * G + g) * 2 + 1] > 0.f)
        mm = fmaxf(mm, ml[(s * G + g) * 2]);
    float ll = 0.f, acc = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float l = ml[(s * G + g) * 2 + 1];
      if (l > 0.f) {
        const float w = expf(ml[(s * G + g) * 2] - mm);
        ll += l * w;
        acc += op[(long long)s * G * D + e] * w;
      }
    }
    store(&o[bh * G * D + e], acc / fmaxf(ll, 1e-30f));
  }
}

template <typename T, int NG, int VL>
int launch_split(const Params& p, int B, cudaStream_t stream) {
  auto kern = paged_split<T, NG, VL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err != cudaSuccess) return (int)err;
  const int red = kWarps * p.G * p.ds * (int)sizeof(float);
  const int smem = red > kRingBytes ? red : kRingBytes;
  kern<<<dim3(p.n_split, p.KVH, B), kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int pow2_ceil(int x) {
  int r = 1;
  while (r < x) r <<= 1;
  return r;
}

// the lane layout of Params and the template that holds its registers
template <typename T>
int dispatch(Params p, void* o, int B, cudaStream_t stream) {
  const int esize = (int)sizeof(T);
  const int ev = 16 / esize;
  p.ds = (p.D + ev - 1) / ev * ev;
  p.nv = p.ds / ev;
  p.tpv = min(32, pow2_ceil(p.nv));
  const int vl = (p.nv + p.tpv - 1) / p.tpv;
  const int rest = 32 / p.tpv;
  // the fewest lanes across G that keep NG within the smallest template
  const int ng_small = esize == 2 ? 2 : vl == 1 ? 4 : 8;
  p.gl = 1;
  while (p.gl < rest && (p.G + p.gl - 1) / p.gl > ng_small) p.gl <<= 1;
  p.kh = rest / p.gl;
  const int ng = (p.G + p.gl - 1) / p.gl;
  p.chunk = min(p.page, kStageBytes / (p.ds * esize));
  p.bulk = (p.D * esize) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(p.kp) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(p.vp) % 16 == 0;
  if (p.G * p.ds > kMaxGD || p.G > kMaxG || vl > 2)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (ng <= 2)
      err = launch_split<T, 2, 1>(p, B, stream);
    else if (ng <= 8)
      err = launch_split<T, 8, 1>(p, B, stream);
  } else {
    if (vl == 1 && ng <= 4)
      err = launch_split<T, 4, 1>(p, B, stream);
    else if (vl == 1 && ng <= 16)
      err = launch_split<T, 16, 1>(p, B, stream);
    else if (vl == 2 && ng <= 8)
      err = launch_split<T, 8, 2>(p, B, stream);
  }
  if (err != 0) return err;
  paged_combine<T><<<B * p.KVH, kThreads, 0, stream>>>(
      p.o_part, p.ml_part, static_cast<T*>(o), p.G, p.D, p.n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// q / o [B, KVH, G, D], k / v pages [KVH, P, page, D], block_table
// i32[B, npmax], lengths i32[B], all contiguous; float32 scratch o_part
// [B, KVH, n_split, G, D] and ml_part [B, KVH, n_split, G, 2] with n_split
// = ceil(npmax / pages_per_split).  dtype 0 = float32, 1 = bfloat16 (q,
// pages and o alike).
extern "C" int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages, const int* block_table,
                                   const int* lengths, void* o, void* o_part,
                                   void* ml_part, int dtype, int B, int KVH,
                                   int G, int D, int P, int page, int npmax,
                                   int pages_per_split, float scale,
                                   int window, float softcap, void* stream) {
  if (B <= 0 || KVH <= 0 || G <= 0) return 0;
  if (D <= 0 || D > 256 || P <= 0 || page <= 0 || npmax <= 0 ||
      pages_per_split <= 0 || B > 65535 || KVH > 65535)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.q = q;
  p.kp = k_pages;
  p.vp = v_pages;
  p.bt = block_table;
  p.lens = lengths;
  p.o_part = static_cast<float*>(o_part);
  p.ml_part = static_cast<float*>(ml_part);
  p.KVH = KVH;
  p.G = G;
  p.D = D;
  p.P = P;
  p.page = page;
  p.npmax = npmax;
  p.pps = pages_per_split;
  p.n_split = (npmax + pages_per_split - 1) / pages_per_split;
  p.scale = scale;
  p.window = window;
  p.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, o, B, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, o, B, st);
  return (int)cudaErrorInvalidValue;
}
