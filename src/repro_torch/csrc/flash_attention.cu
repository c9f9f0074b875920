// Prefill flash attention for Hopper (sm_90a): GQA, causal mask, sliding
// window, Gemma-2 logit softcap, online softmax in float32.
//
// Replaces the Pallas kernel flash_attention
// (src/repro/kernels/flash_attention/kernel.py), which tiles 128 x 128 for
// the MXU and carries (m, l, acc) in VMEM scratch along a sequential kv grid
// axis.  Here one CTA owns one (batch, head, 64-row query tile) and walks the
// kv tiles in a loop of its own, keeping the online-softmax state of its rows
// in registers.
//
// What bounds it: at the serve shapes (S in the thousands, D = 128) the work
// is 4 * D multiply-adds per live (query, key) pair against 2 * D * S bytes
// of K and V, far above the card's ~295 operations per byte, so the bound is
// operations.  This kernel multiplies on the CUDA cores in float32 (4 x 4
// register tiles over float4 shared-memory reads).  The wrapper sends it
// float32 inputs only: bf16 goes to the tensor-core kernel,
// csrc/flash_attention_wgmma.cu.
//
// Design:
//   * 256 threads as 16 x 16: thread (ty, tx) owns query rows 4ty .. 4ty+3,
//     score columns tx + 16j, and output columns 64g + 4tx .. +3.  Row
//     maxima and sums reduce over the 16 lanes of a half-warp by shuffles;
//   * Q, K and V tiles are staged in shared memory as float32, rows padded by 4 floats so the float4 reads of
//     neighbouring rows fall in different banks.  K and V share one buffer
//     (V is loaded after the scores), which keeps two CTAs on an SM at
//     D <= 128;
//   * only kv tiles that hold a live key for some row of the query tile are
//     visited: up to the diagonal when causal, from q0 - window + 1 with a
//     window.  That is exact whenever each row keeps a live key, as every
//     row does on these masks (the diagonal, or the row's own position);
//   * masked scores are -1e30, as in the reference (a row with no live key
//     would average V uniformly, not turn NaN); keys past the sequence end
//     (the ragged last tile) are -inf and weigh exactly 0;
//   * any S (the ragged edges are masked), any head_dim D <= 256, q/k/v in
//     any layout whose last axis is contiguous (strides are passed).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;  // query rows per CTA
constexpr int kBK = 64;  // keys per kv tile (load_tile stages 64 rows)
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

struct Strides {
  long long b, h, s;
};

// rows [row0, row0 + 64) of one head's [S, D] matrix into smem[64][DP + 4]
// as float32; zero past S and past D
template <int DP, typename T>
__device__ __forceinline__ void load_tile(float* smem, const T* base,
                                          long long stride_s, int row0, int S,
                                          int D) {
  constexpr int kStride = DP + 4;
#pragma unroll 8
  for (int idx = threadIdx.x; idx < kBK * DP; idx += kThreads) {
    const int r = idx / DP;
    const int d = idx - r * DP;
    float x = 0.f;
    if (row0 + r < S && d < D) x = to_f32(base[(row0 + r) * stride_s + d]);
    smem[r * kStride + d] = x;
  }
}

template <int DP, typename T>
__global__ void __launch_bounds__(kThreads, DP <= 128 ? 2 : 1)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, Strides qs,
              Strides ks, Strides vs, int H, int KVH, int S, int D,
              float scale, int causal, int window, float softcap) {
  constexpr int kStride = DP + 4;   // Q / KV row stride (floats)
  constexpr int kPStride = kBK + 4;  // P row stride
  constexpr int NG = DP / 64;        // float4 output groups per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* KV = Qs + kBQ * kStride;
  float* Ps = KV + kBK * kStride;

  const int nq = (S + kBQ - 1) / kBQ;
  const int qt = nq - 1 - (int)blockIdx.x;  // longest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  load_tile<DP>(Qs, qb, qs.s, q0, S, D);

  float m[4], l[4], acc[4][4 * NG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  const int nk = (S + kBK - 1) / kBK;
  const int kt_end = causal ? q_last / kBK + 1 : nk;
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    load_tile<DP>(KV, kb, ks.s, k0, S, D);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            &Qs[(ty * 4 + i) * kStride + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c[j] = *reinterpret_cast<const float4*>(
            &KV[(tx + 16 * j) * kStride + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += a[i].x * c[j].x + a[i].y * c[j].y + a[i].z * c[j].z +
                     a[i].w * c[j].w;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ki = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool live = true;
        if (causal) live = live && qi >= ki;
        if (window > 0) live = live && (qi - ki) < window;
        x = live ? x : kNegInf;
        if (ki >= S) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty * 4 + i) * kPStride + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NG; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // scores read K; P written
    load_tile<DP>(KV, vb, vs.s, k0, S, D);
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(
            &Ps[(ty * 4 + i) * kPStride + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 w = *reinterpret_cast<const float4*>(
              &KV[(kk + u) * kStride + g * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pu = u == 0 ? p[i].x
                           : u == 1 ? p[i].y
                           : u == 2 ? p[i].z
                                    : p[i].w;
            acc[i][g * 4 + 0] += pu * w.x;
            acc[i][g * 4 + 1] += pu * w.y;
            acc[i][g * 4 + 2] += pu * w.z;
            acc[i][g * 4 + 3] += pu * w.w;
          }
        }
      }
    }
    __syncthreads();  // before the next tile overwrites KV and Ps
  }

  T* ob = o + ((long long)(b * H + h) * S) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = g * 64 + tx * 4 + e;
        if (d < D) store(&ob[(long long)qi * D + d], acc[i][g * 4 + e] * inv);
      }
  }
}

template <int DP, typename T>
int launch(const void* q, const void* k, const void* v, void* o, Strides qs,
           Strides ks, Strides vs, int B, int H, int KVH, int S, int D,
           float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(kBQ + kBK) * (DP + 4) + kBQ * (kBK + 4));
  auto kern = flash_fwd<DP, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, H, KVH, S, D,
      scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, Strides qs,
             Strides ks, Strides vs, int B, int H, int KVH, int S, int D,
             float scale, int causal, int window, float softcap,
             cudaStream_t stream) {
  if (D <= 64)
    return launch<64, T>(q, k, v, o, qs, ks, vs, B, H, KVH, S, D, scale,
                         causal, window, softcap, stream);
  if (D <= 128)
    return launch<128, T>(q, k, v, o, qs, ks, vs, B, H, KVH, S, D, scale,
                          causal, window, softcap, stream);
  return launch<256, T>(q, k, v, o, qs, ks, vs, B, H, KVH, S, D, scale,
                        causal, window, softcap, stream);
}

}  // namespace

// q [B, H, S, D], k / v [B, KVH, S, D] float32 with the given (batch, head,
// row) strides in elements and a contiguous last axis; o [B, H, S, D]
// float32 contiguous.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KVH, int S, int D, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, float scale, int causal,
    int window, float softcap, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (D <= 0 || D > 256 || KVH <= 0 || H % KVH != 0 || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch<float>(q, k, v, o, qs, ks, vs, B, H, KVH, S, D, scale,
                         causal, window, softcap, st);
}
