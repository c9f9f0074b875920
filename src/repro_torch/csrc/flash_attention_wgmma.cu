// Prefill flash attention on Hopper's tensor cores (sm_90a), bf16 in and
// out: GQA, causal mask, sliding window, Gemma-2 logit softcap, online
// softmax in float32.
//
// Replaces, for bf16 inputs, the Pallas kernel flash_attention
// (src/repro/kernels/flash_attention/kernel.py:69, body :24-66).  float32
// inputs stay on csrc/flash_attention.cu (CUDA cores); the wrapper picks by
// dtype.
//
// What bounds it: at the serve shape (B 8, H 32, S 6,205, D 128) the work
// is 4 * D flops per live (query, key) pair on the tensor cores (2.55 ms at
// 989 TFLOP/s for the global layer), and with the softcap each live pair
// also needs transcendentals on the MUFU pipe (16 a clock per SM): the
// softcap's tanh as 1 - 2 / (exp2(2x log2 e) + 1) is an ex2 and an rcp, p
// is another ex2.  The two floors are within 1.5x of each other, so the
// softmax of one warpgroup must run while the other's wgmma runs.
//
// Design (FlashAttention-3's shape, written plainly):
//   * one CTA per (batch, head, 128-row query tile), 3 warpgroups.  The
//     first is the producer: one thread issues TMA loads
//     (cp.async.bulk.tensor, 128-byte swizzle, mbarrier completion) of the
//     Q tile once and of K and V tiles into a ring of 3 stages (2 at
//     D 256).  The other two are consumers, each owning 64 query rows;
//   * S = Q K^T by wgmma m64n128k16 (n64 at D 256, whose kv tile is 64
//     keys) with both operands in shared memory,
//     float32 accumulators in registers; then scale, softcap, masks (only on
//     tiles that cross the diagonal, the window edge or S), the online
//     softmax in the log2 domain, and P rounded to bf16 in registers, laid
//     out as the A operand of O += P V (wgmma m64n128k16, n64 at D 64, with
//     V from shared memory, transposed, float32 accumulators);
//   * the consumers take turns at the tensor cores (named barriers 1, 2):
//     each turn issues S_j = Q K_j^T and O += P_{j-1} V_{j-1} together, then
//     hands the turn over and runs tile j's softmax while the other
//     warpgroup's products run;
//   * tile skipping as csrc/flash_attention.cu: kv tiles up to the diagonal
//     when causal, from q0 - window + 1 with a window; the longest causal
//     tiles are scheduled first;
//   * layout: q / k / v as [B, heads, S, D] views with a contiguous last
//     axis and strides that are multiples of 16 bytes go straight into 4-D
//     tensor maps {D, S, heads, B}; columns past D and rows past S come in
//     as zeros (TMA's out-of-bounds fill); D is padded to 64 / 128 / 256.
//     Keys past S are -inf, masked pairs -1e30 (as the reference), and o is
//     written contiguous [B, H, S, D].
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;        // query rows per CTA (two consumer warpgroups)
constexpr int kStages = 3;      // K / V ring depth (2 at D 256: 227 KB)
constexpr int kThreads = 384;   // producer + two consumer warpgroups
constexpr int kBoxBytes = 128;  // one swizzled row: 64 bf16 columns
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e30f;

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
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

// one box {64 columns, rows, 1, 1} of a 4-D tensor map into shared memory
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// wgmma shared-memory descriptor, 128-byte swizzle.  K-major operands (Q,
// K: rows of 64 columns, 8-row groups 1024 bytes apart) take SBO = 1024 and
// no LBO; the MN-major V takes SBO = 1024 between 8-key groups and LBO =
// the distance to the next 64-column box (an n128 product spans two).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads of async-written registers
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define ACC8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC32 ACC8(0), ACC8(8), ACC8(16), ACC8(24)
#define REGS32                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31}"

#define ACC64 ACC32, ACC8(32), ACC8(40), ACC8(48), ACC8(56)
#define REGS64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss128(float* d, uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC64
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A in registers, B MN-major
__device__ __forceinline__ void wgmma_rs128(float* d, const uint32_t* a,
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers, B MN-major in
// shared memory (the transpose bit)
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ------------------------------------------------------------- kernel ----

struct Params {
  __nv_bfloat16* o;  // [B, H, S, D] contiguous
  int H, G, S, D, nq;
  int causal, window;
  float k_lin;  // scale * log2 e: logit -> log2 domain without a softcap
  float k_cap;  // 2 * log2 e * scale / softcap: exp2 argument of the tanh
  float cl;     // softcap * log2 e (0 without a softcap)
};

template <int DP, int BN>
struct Layout {
  static constexpr int NC = DP / 64;             // 64-column boxes
  static constexpr int kQBox = kBM * kBoxBytes;  // one box of Q rows
  static constexpr int kQBytes = NC * kQBox;
  static constexpr int kKVBox = BN * kBoxBytes;  // one box of K or V rows
  static constexpr int kKVBytes = NC * kKVBox;   // one stage of K (or V)
  static constexpr int ST = DP == 256 ? 2 : kStages;
  static constexpr int kBarBytes = 8 * (1 + 3 * ST);
  static constexpr int kSmem =
      1024 + kQBytes + 2 * ST * kKVBytes + kBarBytes;
};

// S = Q K^T for one warpgroup's 64 rows: one n128 product (BN 128) or
// BN / 64 of n64 per k16 step, DP / 16 k16 steps.  A k step inside a
// swizzled box moves the start address by 32 bytes; every fourth one starts
// the next 64-column box
template <int DP, int BN>
__device__ __forceinline__ void issue_s(float* s, uint32_t qa, uint32_t kb) {
  using L = Layout<DP, BN>;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint64_t a = smem_desc(qa + (kk / 4) * L::kQBox + off, 16);
    const uint32_t kaddr = kb + (kk / 4) * L::kKVBox + off;
    if constexpr (BN == 128) {
      wgmma_ss128(s, a, smem_desc(kaddr, 16), kk > 0);
    } else {
#pragma unroll
      for (int c = 0; c < BN / 64; ++c)
        wgmma_ss(s + 32 * c, a, smem_desc(kaddr + c * 64 * kBoxBytes, 16),
                 kk > 0);
    }
  }
}

// O += P V: P [64 x BN] in registers (four 32-bit registers a k16 step),
// V [BN x DP] MN-major, n128 products over two 64-column boxes (n64 at
// DP 64); a k16 step is 16 rows = 2048 bytes
template <int DP, int BN>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t* p,
                                         uint32_t vb) {
  using L = Layout<DP, BN>;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint32_t vaddr = vb + kk * 16 * kBoxBytes;
    if constexpr (DP % 128 == 0) {
#pragma unroll
      for (int c = 0; c < DP / 128; ++c)
        wgmma_rs128(o + 64 * c, p + 4 * kk,
                    smem_desc(vaddr + 2 * c * L::kKVBox, L::kKVBox));
    } else {
#pragma unroll
      for (int c = 0; c < DP / 64; ++c)
        wgmma_rs(o + 32 * c, p + 4 * kk,
                 smem_desc(vaddr + c * L::kKVBox, L::kKVBox));
    }
  }
}

// scores -> log2-domain logits z (scale, softcap, masks) in place, and the
// row maxima over the tile.  The thread holds rows row0 and row0 + 8 and,
// in each 8-column group j, columns kc + 8 j and kc + 8 j + 1
template <int BN, bool MASK, bool CAP>
__device__ __forceinline__ void scores(float* s, float* mx, const Params& P,
                                       int row0, int kc) {
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 4 * j + 2 * i + e;
        // c tanh(x / c) in log2 units: c L (1 - 2 / (exp2(2 L x / c) + 1))
        float z = CAP ? fmaf(rcp(ex2(s[r] * P.k_cap) + 1.f), -2.f * P.cl,
                             P.cl)
                      : s[r] * P.k_lin;
        if (MASK) {
          const int qi = row0 + 8 * i;
          const int ki = kc + 8 * j + e;
          const bool live = (!P.causal || qi >= ki) &&
                            (P.window <= 0 || qi - ki < P.window);
          z = ki >= P.S ? -INFINITY : (live ? z : kMasked);
        }
        s[r] = z;
        mx[i] = fmaxf(mx[i], z);
      }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
}

template <int BN>
__device__ __forceinline__ void scores_any(float* s, float* mx,
                                           const Params& P, int row0, int kc,
                                           bool mask) {
  if (mask) {
    if (P.cl > 0.f) scores<BN, true, true>(s, mx, P, row0, kc);
    else scores<BN, true, false>(s, mx, P, row0, kc);
  } else {
    if (P.cl > 0.f) scores<BN, false, true>(s, mx, P, row0, kc);
    else scores<BN, false, false>(s, mx, P, row0, kc);
  }
}

// online softmax: new maxima, O and the partial row sums rescaled, p =
// exp2(z - m) summed in float32 and rounded to bf16 into wgmma's A-operand
// layout (rows r / r + 8, columns 2q, 2q + 1 and 8 + 2q, 9 + 2q of each
// k16 step: the accumulator layout of two n8 column groups)
template <int DP, int BN>
__device__ __forceinline__ void softmax_update(float* s, uint32_t* p,
                                               float* o, float* m, float* l,
                                               const float* mx) {
  float corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float mn = fmaxf(m[i], mx[i]);
    corr[i] = ex2(m[i] - mn);
    m[i] = mn;
    l[i] *= corr[i];
  }
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      o[4 * j + 2 * i] *= corr[i];
      o[4 * j + 2 * i + 1] *= corr[i];
    }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 4 * j + 2 * i + e;
        const float pv = ex2(s[r] - m[i]);
        l[i] += pv;
        s[r] = pv;
      }
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      p[4 * kk + u] = pack_bf16(s[8 * kk + 2 * u], s[8 * kk + 2 * u + 1]);
}

template <int DP, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const Params P) {
  using L = Layout<DP, BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + L::kQBytes;
  const uint32_t sv = sk + L::ST * L::kKVBytes;
  const uint32_t full_q = sv + L::ST * L::kKVBytes;
  const uint32_t full_k = full_q + 8;  // + 8 * stage, as the two below
  const uint32_t full_v = full_k + 8 * L::ST;
  const uint32_t empty = full_v + 8 * L::ST;

  const int qt = P.nq - 1 - (int)blockIdx.x;  // longest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / P.G;
  const int q0 = qt * kBM;
  const int q_last = min(q0 + kBM, P.S) - 1;
  const int kt_end = P.causal ? q_last / BN + 1 : (P.S + BN - 1) / BN;
  const int kt_begin = P.window > 0 ? max(0, q0 - P.window + 1) / BN : 0;
  const int n = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int st = 0; st < L::ST; ++st) {
      mbar_init(full_k + 8 * st, 1);
      mbar_init(full_v + 8 * st, 1);
      mbar_init(empty + 8 * st, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the K / V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, L::kQBytes);
      for (int c = 0; c < L::NC; ++c)
        tma_load(&qmap, sq + c * L::kQBox, full_q, 64 * c, q0, h, b);
      for (int i = 0; i < n; ++i) {
        const int st = i % L::ST;
        const int k0 = (kt_begin + i) * BN;
        mbar_wait(empty + 8 * st, ((i / L::ST) & 1) ^ 1);
        mbar_expect_tx(full_k + 8 * st, L::kKVBytes);
        for (int c = 0; c < L::NC; ++c)
          tma_load(&kmap, sk + st * L::kKVBytes + c * L::kKVBox,
                   full_k + 8 * st, 64 * c, k0, kvh, b);
        mbar_expect_tx(full_v + 8 * st, L::kKVBytes);
        for (int c = 0; c < L::NC; ++c)
          tma_load(&vmap, sv + st * L::kKVBytes + c * L::kKVBox,
                   full_v + 8 * st, 64 * c, k0, kvh, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1;
  const int t = threadIdx.x - 128 * wg;
  const int lane = t & 31;
  const int row0 = q0 + 64 * cw + 16 * (t / 32) + lane / 4;
  const int col = 2 * (lane & 3);
  const int r_first = q0 + 64 * cw;
  const uint32_t qa = sq + cw * 64 * kBoxBytes;
  // named barrier 1 + cw: this warpgroup's turn at the tensor cores
  const int my_turn = 1 + cw, their_turn = 2 - cw;

  float o[DP / 2], s[BN / 2], m[2], l[2], mx[2];
  uint32_t p[BN / 4];
#pragma unroll
  for (int r = 0; r < DP / 2; ++r) o[r] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  // a tile needs masks only where it crosses the diagonal, the window edge
  // or S for some row of this warpgroup
  auto needs_mask = [&](int k0) {
    return k0 + BN > P.S || (P.causal && k0 + BN - 1 > r_first) ||
           (P.window > 0 && r_first + 63 - k0 >= P.window);
  };

  if (cw == 1) named_arrive(1);  // warpgroup 0 takes the first turn
  mbar_wait(full_q, 0);

  // tile 0: S only
  mbar_wait(full_k, 0);
  named_sync(my_turn);
  wgmma_fence();
  issue_s<DP, BN>(s, qa, sk);
  wgmma_commit();
  named_arrive(their_turn);
  wgmma_wait<0>();
  fence_regs<BN / 2>(s);
  scores_any<BN>(s, mx, P, row0, kt_begin * BN + col,
                 needs_mask(kt_begin * BN));
  softmax_update<DP, BN>(s, p, o, m, l, mx);

  for (int i = 1; i < n; ++i) {
    const int st = i % L::ST, pst = (i - 1) % L::ST;
    const int k0 = (kt_begin + i) * BN;
    mbar_wait(full_k + 8 * st, (i / L::ST) & 1);
    mbar_wait(full_v + 8 * pst, ((i - 1) / L::ST) & 1);
    named_sync(my_turn);
    wgmma_fence();
    issue_s<DP, BN>(s, qa, sk + st * L::kKVBytes);
    wgmma_commit();
    issue_pv<DP, BN>(o, p, sv + pst * L::kKVBytes);
    wgmma_commit();
    named_arrive(their_turn);
    wgmma_wait<1>();  // S_i is in; P_{i-1} V_{i-1} may still run
    fence_regs<BN / 2>(s);
    scores_any<BN>(s, mx, P, row0, k0 + col, needs_mask(k0));
    wgmma_wait<0>();
    fence_regs<DP / 2>(o);
    mbar_arrive(empty + 8 * pst);
    softmax_update<DP, BN>(s, p, o, m, l, mx);
  }

  const int lst = (n - 1) % L::ST;
  mbar_wait(full_v + 8 * lst, ((n - 1) / L::ST) & 1);
  named_sync(my_turn);
  wgmma_fence();
  issue_pv<DP, BN>(o, p, sv + lst * L::kKVBytes);
  wgmma_commit();
  named_arrive(their_turn);
  wgmma_wait<0>();
  fence_regs<DP / 2>(o);
  mbar_arrive(empty + 8 * lst);
  if (cw == 0) named_sync(my_turn);  // matches warpgroup 1's first arrive

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    inv[i] = 1.f / lt;
  }
  __nv_bfloat16* ob = P.o + (long long)(b * P.H + h) * P.S * P.D;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 8 * i;
      const int d = 8 * j + col;
      if (r < P.S && d < P.D)
        *reinterpret_cast<uint32_t*>(ob + (long long)r * P.D + d) =
            pack_bf16(o[4 * j + 2 * i] * inv[i],
                      o[4 * j + 2 * i + 1] * inv[i]);
    }
}

// ---------------------------------------------------------------- host ---

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled through the runtime, so the library
// needs no -lcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a [B, heads, S, D] bf16 view (strides in elements) as a 4-D map with
// boxes of {64 columns, rows}, 128-byte swizzle, zeros out of bounds
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B,
              int heads, int S, int D, long long sb, long long sh,
              long long ss, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, int BN>
int launch(const void* q, const void* k, const void* v, const Params& P,
           int B, int KVH, const long long* st, cudaStream_t stream) {
  using L = Layout<DP, BN>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap qm, km, vm;
  if (!make_map(enc, &qm, q, B, P.H, P.S, P.D, st[0], st[1], st[2], kBM) ||
      !make_map(enc, &km, k, B, KVH, P.S, P.D, st[3], st[4], st[5], BN) ||
      !make_map(enc, &vm, v, B, KVH, P.S, P.D, st[6], st[7], st[8], BN))
    return (int)cudaErrorInvalidPitchValue;
  auto kern = flash_fwd_wgmma<DP, BN>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(P.nq, P.H, B);
  kern<<<grid, kThreads, L::kSmem, stream>>>(qm, km, vm, P);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, H, S, D], k / v [B, KVH, S, D] bf16 with the given (batch, head,
// row) strides in elements, each a multiple of 8, a contiguous last axis
// and 16-byte aligned bases; o [B, H, S, D] bf16 contiguous; D a multiple
// of 8 up to 256.  Returns a cudaError_t: cudaErrorInvalidPitchValue when
// the driver refuses a tensor map, cudaErrorNotSupported without
// cuTensorMapEncodeTiled.
extern "C" int flash_attention_wgmma_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KVH, int S, int D, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, float scale, int causal, int window,
    float softcap, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (D <= 0 || D > 256 || D % 8 != 0 || KVH <= 0 || H % KVH != 0 ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh,
                           k_ss, v_sb, v_sh, v_ss};
  Params P;
  P.o = static_cast<__nv_bfloat16*>(o);
  P.H = H;
  P.G = H / KVH;
  P.S = S;
  P.D = D;
  P.nq = (S + kBM - 1) / kBM;
  P.causal = causal;
  P.window = window;
  P.k_lin = scale * kLog2e;
  P.k_cap = softcap > 0.f ? 2.f * kLog2e * scale / softcap : 0.f;
  P.cl = softcap > 0.f ? softcap * kLog2e : 0.f;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64) return launch<64, 128>(q, k, v, P, B, KVH, st, s);
  if (D <= 128) return launch<128, 128>(q, k, v, P, B, KVH, st, s);
  return launch<256, 64>(q, k, v, P, B, KVH, st, s);
}
