// Prefill flash attention for Hopper (sm_90a), float32 in and out: GQA,
// causal mask, sliding window, Gemma-2 logit softcap, online softmax in
// float32, the products on the tensor cores through split TF32.
//
// Replaces, for float32 inputs, the Pallas kernel flash_attention
// (src/repro/kernels/flash_attention/kernel.py:69, body :24-66).  bf16
// inputs go to csrc/flash_attention_wgmma.cu; the wrapper picks by dtype.
//
// What bounds it: at the serve shape (B 8, H 32, S 6,205, D 128) the work
// is 4 * D multiply-adds per live (query, key) pair.  On the CUDA cores in
// float32 (67 TFLOP/s) that is a 37.7 ms floor.  TF32 on the tensor cores
// (495 TFLOP/s) keeps 11 significant bits, too few for the float32
// tolerance, so each operand x is split into two TF32 parts,
// hi = rna(x) and lo = rna(x - hi) (22 bits together), and a product
// a.b is taken as hi_a.hi_b + hi_a.lo_b + lo_a.hi_b (the dropped lo.lo term
// is ~2^-22 of it): three TF32 products for each float32 one, a 15.3 ms
// floor at the serve shape.
//
// Design:
//   * a prep kernel splits Q and K into hi / lo copies [B, heads, S, DP]
//     (D padded with zeros to DP = 32, 64, 128 or 256) and writes V
//     transposed, [B, KVH, DP, Sp] (Sp = S rounded up to 64, so every kv
//     tile's boxes start inside it), hi and lo:
//     wgmma takes 32-bit operands only K-major, and V as the B operand of
//     P V is K-major only when transposed.  Within each group of 8 keys
//     the transposed V holds the keys in the order 0 2 4 6 1 3 5 7, the
//     order in which the score accumulator's registers sit in the A
//     fragment of P V (below), so P needs no shuffle;
//   * the attention kernel: one CTA per (batch, head, 128-row query tile),
//     two consumer warpgroups of 64 rows that share each K / V tile, and a
//     producer warp.  The producer's lane 0 loads the Q tile once and then
//     K_0, V_0, K_1, V_1, ... into a ring of NS slots
//     (cp.async.bulk.tensor, 128-byte swizzle, mbarrier completion), each
//     slot a tile's hi and lo parts.  Each warpgroup runs S, softmax, P V in
//     turn; with two of them, one's softmax runs while the other's products
//     hold the tensor cores;
//   * S = Q K^T: per k8 step three wgmma m64nBNk8 tf32 products with both
//     operands in shared memory, float32 accumulators in registers: hi.hi
//     in one, hi.lo + lo.hi in another, added once the tile is done.  The
//     tensor cores truncate every sum they take to the accumulator's
//     precision; summed into one accumulator, those truncations doubled
//     the error at twice standard-normal inputs (logits four times as
//     large) and took it past the float32 bound at D 128 and 256; then
//     scale, softcap (tanhf), masks (only on tiles that cross the diagonal,
//     the window edge or S) and the online softmax in float32 in registers;
//   * P is split in registers (cvt.rna.tf32) and kept in wgmma's A-register
//     layout: the accumulator gives a thread the columns 2t, 2t + 1 of each
//     8-key group, which wgmma's tf32 A fragment reads as its columns t and
//     t + 4 -- hence V's key order above.  O += P V by three wgmma
//     m64n64k8 (n32 at DP 32) products a k8 step, V from shared memory;
//   * tile skipping as before: kv tiles up to the diagonal when causal, from
//     q0 - window + 1 with a window, per warpgroup; the longest causal tiles
//     first.  Masked scores are -1e30 as in the reference, keys past S -inf;
//   * shared memory per CTA, hi and lo taking twice float32's room: at D 128
//     Q 128 KB and three 32 KB slots of 32 keys (225 KB); at D 64 Q 64 KB
//     and three 32 KB slots of 64 keys; at D <= 32 Q 32 KB and four 16 KB
//     slots; at D 256 one warpgroup, Q 128 KB and one 64 KB slot of 32 keys.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBoxBytes = 128;  // one swizzled row: 32 float columns
constexpr int kBoxCols = 32;
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

// one box {32 columns, rows, 1, 1} of a 4-D tensor map into shared memory
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

// x rounded to TF32 (10 fraction bits), to nearest, ties away from zero
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// wgmma shared-memory descriptor, K-major, 128-byte swizzle: rows of 32
// floats, 8-row groups 1024 bytes apart (SBO), no LBO
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
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
#define ACC16 ACC8(0), ACC8(8)
#define ACC32 ACC16, ACC8(16), ACC8(24)
#define REGS16                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15}"
#define REGS32                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
  "%28, %29, %30, %31}"

// d[64 x N] (+)= A[64 x 8] B[8 x N], tf32, A and B K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int accumulate);
template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " REGS32
      ", %32, %33, p, 1, 1;\n}\n"
      : ACC32
      : "l"(a), "l"(b), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_ss<32>(float* d, uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " REGS16
      ", %16, %17, p, 1, 1;\n}\n"
      : ACC16
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x N] += A[64 x 8] B[8 x N], tf32, A in registers (four a thread),
// B K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " REGS16
      ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : ACC16
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ------------------------------------------------------------- prep ----

struct Strides {
  long long b, h, s;
};

// x [B, heads, S, D] (strided, last axis contiguous) -> hi, lo
// [B, heads, S, DP] contiguous, zero past D.  A thread splits 4 columns of
// one of the `rows` = B * heads * S rows
__global__ void split_rows(const float* __restrict__ x, Strides xs, int heads,
                           int S, int D, int DP, float* __restrict__ hi,
                           float* __restrict__ lo, int rows) {
  const int lanes = DP / 4;
  const int r = blockIdx.x * (blockDim.x / lanes) + threadIdx.x / lanes;
  if (r >= rows) return;
  const int d0 = 4 * (threadIdx.x % lanes);
  const int s = r % S, bh = r / S;
  const int b = bh / heads, h = bh - b * heads;
  const float* src = x + b * xs.b + h * xs.h + s * xs.s;
  float val[4], hv[4], lv[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    val[e] = d0 + e < D ? src[d0 + e] : 0.f;
    const uint32_t h32 = tf32(val[e]);
    hv[e] = __uint_as_float(h32);
    lv[e] = __uint_as_float(tf32(val[e] - hv[e]));
  }
  const long long at = (long long)r * DP + d0;
  *reinterpret_cast<float4*>(hi + at) =
      make_float4(hv[0], hv[1], hv[2], hv[3]);
  *reinterpret_cast<float4*>(lo + at) =
      make_float4(lv[0], lv[1], lv[2], lv[3]);
}

// v [B, KVH, S, D] (strided) -> hi, lo [B, KVH, DP, Sp]: V transposed, keys
// in the order 0 2 4 6 1 3 5 7 within each group of 8, zero past S and D.
// A block moves a 32-key x 32-column tile through shared memory
__global__ void split_vt(const float* __restrict__ v, Strides vs, int KVH,
                         int S, int D, int DP, int Sp,
                         float* __restrict__ hi, float* __restrict__ lo) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  const int bh = blockIdx.z;
  const int b = bh / KVH, h = bh - b * KVH;
  const int tx = threadIdx.x, ty = threadIdx.y;  // 32 x 8
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int key = k0 + ty + 8 * r, d = d0 + tx;
    tile[ty + 8 * r][tx] =
        key < S && d < D ? v[b * vs.b + h * vs.h + key * vs.s + d] : 0.f;
  }
  __syncthreads();
  const int pos = k0 + tx;  // column of the transposed row
  const int g = tx & 7;     // its key within the group of 8
  const int src = (tx & ~7) + (g < 4 ? 2 * g : 2 * (g - 4) + 1);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int d = d0 + ty + 8 * r;
    if (pos < Sp && d < DP) {
      const float x = tile[src][ty + 8 * r];
      const uint32_t h32 = tf32(x);
      const long long at = ((long long)bh * DP + d) * Sp + pos;
      hi[at] = __uint_as_float(h32);
      lo[at] = __uint_as_float(tf32(x - __uint_as_float(h32)));
    }
  }
}

// ------------------------------------------------------------- kernel ----

struct Params {
  float* o;  // [B, H, S, D] contiguous
  int H, G, S, D, nq;
  int causal, window;
  float scale, softcap;
  float k_cap;  // scale / softcap: the tanh argument from a raw score
};

// DP: padded head dim; NWG: consumer warpgroups (64 query rows each); BN:
// keys a kv tile; NS: ring slots (a slot holds one K or V tile, hi and lo)
template <int DP, int NWG, int BN, int NS>
struct Layout {
  static constexpr int BM = 64 * NWG;                // query rows a CTA
  static constexpr int NC = DP / kBoxCols;           // boxes across D
  static constexpr int kQBox = BM * kBoxBytes;       // one box of Q rows
  static constexpr int kQPart = NC * kQBox;          // hi or lo of Q
  static constexpr int kKBox = BN * kBoxBytes;       // one box of K rows
  static constexpr int kVBox = DP * kBoxBytes;       // one box of V^T rows
  static constexpr int kPart = DP * BN * 4;          // hi or lo of a tile
  static constexpr int kSlot = 2 * kPart;
  static constexpr int kThreads = 128 * NWG + 32;    // + the producer warp
  static constexpr int kBarBytes = 8 * (1 + 2 * NS);
  static constexpr int kSmem = 1024 + 2 * kQPart + NS * kSlot + kBarBytes;
  static_assert(BN % kBoxCols == 0, "a V^T box is 32 keys wide");
  static_assert(kSmem <= 232448, "shared memory of one CTA");
};

// scores -> float32 logits (scale, softcap, masks) in place, and the row
// maxima over the tile, reduced over the quad that shares the rows
template <int BN, bool MASK>
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
        float x = P.softcap > 0.f ? P.softcap * tanhf(s[r] * P.k_cap)
                                  : s[r] * P.scale;
        if (MASK) {
          const int qi = row0 + 8 * i;
          const int ki = kc + 8 * j + e;
          const bool live = (!P.causal || qi >= ki) &&
                            (P.window <= 0 || qi - ki < P.window);
          x = ki >= P.S ? -INFINITY : (live ? x : kMasked);
        }
        s[r] = x;
        mx[i] = fmaxf(mx[i], x);
      }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
}

template <int DP, int NWG, int BN, int NS>
__global__ void __launch_bounds__(Layout<DP, NWG, BN, NS>::kThreads, 1)
    flash_fwd_tf32(const __grid_constant__ CUtensorMap qhi,
                   const __grid_constant__ CUtensorMap qlo,
                   const __grid_constant__ CUtensorMap khi,
                   const __grid_constant__ CUtensorMap klo,
                   const __grid_constant__ CUtensorMap vhi,
                   const __grid_constant__ CUtensorMap vlo, const Params P) {
  using L = Layout<DP, NWG, BN, NS>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t ring = sq + 2 * L::kQPart;
  const uint32_t full_q = ring + NS * L::kSlot;
  const uint32_t full = full_q + 8;  // + 8 * slot, as empty
  const uint32_t empty = full + 8 * NS;

  const int qt = P.nq - 1 - (int)blockIdx.x;  // longest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / P.G;
  const int q0 = qt * L::BM;
  const int q_last = min(q0 + L::BM, P.S) - 1;
  const int kt_end = P.causal ? q_last / BN + 1 : (P.S + BN - 1) / BN;
  const int kt_begin = P.window > 0 ? max(0, q0 - P.window + 1) / BN : 0;
  const int n = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int st = 0; st < NS; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, 128 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NWG) {
    // ---- producer: lane 0 of the last warp keeps the ring full
    if (threadIdx.x == 128 * NWG) {
      mbar_expect_tx(full_q, 2 * L::kQPart);
      for (int c = 0; c < L::NC; ++c) {
        const uint32_t at = sq + c * L::kQBox;
        tma_load(&qhi, at, full_q, kBoxCols * c, q0, h, b);
        tma_load(&qlo, at + L::kQPart, full_q, kBoxCols * c, q0, h, b);
      }
      for (int t = 0; t < 2 * n; ++t) {  // K_0, V_0, K_1, V_1, ...
        const int st = t % NS;
        const uint32_t slot = ring + st * L::kSlot;
        const int k0 = (kt_begin + t / 2) * BN;
        mbar_wait(empty + 8 * st, ((t / NS) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, L::kSlot);
        if (t % 2 == 0) {
          for (int c = 0; c < L::NC; ++c) {
            const uint32_t at = slot + c * L::kKBox;
            tma_load(&khi, at, full + 8 * st, kBoxCols * c, k0, kvh, b);
            tma_load(&klo, at + L::kPart, full + 8 * st, kBoxCols * c, k0,
                     kvh, b);
          }
        } else {
          for (int c = 0; c < BN / kBoxCols; ++c) {
            const uint32_t at = slot + c * L::kVBox;
            tma_load(&vhi, at, full + 8 * st, k0 + kBoxCols * c, 0, kvh, b);
            tma_load(&vlo, at + L::kPart, full + 8 * st, k0 + kBoxCols * c,
                     0, kvh, b);
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup w: query rows q0 + 64 w .. + 63.  The thread
  // holds rows row0 and row0 + 8 and, in each 8-column group j, columns
  // 8 j + col and 8 j + col + 1 of the accumulators
  const int w = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t & 31;
  const int r_first = q0 + 64 * w;
  const int row0 = r_first + 16 * (t / 32) + lane / 4;
  const int col = 2 * (lane & 3);
  const uint32_t qw = sq + w * 64 * kBoxBytes;  // this warpgroup's Q rows
  // the kv tiles with a live key for some row of this warpgroup
  const int w_end = P.causal ? min(r_first + 63, P.S - 1) / BN + 1 : kt_end;
  const int w_begin =
      P.window > 0 ? max(0, r_first - P.window + 1) / BN : 0;

  float o[DP / 2], s[BN / 2], sc[BN / 2], mx[2], m[2], l[2];
  uint32_t phi[BN / 2], plo[BN / 2];
#pragma unroll
  for (int r = 0; r < DP / 2; ++r) o[r] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  mbar_wait(full_q, 0);

  for (int i = 0; i < n; ++i) {
    const int kt = kt_begin + i, k0 = kt * BN;
    const int tk = 2 * i, sk = tk % NS, tv = tk + 1, sv = tv % NS;
    const uint32_t kslot = ring + sk * L::kSlot;
    const uint32_t vslot = ring + sv * L::kSlot;
    if (r_first >= P.S || kt < w_begin || kt >= w_end) {
      // no live key for these rows: hand the slots back once filled
      mbar_wait(full + 8 * sk, (tk / NS) & 1);
      mbar_arrive(empty + 8 * sk);
      mbar_wait(full + 8 * sv, (tv / NS) & 1);
      mbar_arrive(empty + 8 * sv);
      continue;
    }
    // S = Q K^T: hi.hi into s, hi.lo + lo.hi into sc (their truncations
    // 2^-11 smaller than s's), a k8 step; a step moves 32 bytes inside a
    // swizzled box, every fourth starts the next box
    mbar_wait(full + 8 * sk, (tk / NS) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk) {
      const uint32_t qa = qw + (kk / 4) * L::kQBox + (kk % 4) * 32;
      const uint32_t ka = kslot + (kk / 4) * L::kKBox + (kk % 4) * 32;
      wgmma_ss<BN>(s, smem_desc(qa), smem_desc(ka), kk > 0);
      wgmma_ss<BN>(sc, smem_desc(qa), smem_desc(ka + L::kPart), kk > 0);
      wgmma_ss<BN>(sc, smem_desc(qa + L::kQPart), smem_desc(ka), 1);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs<BN / 2>(s);
    fence_regs<BN / 2>(sc);
    mbar_arrive(empty + 8 * sk);
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) s[r] += sc[r];

    // masks only where the tile crosses the diagonal, the window edge or S
    // for some row of this warpgroup
    const bool mask = k0 + BN > P.S || (P.causal && k0 + BN - 1 > r_first) ||
                      (P.window > 0 && r_first + 63 - k0 >= P.window);
    if (mask)
      scores<BN, true>(s, mx, P, row0, k0 + col);
    else
      scores<BN, false>(s, mx, P, row0, k0 + col);
    // online softmax: new maxima, O and the partial sums rescaled
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const float mn = fmaxf(m[i2], mx[i2]);
      const float corr = expf(m[i2] - mn);
      m[i2] = mn;
      l[i2] *= corr;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o[4 * j + 2 * i2] *= corr;
        o[4 * j + 2 * i2 + 1] *= corr;
      }
    }
    // p = exp(x - m), summed in float32, split into TF32 hi and lo in the
    // A fragment: for k8 step j, (row, column t) <- key 8 j + 2 t and
    // (row, column t + 4) <- key 8 j + 2 t + 1, rows r and r + 8
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 4 * j + 2 * i2 + e;
          const float p = expf(s[r] - m[i2]);
          l[i2] += p;
          const uint32_t h32 = tf32(p);
          phi[4 * j + 2 * e + i2] = h32;
          plo[4 * j + 2 * e + i2] = tf32(p - __uint_as_float(h32));
        }

    // O += P V: hi.hi + hi.lo + lo.hi a k8 step over V^T (DP rows of BN
    // keys), in n64 column blocks (n32 at DP 32)
    constexpr int NB = DP < 64 ? DP : 64;
    mbar_wait(full + 8 * sv, (tv / NS) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 8; ++kk) {
      const uint32_t va = vslot + (kk / 4) * L::kVBox + (kk % 4) * 32;
#pragma unroll
      for (int c = 0; c < DP / NB; ++c) {
        const uint32_t at = va + c * NB * kBoxBytes;
        float* oc = o + c * (NB / 2);
        wgmma_rs<NB>(oc, phi + 4 * kk, smem_desc(at));
        wgmma_rs<NB>(oc, phi + 4 * kk, smem_desc(at + L::kPart));
        wgmma_rs<NB>(oc, plo + 4 * kk, smem_desc(at));
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs<DP / 2>(o);
    mbar_arrive(empty + 8 * sv);
  }

  float inv[2];
#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    float lt = l[i2];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    inv[i2] = 1.f / fmaxf(lt, 1e-30f);
  }
  float* ob = P.o + (long long)(b * P.H + h) * P.S * P.D;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = row0 + 8 * i2;
        const int d = 8 * j + col + e;
        if (r < P.S && d < P.D)
          ob[(long long)r * P.D + d] = o[4 * j + 2 * i2 + e] * inv[i2];
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

// a contiguous float32 [B, heads, rows, cols] array as a 4-D map with boxes
// of {32 columns, box_rows}, 128-byte swizzle, zeros out of bounds
bool make_map(EncodeTiled enc, CUtensorMap* map, const float* ptr, int B,
              int heads, int rows, int cols, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)cols * 4;
  const cuuint64_t strides[3] = {row, row * rows, row * rows * heads};
  const cuuint32_t box[4] = {(cuuint32_t)kBoxCols, (cuuint32_t)box_rows, 1,
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
             const_cast<float*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, int NWG, int BN, int NS>
int launch(const float* q, const float* k, const float* v, const Strides* st,
           float* ws, Params P, int B, int KVH, cudaStream_t stream) {
  using L = Layout<DP, NWG, BN, NS>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const int S = P.S, H = P.H, Sp = (S + 63) / 64 * 64;
  const long long nq = (long long)B * H * S * DP;
  const long long nk = (long long)B * KVH * S * DP;
  const long long nv = (long long)B * KVH * DP * Sp;
  float* qh = ws;
  float* ql = qh + nq;
  float* kh = ql + nq;
  float* kl = kh + nk;
  float* vh = kl + nk;
  float* vl = vh + nv;
  const int rows_per_block = 256 / (DP / 4);
  const int qrows = B * H * S, krows = B * KVH * S;
  split_rows<<<(qrows + rows_per_block - 1) / rows_per_block, 256, 0,
               stream>>>(q, st[0], H, S, P.D, DP, qh, ql, qrows);
  split_rows<<<(krows + rows_per_block - 1) / rows_per_block, 256, 0,
               stream>>>(k, st[1], KVH, S, P.D, DP, kh, kl, krows);
  const dim3 tgrid((Sp + 31) / 32, DP / 32, B * KVH);
  split_vt<<<tgrid, dim3(32, 8), 0, stream>>>(v, st[2], KVH, S, P.D, DP, Sp,
                                              vh, vl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  CUtensorMap m[6];
  if (!make_map(enc, &m[0], qh, B, H, S, DP, L::BM) ||
      !make_map(enc, &m[1], ql, B, H, S, DP, L::BM) ||
      !make_map(enc, &m[2], kh, B, KVH, S, DP, BN) ||
      !make_map(enc, &m[3], kl, B, KVH, S, DP, BN) ||
      !make_map(enc, &m[4], vh, B, KVH, DP, Sp, DP) ||
      !make_map(enc, &m[5], vl, B, KVH, DP, Sp, DP))
    return (int)cudaErrorInvalidPitchValue;
  auto kern = flash_fwd_tf32<DP, NWG, BN, NS>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::kSmem);
  if (err != cudaSuccess) return (int)err;
  P.nq = (S + L::BM - 1) / L::BM;
  const dim3 grid(P.nq, H, B);
  kern<<<grid, L::kThreads, L::kSmem, stream>>>(m[0], m[1], m[2], m[3], m[4],
                                             m[5], P);
  return (int)cudaGetLastError();
}

}  // namespace

// floats of workspace flash_attention_fwd needs: hi and lo copies of Q and K
// ([B, heads, S, DP]) and of V transposed ([B, KVH, DP, Sp]); the wrapper
// sizes its workspace by this
extern "C" long long flash_attention_workspace_floats(int B, int H, int KVH,
                                                      int S, int D) {
  const long long DP = D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
  const long long Sp = (S + 63) / 64 * 64;
  return 2 * DP * ((long long)B * H * S + (long long)B * KVH * S +
                   (long long)B * KVH * Sp);
}

// q [B, H, S, D], k / v [B, KVH, S, D] float32 with the given (batch, head,
// row) strides in elements and a contiguous last axis; o [B, H, S, D]
// float32 contiguous; ws a float32 workspace of ws_floats (at least
// flash_attention_workspace_floats(B, H, KVH, S, D)).  D up to 256.
// Launches the split prep
// kernels, then the attention kernel, on `stream`.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* ws,
    long long ws_floats, int B, int H, int KVH, int S, int D,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, float scale, int causal, int window, float softcap,
    void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (D <= 0 || D > 256 || KVH <= 0 || H % KVH != 0 || B > 65535 ||
      H > 65535 || (long long)B * KVH > 65535 ||
      (long long)B * H * S > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (ws == nullptr || ws_floats <
                            flash_attention_workspace_floats(B, H, KVH, S, D))
    return (int)cudaErrorInvalidValue;
  const Strides st[3] = {{q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss},
                         {v_sb, v_sh, v_ss}};
  Params P;
  P.o = static_cast<float*>(o);
  P.H = H;
  P.G = H / KVH;
  P.S = S;
  P.D = D;
  P.causal = causal;
  P.window = window;
  P.scale = scale;
  P.softcap = softcap;
  P.k_cap = softcap > 0.f ? scale / softcap : 0.f;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* w = static_cast<float*>(ws);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return launch<32, 2, 64, 4>(qf, kf, vf, st, w, P, B, KVH, s);
  if (D <= 64) return launch<64, 2, 64, 3>(qf, kf, vf, st, w, P, B, KVH, s);
  if (D <= 128)
    return launch<128, 2, 32, 3>(qf, kf, vf, st, w, P, B, KVH, s);
  return launch<256, 1, 32, 1>(qf, kf, vf, st, w, P, B, KVH, s);
}
