// GTChain segment sum for Hopper (sm_90a): y[r, :] = sum_{e: seg[e] == r} data[e, :].
//
// Replaces the Pallas kernel segment_matmul_sorted
// (src/repro/kernels/segment_matmul/kernel.py), which reduces
// destination-sorted 128-edge tiles with a one-hot MXU matmul into a VMEM
// output block.  Only the sum is carried over, not the one-hot trick: on
// Hopper the sum has no arithmetic worth a tensor core (one add per edge and
// feature), so the bound is bytes moved -- the payload of each edge whose
// row is in range read once, every segment id read once, and each output
// row written once, over 3.35 TB/s.
//
// Layout contract (set up by the wrapper in
// repro_torch/kernels/segment_matmul/ops.py with plain tensor ops, as the
// reference also sorts outside its kernel): `order` is a stable sort of the
// edges by destination row, with out-of-range rows sorted last, and
// row_ptr[r] .. row_ptr[r + 1] is row r's span of `order`.
//
// Design:
//   * one warp per output row, no atomics: every output element is written
//     by exactly one lane, and each lane adds its strided share of the row's
//     edges in a fixed order before a fixed xor-shuffle tree.  The same
//     inputs give the same bits on every run (the overlay and replica
//     bit-identity of the serving stack needs this);
//   * the warp's 32 lanes are split into FL lanes across features and
//     32 / FL lanes across edges, so F = 1 (push / pull) uses every lane on
//     edges and wide features (push_feat) load neighbouring addresses;
//   * lanes accumulate in float64: the loop is bound by its dependent
//     random loads, so the wider add is free, and a hub row of 10^5 edges
//     stays within one float32 rounding of the exact sum;
//   * known imbalance: a hub row is walked by one warp while short rows
//     finish at once.  Splitting hub rows across blocks is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void segment_sum_rows(const float* __restrict__ data,
                                 const int64_t* __restrict__ order,
                                 const int64_t* __restrict__ row_ptr,
                                 float* __restrict__ out, int64_t num_rows,
                                 int F, int feat_lanes_log2) {
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= num_rows) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int FL = 1 << feat_lanes_log2;
  const int EL = 32 >> feat_lanes_log2;
  const int fl = lane & (FL - 1);
  const int el = lane >> feat_lanes_log2;
  const int64_t start = row_ptr[row];
  const int64_t stop = row_ptr[row + 1];
  for (int f0 = 0; f0 < F; f0 += FL) {
    const int f = f0 + fl;
    double acc = 0.0;
    if (f < F) {
#pragma unroll 4
      for (int64_t j = start + el; j < stop; j += EL) {
        acc += (double)data[order[j] * F + f];
      }
    }
    for (int off = 16; off >= FL; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (el == 0 && f < F) out[row * F + f] = (float)acc;
  }
}

}  // namespace

extern "C" int segment_sum_f32(const float* data, const int64_t* order,
                               const int64_t* row_ptr, float* out,
                               long long num_rows, int F, void* stream) {
  if (num_rows <= 0 || F <= 0) return 0;
  int log2 = 0;
  while ((1 << log2) < F && log2 < 5) ++log2;
  const long long blocks = (num_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  segment_sum_rows<<<(unsigned)blocks, 32 * kWarpsPerBlock, 0,
                     (cudaStream_t)stream>>>(data, order, row_ptr, out,
                                             num_rows, F, log2);
  return (int)cudaGetLastError();
}
