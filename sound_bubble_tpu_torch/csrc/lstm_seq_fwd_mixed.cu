// The mixed single-direction forward of the custom-VJP route (row 6b):
// `sbt_lstm_seq_fwd` (csrc/lstm_seq.cu) calls it for nd = 1 and a mixed
// (x, weights) pair. A source of its own so that its eight instantiations of
// the walk compile beside lstm_seq.cu's.
//
// Replaces the mixed branch of `lstm_seq_fwd` (`sound_bubble_tpu/ops/pallas/
// lstm_train_kernel.py`, body `_fwd_kernel`, `mixed=True`): the LSTM over
// bf16 x [T, R, C] from (h0, c0) with bf16 or fp32 weights, rounding where
// the Pallas body rounds (RND_SEQ, csrc/lstm_fwd32.cuh's header comment);
// y [T, R, H] and the post-activation gates [T, R, 4H] in bf16, the cell
// states c [T, R, H] in fp32.
//
// What bounds it (H100 SXM; the bf16 recipe's inter LSTM, [313, 1160, 32],
// H = 64): it moves ~0.35 GB (x in; y, gates, c out), 0.10 ms at 3.35
// TB/s. In practice the recurrence bounds it: T dependent frames a row
// tile. The design it replaces (8-row blocks, each thread a 96-long dot
// over [x | h] a frame with W re-read from shared memory, 145 blocks on 132
// SMs) was latency-bound in that dot.
//
// Design: the walk of csrc/lstm_fwd32.cuh in its mixed mode SEQ: rows a
// block for one wave (`fwd_row_tiles(..., bseq=True)`: 9 at R = 1160, 129
// blocks), each slab's projection into a bf16 gx tile of 4 frames before
// its walk (on the tensor cores for bf16 weights), W_hh in registers, four
// rows a group on the serial chain, the first frame from bf16(h0) and c0:
// row 8b's layout and order, on one direction from (h0, c0).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "lstm_fwd32.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <int H, typename WT>
__global__ void __launch_bounds__(4 * H, 1) seq_fwd_mixed_kernel(
    const bf16* __restrict__ x, const WT* __restrict__ w_ih,
    const WT* __restrict__ w_hh, const WT* __restrict__ b,
    const float* __restrict__ h0, const float* __restrict__ c0,
    bf16* __restrict__ y, bf16* __restrict__ gates,
    float* __restrict__ cseq, int T, int R, int C, int rows) {
  sbt_fwd32::walk<H, sbt_fwd32::SEQ, 0, bf16, WT, sbt_fwd32::RND_SEQ>(
      x, w_ih, w_hh, b, h0, c0, {y, gates, cseq}, nullptr, nullptr, nullptr,
      T, R, C, min(T, sbt_fwd32::KMAX / 2), 0, rows, blockIdx.x);
}

template <typename WT>
int seq_fwd_mixed(const void* x, const void* w_ih, const void* w_hh,
                  const void* b, const float* h0, const float* c0, void* y,
                  void* gates, float* cseq, int T, int R, int C, int H,
                  int rows, cudaStream_t st) {
  static void (*const ks[4])(const bf16*, const WT*, const WT*, const WT*,
                             const float*, const float*, bf16*, bf16*,
                             float*, int, int, int, int) = {
      seq_fwd_mixed_kernel<8, WT>, seq_fwd_mixed_kernel<16, WT>,
      seq_fwd_mixed_kernel<32, WT>, seq_fwd_mixed_kernel<64, WT>};
  constexpr bool tc = std::is_same<WT, bf16>::value;
  return sbt_fwd32::launch_smem(
      ks, sbt_fwd32::smem_mixed(C, H, rows, tc, true), H, T, R, rows, 1, st,
      (const bf16*)x, (const WT*)w_ih, (const WT*)w_hh, (const WT*)b, h0, c0,
      (bf16*)y, (bf16*)gates, cseq, T, R, C, rows);
}

}  // namespace

// dtypes: 1 = (bf16, bf16), 2 = (bf16, fp32) (`DTYPES` in
// ops/kernels/lstm_slab.py); rows: rows a block, ceil(R / rows) blocks (its
// shared memory is sbt_lstm_fwd_mixed_smem's with bseq = 1). A CUDA error
// code, or cudaErrorInvalidValue for a shape or pair it does not take.
int sbt_seq_fwd_mixed(int dtypes, const void* x, const void* w_ih,
                      const void* w_hh, const void* b, const float* h0,
                      const float* c0, void* y, void* gates, float* cseq,
                      int T, int R, int C, int H, int rows, cudaStream_t st) {
  if (dtypes == 1)
    return seq_fwd_mixed<bf16>(x, w_ih, w_hh, b, h0, c0, y, gates, cseq, T,
                               R, C, H, rows, st);
  if (dtypes == 2)
    return seq_fwd_mixed<float>(x, w_ih, w_hh, b, h0, c0, y, gates, cseq, T,
                                R, C, H, rows, st);
  return (int)cudaErrorInvalidValue;
}
