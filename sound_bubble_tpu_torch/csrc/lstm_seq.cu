// The forward LSTM training recurrences of the custom-VJP route, one
// timestep per step, one direction or both directions in one launch, in fp32
// and in the mixed mode (bf16 activations with bf16 or fp32 weights).
//
// Replaces the Pallas TPU kernels of `sound_bubble_tpu/ops/pallas/
// lstm_train_kernel.py`, the JAX package's custom-VJP kernel route:
// - `sbt_lstm_seq_fwd`, nd = 1 <- `lstm_seq_fwd` (body `_fwd_kernel`):
//   the LSTM (PyTorch cell, gate order [i, f, g, o], w_ih [C, 4H],
//   w_hh [H, 4H], one folded bias b [4H]) over scan-major x [T, R, C] from
//   (h0, c0); writes y [T, R, H], the post-activation gates [T, R, 4H] and
//   the cell states c [T, R, H].
// - `sbt_lstm_seq_fwd`, nd = 2 <- `_blstm_fwd` (body `_blstm_fwd_kernel`):
//   both directions of a BLSTM from zero states, on the pack of
//   `_blstm_pack` (w_hh [2H, 8H] block-diagonal, direction-major; b [8H]).
//   Only the two diagonal H x 4H blocks are read and multiplied. At step n
//   the forward direction reads x at time n and the backward one at
//   T-1-n (no flipped copy); y [T, R, 2H] = [y_f | y_b] in original time,
//   gates [T, R, 8H] gate-major with the direction inside and c [T, R, 2H]
//   at the walk's step.
// Both backwards (rows 7, `lstm_seq_bwd`, and 9, the walk of `_bpt_bwd`)
// are the backward walk of csrc/lstm_seq_bwd.cu (`sbt_lstm_seq_bwd`,
// `sbt_blstm_seq_bwd`). The weight and input gradients (dW_ih, dW_hh, db,
// dx) are large products outside these kernels, as in the JAX package
// (`_lpt_bwd`, `_bpt_bwd`).
//
// What bounds them on an H100 (the flagship's training shapes in fp32,
// batch 4 x 2.5 s): the fused-direction forward (intra, T = 145,
// R = 1252, C = 32, H = 64) does 2*T*R*2*(C+H)*4H = 17.8 GFLOP, 0.27 ms at
// 67 TFLOP/s, and must move ~0.58 GB (x in; y, gates, c out), 0.17 ms at
// 3.35 TB/s: operations. The single-direction forward at the inter shape
// (T = 313, R = 580) is half of it. In practice the recurrence bounds
// them: T dependent steps per row tile, each a [rows, K] x [K, 4H]
// product.
//
// The forwards (rows 6a `seq_fwd32_kernel`, 6b `seq_fwd_mixed_kernel` in
// csrc/lstm_seq_fwd_mixed.cu, 8a `seq_bfwd32_kernel`, 8b
// `seq_bfwd_mixed_kernel`) are the walk of
// csrc/lstm_fwd32.cuh, shared with the slab scan's forward, in its modes SEQ
// (one direction, from h0 and c0) and BSEQ (a grid half a direction): rows a
// block for one wave of the card's SMs (`fwd_row_tiles`: 5 at R = 580 and 9
// at R = 1160 in SEQ, 19 at R = 1252 and 38 at R = 2504 in BSEQ), each
// slab's input projection as one product into shared memory before its
// walk (on the tensor cores for bf16 weights), the next slab's x tile copied
// in by cp.async meanwhile, W_hh in registers (four lanes split a unit's
// inputs and reduce by shuffles), four rows a group; a lane applies one
// (row, unit) cell and writes its y, four gates and c. The fp32 forwards
// take K = 8 frames a slab; the mixed ones (RND_SEQ, the Pallas body's
// roundings, the header's comment) keep gx in bf16 at 4 frames a slab.
// A `clock64()` split of the design they replaced (PERF.md §6) found its
// frames latency-bound in a 96-long dot over [x | h] a thread, W re-read
// from shared memory every frame.
//
// The mixed mode (`mixed=True` in the Pallas bodies, the instantiations the
// JAX package's bf16 trunk launches): bf16 values are widened on load and
// sums are taken in fp32, and values are rounded to bf16 exactly where the
// Pallas body rounds: gx = bf16(x W_ih), then + b (rounded again when b is
// bf16); the gates bf16(gx + bf16(h) W_hh); each sigmoid as the body's
// `jax.nn.sigmoid` lowers on bf16, 1 / (1 + exp(-v)) with each of the three
// ops rounded; each tanh and tanh's input c_t; i*g; the output h_t. The
// carried c stays fp32. The bound of a mixed launch counts 2
// bytes for each bf16 tensor and its products at the bf16 tensor-core rate
// (989 TFLOP/s dense), the rate the work could reach.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "lstm_fwd32.cuh"

// row 6b, csrc/lstm_seq_fwd_mixed.cu (a source of its own, so that its
// instantiations compile beside this file's)
int sbt_seq_fwd_mixed(int dtypes, const void* x, const void* w_ih,
                      const void* w_hh, const void* b, const float* h0,
                      const float* c0, void* y, void* gates, float* cseq,
                      int T, int R, int C, int H, int rows, cudaStream_t st);

namespace {

using bf16 = __nv_bfloat16;

// ---- the fp32 single-direction forward (row 6a): csrc/lstm_fwd32.cuh's
// walk, K = min(8, T) frames a slab

template <int H>
__global__ void __launch_bounds__(4 * H, 1) seq_fwd32_kernel(
    const float* __restrict__ x, const float* __restrict__ w_ih,
    const float* __restrict__ w_hh, const float* __restrict__ b,
    const float* __restrict__ h0, const float* __restrict__ c0,
    float* __restrict__ y, float* __restrict__ gates,
    float* __restrict__ cseq, int T, int R, int C, int rows) {
  sbt_fwd32::walk<H, sbt_fwd32::SEQ>(x, w_ih, w_hh, b, h0, c0,
                                     {y, gates, cseq}, nullptr, nullptr,
                                     nullptr, T, R, C,
                                     min(T, sbt_fwd32::KMAX), 0, rows,
                                     blockIdx.x);
}

int seq_fwd32(const void* x, const void* w_ih, const void* w_hh,
              const void* b, const float* h0, const float* c0, void* y,
              void* gates, float* cseq, int T, int R, int C, int H, int rows,
              cudaStream_t st) {
  static void (*const ks[4])(const float*, const float*, const float*,
                             const float*, const float*, const float*,
                             float*, float*, float*, int, int, int, int) = {
      seq_fwd32_kernel<8>, seq_fwd32_kernel<16>, seq_fwd32_kernel<32>,
      seq_fwd32_kernel<64>};
  return sbt_fwd32::launch(ks, H, C, T, R, rows, 1, st, (const float*)x,
                           (const float*)w_ih, (const float*)w_hh,
                           (const float*)b, h0, c0, (float*)y, (float*)gates,
                           cseq, T, R, C, rows);
}

// ---- the fp32 fused-direction forward (row 8a): the same walk, one block
// a direction and row tile: blocks [0, tiles) walk the forward direction,
// [tiles, 2 tiles) the backward one (reversed) with w_ih_b, b[4H:] and the
// pack's second diagonal block of W_hh; both write y, gates and c at the
// direction's offset d*H of the two-direction layout

template <int H>
__global__ void __launch_bounds__(4 * H, 1) seq_bfwd32_kernel(
    const float* __restrict__ x, const float* __restrict__ w_ih_f,
    const float* __restrict__ w_ih_b, const float* __restrict__ w_hh,
    const float* __restrict__ b, float* __restrict__ y,
    float* __restrict__ gates, float* __restrict__ cseq, int T, int R,
    int C, int rows) {
  const int tiles = (R + rows - 1) / rows;
  const int d = blockIdx.x >= tiles, tile = blockIdx.x - d * tiles;
  sbt_fwd32::walk<H, sbt_fwd32::BSEQ>(
      x, d ? w_ih_b : w_ih_f, w_hh + d * (H * 8 * H + 4 * H), b + d * 4 * H,
      nullptr, nullptr, {y + d * H, gates + d * H, cseq + d * H}, nullptr,
      nullptr, nullptr, T, R, C, min(T, sbt_fwd32::KMAX), d, rows, tile);
}

int seq_bfwd32(const void* x, const void* w_ih_f, const void* w_ih_b,
               const void* w_hh, const void* b, void* y, void* gates,
               float* cseq, int T, int R, int C, int H, int rows,
               cudaStream_t st) {
  static void (*const ks[4])(const float*, const float*, const float*,
                             const float*, const float*, float*, float*,
                             float*, int, int, int, int) = {
      seq_bfwd32_kernel<8>, seq_bfwd32_kernel<16>, seq_bfwd32_kernel<32>,
      seq_bfwd32_kernel<64>};
  return sbt_fwd32::launch(ks, H, C, T, R, rows, 2, st, (const float*)x,
                           (const float*)w_ih_f, (const float*)w_ih_b,
                           (const float*)w_hh, (const float*)b, (float*)y,
                           (float*)gates, cseq, T, R, C, rows);
}

// ---- the mixed fused-direction forward (row 8b): the walk in its mixed
// mode, bf16 x, y and gates, WT weights; the grid as row 8a's

template <int H, typename WT>
__global__ void __launch_bounds__(4 * H, 1) seq_bfwd_mixed_kernel(
    const bf16* __restrict__ x, const WT* __restrict__ w_ih_f,
    const WT* __restrict__ w_ih_b, const WT* __restrict__ w_hh,
    const WT* __restrict__ b, bf16* __restrict__ y, bf16* __restrict__ gates,
    float* __restrict__ cseq, int T, int R, int C, int rows) {
  const int tiles = (R + rows - 1) / rows;
  const int d = blockIdx.x >= tiles, tile = blockIdx.x - d * tiles;
  sbt_fwd32::walk<H, sbt_fwd32::BSEQ, 0, bf16, WT, sbt_fwd32::RND_SEQ>(
      x, d ? w_ih_b : w_ih_f, w_hh + d * (H * 8 * H + 4 * H), b + d * 4 * H,
      nullptr, nullptr, {y + d * H, gates + d * H, cseq + d * H}, nullptr,
      nullptr, nullptr, T, R, C, min(T, sbt_fwd32::KMAX / 2), d, rows, tile);
}

template <typename WT>
int seq_bfwd_mixed(const void* x, const void* w_ih_f, const void* w_ih_b,
                   const void* w_hh, const void* b, void* y, void* gates,
                   float* cseq, int T, int R, int C, int H, int rows,
                   cudaStream_t st) {
  static void (*const ks[4])(const bf16*, const WT*, const WT*, const WT*,
                             const WT*, bf16*, bf16*, float*, int, int, int,
                             int) = {
      seq_bfwd_mixed_kernel<8, WT>, seq_bfwd_mixed_kernel<16, WT>,
      seq_bfwd_mixed_kernel<32, WT>, seq_bfwd_mixed_kernel<64, WT>};
  constexpr bool tc = std::is_same<WT, bf16>::value;
  return sbt_fwd32::launch_smem(
      ks, sbt_fwd32::smem_mixed(C, H, rows, tc, true), H, T, R, rows, 2, st,
      (const bf16*)x, (const WT*)w_ih_f, (const WT*)w_ih_b, (const WT*)w_hh,
      (const WT*)b, (bf16*)y, (bf16*)gates, cseq, T, R, C, rows);
}

template <int ND>
int fwd_dtypes(int dtypes, const void* x, const void* w_ih_f,
               const void* w_ih_b, const void* w_hh, const void* b,
               const float* h0, const float* c0, void* y, void* gates,
               float* cseq, int T, int R, int C, int H, int rows,
               cudaStream_t st) {
  switch (dtypes) {
    case 0:
      if constexpr (ND == 1)
        return seq_fwd32(x, w_ih_f, w_hh, b, h0, c0, y, gates, cseq, T, R, C,
                         H, rows, st);
      else
        return seq_bfwd32(x, w_ih_f, w_ih_b, w_hh, b, y, gates, cseq, T, R,
                          C, H, rows, st);
    case 1:
      if constexpr (ND == 1)
        return sbt_seq_fwd_mixed(1, x, w_ih_f, w_hh, b, h0, c0, y, gates,
                                 cseq, T, R, C, H, rows, st);
      else
        return seq_bfwd_mixed<bf16>(x, w_ih_f, w_ih_b, w_hh, b, y, gates,
                                    cseq, T, R, C, H, rows, st);
    case 2:
      if constexpr (ND == 1)
        return sbt_seq_fwd_mixed(2, x, w_ih_f, w_hh, b, h0, c0, y, gates,
                                 cseq, T, R, C, H, rows, st);
      else
        return seq_bfwd_mixed<float>(x, w_ih_f, w_ih_b, w_hh, b, y, gates,
                                     cseq, T, R, C, H, rows, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtypes: the (x, weights) pair, 0 = (fp32, fp32), 1 = (bf16, bf16),
// 2 = (bf16, fp32) (`DTYPES` in ops/kernels/lstm_slab.py); y has the
// activations' type, the gates bf16 in the mixed mode. nd = 1: w_ih_b is
// unused; nd = 2: h0, c0 are unused (zero states), and may be null. rows:
// rows a block of the walk (its shared memory is sbt_lstm_fwd32_smem's, or,
// mixed, sbt_lstm_fwd_mixed_smem's with bseq = 1; nd = 2 launches a grid of
// 2 x ceil(R / rows) blocks).

extern "C" int sbt_lstm_seq_fwd(const void* x, const void* w_ih_f,
                                const void* w_ih_b, const void* w_hh,
                                const void* b, const float* h0,
                                const float* c0, void* y, void* gates,
                                float* cseq, int T, int R, int C, int H,
                                int nd, int dtypes, int rows, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  cudaStream_t st = (cudaStream_t)stream;
  if (nd == 1)
    return fwd_dtypes<1>(dtypes, x, w_ih_f, w_ih_b, w_hh, b, h0, c0, y,
                         gates, cseq, T, R, C, H, rows, st);
  if (nd == 2)
    return fwd_dtypes<2>(dtypes, x, w_ih_f, w_ih_b, w_hh, b, h0, c0, y,
                         gates, cseq, T, R, C, H, rows, st);
  return (int)cudaErrorInvalidValue;
}
