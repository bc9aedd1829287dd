// Fused-direction inference BLSTM, fp32: both directions of a bidirectional
// LSTM from zero states, the input projection included, in one launch.
//
// Replaces the whole of `sound_bubble_tpu/ops/pallas/lstm_kernel.py:
// blstm_pallas`: its Pallas TPU kernel (body `_kernel`, the recurrence over
// the gate-major pack of `_pack_weights`) and what the function computes
// around its `pallas_call` (the pack and the input projection x @ W_ih + b).
// Inputs: x [R, T, C], batch-major as `blstm_pallas` takes it, and each
// direction's own w_ih [C, 4H], w_hh [H, 4H], b [4H] as the port stores them
// (PyTorch cell, gate order [i, f, g, o]). There is no pack: column
// g*2H + d*H + j of `_pack_weights` is column g*H + j of direction d's
// tensors, so reading those is the same function. Output y [R, T, 2H] =
// [y_f | y_b], both in original time order (the layout `blstm_pallas`
// returns after its flip).
//
// What bounds it on an H100: x, the weights and y, 4 B each:
// 4*(R*T*C + 2*(C+H+1)*4H + R*T*2H); the products 2*T*R*2*(C+H)*4H FLOP at
// the fp32 rate (67 TFLOP/s). Serving (R = 1, T = 145, C = 32, H = 64):
// 14.3 MFLOP, 0.21 us, and 0.29 MB, 0.09 us; offline (R = 250 frames of a
// 2 s clip): 3.56 GFLOP, 53 us. Neither is reachable at R = 1: the
// recurrence is T dependent frames of a row tile.
//
// Design: the walk of csrc/lstm_fwd32.cuh in its INFER mode (see there),
// which the fp32 training forwards (rows 6a, 8a, 10a) share: one block of
// 4H threads a direction and row tile, the two directions in the two halves
// of the grid (the backward one walks reversed), rows a block the fewest
// that keep both halves within one wave (the wrapper's `row_tile`: 1 at
// R <= 66, 4 at R = 250); each 8-frame slab's x rows copied in by
// `cp.async` and projected as one product into shared memory before its
// walk (passes as wide as the rows, so R = 1 computes no padding row),
// W_hh in registers, one barrier a frame. H = 64 only, the width of every
// config of the repo. The kernel is compiled for 1 and for 4 rows a block
// (serving; the offline 2 s clip) besides any rows: with the rows known
// the frame has no jump table and a smaller body (154 / 186 registers
// against 239), 16 % faster at R = 1 (PERF.md §6).
// Why not both directions in one block of 8H threads: a thread could
// then hold at most 128 registers, where the walk holds ~240 at 4H. Why
// the projection inside: as ~10 small PyTorch launches around the kernel
// (pack, product, bias) it made the whole function slower than cuDNN's
// bidirectional LSTM at R <= 4 (PERF.md §6).
// No TF32 and no fast-math: fp32 FMA and expf (lstm_fwd32.cuh's activations).
#include <cuda_runtime.h>

#include "lstm_fwd32.cuh"

namespace {

constexpr int kH = 64;   // the hidden width of every config of the repo

template <int H, int RT>
__global__ void __launch_bounds__(4 * H, 1) blstm_infer_kernel(
    const float* __restrict__ x, const float* __restrict__ w_ih_f,
    const float* __restrict__ w_hh_f, const float* __restrict__ b_f,
    const float* __restrict__ w_ih_b, const float* __restrict__ w_hh_b,
    const float* __restrict__ b_b, float* __restrict__ y, int T, int R,
    int C, int rows) {
  const int tiles = (R + rows - 1) / rows;
  const int d = blockIdx.x >= tiles, tile = blockIdx.x - d * tiles;
  sbt_fwd32::walk<H, sbt_fwd32::INFER, RT>(
      x, d ? w_ih_b : w_ih_f, d ? w_hh_b : w_hh_f, d ? b_b : b_f, nullptr,
      nullptr, {y + d * H, nullptr, nullptr}, nullptr, nullptr, nullptr, T,
      R, C, min(T, sbt_fwd32::KMAX), d, rows, tile);
}

}  // namespace

// x [R, T, C] (16-byte aligned, C a multiple of 4), each direction's
// w_ih [C, 4H], w_hh [H, 4H], b [4H], y [R, T, 2H] out; rows a block (the
// grid is 2 x ceil(R / rows) blocks); H = kH. A CUDA error code, or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int sbt_blstm_infer(const float* x, const float* w_ih_f,
                               const float* w_hh_f, const float* b_f,
                               const float* w_ih_b, const float* w_hh_b,
                               const float* b_b, float* y, int T, int R,
                               int C, int H, int rows, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  if (H != kH) return (int)cudaErrorInvalidValue;
  using K = void (*const)(const float*, const float*, const float*,
                          const float*, const float*, const float*,
                          const float*, float*, int, int, int, int);
  // serving (R <= 66) walks 1 row a block, the offline 2 s clip 4
  static K k1[4] = {nullptr, nullptr, nullptr, blstm_infer_kernel<kH, 1>};
  static K k4[4] = {nullptr, nullptr, nullptr, blstm_infer_kernel<kH, 4>};
  static K kn[4] = {nullptr, nullptr, nullptr, blstm_infer_kernel<kH, 0>};
  return sbt_fwd32::launch(rows == 1 ? k1 : rows == 4 ? k4 : kn, H, C, T, R,
                           rows, 2, (cudaStream_t)stream, x, w_ih_f, w_hh_f,
                           b_f, w_ih_b, w_hh_b, b_b, y, T, R, C, rows);
}
