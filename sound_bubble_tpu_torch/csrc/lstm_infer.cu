// Fused-direction inference BLSTM recurrence, fp32: both directions of a
// bidirectional LSTM from zero states in one walk, on precomputed input
// projections.
//
// Replaces the Pallas TPU kernel of `sound_bubble_tpu/ops/pallas/
// lstm_kernel.py:blstm_pallas` (body `_kernel`): the recurrence over the
// gate-major pack of `_pack_weights` (W_hh block-diagonal [2H, 8H], columns
// [i_f i_b | f_f f_b | g_f g_b | o_f o_b], H columns each). Inputs:
// - gx [R, T, 8H], gate-major: x @ W_ih + b of both directions at each
//   original time t (the two directions' columns are disjoint, so one
//   product gives both). The Pallas kernel takes the backward direction's
//   rows pre-reversed; here the walk's step n reads the forward columns at
//   time n and the backward columns at time T-1-n (no flipped copy).
// - w_hh [2H, 8H], the pack; only its two diagonal H x 4H blocks are read.
// Output y [R, T, 2H] = [y_f | y_b], both in original time order (the
// layout `blstm_pallas` returns after its flip). Zero initial (h, c).
//
// What bounds it on an H100: gx in, y out and the diagonal weights, 4 B
// each: 4*(T*R*8H + 2*H*4H + T*R*2H); 2*T*R*2H*4H FLOP at the fp32 rate.
// Serving (R = 1, T = 145, H = 64): 0.50 MB, 0.15 us at 3.35 TB/s; offline
// (R ~ 250 frames of a 2 s clip): 37 MB, 11 us. Neither is reachable: the
// recurrence is T dependent steps, each an [RT, H] x [H, 4H] product a
// direction followed by the cell, so the kernel is bound by the latency of
// one step times T.
//
// Design (simple first; a cluster or tensor-core `mma` across row tiles is
// later work):
// - One thread block owns a tile of RT rows (RT = 1, 2 or 4, the smallest
//   that keeps the grid within one wave of SMs) and walks all T steps
//   itself; no block waits on another (no grid sync, no flags, no clusters).
// - 8H threads; thread `col` owns column col of the pack: its direction's
//   H weights of that column stay in registers for the whole walk, so
//   W_hh is read from global memory once.
// - Per step: each thread forms its gate's pre-activation for the RT rows
//   (gx, prefetched a step ahead into registers, + h @ W_hh; h broadcast from
//   shared memory as float4, four partial sums), writes it to shared memory;
//   after a barrier, thread (row, d, j) of the first RT*2H applies the cell
//   with c in a register, writes h to shared memory and to y. Two barriers
//   a step; 2.5 KB to 10 KB of static shared memory, so no attribute to set.
// No TF32 and no fast-math: fp32 FMA throughout, expf / tanhf.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigm(float v) { return 1.f / (1.f + expf(-v)); }

template <int H, int RT>
__global__ void __launch_bounds__(8 * H) blstm_infer_kernel(
    const float* __restrict__ gx, const float* __restrict__ w_hh,
    float* __restrict__ y, int T, int R) {
  constexpr int H2 = 2 * H, H8 = 8 * H;
  __shared__ float4 gs4[RT * H8 / 4];   // pre-activations [RT][8H]
  __shared__ float4 hs4[RT * H2 / 4];   // h [RT][2H] = [h_f | h_b]
  float* gs = reinterpret_cast<float*>(gs4);
  float* hs = reinterpret_cast<float*>(hs4);
  const int col = threadIdx.x;          // gate-major column of the pack
  const int d = (col / H) & 1;          // its direction
  const int r0 = blockIdx.x * RT;

  // the direction's H weights of this column: rows d*H .. d*H+H-1
  float w[H];
#pragma unroll
  for (int m = 0; m < H; ++m) w[m] = w_hh[(size_t)(d * H + m) * H8 + col];
  for (int i = col; i < RT * H2; i += H8) hs[i] = 0.f;

  // the cell's item: row q, unit u = d*H + j of [h_f | h_b]
  const bool cell = col < RT * H2;
  const int q_c = col / H2, u = col % H2, d_c = u / H;
  const int r_c = r0 + q_c;
  float c = 0.f;

  float pre[RT];
#pragma unroll
  for (int q = 0; q < RT; ++q) {
    const int r = r0 + q, t = d ? T - 1 : 0;
    pre[q] = r < R ? gx[((size_t)r * T + t) * H8 + col] : 0.f;
  }
  __syncthreads();

  for (int n = 0; n < T; ++n) {
    float acc[RT];
#pragma unroll
    for (int q = 0; q < RT; ++q) acc[q] = pre[q];
    // the next step's gx, in flight while this step computes
    if (n + 1 < T) {
      const int t = d ? T - 2 - n : n + 1;
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        const int r = r0 + q;
        pre[q] = r < R ? gx[((size_t)r * T + t) * H8 + col] : 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < RT; ++q) {
      const float4* h4 = hs4 + (q * H2 + d * H) / 4;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int m = 0; m < H / 4; ++m) {
        const float4 hv = h4[m];
        a0 += hv.x * w[4 * m];
        a1 += hv.y * w[4 * m + 1];
        a2 += hv.z * w[4 * m + 2];
        a3 += hv.w * w[4 * m + 3];
      }
      gs[q * H8 + col] = acc[q] + ((a0 + a1) + (a2 + a3));
    }
    __syncthreads();
    if (cell) {
      const float* g = gs + q_c * H8 + u;
      const float ig = sigm(g[0]), fg = sigm(g[H2]);
      const float gg = tanhf(g[2 * H2]), og = sigm(g[3 * H2]);
      c = fg * c + ig * gg;
      const float h = og * tanhf(c);
      hs[q_c * H2 + u] = h;
      if (r_c < R) {
        const int t = d_c ? T - 1 - n : n;   // original time of this output
        y[((size_t)r_c * T + t) * H2 + u] = h;
      }
    }
    __syncthreads();
  }
}

constexpr int kH = 64;   // the hidden width of every config of the repo

template <int RT>
int launch(const float* gx, const float* w_hh, float* y, int T, int R,
           cudaStream_t st) {
  blstm_infer_kernel<kH, RT><<<(R + RT - 1) / RT, 8 * kH, 0, st>>>(
      gx, w_hh, y, T, R);
  return (int)cudaGetLastError();
}

}  // namespace

// gx [R, T, 8H] gate-major (both directions at original time), w_hh the
// [2H, 8H] pack, y [R, T, 2H] out; rt rows a block (1, 2 or 4); H = kH.
extern "C" int sbt_blstm_infer(const float* gx, const float* w_hh, float* y,
                               int T, int R, int H, int rt, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  if (T < 1 || R < 1 || H != kH) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (rt) {
    case 1: return launch<1>(gx, w_hh, y, T, R, st);
    case 2: return launch<2>(gx, w_hh, y, T, R, st);
    case 4: return launch<4>(gx, w_hh, y, T, R, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
