// Single-direction LSTM training scans over scan-major x [T, R, C], forward
// and backward, in fp32 and in the mixed mode (bf16 activations with bf16 or
// fp32 weights).
//
// Replaces the Pallas TPU kernels of `sound_bubble_tpu/ops/pallas/
// lstm_train_slab.py`:
// - `sbt_lstm_slab_fwd` <- `lstm_slab_fwd` (body `_fwd_kernel`): runs the
//   LSTM (PyTorch cell, gate order [i, f, g, o], weights stored transposed
//   for right-matmuls: w_ih [C, 4H], w_hh [H, 4H], one folded bias b [4H])
//   forward or reversed over T, and saves ys [T, R, H], hT, cT [R, H] and the
//   cell state entering each K-frame slab, c_ckpt [nb, R, H], nb = ceil(T/K).
//   In the reverse direction a slab's first processed frame is its last
//   index, and slabs are walked from the end.
// - `sbt_lstm_slab_bwd` <- `lstm_slab_bwd` (body `_bwd_kernel`): for each
//   slab, re-forwards the cell states from c_ckpt (h entering each frame, hp,
//   is an input, so every frame's gates are recomputed without a chain),
//   then walks the slab's frames backwards for the gate gradients and the
//   (dh, dc) chain; then dx = dgates @ w_ih^T and the weight gradients
//   dW_ih = x^T dgates, dW_hh = hp^T dgates, db = sum(dgates).
//
// Frames with t >= T do not exist here (the TPU kernel pads them and passes
// the carry through): the loops skip them. Rows are split into tiles of
// RT = 8; rows of the last tile at or past R are computed on zeros and never
// written.
//
// What bounds them on an H100 (counted on the compact math, fp32, one
// direction of the training shapes, T*R = 181,540 rows, C = 32, H = 64):
// the forward does 2*T*R*(C+H)*4H = 8.92 GFLOP, 0.133 ms at 67 TFLOP/s,
// and must move ~76 MB (x in, ys and c_ckpt out), 0.023 ms at 3.35 TB/s:
// operations bound it. The backward does ~26.8 GFLOP (gate recompute,
// dh chain, dx, dW), 0.40 ms, against ~145 MB, 0.043 ms: operations again.
// In practice the recurrence bounds both: T dependent steps per row tile.
//
// Design (simple first; tensor cores, weights in registers and fusing the
// weight gradients into the walk are later work):
// - One thread block owns a row tile and loops over all T frames itself, so
//   no block ever waits on another (no grid sync, no flags, no clusters).
// - The weights are read once per block into shared memory, gate-interleaved
//   as float4 (w_i, w_f, w_g, w_o) per (input row k, hidden unit j): 96 KB
//   for C + H = 96, H = 64. Thread (j, grp) computes the four gates of unit
//   j for RPT = 2 rows, so the cell state of those cells never leaves its
//   registers; the h that the next frame needs is double-buffered in shared
//   memory, one __syncthreads per frame.
// - The backward keeps the recomputed gates and the entering c of the slab's
//   K = 8 frames in registers, and W_hh^T in shared memory for the dh chain
//   (200 KB of shared memory in all, one block per SM).
// - dgates go to a global scratch [T, R, 4H]. dx is a second kernel, and the
//   weight gradients are per-block partials over row chunks (third kernel)
//   summed over the chunks in a fixed order by a fourth: deterministic, no
//   atomics. This costs 2 x 186 MB of traffic at the training shape, which
//   the TPU kernel avoids by accumulating dW in VMEM.
// No TF32 and no fast-math: fp32 FMA throughout, expf / tanhf.
//
// The mixed mode (`_fwd_kernel` / `_bwd_kernel` with mixed=True, the
// instantiation the JAX package's bf16 trunk launches) is the same code,
// templated on the activation type XT (x, ys, dy, dx) and the weight type WT
// (w_ih, w_hh, b, hp): bf16 operands are widened to fp32 on load (products
// of bf16 values are exact in fp32) and accumulated in fp32, and values are
// rounded to bf16 exactly where the Pallas kernel rounds: the gates
// (gx + bf16(h) W_hh, with gx = x W_ih + b unrounded), each sigmoid / tanh
// output, i*g, tanh's input c_t and the output h_t; the carried c stays
// fp32. The backward keeps the fp32 gate gradients for db (summed per row
// tile in the walk, then over the tiles in a fixed order) and stores them
// as bf16 for the dh chain, dx and the weight gradients, so the dgates
// scratch is half the fp32 one. The mixed branches are `if constexpr`, so
// the fp32 instantiation (XT = WT = float) runs the code path it had before.
// The bound of a mixed scan counts 2 bytes for each bf16 tensor and its
// matrix products at the bf16 tensor-core rate (989 TFLOP/s dense), the
// rate the work could reach; this first instantiation does fp32 FMA on the
// CUDA cores like the fp32 one (bf16 mma / wgmma tiles are later work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float ldf(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ldf(const bf16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void stf(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void stf(bf16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}
// round to bf16 and back (the mixed mode's rounding points)
__device__ __forceinline__ float rb(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename XT, typename WT>
constexpr bool kMixed =
    std::is_same<XT, bf16>::value || std::is_same<WT, bf16>::value;

constexpr int KMAX = 8;   // frames per slab (the TPU kernel's K)
constexpr int G = 4;      // row groups per block
constexpr int RPT = 2;    // rows per thread
constexpr int RT = G * RPT;

__device__ __forceinline__ float sigm(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// acc[q][0..3] = b + xr[q] . w_ih[:, gate*H + j] + hr[q] . w_hh[:, gate*H + j]
// xr / hr: shared rows (stride C / H) of the thread's RPT rows.
__device__ __forceinline__ void gates4(const float4* __restrict__ wp,
                                       const float* xr, const float* hr,
                                       int C, int H, int j, float4 bias,
                                       float4 (&acc)[RPT]) {
#pragma unroll
  for (int q = 0; q < RPT; ++q) acc[q] = bias;
  for (int k = 0; k < C; ++k) {
    const float4 w = wp[k * H + j];
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const float v = xr[q * C + k];
      acc[q].x += v * w.x; acc[q].y += v * w.y;
      acc[q].z += v * w.z; acc[q].w += v * w.w;
    }
  }
  for (int m = 0; m < H; ++m) {
    const float4 w = wp[(C + m) * H + j];
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const float v = hr[q * H + m];
      acc[q].x += v * w.x; acc[q].y += v * w.y;
      acc[q].z += v * w.z; acc[q].w += v * w.w;
    }
  }
}

// wp[k*H + j] = (W[k][j], W[k][H+j], W[k][2H+j], W[k][3H+j]), W = [w_ih; w_hh]
template <typename WT>
__device__ void load_interleaved(float4* wp, const WT* __restrict__ w_ih,
                                 const WT* __restrict__ w_hh, int C,
                                 int H) {
  const int H4 = 4 * H;
  for (int i = threadIdx.x; i < (C + H) * H; i += blockDim.x) {
    const int k = i / H, j = i - k * H;
    const WT* row = k < C ? w_ih + (size_t)k * H4 : w_hh + (size_t)(k - C) * H4;
    wp[i] = make_float4(ldf(row, j), ldf(row, H + j), ldf(row, 2 * H + j),
                        ldf(row, 3 * H + j));
  }
}

template <typename WT>
__device__ __forceinline__ float4 load_bias(const WT* __restrict__ b, int H,
                                            int j) {
  return make_float4(ldf(b, j), ldf(b, H + j), ldf(b, 2 * H + j),
                     ldf(b, 3 * H + j));
}

template <typename XT, typename WT>
__global__ void __launch_bounds__(1024) slab_fwd_kernel(
    const XT* __restrict__ x, const WT* __restrict__ w_ih,
    const WT* __restrict__ w_hh, const WT* __restrict__ b,
    const float* __restrict__ h0, const float* __restrict__ c0,
    XT* __restrict__ ys, float* __restrict__ hT, float* __restrict__ cT,
    float* __restrict__ c_ckpt, int T, int R, int C, int H, int kf,
    int reverse) {
  constexpr bool M = kMixed<XT, WT>;
  extern __shared__ float4 smem4[];
  float4* wp = smem4;                                  // [(C+H)*H]
  float* xbuf = reinterpret_cast<float*>(wp + (C + H) * H);  // [2][RT][C]
  float* hbuf = xbuf + 2 * RT * C;                     // [2][RT][H]
  const int tid = threadIdx.x, nt = blockDim.x;
  const int j = tid % H, grp = tid / H;
  const int r0 = blockIdx.x * RT;

  load_interleaved(wp, w_ih, w_hh, C, H);
  const float4 bias = load_bias(b, H, j);
  float c[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int row = grp * RPT + q, r = r0 + row;
    // the mixed mode's recurrence matmul takes bf16(h)
    const float h = r < R ? h0[(size_t)r * H + j] : 0.f;
    hbuf[row * H + j] = M ? rb(h) : h;
    c[q] = r < R ? c0[(size_t)r * H + j] : 0.f;
  }
  const int t_first = reverse ? T - 1 : 0;
  for (int i = tid; i < RT * C; i += nt) {
    const int row = i / C, r = r0 + row;
    xbuf[i] = r < R ? ldf(x, ((size_t)t_first * R + r) * C + (i - row * C))
                    : 0.f;
  }
  __syncthreads();

  for (int n = 0; n < T; ++n) {
    const int t = reverse ? T - 1 - n : n;
    const int cur = n & 1, nxt = cur ^ 1;
    const bool first = reverse ? (t == T - 1 || (t + 1) % kf == 0)
                               : (t % kf == 0);
    if (first) {
      const int blk = t / kf;
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const int r = r0 + grp * RPT + q;
        if (r < R) c_ckpt[((size_t)blk * R + r) * H + j] = c[q];
      }
    }
    // prefetch the next frame's x tile into registers (stored after compute)
    float pre[4];
    const bool more = n + 1 < T;
    const int t_next = reverse ? t - 1 : t + 1;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = tid + u * nt;
      pre[u] = 0.f;
      if (more && i < RT * C) {
        const int row = i / C, r = r0 + row;
        if (r < R)
          pre[u] = ldf(x, ((size_t)t_next * R + r) * C + (i - row * C));
      }
    }
    float4 acc[RPT];
    gates4(wp, xbuf + cur * RT * C + grp * RPT * C,
           hbuf + cur * RT * H + grp * RPT * H, C, H, j, bias, acc);
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int row = grp * RPT + q, r = r0 + row;
      float h;
      if constexpr (M) {
        const float ig = rb(sigm(rb(acc[q].x))), fg = rb(sigm(rb(acc[q].y)));
        const float gg = rb(tanhf(rb(acc[q].z))), og = rb(sigm(rb(acc[q].w)));
        c[q] = fg * c[q] + rb(ig * gg);
        h = rb(og * rb(tanhf(rb(c[q]))));
      } else {
        const float ig = sigm(acc[q].x), fg = sigm(acc[q].y);
        const float gg = tanhf(acc[q].z), og = sigm(acc[q].w);
        c[q] = fg * c[q] + ig * gg;
        h = og * tanhf(c[q]);
      }
      hbuf[nxt * RT * H + row * H + j] = h;
      if (r < R) stf(ys, ((size_t)t * R + r) * H + j, h);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = tid + u * nt;
      if (more && i < RT * C) xbuf[nxt * RT * C + i] = pre[u];
    }
    __syncthreads();
  }
  const int last = T & 1;
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int row = grp * RPT + q, r = r0 + row;
    if (r < R) {
      hT[(size_t)r * H + j] = hbuf[last * RT * H + row * H + j];
      cT[(size_t)r * H + j] = c[q];
    }
  }
}

// Backward walk: gate gradients dg [T, R, 4H] (torch gate-major columns),
// and dh0, dc0; in the mixed mode also db_part [row tiles, 4H], each tile's
// fp32 sum of its gate gradients. At most 256 threads (4H, H <= 64), so the
// slab's gates stay in registers without spilling.
template <typename XT, typename WT>
using GateT = typename std::conditional<kMixed<XT, WT>, bf16, float>::type;

template <typename XT, typename WT>
__global__ void __launch_bounds__(256) slab_bwd_walk_kernel(
    const XT* __restrict__ x, const WT* __restrict__ hp,
    const float* __restrict__ c_ckpt, const XT* __restrict__ dy,
    const WT* __restrict__ w_ih, const WT* __restrict__ w_hh,
    const WT* __restrict__ b, const float* __restrict__ dhT,
    const float* __restrict__ dcT,
    GateT<XT, WT>* __restrict__ dg,
    float* __restrict__ db_part, float* __restrict__ dh0,
    float* __restrict__ dc0, int T, int R, int C, int H, int kf,
    int reverse) {
  constexpr bool M = kMixed<XT, WT>;
  extern __shared__ float4 smem4[];
  const int H4 = 4 * H;
  float4* wp = smem4;                                    // [(C+H)*H]
  float* whhT = reinterpret_cast<float*>(wp + (C + H) * H);  // [4H][H]
  float* xs = whhT + H4 * H;                             // [KMAX][RT][C]
  float* hs = xs + KMAX * RT * C;                        // [KMAX][RT][H]
  float* dgs = hs + KMAX * RT * H;                       // [2][RT][4H]
  const int tid = threadIdx.x, nt = blockDim.x;
  const int j = tid % H, grp = tid / H;
  const int r0 = blockIdx.x * RT;
  const int nb = (T + kf - 1) / kf;

  load_interleaved(wp, w_ih, w_hh, C, H);
  for (int i = tid; i < H4 * H; i += nt) {
    const int col = i / H, m = i - col * H;
    whhT[i] = ldf(w_hh, (size_t)m * H4 + col);
  }
  const float4 bias = load_bias(b, H, j);
  float dh[RPT], dc[RPT];
  float4 dbacc = make_float4(0.f, 0.f, 0.f, 0.f);   // mixed mode: db
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int r = r0 + grp * RPT + q;
    dh[q] = r < R ? dhT[(size_t)r * H + j] : 0.f;
    dc[q] = r < R ? dcT[(size_t)r * H + j] : 0.f;
  }
  int buf = 0;

  for (int js = 0; js < nb; ++js) {
    const int blk = reverse ? js : nb - 1 - js;
    // the slab's x and hp tiles, slot s = position in processing order
    __syncthreads();   // the previous slab's tiles are no longer read
    for (int i = tid; i < KMAX * RT * (C + H); i += nt) {
      const int s = i / (RT * (C + H));
      const int rem = i - s * RT * (C + H);
      const int t = blk * kf + (reverse ? kf - 1 - s : s);
      const bool ok = s < kf && t < T;
      if (rem < RT * C) {
        const int row = rem / C, r = r0 + row;
        xs[s * RT * C + rem] = ok && r < R
            ? ldf(x, ((size_t)t * R + r) * C + (rem - row * C)) : 0.f;
      } else {
        const int e = rem - RT * C, row = e / H, r = r0 + row;
        hs[s * RT * H + e] = ok && r < R
            ? ldf(hp, ((size_t)t * R + r) * H + (e - row * H)) : 0.f;
      }
    }
    __syncthreads();

    // phase A: recompute every frame's gates, re-forward c from the slab
    // checkpoint, keep activations and the entering c in registers
    float4 act[KMAX][RPT];
    float cprev[KMAX][RPT];
    float c[RPT];
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int r = r0 + grp * RPT + q;
      c[q] = r < R ? c_ckpt[((size_t)blk * R + r) * H + j] : 0.f;
    }
#pragma unroll
    for (int s = 0; s < KMAX; ++s) {
      const int t = blk * kf + (reverse ? kf - 1 - s : s);
      if (s < kf && t < T) {
        float4 acc[RPT];
        gates4(wp, xs + s * RT * C + grp * RPT * C,
               hs + s * RT * H + grp * RPT * H, C, H, j, bias, acc);
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
          float4 a;
          if constexpr (M) {
            a = make_float4(rb(sigm(rb(acc[q].x))), rb(sigm(rb(acc[q].y))),
                            rb(tanhf(rb(acc[q].z))), rb(sigm(rb(acc[q].w))));
          } else {
            a = make_float4(sigm(acc[q].x), sigm(acc[q].y), tanhf(acc[q].z),
                            sigm(acc[q].w));
          }
          act[s][q] = a;
          cprev[s][q] = c[q];
          c[q] = a.y * c[q] + (M ? rb(a.x * a.z) : a.x * a.z);
        }
      }
    }

    // phase B: reverse walk, dgates and the (dh, dc) chain
#pragma unroll
    for (int s = KMAX - 1; s >= 0; --s) {
      const int t = blk * kf + (reverse ? kf - 1 - s : s);
      if (s < kf && t < T) {
        float* dgb = dgs + buf * RT * H4;
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
          const int row = grp * RPT + q, r = r0 + row;
          const float4 a = act[s][q];
          const float cp = cprev[s][q];
          const float ct = a.y * cp + a.x * a.z;
          const float tc = M ? rb(tanhf(rb(ct))) : tanhf(ct);
          const float d = (r < R ? ldf(dy, ((size_t)t * R + r) * H + j) : 0.f)
                          + dh[q];
          const float dO = d * tc;
          const float dC = dc[q] + d * a.w * (1.f - tc * tc);
          const float di = dC * a.z * a.x * (1.f - a.x);
          const float df = dC * cp * a.y * (1.f - a.y);
          const float dgg = dC * a.x * (1.f - a.z * a.z);
          const float dog = dO * a.w * (1.f - a.w);
          if constexpr (M) {
            if (r < R) {
              dbacc.x += di; dbacc.y += df; dbacc.z += dgg; dbacc.w += dog;
            }
          }
          // the dh chain, dx and dW take the gate gradients in bf16 in the
          // mixed mode
          dgb[row * H4 + j] = M ? rb(di) : di;
          dgb[row * H4 + H + j] = M ? rb(df) : df;
          dgb[row * H4 + 2 * H + j] = M ? rb(dgg) : dgg;
          dgb[row * H4 + 3 * H + j] = M ? rb(dog) : dog;
          if (r < R) {
            const size_t o = ((size_t)t * R + r) * H4;
            stf(dg, o + j, di); stf(dg, o + H + j, df);
            stf(dg, o + 2 * H + j, dgg); stf(dg, o + 3 * H + j, dog);
          }
          dc[q] = dC * a.y;
        }
        __syncthreads();
        // dh entering this frame = dgates @ W_hh^T, unit j of my rows
        float acc[RPT];
#pragma unroll
        for (int q = 0; q < RPT; ++q) acc[q] = 0.f;
        for (int col = 0; col < H4; ++col) {
          const float w = whhT[col * H + j];
#pragma unroll
          for (int q = 0; q < RPT; ++q)
            acc[q] += dgb[(grp * RPT + q) * H4 + col] * w;
        }
#pragma unroll
        for (int q = 0; q < RPT; ++q) dh[q] = acc[q];
        buf ^= 1;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int r = r0 + grp * RPT + q;
    if (r < R) {
      dh0[(size_t)r * H + j] = dh[q];
      dc0[(size_t)r * H + j] = dc[q];
    }
  }
  if constexpr (M) {
    // the tile's db: sum the G row groups' fp32 sums, in order
    __syncthreads();
    float* red = dgs;                                    // [G][4][H]
    red[(grp * 4 + 0) * H + j] = dbacc.x;
    red[(grp * 4 + 1) * H + j] = dbacc.y;
    red[(grp * 4 + 2) * H + j] = dbacc.z;
    red[(grp * 4 + 3) * H + j] = dbacc.w;
    __syncthreads();
    for (int o = tid; o < H4; o += nt) {
      const int gate = o / H, u = o - gate * H;
      float sum = 0.f;
      for (int g = 0; g < G; ++g) sum += red[(g * 4 + gate) * H + u];
      db_part[(size_t)blockIdx.x * H4 + o] = sum;
    }
  }
}

constexpr int DX_ROWS = 32;

// dx[n, :] = dg[n, :] @ w_ih^T over the N = T*R rows.
template <typename XT, typename WT, typename GT>
__global__ void __launch_bounds__(256) slab_dx_kernel(
    const GT* __restrict__ dg, const WT* __restrict__ w_ih,
    XT* __restrict__ dx, int N, int C, int H) {
  extern __shared__ float sm[];
  const int H4 = 4 * H;
  float* wT = sm;                  // [4H][C]
  float* dgt = wT + H4 * C;        // [DX_ROWS][4H]
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < H4 * C; i += nt) {
    const int col = i / C, c = i - col * C;
    wT[i] = ldf(w_ih, (size_t)c * H4 + col);
  }
  const int n_tiles = (N + DX_ROWS - 1) / DX_ROWS;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int n0 = tile * DX_ROWS;
    __syncthreads();
    for (int i = tid; i < DX_ROWS * H4; i += nt) {
      const int row = i / H4, n = n0 + row;
      dgt[i] = n < N ? ldf(dg, (size_t)n * H4 + (i - row * H4)) : 0.f;
    }
    __syncthreads();
    for (int o = tid; o < DX_ROWS * C; o += nt) {
      const int row = o / C, c = o - row * C, n = n0 + row;
      float acc = 0.f;
      for (int col = 0; col < H4; ++col)
        acc += dgt[row * H4 + col] * wT[col * C + c];
      if (n < N) stf(dx, (size_t)n * C + c, acc);
    }
  }
}

constexpr int DW_AG = 32;      // rows of [x | hp | 1] per block (registers)
constexpr int DW_TILE = 16;    // rows of N per shared-memory tile

// Per-chunk partials of [x | hp | 1]^T @ dg: part[chunk][a][col],
// a in [0, C+H+1). Block (chunk, a-group) of 4H threads, thread = column.
template <typename XT, typename WT, typename GT>
__global__ void __launch_bounds__(1024) slab_dw_partial_kernel(
    const XT* __restrict__ x, const WT* __restrict__ hp,
    const GT* __restrict__ dg, float* __restrict__ part, int N, int C,
    int H, int chunk_rows) {
  extern __shared__ float sm[];
  const int H4 = 4 * H, A = C + H + 1;
  float* dgt = sm;                       // [DW_TILE][4H]
  float* at = dgt + DW_TILE * H4;        // [DW_TILE][DW_AG]
  const int tid = threadIdx.x, nt = blockDim.x, col = tid;
  const int chunk = blockIdx.x, a0 = blockIdx.y * DW_AG;
  const int n_begin = chunk * chunk_rows;
  const int n_end = min(N, n_begin + chunk_rows);
  float acc[DW_AG];
#pragma unroll
  for (int a = 0; a < DW_AG; ++a) acc[a] = 0.f;
  for (int n0 = n_begin; n0 < n_end; n0 += DW_TILE) {
    __syncthreads();
    for (int i = tid; i < DW_TILE * H4; i += nt) {
      const int row = i / H4, n = n0 + row;
      dgt[i] = n < n_end ? ldf(dg, (size_t)n * H4 + (i - row * H4)) : 0.f;
    }
    for (int i = tid; i < DW_TILE * DW_AG; i += nt) {
      const int row = i / DW_AG, a = a0 + (i - row * DW_AG), n = n0 + row;
      float v = 0.f;
      if (n < n_end && a < A)
        v = a < C ? ldf(x, (size_t)n * C + a)
                  : (a < C + H ? ldf(hp, (size_t)n * H + (a - C)) : 1.f);
      at[i] = v;
    }
    __syncthreads();
    for (int row = 0; row < DW_TILE; ++row) {
      const float g = dgt[row * H4 + col];
#pragma unroll
      for (int a = 0; a < DW_AG; ++a) acc[a] += at[row * DW_AG + a] * g;
    }
  }
#pragma unroll
  for (int a = 0; a < DW_AG; ++a)
    if (a0 + a < A) part[((size_t)chunk * A + a0 + a) * H4 + col] = acc[a];
}

// Sum the partials over the chunks in order: dW_ih, dW_hh, db. In the mixed
// mode db sums the walk's per-tile fp32 sums db_part [n_tiles, 4H] instead
// (the partials' ones row summed the bf16-rounded gate gradients).
template <bool M>
__global__ void slab_dw_reduce_kernel(const float* __restrict__ part,
                                      const float* __restrict__ db_part,
                                      float* __restrict__ dw_ih,
                                      float* __restrict__ dw_hh,
                                      float* __restrict__ db, int n_chunks,
                                      int n_tiles, int C, int H) {
  const int H4 = 4 * H, A = C + H + 1;
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= A * H4) return;
  const int a = o / H4, col = o - a * H4;
  float s = 0.f;
  if (M && a == C + H) {
    for (int k = 0; k < n_tiles; ++k) s += db_part[(size_t)k * H4 + col];
  } else {
    for (int k = 0; k < n_chunks; ++k) s += part[(size_t)k * A * H4 + o];
  }
  if (a < C) dw_ih[(size_t)a * H4 + col] = s;
  else if (a < C + H) dw_hh[(size_t)(a - C) * H4 + col] = s;
  else db[col] = s;
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

size_t fwd_smem(int C, int H) {
  return (size_t)(C + H) * H * 16 + (size_t)2 * RT * (C + H) * 4;
}

size_t bwd_smem(int C, int H) {
  return (size_t)(C + H) * H * 16 + (size_t)4 * H * H * 4 +
         (size_t)KMAX * RT * (C + H) * 4 + (size_t)2 * RT * 4 * H * 4;
}

template <typename XT, typename WT>
int slab_fwd(const void* x, const void* w_ih, const void* w_hh,
             const void* b, const float* h0, const float* c0, void* ys,
             float* hT, float* cT, float* c_ckpt, int T, int R, int C, int H,
             int kf, int reverse, cudaStream_t st) {
  const size_t smem = fwd_smem(C, H);
  int err = set_smem((const void*)slab_fwd_kernel<XT, WT>, smem);
  if (err) return err;
  const int blocks = (R + RT - 1) / RT;
  slab_fwd_kernel<XT, WT><<<blocks, G * H, smem, st>>>(
      (const XT*)x, (const WT*)w_ih, (const WT*)w_hh, (const WT*)b, h0, c0,
      (XT*)ys, hT, cT, c_ckpt, T, R, C, H, kf, reverse);
  return (int)cudaGetLastError();
}

template <typename XT, typename WT>
int slab_bwd(const void* x, const void* hp, const float* c_ckpt,
             const void* dy, const void* w_ih, const void* w_hh,
             const void* b, const float* dhT, const float* dcT, void* dx,
             float* dw_ih, float* dw_hh, float* db, float* dh0, float* dc0,
             void* dg, float* part, float* db_part, int T, int R, int C,
             int H, int kf, int reverse, int n_chunks, cudaStream_t st) {
  constexpr bool M = kMixed<XT, WT>;
  using GT = GateT<XT, WT>;
  const int H4 = 4 * H, N = T * R, A = C + H + 1;
  const int n_tiles = (R + RT - 1) / RT;

  const size_t smem_walk = bwd_smem(C, H);
  int err = set_smem((const void*)slab_bwd_walk_kernel<XT, WT>, smem_walk);
  if (err) return err;
  slab_bwd_walk_kernel<XT, WT><<<n_tiles, G * H, smem_walk, st>>>(
      (const XT*)x, (const WT*)hp, c_ckpt, (const XT*)dy, (const WT*)w_ih,
      (const WT*)w_hh, (const WT*)b, dhT, dcT, (GT*)dg, db_part, dh0, dc0, T,
      R, C, H, kf, reverse);
  if ((err = (int)cudaGetLastError())) return err;

  const size_t smem_dx = (size_t)(H4 * C + DX_ROWS * H4) * 4;
  if ((err = set_smem((const void*)slab_dx_kernel<XT, WT, GT>, smem_dx)))
    return err;
  const int dx_tiles = (N + DX_ROWS - 1) / DX_ROWS;
  slab_dx_kernel<XT, WT, GT><<<dx_tiles < 1056 ? dx_tiles : 1056, 256,
                               smem_dx, st>>>(
      (const GT*)dg, (const WT*)w_ih, (XT*)dx, N, C, H);
  if ((err = (int)cudaGetLastError())) return err;

  const int chunk_rows = (N + n_chunks - 1) / n_chunks;
  const size_t smem_dw = (size_t)(DW_TILE * H4 + DW_TILE * DW_AG) * 4;
  if ((err = set_smem((const void*)slab_dw_partial_kernel<XT, WT, GT>,
                      smem_dw)))
    return err;
  dim3 grid(n_chunks, (A + DW_AG - 1) / DW_AG);
  slab_dw_partial_kernel<XT, WT, GT><<<grid, H4, smem_dw, st>>>(
      (const XT*)x, (const WT*)hp, (const GT*)dg, part, N, C, H, chunk_rows);
  if ((err = (int)cudaGetLastError())) return err;

  slab_dw_reduce_kernel<M><<<(A * H4 + 255) / 256, 256, 0, st>>>(
      part, db_part, dw_ih, dw_hh, db, n_chunks, n_tiles, C, H);
  return (int)cudaGetLastError();
}

}  // namespace

// dtypes: the (x, weights) pair, 0 = (fp32, fp32), 1 = (bf16, bf16),
// 2 = (bf16, fp32) (`DTYPES` in ops/kernels/lstm_slab.py); hp has the
// weights' type, dy and dx the activations'.
extern "C" size_t sbt_lstm_slab_fwd_smem(int C, int H) {
  return fwd_smem(C, H);
}

extern "C" size_t sbt_lstm_slab_bwd_smem(int C, int H) {
  return bwd_smem(C, H);
}

extern "C" int sbt_lstm_slab_fwd(const void* x, const void* w_ih,
                                 const void* w_hh, const void* b,
                                 const float* h0, const float* c0, void* ys,
                                 float* hT, float* cT, float* c_ckpt, int T,
                                 int R, int C, int H, int kf, int reverse,
                                 int dtypes, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtypes) {
    case 0:
      return slab_fwd<float, float>(x, w_ih, w_hh, b, h0, c0, ys, hT, cT,
                                    c_ckpt, T, R, C, H, kf, reverse, st);
    case 1:
      return slab_fwd<bf16, bf16>(x, w_ih, w_hh, b, h0, c0, ys, hT, cT,
                                  c_ckpt, T, R, C, H, kf, reverse, st);
    case 2:
      return slab_fwd<bf16, float>(x, w_ih, w_hh, b, h0, c0, ys, hT, cT,
                                   c_ckpt, T, R, C, H, kf, reverse, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Scratch from the caller: dg [T*R*4H] (bf16 in the mixed mode),
// part [n_chunks*(C+H+1)*4H], db_part [ceil(R/8)*4H] (mixed mode only).
extern "C" int sbt_lstm_slab_bwd(const void* x, const void* hp,
                                 const float* c_ckpt, const void* dy,
                                 const void* w_ih, const void* w_hh,
                                 const void* b, const float* dhT,
                                 const float* dcT, void* dx, float* dw_ih,
                                 float* dw_hh, float* db, float* dh0,
                                 float* dc0, void* dg, float* part,
                                 float* db_part, int T, int R, int C, int H,
                                 int kf, int reverse, int n_chunks,
                                 int dtypes, void* stream) {
  cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtypes) {
    case 0:
      return slab_bwd<float, float>(x, hp, c_ckpt, dy, w_ih, w_hh, b, dhT,
                                    dcT, dx, dw_ih, dw_hh, db, dh0, dc0, dg,
                                    part, db_part, T, R, C, H, kf, reverse,
                                    n_chunks, st);
    case 1:
      return slab_bwd<bf16, bf16>(x, hp, c_ckpt, dy, w_ih, w_hh, b, dhT,
                                  dcT, dx, dw_ih, dw_hh, db, dh0, dc0, dg,
                                  part, db_part, T, R, C, H, kf, reverse,
                                  n_chunks, st);
    case 2:
      return slab_bwd<bf16, float>(x, hp, c_ckpt, dy, w_ih, w_hh, b, dhT,
                                   dcT, dx, dw_ih, dw_hh, db, dh0, dc0, dg,
                                   part, db_part, T, R, C, H, kf, reverse,
                                   n_chunks, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
