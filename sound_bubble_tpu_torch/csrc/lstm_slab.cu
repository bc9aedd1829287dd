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
// the carry through): the loops skip them.
//
// What bounds them on an H100 (counted on the compact math, fp32, one
// direction of the training shapes, T*R = 181,540 rows, C = 32, H = 64):
// the forward does 2*T*R*(C+H)*4H = 8.92 GFLOP, 0.133 ms at 67 TFLOP/s,
// and must move ~76 MB (x in, ys and c_ckpt out), 0.023 ms at 3.35 TB/s:
// operations bound it. The backward does ~26.8 GFLOP (gate recompute,
// dh chain, dx, dW), 0.40 ms, against ~145 MB, 0.043 ms: operations again.
// In practice the recurrence bounds both: T dependent steps per row tile.
//
// Forward design (`slab_fwd32_kernel`, row 10a; `slab_fwd_mixed_kernel`,
// row 10b): the walk of csrc/lstm_fwd32.cuh, which this file shares with
// the seq route's forwards; the mixed one is its mixed mode (RND_SLAB). A
// `clock64()` split of the first design (8-row blocks, each thread one
// unit's 96-long dot over [x | h] for two rows, [W_ih; W_hh] re-read from
// shared memory every frame) found its frames latency-bound, two thirds of
// each in that dot, whose steps wait on their shared loads. So: rows a block for one wave (`fwd_row_tiles`); per
// K-frame slab, gx = x W_ih + b for all the slab's frames x rows as one
// register-tiled product into shared memory, the next slab's x tile copied
// in by cp.async meanwhile; the chain keeps W_hh in registers (a lane holds
// four gates of one unit at a quarter of the inputs; four lanes reduce by
// shuffles), four rows at a time as 16 independent accumulators a lane;
// each lane then applies one (row, unit) cell. See the header for the
// layout and why it, and not row 5's, was chosen.
//
// Backward design (from a torch.profiler split of the four-kernel version it
// replaces: its walk took 73-75 % of a call in fp32, dx and the weight
// partials the rest through a [T*R, 4H] dgates array):
// - Two launches. `slab_bwd_kernel`: one block of BT = 512 threads a tile of
//   `rows` consecutive rows, one block an SM; it walks all the tile's slabs
//   and writes dx, dh0, dc0 and one partial (dW_ih; dW_hh; db) [C+H+1][4H]
//   of the block. `slab_bwd_reduce_kernel` sums the partials in block order.
//   No dgates array in device memory, no atomics: two launches give
//   bit-equal results. Blocks never wait on each other.
// - One wave: the wrapper (`bwd_row_tiles`) picks the fewest rows a block
//   that keep the grid within one wave of the card's SMs, or fewer where the
//   shared memory below would not fit (then the grid takes more waves).
// - Per slab: the x | hp rows of its K frames are loaded once; the gates of
//   all K frames are one [K*rows, C+H] @ [C+H, 4H] product: register-tiled
//   FMA (four gates of one unit at up to 10 rows a thread, four inputs a
//   step), or, where x, hp and the weights are all bf16, mma.sync m16n8k16
//   tiles on the tensor cores (`gate_mma`; bf16 products are exact in fp32,
//   as the Pallas body's preferred_element_type=f32 dots). The cell states
//   are re-forwarded from c_ckpt; then the frames are walked backwards. Only
//   the chain is serial: each frame's gate gradients (elementwise, thread
//   (unit, row)) and dh = dg @ W_hh^T, which eight warps compute with W_hh
//   held in registers (eight rows of it a warp, 64 registers a thread,
//   loaded once a slab), two 4-vector loads a lane for 64 FMAs, summed over
//   the lanes by a 9-shuffle reduce-scatter; two __syncthreads a frame.
//   After the walk, dW += [x | hp]^T dg (48 accumulators a thread, 12
//   inputs x 4 gates of one unit) and dx = dg @ W_ih^T (the chain's warp
//   dots, W_ih in registers), both from the slab's gate tile in shared
//   memory. Between slabs a thread's dW accumulators wait in its block's
//   partial (part, L2-resident: 12.5 MB at the training shapes), which
//   frees their 48 registers for the products.
// - Budget (bytes of shared memory at C = 32, H = 64, n = K*rows rows of a
//   slab; `bwd_layout`): weights (C+H)*4H values (fp32 98,304; the tensor
//   cores' transposed bf16 copy, rows padded to 104, 53,248), x | hp n*(C+H)
//   values (n*104 bf16 for the tensor cores), the gate tile n*4H (fp32, bf16
//   in the mixed mode), the cell states n*H fp32, and in the mixed mode one
//   frame's fp32 gate gradients rows*4H. fp32: 98,304 + 13,312*rows, so
//   rows <= 10 (231,424 B at 10: R = 1252 in one wave of 126 blocks);
//   (bf16, bf16): 53,248 + 8,832*rows, rows <= 20 (221,056 B at 19: R = 2504
//   in 132 blocks); (bf16, fp32): 98,304 + 10,240*rows, rows <= 13 (R = 2504
//   takes two waves there). Registers: 128 a thread (the launch bound of 512
//   threads, one block an SM); the largest live sets are the FMA gate tile
//   (40 accumulators, 16 weights, 10 row offsets) and the chain's 64 W_hh
//   values. The chain and dx read their weight rows from the gate-
//   interleaved copy in shared memory, or from device memory where shared
//   memory holds the transposed one.
// - The gate tile and the cell states are XOR-swizzled on the unit
//   (`sw4`, `swc`) so that the walk's (unit, row) threads, the chain's and
//   dx's row reads and the dW reads all hit distinct banks.
// No TF32 and no fast-math: fp32 FMA (or bf16 mma with fp32 accumulation),
// expf / tanhf.
//
// The mixed mode (`_fwd_kernel` / `_bwd_kernel` with mixed=True, the
// instantiation the JAX package's bf16 trunk launches) is the walk's mixed
// mode (the forward) and the backward's code, templated on the activation
// type XT (x, ys, dy, dx) and the weight type WT (w_ih, w_hh, b, hp): bf16
// operands are widened to fp32 on load (products of bf16 values are exact
// in fp32) and accumulated in fp32, and values are rounded to bf16 exactly
// where the Pallas kernel rounds: the gates
// (gx + bf16(h) W_hh, with gx = x W_ih + b unrounded), each sigmoid / tanh
// output, i*g, tanh's input c_t and the output h_t; the carried c stays
// fp32. The backward keeps the fp32 gate gradients for db (summed per
// thread in the walk) and stores them as bf16 in the gate tile for dx and
// the weight gradients, and as bf16-rounded fp32 for the chain. The mixed
// branches are `if constexpr`, so the fp32 backward (XT = WT = float) has
// none of them. The bound of a mixed scan counts 2 bytes for each bf16
// tensor and its matrix products at the bf16 tensor-core rate (989 TFLOP/s
// dense), the rate the work could reach; of them only the backward's gate
// recompute and the forward's slab projection with bf16 weights run on the
// tensor cores, the rest is fp32 FMA on the CUDA cores like the fp32
// instantiation (dW, dx and the chains on mma / wgmma tiles are later
// work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "lstm_fwd32.cuh"

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

__device__ __forceinline__ float sigm(float v) {
  return 1.0f / (1.0f + expf(-v));
}

template <typename WT>
__device__ __forceinline__ float4 load_bias(const WT* __restrict__ b, int H,
                                            int j) {
  return make_float4(ldf(b, j), ldf(b, H + j), ldf(b, 2 * H + j),
                     ldf(b, 3 * H + j));
}

// ---- the backward (row 11) ----------------------------------------------

template <typename XT, typename WT>
using GateT = typename std::conditional<kMixed<XT, WT>, bf16, float>::type;

// Four values of one (row, unit) or (input, unit), gate-interleaved
// (i, f, g, o): float4, or four bf16 in 8 bytes.
struct __align__(8) bf16x4 {
  __nv_bfloat162 lo, hi;
};
template <typename T>
using Vec4 = typename std::conditional<std::is_same<T, float>::value, float4,
                                       bf16x4>::type;

__device__ __forceinline__ float4 ld4(const float4* p, int i) { return p[i]; }
__device__ __forceinline__ float4 ld4(const bf16x4* p, int i) {
  const bf16x4 v = p[i];
  const float2 a = __bfloat1622float2(v.lo), b = __bfloat1622float2(v.hi);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void st4(float4* p, int i, float4 v) { p[i] = v; }
__device__ __forceinline__ void st4(bf16x4* p, int i, float4 v) {
  bf16x4 o;
  o.lo = __floats2bfloat162_rn(v.x, v.y);
  o.hi = __floats2bfloat162_rn(v.z, v.w);
  p[i] = o;
}
// four consecutive values at an index that is a multiple of 4
template <typename T>
__device__ __forceinline__ float4 ldv4(const T* p, size_t i) {
  return ld4(reinterpret_cast<const Vec4<T>*>(p + i), 0);
}
__device__ __forceinline__ void fma4(float4& acc, float v, float4 w) {
  acc.x += v * w.x; acc.y += v * w.y; acc.z += v * w.z; acc.w += v * w.w;
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc += a.x * b.x; acc += a.y * b.y; acc += a.z * b.z; acc += a.w * b.w;
  return acc;
}
// the sum over the 8 lanes kc of a warp's unit, the same in each lane
__device__ __forceinline__ float wsum(float v) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int BT = 512;          // threads of a backward block
constexpr int BWD_ROWS_MAX = 24; // rows of a block: 3 cells a chain thread
constexpr int MA = 12;           // dW inputs of a thread: a = ag*MA + m

// The gate tile [n][H] of 4-vectors and the cell states [n][H], XOR-swizzled
// on the unit so that 8 consecutive rows at one unit, and the units of one
// row, fall in distinct banks.
__device__ __forceinline__ int sw4(int p, int j, int H) {
  return p * H + (j ^ (p & 7));
}
__device__ __forceinline__ int swc(int p, int j, int H) {
  return p * H + (j ^ (((p & 7) << 2) & (H - 1)));
}

// Shared memory of one backward block of `rows` rows (byte offsets): the
// weights, the slab's x | hp rows xh [K*rows][xs] (the weights' type), its
// gates, then gate gradients, dg4 [K*rows][H] (4-vectors: float, bf16 in
// the mixed mode), the cell states entering each frame cps [K*rows][H]
// (float) and, in the mixed mode, the current frame's gate gradients in
// float for the chain, dgf [rows][H]. The weights are w4 [C+H][H]
// (4-vectors of the weights' type) for the FMA path; for the tensor-core
// path (bf16 weights, `tc`) they are wt [4H][xs], the transposed product
// operand with its columns in gate-interleaved order (n = 4 unit + gate),
// and xs = C+H rounded up to 16 (zeros past C+H) plus 8, a row stride that
// keeps the mma fragments' loads off each other's banks; else xs = C+H.
struct BwdLayout {
  size_t xh, dg, cp, dgf, total;
  int xs;
};

inline __host__ __device__ size_t al16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

inline __host__ __device__ BwdLayout bwd_layout(int C, int H, int rows,
                                               bool mixed, int wbytes,
                                               bool tc) {
  const size_t CH = C + H, n = (size_t)KMAX * rows;
  BwdLayout L;
  L.xs = tc ? (int)((CH + 15) / 16 * 16 + 8) : (int)CH;
  L.xh = al16(tc ? (size_t)4 * H * L.xs * wbytes : CH * H * 4 * wbytes);
  L.dg = L.xh + al16(n * L.xs * wbytes);
  L.cp = L.dg + al16(n * H * 4 * (mixed ? 2 : 4));
  L.dgf = L.cp + al16(n * H * 4);
  L.total = L.dgf + (mixed ? (size_t)rows * H * 16 : 0);
  return L;
}

// D += A B for one m16n8k16 tile on the tensor cores: bf16 A (row-major)
// and B (column-major) fragments, fp32 accumulators (products of bf16 values
// are exact in fp32).
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned ld32(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// The gate recompute on the tensor cores (bf16 x, hp and weights): the
// slab's [n, C+H] @ [C+H, 4H] as m16n8k16 tiles, warp w owning the 8-column
// tiles w, w + 16, ... (their B fragments in registers, at most 6 k-steps:
// C+H <= 96), the bias as the accumulators' start; each lane then rounds
// and activates its two gates of one unit at two rows and stores them as
// half of the unit's 4-vector.
__device__ __forceinline__ void gate_mma(const bf16* wt, const bf16* xh,
                                         bf16x4* dg4, const bf16* b, int H,
                                         int n, int ks, int xs, int lane,
                                         int warp) {
  const int g = lane >> 2, t = lane & 3, nks = ks / 16;
  const int mtiles = (n + 15) / 16;
  for (int nt = warp; nt < H / 2; nt += BT / 32) {
    unsigned bfr[6][2];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      if (k < nks) {
        const bf16* col = wt + (nt * 8 + g) * xs + 16 * k + 2 * t;
        bfr[k][0] = ld32(col);
        bfr[k][1] = ld32(col + 8);
      }
    }
    const int c0 = nt * 8 + 2 * t;         // this lane's two columns
    const int j = c0 >> 2, hi = t & 1;     // unit, and (i, f) or (g, o)
    const float b0 = __bfloat162float(b[2 * hi * H + j]);
    const float b1 = __bfloat162float(b[(2 * hi + 1) * H + j]);
    for (int mt = 0; mt < mtiles; ++mt) {
      const int r0 = mt * 16 + g;
      // rows past n (not stored) are read as row n - 1, inside the tile
      const bf16* lo = xh + min(r0, n - 1) * xs + 2 * t;
      const bf16* hi8 = xh + min(r0 + 8, n - 1) * xs + 2 * t;
      float d[4] = {b0, b1, b0, b1};
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        if (k < nks) {
          const unsigned a[4] = {ld32(lo + 16 * k), ld32(hi8 + 16 * k),
                                 ld32(lo + 16 * k + 8),
                                 ld32(hi8 + 16 * k + 8)};
          mma16816(d, a, bfr[k]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int p = r0 + 8 * rr;
        if (p < n) {
          const float v0 = rb(d[2 * rr]), v1 = rb(d[2 * rr + 1]);
          const float a0 = rb(hi ? tanhf(v0) : sigm(v0)), a1 = rb(sigm(v1));
          reinterpret_cast<__nv_bfloat162*>(dg4)[2 * sw4(p, j, H) + hi] =
              __floats2bfloat162_rn(a0, a1);
        }
      }
    }
  }
}

// One pass of the gate recompute: thread (gj, rg) forms the four gates of
// unit gj at the GM rows pb + NG m (m < mp) of the slab's [n, C+H] @
// [C+H, 4H] product, four inputs a step (one float4 of x | hp a row, four of
// weights reused over the rows), and stores their activations.
template <int GM, bool M, typename W4, typename WT, typename G4>
__device__ __forceinline__ void gate_pass(const W4* w4, const WT* xh, G4* dg4,
                                          int CH, int H, int n, int NG,
                                          int gj, int pb, int mp,
                                          float4 bias) {
  float4 acc[GM];
  int off[GM];
#pragma unroll
  for (int m = 0; m < GM; ++m) {
    acc[m] = bias;
    off[m] = min(pb + NG * m, n - 1) * CH;
  }
#pragma unroll 2
  for (int k = 0; k < CH; k += 4) {
    const float4 w0 = ld4(w4, k * H + gj), w1 = ld4(w4, (k + 1) * H + gj);
    const float4 w2 = ld4(w4, (k + 2) * H + gj), w3 = ld4(w4, (k + 3) * H + gj);
#pragma unroll
    for (int m = 0; m < GM; ++m) {
      if (m < mp) {
        const float4 v = ldv4(xh, off[m] + k);
        fma4(acc[m], v.x, w0);
        fma4(acc[m], v.y, w1);
        fma4(acc[m], v.z, w2);
        fma4(acc[m], v.w, w3);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < GM; ++m) {
    const int p = pb + NG * m;
    if (m < mp && p < n) {
      const float4 g = acc[m];
      float4 a;
      if constexpr (M) {
        a = make_float4(rb(sigm(rb(g.x))), rb(sigm(rb(g.y))),
                        rb(tanhf(rb(g.z))), rb(sigm(rb(g.w))));
      } else {
        a = make_float4(sigm(g.x), sigm(g.y), tanhf(g.z), sigm(g.w));
      }
      st4(dg4, sw4(p, gj, H), a);
    }
  }
}

// The sums over a warp's 32 lanes of t[0..7], scattered: lane l ends with
// the sum of t[4 b4 + 2 b3 + b2] (b the bits of l), the same value in the 4
// lanes that share it; 9 shuffles where 8 butterflies would take 40.
__device__ __forceinline__ float rsum8(const float (&t)[8], int lane) {
  const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
  float a[4], c[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = (h4 ? t[4 + i] : t[i]) +
           __shfl_xor_sync(0xffffffffu, h4 ? t[i] : t[4 + i], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    c[i] = (h3 ? a[2 + i] : a[i]) +
           __shfl_xor_sync(0xffffffffu, h3 ? a[i] : a[2 + i], 8);
  float v = (h2 ? c[1] : c[0]) +
            __shfl_xor_sync(0xffffffffu, h2 ? c[0] : c[1], 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

// A warp's eight row dots against weight rows held in registers: for the
// rows p = p_begin, p_begin + step, ... < p_end, output i of the warp is
// sum_jp dot4(src(p, jp), wr[i][u]) over the input units jp = lane + 32u <
// nin; emit(p, i, v) runs in the lanes 4i. Each lane reads two 4-vectors of
// a row for 64 FMAs; two rows at a time, so that their loads, FMAs and
// shuffles overlap (the second repeats the last row past p_end).
template <typename Src, typename Emit>
__device__ __forceinline__ void row_dots8(int p_begin, int p_end, int step,
                                          const float4 (&wr)[8][2], int lane,
                                          int nin, Src src, Emit emit) {
  for (int p = p_begin; p < p_end; p += 2 * step) {
    const int p2 = min(p + step, p_end - 1);
    float t[8], t2[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) t[i] = t2[i] = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (lane + 32 * u < nin) {
        const float4 g = src(p, lane + 32 * u), g2 = src(p2, lane + 32 * u);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          t[i] = dot4(g, wr[i][u], t[i]);
          t2[i] = dot4(g2, wr[i][u], t2[i]);
        }
      }
    }
    const float v = rsum8(t, lane), v2 = rsum8(t2, lane);
    if ((lane & 3) == 0) {
      emit(p, lane >> 2, v);
      if (p + step < p_end) emit(p + step, lane >> 2, v2);
    }
  }
}

// Weight rows k0 .. k0 + 7 at the input units lane + 32u, the four gates
// of each, for row_dots8; read once a slab. From the gate-interleaved w4 in
// shared memory (rows ks0 + i), or, where shared memory holds the
// tensor cores' transposed copy (TC), from w ([K, 4H] in device memory,
// gate-major columns, rows k0 + i), coalesced over the lanes.
template <bool TC, typename W4, typename WT>
__device__ __forceinline__ void load_rows8(float4 (&wr)[8][2], const W4* w4,
                                           int ks0, const WT* w, int k0,
                                           int H, int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int jp = lane + 32 * u;
      const WT* row = w + (size_t)(k0 + i) * 4 * H + jp;
      if (jp >= H)
        wr[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
      else if constexpr (TC)
        wr[i][u] = make_float4(ldf(row, 0), ldf(row, H), ldf(row, 2 * H),
                               ldf(row, 3 * H));
      else
        wr[i][u] = ld4(w4, (ks0 + i) * H + jp);
    }
}

// One block owns `rows` consecutive rows and walks all their slabs; it
// writes dx, dh0, dc0 of its rows and one partial [C+H+1][4H] of
// (dW_ih; dW_hh; db) to part.
template <typename XT, typename WT>
__global__ void __launch_bounds__(BT, 1) slab_bwd_kernel(
    const XT* __restrict__ x, const WT* __restrict__ hp,
    const float* __restrict__ c_ckpt, const XT* __restrict__ dy,
    const WT* __restrict__ w_ih, const WT* __restrict__ w_hh,
    const WT* __restrict__ b, const float* __restrict__ dhT,
    const float* __restrict__ dcT, XT* __restrict__ dx,
    float* __restrict__ part, float* __restrict__ dh0,
    float* __restrict__ dc0, int T, int R, int C, int H, int kf,
    int reverse, int rows) {
  constexpr bool M = kMixed<XT, WT>;
  // the tensor cores take the products where every operand is bf16
  constexpr bool TC = std::is_same<WT, bf16>::value;
  using W4 = Vec4<WT>;
  using G4 = Vec4<GateT<XT, WT>>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int CH = C + H, H4 = 4 * H;
  const BwdLayout L = bwd_layout(C, H, rows, M, (int)sizeof(WT), TC);
  const int xs = L.xs;
  W4* w4 = reinterpret_cast<W4*>(smem);
  WT* xh = reinterpret_cast<WT*>(smem + L.xh);
  G4* dg4 = reinterpret_cast<G4*>(smem + L.dg);
  float* cps = reinterpret_cast<float*>(smem + L.cp);
  float4* dgf = reinterpret_cast<float4*>(smem + L.dgf);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * rows, rt = min(rows, R - row0);
  const int nb = (T + kf - 1) / kf;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  if constexpr (TC) {
    bf16* wt = reinterpret_cast<bf16*>(smem);
    for (int i = tid; i < H4 * xs; i += BT) {
      const int nn = i / xs, k = i - nn * xs;
      const int col = (nn & 3) * H + (nn >> 2);
      wt[i] = k < C ? w_ih[(size_t)k * H4 + col]
                    : k < CH ? w_hh[(size_t)(k - C) * H4 + col]
                             : __float2bfloat16_rn(0.f);
    }
  } else {
    for (int i = tid; i < CH * H; i += BT) {
      const int k = i / H, j = i - k * H;
      const WT* row =
          k < C ? w_ih + (size_t)k * H4 : w_hh + (size_t)(k - C) * H4;
      st4(w4, i, make_float4(ldf(row, j), ldf(row, H + j),
                             ldf(row, 2 * H + j), ldf(row, 3 * H + j)));
    }
  }
  // the cell's and the chain's thread (cj, kc): the 8 lanes kc of a warp
  // share unit cj; the rows kc + 8 s of the tile are its cells
  const int lane = tid & 31, kc = lane & 7;
  const int cj = (tid >> 5) * 4 + (lane >> 3);
  const bool chain = cj < H;
  float dh[3], dc[3];
  float4 db4 = zero;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int r = kc + 8 * s;
    const bool ok = chain && r < rt;
    dh[s] = ok ? dhT[(size_t)(row0 + r) * H + cj] : 0.f;
    dc[s] = ok ? dcT[(size_t)(row0 + r) * H + cj] : 0.f;
  }
  // the dW thread (unit wj, inputs a0 .. a0 + MA - 1); between slabs its
  // part of the block's partial waits in part (L2), not in registers
  const int wj = tid % H, a0 = (tid / H) * MA;
  float* mine = part + (size_t)blockIdx.x * (CH + 1) * H4;
  // row_dots8 warps: the chain's warp owns dh units 8 og .. 8 og + 7 of
  // the rows rs + npar i, dx's its inputs 8 xg .. 8 xg + 7 of the rows
  // xr + nxpar i
  const int warp = tid >> 5;
  const int og = warp % (H / 8), rs = warp / (H / 8), npar = 16 / (H / 8);
  const int xg = warp % (C / 8), xr = warp / (C / 8), nxpar = 16 / (C / 8);

  for (int js = 0; js < nb; ++js) {
    const int blk = reverse ? js : nb - 1 - js;
    const int lo = blk * kf, hi = min(T, lo + kf), nf = hi - lo, n = nf * rt;
    // the frame of slot q (processing order); row p = q * rt + r
    auto tq = [&](int q) { return reverse ? hi - 1 - q : lo + q; };

    __syncthreads();   // the previous slab's tiles are no longer read
    {
      const int CV = C / 4, RV = CH / 4, XV = xs / 4;
      for (int i = tid; i < n * XV; i += BT) {
        const int p = i / XV, v = i - p * XV;
        const int q = p / rt, r = p - q * rt;
        const size_t row = (size_t)tq(q) * R + row0 + r;
        st4(reinterpret_cast<W4*>(xh), i,
            v < CV ? ldv4(x, row * C + 4 * v)
                   : v < RV ? ldv4(hp, row * H + 4 * (v - CV)) : zero);
      }
    }
    __syncthreads();

    // gate recompute, one product [n, C+H] @ [C+H, 4H] for the slab
    if constexpr (TC) {
      gate_mma(reinterpret_cast<const bf16*>(smem), xh, dg4, b, H, n,
               xs - 8, xs, lane, warp);
    } else {
      const int NG = BT / H, gj = tid % H, rg = tid / H;
      const int per = (n + NG - 1) / NG;
      const float4 bias = load_bias(b, H, gj);
      if (per <= 5) {
        gate_pass<5, M>(w4, xh, dg4, CH, H, n, NG, gj, rg, per, bias);
      } else {
        const int npass = (per + 9) / 10, mp = (per + npass - 1) / npass;
        for (int pass = 0; pass < npass; ++pass)
          gate_pass<10, M>(w4, xh, dg4, CH, H, n, NG, gj,
                           pass * NG * mp + rg, mp, bias);
      }
    }
    __syncthreads();

    // re-forward the cell states of the thread's cells from the checkpoint
    if (chain) {
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const int r = kc + 8 * s;
        if (r < rt) {
          float c = c_ckpt[((size_t)blk * R + row0 + r) * H + cj];
          for (int q = 0; q < nf; ++q) {
            const int p = q * rt + r;
            cps[swc(p, cj, H)] = c;
            const float4 a = ld4(dg4, sw4(p, cj, H));
            c = a.y * c + (M ? rb(a.x * a.z) : a.x * a.z);
          }
        }
      }
    }

    // the reverse walk: the serial part is the cells' gate gradients and dh
    // = dg @ W_hh^T, the warp's eight rows of W_hh in registers; dh goes
    // to the cells through the cell states of the frame just walked
    float4 wr[8][2];
    load_rows8<TC>(wr, w4, C + 8 * og, w_hh, 8 * og, H, lane);
    float dyn[3];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int r = kc + 8 * s;
      dyn[s] = chain && r < rt
                   ? ldf(dy, ((size_t)tq(nf - 1) * R + row0 + r) * H + cj)
                   : 0.f;
    }
    for (int q = nf - 1; q >= 0; --q) {
      float dyv[3];
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const int r = kc + 8 * s;
        dyv[s] = dyn[s];
        if (q > 0 && chain && r < rt)
          dyn[s] = ldf(dy, ((size_t)tq(q - 1) * R + row0 + r) * H + cj);
      }
      if (chain) {
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          const int r = kc + 8 * s;
          if (r < rt) {
            const int p = q * rt + r;
            if (q < nf - 1) dh[s] = cps[swc(p + rt, cj, H)];
            const float4 a = ld4(dg4, sw4(p, cj, H));
            const float cp = cps[swc(p, cj, H)];
            const float ct = a.y * cp + a.x * a.z;
            const float tc = M ? rb(tanhf(rb(ct))) : tanhf(ct);
            const float d = dyv[s] + dh[s];
            const float dO = d * tc;
            const float dC = dc[s] + d * a.w * (1.f - tc * tc);
            const float4 g = make_float4(dC * a.z * a.x * (1.f - a.x),
                                         dC * cp * a.y * (1.f - a.y),
                                         dC * a.x * (1.f - a.z * a.z),
                                         dO * a.w * (1.f - a.w));
            db4.x += g.x; db4.y += g.y; db4.z += g.z; db4.w += g.w;
            // the chain, dx and dW take the gate gradients in bf16 in the
            // mixed mode (st4 rounds)
            st4(dg4, sw4(p, cj, H), g);
            if constexpr (M)
              dgf[r * H + (cj ^ (r & 7))] =
                  make_float4(rb(g.x), rb(g.y), rb(g.z), rb(g.w));
            dc[s] = dC * a.y;
          }
        }
      }
      __syncthreads();
      if (rs < npar) {
        auto put_dh = [&](int r, int i, float v) {
          cps[swc(q * rt + r, 8 * og + i, H)] = v;
        };
        if constexpr (M) {
          row_dots8(rs, rt, npar, wr, lane, H, [&](int r, int jp) {
            return dgf[r * H + (jp ^ (r & 7))];
          }, put_dh);
        } else {
          row_dots8(rs, rt, npar, wr, lane, H, [&](int r, int jp) {
            return ld4(dg4, sw4(q * rt + r, jp, H));
          }, put_dh);
        }
      }
      __syncthreads();   // dh and (mixed) dgf are read next frame
    }
    // the dh entering the slab's first frame: the carry to the next slab
    if (chain) {
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const int r = kc + 8 * s;
        if (r < rt) dh[s] = cps[swc(r, cj, H)];
      }
    }
    __syncthreads();

    // dW += [x | hp]^T dg over the slab's rows
    if (a0 < CH) {
      float4 dw[MA];
#pragma unroll
      for (int m = 0; m < MA; ++m) {
        const float* o = mine + (size_t)(a0 + m) * H4 + wj;
        dw[m] = js == 0 || a0 + m >= CH
                    ? zero : make_float4(o[0], o[H], o[2 * H], o[3 * H]);
      }
      const W4* xh4 = reinterpret_cast<const W4*>(xh);
#pragma unroll 2
      for (int p = 0; p < n; ++p) {
        const float4 g = ld4(dg4, sw4(p, wj, H));
#pragma unroll
        for (int c4 = 0; c4 < MA / 4; ++c4) {
          if (a0 + 4 * c4 < CH) {
            const float4 v = ld4(xh4, (p * xs + a0) / 4 + c4);
            fma4(dw[4 * c4], v.x, g);
            fma4(dw[4 * c4 + 1], v.y, g);
            fma4(dw[4 * c4 + 2], v.z, g);
            fma4(dw[4 * c4 + 3], v.w, g);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < MA; ++m) {
        if (a0 + m < CH) {
          float* o = mine + (size_t)(a0 + m) * H4 + wj;
          o[0] = dw[m].x; o[H] = dw[m].y; o[2 * H] = dw[m].z;
          o[3 * H] = dw[m].w;
        }
      }
    }
    __syncthreads();

    // dx = dg @ W_ih^T: the warp's eight rows of W_ih in registers, its
    // rows xr + nxpar i of the slab, staged in the x | hp tile, then
    // written row by row
    {
      if (xr < nxpar) {
        float4 wx[8][2];
        load_rows8<TC>(wx, w4, 8 * xg, w_ih, 8 * xg, H, lane);
        row_dots8(xr, n, nxpar, wx, lane, H, [&](int p, int jp) {
          return ld4(dg4, sw4(p, jp, H));
        }, [&](int p, int i, float v) {
          stf(xh, (size_t)p * C + 8 * xg + i, v);
        });
      }
      __syncthreads();
      for (int i = tid; i < n * C; i += BT) {
        const int p = i / C, cc = i - p * C, q = p / rt, r = p - q * rt;
        stf(dx, ((size_t)tq(q) * R + row0 + r) * C + cc, ldf(xh, i));
      }
    }
  }

  if (chain) {
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int r = kc + 8 * s;
      if (r < rt) {
        dh0[(size_t)(row0 + r) * H + cj] = dh[s];
        dc0[(size_t)(row0 + r) * H + cj] = dc[s];
      }
    }
  }
  if (chain) {
    const float4 v = make_float4(wsum(db4.x), wsum(db4.y), wsum(db4.z),
                                 wsum(db4.w));
    if (kc == 0) {
      float* o = mine + (size_t)CH * H4 + cj;
      o[0] = v.x; o[H] = v.y; o[2 * H] = v.z; o[3 * H] = v.w;
    }
  }
}

// Sum the blocks' partials in block order: dW_ih, dW_hh, db.
__global__ void slab_bwd_reduce_kernel(const float* __restrict__ part,
                                       float* __restrict__ dw_ih,
                                       float* __restrict__ dw_hh,
                                       float* __restrict__ db, int n_blocks,
                                       int C, int H) {
  const int H4 = 4 * H, A = C + H + 1;
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= A * H4) return;
  const int a = o / H4, col = o - a * H4;
  float s = 0.f;
  for (int k = 0; k < n_blocks; ++k) s += part[(size_t)k * A * H4 + o];
  if (a < C) dw_ih[(size_t)a * H4 + col] = s;
  else if (a < C + H) dw_hh[(size_t)(a - C) * H4 + col] = s;
  else db[col] = s;
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ---- the fp32 forward (row 10a): csrc/lstm_fwd32.cuh's walk ------------

template <int H>
__global__ void __launch_bounds__(4 * H, 1) slab_fwd32_kernel(
    const float* __restrict__ x, const float* __restrict__ w_ih,
    const float* __restrict__ w_hh, const float* __restrict__ b,
    const float* __restrict__ h0, const float* __restrict__ c0,
    float* __restrict__ ys, float* __restrict__ hT, float* __restrict__ cT,
    float* __restrict__ c_ckpt, int T, int R, int C, int kf, int reverse,
    int rows) {
  sbt_fwd32::walk<H, sbt_fwd32::SLAB>(x, w_ih, w_hh, b, h0, c0,
                                      {ys, nullptr, nullptr}, hT, cT, c_ckpt,
                                      T, R, C, kf, reverse, rows, blockIdx.x);
}

// ---- the mixed forward (row 10b): the same walk in its mixed mode, bf16 x
// and ys, WT weights

template <int H, typename WT>
__global__ void __launch_bounds__(4 * H, 1) slab_fwd_mixed_kernel(
    const bf16* __restrict__ x, const WT* __restrict__ w_ih,
    const WT* __restrict__ w_hh, const WT* __restrict__ b,
    const float* __restrict__ h0, const float* __restrict__ c0,
    bf16* __restrict__ ys, float* __restrict__ hT, float* __restrict__ cT,
    float* __restrict__ c_ckpt, int T, int R, int C, int kf, int reverse,
    int rows) {
  sbt_fwd32::walk<H, sbt_fwd32::SLAB, 0, bf16, WT, sbt_fwd32::RND_SLAB>(
      x, w_ih, w_hh, b, h0, c0, {ys, nullptr, nullptr}, hT, cT, c_ckpt, T, R,
      C, kf, reverse, rows, blockIdx.x);
}

template <typename WT>
int slab_fwd_mixed(const void* x, const void* w_ih, const void* w_hh,
                   const void* b, const float* h0, const float* c0, void* ys,
                   float* hT, float* cT, float* c_ckpt, int T, int R, int C,
                   int H, int kf, int reverse, int rows, cudaStream_t st) {
  static void (*const ks[4])(const bf16*, const WT*, const WT*, const WT*,
                             const float*, const float*, bf16*, float*,
                             float*, float*, int, int, int, int, int, int) = {
      slab_fwd_mixed_kernel<8, WT>, slab_fwd_mixed_kernel<16, WT>,
      slab_fwd_mixed_kernel<32, WT>, slab_fwd_mixed_kernel<64, WT>};
  constexpr bool tc = std::is_same<WT, bf16>::value;
  if (kf < 1 || kf > sbt_fwd32::KMAX) return (int)cudaErrorInvalidValue;
  return sbt_fwd32::launch_smem(
      ks, sbt_fwd32::smem_mixed(C, H, rows, tc, false), H, T, R, rows, 1, st,
      (const bf16*)x, (const WT*)w_ih, (const WT*)w_hh, (const WT*)b, h0, c0,
      (bf16*)ys, hT, cT, c_ckpt, T, R, C, kf, reverse, rows);
}

int slab_fwd32(const void* x, const void* w_ih, const void* w_hh,
               const void* b, const float* h0, const float* c0, void* ys,
               float* hT, float* cT, float* c_ckpt, int T, int R, int C,
               int H, int kf, int reverse, int rows, cudaStream_t st) {
  static void (*const ks[4])(const float*, const float*, const float*,
                             const float*, const float*, const float*,
                             float*, float*, float*, float*, int, int, int,
                             int, int, int) = {
      slab_fwd32_kernel<8>, slab_fwd32_kernel<16>, slab_fwd32_kernel<32>,
      slab_fwd32_kernel<64>};
  if (kf < 1 || kf > sbt_fwd32::KMAX) return (int)cudaErrorInvalidValue;
  return sbt_fwd32::launch(ks, H, C, T, R, rows, 1, st, (const float*)x,
                           (const float*)w_ih, (const float*)w_hh,
                           (const float*)b, h0, c0, (float*)ys, hT, cT,
                           c_ckpt, T, R, C, kf, reverse, rows);
}

// The backward's shared memory at `rows` rows a block, 0 for a shape the
// kernel does not take: H a power of two in [8, 64], C a multiple of 8 (at
// most 2H), C + H at most the MA * BT / H inputs of the dW threads, and
// 1 <= rows <= BWD_ROWS_MAX.
size_t bwd_smem(int C, int H, int rows, int dtypes) {
  if (H < 8 || H > 64 || (H & (H - 1)) || C < 8 || C % 8 || C > 2 * H ||
      C + H > MA * (BT / H) || rows < 1 || rows > BWD_ROWS_MAX ||
      dtypes < 0 || dtypes > 2)
    return 0;
  return bwd_layout(C, H, rows, dtypes != 0, dtypes == 1 ? 2 : 4,
                    dtypes == 1).total;
}

template <typename XT, typename WT>
int slab_bwd(const void* x, const void* hp, const float* c_ckpt,
             const void* dy, const void* w_ih, const void* w_hh,
             const void* b, const float* dhT, const float* dcT, void* dx,
             float* dw_ih, float* dw_hh, float* db, float* dh0, float* dc0,
             float* part, int T, int R, int C, int H, int kf, int reverse,
             int rows, int dtypes, cudaStream_t st) {
  const size_t smem = bwd_smem(C, H, rows, dtypes);
  if (!smem || T < 1 || R < 1 || kf < 1) return (int)cudaErrorInvalidValue;
  int err = set_smem((const void*)slab_bwd_kernel<XT, WT>, smem);
  if (err) return err;
  const int n_blocks = (R + rows - 1) / rows;
  slab_bwd_kernel<XT, WT><<<n_blocks, BT, smem, st>>>(
      (const XT*)x, (const WT*)hp, c_ckpt, (const XT*)dy, (const WT*)w_ih,
      (const WT*)w_hh, (const WT*)b, dhT, dcT, (XT*)dx, part, dh0, dc0, T, R,
      C, H, kf, reverse, rows);
  if ((err = (int)cudaGetLastError())) return err;
  const int outs = (C + H + 1) * 4 * H;
  slab_bwd_reduce_kernel<<<(outs + 255) / 256, 256, 0, st>>>(
      part, dw_ih, dw_hh, db, n_blocks, C, H);
  return (int)cudaGetLastError();
}

}  // namespace

// dtypes: the (x, weights) pair, 0 = (fp32, fp32), 1 = (bf16, bf16),
// 2 = (bf16, fp32) (`DTYPES` in ops/kernels/lstm_slab.py); hp has the
// weights' type, dy and dx the activations'.

// The fp32 forwards' (rows 5, 6a, 8a and 10a) shared memory at `rows` rows
// a block, 0 for a shape they do not take.
extern "C" size_t sbt_lstm_fwd32_smem(int C, int H, int rows) {
  return sbt_fwd32::smem_bytes(C, H, rows);
}

// The mixed forwards' (rows 10b and, bseq, 8b and 6b) shared memory at
// `rows` rows a block for the pair dtypes (1 or 2), 0 for a shape they do
// not take.
extern "C" size_t sbt_lstm_fwd_mixed_smem(int C, int H, int rows,
                                          int dtypes, int bseq) {
  if (dtypes != 1 && dtypes != 2) return 0;
  return sbt_fwd32::smem_mixed(C, H, rows, dtypes == 1, bseq != 0);
}

// rows: rows a block of the walk (ops/kernels/lstm_slab.py:fwd_row_tiles).
extern "C" int sbt_lstm_slab_fwd(const void* x, const void* w_ih,
                                 const void* w_hh, const void* b,
                                 const float* h0, const float* c0, void* ys,
                                 float* hT, float* cT, float* c_ckpt, int T,
                                 int R, int C, int H, int kf, int reverse,
                                 int dtypes, int rows, void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtypes) {
    case 0:
      return slab_fwd32(x, w_ih, w_hh, b, h0, c0, ys, hT, cT, c_ckpt, T, R,
                        C, H, kf, reverse, rows, st);
    case 1:
      return slab_fwd_mixed<bf16>(x, w_ih, w_hh, b, h0, c0, ys, hT, cT,
                                  c_ckpt, T, R, C, H, kf, reverse, rows, st);
    case 2:
      return slab_fwd_mixed<float>(x, w_ih, w_hh, b, h0, c0, ys, hT, cT,
                                   c_ckpt, T, R, C, H, kf, reverse, rows, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}


extern "C" size_t sbt_lstm_slab_bwd_smem(int C, int H, int rows,
                                         int dtypes) {
  return bwd_smem(C, H, rows, dtypes);
}

// part: scratch of ceil(R / rows) * (C+H+1) * 4H floats, one partial a block.
extern "C" int sbt_lstm_slab_bwd(const void* x, const void* hp,
                                 const float* c_ckpt, const void* dy,
                                 const void* w_ih, const void* w_hh,
                                 const void* b, const float* dhT,
                                 const float* dcT, void* dx, float* dw_ih,
                                 float* dw_hh, float* db, float* dh0,
                                 float* dc0, float* part, int T, int R, int C,
                                 int H, int kf, int reverse, int rows,
                                 int dtypes, void* stream) {
  cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
#define SBT_BWD(XT, WT)                                                      \
  slab_bwd<XT, WT>(x, hp, c_ckpt, dy, w_ih, w_hh, b, dhT, dcT, dx, dw_ih,    \
                   dw_hh, db, dh0, dc0, part, T, R, C, H, kf, reverse, rows, \
                   dtypes, st)
  switch (dtypes) {
    case 0: return SBT_BWD(float, float);
    case 1: return SBT_BWD(bf16, bf16);
    case 2: return SBT_BWD(bf16, float);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SBT_BWD
}
