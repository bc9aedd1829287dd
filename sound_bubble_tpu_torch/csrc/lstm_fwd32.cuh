// The fp32 forward walk of a single-direction LSTM over x [T, R, C]
// (PyTorch cell, gate order [i, f, g, o]; w_ih [C, 4H], w_hh [H, 4H], one
// folded bias b [4H]), shared by four kernels (the walk's mode M): the slab
// scan's forward (SLAB: `slab_fwd32_kernel`, csrc/lstm_slab.cu; ys, hT, cT
// and the cell state entering each slab, c_ckpt), the custom-VJP route's
// forward (SEQ: `seq_fwd32_kernel` and the mixed `seq_fwd_mixed_kernel`,
// csrc/lstm_seq.cu; y and, every frame, the post-activation gates and the
// cell state), and, one block a direction
// and row tile, both directions of a BLSTM from zero states: the route's
// fused-direction forward (BSEQ: `seq_bfwd32_kernel`, csrc/lstm_seq.cu; the
// same three outputs at the two-direction layout) and the fused inference
// BLSTM (INFER: `blstm_infer_kernel`, csrc/lstm_infer.cu; x and y
// batch-major, y only), and, at R = 1, the intra BLSTM of each block of the
// whole-stack streaming step (STACK: `stack_walk_kernel`,
// csrc/stack_walk.cu; INFER's layout, the weights read from the stack
// step's fused pack). No TF32 and no fast-math: fp32 FMA and expf; the
// activations' reciprocal is `rcp.approx` refined by one Newton step
// (`sigm`, `tanh2`: within a few ulp, and branch-free).
//
// What bounds it (H100, the flagship's training shapes, C = 32, H = 64): the
// products are 2*T*R*(C+H)*4H = 8.92 GFLOP at T*R = 181,540, 0.133 ms at
// 67 TFLOP/s. In practice the recurrence bounds it: T dependent frames a
// row tile, one barrier each. A `clock64()` split of the kernel this
// replaced (8-row blocks, each thread one unit's 96-long dot over [x | h]
// for two rows, W re-read from shared memory every frame; NVIDIA H100 80GB
// HBM3 at 700 W, PERF.md §6) found its frames latency-bound: two thirds of a frame in the dot, each of its 96 steps ~59
// cycles (a shared load, then 8 FMAs that wait on it), with 8 warps an SM
// to hide that; a third of the dot was the x part, which does not depend
// on h. In this design a frame at 10 rows is ~1,100 instructions a warp
// (640 of them the h . W_hh FMAs), ~65 % of the issue bound at two warps a
// scheduler on the same card; the rest is the latency around the frame's
// barrier (`tools/split_fwd_cycles.py` splits a block's cycles).
//
// Design:
// - One block owns `rows` consecutive rows (the wrapper's `fwd_row_tiles`:
//   the fewest that keep the grid within one wave of the card's SMs) and
//   walks all T frames itself, 4H threads; blocks never wait on each other
//   (no grid sync, no flags, no clusters).
// - The input projection is off the chain: per slab of kf <= KMAX frames,
//   gx = x W_ih + b for all the slab's frames x rows is one register-tiled
//   product (`project`: a thread forms the four gates of two units at PASS
//   rows a pass, four inputs a step, W_ih gate-interleaved in shared
//   memory) into shared memory, before the slab's walk. The next slab's x
//   tile is copied in by `cp.async` while the slab is walked.
// - The chain keeps W_hh in registers, as the row-11 backward does for its
//   dh chain: lane (uq, kq) of warp w holds the four gates of unit
//   8w + uq at the KV-wide input chunks kq, kq + 4, ... (H/4 inputs, H
//   weights a lane); four lanes split the H inputs. A group of up to four
//   rows is then NR independent float4 accumulators a lane (16 FMAs a
//   loaded float4 of h), and a reduce-scatter over the four lanes (12
//   shuffles for four rows) leaves each lane the four gate sums of one
//   (row, unit) cell, which it applies itself: the cell state lives in a
//   shared-memory slot of its own lane ((row, unit) never changes lanes; a
//   register array would need the frame's group loop unrolled), h goes to a
//   double-buffered tile for the next frame: one __syncthreads a frame. Up
//   to three groups of a frame (twelve rows) are walked as one
//   straight-line body with no branch around a cell (every lane computes,
//   the owner stores), so the compiler can overlap one group's reduce and
//   cells with the others'. A group of one or two rows reduces to
//   redundant lanes instead (all-reduce), so a tail costs what its rows
//   need. Row 5's layout (a lane owns one gate column and all its H
//   weights) was the other candidate: it loads every h value for a single
//   FMA, four times the shared-memory wavefronts of the FMA rate.
// - Rows of the last block at or past R are computed on zeros and never
//   written; a four-row group past `rows` (rows % 4 == 3) computes its
//   padding row on the last real row's gx.
// Tried and dropped on the card: two blocks an SM (the 128-register cap
// spills in the frame body), a 10-row projection pass (spills), and a
// reduce-scatter without selects (rows in a lane-dependent order): each
// was slower.
// Both directions (BSEQ, INFER): the two are independent, so each is a
// grid half of its own (blocks [0, tiles) walk the forward direction,
// [tiles, 2 tiles) the backward one, reversed, on its own weights): a
// block keeps 4H threads and its W_hh in registers, where one block of 8H
// threads for both would cap a thread at 128 registers. The wrappers take
// rows a block for one wave of 2 x tiles blocks; the inference BLSTM's
// projection passes are as wide as its rows (one to four), so a pass of
// one row at R = 1 computes no padding rows.
//
// The mixed mode (SLAB, SEQ and BSEQ): the walk is templated on the
// activation type XT (x, y and the saved gates), the weight type WT and
// a rounding policy RND, and rounds to bf16 exactly where the Pallas body
// it replaces rounds; with XT = WT = float and RND = EXACT every branch
// below is the fp32 walk's. bf16 products are exact in fp32, so a bf16
// operand is widened and every sum is taken in fp32.
// - RND_SLAB (`lstm_train_slab.py:_fwd_kernel`, mixed; row 10b): gx =
//   x W_ih + b in fp32, unrounded; gates = bf16(gx + bf16(h) W_hh); each
//   sigmoid and tanh in fp32 on the bf16 value, rounded once; c_t = f c +
//   bf16(i g) in fp32 (c carried in fp32); h_t = bf16(o bf16(tanh(bf16(
//   c_t)))); ys bf16, hT, cT and c_ckpt fp32.
// - RND_SEQ (`lstm_train_kernel.py:_fwd_kernel` and `_blstm_fwd_kernel`,
//   mixed; rows 6b and 8b): gx =
//   bf16(x W_ih) + b (rounded again when b is bf16); gates = bf16(gx +
//   bf16(h) W_hh); each sigmoid as `jax.nn.sigmoid` lowers on bf16, 1 /
//   (1 + exp(-v)) with each of its three ops rounded; tanh, c and h as
//   RND_SLAB; the gates stored in bf16, c in fp32.
// c = f c + ig is a multiply, then an add (`__fmul_rn`, `__fadd_rn`), as
// the plain versions take it. What the mode changes in the design:
// - Half the bytes: the x tile is bf16 (its 16-byte `cp.async` pieces need
//   C a multiple of 8). W_hh is held as packed bf16 pairs when WT is bf16
//   (32 registers a lane at H = 64, not 64), widened at use.
// - (bf16, bf16), `train_stream`'s pair: the slab projection runs on the
//   tensor cores (`project_mma`: mma.sync m16n8k16, fp32 accumulation;
//   W_ih bf16 in shared memory, transposed with its columns gate-
//   interleaved, n = 4 unit + gate, so a lane's two accumulators are two
//   gates of one unit). (bf16, fp32), `train_pt --bf16`'s, promotes to
//   fp32 in the Pallas body and stays on FMA. The h . W_hh chain stays on
//   the CUDA cores.
// - SEQ and BSEQ keep gx in bf16 (half SLAB's fp32 gx) and walk KMAX / 2
//   frames a slab (the function does not depend on it), so that a block of
//   up to ROWS_MAX_MIXED rows fits: 38 rows a block put both directions of
//   the bf16 recipe's intra BLSTM (R = 2504) in one wave. Their fp32 bias,
//   when W is fp32, is added in the cell, after the rounding of x W_ih.
//   SEQ starts from h0 and c0: the first product takes bf16(h0), c0 stays
//   fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace sbt_fwd32 {

// What a walk reads and writes: its mode M.
enum : int {
  SLAB = 0,   // x, ys [T, R, H] scan-major, forward or reversed; hT, cT and
              // c_ckpt
  SEQ = 1,    // forward: y, post-activation gates [T, R, 4H], c [T, R, H]
  BSEQ = 2,   // a direction d of a BLSTM, scan-major: y [T, R, 2H] at the
              // original time, gates [T, R, 8H] (gate g at g*2H) and c
              // [T, R, 2H] at the walk's step, at the offset d*H (OutT's
              // pointers come offset); W_hh the pack's diagonal block (row
              // stride 8H); zero initial state
  INFER = 3,  // a direction d of a BLSTM, batch-major x [R, T, C] and y
              // [R, T, 2H] (original time, offset d*H) only; zero initial
              // state
  STACK = 4,  // INFER's x, y and zero state, the weights those of the stack
              // step's fused pack (`pack_stack_params`): gate g of direction
              // d at column g*2H + d*H of w_ih [C, 8H], of the diagonal block
              // of w_hh [2H, 8H] and of b [8H] (the pointers come offset by
              // d*H; rows 8H apart)
};

// The rounding policy of a walk (RND; the header comment).
enum : int {
  EXACT = 0,     // fp32 throughout
  RND_SLAB = 1,  // mixed: the slab scan's Pallas body
  RND_SEQ = 2,   // mixed: the custom-VJP route's Pallas body
};

constexpr int KMAX = 8;       // frames a slab (the TPU kernels' K)
constexpr int ROWS_MAX = 24;  // rows a block
constexpr int ROWS_MAX_MIXED = 48;  // rows a block, mixed mode
constexpr int KS_MAX = 4;     // k-steps of 16 inputs of `project_mma`
constexpr int PASS = 5;       // projection rows a thread a pass
constexpr int NRS = 8;        // projection row sets (4H threads / (H/2))

template <int H>
struct Dims {
  static constexpr int NT = 4 * H;             // threads
  static constexpr int KV = H >= 16 ? 4 : 2;   // inputs a chunk
  static constexpr int NCH = H / (4 * KV);     // chunks a lane
  static constexpr int HS = H + 8;             // row stride of h, c (floats)
  static constexpr int GS = H + 2;             // row stride of gx (float4)
  static constexpr int GSB = H + 8;            // the same, bf16 gx (bf16x4)
};

using bf16 = __nv_bfloat16;

// Four bf16 values of one (row, unit), gate-interleaved (i, f, g, o).
struct __align__(8) bf16x4 {
  __nv_bfloat162 lo, hi;
};

// The layout of a mixed walk's shared memory (byte offsets): W_ih (the
// tensor cores' transposed bf16 copy [4H][xs], or gate-interleaved float4
// [C][H]), gx [kf*rows][GS] float4 (SLAB) or [kf*rows][GSB] bf16x4 (SEQ,
// BSEQ), the x tile [kf*rows][xs] bf16, h [2][R4][HS] and c [R4][HS] fp32.
// xs: C,
// or for the tensor cores C rounded up to 16 (zeros past C) plus 8, a row
// stride that keeps a fragment's loads on distinct banks. kf: frames a
// slab, KMAX (SLAB) or KMAX / 2 (SEQ, BSEQ; `bseq`).
struct MixedLayout {
  size_t gx, xs, hb, cs, total;
  int xstride;
};

__host__ __device__ inline MixedLayout mixed_layout(int C, int H, int rows,
                                                    bool tc, bool bseq) {
  MixedLayout L;
  const size_t r4 = (size_t)(rows + 3) / 4 * 4;
  L.xstride = tc ? (C + 15) / 16 * 16 + 8 : C;
  const size_t n = (size_t)(bseq ? KMAX / 2 : KMAX) * rows;
  L.gx = tc ? (size_t)8 * H * L.xstride : (size_t)16 * C * H;
  L.xs = L.gx + (bseq ? 8 * n * (H + 8) : 16 * n * (H + 2));
  L.hb = L.xs + 2 * n * L.xstride;
  L.cs = L.hb + (size_t)8 * r4 * (H + 8);
  L.total = L.cs + (size_t)4 * r4 * (H + 8);
  return L;
}

// Shared memory of a block of `rows` rows (bytes), 0 for a shape the
// kernels do not take: H in 8, 16, 32, 64; C a multiple of 4; 1 <= rows <=
// ROWS_MAX. Layout: W_ih gate-interleaved [C][H] float4; gx [KMAX*rows][GS]
// float4; the slab's x tile [KMAX*rows][C]; h [2][R4][HS]; c [R4][HS]
// (R4: rows rounded up to 4).
inline size_t smem_bytes(int C, int H, int rows) {
  if ((H != 8 && H != 16 && H != 32 && H != 64) || C < 4 || C % 4 ||
      rows < 1 || rows > ROWS_MAX)
    return 0;
  const size_t r4 = (size_t)(rows + 3) / 4 * 4;
  return (size_t)16 * C * H + (size_t)16 * KMAX * rows * (H + 2) +
         (size_t)4 * KMAX * rows * C + (size_t)12 * r4 * (H + 8);
}

// The same for a mixed walk (`mixed_layout`; tc: bf16 weights, the tensor
// cores' projection; bseq: the bf16 gx of SEQ and BSEQ), 0 for a shape it
// does not take: H in 8, 16, 32, 64; C a multiple of 8 (and, tc, at most
// 16 KS_MAX); 1 <= rows <= ROWS_MAX_MIXED.
inline size_t smem_mixed(int C, int H, int rows, bool tc, bool bseq) {
  if ((H != 8 && H != 16 && H != 32 && H != 64) || C < 8 || C % 8 ||
      (tc && C > 16 * KS_MAX) || rows < 1 || rows > ROWS_MAX_MIXED)
    return 0;
  return mixed_layout(C, H, rows, tc, bseq).total;
}

// 1 / d for d in [1, 6e34]: `rcp.approx` and one Newton step, within ~1 ulp
// of the IEEE quotient and without its slow-path branch, so that the cells
// of a frame can overlap.
__device__ __forceinline__ float rcp1(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return fmaf(fmaf(-d, r, 1.0f), r, r);
}
// sigmoid, and tanh v = 2 sigmoid(2v) - 1, branch-free: expf of at most 80
// keeps 1 + e finite (a NaN goes through); both within a few ulp of 1.
__device__ __forceinline__ float sigm(float v) {
  const float a = -v > 80.0f ? 80.0f : -v;
  return rcp1(1.0f + expf(a));
}
__device__ __forceinline__ float tanh2(float v) {
  return fmaf(2.0f, sigm(2.0f * v), -1.0f);
}
__device__ __forceinline__ void fma4(float4& a, float v, float4 w) {
  a.x += v * w.x; a.y += v * w.y; a.z += v * w.z; a.w += v * w.w;
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 sel4(bool c, float4 a, float4 b) {
  return c ? a : b;
}
__device__ __forceinline__ float4 shfl4(float4 v, int m) {
  return make_float4(__shfl_xor_sync(0xffffffffu, v.x, m),
                     __shfl_xor_sync(0xffffffffu, v.y, m),
                     __shfl_xor_sync(0xffffffffu, v.z, m),
                     __shfl_xor_sync(0xffffffffu, v.w, m));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---- the mixed mode's pieces

// round to bf16 and back (the mixed mode's rounding points)
__device__ __forceinline__ float rb(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// a weight, bias or input as fp32 (bf16 widened: exact)
__device__ __forceinline__ float ldw(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float ldw(const bf16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void put(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void put(bf16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}
// the raw bits of p[i]
__device__ __forceinline__ unsigned bits(const bf16* p, size_t i) {
  return reinterpret_cast<const unsigned short*>(p)[i];
}
// four bf16 of one 8-byte word, widened (lo, hi halves of x, then of y)
__device__ __forceinline__ float4 wide4(uint2 w) {
  return make_float4(__uint_as_float(w.x << 16),
                     __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16),
                     __uint_as_float(w.y & 0xffff0000u));
}
// the chain's weights: a float4 as it is, a packed (i, f | g, o) bf16 4-vector
// widened
__device__ __forceinline__ float4 wv(const float4& w) { return w; }
__device__ __forceinline__ float4 wv(const uint2& w) { return wide4(w); }
// four consecutive inputs of an x tile row
__device__ __forceinline__ float4 ldx4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ldx4(const bf16* p) {
  return wide4(*reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ float4 ld_gx(const float4& g) { return g; }
__device__ __forceinline__ float4 ld_gx(const bf16x4& g) {
  const float2 a = __bfloat1622float2(g.lo), b = __bfloat1622float2(g.hi);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ bf16x4 to_bf16x4(float4 v) {
  bf16x4 o;
  o.lo = __floats2bfloat162_rn(v.x, v.y);
  o.hi = __floats2bfloat162_rn(v.z, v.w);
  return o;
}
__device__ __forceinline__ float4 rb4(float4 v) {
  return make_float4(rb(v.x), rb(v.y), rb(v.z), rb(v.w));
}

// The mixed activations, each rounded to bf16: sigmoid and tanh in fp32 on
// the bf16 value, rounded once (RND_SLAB), or the sigmoid as three bf16 ops
// (RND_SEQ). There 1 / d is XLA's IEEE quotient: d is a bf16 value >= 1,
// and for each of the 128 bf16 mantissas every fp32 value within 128 ulps
// of the quotient rounds to its bf16 (`test_bf16_reciprocal_margin`), so
// `rcp1`'s ulp does not move the result; past `rcp1`'s range (d > 6e34:
// v < -80, or inf) the IEEE quotient.
template <int RND>
__device__ __forceinline__ float sig_m(float v) {
  if constexpr (RND == RND_SEQ) {
    const float d = rb(1.0f + rb(expf(-v)));
    return rb(d <= 6e34f ? rcp1(d) : __frcp_rn(d));
  } else {
    return rb(sigm(v));
  }
}
__device__ __forceinline__ float tanh_m(float v) { return rb(tanhf(v)); }

// D += A B for one m16n8k16 tile on the tensor cores: bf16 A (row-major)
// and B (column-major) fragments, fp32 accumulators.
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

// gx for the slab's n rows p (frame-major) on the tensor cores: the x tile
// [n][xs] times W_ih's transposed copy wt [4H][xs] (columns n = 4 unit +
// gate), NKS k-steps of 16 inputs. Warp w of the H / 8 owns the 8-column
// tiles w + (H / 8) j, j < 4 (two units each; their B fragments in
// registers) and walks the 16-row tiles, each k-step's A fragment feeding
// the four tiles' independent accumulators (one accumulator chain would
// wait on each mma's latency in turn); lane (g, t) holds gates 2 (t & 1)
// and 2 (t & 1) + 1 of unit 2 tile + t / 2 at rows g and g + 8. SLAB: gx =
// x W_ih + b (fp32); GX bf16x4 (SEQ, BSEQ): bf16(bf16(x W_ih) + b). Rows
// past n are read as row n - 1 and not stored.
template <int H, int M, int NKS, typename GX>
__device__ __forceinline__ void project_mma(const bf16* __restrict__ wt,
                                            const bf16* __restrict__ xt,
                                            GX* __restrict__ gx,
                                            const bf16* __restrict__ b,
                                            int xs, int n) {
  constexpr int NW = H / 8;
  constexpr bool BGX = std::is_same<GX, bf16x4>::value;
  constexpr int GSX = BGX ? Dims<H>::GSB : Dims<H>::GS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, hi = t & 1;
  unsigned bfr[4][NKS][2];
  float b0[4], b1[4];
  int u[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int nt = warp + NW * j;
    u[j] = nt * 2 + (t >> 1);
#pragma unroll
    for (int k = 0; k < NKS; ++k) {
      const bf16* col = wt + (nt * 8 + g) * xs + 16 * k + 2 * t;
      bfr[j][k][0] = ld32(col);
      bfr[j][k][1] = ld32(col + 8);
    }
    b0[j] = ldw(b, 2 * hi * H + u[j]);
    b1[j] = ldw(b, (2 * hi + 1) * H + u[j]);
  }
  for (int r0 = g; r0 - g < n; r0 += 16) {
    const bf16* lo = xt + min(r0, n - 1) * xs + 2 * t;
    const bf16* hi8 = xt + min(r0 + 8, n - 1) * xs + 2 * t;
    float d[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
#pragma unroll
    for (int k = 0; k < NKS; ++k) {
      const unsigned a[4] = {ld32(lo + 16 * k), ld32(hi8 + 16 * k),
                             ld32(lo + 16 * k + 8), ld32(hi8 + 16 * k + 8)};
#pragma unroll
      for (int j = 0; j < 4; ++j) mma16816(d[j], a, bfr[j][k]);
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int p = r0 + 8 * rr;
      if (p < n) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (BGX) {
            reinterpret_cast<__nv_bfloat162*>(gx + p * GSX + u[j])[hi] =
                __floats2bfloat162_rn(rb(d[j][2 * rr]) + b0[j],
                                      rb(d[j][2 * rr + 1]) + b1[j]);
          } else {
            reinterpret_cast<float2*>(gx + p * GSX + u[j])[hi] =
                make_float2(d[j][2 * rr] + b0[j], d[j][2 * rr + 1] + b1[j]);
          }
        }
      }
    }
  }
}

// gx[p] = b + x[p] W_ih for the slab's n rows p (frame-major): thread
// (up, rs) forms units up and up + H/2, four gates each, at the rows
// rs + NRS m, P rows a pass, four inputs a step. A pass always computes
// P rows (past n: the last row again, not stored), so its loads carry no
// branch and can run ahead of the FMAs. Mixed (bf16 x, fp32 W_ih): the
// sums start at 0; SLAB adds b after them, SEQ and BSEQ (bf16 gx) store
// bf16(x W_ih) and their cells add b.
template <int H, int P = PASS, int RND = EXACT, typename XT = float,
          typename GX = float4>
__device__ __forceinline__ void project(const float4* __restrict__ w4,
                                        const XT* __restrict__ xt,
                                        GX* __restrict__ gx, int C, int n,
                                        int up, int rs, float4 b0,
                                        float4 b1) {
  constexpr bool BGX = std::is_same<GX, bf16x4>::value;
  constexpr int GS = BGX ? Dims<H>::GSB : Dims<H>::GS, H2 = H / 2;
  for (int p0 = rs; p0 < n; p0 += NRS * P) {
    float4 a0[P], a1[P];
    const XT* xr[P];
#pragma unroll
    for (int m = 0; m < P; ++m) {
      if constexpr (RND == EXACT) {
        a0[m] = b0;
        a1[m] = b1;
      } else {
        a0[m] = a1[m] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      xr[m] = xt + min(p0 + NRS * m, n - 1) * C;
    }
#pragma unroll 2
    for (int k = 0; k < C; k += 4) {
      float4 wa[4], wb[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        wa[e] = w4[(k + e) * H + up];
        wb[e] = w4[(k + e) * H + up + H2];
      }
#pragma unroll
      for (int m = 0; m < P; ++m) {
        const float4 v = ldx4(xr[m] + k);
        fma4(a0[m], v.x, wa[0]); fma4(a1[m], v.x, wb[0]);
        fma4(a0[m], v.y, wa[1]); fma4(a1[m], v.y, wb[1]);
        fma4(a0[m], v.z, wa[2]); fma4(a1[m], v.z, wb[2]);
        fma4(a0[m], v.w, wa[3]); fma4(a1[m], v.w, wb[3]);
      }
    }
#pragma unroll
    for (int m = 0; m < P; ++m) {
      const int p = p0 + NRS * m;
      if (p < n) {
        if constexpr (RND == EXACT) {
          gx[p * GS + up] = a0[m];
          gx[p * GS + up + H2] = a1[m];
        } else if constexpr (BGX) {
          gx[p * GS + up] = to_bf16x4(a0[m]);
          gx[p * GS + up + H2] = to_bf16x4(a1[m]);
        } else {
          gx[p * GS + up] = add4(a0[m], b0);
          gx[p * GS + up + H2] = add4(a1[m], b1);
        }
      }
    }
  }
}

// Sums over the four lanes kq of the NR rows' gate partials: the lane's
// (row rho, all four gates); own: the lane that stores the cell (NR < 4
// leaves the same sums in 4 / NR lanes).
template <int NR>
__device__ __forceinline__ float4 reduce_rows(const float4* acc, int kq,
                                              int& rho, bool& own) {
  const bool b0 = kq & 1, b1 = kq & 2;
  if constexpr (NR == 4) {
    const float4 a0 =
        add4(sel4(b0, acc[2], acc[0]), shfl4(sel4(b0, acc[0], acc[2]), 1));
    const float4 a1 =
        add4(sel4(b0, acc[3], acc[1]), shfl4(sel4(b0, acc[1], acc[3]), 1));
    rho = 2 * b0 + b1;
    own = true;
    return add4(sel4(b1, a1, a0), shfl4(sel4(b1, a0, a1), 2));
  } else if constexpr (NR == 2) {
    const float4 a =
        add4(sel4(b0, acc[1], acc[0]), shfl4(sel4(b0, acc[0], acc[1]), 1));
    rho = b0;
    own = !b1;
    return add4(a, shfl4(a, 2));
  } else {
    const float4 a = add4(acc[0], shfl4(acc[0], 1));
    rho = 0;
    own = kq == 0;
    return add4(a, shfl4(a, 2));
  }
}

// What a frame writes besides h and c (device memory; BSEQ, INFER and
// STACK: at the direction's offset). Mixed: y and the gates bf16.
template <typename YT = float, typename GT = float>
struct OutT {
  YT* y;          // [T, R, H]; BSEQ [T, R, 2H]; INFER, STACK [R, T, 2H]
  GT* gates;      // post-activation [T, R, 4H] (SEQ), [T, R, 8H] (BSEQ), or
                  // null
  float* cseq;    // [T, R, H] (SEQ), [T, R, 2H] (BSEQ), or null
};

// What the types and the rounding policy make of a walk in mode M.
template <int M, typename XT, typename WT, int RND>
struct Policy {
  static_assert(RND == EXACT ? std::is_same<XT, float>::value &&
                                   std::is_same<WT, float>::value
                             : std::is_same<XT, bf16>::value &&
                                   (M == SLAB || M == SEQ || M == BSEQ),
                "the mixed mode: bf16 x, SLAB, SEQ or BSEQ");
  static constexpr int kRnd = RND;
  static constexpr bool kMixed = RND != EXACT;
  // the projection on the tensor cores: bf16 x and weights
  static constexpr bool kTC = kMixed && std::is_same<WT, bf16>::value;
  // SEQ's and BSEQ's bf16 gx; with fp32 weights b is added in the cell
  static constexpr bool kBgx = kMixed && (M == SEQ || M == BSEQ);
  static constexpr bool kBias = kBgx && !kTC;
  using GX = typename std::conditional<kBgx, bf16x4, float4>::type;
  using GT = typename std::conditional<kMixed, bf16, float>::type;
  // a lane's W_hh 4-vectors: packed bf16 pairs for bf16 weights
  using WR = typename std::conditional<std::is_same<WT, bf16>::value, uint2,
                                       float4>::type;
};

// Apply the cell of (row, unit cu) from its four gate sums v (gx not yet
// added). Every lane computes (no branch, so the compiler can overlap
// groups); the owner lane stores c, h and the frame's outputs. A lane that
// does not own the cell may read c after its owner wrote it: it stores
// nothing. base: the index of the tile's first row at this frame's time in
// y's rows (INFER, STACK: rows r*T + t, so row q is base + q*T); sbase: the
// same at the walk's step in the gates' and c's rows (BSEQ). bc: the
// unit's bias, where the cell adds it (P::kBias).
template <int H, int M, typename P, typename O>
__device__ __forceinline__ void cell(float4 v, int row, bool own,
                                     const typename P::GX* __restrict__ gq,
                                     float* __restrict__ cs,
                                     float* __restrict__ hn, int cu,
                                     int rows, int rt, size_t base,
                                     size_t sbase, int T, const O& o,
                                     float4 bc) {
  constexpr int HS = Dims<H>::HS;
  constexpr int GS = P::kBgx ? Dims<H>::GSB : Dims<H>::GS;
  float ig, fg, gg, og, c, h;
  if constexpr (!P::kMixed) {
    v = add4(v, gq[min(row, rows - 1) * GS + cu]);
    ig = sigm(v.x), fg = sigm(v.y), gg = tanh2(v.z), og = sigm(v.w);
  } else {
    float4 gxv = ld_gx(gq[min(row, rows - 1) * GS + cu]);
    if constexpr (P::kBias) gxv = add4(gxv, bc);   // bf16(x W_ih) + b
    const float4 pre = rb4(add4(gxv, v));          // bf16(gx + h W_hh)
    ig = sig_m<P::kRnd>(pre.x), fg = sig_m<P::kRnd>(pre.y);
    gg = tanh_m(pre.z), og = sig_m<P::kRnd>(pre.w);
  }
  float* cp = cs + row * HS + cu;
  if constexpr (!P::kMixed) {
    c = fg * *cp + ig * gg;
    h = og * tanh2(c);
  } else {
    c = __fadd_rn(__fmul_rn(fg, *cp), rb(ig * gg));
    h = rb(og * tanh_m(rb(c)));
  }
  if (own) {
    *cp = c;
    hn[row * HS + cu] = h;
  }
  if (own && row < rt) {
    constexpr int W = M == BSEQ || M >= INFER ? 2 * H : H;  // y's row width
    const size_t yi = M >= INFER ? base + (size_t)row * T : base + row;
    put(o.y, yi * W + cu, h);
    if constexpr (M == SEQ || M == BSEQ) {
      const size_t si = (M == BSEQ ? sbase : base) + row;
      typename P::GT* g = o.gates + si * 4 * W + cu;
      put(g, 0, ig); put(g, W, fg); put(g, 2 * W, gg); put(g, 3 * W, og);
      o.cseq[si * W + cu] = c;
    }
  }
}

// One frame's cells of up to three row groups from row g: NA, NB, NC rows
// (4, 2 or 1; 0: no group): h . W_hh for all of them, then each group's
// reduce and cells, as one straight-line body.
template <int H, int M, typename P, int NA, int NB, int NC, typename O>
__device__ __forceinline__ void rows_step(
    int g, const float* __restrict__ hc, float* __restrict__ hn,
    const typename P::GX* __restrict__ gq, float* __restrict__ cs,
    const typename P::WR (&wr)[Dims<H>::NCH][Dims<H>::KV], int kq, int cu,
    int rows, int rt, size_t base, size_t sbase, int T, const O& o,
    float4 bc) {
  using D = Dims<H>;
  constexpr int N = NA + NB + NC;
  float4 acc[N];
#pragma unroll
  for (int r = 0; r < N; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < D::NCH; ++i) {
#pragma unroll
    for (int r = 0; r < N; ++r) {
      const float* hp = hc + (g + r) * D::HS + D::KV * (4 * i + kq);
      if constexpr (D::KV == 4) {
        const float4 hv = *reinterpret_cast<const float4*>(hp);
        fma4(acc[r], hv.x, wv(wr[i][0])); fma4(acc[r], hv.y, wv(wr[i][1]));
        fma4(acc[r], hv.z, wv(wr[i][2])); fma4(acc[r], hv.w, wv(wr[i][3]));
      } else {
        const float2 hv = *reinterpret_cast<const float2*>(hp);
        fma4(acc[r], hv.x, wv(wr[i][0])); fma4(acc[r], hv.y, wv(wr[i][1]));
      }
    }
  }
  int rho[3] = {0, 0, 0};
  bool own[3] = {false, false, false};
  float4 v[3];
  v[0] = reduce_rows<NA>(acc, kq, rho[0], own[0]);
  if constexpr (NB > 0) v[1] = reduce_rows<NB>(acc + NA, kq, rho[1], own[1]);
  if constexpr (NC > 0)
    v[2] = reduce_rows<NC>(acc + NA + NB, kq, rho[2], own[2]);
  cell<H, M, P>(v[0], g + rho[0], own[0], gq, cs, hn, cu, rows, rt, base,
                sbase, T, o, bc);
  if constexpr (NB > 0)
    cell<H, M, P>(v[1], g + NA + rho[1], own[1], gq, cs, hn, cu, rows, rt,
                  base, sbase, T, o, bc);
  if constexpr (NC > 0)
    cell<H, M, P>(v[2], g + NA + NB + rho[2], own[2], gq, cs, hn, cu, rows,
                  rt, base, sbase, T, o, bc);
}

// The walk of row tile `tile` in mode M (outputs o; SLAB also hT, cT and
// c_ckpt), forward or reversed (SEQ: forward only). BSEQ, INFER and STACK
// take no h0 / c0 (zero states). RT > 0: rows is RT, known to the compiler,
// so a frame's row groups and the projection's passes are fixed at compile
// time (no jump table, a smaller body); 0: rows as given. XT, WT, RND: the
// mixed mode (the header comment); its shared memory is `mixed_layout`'s,
// and kf at most its frames a slab.
template <int H, int M, int RT = 0, typename XT = float, typename WT = float,
          int RND = EXACT>
__device__ __forceinline__ void walk(
    const XT* __restrict__ x, const WT* __restrict__ w_ih,
    const WT* __restrict__ w_hh, const WT* __restrict__ b,
    const float* __restrict__ h0, const float* __restrict__ c0,
    OutT<XT, typename Policy<M, XT, WT, RND>::GT> o,
    float* __restrict__ hT, float* __restrict__ cT,
    float* __restrict__ c_ckpt, int T, int R, int C, int kf, int reverse,
    int rows, int tile) {
  using D = Dims<H>;
  using P = Policy<M, XT, WT, RND>;
  using GX = typename P::GX;
  constexpr int NT = D::NT, HS = D::HS, H4 = 4 * H;
  constexpr int GS = P::kBgx ? D::GSB : D::GS;  // row stride of gx
  constexpr int WS = M == BSEQ || M == STACK ? 8 * H : H4;  // w_hh's rows
  constexpr int WI = M == STACK ? 8 * H : H4;   // row stride of w_ih
  constexpr int GC = M == STACK ? 2 * H : H;    // column stride of a gate
  constexpr int EPV = 16 / sizeof(XT);          // x values a 16-byte piece
  if constexpr (RT > 0) rows = RT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int r4 = (rows + 3) / 4 * 4;
  float4* w4 = reinterpret_cast<float4*>(smem);             // [C][H]
  GX* gx;                                                   // [KMAX*rows][GS]
  XT* xs;                                                   // [KMAX*rows][C]
  float* hb;                                                // [2][r4][HS]
  float* cs;                                                // [r4][HS]
  int xst = C;  // the x tile's row stride
  if constexpr (!P::kMixed) {
    gx = w4 + C * H;
    xs = reinterpret_cast<float*>(gx + KMAX * rows * GS);
    hb = xs + KMAX * rows * C;
    cs = hb + 2 * r4 * HS;
  } else {
    const MixedLayout L = mixed_layout(C, H, rows, P::kTC, P::kBgx);
    gx = reinterpret_cast<GX*>(smem + L.gx);
    xs = reinterpret_cast<XT*>(smem + L.xs);
    hb = reinterpret_cast<float*>(smem + L.hb);
    cs = reinterpret_cast<float*>(smem + L.cs);
    xst = L.xstride;
  }
  const int tid = threadIdx.x;
  const int row0 = tile * rows, rt = min(rows, R - row0);
  const int nb = (T + kf - 1) / kf;

  // the slab js's x rows (processing order) into the tile; rows past R: 0
  auto load_x = [&](int js) {
    const int blk = reverse ? nb - 1 - js : js;
    const int lo = blk * kf, nf = min(T, lo + kf) - lo, cv = C / EPV;
    for (int i = tid; i < nf * rows * cv; i += NT) {
      const int q = i / (rows * cv), rem = i - q * rows * cv;
      const int r = rem / cv, v = rem - r * cv;
      const int t = reverse ? lo + nf - 1 - q : lo + q;
      XT* d = xs + (q * rows + r) * xst + EPV * v;
      const size_t xi = M >= INFER ? (size_t)(row0 + r) * T + t
                                   : (size_t)t * R + row0 + r;
      if (r < rt)
        cp_async16(d, x + xi * C + EPV * v);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    cp_async_commit();
  };
  load_x(0);

  if constexpr (P::kTC) {
    // W_ih transposed, column n = 4u + gate, zeros past C; the x tile's
    // columns past C are zeros too (the copies never write them)
    bf16* wt = reinterpret_cast<bf16*>(smem);
    for (int i = tid; i < H4 * xst; i += NT) {
      const int n = i / xst, k = i - n * xst;
      wt[i] = k < C ? w_ih[(size_t)k * WI + (n & 3) * GC + (n >> 2)]
                    : __float2bfloat16_rn(0.f);
    }
    for (int i = tid; i < kf * rows * (xst - C); i += NT) {
      const int p = i / (xst - C);
      xs[p * xst + C + (i - p * (xst - C))] = __float2bfloat16_rn(0.f);
    }
  } else {
    for (int i = tid; i < C * H; i += NT) {
      const int k = i / H, u = i - k * H;
      const WT* wrow = w_ih + (size_t)k * WI;
      w4[i] = make_float4(wrow[u], wrow[GC + u], wrow[2 * GC + u],
                          wrow[3 * GC + u]);
    }
  }
  for (int i = tid; i < r4 * H; i += NT) {
    const int r = i / H, u = i - r * H;
    if constexpr (M == BSEQ || M >= INFER) {
      hb[r * HS + u] = cs[r * HS + u] = 0.f;
    } else {
      const bool ok = r < rt;
      // the mixed recurrence takes bf16(h)
      const float h = ok ? h0[(size_t)(row0 + r) * H + u] : 0.f;
      hb[r * HS + u] = P::kMixed ? rb(h) : h;
      cs[r * HS + u] = ok ? c0[(size_t)(row0 + r) * H + u] : 0.f;
    }
  }
  // the chain's lane (uq, kq): unit cu, input chunks kq, kq + 4, ...
  const int lane = tid & 31, kq = lane & 3, cu = (tid >> 5) * 8 + (lane >> 2);
  typename P::WR wr[D::NCH][D::KV];
#pragma unroll
  for (int i = 0; i < D::NCH; ++i)
#pragma unroll
    for (int e = 0; e < D::KV; ++e) {
      const size_t wo = (size_t)(D::KV * (4 * i + kq) + e) * WS;
      if constexpr (std::is_same<WT, bf16>::value) {
        wr[i][e] = make_uint2(
            bits(w_hh, wo + cu) | bits(w_hh, wo + GC + cu) << 16,
            bits(w_hh, wo + 2 * GC + cu) | bits(w_hh, wo + 3 * GC + cu) << 16);
      } else {
        const WT* wrow = w_hh + wo;
        wr[i][e] = make_float4(wrow[cu], wrow[GC + cu], wrow[2 * GC + cu],
                               wrow[3 * GC + cu]);
      }
    }
  // the projection's thread (up, rs)
  const int up = tid % (H / 2), rs = tid / (H / 2);
  float4 b0, b1, bc = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (!P::kTC) {
    b0 = make_float4(b[up], b[GC + up], b[2 * GC + up], b[3 * GC + up]);
    const int u1 = up + H / 2;
    b1 = make_float4(b[u1], b[GC + u1], b[2 * GC + u1], b[3 * GC + u1]);
  }
  if constexpr (P::kBias)
    bc = make_float4(b[cu], b[GC + cu], b[2 * GC + cu], b[3 * GC + cu]);

  int n = 0;  // frames walked: h of the last one is in hb[n & 1]
  for (int js = 0; js < nb; ++js) {
    const int blk = reverse ? nb - 1 - js : js;
    const int lo = blk * kf, nf = min(T, lo + kf) - lo;
    cp_async_wait_all();
    __syncthreads();  // the x tile is in; the last walk is done with gx
    if constexpr (M >= INFER) {  // passes as wide as the rows (KMAX == NRS)
      const int n_p = nf * rows;
      switch (rows) {
        case 1: project<H, 1>(w4, xs, gx, C, n_p, up, rs, b0, b1); break;
        case 2: project<H, 2>(w4, xs, gx, C, n_p, up, rs, b0, b1); break;
        case 3: case 4: project<H, 4>(w4, xs, gx, C, n_p, up, rs, b0, b1);
          break;
        default: project<H>(w4, xs, gx, C, n_p, up, rs, b0, b1);
      }
    } else if constexpr (P::kTC) {   // k-steps of 16 inputs: C <= 64
      const bf16* wt = reinterpret_cast<const bf16*>(smem);
      const int n_p = nf * rows;
      switch ((C + 15) / 16) {
        case 1: project_mma<H, M, 1>(wt, xs, gx, b, xst, n_p); break;
        case 2: project_mma<H, M, 2>(wt, xs, gx, b, xst, n_p); break;
        case 3: project_mma<H, M, 3>(wt, xs, gx, b, xst, n_p); break;
        default: project_mma<H, M, 4>(wt, xs, gx, b, xst, n_p);
      }
    } else {
      project<H, PASS, RND>(w4, xs, gx, C, nf * rows, up, rs, b0, b1);
    }
    if constexpr (M == SLAB) {
      for (int i = tid; i < rt * H; i += NT) {
        const int r = i / H, u = i - r * H;
        c_ckpt[((size_t)blk * R + row0 + r) * H + u] = cs[r * HS + u];
      }
    }
    __syncthreads();  // gx is in; the x tile and c are free
    if (js + 1 < nb) load_x(js + 1);
    for (int q = 0; q < nf; ++q, ++n) {
      const int t = reverse ? lo + nf - 1 - q : lo + q;
      const float* hc = hb + (n & 1) * r4 * HS;
      float* hn = hb + ((n + 1) & 1) * r4 * HS;
      const GX* gq = gx + q * rows * GS;
      const size_t base = M >= INFER ? (size_t)row0 * T + t
                                     : (size_t)t * R + row0;
      const size_t sbase = (size_t)n * R + row0;  // the walk's step (BSEQ)
      int g = 0;
      for (; rows - g > 12; g += 12)
        rows_step<H, M, P, 4, 4, 4>(g, hc, hn, gq, cs, wr, kq, cu, rows, rt,
                                    base, sbase, T, o, bc);
#define SBT_ROWS(A, B, C_)                                                   \
  rows_step<H, M, P, A, B, C_>(g, hc, hn, gq, cs, wr, kq, cu, rows, rt,      \
                               base, sbase, T, o, bc);                       \
  break
      switch (rows - g) {  // the last 1-12 rows; 3, 7, 11: one padding row
        case 1: SBT_ROWS(1, 0, 0);
        case 2: SBT_ROWS(2, 0, 0);
        case 3: case 4: SBT_ROWS(4, 0, 0);
        case 5: SBT_ROWS(4, 1, 0);
        case 6: SBT_ROWS(4, 2, 0);
        case 7: case 8: SBT_ROWS(4, 4, 0);
        case 9: SBT_ROWS(4, 4, 1);
        case 10: SBT_ROWS(4, 4, 2);
        default: SBT_ROWS(4, 4, 4);
      }
#undef SBT_ROWS
      __syncthreads();  // h of this frame is in hn
    }
  }
  if constexpr (M == SLAB) {
    const float* hl = hb + (n & 1) * r4 * HS;
    for (int i = tid; i < rt * H; i += NT) {
      const int r = i / H, u = i - r * H;
      hT[(size_t)(row0 + r) * H + u] = hl[r * HS + u];
      cT[(size_t)(row0 + r) * H + u] = cs[r * HS + u];
    }
  }
}

// Launch ks[log2(H / 8)] (the kernel's instantiations for H = 8, 16, 32,
// 64) over nd x ceil(R / rows) blocks of 4H threads (nd directions) with
// smem bytes of shared memory (0: a shape the walk does not take); a CUDA
// error code, or cudaErrorInvalidValue for a shape the walk does not take.
template <typename... P, typename... A>
int launch_smem(void (*const (&ks)[4])(P...), size_t smem, int H, int T,
                int R, int rows, int nd, cudaStream_t st, A... args) {
  if (!smem || T < 1 || R < 1) return (int)cudaErrorInvalidValue;
  void (*k)(P...) = ks[H == 8 ? 0 : H == 16 ? 1 : H == 32 ? 2 : 3];
  int err = (int)cudaFuncSetAttribute(
      (const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  k<<<nd * ((R + rows - 1) / rows), 4 * H, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

// The same with the fp32 walk's shared memory.
template <typename... P, typename... A>
int launch(void (*const (&ks)[4])(P...), int H, int C, int T, int R,
           int rows, int nd, cudaStream_t st, A... args) {
  return launch_smem(ks, smem_bytes(C, H, rows), H, T, R, rows, nd, st,
                     args...);
}

}  // namespace sbt_fwd32
