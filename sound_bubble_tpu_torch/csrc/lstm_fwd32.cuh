// The fp32 forward walk of a single-direction LSTM over x [T, R, C]
// (PyTorch cell, gate order [i, f, g, o]; w_ih [C, 4H], w_hh [H, 4H], one
// folded bias b [4H]), shared by four kernels (the walk's mode M): the slab
// scan's forward (SLAB: `slab_fwd32_kernel`, csrc/lstm_slab.cu; ys, hT, cT
// and the cell state entering each slab, c_ckpt), the custom-VJP route's
// forward (SEQ: `seq_fwd32_kernel`, csrc/lstm_seq.cu; y and, every frame,
// the post-activation gates and the cell state), and, one block a direction
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
#pragma once

#include <cuda_runtime.h>

namespace sbt_fwd32 {

// What a walk reads and writes: its mode M.
enum : int {
  SLAB = 0,   // x, ys [T, R, H] scan-major, forward or reversed; hT, cT and
              // c_ckpt
  SEQ = 1,    // forward: y, post-activation gates [T, R, 4H], c [T, R, H]
  BSEQ = 2,   // a direction d of a BLSTM, scan-major: y [T, R, 2H] at the
              // original time, gates [T, R, 8H] (gate g at g*2H) and c
              // [T, R, 2H] at the walk's step, at the offset d*H (Out's
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

constexpr int KMAX = 8;       // frames a slab (the TPU kernels' K)
constexpr int ROWS_MAX = 24;  // rows a block
constexpr int PASS = 5;       // projection rows a thread a pass
constexpr int NRS = 8;        // projection row sets (4H threads / (H/2))

template <int H>
struct Dims {
  static constexpr int NT = 4 * H;             // threads
  static constexpr int KV = H >= 16 ? 4 : 2;   // inputs a chunk
  static constexpr int NCH = H / (4 * KV);     // chunks a lane
  static constexpr int HS = H + 8;             // row stride of h, c (floats)
  static constexpr int GS = H + 2;             // row stride of gx (float4)
};

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

// gx[p] = b + x[p] W_ih for the slab's n rows p (frame-major): thread
// (up, rs) forms units up and up + H/2, four gates each, at the rows
// rs + NRS m, P rows a pass, four inputs a step. A pass always computes
// P rows (past n: the last row again, not stored), so its loads carry no
// branch and can run ahead of the FMAs.
template <int H, int P = PASS>
__device__ __forceinline__ void project(const float4* __restrict__ w4,
                                        const float* __restrict__ xt,
                                        float4* __restrict__ gx, int C, int n,
                                        int up, int rs, float4 b0,
                                        float4 b1) {
  constexpr int GS = Dims<H>::GS, H2 = H / 2;
  for (int p0 = rs; p0 < n; p0 += NRS * P) {
    float4 a0[P], a1[P];
    const float* xr[P];
#pragma unroll
    for (int m = 0; m < P; ++m) {
      a0[m] = b0;
      a1[m] = b1;
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
        const float4 v = *reinterpret_cast<const float4*>(xr[m] + k);
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
        gx[p * GS + up] = a0[m];
        gx[p * GS + up + H2] = a1[m];
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
// STACK: at the direction's offset).
struct Out {
  float* y;       // [T, R, H]; BSEQ [T, R, 2H]; INFER, STACK [R, T, 2H]
  float* gates;   // post-activation [T, R, 4H] (SEQ), [T, R, 8H] (BSEQ), or
                  // null
  float* cseq;    // [T, R, H] (SEQ), [T, R, 2H] (BSEQ), or null
};

// Apply the cell of (row, unit cu) from its four gate sums v (gx not yet
// added). Every lane computes (no branch, so the compiler can overlap
// groups); the owner lane stores c, h and the frame's outputs. A lane that
// does not own the cell may read c after its owner wrote it: it stores
// nothing. base: the index of the tile's first row at this frame's time in
// y's rows (INFER, STACK: rows r*T + t, so row q is base + q*T); sbase: the
// same at the walk's step in the gates' and c's rows (BSEQ).
template <int H, int M>
__device__ __forceinline__ void cell(float4 v, int row, bool own,
                                     const float4* __restrict__ gq,
                                     float* __restrict__ cs,
                                     float* __restrict__ hn, int cu,
                                     int rows, int rt, size_t base,
                                     size_t sbase, int T, const Out& o) {
  constexpr int HS = Dims<H>::HS, GS = Dims<H>::GS;
  v = add4(v, gq[min(row, rows - 1) * GS + cu]);
  const float ig = sigm(v.x), fg = sigm(v.y), gg = tanh2(v.z),
              og = sigm(v.w);
  float* cp = cs + row * HS + cu;
  const float c = fg * *cp + ig * gg;
  const float h = og * tanh2(c);
  if (own) {
    *cp = c;
    hn[row * HS + cu] = h;
  }
  if (own && row < rt) {
    constexpr int W = M == BSEQ || M >= INFER ? 2 * H : H;  // y's row width
    const size_t yi = M >= INFER ? base + (size_t)row * T : base + row;
    o.y[yi * W + cu] = h;
    if constexpr (M == SEQ || M == BSEQ) {
      const size_t si = (M == BSEQ ? sbase : base) + row;
      float* g = o.gates + si * 4 * W + cu;
      g[0] = ig; g[W] = fg; g[2 * W] = gg; g[3 * W] = og;
      o.cseq[si * W + cu] = c;
    }
  }
}

// One frame's cells of up to three row groups from row g: NA, NB, NC rows
// (4, 2 or 1; 0: no group): h . W_hh for all of them, then each group's
// reduce and cells, as one straight-line body.
template <int H, int M, int NA, int NB, int NC>
__device__ __forceinline__ void rows_step(
    int g, const float* __restrict__ hc, float* __restrict__ hn,
    const float4* __restrict__ gq, float* __restrict__ cs,
    const float4 (&wr)[Dims<H>::NCH][Dims<H>::KV], int kq, int cu, int rows,
    int rt, size_t base, size_t sbase, int T, const Out& o) {
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
        fma4(acc[r], hv.x, wr[i][0]); fma4(acc[r], hv.y, wr[i][1]);
        fma4(acc[r], hv.z, wr[i][2]); fma4(acc[r], hv.w, wr[i][3]);
      } else {
        const float2 hv = *reinterpret_cast<const float2*>(hp);
        fma4(acc[r], hv.x, wr[i][0]); fma4(acc[r], hv.y, wr[i][1]);
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
  cell<H, M>(v[0], g + rho[0], own[0], gq, cs, hn, cu, rows, rt, base, sbase,
             T, o);
  if constexpr (NB > 0)
    cell<H, M>(v[1], g + NA + rho[1], own[1], gq, cs, hn, cu, rows, rt, base,
               sbase, T, o);
  if constexpr (NC > 0)
    cell<H, M>(v[2], g + NA + NB + rho[2], own[2], gq, cs, hn, cu, rows, rt,
               base, sbase, T, o);
}

// The walk of row tile `tile` in mode M (outputs o; SLAB also hT, cT and
// c_ckpt), forward or reversed (SEQ: forward only). BSEQ, INFER and STACK
// take no h0 / c0 (zero states). RT > 0: rows is RT, known to the compiler,
// so a frame's row groups and the projection's passes are fixed at compile
// time (no jump table, a smaller body); 0: rows as given.
template <int H, int M, int RT = 0>
__device__ __forceinline__ void walk(
    const float* __restrict__ x, const float* __restrict__ w_ih,
    const float* __restrict__ w_hh, const float* __restrict__ b,
    const float* __restrict__ h0, const float* __restrict__ c0, Out o,
    float* __restrict__ hT, float* __restrict__ cT,
    float* __restrict__ c_ckpt, int T, int R, int C, int kf, int reverse,
    int rows, int tile) {
  using D = Dims<H>;
  constexpr int NT = D::NT, HS = D::HS, GS = D::GS, H4 = 4 * H;
  constexpr int WS = M == BSEQ || M == STACK ? 8 * H : H4;  // w_hh's rows
  constexpr int WI = M == STACK ? 8 * H : H4;   // row stride of w_ih
  constexpr int GC = M == STACK ? 2 * H : H;    // column stride of a gate
  if constexpr (RT > 0) rows = RT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int r4 = (rows + 3) / 4 * 4;
  float4* w4 = reinterpret_cast<float4*>(smem);             // [C][H]
  float4* gx = w4 + C * H;                                  // [KMAX*rows][GS]
  float* xs = reinterpret_cast<float*>(gx + KMAX * rows * GS);  // [KMAX*rows][C]
  float* hb = xs + KMAX * rows * C;                         // [2][r4][HS]
  float* cs = hb + 2 * r4 * HS;                             // [r4][HS]
  const int tid = threadIdx.x;
  const int row0 = tile * rows, rt = min(rows, R - row0);
  const int nb = (T + kf - 1) / kf;

  // the slab js's x rows (processing order) into the tile; rows past R: 0
  auto load_x = [&](int js) {
    const int blk = reverse ? nb - 1 - js : js;
    const int lo = blk * kf, nf = min(T, lo + kf) - lo, cv = C / 4;
    for (int i = tid; i < nf * rows * cv; i += NT) {
      const int q = i / (rows * cv), rem = i - q * rows * cv;
      const int r = rem / cv, v = rem - r * cv;
      const int t = reverse ? lo + nf - 1 - q : lo + q;
      float* d = xs + (q * rows + r) * C + 4 * v;
      const size_t xi = M >= INFER ? (size_t)(row0 + r) * T + t
                                   : (size_t)t * R + row0 + r;
      if (r < rt)
        cp_async16(d, x + xi * C + 4 * v);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    cp_async_commit();
  };
  load_x(0);

  for (int i = tid; i < C * H; i += NT) {
    const int k = i / H, u = i - k * H;
    const float* wrow = w_ih + (size_t)k * WI;
    w4[i] = make_float4(wrow[u], wrow[GC + u], wrow[2 * GC + u],
                        wrow[3 * GC + u]);
  }
  for (int i = tid; i < r4 * H; i += NT) {
    const int r = i / H, u = i - r * H;
    if constexpr (M == BSEQ || M >= INFER) {
      hb[r * HS + u] = cs[r * HS + u] = 0.f;
    } else {
      const bool ok = r < rt;
      hb[r * HS + u] = ok ? h0[(size_t)(row0 + r) * H + u] : 0.f;
      cs[r * HS + u] = ok ? c0[(size_t)(row0 + r) * H + u] : 0.f;
    }
  }
  // the chain's lane (uq, kq): unit cu, input chunks kq, kq + 4, ...
  const int lane = tid & 31, kq = lane & 3, cu = (tid >> 5) * 8 + (lane >> 2);
  float4 wr[D::NCH][D::KV];
#pragma unroll
  for (int i = 0; i < D::NCH; ++i)
#pragma unroll
    for (int e = 0; e < D::KV; ++e) {
      const float* wrow = w_hh + (size_t)(D::KV * (4 * i + kq) + e) * WS;
      wr[i][e] = make_float4(wrow[cu], wrow[GC + cu], wrow[2 * GC + cu],
                             wrow[3 * GC + cu]);
    }
  // the projection's thread (up, rs)
  const int up = tid % (H / 2), rs = tid / (H / 2);
  const float4 b0 = make_float4(b[up], b[GC + up], b[2 * GC + up],
                                b[3 * GC + up]);
  const int u1 = up + H / 2;
  const float4 b1 = make_float4(b[u1], b[GC + u1], b[2 * GC + u1],
                                b[3 * GC + u1]);

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
    } else {
      project<H>(w4, xs, gx, C, nf * rows, up, rs, b0, b1);
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
      const float4* gq = gx + q * rows * GS;
      const size_t base = M >= INFER ? (size_t)row0 * T + t
                                     : (size_t)t * R + row0;
      const size_t sbase = (size_t)n * R + row0;  // the walk's step (BSEQ)
      int g = 0;
      for (; rows - g > 12; g += 12)
        rows_step<H, M, 4, 4, 4>(g, hc, hn, gq, cs, wr, kq, cu, rows, rt,
                                 base, sbase, T, o);
#define SBT_ROWS(A, B, C_)                                                   \
  rows_step<H, M, A, B, C_>(g, hc, hn, gq, cs, wr, kq, cu, rows, rt, base,   \
                            sbase, T, o);                                    \
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
// the walk's shared memory; a CUDA error code, or cudaErrorInvalidValue for
// a shape the walk does not take.
template <typename... P, typename... A>
int launch(void (*const (&ks)[4])(P...), int H, int C, int T, int R,
           int rows, int nd, cudaStream_t st, A... args) {
  const size_t smem = smem_bytes(C, H, rows);
  if (!smem || T < 1 || R < 1) return (int)cudaErrorInvalidValue;
  void (*k)(P...) = ks[H == 8 ? 0 : H == 16 ? 1 : H == 32 ? 2 : 3];
  int err = (int)cudaFuncSetAttribute(
      (const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  k<<<nd * ((R + rows - 1) / rows), 4 * H, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace sbt_fwd32
