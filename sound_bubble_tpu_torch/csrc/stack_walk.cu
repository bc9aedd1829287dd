// One streaming step (T=1, batch 1) of the whole TF-GridNet block stack,
// without and with local causal attention, with the plain intra BLSTM (rows
// 1 and 3 of PERF.md's kernel table) or the conv_lstm intra (rows 2 and 4).
//
// Replaces the Pallas TPU kernels of `sound_bubble_tpu/ops/pallas/
// stack_kernel.py`: `stack_walk_kernel<H, false, false>` replaces `_kernel`
// (the `pallas_call` of `gridnet_stack_step` at :576), `<H, true, false>`
// `_kernel_attn` (`gridnet_stack_step_attn`, :671), `<H, false, true>`
// `_kernel_conv` / `_intra_conv` (`gridnet_stack_step` on a conv_lstm pack,
// :557) and `<H, true, true>` `_kernel_conv_attn` (:649), with their
// helpers `_intra_blstm`, `_inter_step` and `_attn_step`. Per block b:
// FiLM (b > 0) -> LayerNorm -> the fused-direction BLSTM over the F
// frequency rows -> projection residual -> LayerNorm -> one inter-LSTM
// step on all F rows -> projection residual [-> the attention step]. The
// conv_lstm intra (kConv, stride s) takes the strided down conv, PReLU and
// the LayerNorm to k = F / s conv frames, walks the BLSTM over those, and
// adds the up conv to the rows < k*s in place of the projection; the rows
// from k*s on keep x. The operands are those of `pack_stack_params` and
// `pack_attn_params` (sound_bubble_tpu_torch/ops/kernels/stack_kernel.py),
// read as they are: no re-pack and no cache of one.
//
// What bounds it on an H100: the intra recurrences, B walks of F (or k)
// dependent frames each (B*F = 870 at the flagship's B = 6, F = 145; B*k =
// 87 at the edge models' B = 3, k = 29), not bytes or FLOPs: the flagship
// step moves 3.05 MB and does 139 MFLOP of compact math (0.9 us at 3.35
// TB/s, 2.1 us at 67 TFLOP/s fp32); with attention the K/V rings (13.9 MB,
// read once) make it 5.2 us of bytes (chip_smoke.py's `stack_step_bound_ms`
// counts both from the run's shapes).
//
// Design (the single-block kernels it replaces walked a chain of B*(F+1),
// or B*(k+1), cell updates on one SM, ~7.9 us each, W_hh re-read from L2 at
// every one):
// - One launch a call: a cluster of kCTAs = 8 thread blocks of 4H threads
//   (`cudaLaunchKernelEx` with a cluster dimension; 8 is the portable
//   size). The hardware schedules a cluster's blocks together, so every
//   block a cluster barrier waits on is resident; the wrapper checks with
//   `cudaOccupancyMaxActiveClusters` that a cluster fits the card, and no
//   block waits on anything outside its cluster. Block c owns ceil(k / 8)
//   consecutive conv frames (the plain intra: s = 1, a frame a row) and so
//   the s rows of each (`tile_of`; the rows from k*s on go to the block
//   after the last frame's); their x stays in its shared memory for the
//   whole step.
// - The walk: blocks 0 and 1 run the two directions of each block's intra
//   BLSTM (block d direction d, the backward one reversed), each the fp32
//   walk of csrc/lstm_fwd32.cuh in its STACK mode at R = 1 over T = k
//   frames: row 5's walk (W_hh in registers with no zeros, each 8-frame
//   slab's input projection one product into shared memory, one barrier a
//   frame) reading the fused pack's columns. Its input z [k, D] (the intra
//   head: LayerNorm(FiLM(x)) or, kConv, LayerNorm(PReLU(down conv))) and
//   its output y [k, 2H] live in a global scratch (L2). While a block's
//   walk runs, blocks 2-7 form its inter LSTM's recurrent part h0 W_hh2 of
//   every row, which does not depend on x, into the scratch (all blocks'
//   at once, 58K cycles at the Orange Pi width, outlasted a 29-frame walk,
//   36K: tools/split_stack_cycles.py).
// - The row phases, between two walks, every block on its own rows:
//   x += y W_proj + b_proj (kConv: x[q*s + j] += y[q] up_flat[:, j*D:(j+1)*D]
//   + up_b, the frame's s rows one [s*D] row of the product); the inter
//   LayerNorm; the inter gates (z2 W_ih2 + b2) + h0 W_hh2 and cell (h0',
//   c0' out); x += h' W_proj2 + b_proj2; then the next block's FiLM and
//   intra head into z (kConv: the own frames' s rows one [s*D] row times
//   the down conv laid out [s*D, D]).
//   Everything they read of the step's operands (the block's weights,
//   biases and LayerNorm affines, the next block's head, its rows of c0,
//   FiLM and, with attention, of the attention LayerNorms) is copied into
//   shared memory by `cp.async` before the walk and lands while it runs
//   (`stage_rows`, `stage_head`, `stage_attn`); y and h0 W_hh2 come in one
//   `cp.async` pass after it. At the Orange Pi width (D = 24, H = 64, s =
//   5) a block's staged weights are 104 KB (up_flat alone 61 KB) and it
//   holds 183 KB of shared memory in all, 195 KB with attention, whose
//   rows take the inter gates' place: the SM's L1 is what its 256 KB leave
//   to shared memory, and the attention's ring reads (uncoalesced, each
//   sector read 8 times over a tile's rows) need it; at 202 KB (the 228 KB
//   configuration, 28 KB of L1) its partial scores took 2.1x row 3's time
//   a block. The products are register-tiled (`rows_matmul`: four rows
//   and one or two
//   columns a thread, A as float4 broadcasts). The residual additions and
//   FiLM round in the plain version's order (`residual`; a multiply and an
//   add, not an FMA): |x| reaches ~100 at the flagship width, so these
//   roundings, not the products' own errors, set x's error.
//   A `clock64()` split of a call (tools/split_stack_cycles.py; NVIDIA
//   H100 80GB HBM3, 700 W; PERF.md §6): at the flagship width each walk
//   ~90 us (178K cycles), 87 % of the call; the row phases and barriers
//   ~13 us a block; the attention ~25 us a block more, most of it the ring
//   reads (partial scores 5 us, weighted values 7 us). At the Orange Pi
//   width (rows 2 and 4) each walk of 29 frames ~20 us (36K cycles), about
//   half of a row-2 call; the row phases ~12 us a block.
//   Staging replaced reading the weights from L2 inside the products and
//   y and hr in a load loop, which left the row phases latency-bound.
// - Attention (kAttn), per block after the inter step; what reduces over
//   all F rows is a partial per block, then a combine:
//   1. q, k, v = PReLU(x W + b) of the own rows; per (tensor, head) slab the
//      own rows' mean and sum of squared deviations -> the scratch;
//   2. [cluster barrier] each block combines the eight partials (Chan's
//      pairwise formula: no cancellation) and normalises its rows (eps
//      1e-5: the model's attention LayerNorms take flax's default, not
//      cfg.eps); writes its k, v to slot `pos` of the rings (in place,
//      k_ring [B, L*E, W, F], v_ring [B, D, W, F], its rows only); its
//      partial scores over its rows for every (head, slot) -> the scratch;
//   3. [barrier] the scores summed over the blocks and scaled by
//      1/sqrt(F*E) (the model's dk is the flattened F*E row), the softmax
//      over the W slots with no mask (slots not written yet hold zeros and
//      are attended, as the model attends its zero K_buf), each block the
//      same; the probability-weighted values of its rows (head-minor
//      channel l*vd + j; a ring plane's F is contiguous, so its rows are one
//      segment a (channel, slot)); the output Linear and PReLU; the own
//      rows' partial moments of the frame's LayerNorm -> the scratch;
//   4. [barrier] the combine, the LayerNorm over the [F, D] frame, the
//      residual.
//   So eight SMs read the rings (13.9 MB at the flagship width, in L2), each
//   its own rows.
// - Sequencing: cluster barriers (`barrier.cluster.arrive.release` /
//   `barrier.cluster.wait.acquire`), one after the prologue and 2 a block (5
//   with attention). What one block writes and another reads goes through
//   global memory, read back with `ld.global.cg` (the walk reads z by
//   `cp.async.cg`). No host sync, no branch on device data and no
//   allocation: a call can be captured in a CUDA graph.
// H in 8, 16, 32, 64 (the walk's widths), D a multiple of 4.
// No TF32 and no fast-math: fp32 FMA, expf and tanhf (the walk: its refined
// `rcp.approx` activations; in the inter cell they moved the attention
// flagship's x error, chained over 105 steps, toward the 1e-4 bar).
#include <cuda_runtime.h>

#include <algorithm>

#include "lstm_fwd32.cuh"

namespace {

constexpr int kCTAs = 8;           // blocks of the cluster
constexpr float kAttnEps = 1e-5f;  // the attention LayerNorms' eps

// A step's operands (the kernel's one parameter). proj_w / proj_b hold
// up_flat [B, 2H, s*D] / up_b on a conv_lstm pack, whose down conv
// (down_cat [B, D, s*D], down_b, the PReLU slope dn_a [B, 1]) the plain
// pack does not have; s = 1 there. z, y, hr, pst and psc are the scratch
// (`scratch_floats`): z [k, D] the walk's input, y [k, 2H] its output (k =
// F / s), hr [B, F, 4H] = h0 W_hh2, pst [kCTAs][3L+1][2] the blocks'
// partial moments, psc [kCTAs][L][W] their partial scores.
struct Args {
  const float *x, *film_w, *film_b, *i_ln, *wih_f, *wih_b, *whh, *b8,
      *proj_w, *proj_b, *t_ln, *wih2, *whh2, *b2, *proj2_w, *proj2_b,
      *down_cat, *down_b, *dn_a, *h0, *c0;
  const float *q_w, *q_b, *q_a, *q_ln, *k_w, *k_b, *k_a, *k_ln, *v_w, *v_b,
      *v_a, *v_ln, *o_w, *o_b, *o_a, *o_ln;
  float *x_out, *h0_out, *c0_out, *k_ring, *v_ring;
  float *z, *y, *hr, *pst, *psc;
  int n_blocks, F, D, s, use_film, heads, e_dim, W, pos, walk_smem;
  float eps;
};

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}
__device__ __forceinline__ float prelu(float v, float a) {
  return fmaxf(v, 0.f) + a * fminf(v, 0.f);
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// x = (x + v) + b, the plain version's order: x is large (|x| ~ 100 at the
// flagship width after a few blocks) and v, b are not, so the rounding of
// these two additions, not v's own error, sets x's; added in the same order
// the two versions round alike.
__device__ __forceinline__ void residual(float& x, float v, float b) {
  x = (x + v) + b;
}

// What block c owns: nq conv frames from frame q0 and their n rows from
// row f0 = q0 * s, ceil(k / kCTAs) frames a block (k = F / s; s = 1: a
// frame a row); the rows from k*s on, which take only the inter step, go
// to the block after the last frame's (the last block if that one owns
// frames). `conv_walk_tiles` in stack_kernel.py is the same.
struct Tile {
  int q0, nq, f0, n;
};
__device__ __forceinline__ Tile tile_of(int F, int s, int c) {
  const int k = F / s, fc = (k + kCTAs - 1) / kCTAs;
  Tile t;
  t.q0 = min(k, c * fc);
  t.nq = min(k, t.q0 + fc) - t.q0;
  t.f0 = t.q0 * s;
  t.n = t.nq * s;
  if (c == min(kCTAs - 1, (k + fc - 1) / fc)) t.n += F - k * s;  // s = 1: 0
  return t;
}

// epi(r, j, sum_k A[r*lda + k] W[k*N + j]) for r < n, j < N: A in shared
// memory (16-byte aligned rows: lda and K multiples of 4), W (read-only) in
// shared or global memory. A thread forms C columns (C = 2: N even, W
// 8-byte aligned) at four rows: per four k, four float4 loads of A
// (broadcast: a warp shares its rows) and four loads of W feed 16 C FMAs.
// C = 2 where N is wide (4H), 1 where N is D or less, so that enough
// threads have work.
template <int C, typename Epi>
__device__ __forceinline__ void rows_matmul(const float* A, int lda, int n,
                                            const float* W, int K, int N,
                                            Epi epi) {
  const int groups = (n + 3) >> 2, cols = N / C;
  for (int idx = threadIdx.x; idx < groups * cols; idx += blockDim.x) {
    const int g = idx / cols, j = C * (idx - g * cols), r0 = 4 * g;
    const float* a[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) a[q] = A + min(r0 + q, n - 1) * lda;
    float s[4][C] = {};
#pragma unroll 2
    for (int k = 0; k < K; k += 4) {
      float w[4][C];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* wr = W + (size_t)(k + e) * N + j;
        if constexpr (C == 2) {
          const float2 t = *reinterpret_cast<const float2*>(wr);
          w[e][0] = t.x;
          w[e][1] = t.y;
        } else {
          w[e][0] = *wr;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(a[q] + k);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          s[q][c] += v.x * w[0][c];
          s[q][c] += v.y * w[1][c];
          s[q][c] += v.z * w[2][c];
          s[q][c] += v.w * w[3][c];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (r0 + q < n)
#pragma unroll
        for (int c = 0; c < C; ++c) epi(r0 + q, j + c, s[q][c]);
  }
}

// Wait for all but the newest committed `cp.async` group.
__device__ __forceinline__ void cp_async_wait_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// 4 bytes from global to shared memory by `cp.async` (no alignment beyond
// the float's own; the weights' 16-byte pieces use the walk's cp_async16).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// What the row phases of a block read, in shared memory: its weights, its
// vectors, the next block's intra head (kConv: its down conv laid out [s*D,
// D], row j*D + ci tap j of input ci) and the block's own rows of c0, FiLM
// and the attention LayerNorms' affines (scale rows, then bias rows).
struct Staged {
  // [2H|D|H|s*D|D|D, s*D|4H|D|D|D|2LE+D]
  float *wp, *wi2, *wp2, *wd, *wo, *wqkv;
  float *pb, *b2, *pb2, *tln, *iln;  // D, 4H, D, 2D, 2D
  float *db, *da, *c0, *fw, *fb;     // kConv: D, 1; rows
  float *qkvb, *ob, *alpha, *qln, *kln, *vln, *oln;  // 2LE+D, D, 4, rows
  float* end;

  // from p (16-byte aligned): the weights copied in 16-byte pieces (every
  // one a multiple of 4 floats: D is) first; then q_w | k_w | v_w
  // interleaved a row ([D, 2LE + D], 4-byte pieces) and the rest; rc rows a
  // block
  __device__ Staged(float* p, int D, int H, int s, int rc, bool conv,
                    bool attn, int LE, int E, int vd) {
    wp = p, wi2 = wp + 2 * H * s * D, wp2 = wi2 + 4 * H * D;
    p = wp2 + H * D;
    wd = wo = wqkv = db = da = nullptr;
    qkvb = ob = alpha = qln = kln = vln = oln = nullptr;
    if (conv) wd = p, p = wd + s * D * D;
    if (attn) {
      wo = p, wqkv = wo + D * D;
      p = wqkv + D * (2 * LE + D);
    }
    pb = p, b2 = pb + D, pb2 = b2 + 4 * H, tln = pb2 + D, iln = tln + 2 * D;
    p = iln + 2 * D;
    if (conv) db = p, da = db + D, p = da + 1;
    c0 = p, fw = c0 + rc * H, fb = fw + rc * D, p = fb + rc * D;
    if (attn) {
      qkvb = p, ob = qkvb + 2 * LE + D, alpha = ob + D;
      qln = alpha + 4, kln = qln + 2 * rc * E, vln = kln + 2 * rc * E;
      oln = vln + 2 * rc * vd, p = oln + 2 * rc * D;
    }
    end = wp + ((p - wp + 3) & ~3);  // 16-byte aligned, as the rows' A
  }
};

// What the row phases of block b read from the step's operands, into
// shared memory by `cp.async` (committed, not waited for): the intra head's
// part (`stage_head`, GridNet block b's walk input), the rest of the
// block's row phases and the next head (`stage_rows`) or the attention's
// (`stage_attn`). Issued before the walk, it lands while the walk runs;
// blocks 0 and 1, which walk, issue the attention's part after their walk,
// so that it lands during the inter step and not before their walk. n rows
// from f0 are the block's own.
template <bool kConv>
__device__ void stage_head(const Args& a, int b, const Staged& s) {
  const int D = a.D, tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < 2 * D; i += nt)
    cp_async4(s.iln + i, a.i_ln + (size_t)b * 2 * D + i);
  if constexpr (kConv) {
    const int sD = a.s * D;
    // staged row r = j*D + ci (tap j, input ci) is down_cat's row ci at
    // columns j*D...: four columns a piece (D is a multiple of 4)
    for (int i = 4 * tid; i < sD * D; i += 4 * nt) {
      const int r = i / D, co = i - r * D, j = r / D, ci = r - j * D;
      sbt_fwd32::cp_async16(
          s.wd + i, a.down_cat + ((size_t)b * D + ci) * sD + j * D + co);
    }
    for (int i = tid; i < D; i += nt)
      cp_async4(s.db + i, a.down_b + (size_t)b * D + i);
    if (tid == 0) cp_async4(s.da, a.dn_a + b);
  }
}

template <bool kConv>
__device__ void stage_rows(const Args& a, int b, int H, int n, int f0,
                           const Staged& s) {
  const int D = a.D, F = a.F, sD = kConv ? a.s * D : D, tid = threadIdx.x;
  const int nt = blockDim.x;
  auto big = [&](float* dst, const float* src, int len) {
    for (int i = 4 * tid; i < len; i += 4 * nt)
      sbt_fwd32::cp_async16(dst + i, src + i);
  };
  auto small = [&](float* dst, const float* src, int len) {
    for (int i = tid; i < len; i += nt) cp_async4(dst + i, src + i);
  };
  big(s.wp, a.proj_w + (size_t)b * 2 * H * sD, 2 * H * sD);
  big(s.wi2, a.wih2 + (size_t)b * D * 4 * H, 4 * H * D);
  big(s.wp2, a.proj2_w + (size_t)b * H * D, H * D);
  small(s.pb, a.proj_b + (size_t)b * D, D);
  small(s.b2, a.b2 + (size_t)b * 4 * H, 4 * H);
  small(s.pb2, a.proj2_b + (size_t)b * D, D);
  small(s.tln, a.t_ln + (size_t)b * 2 * D, 2 * D);
  small(s.c0, a.c0 + ((size_t)b * F + f0) * H, n * H);
  if (b + 1 < a.n_blocks) {
    stage_head<kConv>(a, b + 1, s);
    if (a.use_film) {
      small(s.fw, a.film_w + ((size_t)b * F + f0) * D, n * D);
      small(s.fb, a.film_b + ((size_t)b * F + f0) * D, n * D);
    }
  }
  sbt_fwd32::cp_async_commit();
}

__device__ void stage_attn(const Args& a, int b, int n, int f0,
                           const Staged& s) {
  const int D = a.D, F = a.F, E = a.e_dim, LE = a.heads * E;
  const int vd = D / a.heads, QS = 2 * LE + D;
  const int tid = threadIdx.x, nt = blockDim.x;
  auto small = [&](float* dst, const float* src, int len) {
    for (int i = tid; i < len; i += nt) cp_async4(dst + i, src + i);
  };
  for (int i = 4 * tid; i < D * D; i += 4 * nt)
    sbt_fwd32::cp_async16(s.wo + i, a.o_w + (size_t)b * D * D + i);
  for (int i = tid; i < D * QS; i += nt) {  // row k: q_w | k_w | v_w
    const int k = i / QS, c = i - k * QS;
    cp_async4(s.wqkv + i,
              c < LE       ? a.q_w + ((size_t)b * D + k) * LE + c
              : c < 2 * LE ? a.k_w + ((size_t)b * D + k) * LE + c - LE
                           : a.v_w + ((size_t)b * D + k) * D + c - 2 * LE);
  }
  small(s.qkvb, a.q_b + (size_t)b * LE, LE);
  small(s.qkvb + LE, a.k_b + (size_t)b * LE, LE);
  small(s.qkvb + 2 * LE, a.v_b + (size_t)b * D, D);
  small(s.ob, a.o_b + (size_t)b * D, D);
  if (tid < 4)  // the PReLU slopes of q, k, v and the output
    cp_async4(s.alpha + tid,
              (tid == 0 ? a.q_a : tid == 1 ? a.k_a : tid == 2 ? a.v_a
                                                              : a.o_a) + b);
  for (int sb = 0; sb < 2; ++sb) {  // scale rows, then bias rows
    const size_t row = ((size_t)b * 2 + sb) * F + f0;
    small(s.qln + sb * n * E, a.q_ln + row * E, n * E);
    small(s.kln + sb * n * E, a.k_ln + row * E, n * E);
    small(s.vln + sb * n * vd, a.v_ln + row * vd, n * vd);
    small(s.oln + sb * n * D, a.o_ln + row * D, n * D);
  }
  sbt_fwd32::cp_async_commit();
}

// dst[r*D + d] = LayerNorm(src[r*D + :])[d] * scale[d] + bias[d] for r < n,
// one warp a row (blockDim.x is a multiple of 32). dst may be src: a lane
// writes only what it read, after the row's statistics.
__device__ void ln_rows(const float* src, float* dst, int n, int D,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias, float eps) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < n; r += nw) {
    const float* row = src + r * D;
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += row[d];
    const float mu = warp_sum(s) / D;
    float v = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float t = row[d] - mu;
      v += t * t;
    }
    const float inv = 1.0f / sqrtf(warp_sum(v) / D + eps);
    for (int d = lane; d < D; d += 32)
      dst[r * D + d] = (row[d] - mu) * inv * scale[d] + bias[d];
  }
}

// (mean, sum of squared deviations) of the n*w values p[r*ld + j], r < n,
// j < w, by one warp; (0, 0) for none.
__device__ float2 warp_moments(const float* p, int n, int w, int ld) {
  const int lane = threadIdx.x & 31, m = n * w;
  float s = 0.f;
  for (int i = lane; i < m; i += 32) s += p[(i / w) * ld + i % w];
  const float mu = m ? warp_sum(s) / m : 0.f;
  float v = 0.f;
  for (int i = lane; i < m; i += 32) {
    const float t = p[(i / w) * ld + i % w] - mu;
    v += t * t;
  }
  return make_float2(mu, warp_sum(v));
}

// (mean, 1/sqrt(var + eps)) over all F rows of a slab w wide, from the
// blocks' partials part[c*stride + {0, 1}] (mean, sum of squared
// deviations) of their rows (`tile_of` at stride s): by one warp, a lane a
// block.
__device__ float2 combine_moments(const float* part, int stride, int F,
                                  int s, int w, float eps) {
  const int lane = threadIdx.x & 31;
  float n = 0.f, mu = 0.f, m2 = 0.f;
  if (lane < kCTAs) {
    n = (float)(tile_of(F, s, lane).n * w);
    mu = __ldcg(part + lane * stride);
    m2 = __ldcg(part + lane * stride + 1);
  }
  const float total = (float)(F * w);
  const float mean = warp_sum(n * mu) / total;
  const float dm = mu - mean;
  const float var = warp_sum(m2 + n * dm * dm) / total;
  return make_float2(mean, 1.0f / sqrtf(var + eps));
}

// hr[b, f] = h0[b, f] W_hh2[b] for block b and the rows of part p of
// kCTAs - 2: the inter LSTM's recurrent part (it does not depend on x).
// hrow: shared memory for the part's h0 rows.
template <int H>
__device__ void inter_recurrent(const Args& a, int b, int part, float* hrow) {
  constexpr int G2 = 4 * H;
  const int F = a.F, rh = (F + kCTAs - 3) / (kCTAs - 2);
  const int r0 = min(F, part * rh), n = min(F, r0 + rh) - r0;
  const float* h = a.h0 + ((size_t)b * F + r0) * H;
  for (int i = threadIdx.x; i < n * H; i += blockDim.x) hrow[i] = h[i];
  __syncthreads();
  float* out = a.hr + ((size_t)b * F + r0) * G2;
  rows_matmul<2>(hrow, H, n, a.whh2 + (size_t)b * H * G2, H, G2,
                 [&](int r, int j, float v) { out[r * G2 + j] = v; });
}

template <int H, bool kAttn, bool kConv>
__global__ void __launch_bounds__(4 * H, 1) stack_walk_kernel(const Args a) {
  constexpr int H2 = 2 * H, G2 = 4 * H, G = 8 * H;
  extern __shared__ __align__(16) unsigned char smem[];
  const int F = a.F, D = a.D, cta = blockIdx.x, tid = threadIdx.x;
  const int nt = blockDim.x;
  // s: the conv stride (1: the plain intra); K frames walked, fc a block,
  // rc rows a block at most
  const int s = kConv ? a.s : 1, sD = s * D, K = F / s;
  const int fc = (K + kCTAs - 1) / kCTAs, rc = fc * s + F - K * s;
  const Tile tl = tile_of(F, s, cta);
  const int q0 = tl.q0, nq = tl.nq, f0 = tl.f0, n = tl.n;
  const int L = a.heads, E = a.e_dim, LE = L * E, QS = 2 * LE + D;
  const int vd = kAttn ? D / L : 0;
  // the block's own region, after the walk's (blocks 0 and 1): what the
  // row phases read of the current block (`stage_*`), then its rows
  const Staged st(reinterpret_cast<float*>(smem + a.walk_smem), D, H, s, rc,
                  kConv, kAttn, LE, E, vd);
  float* xs = st.end;         // [rc, D] x
  float* ys = xs + rc * D;    // [fc, 2H] y of the own frames
  float* zs = ys + fc * H2;   // [rc, D] a LayerNorm's (the down conv's) output
  float* gs = zs + rc * D;    // [rc, 4H] the inter gates
  // attention, after the inter step in the gates' place: q | k | v [rc,
  // 2LE + D], the attention output [rc, D], the scores [L, W], the
  // combined moments [3L + 1][2]
  float* qkv = gs;
  float* os = qkv + (rc * QS + 3) / 4 * 4;  // 16-byte aligned
  float* sc = os + rc * D;
  float* red = sc + L * a.W;
  const int attn_rows = kAttn ? int(red - qkv) + 2 * (3 * L + 1) : 0;
  // [rc, H] the inter h'
  float* hs = gs + (max(rc * G2, attn_rows) + 3) / 4 * 4;
  const int pstride = 2 * (3 * L + 1);  // floats of a block's partials

  // the walk's input of the own frames from the own x rows (the intra
  // head, as staged by `stage_head`): each row's LayerNorm or, kConv, each
  // frame's s rows as one [s*D] row times the down conv, PReLU, LayerNorm
  auto walk_input = [&]() {
    if constexpr (kConv) {
      rows_matmul<1>(xs, sD, nq, st.wd, sD, D, [&](int r, int j, float v) {
        zs[r * D + j] = prelu(st.db[j] + v, st.da[0]);
      });
      __syncthreads();
      ln_rows(zs, a.z + q0 * D, nq, D, st.iln, st.iln + D, a.eps);
    } else {
      ln_rows(xs, a.z + f0 * D, n, D, st.iln, st.iln + D, a.eps);
    }
  };

  // the prologue: the own x rows and block 0's walk input (the plain
  // intra's LayerNorm reads i_ln from L2)
  if constexpr (kConv) {
    stage_head<kConv>(a, 0, st);
    sbt_fwd32::cp_async_commit();
  }
  for (int i = tid; i < n * D; i += nt) xs[i] = a.x[f0 * D + i];
  if constexpr (kConv) {
    sbt_fwd32::cp_async_wait_all();
    __syncthreads();
    walk_input();
  } else {
    __syncthreads();
    ln_rows(xs, a.z + f0 * D, n, D, a.i_ln, a.i_ln + D, a.eps);
  }
  cluster_sync();  // block 0's z is in

  for (int b = 0; b < a.n_blocks; ++b) {
    stage_rows<kConv>(a, b, H, n, f0, st);
    if (kAttn && cta >= 2) stage_attn(a, b, n, f0, st);
    if (cta < 2) {
      const int d = cta;
      sbt_fwd32::walk<H, sbt_fwd32::STACK, 1>(
          a.z, (d ? a.wih_b + H : a.wih_f) + (size_t)b * D * G,
          a.whh + (size_t)b * H2 * G + d * ((size_t)H * G + H),
          a.b8 + (size_t)b * G + d * H, nullptr, nullptr,
          {a.y + d * H, nullptr, nullptr}, nullptr, nullptr, nullptr, K, 1,
          D, min(K, sbt_fwd32::KMAX), d, 1, 0);
    } else {
      inter_recurrent<H>(a, b, cta - 2, gs);
    }
    sbt_fwd32::cp_async_wait_all();
    cluster_sync();  // y, block b's hr and the staged data are in

    // ---- the intra projection (kConv: up conv) residual and the inter
    // step, own rows
    {
      const float* hr = a.hr + ((size_t)b * F + f0) * G2;
      const float* yr = a.y + (size_t)q0 * H2;
      for (int i = 4 * tid; i < n * G2; i += 4 * nt) {  // y and h0 W_hh2
        if (i < nq * H2) sbt_fwd32::cp_async16(ys + i, yr + i);
        sbt_fwd32::cp_async16(gs + i, hr + i);
      }
      sbt_fwd32::cp_async_commit();
      if (kAttn && cta < 2) {  // lands during the inter step
        stage_attn(a, b, n, f0, st);
        cp_async_wait_but_newest();
      } else {
        sbt_fwd32::cp_async_wait_all();
      }
      __syncthreads();
      // frame r's column j: row r*s + j / D, column j % D
      rows_matmul<1>(ys, H2, nq, st.wp, H2, sD, [&](int r, int j, float v) {
        residual(xs[r * sD + j], v, st.pb[kConv ? j % D : j]);
      });
      __syncthreads();
      ln_rows(xs, zs, n, D, st.tln, st.tln + D, a.eps);
      __syncthreads();
      rows_matmul<2>(zs, D, n, st.wi2, D, G2, [&](int r, int j, float v) {
        float& g = gs[r * G2 + j];
        g = (v + st.b2[j]) + g;
      });
      __syncthreads();
      const size_t sb = ((size_t)b * F + f0) * H;
      for (int i = tid; i < n * H; i += nt) {
        const int r = i / H, k = i - r * H;
        const float* g = gs + r * G2;
        const float c = sigmoid(g[H + k]) * st.c0[i] +
                        sigmoid(g[k]) * tanhf(g[2 * H + k]);
        const float h = sigmoid(g[3 * H + k]) * tanhf(c);
        a.c0_out[sb + i] = c;
        a.h0_out[sb + i] = h;
        hs[i] = h;
      }
      __syncthreads();
      rows_matmul<1>(hs, H, n, st.wp2, H, D, [&](int r, int j, float v) {
        residual(xs[r * D + j], v, st.pb2[j]);
      });
      __syncthreads();
    }

    // ---- local causal attention over the W ring slots (see the header)
    if constexpr (kAttn) {
      const int W = a.W, warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
      sbt_fwd32::cp_async_wait_all();  // blocks 0 and 1: stage_attn
      __syncthreads();
      // 1. q, k, v of the own rows; each slab's partial moments
      rows_matmul<1>(xs, D, n, st.wqkv, D, QS, [&](int r, int j, float v) {
        const int t = j < LE ? 0 : j < 2 * LE ? 1 : 2;
        qkv[r * QS + j] = prelu(v + st.qkvb[j], st.alpha[t]);
      });
      __syncthreads();
      for (int sl = warp; sl < 3 * L; sl += nw) {  // slab (tensor, head)
        const int t = sl / L, h = sl - t * L, w = t < 2 ? E : vd;
        const float2 m = warp_moments(qkv + t * LE + h * w, n, w, QS);
        if (lane == 0) {
          a.pst[cta * pstride + 2 * sl] = m.x;
          a.pst[cta * pstride + 2 * sl + 1] = m.y;
        }
      }
      cluster_sync();

      // 2. normalise; the ring slot pos; the partial scores
      for (int sl = warp; sl < 3 * L; sl += nw) {
        const float2 m = combine_moments(a.pst + 2 * sl, pstride, F, s,
                                         sl < 2 * L ? E : vd, kAttnEps);
        if (lane == 0) {
          red[2 * sl] = m.x;
          red[2 * sl + 1] = m.y;
        }
      }
      __syncthreads();
      for (int i = tid; i < n * QS; i += nt) {
        const int r = i / QS, c = i - r * QS;
        const int t = c < LE ? 0 : c < 2 * LE ? 1 : 2;
        const int w = t < 2 ? E : vd, h = (c - t * LE) / w;
        const int j = c - t * LE - h * w;
        const float* g = (t == 0 ? st.qln : t == 1 ? st.kln : st.vln) +
                         r * w + j;
        const float* m = red + 2 * (t * L + h);
        qkv[i] = (qkv[i] - m[0]) * m[1] * g[0] + g[n * w];
      }
      __syncthreads();
      for (int i = tid; i < (LE + D) * n; i += nt) {
        const int c = i / n, r = i - c * n;
        float* dst = c < LE ? a.k_ring + (((size_t)b * LE + c) * W + a.pos) * F
                            : a.v_ring + (((size_t)b * D + c - LE) * W + a.pos)
                                  * F;
        dst[f0 + r] = qkv[r * QS + LE + c];
      }
      __syncthreads();  // the block's ring writes are visible to its reads
      // a thread takes kPs (head, slot) pairs at once (more loads in
      // flight); its rows of a (head, key channel, slot) are contiguous
      constexpr int kPs = 2;
      for (int p0 = tid; p0 < L * W; p0 += kPs * nt) {
        const float* kr[kPs];
        const float* q[kPs];
        float acc[kPs];
#pragma unroll
        for (int u = 0; u < kPs; ++u) {
          const int p = min(p0 + u * nt, L * W - 1), h = p / W;
          kr[u] = a.k_ring + (((size_t)b * LE + h * E) * W + p - h * W) * F +
                  f0;
          q[u] = qkv + h * E;
          acc[u] = 0.f;
        }
        for (int j = 0; j < E; ++j)
#pragma unroll 8
          for (int r = 0; r < n; ++r)
#pragma unroll
            for (int u = 0; u < kPs; ++u)
              acc[u] += q[u][r * QS + j] * kr[u][(size_t)j * W * F + r];
#pragma unroll
        for (int u = 0; u < kPs; ++u)
          if (p0 + u * nt < L * W)
            a.psc[(size_t)cta * L * W + p0 + u * nt] = acc[u];
      }
      cluster_sync();

      // 3. the scores, the softmax, the weighted values, the output Linear
      // and PReLU, the partial moments of the frame
      const float scale = 1.0f / sqrtf((float)(F * E));
      for (int p = tid; p < L * W; p += nt) {
        float acc = 0.f;
        for (int c = 0; c < kCTAs; ++c)
          acc += __ldcg(a.psc + (size_t)c * L * W + p);
        sc[p] = acc * scale;
      }
      __syncthreads();
      for (int h = warp; h < L; h += nw) {  // a warp a head
        float* sr = sc + h * W;
        float m = sr[0];
        for (int w = lane; w < W; w += 32) m = fmaxf(m, sr[w]);
        m = warp_max(m);
        float z = 0.f;
        for (int w = lane; w < W; w += 32) {
          const float e = expf(sr[w] - m);
          sr[w] = e;
          z += e;
        }
        const float inv = 1.0f / warp_sum(z);
        for (int w = lane; w < W; w += 32) sr[w] *= inv;
      }
      __syncthreads();
      // a thread takes kIt (channel, row) items at once, so that kIt times
      // the unrolled slots' loads are in flight (the rings are in L2)
      constexpr int kIt = 3;
      for (int i0 = tid; i0 < D * n; i0 += kIt * nt) {
        const float* vr[kIt];
        const float* pr[kIt];
        float acc[kIt];
#pragma unroll
        for (int u = 0; u < kIt; ++u) {
          const int i = min(i0 + u * nt, D * n - 1), c = i / n;
          vr[u] = a.v_ring + ((size_t)b * D + c) * W * F + f0 + i - c * n;
          pr[u] = sc + (c / vd) * W;
          acc[u] = 0.f;
        }
#pragma unroll 16
        for (int w = 0; w < W; ++w)
#pragma unroll
          for (int u = 0; u < kIt; ++u)
            acc[u] += pr[u][w] * vr[u][(size_t)w * F];
#pragma unroll
        for (int u = 0; u < kIt; ++u) {
          const int i = i0 + u * nt, c = i / n;
          if (i < D * n) os[(i - c * n) * D + c] = acc[u];
        }
      }
      __syncthreads();
      rows_matmul<1>(os, D, n, st.wo, D, D, [&](int r, int j, float v) {
        zs[r * D + j] = prelu(v + st.ob[j], st.alpha[3]);
      });
      __syncthreads();
      if (warp == 0) {
        const float2 m = warp_moments(zs, n, D, D);
        if (lane == 0) {
          a.pst[cta * pstride + 6 * L] = m.x;
          a.pst[cta * pstride + 6 * L + 1] = m.y;
        }
      }
      cluster_sync();

      // 4. the LayerNorm over the [F, D] frame, the residual
      if (warp == 0) {
        const float2 m = combine_moments(a.pst + 6 * L, pstride, F, s, D,
                                         kAttnEps);
        if (lane == 0) {
          red[6 * L] = m.x;
          red[6 * L + 1] = m.y;
        }
      }
      __syncthreads();
      const float mu = red[6 * L], inv = red[6 * L + 1];
      for (int i = tid; i < n * D; i += nt)
        xs[i] += (zs[i] - mu) * inv * st.oln[i] + st.oln[n * D + i];
      __syncthreads();
    }

    // ---- the next block's FiLM and intra head: the walk's input
    if (b + 1 < a.n_blocks) {
      if (a.use_film) {
        for (int i = tid; i < n * D; i += nt)
          xs[i] = __fadd_rn(__fmul_rn(xs[i], st.fw[i]), st.fb[i]);
        __syncthreads();
      }
      walk_input();
      cluster_sync();  // z is in; the staged data is free again
    }
  }
  for (int i = tid; i < n * D; i += nt) a.x_out[f0 * D + i] = xs[i];
}

// Dynamic shared memory of a block (bytes; the walk's, then the block's own
// region: what `stage_*` copies in, then its rows' x, LayerNorm outputs,
// gates and h', its frames' y and the attention's), 0 for a shape the
// kernel does not take; heads = 0: no attention; lstm_down = 0: the plain
// intra, else the conv stride s.
size_t smem_bytes(int f_len, int d, int hidden, int lstm_down, int heads,
                  int e_dim, int window) {
  const size_t walk = sbt_fwd32::smem_bytes(d, hidden, 1);
  const int s = lstm_down > 0 ? lstm_down : 1, k = f_len / s;
  if (!walk || f_len < 1 || k < 1 || lstm_down < 0 || heads < 0) return 0;
  const size_t fc = (k + kCTAs - 1) / kCTAs;
  const size_t rc = fc * s + f_len - (size_t)k * s;
  const size_t le = (size_t)heads * e_dim;
  // staged (`Staged`), then the rows; each part 16-byte aligned
  size_t staged = (size_t)(2 * s + 5) * hidden * d + 6 * d + 4 * hidden +
                  rc * (hidden + 2 * d);
  if (lstm_down > 0) staged += (size_t)s * d * d + d + 1;
  // the rows: x, z, h'; the frames' y; the gates or, in their place, the
  // attention's rows
  size_t gates = rc * 4 * hidden;
  if (heads > 0) {
    staged += 2 * d * (le + d) + 2 * le + 2 * d + 4 +
              2 * rc * (2 * e_dim + d / heads + d);
    gates = std::max(gates, (rc * (2 * le + d) + 3) / 4 * 4 + rc * d +
                                (size_t)heads * window +
                                2 * (3 * heads + 1));
  }
  const size_t rows =
      rc * (2 * d + hidden) + fc * 2 * hidden + (gates + 3) / 4 * 4;
  return walk + 4 * ((staged + 3) / 4 * 4 + rows);
}

// Floats of the scratch (see Args).
size_t scratch_floats(int n_blocks, int f_len, int d, int hidden,
                      int lstm_down, int heads, int window) {
  const size_t k = f_len / (lstm_down > 0 ? lstm_down : 1);
  return k * (d + 2 * hidden) + (size_t)f_len * 4 * hidden * n_blocks +
         (heads > 0 ? (size_t)kCTAs * (2 * (3 * heads + 1) + heads * window)
                    : 0);
}

using Kernel = void (*)(const Args);
// the kernel for H (8, 16, 32, 64) with or without attention and the conv
// intra; null for another H
Kernel kernel_for(int hidden, bool attn, bool conv) {
#define SBT_KS(A, C)                                                    \
  {stack_walk_kernel<8, A, C>, stack_walk_kernel<16, A, C>,             \
   stack_walk_kernel<32, A, C>, stack_walk_kernel<64, A, C>}
  static const Kernel ks[2][2][4] = {{SBT_KS(false, false),
                                      SBT_KS(true, false)},
                                     {SBT_KS(false, true),
                                      SBT_KS(true, true)}};
#undef SBT_KS
  const int i = hidden == 8 ? 0 : hidden == 16 ? 1 : hidden == 32 ? 2
              : hidden == 64 ? 3 : -1;
  return i < 0 ? nullptr : ks[conv][attn][i];
}

// The launch configuration of one cluster of kCTAs blocks of 4H threads.
struct ClusterConfig {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  ClusterConfig(int hidden, size_t smem, cudaStream_t st) : cfg() {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCTAs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(kCTAs, 1, 1);
    cfg.blockDim = dim3(4 * hidden, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// a.s is the call's lstm_down (0: the plain intra)
int launch(Args a, int hidden, int scratch_given, float* scratch,
           void* stream) {
  cudaGetLastError();  // clear an error left by an earlier call
  const bool attn = a.heads > 0, conv = a.s > 0;
  const Kernel k = kernel_for(hidden, attn, conv);
  const size_t smem =
      smem_bytes(a.F, a.D, hidden, a.s, a.heads, a.e_dim, attn ? a.W : 0);
  const size_t need =
      scratch_floats(a.n_blocks, a.F, a.D, hidden, a.s, a.heads, a.W);
  if (!k || !smem || a.n_blocks < 1 || (size_t)scratch_given < need ||
      (conv && (!a.down_cat || !a.down_b || !a.dn_a)) ||
      (attn && (a.D % a.heads || a.e_dim < 1 || a.W < 1 || a.pos < 0 ||
                a.pos >= a.W)))
    return (int)cudaErrorInvalidValue;
  if (!conv) a.s = 1;
  const int n_frames = a.F / a.s;
  a.walk_smem = (int)sbt_fwd32::smem_bytes(a.D, hidden, 1);
  a.z = scratch;
  a.y = a.z + (size_t)n_frames * a.D;
  a.hr = a.y + (size_t)n_frames * 2 * hidden;
  a.pst = a.hr + (size_t)a.n_blocks * a.F * 4 * hidden;
  a.psc = a.pst + (attn ? kCTAs * 2 * (3 * a.heads + 1) : 0);
  int err = (int)cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  ClusterConfig c(hidden, smem, (cudaStream_t)stream);
  err = (int)cudaLaunchKernelEx(&c.cfg, k, a);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. Every pointer is a device pointer to
// contiguous fp32 memory; the wrapper has checked shapes, types and devices.
// Each launches one cluster on `stream` and returns the CUDA error (0 on
// success; cudaErrorInvalidValue for a shape the kernel does not take).
// scratch: `scratch` floats, at least what `sbt_stack_walk_scratch` gives.
// lstm_down: 0 for a plain pack (down_cat, down_b, alpha null), else the
// conv stride s of a conv_lstm pack, whose up_flat and up_b come as proj_w
// and proj_b.

extern "C" size_t sbt_stack_walk_smem(int f_len, int d, int hidden,
                                      int lstm_down, int heads, int e_dim,
                                      int window) {
  return kernel_for(hidden, heads > 0, lstm_down > 0)
             ? smem_bytes(f_len, d, hidden, lstm_down, heads, e_dim, window)
             : 0;
}

extern "C" size_t sbt_stack_walk_scratch(int n_blocks, int f_len, int d,
                                         int hidden, int lstm_down,
                                         int heads, int window) {
  return scratch_floats(n_blocks, f_len, d, hidden, lstm_down, heads,
                        window);
}

// How many clusters of the kernel (H, with or without attention and the
// conv intra, smem bytes of dynamic shared memory a block) the card can
// hold at once (>= 1: all eight blocks of a launch are resident together);
// a negative CUDA error, or 0 where none fits.
extern "C" int sbt_stack_walk_clusters(int hidden, int attn, int conv,
                                       int smem) {
  cudaGetLastError();
  const Kernel k = kernel_for(hidden, attn != 0, conv != 0);
  if (!k) return -(int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return -err;
  ClusterConfig c(hidden, (size_t)smem, nullptr);
  int n = 0;
  err = (int)cudaOccupancyMaxActiveClusters(&n, (const void*)k, &c.cfg);
  return err ? -err : n;
}

#define SBT_STACK_PARAMS                                                     \
  const float *x, const float *film_w, const float *film_b,                 \
      const float *i_ln, const float *wih_f, const float *wih_b,            \
      const float *whh, const float *b8, const float *proj_w,               \
      const float *proj_b, const float *t_ln, const float *wih2,            \
      const float *whh2, const float *b2, const float *proj2_w,             \
      const float *proj2_b, const float *down_cat, const float *down_b,     \
      const float *alpha
#define SBT_STACK_ARGS                                                       \
  a.x = x, a.film_w = film_w, a.film_b = film_b, a.i_ln = i_ln;             \
  a.wih_f = wih_f, a.wih_b = wih_b, a.whh = whh, a.b8 = b8;                 \
  a.proj_w = proj_w, a.proj_b = proj_b, a.t_ln = t_ln, a.wih2 = wih2;       \
  a.whh2 = whh2, a.b2 = b2, a.proj2_w = proj2_w, a.proj2_b = proj2_b;       \
  a.down_cat = down_cat, a.down_b = down_b, a.dn_a = alpha

extern "C" int sbt_stack_walk(SBT_STACK_PARAMS, const float* h0,
                              const float* c0, float* x_out, float* h0_out,
                              float* c0_out, float* scratch, int n_blocks,
                              int f_len, int d, int hidden, int lstm_down,
                              int use_film, int scratch_given, float eps,
                              void* stream) {
  Args a = {};
  SBT_STACK_ARGS;
  a.h0 = h0, a.c0 = c0, a.x_out = x_out, a.h0_out = h0_out;
  a.c0_out = c0_out;
  a.n_blocks = n_blocks, a.F = f_len, a.D = d, a.s = lstm_down;
  a.use_film = use_film, a.eps = eps;
  return launch(a, hidden, scratch_given, scratch, stream);
}

// The attention step's operands (those of `pack_attn_params`, then the
// rings, updated in place at slot `pos`) after the stack's; heads L, e_dim
// E, window W and pos after the dims.
extern "C" int sbt_stack_walk_attn(
    SBT_STACK_PARAMS, const float* q_w, const float* q_b, const float* q_a,
    const float* q_ln, const float* k_w, const float* k_b, const float* k_a,
    const float* k_ln, const float* v_w, const float* v_b, const float* v_a,
    const float* v_ln, const float* o_w, const float* o_b, const float* o_a,
    const float* o_ln, float* k_ring, float* v_ring, const float* h0,
    const float* c0, float* x_out, float* h0_out, float* c0_out,
    float* scratch, int n_blocks, int f_len, int d, int hidden,
    int lstm_down, int heads, int e_dim, int window, int pos, int use_film,
    int scratch_given, float eps, void* stream) {
  if (heads < 1) return (int)cudaErrorInvalidValue;
  Args a = {};
  SBT_STACK_ARGS;
  a.q_w = q_w, a.q_b = q_b, a.q_a = q_a, a.q_ln = q_ln;
  a.k_w = k_w, a.k_b = k_b, a.k_a = k_a, a.k_ln = k_ln;
  a.v_w = v_w, a.v_b = v_b, a.v_a = v_a, a.v_ln = v_ln;
  a.o_w = o_w, a.o_b = o_b, a.o_a = o_a, a.o_ln = o_ln;
  a.k_ring = k_ring, a.v_ring = v_ring;
  a.h0 = h0, a.c0 = c0, a.x_out = x_out, a.h0_out = h0_out;
  a.c0_out = c0_out;
  a.n_blocks = n_blocks, a.F = f_len, a.D = d, a.s = lstm_down;
  a.heads = heads, a.e_dim = e_dim, a.W = window, a.pos = pos;
  a.use_film = use_film, a.eps = eps;
  return launch(a, hidden, scratch_given, scratch, stream);
}
