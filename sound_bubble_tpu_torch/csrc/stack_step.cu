// One streaming step (T=1, batch 1) of the whole TF-GridNet block stack with
// the conv_lstm intra part, without and with local causal attention: rows 2
// and 4 of PERF.md's kernel table.
//
// Replaces the Pallas TPU kernels of `sound_bubble_tpu/ops/pallas/
// stack_kernel.py` (called from `gridnet_stack_step` and
// `gridnet_stack_step_attn` on a conv_lstm pack):
// `stack_step_conv_kernel<false>` replaces `_kernel_conv` / `_intra_conv`
// and `<true>` replaces `_kernel_conv_attn` (the same with local causal
// attention, `_attn_step`). Per block b: FiLM (b > 0) -> the strided down
// conv -> PReLU -> LayerNorm -> fused-direction BLSTM over the k = F // s
// conv frames -> up conv residual on rows < k*s -> LayerNorm -> one
// inter-LSTM step on all F lanes -> projection residual [-> the attention
// step, kAttn]. Operand layouts are those of `pack_stack_params`
// (sound_bubble_tpu_torch/ops/kernels/stack_kernel.py): gate g of the fused
// BLSTM occupies columns [g*2H, g*2H+H) for the forward direction and
// [g*2H+H, (g+1)*2H) for the backward one. The plain intra BLSTM (rows 1
// and 3) is csrc/stack_walk.cu.
//
// What bounds them on an H100: a dependency chain of B*(k+1) sequential
// LSTM cell updates (90 at B=3, k=29), each a [2H] x [2H, 8H] product
// followed by the gate math, not bytes or FLOPs. Counting the compact math
// (not the zeros the fused packing adds), the edge conv step (F=145, D=24,
// B=3, H=64, s=5, no FiLM) moves 1,532,844 B (weights 1.06 MB, h0/c0 in and
// out 0.45 MB), about 0.46 us at 3.35 TB/s, and does 31,949,184 FLOP, about
// 0.48 us at 67 TFLOP/s fp32. chip_smoke.py computes both from the shapes of
// the run.
//
// Design: ONE thread block does the whole step and loops over the B blocks,
// the same dependency chain as the TPU kernel, so no inter-block
// synchronisation of any kind exists (no grid sync, no clusters, no spin
// flags) and the kernel cannot wait on a block that is not resident. One
// thread per fused gate column (8H threads). Each intra step computes
// gates = gx[f] + h . W_hh into shared memory, then the 2H state threads
// update (h, c). The activation tile x [F, D], the LayerNorm output and the
// recurrent state live in shared memory; the input projections gx [k, 8H],
// the BLSTM output y [k, 2H] and the inter gates [F, 4H] live in a global
// scratch the wrapper allocates (it stays in L2); the weights are read from
// global memory (they sit in the 50 MB L2). This trades speed for
// certainty: W_hh is re-read from L2 at every step. csrc/stack_walk.cu's
// design (the walk of csrc/lstm_fwd32.cuh on two blocks of a cluster, the
// row phases spread over eight) is the next step for these rows too.
//
// The two kernels are the instantiations of ONE kernel template,
// `stack_step_conv_kernel<kAttn>`: the attention step's operands are
// appended to the parameter list, so the <false> instantiation compiles to
// the code it had before the attention step was added.
//
// The attention step (kAttn; the Pallas `_attn_step`), per block after the
// inter step, with L heads of key width E and value width vd = D / L:
//   1. q, k, v = PReLU(x W + b): [F, L*E], [F, L*E], [F, D] in a global
//      scratch the wrapper allocates (see below);
//   2. per head, a LayerNorm over its whole [F, e] slab (one warp a slab,
//      eps 1e-5: the model's attention LayerNorms take flax's default, not
//      cfg.eps);
//   3. this frame's k and v to slot `pos` of the K/V rings, which live in
//      global memory as per-(head, channel) planes k_ring [B, L*E, W, F] and
//      v_ring [B, D, W, F] (a window softmax does not depend on the slots'
//      order, so the ring is written in place and never shifted);
//   4. __syncthreads(), which makes the block's global writes visible to its
//      own reads (the rings are read through plain, not read-only, loads);
//   5. scores over the W slots, one warp per (head, slot), scaled by
//      1/sqrt(F*E) (the model's dk is the flattened F*E row);
//   6. a softmax over the W slots with no mask (slots not written yet hold
//      zeros and are attended, as the model attends its zero K_buf);
//   7. the probability-weighted sum of the value planes, head-minor [F, D]
//      (channel l*vd + j), one thread per (channel, frequency) so that a
//      warp reads consecutive frequencies of one slot;
//   8. the output Linear -> PReLU -> a LayerNorm over the whole [F, D] frame
//      (a block-wide reduction, eps 1e-5) -> residual.
// q, k, v and the attention output [F, D] live in that global scratch (it
// stays in L1/L2), and only the scores [L, W] and the reduction scratch are
// added to the block's shared memory: on an H100 the L1 and the shared
// memory share 256 KB an SM, and W_hh, re-read at every recurrence step, is
// served partly from L1 (a first version of the attention kernels that kept
// q, k, v and the output in shared memory doubled the plain branch's time,
// PERF.md §6). The rings are 5.57 MB at the Orange Pi width: too large for
// shared memory (227 KB a block), they stay in global memory and sit in the
// 50 MB L2. The bound that chip_smoke.py computes adds the ring bytes (read
// once, the new slot written once) and the attention FLOP to the stack
// step's.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// dst[f, :] = LayerNorm(src[f, :]) * scale + bias, one warp per row.
// blockDim.x is a multiple of 32, so every warp is full. dst may be src: each
// lane writes only the elements it read, after the row's statistics.
__device__ void layer_norm_rows(const float* src, float* dst,
                                const float* __restrict__ scale,
                                const float* __restrict__ bias, int F, int D,
                                float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int f = warp; f < F; f += n_warps) {
    const float* row = src + f * D;
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += row[d];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mu = s / D;
    float v = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float t = row[d] - mu;
      v += t * t;
    }
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const float inv = 1.0f / sqrtf(v / D + eps);
    for (int d = lane; d < D; d += 32)
      dst[f * D + d] = (row[d] - mu) * inv * scale[d] + bias[d];
  }
}

// The conv_lstm intra over the n = k = F / s conv frames (`_kernel_conv` /
// `_intra_conv`):
//   zs[f, co] = PReLU(down_b[co] + sum_j sum_ci x[f*s+j, ci] *
//                     down_cat[ci, j*C+co]) for f < k,
// then LayerNorm in place, the recurrence over k steps, and
//   x[f*s+j, c] += y[f] . up[:, j*C+c] + up_b[c] for f*s+j < k*s,
// with proj_w / proj_b holding up_flat [B, 2H, s*C] / up_b [B, C]; rows from
// k*s on keep x (the reference zero-pads the up conv's output). The Pallas
// kernel forms all s phases of every row (taps = x @ down_cat [F, s*C]) and
// sums phase j of row f*s+j; here each row computes only the phase it
// contributes: the same sum, without the (s-1)/s of taps that is never read
// and without a taps buffer. Each thread updates the xs elements it reads,
// from y and the weights only, so no element of xs is read by one thread
// while another writes it.
template <bool kAttn>
__global__ void __launch_bounds__(1024) stack_step_conv_kernel(
    const float* __restrict__ x, const float* __restrict__ film_w,
    const float* __restrict__ film_b, const float* __restrict__ down_cat,
    const float* __restrict__ down_b, const float* __restrict__ alpha,
    const float* __restrict__ i_ln, const float* __restrict__ wih_f,
    const float* __restrict__ wih_b, const float* __restrict__ whh,
    const float* __restrict__ b8, const float* __restrict__ proj_w,
    const float* __restrict__ proj_b, const float* __restrict__ t_ln,
    const float* __restrict__ wih2, const float* __restrict__ whh2,
    const float* __restrict__ b2, const float* __restrict__ proj2_w,
    const float* __restrict__ proj2_b, const float* __restrict__ h0,
    const float* __restrict__ c0, float* x_out, float* h0_out,
    float* c0_out, float* gx, float* y, float* g2, int n_blocks, int F,
    int D, int H, int s, int use_film, float eps,
    const float* __restrict__ q_w, const float* __restrict__ q_b,
    const float* __restrict__ q_a, const float* __restrict__ q_ln,
    const float* __restrict__ k_w, const float* __restrict__ k_b,
    const float* __restrict__ k_a, const float* __restrict__ k_ln,
    const float* __restrict__ v_w, const float* __restrict__ v_b,
    const float* __restrict__ v_a, const float* __restrict__ v_ln,
    const float* __restrict__ o_w, const float* __restrict__ o_b,
    const float* __restrict__ o_a, const float* __restrict__ o_ln,
    float* k_ring, float* v_ring, float* a_scr, int heads, int e_dim, int W,
    int pos) {
  extern __shared__ float smem[];
  const int G = 8 * H, H2 = 2 * H, G2 = 4 * H, FD = F * D;
  const int n = F / s;     // rows of the intra recurrence
  float* xs = smem;        // [F, D] activation tile
  float* zs = xs + FD;     // [F, D] LayerNorm output ([k, D] conv frames)
  float* gs = zs + FD;     // [8H] gates of the current intra step
  float* hs = gs + G;      // [2H] fused (fwd | bwd) hidden state
  float* cs = hs + H2;     // [2H] fused cell state
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int i = tid; i < FD; i += nt) xs[i] = x[i];
  __syncthreads();

  for (int b = 0; b < n_blocks; ++b) {
    if (use_film && b > 0) {
      const float* fw = film_w + (size_t)(b - 1) * FD;
      const float* fb = film_b + (size_t)(b - 1) * FD;
      for (int i = tid; i < FD; i += nt) xs[i] = xs[i] * fw[i] + fb[i];
      __syncthreads();
    }

    // ---- intra head: the n rows the recurrence reads, LayerNorm-ed, in zs.
    {
      const int sD = s * D;
      const float* w = down_cat + (size_t)b * D * sD;
      const float* bd = down_b + (size_t)b * D;
      const float a = alpha[b];
      for (int idx = tid; idx < n * D; idx += nt) {
        const int f = idx / D, co = idx - f * D;
        float z = bd[co];
        for (int j = 0; j < s; ++j) {
          const float* xr = xs + (f * s + j) * D;
          float t = 0.f;
          for (int ci = 0; ci < D; ++ci) t += xr[ci] * w[ci * sD + j * D + co];
          z += t;
        }
        zs[idx] = fmaxf(z, 0.f) + a * fminf(z, 0.f);
      }
      __syncthreads();
      layer_norm_rows(zs, zs, i_ln + (size_t)b * 2 * D,
                      i_ln + (size_t)b * 2 * D + D, n, D, eps);
    }
    __syncthreads();

    // ---- both directions' input projections. The backward direction reads
    // row n-1-f, so step f needs only gx[f].
    {
      const float* wf = wih_f + (size_t)b * D * G;
      const float* wb = wih_b + (size_t)b * D * G;
      const float* bb = b8 + (size_t)b * G;
      for (int idx = tid; idx < n * G; idx += nt) {
        const int f = idx / G, j = idx - f * G;
        const float* zf = zs + f * D;
        const float* zr = zs + (n - 1 - f) * D;
        float af = 0.f, ab = 0.f;
        for (int d = 0; d < D; ++d) {
          af += zf[d] * wf[d * G + j];
          ab += zr[d] * wb[d * G + j];
        }
        gx[idx] = (af + bb[j]) + ab;
      }
    }
    if (tid < H2) {
      hs[tid] = 0.f;
      cs[tid] = 0.f;
    }
    __syncthreads();

    // ---- intra recurrence over the n rows: the sequential chain.
    {
      const float* wh = whh + (size_t)b * H2 * G;
      for (int f = 0; f < n; ++f) {
        for (int j = tid; j < G; j += nt) {
          float a = gx[f * G + j];
#pragma unroll 8
          for (int k = 0; k < H2; ++k) a += hs[k] * wh[k * G + j];
          gs[j] = a;
        }
        __syncthreads();
        if (tid < H2) {
          const float ig = sigmoid(gs[tid]);
          const float fg = sigmoid(gs[H2 + tid]);
          const float gg = tanhf(gs[2 * H2 + tid]);
          const float og = sigmoid(gs[3 * H2 + tid]);
          const float c = fg * cs[tid] + ig * gg;
          const float h = og * tanhf(c);
          cs[tid] = c;
          hs[tid] = h;
          // forward h at row f, backward h at the mirrored row
          y[(tid < H ? f : n - 1 - f) * H2 + tid] = h;
        }
        __syncthreads();
      }
    }

    // ---- intra tail, a residual: the up conv on rows < k*s.
    {
      const int sD = s * D;
      const float* w = proj_w + (size_t)b * H2 * sD;
      const float* bu = proj_b + (size_t)b * D;
      for (int idx = tid; idx < n * s * D; idx += nt) {
        const int r = idx / D, c = idx - r * D;
        const int f = r / s, j = r - f * s;
        const float* yr = y + f * H2;
        float a = 0.f;
        for (int m = 0; m < H2; ++m) a += yr[m] * w[m * sD + j * D + c];
        xs[idx] = xs[idx] + a + bu[c];
      }
    }
    __syncthreads();

    // ---- inter: one LSTM step on all F lanes, from the carried (h0, c0).
    layer_norm_rows(xs, zs, t_ln + (size_t)b * 2 * D,
                    t_ln + (size_t)b * 2 * D + D, F, D, eps);
    __syncthreads();
    const float* hb = h0 + (size_t)b * F * H;
    const float* cb = c0 + (size_t)b * F * H;
    float* ho = h0_out + (size_t)b * F * H;
    float* co = c0_out + (size_t)b * F * H;
    {
      const float* w2 = wih2 + (size_t)b * D * G2;
      const float* u2 = whh2 + (size_t)b * H * G2;
      const float* bb2 = b2 + (size_t)b * G2;
      for (int idx = tid; idx < F * G2; idx += nt) {
        const int f = idx / G2, j = idx - f * G2;
        float a = 0.f, r = 0.f;
        for (int d = 0; d < D; ++d) a += zs[f * D + d] * w2[d * G2 + j];
        for (int k = 0; k < H; ++k) r += hb[f * H + k] * u2[k * G2 + j];
        g2[idx] = (a + bb2[j]) + r;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < F * H; idx += nt) {
      const int f = idx / H, k = idx - f * H;
      const float* g = g2 + f * G2;
      const float i2 = sigmoid(g[k]);
      const float f2 = sigmoid(g[H + k]);
      const float gg2 = tanhf(g[2 * H + k]);
      const float o2 = sigmoid(g[3 * H + k]);
      const float c = f2 * cb[idx] + i2 * gg2;
      co[idx] = c;
      ho[idx] = o2 * tanhf(c);
    }
    __syncthreads();

    // ---- inter projection residual: x += h' @ proj2_w + proj2_b.
    {
      const float* pw = proj2_w + (size_t)b * H * D;
      const float* pb = proj2_b + (size_t)b * D;
      for (int idx = tid; idx < FD; idx += nt) {
        const int f = idx / D, d = idx - f * D;
        float a = 0.f;
        for (int k = 0; k < H; ++k) a += ho[f * H + k] * pw[k * D + d];
        xs[idx] = xs[idx] + a + pb[d];
      }
    }
    __syncthreads();

    // ---- local causal attention over the W ring slots (see the header).
    if constexpr (kAttn) {
      const int LE = heads * e_dim, vd = D / heads;
      const int warp = tid >> 5, lane = tid & 31, n_warps = nt >> 5;
      float* qa = a_scr;              // [F, L*E] (global scratch)
      float* ka = qa + F * LE;        // [F, L*E]
      float* va = ka + F * LE;        // [F, D]
      float* oa = va + FD;            // [F, D] attention output, head-minor
      float* sc = cs + H2;            // [L, W] scores, then probabilities
      float* red = sc + heads * W;    // [64] reduction scratch

      // 1. q, k, v = PReLU(x W + b)
      {
        const int row = 2 * LE + D;
        for (int idx = tid; idx < F * row; idx += nt) {
          const int f = idx / row, c = idx - f * row;
          const float *w, *bias;
          float al, *dst;
          int ld, col;
          if (c < LE) {
            w = q_w + (size_t)b * D * LE, bias = q_b + (size_t)b * LE;
            al = q_a[b], ld = LE, col = c, dst = qa + f * LE + c;
          } else if (c < 2 * LE) {
            w = k_w + (size_t)b * D * LE, bias = k_b + (size_t)b * LE;
            al = k_a[b], ld = LE, col = c - LE, dst = ka + f * LE + col;
          } else {
            w = v_w + (size_t)b * D * D, bias = v_b + (size_t)b * D;
            al = v_a[b], ld = D, col = c - 2 * LE, dst = va + f * D + col;
          }
          const float* xr = xs + f * D;
          float a = 0.f;
          for (int d = 0; d < D; ++d) a += xr[d] * w[d * ld + col];
          a += bias[col];
          *dst = fmaxf(a, 0.f) + al * fminf(a, 0.f);
        }
      }
      __syncthreads();

      // 2. per head, a LayerNorm over its whole [F, e] slab: one warp a slab
      for (int sl = warp; sl < 3 * heads; sl += n_warps) {
        const int t = sl / heads, h = sl - t * heads;
        const int w = t < 2 ? e_dim : vd, ld = t < 2 ? LE : D;
        float* base = (t == 0 ? qa : t == 1 ? ka : va) + h * w;
        const float* g = (t == 0 ? q_ln : t == 1 ? k_ln : v_ln) +
                         (size_t)b * 2 * F * w;
        const int n = F * w;
        float sum = 0.f;
        for (int i = lane; i < n; i += 32) {
          const int f = i / w;
          sum += base[f * ld + i - f * w];
        }
        for (int o = 16; o > 0; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float mu = sum / n;
        float var = 0.f;
        for (int i = lane; i < n; i += 32) {
          const int f = i / w;
          const float dv = base[f * ld + i - f * w] - mu;
          var += dv * dv;
        }
        for (int o = 16; o > 0; o >>= 1)
          var += __shfl_xor_sync(0xffffffffu, var, o);
        const float inv = 1.0f / sqrtf(var / n + 1e-5f);
        for (int i = lane; i < n; i += 32) {
          const int f = i / w;
          float* p = base + f * ld + i - f * w;
          *p = (*p - mu) * inv * g[i] + g[n + i];
        }
      }
      __syncthreads();

      // 3. this frame's k, v to slot pos of the rings
      for (int idx = tid; idx < (LE + D) * F; idx += nt) {
        const int c = idx / F, f = idx - c * F;
        if (c < LE)
          k_ring[(((size_t)b * LE + c) * W + pos) * F + f] = ka[f * LE + c];
        else
          v_ring[(((size_t)b * D + c - LE) * W + pos) * F + f] =
              va[f * D + c - LE];
      }
      // 4. the block's ring writes are visible to its reads below
      __syncthreads();

      // 5. scores, one warp per (head, slot)
      const float scale = 1.0f / sqrtf((float)(F * e_dim));
      for (int p = warp; p < heads * W; p += n_warps) {
        const int h = p / W, w = p - h * W;
        float a = 0.f;
        for (int j = 0; j < e_dim; ++j) {
          const float* kr =
              k_ring + (((size_t)b * LE + h * e_dim + j) * W + w) * F;
          const float* qc = qa + h * e_dim + j;
          for (int f = lane; f < F; f += 32) a += qc[f * LE] * kr[f];
        }
        for (int o = 16; o > 0; o >>= 1)
          a += __shfl_xor_sync(0xffffffffu, a, o);
        if (lane == 0) sc[p] = a * scale;
      }
      __syncthreads();

      // 6. softmax over the W slots, no mask: one warp a head
      for (int h = warp; h < heads; h += n_warps) {
        float* sr = sc + h * W;
        float m = __int_as_float(0xff800000);  // -inf
        for (int w = lane; w < W; w += 32) m = fmaxf(m, sr[w]);
        for (int o = 16; o > 0; o >>= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        float z = 0.f;
        for (int w = lane; w < W; w += 32) {
          const float ev = expf(sr[w] - m);
          sr[w] = ev;
          z += ev;
        }
        for (int o = 16; o > 0; o >>= 1)
          z += __shfl_xor_sync(0xffffffffu, z, o);
        const float inv = 1.0f / z;
        for (int w = lane; w < W; w += 32) sr[w] *= inv;
      }
      __syncthreads();

      // 7. the probability-weighted values, head-minor
      for (int idx = tid; idx < D * F; idx += nt) {
        const int c = idx / F, f = idx - c * F;
        const float* vr = v_ring + ((size_t)b * D + c) * W * F + f;
        const float* pr = sc + (c / vd) * W;
        float a = 0.f;
        for (int w = 0; w < W; ++w) a += pr[w] * vr[(size_t)w * F];
        oa[f * D + c] = a;
      }
      __syncthreads();

      // 8. output Linear -> PReLU into zs (free since the inter gates)
      {
        const float* ow = o_w + (size_t)b * D * D;
        const float* ob = o_b + (size_t)b * D;
        const float al = o_a[b];
        for (int idx = tid; idx < FD; idx += nt) {
          const int f = idx / D, d = idx - f * D;
          const float* orow = oa + f * D;
          float a = 0.f;
          for (int c = 0; c < D; ++c) a += orow[c] * ow[c * D + d];
          a += ob[d];
          zs[idx] = fmaxf(a, 0.f) + al * fminf(a, 0.f);
        }
      }
      __syncthreads();
      // ... -> LayerNorm over the whole [F, D] frame -> residual
      float part = 0.f;
      for (int i = tid; i < FD; i += nt) part += zs[i];
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) red[warp] = part;
      __syncthreads();
      if (warp == 0) {
        float t = lane < n_warps ? red[lane] : 0.f;
        for (int o = 16; o > 0; o >>= 1)
          t += __shfl_xor_sync(0xffffffffu, t, o);
        if (lane == 0) red[32] = t / FD;
      }
      __syncthreads();
      const float mu = red[32];
      part = 0.f;
      for (int i = tid; i < FD; i += nt) {
        const float dv = zs[i] - mu;
        part += dv * dv;
      }
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) red[warp] = part;
      __syncthreads();
      if (warp == 0) {
        float t = lane < n_warps ? red[lane] : 0.f;
        for (int o = 16; o > 0; o >>= 1)
          t += __shfl_xor_sync(0xffffffffu, t, o);
        if (lane == 0) red[33] = 1.0f / sqrtf(t / FD + 1e-5f);
      }
      __syncthreads();
      const float inv = red[33];
      const float* g = o_ln + (size_t)b * 2 * FD;
      for (int i = tid; i < FD; i += nt)
        xs[i] += (zs[i] - mu) * inv * g[i] + g[FD + i];
      __syncthreads();
    }
  }

  for (int i = tid; i < FD; i += nt) x_out[i] = xs[i];
}

// Attention operands (nullptr / 0 for kAttn = false), in the kernel's order.
struct AttnArgs {
  const float *q_w, *q_b, *q_a, *q_ln, *k_w, *k_b, *k_a, *k_ln;
  const float *v_w, *v_b, *v_a, *v_ln, *o_w, *o_b, *o_a, *o_ln;
  float *k_ring, *v_ring, *a_scr;
  int heads, e_dim, window, pos;
};

template <bool kAttn>
int launch(const float* x, const float* film_w, const float* film_b,
           const float* down_cat, const float* down_b, const float* alpha,
           const float* i_ln, const float* wih_f, const float* wih_b,
           const float* whh, const float* b8, const float* proj_w,
           const float* proj_b, const float* t_ln, const float* wih2,
           const float* whh2, const float* b2, const float* proj2_w,
           const float* proj2_b, const float* h0, const float* c0,
           float* x_out, float* h0_out, float* c0_out, float* gx, float* y,
           float* g2, int n_blocks, int f_len, int d, int hidden, int s,
           int use_film, float eps, const AttnArgs& at, void* stream) {
  const int threads = 8 * hidden;
  size_t smem = (size_t)(2 * f_len * d + 12 * hidden) * sizeof(float);
  if (kAttn)  // the scores [L, W] and 64 floats of reduction scratch
    smem += (size_t)(at.heads * at.window + 64) * sizeof(float);
  cudaGetLastError();  // clear an error left by an earlier call
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        stack_step_conv_kernel<kAttn>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  stack_step_conv_kernel<kAttn>
      <<<1, threads, smem, (cudaStream_t)stream>>>(
          x, film_w, film_b, down_cat, down_b, alpha, i_ln, wih_f, wih_b,
          whh, b8, proj_w, proj_b, t_ln, wih2, whh2, b2, proj2_w, proj2_b,
          h0, c0, x_out, h0_out, c0_out, gx, y, g2, n_blocks, f_len, d,
          hidden, s, use_film, eps, at.q_w, at.q_b, at.q_a, at.q_ln, at.k_w,
          at.k_b, at.k_a, at.k_ln, at.v_w, at.v_b, at.v_a, at.v_ln, at.o_w,
          at.o_b, at.o_a, at.o_ln, at.k_ring, at.v_ring, at.a_scr, at.heads,
          at.e_dim, at.window, at.pos);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. Every pointer is a device pointer to
// contiguous fp32 memory; the wrapper has checked shapes, types and devices.
// Each launches on `stream` and returns cudaGetLastError() (0 on success).
// gx [k, 8H], y [k, 2H] and g2 [F, 4H] are scratch (k = f_len / lstm_down).
// The conv operands of `pack_stack_params` come in place of the plain
// branch's proj_w / proj_b, with `lstm_down` s.
extern "C" int sbt_stack_step_conv(
    const float* x, const float* film_w, const float* film_b,
    const float* down_cat, const float* down_b, const float* alpha,
    const float* i_ln, const float* wih_f, const float* wih_b,
    const float* whh, const float* b8, const float* up_flat,
    const float* up_b, const float* t_ln, const float* wih2,
    const float* whh2, const float* b2, const float* proj2_w,
    const float* proj2_b, const float* h0, const float* c0, float* x_out,
    float* h0_out, float* c0_out, float* gx, float* y, float* g2,
    int n_blocks, int f_len, int d, int hidden, int lstm_down, int use_film,
    float eps, void* stream) {
  return launch<false>(
      x, film_w, film_b, down_cat, down_b, alpha, i_ln, wih_f, wih_b, whh,
      b8, up_flat, up_b, t_ln, wih2, whh2, b2, proj2_w, proj2_b, h0, c0,
      x_out, h0_out, c0_out, gx, y, g2, n_blocks, f_len, d, hidden,
      lstm_down, use_film, eps, AttnArgs{}, stream);
}

// The attention branch: the 16 operands of `pack_attn_params`, the rings
// (updated in place at slot `pos`) and the q/k/v/output scratch
// [F * (2 L E + 2 D)] after the weights; heads L, e_dim E, window W and pos
// after the dims.
#define SBT_ATTN_PARAMS                                                      \
  const float *q_w, const float *q_b, const float *q_a, const float *q_ln,  \
      const float *k_w, const float *k_b, const float *k_a,                 \
      const float *k_ln, const float *v_w, const float *v_b,                \
      const float *v_a, const float *v_ln, const float *o_w,                \
      const float *o_b, const float *o_a, const float *o_ln, float *k_ring, \
      float *v_ring, float *a_scr
#define SBT_ATTN_ARGS                                                        \
  AttnArgs {                                                                 \
    q_w, q_b, q_a, q_ln, k_w, k_b, k_a, k_ln, v_w, v_b, v_a, v_ln, o_w, o_b, \
        o_a, o_ln, k_ring, v_ring, a_scr, heads, e_dim, window, pos          \
  }

extern "C" int sbt_stack_step_conv_attn(
    const float* x, const float* film_w, const float* film_b,
    const float* down_cat, const float* down_b, const float* alpha,
    const float* i_ln, const float* wih_f, const float* wih_b,
    const float* whh, const float* b8, const float* up_flat,
    const float* up_b, const float* t_ln, const float* wih2,
    const float* whh2, const float* b2, const float* proj2_w,
    const float* proj2_b, SBT_ATTN_PARAMS, const float* h0, const float* c0,
    float* x_out, float* h0_out, float* c0_out, float* gx, float* y,
    float* g2, int n_blocks, int f_len, int d, int hidden, int lstm_down,
    int heads, int e_dim, int window, int pos, int use_film, float eps,
    void* stream) {
  return launch<true>(
      x, film_w, film_b, down_cat, down_b, alpha, i_ln, wih_f, wih_b, whh,
      b8, up_flat, up_b, t_ln, wih2, whh2, b2, proj2_w, proj2_b, h0, c0,
      x_out, h0_out, c0_out, gx, y, g2, n_blocks, f_len, d, hidden,
      lstm_down, use_film, eps, SBT_ATTN_ARGS, stream);
}
